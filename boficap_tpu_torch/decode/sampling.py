"""Next-word selection (the JAX package's ``decode/sampling.py``, reference
CaptionModel.sample_next_word).  Only the greedy branch is ported in this
slice; the sampled branches come with the RL slice."""

from __future__ import annotations

from typing import Optional

import torch

# the finite fill of forbidden words (the JAX package's sampling.NEG_INF)
NEG_INF = -1e9


def sample_next_word(logprobs: torch.Tensor, sample_method: str = "greedy",
                     temperature: float = 1.0,
                     generator: Optional[torch.Generator] = None):
    """Returns (ids, per-token logprob) over the last axis.  Greedy takes the
    first maximum on ties, as ``jnp.argmax`` does."""
    if sample_method == "greedy":
        ids = torch.argmax(logprobs, dim=-1)
        return ids, torch.gather(logprobs, -1, ids[..., None])[..., 0]
    raise NotImplementedError(
        f"sample_method={sample_method!r}: only 'greedy' is ported so far")
