"""Next-word sampling (the JAX package's ``decode/sampling.py``, reference
CaptionModel.sample_next_word, captioning/models/CaptionModel.py:383-437):
greedy / temperature / top-k / top-p (nucleus) / gumbel.

Every function works on the LAST axis, so the same code serves the AR path
([B, V] a step) and the parallel phrase paths ([B, L, V] a pass).  Forbidden
words carry the finite fill ``NEG_INF``, so the reference's NaN guards are
not needed.  The draws come from an explicit ``torch.Generator`` on the
tensor's device: there is no hidden global stream, and a sampled call
without one raises.  The draws cannot equal the JAX package's (another
RNG); the filters and the gathered log-probs do.
"""

from __future__ import annotations

from typing import Optional

import torch

# the finite fill of forbidden words (the JAX package's sampling.NEG_INF)
NEG_INF = -1e9


def _gather_last(logprobs, ids):
    return torch.gather(logprobs, -1, ids[..., None])[..., 0]


def top_k_filter(logprobs: torch.Tensor, k: int) -> torch.Tensor:
    """Keep every entry >= the k-th largest (ties kept), fill the rest
    with NEG_INF (reference CaptionModel.py:418-422)."""
    kth = torch.topk(logprobs, k, dim=-1).values[..., -1:]
    return torch.where(logprobs >= kth, logprobs, NEG_INF)


def top_p_filter(logprobs: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering (reference CaptionModel.py:407-417): keep the
    smallest prefix of descending-probability words whose cumulative
    probability reaches p (the first always), renormalise, and return
    ``log(max(kept, 1e-12))``."""
    probs = torch.softmax(logprobs, dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = torch.cat([torch.ones_like(csum[..., :1], dtype=torch.bool),
                             csum[..., :-1] < p], dim=-1)
    # the threshold is the smallest kept probability
    thresh = torch.where(keep_sorted, sorted_probs,
                         torch.inf).min(dim=-1, keepdim=True).values
    kept = torch.where(probs >= thresh, probs, 0.0)
    kept = kept / kept.sum(-1, keepdim=True).clamp_min(1e-12)
    return torch.log(kept.clamp_min(1e-12))


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, as the JAX package draws it for gumbel."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u + 1e-20) + 1e-20)


def _check_generator(logprobs, generator) -> None:
    if generator is None:
        raise ValueError("a sampled sample_method needs an explicit "
                         "torch.Generator (generator=None)")
    if torch.device(generator.device).type != logprobs.device.type:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"log-probs on {logprobs.device}")


def sample_next_word(logprobs: torch.Tensor, sample_method: str = "greedy",
                     temperature: float = 1.0,
                     generator: Optional[torch.Generator] = None):
    """Returns (ids, per-token logprob) over the last axis.

    ``sample_method``: 'greedy' | 'gumbel' | 'sample' | 'topK' (int K) |
    'top0.P' (nucleus).  Greedy takes the first maximum on ties, as
    ``jnp.argmax`` does.  The gathered log-prob is taken from the ORIGINAL
    log-probs for greedy and gumbel and from the tempered / filtered ones
    for the sample family, as the reference does."""
    if sample_method == "greedy":
        ids = torch.argmax(logprobs, dim=-1)
        return ids, _gather_last(logprobs, ids)
    _check_generator(logprobs, generator)

    if sample_method == "gumbel":
        g = _gumbel(logprobs.shape, generator, logprobs.device)
        ids = torch.argmax(torch.log_softmax((logprobs + g) / temperature,
                                             dim=-1), dim=-1)
        return ids, _gather_last(logprobs, ids)

    lp = logprobs / temperature
    if sample_method.startswith("top"):
        top_num = float(sample_method[3:])
        if 0 < top_num < 1:
            lp = top_p_filter(lp, top_num)
        else:
            lp = top_k_filter(lp, int(top_num))
    # a categorical draw by the Gumbel-max rule (jax.random.categorical's)
    ids = torch.argmax(lp + _gumbel(lp.shape, generator, lp.device), dim=-1)
    return ids, _gather_last(lp, ids)
