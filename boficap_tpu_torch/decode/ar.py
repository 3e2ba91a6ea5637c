"""Autoregressive decoding: the port of the JAX package's ``decode/ar.py``
(KV-cached sampling loop and batched beam search; reference
captioning/models/AttModel.py:307-430 and CaptionModel.py:48-222).

  * The step is ``BoFiCap.ar_step``: per-layer KV caches (written in place)
    and cross-attention K/V projected once per sequence.  With the model's
    ``use_pallas`` set, every step's cross-attentions take the
    attention-core kernel (``ops/attention.py``), as in the JAX package.
  * ``ar_sample`` runs a fixed ``n_steps`` loop with per-sample
    ``unfinished`` masks and no host sync: a finished row writes PAD and
    zero log-prob / entropy, so the result equals the JAX package's
    while-loop, which exits once every row has finished.
  * ``ar_beam_search`` keeps the JAX package's batched form: a top-K over
    the K·V candidates per step, a merged top-K "done" pool, the beam state
    gathered by one index per step.  ``jax.lax.top_k`` puts the lower index
    first among equal values; ``torch.topk`` promises no order, so the
    top-K here is a stable descending sort (equal values keep index order),
    which matters in the done pool, where many entries are equal to NEG_INF.

``ar_sample`` takes every method of ``sample_next_word``; a sampled one
draws from the caller's ``generator``.  ``ar_diverse_beam_search``,
``ar_old_beam_search`` and ``ar_diverse_sample`` are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..constants import BOS, EOS, PAD
from .sampling import NEG_INF, sample_next_word


def length_penalty_fn(spec: str):
    """'' | 'wu_X' | 'avg_X' (reference utils/misc.py:133-157).  The
    penalty's divisor is computed in float32 from the int length, as the
    JAX package computes it on the device."""
    if not spec:
        return lambda length, logp: logp
    kind, alpha = spec.split("_")
    alpha = float(alpha)
    f32 = np.float32
    if kind == "wu":
        return lambda length, logp: logp / float(
            f32(5.0 + length) ** f32(alpha) / f32(6.0 ** alpha))
    if kind == "avg":
        return lambda length, logp: logp / float(
            f32(max(length, 1)) ** f32(alpha))
    raise ValueError(f"unknown length penalty {spec}")


def _top_k(x, k: int):
    """(values, indices) of the k largest entries of the last axis, the
    lower index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _forbid_stop(logprob, it, bad) -> None:
    """In place: a row whose previous word is a bad ending cannot stop, its
    PAD and EOS take NEG_INF (reference AttModel.py:355-360,
    CaptionModel.py:169-170)."""
    prev_bad = torch.isin(it, bad)
    for t in (PAD, EOS):
        logprob[:, t] = torch.where(prev_bad, NEG_INF, logprob[:, t])


@torch.no_grad()
def ar_sample(model, memory, src_mask, *, sample_method: str = "greedy",
              temperature: float = 1.0, decoding_constraint: bool = False,
              suppress_unk_idx: Optional[int] = None,
              max_steps: Optional[int] = None, block_trigrams: bool = False,
              penalty_seqs=None, diversity_lambda: float = 0.5,
              bad_endings_ix: Optional[tuple] = None,
              generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
    """Decode captions autoregressively, each word by ``sample_method``
    (a sampled method draws from ``generator``).

    Returns {'seq': [B, L] int64, 'tok_logprobs': [B, L] float32 (the
    chosen token's log-prob), 'entropy': [B, L] float32}; finished rows
    hold PAD and zeros.

    ``decoding_constraint`` forbids repeating the previous word;
    ``suppress_unk_idx`` takes 1000 off that column; ``bad_endings_ix``
    forbids stopping right after one of those words; ``block_trigrams``
    penalizes a word that would repeat a trigram of the row (ln(1/2) * 2 a
    repeat); ``penalty_seqs`` [B, P, L] takes ``diversity_lambda`` off each
    word an earlier group chose at this step (AttModel.py:349-383,
    CaptionModel.add_diversity :51-68).  The options apply in the JAX
    package's order."""
    L = model.max_length
    B = memory.shape[0]
    V = model.tgt_vocab
    dev = memory.device
    n_steps = L if max_steps is None else min(max_steps, L)
    cache = model.init_ar_cache(memory, L + 1)
    it = torch.full((B,), BOS, dtype=torch.long, device=dev)
    seq = torch.full((B, L), PAD, dtype=torch.long, device=dev)
    tok_lp = torch.zeros((B, L), dtype=torch.float32, device=dev)
    ent_lp = torch.zeros((B, L), dtype=torch.float32, device=dev)
    unfinished = torch.ones(B, dtype=torch.bool, device=dev)
    bad = (None if not bad_endings_ix else
           torch.tensor(bad_endings_ix, dtype=torch.long, device=dev))
    pos_idx = torch.arange(L, device=dev)[None, :]

    for pos in range(n_steps):
        logprob, cache = model.ar_step(it, pos, cache, src_mask)
        if suppress_unk_idx is not None:
            logprob[:, suppress_unk_idx] -= 1000.0
        if bad is not None and pos > 0:
            _forbid_stop(logprob, it, bad)
        if decoding_constraint and pos > 0:
            logprob = logprob.scatter_add(
                1, it[:, None], torch.full((B, 1), NEG_INF, device=dev))
        if penalty_seqs is not None:
            counts = torch.zeros((B, V), device=dev).scatter_add_(
                1, penalty_seqs[:, :, pos].long(),
                torch.ones(penalty_seqs.shape[:2], device=dev))
            logprob = logprob - diversity_lambda * counts
        if block_trigrams and pos >= 3:
            # count seq[p] for every past p >= 2 whose (seq[p-2], seq[p-1])
            # equals the current pair (seq[pos-2], seq[pos-1])
            prev2 = torch.stack([seq.roll(2, 1), seq.roll(1, 1)], -1)
            cur2 = seq[:, pos - 2:pos]
            match = ((prev2 == cur2[:, None, :]).all(-1) & (pos_idx >= 2)
                     & (pos_idx < pos))
            counts = torch.zeros((B, V), device=dev).scatter_add_(
                1, seq, match.float())
            logprob = logprob + counts * (-0.693) * 2.0
        ids, _ = sample_next_word(logprob, sample_method, temperature,
                                  generator)
        ids = torch.where(unfinished, ids, PAD)
        tok = torch.gather(logprob, 1, ids[:, None])[:, 0]
        ent = -(torch.exp(logprob) * logprob).sum(-1)
        seq[:, pos] = ids
        tok_lp[:, pos] = torch.where(unfinished, tok, 0.0)
        ent_lp[:, pos] = torch.where(unfinished, ent, 0.0)
        unfinished = unfinished & (ids != EOS)
        it = ids
    return {"seq": seq, "tok_logprobs": tok_lp, "entropy": ent_lp}


def _topk_candidates(sum_lp, lp, B: int, K: int, V: int):
    """Global top-K over the K·V candidate expansion (reference
    CaptionModel.py:102-130).  Returns (scores, flat index into K·V,
    parent beam_ix, word), each [B, K]."""
    cand = sum_lp[:, :, None] + lp                               # [B, K, V]
    scores, idx = _top_k(cand.reshape(B, K * V), K)
    return scores, idx, idx // V, idx % V


def _gather_beams(x, beam_ix):
    """x [B, K, ...] reordered by each row's parent beam."""
    ix = beam_ix.reshape(beam_ix.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, ix.expand(beam_ix.shape + x.shape[2:]))


def _gather_cache(cache, beam_ix, B: int, K: int):
    """Reorder the flat [B*K, ...] self-attention K/V caches by each row's
    parent beam.  The cross-attention K/V are left as they are: the K rows
    of an image hold the same memory, so their K/V are equal and the
    reorder would not change them."""
    flat_ix = (torch.arange(B, device=beam_ix.device)[:, None] * K
               + beam_ix).reshape(-1)
    return [{**c, "ks": c["ks"][flat_ix], "vs": c["vs"][flat_ix]}
            for c in cache]


def _merge_done_pool(done_p, cand_p, K: int, payloads):
    """Merge newly ended beams into the persistent top-K done pool
    (reference done_beams + final sort, CaptionModel.py:193-209); on equal
    scores the pool's entries come first, then the candidates in beam
    order.  ``payloads``: (pool, candidate) pairs gathered by the same
    keep index.  Returns (new_done_p, [merged payloads])."""
    new_p, keep = _top_k(torch.cat([done_p, cand_p], 1), K)
    return new_p, [_gather_beams(torch.cat([pool, cand], 1), keep)
                   for pool, cand in payloads]


def _make_beam_step(model, mask_k, B: int, K: int, V: int, L: int, penalty,
                    *, temperature: float, suppress_unk_idx,
                    bad_endings_ix, decoding_constraint, device):
    """One batched beam-search step (the JAX package's single-group use):
    expand K beams to K·V candidates, keep the top K by cumulative
    log-prob, take each kept token's log-prob from the distribution before
    the diversity term, merge ended beams into the done pool with the
    length penalty applied (CaptionModel.py:193-209), knock ended alive
    scores down by 1000 (:210)."""
    bad = (None if not bad_endings_ix else
           torch.tensor(bad_endings_ix, dtype=torch.long, device=device))

    def step(state, pos: int):
        logprob, cache = model.ar_step(state["it"], pos, state["cache"],
                                       mask_k)
        if temperature != 1.0 and pos > 0:
            # the reference re-normalizes every step-t >= 1 logprob as
            # log_softmax(logprobs / T) (CaptionModel.py:218-219)
            logprob = torch.log_softmax(logprob / temperature, dim=-1)
        if suppress_unk_idx is not None:
            logprob[:, suppress_unk_idx] -= 1000.0
        if bad is not None and pos > 0:
            _forbid_stop(logprob, state["it"], bad)
        if decoding_constraint and pos > 0:
            logprob = logprob.scatter(
                1, state["it"][:, None],
                torch.full((logprob.shape[0], 1), NEG_INF,
                           device=logprob.device))
        lp = logprob.reshape(B, K, V)
        scores, idx, beam_ix, word = _topk_candidates(state["sum_lp"], lp,
                                                      B, K, V)
        seq = _gather_beams(state["seq"], beam_ix)
        seq[:, :, pos] = word
        tok_lp = _gather_beams(state["tok_lp"], beam_ix)
        tok_lp[:, :, pos] = torch.gather(lp.reshape(B, K * V), 1, idx)
        cache = _gather_cache(cache, beam_ix, B, K)

        # every beam ends at the last step
        is_end = (word == EOS) if pos < L - 1 else torch.ones_like(
            word, dtype=torch.bool)
        cand_p = torch.where(is_end, penalty(pos + 1, scores), NEG_INF)
        done_p, (done_seq, done_tok) = _merge_done_pool(
            state["done_p"], cand_p, K,
            [(state["done_seq"], seq), (state["done_tok"], tok_lp)])
        return {"it": word.reshape(-1), "cache": cache,
                "sum_lp": torch.where(word == EOS, scores - 1000.0, scores),
                "seq": seq, "tok_lp": tok_lp, "done_p": done_p,
                "done_seq": done_seq, "done_tok": done_tok}

    return step


def _beam_init(B: int, K: int, L: int, cache, dev):
    sum_lp = torch.full((B, K), NEG_INF, device=dev)
    # only beam 0 alive at step 0, so identical initial beams don't repeat
    sum_lp[:, 0] = 0.0
    return {
        "it": torch.full((B * K,), BOS, dtype=torch.long, device=dev),
        "cache": cache, "sum_lp": sum_lp,
        "seq": torch.full((B, K, L), PAD, dtype=torch.long, device=dev),
        "tok_lp": torch.zeros((B, K, L), device=dev),
        "done_p": torch.full((B, K), NEG_INF, device=dev),
        "done_seq": torch.full((B, K, L), PAD, dtype=torch.long, device=dev),
        "done_tok": torch.zeros((B, K, L), device=dev),
    }


@torch.no_grad()
def ar_beam_search(model, memory, src_mask, *, beam_size: int,
                   length_penalty: str = "",
                   suppress_unk_idx: Optional[int] = None,
                   temperature: float = 1.0,
                   decoding_constraint: bool = False,
                   bad_endings_ix: Optional[tuple] = None
                   ) -> Dict[str, torch.Tensor]:
    """Batched beam search (reference CaptionModel.beam_search,
    group_size=1).  Returns the done pool sorted best-first: {'seq':
    [B, K, L], 'tok_logprobs': [B, K, L], 'scores': [B, K]}.

    All L steps run, with no early exit, as in the reference's loop: ended
    beams go on at score - 1000 and re-enter the pool at the forced final
    step, and with a length penalty a later finish can out-score an earlier
    one."""
    L = model.max_length
    B = memory.shape[0]
    K = beam_size
    V = model.tgt_vocab
    mem_k = memory.repeat_interleave(K, 0)
    mask_k = None if src_mask is None else src_mask.repeat_interleave(K, 0)
    step = _make_beam_step(model, mask_k, B, K, V, L,
                           length_penalty_fn(length_penalty),
                           temperature=temperature,
                           suppress_unk_idx=suppress_unk_idx,
                           bad_endings_ix=bad_endings_ix,
                           decoding_constraint=decoding_constraint,
                           device=memory.device)
    state = _beam_init(B, K, L, model.init_ar_cache(mem_k, L + 1),
                       memory.device)
    for pos in range(L):
        state = step(state, pos)
    return {"seq": state["done_seq"], "tok_logprobs": state["done_tok"],
            "scores": state["done_p"]}
