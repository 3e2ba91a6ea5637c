"""Autoregressive decoding: the port of the JAX package's ``decode/ar.py``
(KV-cached sampling loop and batched beam search; reference
captioning/models/AttModel.py:307-430 and CaptionModel.py:48-222).

  * The step is the model's ``ar_step``: BoFiCap's per-layer KV caches
    (written in place) with the cross-attention K/V projected once per
    sequence, or an LSTM captioner's carry (``models/lstm_caption.py``).
    With the model's ``use_pallas`` set, every step's attentions take the
    attention-core kernel (``ops/attention.py``): BoFiCap's
    cross-attentions, as in the JAX package, and its self-attentions over
    the cache rows written so far; AoANet's decoder attention.  A beam
    search reorders the cache by the model's ``gather_ar_cache``; each
    beam group starts from its own ``copy_ar_cache`` of one
    ``init_ar_cache``.
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

  * ``ar_diverse_beam_search`` and ``ar_old_beam_search`` (the legacy
    loop, its quirks kept) run their groups staggered along one time axis
    as the reference does (``_staggered_groups_scan``), each group a beam
    step of B·K rows; ``ar_diverse_sample`` is one ``ar_sample`` a group,
    penalized by the earlier groups' words.

``ar_sample`` takes every method of ``sample_next_word``; a sampled one
draws from the caller's ``generator``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from .. import obs
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
        with obs.span("bfc.ar.step"):
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


def _gather_cache(model, cache, beam_ix, B: int, K: int):
    """The flat [B*K, ...] AR cache reordered by each row's parent beam
    (the model's ``gather_ar_cache``)."""
    flat_ix = (torch.arange(B, device=beam_ix.device)[:, None] * K
               + beam_ix).reshape(-1)
    return model.gather_ar_cache(cache, flat_ix)


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
                    *, diversity_lambda: float, temperature: float,
                    suppress_unk_idx, bad_endings_ix, decoding_constraint,
                    device):
    """One batched beam-search step, shared by ``ar_beam_search`` (one
    group) and ``ar_diverse_beam_search`` (staggered groups): expand K
    beams to K·V candidates, keep the top K by cumulative log-prob less
    ``diversity_lambda`` x ``div_counts`` (the words earlier groups hold at
    this column), take each kept token's log-prob from the distribution
    without that term (the reference's beam_seq_logprobs store the
    unaugmented log-probs, CaptionModel.py:112-117), merge ended beams
    into the done pool with the length penalty applied (:193-209), knock
    ended alive scores down by 1000 (:210)."""
    bad = (None if not bad_endings_ix else
           torch.tensor(bad_endings_ix, dtype=torch.long, device=device))

    def step(state, pos: int, div_counts=None):
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
        lp_unaug = logprob.reshape(B, K, V)
        lp = lp_unaug
        if div_counts is not None:
            lp = lp - diversity_lambda * div_counts[:, None, :]
        scores, idx, beam_ix, word = _topk_candidates(state["sum_lp"], lp,
                                                      B, K, V)
        seq = _gather_beams(state["seq"], beam_ix)
        seq[:, :, pos] = word
        tok_lp = _gather_beams(state["tok_lp"], beam_ix)
        tok_lp[:, :, pos] = torch.gather(lp_unaug.reshape(B, K * V), 1, idx)
        cache = _gather_cache(model, cache, beam_ix, B, K)

        is_end = _ends(word, pos, L)
        cand_p = torch.where(is_end, penalty(pos + 1, scores), NEG_INF)
        done_p, (done_seq, done_tok) = _merge_done_pool(
            state["done_p"], cand_p, K,
            [(state["done_seq"], seq), (state["done_tok"], tok_lp)])
        return {"it": word.reshape(-1), "cache": cache,
                "sum_lp": torch.where(word == EOS, scores - 1000.0, scores),
                "seq": seq, "tok_lp": tok_lp, "done_p": done_p,
                "done_seq": done_seq, "done_tok": done_tok}

    return step


def _ends(word, pos: int, L: int):
    """The beams that end at step ``pos``: those that chose EOS, and every
    beam at the last step."""
    if pos < L - 1:
        return word == EOS
    return torch.ones_like(word, dtype=torch.bool)


def _staggered_groups_scan(step, states, G: int, B: int, V: int, L: int):
    """Drive G beam groups staggered along one global time axis (the
    reference's diverse-group loop order, CaptionModel.py:58-68,
    :227-235, :326-327): at global step t, group g, in group order, takes
    its local step t - g (when 0 <= t - g < L), with ``div_counts`` [B, V]
    the count of each word at column t - g in the alive beams of the
    groups before it, which have already taken this global step.  The
    counts are a scatter-add on the device: no host sync."""
    states = list(states)
    for t in range(L + G - 1):
        for grp in range(G):
            local = t - grp
            if not 0 <= local < L:
                continue
            counts = None
            if grp > 0:
                words = torch.cat([states[j]["seq"][:, :, local]
                                   for j in range(grp)], 1)
                counts = torch.zeros((B, V), device=words.device
                                     ).scatter_add_(
                    1, words, torch.ones(words.shape, device=words.device))
            states[grp] = step(states[grp], local, counts)
    return states


def _group_caches(model, mem_k, L: int, G: int):
    """G AR caches over one memory, each group's its own copy of the one
    ``init_ar_cache`` made (the model's ``copy_ar_cache``): every group
    starts from the same state."""
    cache = model.init_ar_cache(mem_k, L + 1)
    return [cache] + [model.copy_ar_cache(cache) for _ in range(G - 1)]


def _groups(beam_size: int, group_size: int) -> int:
    """Beams per group; ``group_size`` must divide ``beam_size``."""
    if group_size < 1 or beam_size % group_size:
        raise ValueError(f"group_size {group_size} must divide beam_size "
                         f"{beam_size}")
    return beam_size // group_size


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
                           diversity_lambda=0.0, temperature=temperature,
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


@torch.no_grad()
def ar_diverse_beam_search(model, memory, src_mask, *, beam_size: int,
                           group_size: int, diversity_lambda: float = 0.5,
                           length_penalty: str = "",
                           suppress_unk_idx: Optional[int] = None,
                           temperature: float = 1.0,
                           decoding_constraint: bool = False,
                           bad_endings_ix: Optional[tuple] = None
                           ) -> Dict[str, torch.Tensor]:
    """Diverse beam search (reference CaptionModel.beam_search with
    group_size > 1, :48-222): ``beam_size`` splits into ``group_size``
    groups of beam_size / group_size beams, staggered along one time axis
    as the reference runs them (``_staggered_groups_scan``): group g takes
    its local step t - g with its log-probs less ``diversity_lambda`` x
    the count of each word in the earlier groups' current alive beams at
    that column.  Those groups are a step ahead and re-gathered by their
    own later selections, so this is not a penalty by their finished
    sequences.

    Returns {'seq': [B, K, L], 'tok_logprobs': [B, K, L], 'scores': [B, K]},
    K = beam_size: each group's done pool sorted best-first, the groups
    concatenated group-major (the reference's done_beams order)."""
    G = group_size
    K = _groups(beam_size, G)
    L = model.max_length
    B = memory.shape[0]
    V = model.tgt_vocab
    mem_k = memory.repeat_interleave(K, 0)
    mask_k = None if src_mask is None else src_mask.repeat_interleave(K, 0)
    step = _make_beam_step(model, mask_k, B, K, V, L,
                           length_penalty_fn(length_penalty),
                           diversity_lambda=diversity_lambda,
                           temperature=temperature,
                           suppress_unk_idx=suppress_unk_idx,
                           bad_endings_ix=bad_endings_ix,
                           decoding_constraint=decoding_constraint,
                           device=memory.device)
    final = _staggered_groups_scan(
        step, [_beam_init(B, K, L, c, memory.device)
               for c in _group_caches(model, mem_k, L, G)], G, B, V, L)
    return {"seq": torch.cat([s["done_seq"] for s in final], 1),
            "tok_logprobs": torch.cat([s["done_tok"] for s in final], 1),
            "scores": torch.cat([s["done_p"] for s in final], 1)}


@torch.no_grad()
def ar_old_beam_search(model, memory, src_mask, *, beam_size: int,
                       group_size: int = 1, diversity_lambda: float = 0.5,
                       temperature: float = 1.0, length_penalty: str = "",
                       decoding_constraint: bool = False,
                       remove_bad_endings: bool = False,
                       bad_endings_ix: Optional[tuple] = None,
                       suppress_unk_idx: Optional[int] = None
                       ) -> Dict[str, torch.Tensor]:
    """Legacy beam search (reference ``CaptionModel.old_beam_search``
    :224-381, reached through ``AttModel._old_sample_beam`` :223-261, which
    no reference flow dispatches: a library entry point outside the eval
    dispatch, as in the JAX package).  Its quirks are kept exactly:

      * each step stores the parent beam's whole unaugmented log-prob row
        (``v['r']`` :264,283): ``row_logprobs`` [B, K, L, V];
      * a done beam's ``unaug_p`` is that buffer summed over time and
        vocabulary (:365);
      * a beam that emits EOS has its cumulative score set to the absolute
        -1000 (:371), not score - 1000;
      * ``decoding_constraint`` writes an exact -inf at the previous word
        before the rows are stored (:329-330), so they carry it;
        ``remove_bad_endings`` writes -inf at column 0 (PAD) only
        (:332-333);
      * ``suppress_unk_idx``, when given, takes 1000 off every step
        (:336-337);
      * with T != 1 every step from 1 on is re-normalised as
        log_softmax(logprobs / T) (:380-381).

    Groups are staggered as in ``ar_diverse_beam_search``.  Returns
    {'seq': [B, K, L], 'row_logprobs': [B, K, L, V], 'scores': [B, K],
    'unaug_p': [B, K]}, the groups concatenated group-major, each group's
    done beams sorted best-first by their length-penalized score."""
    G = group_size
    K = _groups(beam_size, G)
    L = model.max_length
    B = memory.shape[0]
    V = model.tgt_vocab
    dev = memory.device
    penalty = length_penalty_fn(length_penalty)
    mem_k = memory.repeat_interleave(K, 0)
    mask_k = None if src_mask is None else src_mask.repeat_interleave(K, 0)
    bad = (torch.tensor(bad_endings_ix, dtype=torch.long, device=dev)
           if remove_bad_endings and bad_endings_ix else None)

    def step(state, pos: int, div_counts=None):
        logprob, cache = model.ar_step(state["it"], pos, state["cache"],
                                       mask_k)
        if temperature != 1.0 and pos > 0:
            logprob = torch.log_softmax(logprob / temperature, dim=-1)
        if decoding_constraint and pos > 0:
            logprob = logprob.scatter(
                1, state["it"][:, None],
                torch.full((B * K, 1), -math.inf, device=dev))
        if bad is not None and pos > 0:
            logprob[:, PAD] = torch.where(torch.isin(state["it"], bad),
                                          -math.inf, logprob[:, PAD])
        if suppress_unk_idx is not None:
            logprob[:, suppress_unk_idx] -= 1000.0
        lp_unaug = logprob.reshape(B, K, V)          # the rows stored
        lp = lp_unaug
        if div_counts is not None:
            lp = lp - diversity_lambda * div_counts[:, None, :]
        scores, _, beam_ix, word = _topk_candidates(state["sum_lp"], lp,
                                                    B, K, V)
        seq = _gather_beams(state["seq"], beam_ix)
        seq[:, :, pos] = word
        row_lp = _gather_beams(state["row_lp"], beam_ix)
        row_lp[:, :, pos] = _gather_beams(lp_unaug, beam_ix)
        cache = _gather_cache(model, cache, beam_ix, B, K)

        cand_p = torch.where(_ends(word, pos, L), penalty(pos + 1, scores),
                             NEG_INF)
        done_p, (done_seq, done_row, done_unaug) = _merge_done_pool(
            state["done_p"], cand_p, K,
            [(state["done_seq"], seq), (state["done_row"], row_lp),
             (state["done_unaug"], row_lp.sum((2, 3)))])
        return {"it": word.reshape(-1), "cache": cache,
                # the absolute -1000 on EOS (:371)
                "sum_lp": torch.where(word == EOS, -1000.0, scores),
                "seq": seq, "row_lp": row_lp, "done_p": done_p,
                "done_seq": done_seq, "done_row": done_row,
                "done_unaug": done_unaug}

    def init(cache):
        s = _beam_init(B, K, L, cache, dev)
        del s["tok_lp"], s["done_tok"]
        s["row_lp"] = torch.zeros((B, K, L, V), device=dev)
        s["done_row"] = torch.zeros((B, K, L, V), device=dev)
        s["done_unaug"] = torch.zeros((B, K), device=dev)
        return s

    final = _staggered_groups_scan(
        step, [init(c) for c in _group_caches(model, mem_k, L, G)], G, B, V,
        L)
    return {"seq": torch.cat([s["done_seq"] for s in final], 1),
            "row_logprobs": torch.cat([s["done_row"] for s in final], 1),
            "scores": torch.cat([s["done_p"] for s in final], 1),
            "unaug_p": torch.cat([s["done_unaug"] for s in final], 1)}


@torch.no_grad()
def ar_diverse_sample(model, memory, src_mask, *, group_size: int,
                      diversity_lambda: float = 0.5,
                      sample_method: str = "greedy",
                      temperature: float = 1.0,
                      decoding_constraint: bool = False,
                      block_trigrams: bool = False,
                      bad_endings_ix: Optional[tuple] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
    """Group-diverse sampling (reference AttModel._diverse_sample
    :519-614): ``group_size`` captions an image, one ``ar_sample`` a group,
    each group's log-probs less ``diversity_lambda`` for each word an
    earlier group chose at the same step.  Every group draws from the
    caller's one ``generator``, in group order.  Returns {'seq': [B, G, L],
    'tok_logprobs': [B, G, L]}."""
    seqs, lps = [], []
    for _ in range(group_size):
        out = ar_sample(model, memory, src_mask, sample_method=sample_method,
                        temperature=temperature,
                        penalty_seqs=torch.stack(seqs, 1) if seqs else None,
                        diversity_lambda=diversity_lambda,
                        decoding_constraint=decoding_constraint,
                        block_trigrams=block_trigrams,
                        bad_endings_ix=bad_endings_ix, generator=generator)
        seqs.append(out["seq"])
        lps.append(out["tok_logprobs"])
    return {"seq": torch.stack(seqs, 1), "tok_logprobs": torch.stack(lps, 1)}
