"""PB_pad inference: the port of the JAX package's ``decode/pb.py``
(reference corePB_pad, TransformerModel.py:2123-2146, and the AttModel PB
sample loop, AttModel.py:469-517).

* ``pb_decode``: the decode loop.  Every alive sample appends exactly one
  phrase a round, so the packed layout is append-only: column j's width is
  fixed the round it is made and its start never moves.  The layout lives
  in a static ``[B, W]`` buffer (W: the packed-width cap, default
  ``2 * (max_length + 2)``) whose column starts and ids come from prefix
  sums each round (``packed_layout``).  The clamp is per sample: a sample
  whose planned phrase would spill past W ends there, and its batchmates
  that fit go on.  The width sums the rounds' batch maxima, so a batch of
  unlike plans can pass the default cap; ``max_length * (max_length + 1)
  // 2 + 1`` can never be passed (the ``pb_packed_width`` eval option).
  The JAX package runs a ``while_loop`` that stops when no sample is
  unfinished, and skips the fill of a round where no sample appends; here
  both read one small device tensor, one host sync a round, and the
  outputs are the same.

* ``pb_decode_host``: the reference's host-driven loop over
  ``data/pb_pack.pack_decoder_inputs``, one packed width a round: the
  test oracle of ``pb_decode`` (greedy decodes are equal; a sampled
  decode draws over another shape).

The kernels: the encoder (``bound_fill.fused_encode``, by the caller) and,
with the model's ``use_pallas``, the attention core (#9) on every attention
of the predictor (``[B, L2, L2]``) and of the packed decoder (``[B, W, W]``)
and on their cross-attentions; the decoder itself is the plain ``Decoder``,
as the JAX package routes it.

Reference defect NOT replicated: corePB_pad packs the decoder with the
CURRENT phrase lengths, so the column of the phrase not yet generated has
zero width and the sample loop breaks on its first step with an empty
logits tensor (AttModel.py:507-508).  Here the predicted next length is
appended to a working copy of the plan before packing, which is the
training-time layout of the next phrase.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..constants import BOS
from ..data.pb_pack import pack_decoder_inputs
from .sampling import sample_next_word


def default_width(max_length: int) -> int:
    """The packed-width cap ``pb_decode`` takes without ``packed_width``."""
    return 2 * (max_length + 2)


def packed_layout(seq, pl_work, P: int, W: int):
    """The reference's packed decoder layout (``pack_decoder_inputs``) as
    prefix sums and gathers over a static width-``W`` buffer.

    ``seq`` [B, L2] bos-framed words, ``pl_work`` [B, L2] phrase lengths
    (slot 0 = bos) with the next phrase already appended; ``P`` = the
    most next-phrase columns.  Returns (ids [B, W], slot [B, W], mask [B,
    W, W], starts [P]): equal to ``pack_decoder_inputs`` on the genuine
    width's prefix; past it ids are 0 and no key is visible."""
    B, L2 = seq.shape
    dev = seq.device
    next_len = pl_work[:, 1:1 + P]                          # [B, P]
    col_max = next_len.max(0).values                        # [P]
    cum = torch.cumsum(col_max, 0)
    starts = cum - col_max
    p = torch.arange(W, device=dev)
    col = (p[:, None] >= cum[None, :]).sum(1).clamp_max(P - 1)
    o = p - starts[col]                                     # [W]

    colb = col[None, :].expand(B, W)
    cur = torch.gather(next_len, 1, colb)                   # [B, W]
    prev = torch.gather(pl_work, 1, colb)                   # pl[col] (bos j=0)
    cexcl = torch.cumsum(pl_work, -1) - pl_work             # phrase starts
    src_start = torch.gather(cexcl, 1, colb)
    # the copy-init closed form (phrase_ops.copy_init_src_indices,
    # reference TransformerModel.py:1180-1199)
    ob = o[None, :]
    prev_safe = prev.clamp_min(1)
    ct = (cur // prev_safe).clamp_min(1)
    pre_less = prev - cur % prev_safe
    src_short = src_start + (prev - cur) + ob
    k_src = torch.where(ob < pre_less * ct, ob // ct,
                        pre_less + (ob - pre_less * ct) // (ct + 1))
    src = torch.where(cur <= prev, src_short, src_start + k_src)
    valid = ob < cur                                        # [B, W]
    ids = torch.where(valid, torch.gather(seq, 1, src.clamp(0, L2 - 1)), 0)
    # key padding & the phrase-blockwise causal mask
    # (phrase_subsequent_mask, TransformerModel.py:982-991)
    mask = valid[:, None, :] & (col[None, None, :] <= col[None, :, None])
    return ids, colb, mask, starts


@torch.no_grad()
def pb_decode(model, memory, src_mask, *, sample_method: str = "greedy",
              temperature: float = 1.0, packed_width: Optional[int] = None,
              generator: Optional[torch.Generator] = None,
              stats: Optional[Dict[str, int]] = None
              ) -> Dict[str, torch.Tensor]:
    """The PB_pad decode from the encoder ``memory`` [B, R, D] and
    ``src_mask`` [B, R]: each round one next-length prediction over the
    plan so far, the new phrase appended (clamped to the caption and to
    the packed width), one packed decode, and the new column's words drawn
    by ``sample_method`` (a sampled method from ``generator``).

    Returns {'seq', 'tok_logprobs', 'entropy', 'phrase_length'} [B, L] and
    'phrase_num' [B].  ``stats``, if given, receives 'rounds', 'fills' and
    'host_syncs'."""
    L = model.max_length
    L2 = L + 2
    B = memory.shape[0]
    dev = memory.device
    W = int(packed_width) if packed_width else default_width(L)
    P = L + 1                       # next-phrase columns (slots 1..L+1)
    WG = min(P, W)                  # the head's window: a phrase's words
    pos2 = torch.arange(L2, device=dev)
    rows = torch.arange(B, device=dev)
    win = torch.arange(WG, device=dev)

    seq = torch.zeros((B, L2), dtype=torch.long, device=dev)
    seq[:, 0] = BOS
    pl = torch.zeros((B, L2), dtype=torch.long, device=dev)
    pl[:, 0] = 1
    pn = torch.ones(B, dtype=torch.long, device=dev)
    cur_start = torch.ones(B, dtype=torch.long, device=dev)
    unfinished = torch.ones(B, dtype=torch.bool, device=dev)
    tok = torch.zeros((B, L2), dtype=torch.float32, device=dev)
    ent = torch.zeros((B, L2), dtype=torch.float32, device=dev)
    counts = {"rounds": 0, "fills": 0, "host_syncs": 0}

    for t in range(L):
        len_lp = model.pb_length_predict(seq, pn, pl, memory, src_mask)
        nxt = torch.argmax(len_lp, -1)[rows, pn - 1]                 # [B]
        # the plan append (pb_decode_host's bookkeeping, vectorised)
        n = torch.minimum(nxt, L + 1 - cur_start)
        n_eff = torch.where(unfinished & (n > 0), n, 0)
        new_unf = unfinished & (n > 0) & (nxt + cur_start < L + 1)
        # the packed-width clamp, per sample: the new column starts where
        # the others end; a sample whose phrase would spill past W ends
        prev_width = pl[:, 1:1 + P].max(0).values.sum()
        fits = prev_width + n_eff <= W
        n_eff = torch.where(fits, n_eff, 0)
        new_unf = new_unf & fits
        pl_work = torch.where((pos2[None, :] == t + 1) & (n_eff[:, None] > 0),
                              n_eff[:, None], pl)
        pn_work = pn + (n_eff > 0).long()

        # the round's one host sync: does a sample append (the fill), is
        # one still unfinished (the next round)
        fill, more = torch.stack([(n_eff > 0).any(), new_unf.any()]).tolist()
        counts["host_syncs"] += 1
        counts["rounds"] += 1
        if fill:
            counts["fills"] += 1
            ids, slot, mask, starts = packed_layout(seq, pl_work, P, W)
            h = model.pb_decode(ids, slot, seq, pl_work, memory, src_mask,
                                mask, return_hidden=True)            # [B, W, D]
            # the vocabulary head over the new column's window only: a
            # phrase has at most P words, so WG rows from the column's
            # start (held inside the buffer) cover it
            q0 = starts[t]
            q0c = q0.clamp(0, W - WG)
            logprob = model.generate(h.index_select(1, q0c + win))   # [B, WG, V]
            words, wlp = sample_next_word(logprob, sample_method,
                                          temperature, generator)
            went = -(torch.exp(logprob) * logprob).sum(-1)           # [B, WG]
            # seq[b, cur_start + o] = words[b, q0 - q0c + o]
            off = pos2[None, :] - cur_start[:, None]
            take = (off >= 0) & (off < n_eff[:, None])
            gidx = (q0 - q0c + off).clamp(0, WG - 1)
            seq = torch.where(take, torch.gather(words, 1, gidx), seq)
            tok = torch.where(take, torch.gather(wlp.float(), 1, gidx), tok)
            ent = torch.where(take, torch.gather(went.float(), 1, gidx), ent)
        cur_start = cur_start + n_eff
        pl, pn, unfinished = pl_work, pn_work, new_unf
        if not more:
            break
    if stats is not None:
        stats.update(counts)
    return {"seq": seq[:, 1:-1], "tok_logprobs": tok[:, 1:-1],
            "entropy": ent[:, 1:-1], "phrase_num": pn - 1,
            "phrase_length": pl[:, 1:-1]}


@torch.no_grad()
def pb_decode_host(model, att_feats, att_masks, *,
                   sample_method: str = "greedy", temperature: float = 1.0,
                   pad_to: Optional[int] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
    """The host-driven PB_pad loop (the JAX package's oracle): encodes
    ``att_feats`` itself, packs each round with ``pack_decoder_inputs`` at
    that round's own width (``pad_to``: padded to a fixed width, ids and
    slots with 0 and the mask with False).  Returns {'seq', 'phrase_num',
    'phrase_length'} as int32 numpy arrays, [B, L] and [B]."""
    L = model.max_length
    L2 = L + 2
    dev = att_feats.device
    B = att_feats.shape[0]
    memory = model.encode(att_feats, att_masks)
    src_mask = att_masks.bool()

    def t(a):
        return torch.as_tensor(a, device=dev)

    seq = np.zeros((B, L2), np.int64)
    seq[:, 0] = BOS
    pl = np.zeros((B, L2), np.int64)
    pl[:, 0] = 1
    pn = np.ones(B, np.int64)            # the bos phrase included
    cur_start = np.ones(B, np.int64)
    unfinished = np.ones(B, bool)

    for _ in range(L):
        len_lp = model.pb_length_predict(t(seq), t(pn), t(pl), memory,
                                         src_mask).cpu().numpy()
        nxt = len_lp.argmax(-1)[np.arange(B), pn - 1]

        # append the predicted next phrase to a working plan, then pack
        pl_work = pl.copy()
        pn_work = pn.copy()
        n_eff = np.zeros(B, np.int64)
        for b in range(B):
            if not unfinished[b]:
                continue
            n = int(min(nxt[b], L + 1 - cur_start[b]))
            if int(nxt[b]) + int(cur_start[b]) >= L + 1:
                unfinished[b] = False        # clamped: the final phrase
            if n == 0:
                unfinished[b] = False
                continue
            n_eff[b] = n
            pl_work[b, pn_work[b]] = n
            pn_work[b] += 1
        if n_eff.sum() == 0:
            break

        ids, slot, mask = pack_decoder_inputs(seq, pn_work, pl_work)
        if pad_to is not None and ids.shape[1] < pad_to:
            w = pad_to - ids.shape[1]
            ids = np.pad(ids, ((0, 0), (0, w)))
            slot = np.pad(slot, ((0, 0), (0, w)))
            mask = np.pad(mask, ((0, 0), (0, w), (0, w)))
        logprob = model.pb_decode(t(ids), t(slot), t(seq), t(pl_work),
                                  memory, src_mask, t(mask))
        words, _ = sample_next_word(logprob, sample_method, temperature,
                                    generator)
        words = words.cpu().numpy()

        # the new phrase's packed column: next-slot index = old pn - 1
        # (alive samples advance in lockstep, so they share it)
        max_pn = int(pn_work.max())
        col_max = pl_work[:, 1:][:, :max_pn].max(axis=0)
        alive = unfinished | (n_eff > 0)
        col_new = int(pn[alive].max()) - 1 if alive.any() else 0
        last_start = int(col_max[:col_new].sum())

        for b in range(B):
            n = int(n_eff[b])
            if n == 0:
                continue
            seq[b, cur_start[b]:cur_start[b] + n] = \
                words[b, last_start:last_start + n]
            pl[b] = pl_work[b]
            pn[b] = pn_work[b]
            cur_start[b] = pl[b].sum()
        if not unfinished.any():
            break

    return {"seq": seq[:, 1:-1].astype(np.int32),
            "phrase_num": (pn - 1).astype(np.int32),
            "phrase_length": pl[:, 1:-1].astype(np.int32)}
