"""PB_pad packed phrase layout (host-side, numpy): the port's copy of the
JAX package's ``data/pb_pack.py``.

The legacy phrase-based variant aligns every sample's phrases to per-column
maxima: column j holds phrase j's words, padded to max_b len_j.  The packed
width is BATCH-DEPENDENT (sum of column maxima) — inherently dynamic, so
this layout stays host-built exactly like the reference
(dataloader.py:398-428, TransformerModel.py:1138-1213).

Two layouts:
  * GT packing (pack_gt): columns = phrase_length slots 0.. (bos col first)
    -> the loss targets ('phrase' + 'masks' in the reference collate).
  * Decoder packing (pack_decoder_inputs): columns = NEXT phrase lengths
    (phrase_length[:, 1:]); position contents = copy-init from the CURRENT
    phrase's words; mask = key-padding & phrase-blockwise-causal
    (phrase_subsequent_mask, TransformerModel.py:982-991).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _col_layout(col_lens: np.ndarray) -> Tuple[np.ndarray, int]:
    starts = np.zeros(len(col_lens), dtype=np.int64)
    for j in range(1, len(col_lens)):
        starts[j] = starts[j - 1] + col_lens[j - 1]
    return starts, int(col_lens.sum())


def pack_gt(labels: np.ndarray, phrase_num: np.ndarray,
            phrase_length: np.ndarray):
    """-> (packed [B, PL], masks [B, PL]) — gt words per aligned column
    (reference dataloader.py:398-419)."""
    B = labels.shape[0]
    max_pn = int(phrase_num.max())
    col_max = phrase_length[:, :max_pn].max(axis=0)
    starts, PL = _col_layout(col_max)
    packed = np.zeros((B, PL), dtype=np.int64)
    for b in range(B):
        last = 0
        for j in range(int(phrase_num[b])):
            n = int(phrase_length[b, j])
            packed[b, starts[j]:starts[j] + n] = labels[b, last:last + n]
            last += n
    return packed, (packed != 0).astype(np.float32)


def pack_decoder_inputs(labels: np.ndarray, phrase_num: np.ndarray,
                        phrase_length: np.ndarray):
    """-> (packed_ids [B, Lp], packed_slot [B, Lp], packed_mask [B, Lp, Lp]).

    Column j (width max_b next_len[:, j]) is the decoder input for phrase
    j+1: copy-init from phrase j's words (truncate / round-robin,
    TransformerModel.py:1180-1199); packed_slot[p] = j (the CURRENT phrase's
    compressed-embedding slot, used by compress/complex norm_modes)."""
    B = labels.shape[0]
    next_len = phrase_length[:, 1:]
    max_pn = int(phrase_num.max())
    col_max = next_len[:, :max_pn].max(axis=0)
    starts, Lp = _col_layout(col_max)

    ids = np.zeros((B, Lp), dtype=np.int64)
    slot = np.zeros((B, Lp), dtype=np.int64)
    key_ok = np.zeros((B, Lp), dtype=bool)
    for j in range(max_pn):
        slot[:, starts[j]:starts[j] + col_max[j]] = j
    for b in range(B):
        src_start = 0
        for j in range(int(phrase_num[b])):
            cur = int(next_len[b, j])
            prev = int(phrase_length[b, j])
            if cur == 0:
                src_start += prev
                continue
            lo = starts[j]
            if cur <= prev:
                pre = prev - cur
                ids[b, lo:lo + cur] = labels[b, src_start + pre:
                                             src_start + pre + cur]
            else:
                pre_less = prev - cur % prev
                ct = cur // prev
                copied = 0
                for k in range(prev):
                    times = ct if k < pre_less else ct + 1
                    ids[b, lo + copied:lo + copied + times] = \
                        labels[b, src_start + k]
                    copied += times
            key_ok[b, lo:lo + cur] = True
            src_start += prev

    # phrase_subsequent_mask (TransformerModel.py:982-991)
    sub = np.zeros((Lp, Lp), dtype=bool)
    if max_pn:
        for j in range(max_pn - 1):
            sub[starts[j]:starts[j + 1] if j + 1 < max_pn else Lp,
                :starts[j + 1]] = True
        sub[starts[-1]:, :] = True
    mask = key_ok[:, None, :] & sub[None]
    return ids, slot, mask
