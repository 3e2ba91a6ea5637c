"""Closed-form phrase-tensor math of the training forward and the losses:
the port of the JAX package's ``data/phrase_ops.py`` (reference
captioning/data/dataloader.py:343-428 and the mask loops of
TransformerModel.py:476-513, :532-565), as torch functions on integer
tensors.

Conventions (all static):

  L   = max caption length in words (reference ``seq_length`` = 20)
  L2  = L + 2 (bos/[LEN] slot at 0, eos slot at the end)

``phrase_length`` rows look like ``[1, l_1, ..., l_n, 0, ...]`` of width
L2: the leading 1 is the bos "phrase", ``l_1..l_n`` the real phrase
lengths, and ``n + 1 == phrase_num``.  Every function works over any
number of leading batch dimensions.
"""

from __future__ import annotations

import torch

from ..constants import LEN, PAD

__all__ = [
    "phrase_word_ends",
    "total_words",
    "extend_syn_seq",
    "copy_init_src_indices",
    "copy_init",
    "blockwise_visible",
    "blockwise_mask",
    "bound_prefixes",
    "bound_step_masks",
    "word_loss_mask",
    "slot_loss_mask",
]


def _row(ref: torch.Tensor, n_lead: int, length: int) -> torch.Tensor:
    """arange(length) broadcastable after n_lead batch dimensions."""
    return torch.arange(length, device=ref.device).reshape(
        (1,) * n_lead + (length,))


def phrase_word_ends(phrase_length):
    """``ends[..., k]`` = words covered by phrases 1..k+1 (the bos slot
    excluded); constant == total beyond slot n.  Shape ``[..., L2 - 1]``."""
    return torch.cumsum(phrase_length[..., 1:], dim=-1)


def total_words(phrase_length):
    """Real words = sum(phrase_length) - 1 (the bos slot excluded)."""
    return phrase_length.sum(-1) - 1


def _slot_of(ends, pos):
    """0-based real-phrase slot containing word position ``pos`` [..., T]."""
    return (pos[..., :, None] >= ends[..., None, :]).sum(-1)


def extend_syn_seq(phrase_length, phrase_syn, L: int):
    """Word-level expansion of per-phrase syntax ids with [LEN] at slot 0:
    ``[..., L + 2]``; position 1 + p holds the syn id of the phrase that
    holds word p, PAD past the caption (reference dataloader.py:372-375)."""
    ends = phrase_word_ends(phrase_length)
    total = total_words(phrase_length)
    lead = phrase_length.dim() - 1
    p = _row(phrase_length, lead, L + 1).expand(
        phrase_length.shape[:-1] + (L + 1,))
    k = _slot_of(ends, p).clamp(0, ends.shape[-1] - 1)
    syn_of = torch.gather(phrase_syn[..., 1:], -1, k)
    body = torch.where(p < total[..., None], syn_of, PAD)
    head = torch.full(phrase_length.shape[:-1] + (1,), LEN,
                      dtype=phrase_length.dtype, device=phrase_length.device)
    return torch.cat([head, body.to(phrase_length.dtype)], dim=-1)


def copy_init_src_indices(phrase_length, L: int):
    """Source index into the bos-framed label row for each extend position
    of the SA decoder's copied-word input (reference dataloader.py:377-396;
    the JAX function's docstring derives the closed form).  Returns
    ``(src, valid)`` of shape ``[..., L]``; invalid positions get 0."""
    P = phrase_length.shape[-1] - 1
    ends = phrase_word_ends(phrase_length)
    total = total_words(phrase_length)
    C = torch.cumsum(phrase_length, dim=-1)
    lead = phrase_length.dim() - 1
    t = _row(phrase_length, lead, L).expand(phrase_length.shape[:-1] + (L,))
    k = _slot_of(ends, t).clamp(0, P - 1)

    def take(a, idx):
        return torch.gather(a, -1, idx)

    start = torch.where(k > 0, take(ends, (k - 1).clamp(0, P - 1)), 0)
    cur = take(phrase_length[..., 1:], k)
    prev = take(phrase_length, k)
    seq_last = torch.where(k > 0, take(C, (k - 1).clamp(0, C.shape[-1] - 1)),
                           0)
    o = t - start
    prev_safe = prev.clamp_min(1)
    ct = (cur // prev_safe).clamp_min(1)
    pre_less = prev - cur % prev_safe
    src_short = seq_last + (prev - cur) + o
    in_head = o < pre_less * ct
    k_src = torch.where(in_head, o // ct,
                        pre_less + (o - pre_less * ct) // (ct + 1))
    src = torch.where(cur <= prev, src_short, seq_last + k_src)
    valid = t < total[..., None]
    src = torch.where(valid, src, 0)
    return src.to(phrase_length.dtype), valid


def copy_init(labels, phrase_length, L: int):
    """``extend_phrase_seq``: the SA decoder's copied-word input [..., L]."""
    src, valid = copy_init_src_indices(phrase_length, L)
    vals = torch.gather(labels, -1, src.long())
    return torch.where(valid, vals, PAD)


def blockwise_visible(phrase_length, L: int):
    """Per-row visible prefix of the SA decoder's blockwise mask: row q
    sees keys < end(phrase holding q); overflow rows see the whole
    caption.  Int ``[..., L]``."""
    P = phrase_length.shape[-1] - 1
    ends = phrase_word_ends(phrase_length)
    n = (phrase_length[..., 1:] > 0).sum(-1)
    lead = phrase_length.dim() - 1
    q = _row(phrase_length, lead, L).expand(phrase_length.shape[:-1] + (L,))
    k = _slot_of(ends, q)
    k = torch.minimum(k, (n[..., None] - 1).clamp_min(0)).clamp(0, P - 1)
    vis = torch.gather(ends, -1, k)
    return torch.where(n[..., None] > 0, vis, 0)


def blockwise_mask(phrase_length, L: int):
    """Dense bool ``[..., L, L]`` of ``extend_phrase_seq_mask``."""
    vis = blockwise_visible(phrase_length, L)
    key = _row(vis, vis.dim() - 1, L)[..., None, :]
    return key < vis[..., :, None]


def bound_prefixes(phrase_length, steps: int):
    """Visible prefix of the [LEN] query at each teacher-forcing step:
    ``1 + sum(l_1..l_i)`` at step i.  Shape ``[..., steps]``."""
    ends = phrase_word_ends(phrase_length)
    zero = torch.zeros(ends.shape[:-1] + (1,), dtype=ends.dtype,
                       device=ends.device)
    return 1 + torch.cat([zero, ends[..., :steps - 1]], dim=-1)


def bound_step_masks(phrase_length, steps: int, L2: int):
    """Full ``[..., steps, L2, L2]`` masks of the teacher-forcing loop
    (needed when N_len > 1): row 0 at step i sees keys < cum[min(i, n)];
    row q >= 1 sees keys < cum[k*], k* = min(i, #{m < n : cum[m] <= q}),
    or only key 0 when k* == 0."""
    n = (phrase_length[..., 1:] > 0).sum(-1)
    cum = bound_prefixes(phrase_length, L2 - 1)               # [..., L2-1]
    lead = phrase_length.dim() - 1
    i = _row(phrase_length, lead, steps)[..., :, None]        # [..., S, 1]
    q = _row(phrase_length, lead, L2)                         # [..., L2]
    m = _row(phrase_length, lead, L2 - 1)
    m_valid = m[..., None, :] < n[..., None, None]            # [..., 1, L2-1]
    r = ((cum[..., None, :] <= q[..., :, None]) & m_valid).sum(-1)
    k_star = torch.minimum(i, r[..., None, :])                # [..., S, L2]
    k_idx = k_star.clamp(0, cum.shape[-1] - 1)
    cum_b = cum[..., None, :].expand(cum.shape[:-1] + (steps, cum.shape[-1]))
    vis = torch.gather(cum_b, -1, k_idx)
    vis = torch.where(k_star >= 1, vis, 1)
    i0 = torch.minimum(i[..., 0], n[..., None]).clamp(0, cum.shape[-1] - 1)
    vis0 = torch.gather(cum, -1, i0)                          # [..., S]
    vis = torch.where(q[..., None, :] == 0, vis0[..., :, None], vis)
    key = torch.arange(L2, device=phrase_length.device).reshape(
        (1,) * lead + (1, 1, L2))
    return key < vis[..., None]


def word_loss_mask(phrase_length, L: int):
    """Bool ``[..., L]``: positions < sum(phrase_length) - 1."""
    total = total_words(phrase_length)
    return _row(total, total.dim(), L) < total[..., None]


def slot_loss_mask(phrase_num, S: int):
    """Bool ``[..., S]``: slots < phrase_num."""
    return _row(phrase_num, phrase_num.dim(), S) < phrase_num[..., None]
