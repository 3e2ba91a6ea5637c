"""The windowed decoder layer taken apart: the port of the two TPU kernels
of the kernel-parts tool (``scripts/bench_kernel_parts.py``).

  ``fused_window_layer_parts`` <- ``_abl_kernel`` (bench_kernel_parts.py:36;
                                  ``abl_layer``, pallas_call :164)
  ``fused_window_layer_hb``    <- ``_hb_kernel``  (bench_kernel_parts.py:327;
                                  ``hb_layer``, pallas_call :460)

Both take the window layer's operands and weights (#8,
``ops.decoder_layer.fused_window_decoder_layer``; w one of
``pack_window_weights(...).layers``) and return ``(out, k_new, v_new)``,
each [B, W, D].  ``fused_window_layer_parts`` runs the layer with parts
switched off (``parts``, a set of ``PARTS``); ``fused_window_layer_hb``
runs it with both attentions taking one softmax max a query row across
every head.  On a CUDA tensor a wrapper makes one call into
``csrc/window_parts.cu`` (``kernel_launches`` gives its launches); on a CPU
tensor it runs its plain twin (``*_plain``), which repeats the kernel's
arithmetic and rounding; any other device raises.  Each counts its CUDA
calls in ``.launches`` (``COUNTED``).

The TPU kernels batch G samples in one grid step with block-diagonal masks
(``_block_diag_masks``): a key of another sample is filled with 2 * -1e9, a
masked key of the row's own sample with -1e9.  A row's max is therefore at
least -1e9, so exp(2 * -1e9 - max) is exactly 0 in float32 and a
cross-sample key adds an exact 0 to every sum and every context: the
function is per sample.  The port takes per-sample masks (tgt [B, W, L +
W], src [B, R] or [B, W, R]), as #8 does.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable

import torch

from .decoder_layer import (MASK_FILL, SMEM_LIMIT, _route,
                            attention_plain, linear_plain, refnorm_plain,
                            window_layer_call)

# _abl_kernel's parts: proj (the q/k/v and out products), self (the
# self-attention), cross (the cross-attention sublayer), ffn, norm (the
# three RefLayerNorms); the C entry takes them as a bit mask in this order
PARTS = ("proj", "self", "cross", "ffn", "norm")
ALL_PARTS = frozenset(PARTS)
# the kernel-parts tool's variants, in its order
VARIANTS = (("full", ALL_PARTS),
            ("no_self", ALL_PARTS - {"self"}),
            ("no_cross", ALL_PARTS - {"cross"}),
            ("no_ffn", ALL_PARTS - {"ffn"}),
            ("no_norm", ALL_PARTS - {"norm"}),
            ("proj_only", frozenset({"proj"})),
            ("empty", frozenset()))
# csrc/hb_attention.cuh: query rows a block
HB_ROWS = 4
# the CUDA launches of one ``fused_window_layer_hb`` call by kind: #8's
# eleven with both attentions on the hb block
HB_LAUNCHES = {"refnorm": 3, "products": 6, "hb_attention": 2}


def check_parts(parts: Iterable[str]) -> frozenset:
    """``parts`` as a frozenset of PARTS; raises ValueError on any other
    name."""
    parts = frozenset(parts)
    unknown = sorted(parts - ALL_PARTS)
    if unknown:
        raise ValueError(f"unknown part(s) {unknown}: the parts are "
                         f"{list(PARTS)}")
    return parts


def parts_mask(parts) -> int:
    """The C entry's bit mask of ``parts``."""
    return sum(1 << PARTS.index(p) for p in check_parts(parts))


def kernel_launches(parts) -> Dict[str, int]:
    """The CUDA launches of one ``fused_window_layer_parts`` call by kind
    (mirrors csrc/window_parts.cu): a refnorm a sublayer that runs, with
    ``norm``; the qkv and out products with ``proj``, then the
    self-attention with ``self`` or else one copy (q and the fresh K/V out
    of the qkv product); without ``proj`` one copy (n0 into k_new and
    v_new, and x into out when no sublayer follows); two products and an
    attention with ``cross``, two products with ``ffn``.  The full layer:
    11."""
    parts = check_parts(parts)
    proj, cross, ffn = ("proj" in parts, "cross" in parts, "ffn" in parts)
    attention = int(proj and "self" in parts) + int(cross)
    return {"refnorm": (1 + cross + ffn) if "norm" in parts else 0,
            "products": 2 * (proj + cross + ffn),
            "attention": attention,
            "copy": int(not proj or "self" not in parts)}


def hb_shared_bytes(Lk: int, D: int, H: int) -> int:
    """Shared memory of one hb attention block at Lk keys
    (csrc/hb_attention.cuh ``hb_smem``): the block's HB_ROWS query rows,
    their score rows over every head and one head's K or V, float32, its
    rows' maxima, and its mask bytes."""
    Dh = D // H
    return (4 * (HB_ROWS * D + HB_ROWS * H * Lk + Lk * (Dh + 1) + HB_ROWS)
            + HB_ROWS * Lk)


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

def window_layer_parts_plain(x, k_cache, v_cache, k2, v2, tgt_mask, src_mask,
                             w, num_heads: int, parts):
    """_abl_kernel line by line (bench_kernel_parts.py:56-141) on the port's
    packed window weights (``wqkv`` [D, 3D]): a RefLayerNorm only with
    ``norm``; without ``proj`` q = k_new = v_new = n0 and no self sublayer;
    with ``proj`` and not ``self`` x += q @ Wo + bo; the cross and FFN
    sublayers only with ``cross`` / ``ffn``.  The attentions are #8's
    (``attention_plain``: scores divided by sqrt(Dh), which the TPU kernel
    multiplies by 1/sqrt(Dh): the same where sqrt(Dh) is a power of two).
    Returns (out, k_new, v_new), each [B, W, D]."""
    parts = check_parts(parts)
    D = x.shape[-1]

    def norm(t, s, b):
        return refnorm_plain(t, w[s], w[b]) if "norm" in parts else t

    n0 = norm(x, "s0", "b0")
    if "proj" in parts:
        q, k, v = linear_plain(n0, w["wqkv"], w["bqkv"]).split(D, dim=-1)
        if "self" in parts:
            q = attention_plain(q, torch.cat([k_cache, k], 1),
                                torch.cat([v_cache, v], 1), tgt_mask,
                                num_heads)
        x = linear_plain(q, w["wo"], w["bo"], res=x)
    else:
        k = v = n0
    if "cross" in parts:
        q2 = linear_plain(norm(x, "s1", "b1"), w["wq2"], w["bq2"])
        x = linear_plain(attention_plain(q2, k2, v2, src_mask, num_heads),
                         w["wo2"], w["bo2"], res=x)
    if "ffn" in parts:
        f = linear_plain(norm(x, "s2", "b2"), w["w1"], w["bf1"], relu=True)
        x = linear_plain(f, w["w2"], w["bf2"], res=x)
    # fresh tensors, as the kernel writes: never the caller's x or one
    # tensor twice
    return tuple(t.clone(memory_format=torch.contiguous_format)
                 for t in (x, k, v))


def hb_attention_plain(q, k, v, mask, num_heads: int):
    """_hb_kernel's attention (bench_kernel_parts.py:354-390, 401-428) per
    sample: q [B,Lq,D], k/v [B,Lk,D], bool mask [B,Lk] | [B,Lq,Lk] ->
    [B,Lq,D].  Scores times the float32 1/sqrt(Dh), masked with -1e9; ONE
    max a query row across every head; each head's exp summed over its
    own keys (the TPU's indicator products); p normalised, cast to the
    compute dtype, then times V."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    H = num_heads
    Dh = D // H
    qh = q.float().reshape(B, Lq, H, Dh)
    kh = k.float().reshape(B, Lk, H, Dh)
    vh = v.float().reshape(B, Lk, H, Dh)
    s = torch.einsum("bqhd,bkhd->bqhk", qh, kh) * (1.0 / math.sqrt(Dh))
    m = mask[:, None, None, :] if mask.dim() == 2 else mask[:, :, None, :]
    s = torch.where(m, s, MASK_FILL)
    e = torch.exp(s - s.amax(dim=(-2, -1), keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(q.dtype)
    ctx = torch.einsum("bqhk,bkhd->bqhd", p.float(), vh).to(q.dtype)
    return ctx.reshape(B, Lq, D)


def window_layer_hb_plain(x, k_cache, v_cache, k2, v2, tgt_mask, src_mask, w,
                          num_heads: int):
    """_hb_kernel (bench_kernel_parts.py:327-437): #8's layer with both
    attentions on ``hb_attention_plain``.  Returns (out, k_new, v_new)."""
    D = x.shape[-1]
    n0 = refnorm_plain(x, w["s0"], w["b0"])
    q, k, v = linear_plain(n0, w["wqkv"], w["bqkv"]).split(D, dim=-1)
    att = hb_attention_plain(q, torch.cat([k_cache, k], 1),
                             torch.cat([v_cache, v], 1), tgt_mask, num_heads)
    x = linear_plain(att, w["wo"], w["bo"], res=x)
    q2 = linear_plain(refnorm_plain(x, w["s1"], w["b1"]), w["wq2"], w["bq2"])
    x = linear_plain(hb_attention_plain(q2, k2, v2, src_mask, num_heads),
                     w["wo2"], w["bo2"], res=x)
    f = linear_plain(refnorm_plain(x, w["s2"], w["b2"]), w["w1"], w["bf1"],
                     relu=True)
    return (linear_plain(f, w["w2"], w["bf2"], res=x), k.contiguous(),
            v.contiguous())


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def fused_window_layer_parts(x_win, k_cache, v_cache, k2, v2, tgt_mask,
                             src_mask, w, num_heads: int, parts):
    """One windowed decoder layer with only ``parts`` (a set of PARTS; an
    unknown name raises ValueError), inference; operands and weights as
    ``fused_window_decoder_layer``'s.  Returns (out, k_new, v_new), each
    [B, W, D].  On CUDA: one call of csrc/window_parts.cu
    (``kernel_launches(parts)``); with every part, #8's launches, bitwise
    #8's outputs."""
    parts = check_parts(parts)
    if not _route(x_win, k_cache, v_cache, k2, v2, w):
        return window_layer_parts_plain(x_win, k_cache, v_cache, k2, v2,
                                        tgt_mask, src_mask, w, num_heads,
                                        parts)
    out = window_layer_call(x_win, k_cache, v_cache, k2, v2, tgt_mask,
                            src_mask, w, num_heads, lib="window_parts",
                            entry="window_layer_parts",
                            extra=(parts_mask(parts),))
    fused_window_layer_parts.launches += 1
    return out


def fused_window_layer_hb(x_win, k_cache, v_cache, k2, v2, tgt_mask,
                          src_mask, w, num_heads: int):
    """One windowed decoder layer whose attentions take one softmax max a
    query row across every head (``window_layer_hb_plain``), inference;
    operands and weights as ``fused_window_decoder_layer``'s.  Returns
    (out, k_new, v_new).  On CUDA: one call of csrc/window_parts.cu
    (``HB_LAUNCHES``); raises ValueError where an hb block's staging
    (``hb_shared_bytes``) would pass the card's shared memory."""
    if not _route(x_win, k_cache, v_cache, k2, v2, w):
        return window_layer_hb_plain(x_win, k_cache, v_cache, k2, v2,
                                     tgt_mask, src_mask, w, num_heads)
    D = x_win.shape[-1]
    for name, Lk in (("self-attention", k_cache.shape[1] + x_win.shape[1]),
                     ("cross-attention", k2.shape[1])):
        smem = hb_shared_bytes(Lk, D, num_heads)
        if smem > SMEM_LIMIT:
            raise ValueError(
                f"{name}: {Lk} keys at width {D} need {smem} bytes of shared "
                f"memory an hb block, over the {SMEM_LIMIT} the card gives")
    out = window_layer_call(x_win, k_cache, v_cache, k2, v2, tgt_mask,
                            src_mask, w, num_heads, lib="window_parts",
                            entry="window_layer_hb")
    fused_window_layer_hb.launches += 1
    return out


fused_window_layer_parts.launches = 0
fused_window_layer_hb.launches = 0

# this module's counted wrappers, by kernel name (``ops.launch_counts``)
COUNTED = {"window_layer_parts": fused_window_layer_parts,
           "window_layer_hb": fused_window_layer_hb}
