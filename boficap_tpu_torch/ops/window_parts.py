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

Both entries run one launch plan: no copy launch while ``proj`` is on,
the bf16 launches chained (the float32 ones plain), and every product on
a tile that fills the card at 512 rows (``product_tile``,
``layer_products``; at bf16 chosen by N alone).  A shape the kernels
cannot stage raises ``ValueError`` before any launch.

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
from typing import Dict, Iterable, List, Tuple

import torch

from .decoder_layer import (MASK_FILL, SMEM_LIMIT, _route, attention_plain,
                            linear_plain, refnorm_plain, window_layer_call)

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
# csrc/hb_attention.cuh: query rows a block, blocks a cluster at most,
# keys a staged chunk of K or V
HB_ROWS = 16
HB_CLUSTER = 8
HB_KC = 64
# the CUDA launches of one ``fused_window_layer_hb`` call by kind: #10's
# full plan with both attentions on the hb block
HB_LAUNCHES = {"refnorm": 3, "products": 6, "hb_attention": 2}
# csrc/ffma_gemm.cuh: the SMs tile_for fills
NUM_SMS = 132


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
    (mirrors csrc/window_parts.cu): the qkv and out products with
    ``proj``, and the self-attention between them with ``self`` (without
    it the qkv product's epilogue writes q and the fresh K/V); without
    ``proj`` one launch writes n0 into k_new and v_new (and x into out when
    no sublayer follows): a refnorm with ``norm``, else a copy; two
    products and an attention with ``cross``, two products with ``ffn``;
    with ``norm`` a refnorm before each sublayer's first product.  The
    full layer: 11, as #8."""
    parts = check_parts(parts)
    proj, cross, ffn = ("proj" in parts, "cross" in parts, "ffn" in parts)
    norm = "norm" in parts
    return {"refnorm": int(norm) * (1 + cross + ffn),
            "products": 2 * (proj + cross + ffn),
            "attention": int(proj and "self" in parts) + int(cross),
            "copy": int(not proj and not norm)}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def hb_cluster(H: int) -> int:
    """Blocks a cluster of the hb block (csrc/hb_attention.cuh
    ``hb_cluster``): the largest of 8, 4, 2, 1 that divides H."""
    c = HB_CLUSTER
    while H % c:
        c //= 2
    return c


def hb_shared_bytes(Lk: int, D: int, H: int, esize: int) -> int:
    """Shared memory of one hb attention block at Lk keys, elements of
    ``esize`` bytes (csrc/hb_attention.cuh ``hb_smem``): the block's
    HB_ROWS query rows of its heads (float32; then the context sums), two
    chunk buffers of min(Lk, HB_KC) keys' K or V of its heads (rows padded
    to 16 bytes, plus 16), the score rows of every key, two maxima a row,
    and the mask bytes."""
    hpc, Dh = H // hb_cluster(H), D // H
    pitch = _cdiv(hpc * Dh * esize, 16) * 16 + 16
    return (4 * HB_ROWS * hpc * Dh + 2 * min(Lk, HB_KC) * pitch
            + 4 * HB_ROWS * hpc * Lk + 4 * 2 * HB_ROWS
            + _cdiv(HB_ROWS * Lk, 16) * 16)


def tile_n(N: int) -> int:
    """BN of a bf16 product of the layer (csrc/wgmma_gemm.cuh
    ``parts_tile_n``): from N alone, the widest of 128, 64 and 32 that cuts
    N into at least 16 column tiles."""
    return 128 if N >= 16 * 128 else 64 if N >= 16 * 64 else 32


def ffma_tile(M: int, N: int) -> Tuple[int, int]:
    """(BM, BN) of a float32 product whose A a predecessor wrote
    (csrc/ffma_gemm.cuh ``tile_for``): 128 x 128 where its blocks fill at
    least 3/4 of the NUM_SMS-block waves they take, else 32 x 64."""
    b = _cdiv(M, 128) * _cdiv(N, 128)
    waves = _cdiv(b, NUM_SMS)
    return (128, 128) if 4 * b >= 3 * waves * NUM_SMS else (32, 64)


def product_tile(M: int, N: int, dtype) -> Tuple[int, int, int]:
    """(BM, BN, blocks) of an M x N product of the layer
    (csrc/window_parts.cu ``bfc_window_parts_tile``): at bf16 BM = 64 and
    ``tile_n(N)``, at float32 ``ffma_tile`` (#8's)."""
    bm, bn = (64, tile_n(N)) if dtype == torch.bfloat16 else ffma_tile(M, N)
    return bm, bn, _cdiv(M, bm) * _cdiv(N, bn)


def layer_products(B: int, W: int, D: int, F: int
                   ) -> List[Tuple[str, int, int, int]]:
    """The full layer's six products in launch order: (name, M, N, K)."""
    M = B * W
    return [("qkv", M, 3 * D, D), ("out", M, D, D), ("q2", M, D, D),
            ("out2", M, D, D), ("w1", M, F, D), ("w2", M, D, F)]


def check_staging(L: int, W: int, R: int, D: int, H: int, dtype) -> None:
    """Raise ValueError where an hb attention block's staging (its
    heads' K and V chunks, the score row of every key) would pass the
    card's shared memory (csrc/window_parts.cu refuses it)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    for name, Lk in (("self-attention", L + W), ("cross-attention", R)):
        smem = hb_shared_bytes(Lk, D, H, esize)
        if smem > SMEM_LIMIT:
            raise ValueError(
                f"{name}: {Lk} keys at width {D} need {smem} bytes of shared "
                f"memory an hb block, over the {SMEM_LIMIT} the card gives")


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
    (``kernel_launches(parts)``); with every part, #8's outputs, bitwise."""
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
    (``HB_LAUNCHES``); raises ValueError where an hb block's staging (``hb_shared_bytes``) would pass
    the card's shared memory."""
    if not _route(x_win, k_cache, v_cache, k2, v2, w):
        return window_layer_hb_plain(x_win, k_cache, v_cache, k2, v2,
                                     tgt_mask, src_mask, w, num_heads)
    check_staging(k_cache.shape[1], x_win.shape[1], k2.shape[1],
                  x_win.shape[-1], num_heads, x_win.dtype)
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
