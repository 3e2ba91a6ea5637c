"""The attention core on a hand-written CUDA kernel: the port of the JAX
package's ``ops/pallas_attention.py``.

  ``attention_core`` <- ``_kernel`` (pallas_attention.py:33, pallas_call :65)

Scores, mask, softmax and context for all heads in one launch, in place of
the ~7 ops of the plain path (two einsums, the scale, the fill, the
softmax, two casts).  ``MultiHeadAttention.attend`` routes to it where the
JAX package routes to its TPU kernel: with the model's ``use_pallas`` set
(``BoFiCap.set_attention_core``) and a mask of rank 2 or 3.  On the decode
paths that is both attentions of the KV-cached AR step (the self-attention
over the cache's rows written so far, views read in place; the
cross-attention over the regions) and both attentions of every bounding
step.

The layout is the JAX package's: q [B, H, Lq, Dh], k / v [B, H, Lk, Dh],
a bool mask [B, Lq, Lk] (True = attend), the output [B, H, Lq, Dh] in q's
dtype.  The CUDA path takes strided views (sample, head and row strides
each; the last dimension dense) and writes its output as [B, Lq, H, Dh]
rows returned as a [B, H, Lq, Dh] view, so ``attend`` needs no transpose,
broadcast or copy around the launch.  On a CPU tensor the wrapper runs its
plain twin, ``attention_core_plain``.

Numerics (pallas_attention.py:38-52): the scores sum in float32 and
multiply by the float32 1/sqrt(Dh) (the layer kernels divide by sqrt(Dh);
the two agree exactly when sqrt(Dh) is a power of two), masked with the
finite -1e9 fill (a fully masked row comes out uniform over its Lk keys),
softmax in float32, the probabilities cast to v's dtype, the context summed
in float32 and cast to v's dtype.

The kernel (csrc/attention.cuh) takes one of four paths, chosen by
``attention_path(Lq, Lk, dtype)`` as the C library chooses it: ``row`` for
Lq <= LQ_ROW and Lk <= ``row_key_max(dtype)`` (the decode steps, at bf16
AIC's over a 14 x 14 grid's 196 regions among them: one warp a (sample,
head), K and V read with 16-byte loads, the score row in registers),
``tile`` at bf16 otherwise (mma.sync tensor cores), and at float32
otherwise ``ffma`` up to KEY_MAX keys and ``ffma_long`` past them.  The
tile path holds KEY_MAX keys' scores in registers and goes over more in
chunks of KEY_MAX twice, for each row's max and sum and then for p,
normalised before it is rounded (PB_pad's packed width reaches 211 keys),
one warp a 16-row query tile and up to 16 of them a block; ``ffma_long``
is the ffma block's arithmetic, bitwise, on a block a (sample, head, 32
query rows) with K and V streamed through shared memory in chunks and the
score rows kept there.  Every path stages in at most the
card's 227 KB of shared memory a block (``shared_bytes``) and takes heads
of at most DH_MAX; every q, k and v view's base and strides, and the head
width, must be 16-byte aligned: ``check_operands`` raises ``ValueError``
otherwise, before any launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

# the attention block's constants, path choice and staging size live
# beside the layer kernels that share the block; re-exported here
from .decoder_layer import (_DTYPE_CODE, _I, _LL, _P, DH_MAX, KEY_MAX,
                            LQ_ROW, PATHS, ROW_KEY_MAX, SMEM_LIMIT,
                            _kernels, _route, attention_path, row_key_max,
                            shared_bytes)

MASK_FILL = -1e9


def attention_core_plain(qh, kh, vh, mask):
    """q [B,H,Lq,Dh], k/v [B,H,Lk,Dh], bool mask [B,Lq,Lk] -> [B,H,Lq,Dh]
    in q's dtype, as the TPU kernel computes it."""
    Dh = qh.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float())
    s = s * (1.0 / math.sqrt(Dh))
    s = torch.where(mask[:, None], s, MASK_FILL)
    p = torch.softmax(s, dim=-1).to(vh.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", p.float(), vh.float())
    return out.to(vh.dtype).to(qh.dtype)


class _AttentionCoreArgs(ctypes.Structure):
    """Mirror of csrc/attention_core.cu ``BfcAttentionCoreArgs``."""
    _fields_ = [("q", _P), ("q_sb", _LL), ("q_sh", _LL), ("q_sl", _LL),
                ("k", _P), ("k_sb", _LL), ("k_sh", _LL), ("k_sl", _LL),
                ("v", _P), ("v_sb", _LL), ("v_sh", _LL), ("v_sl", _LL),
                ("mask", _P), ("mask_sb", _LL), ("mask_sq", _LL),
                ("out", _P), ("o_sb", _LL), ("o_sh", _LL), ("o_sl", _LL),
                ("B", _I), ("H", _I), ("Lq", _I), ("Lk", _I), ("Dh", _I),
                ("path", _I)]


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel library, its struct layout checked once."""
    lib = _kernels().attention_core
    size = lib.bfc_attention_core_args_size()
    if size != ctypes.sizeof(_AttentionCoreArgs):
        raise RuntimeError(f"attention_core: argument struct is {size} bytes "
                           f"in C, {ctypes.sizeof(_AttentionCoreArgs)} in "
                           f"Python")
    return lib


def _aligned16(t: torch.Tensor) -> bool:
    """t's base and every stride but the last are 16-byte aligned."""
    e = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        st * e % 16 == 0 for st in t.stride()[:-1])


def check_operands(qh, kh, vh, mask, path: Optional[str] = None) -> None:
    """Raise on operands the kernel does not take: ranks, shapes, dtypes
    (q, k, v alike; a bool mask), devices, a last dimension that is not
    dense, no keys, a head wider than DH_MAX, a q, k or v view whose base,
    strides or head width is not 16-byte aligned (its 16-byte loads), a
    ``path`` forced that the dtype lacks or the row path past the key
    bound (``row_key_max``: its score row sits in registers), or more
    shared memory than a block has on the path taken."""
    if qh.dim() != 4 or kh.dim() != 4 or vh.dim() != 4 or mask.dim() != 3:
        raise ValueError(f"attention_core takes q/k/v of rank 4 and a mask "
                         f"of rank 3, got {qh.dim()}, {kh.dim()}, "
                         f"{vh.dim()}, {mask.dim()}")
    B, H, Lq, Dh = qh.shape
    Lk = kh.shape[2]
    dev = qh.device
    for name, t in (("kh", kh), ("vh", vh)):
        if tuple(t.shape) != (B, H, Lk, Dh):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(B, H, Lk, Dh)}")
        if t.dtype != qh.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {qh.dtype}")
    if tuple(mask.shape) != (B, Lq, Lk):
        raise ValueError(f"mask has shape {tuple(mask.shape)}, expected "
                         f"{(B, Lq, Lk)}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask is {mask.dtype}, expected torch.bool")
    for name, t in (("qh", qh), ("kh", kh), ("vh", vh), ("mask", mask)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.stride(-1) != 1 and t.shape[-1] != 1:
            raise ValueError(f"{name}'s last dimension must be dense "
                             f"(stride {t.stride(-1)})")
    if Lk == 0 or Dh == 0:
        raise ValueError(f"attention_core needs keys: Lk {Lk}, Dh {Dh}")
    if path is not None and path not in (
            ("row", "tile") if qh.dtype == torch.bfloat16 else
            ("row", "ffma", "ffma_long")):
        raise ValueError(f"no {path!r} path at {qh.dtype}")
    if path == "row" and Lk > row_key_max(qh.dtype):
        raise ValueError(f"attention_core: {Lk} keys on the row path, over "
                         f"the key bound {row_key_max(qh.dtype)} at "
                         f"{qh.dtype} (its score row sits in registers)")
    if Dh > DH_MAX:
        raise ValueError(f"attention_core: head width {Dh} over {DH_MAX}")
    if Dh * qh.element_size() % 16:
        raise ValueError(f"attention_core: head width {Dh} is not a "
                         f"multiple of 16 bytes (16-byte loads)")
    for name, t in (("qh", qh), ("kh", kh), ("vh", vh)):
        if not _aligned16(t):
            raise ValueError(f"attention_core: {name} is not 16-byte "
                             f"aligned (base {t.data_ptr() % 16} bytes off, "
                             f"strides {t.stride()}): the kernel reads "
                             f"16-byte chunks")
    smem = shared_bytes(Lq, Lk, Dh, qh.dtype, path)
    if smem > SMEM_LIMIT:
        raise ValueError(f"attention_core: Lq {Lq}, Lk {Lk}, Dh {Dh} need "
                         f"{smem} bytes of shared memory a block, over the "
                         f"{SMEM_LIMIT} the card gives")


def attention_core(qh, kh, vh, mask, path: Optional[str] = None):
    """q [B,H,Lq,Dh], k/v [B,H,Lk,Dh] (any 16-byte aligned strides, the
    last dimension dense), bool mask [B,Lq,Lk] (likewise; a broadcast view
    will do) -> the attended context [B,H,Lq,Dh] in q's dtype, before the
    output projection.  On CUDA: one launch of csrc/attention_core.cu, whose
    output is a [B,H,Lq,Dh] view of [B,Lq,H,Dh] storage, on
    ``attention_path``'s path; ``path`` ('row', or 'tile' at bf16, 'ffma'
    or 'ffma_long' at float32) forces one, to time it or to hold one
    against another."""
    if not _route(qh, kh, vh):
        return attention_core_plain(qh, kh, vh, mask)
    check_operands(qh, kh, vh, mask, path)
    B, H, Lq, Dh = qh.shape
    lib = _library()
    out = torch.empty((B, Lq, H, Dh), dtype=qh.dtype,
                      device=qh.device).transpose(1, 2)
    qs, ks, vs, ms, os_ = (qh.stride(), kh.stride(), vh.stride(),
                           mask.stride(), out.stride())
    args = _AttentionCoreArgs(
        qh.data_ptr(), qs[0], qs[1], qs[2],
        kh.data_ptr(), ks[0], ks[1], ks[2],
        vh.data_ptr(), vs[0], vs[1], vs[2],
        mask.data_ptr(), ms[0], ms[1],
        out.data_ptr(), os_[0], os_[1], os_[2],
        B, H, Lq, kh.shape[2], Dh, -1 if path is None else PATHS.index(path))
    stream = torch.cuda.current_stream(qh.device).cuda_stream
    err = lib.bfc_attention_core(_DTYPE_CODE[qh.dtype], qh.device.index,
                                 ctypes.byref(args), stream)
    if err != 0:
        _kernels().check(err, "attention_core")
    attention_core.launches += 1
    return out


attention_core.launches = 0

# this module's counted wrappers, by kernel name (``ops.launch_counts``)
COUNTED = {"attention_core": attention_core}
