"""Fused inference layers on hand-written CUDA kernels: the port of the JAX
package's ``ops/pallas_decoder_layer.py``.

Four wrappers replace the four TPU kernels of that file:

  ``fused_encoder_layer``        <- ``_enc_kernel``  (pallas_decoder_layer.py:500)
  ``fused_decoder_layer``        <- ``_kernel``      (pallas_decoder_layer.py:124)
  ``fused_greedy_head``          <- ``_head_kernel`` (pallas_decoder_layer.py:671)
  ``fused_window_decoder_layer`` <- ``_win_kernel``  (pallas_decoder_layer.py:283)

On a CUDA tensor a wrapper makes one call into its kernel library
(``csrc/encoder_layer.cu``, ``csrc/decoder_layer.cu``,
``csrc/greedy_head.cu``, ``csrc/window_layer.cu``), which launches the
port's own kernels, built from the building blocks
``csrc/{refnorm,gemm,attention,window}.cuh``, on the current stream; around
it the wrapper runs nothing but ``torch.empty`` for outputs and scratch,
and it raises on the call's CUDA error code.  On a CPU tensor it runs its
plain PyTorch twin (``*_plain``, same module), which repeats the kernel's
arithmetic and rounding.  Any other device raises.  Each wrapper counts
its CUDA calls in ``.launches`` (``COUNTED`` lists them; ``ops``
gathers every module's).  The whole-stack kernels, which loop these layer
bodies over all layers in one call, live in ``ops/stack.py``.

Layouts are the JAX package's: activations [B, L, D] with heads as column
slices ``h*Dh:(h+1)*Dh``; weights [in, out]; bool masks, True = attend.
The TPU kernel's block-diagonal batching of G samples is a TPU layout trick
and is not ported: attention runs per (sample, head).

Numerics (pallas_decoder_layer.py:63-121): RefLayerNorm in float32 with
the unbiased variance and eps added to the std; scores / sqrt(Dh), masked
with the finite -1e9, softmax in float32, probabilities cast to the compute
dtype (at every key count: past KEY_MAX keys the bf16 attention block goes
over chunks of KEY_MAX keys twice, for the row's max and sum and then for
p, normalised before it is rounded; the float32 block's outputs are
bitwise the same on its ffma and ffma_long paths); every product sums in
float32, casts to the compute dtype, then adds its bias in that dtype,
then ReLU or the residual.  Norm
scales and biases stay float32, as the flax modules hold them.

Bounds on the H100 at the serving batch (B = 64, D = 512, d_ff = 2048,
R = 36, L = 20, V = 9491): the layers and the head are bound by operations
(~14.7, ~12.0 and ~12.4 GFLOP a launch).  Every product of the layer,
window and head kernels runs, at bf16, on the tensor cores
(``csrc/wgmma_gemm.cuh``: TMA into a shared-memory ring, wgmma), which read
their operands with TMA: at bf16 the widths (D, d_ff, the head's padded
vocabulary) must be multiples of 8 and the activations 16-byte aligned, and
the wrappers raise ``ValueError`` otherwise (``check_product_shape``).  At
float32 they run on the FFMA product (``csrc/ffma_gemm.cuh``), which takes
any shape.  The head's weights are padded with zero columns to a multiple
of 8 (``pad_head``) and carry the true vocabulary size.  ``fused_linear``
runs one layer product alone, to time it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

MASK_FILL = -1e9
NORM_EPS = 1e-6
# the attention block (csrc/attention.cuh) of every kernel: one query
# row's scores sit in registers (the row path: KEY_MAX keys, or
# ROW_KEY_MAX from one source at bf16); past KEY_MAX keys the tile path
# goes over chunks of KEY_MAX keys in two passes, one warp a query tile and
# up to TILE_LONG_WARPS a block, and float32 takes the ffma_long block
# (FL_ROWS query rows a block, K and V through a ring of two FL_KEYS-key
# chunks, the score rows in shared memory); heads of at most DH_MAX, at most
# SMEM_LIMIT bytes of shared memory a block (the H100's 227 KB)
KEY_MAX = 128
ROW_KEY_MAX = 256
DH_MAX = 128
SMEM_LIMIT = 232448
ATT_WARPS = 4                       # csrc/attention.cuh: ffma path warps
TILE_LONG_WARPS = 16                # ... tile path past KEY_MAX: tiles a block
FL_ROWS = 32                        # ... ffma_long: query rows a block
FL_KEYS = 32                        # ... ffma_long: keys a K / V chunk
LQ_ROW = 1                          # csrc/attention.cuh: row path up to here
PATHS = ("row", "tile", "ffma", "ffma_long")   # ... AttentionPath

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# weight packing (once per model; BoFiCap.packed_* caches the result)
# ---------------------------------------------------------------------------

def _kernel_of(dense, dtype) -> torch.Tensor:
    """nn weight [out, in] -> [in, out] in the compute dtype, contiguous.
    A tensor-parallel slice (``parallel.shard_params``) raises: the kernels
    take whole layers, and tensor parallelism runs the plain path."""
    if dense.tp is not None:
        raise ValueError("the kernels take whole layers, not a "
                         "tensor-parallel slice: run the plain path")
    return dense.weight.detach().t().to(dtype).contiguous()


def _norm(sub) -> Tuple[torch.Tensor, torch.Tensor]:
    n = sub.norm
    return (n.scale.detach().float().contiguous(),
            n.bias.detach().float().contiguous())


def _attn_qkv(attn, dtype):
    w = torch.cat([_kernel_of(attn.wq, dtype), _kernel_of(attn.wk, dtype),
                   _kernel_of(attn.wv, dtype)], dim=1).contiguous()
    b = torch.cat([attn.wq.bias, attn.wk.bias, attn.wv.bias]).detach()
    return w, b.to(dtype).contiguous()


def _ffn(ffn, dtype) -> Dict[str, torch.Tensor]:
    return {"w1": _kernel_of(ffn.Dense_0, dtype),
            "bf1": ffn.Dense_0.bias.detach().to(dtype).contiguous(),
            "w2": _kernel_of(ffn.Dense_1, dtype),
            "bf2": ffn.Dense_1.bias.detach().to(dtype).contiguous()}


def pack_encoder_layer(layer, dtype) -> Dict[str, torch.Tensor]:
    """EncoderLayer -> {s0, b0, wqkv [D,3D], bqkv, wo, bo, s1, b1, w1, bf1,
    w2, bf2}."""
    wqkv, bqkv = _attn_qkv(layer.self_attn, dtype)
    s0, b0 = _norm(layer.sub0)
    s1, b1 = _norm(layer.sub1)
    return {"s0": s0, "b0": b0, "wqkv": wqkv, "bqkv": bqkv,
            "wo": _kernel_of(layer.self_attn.wo, dtype),
            "bo": layer.self_attn.wo.bias.detach().to(dtype).contiguous(),
            "s1": s1, "b1": b1, **_ffn(layer.ffn, dtype)}


def pack_layer_weights(layer, dtype) -> Dict[str, torch.Tensor]:
    """DecoderLayer -> the encoder entries plus the cross-attention's
    wq2 [D,D], bq2, wkv2 [D,2D] (K and V of the memory in one product),
    bkv2, wo2, bo2 and the third norm s2, b2."""
    out = pack_encoder_layer(layer, dtype)
    ca = layer.src_attn
    s2, b2 = _norm(layer.sub2)
    wkv2 = torch.cat([_kernel_of(ca.wk, dtype), _kernel_of(ca.wv, dtype)],
                     dim=1).contiguous()
    bkv2 = torch.cat([ca.wk.bias, ca.wv.bias]).detach().to(dtype).contiguous()
    out.update({
        "wq2": _kernel_of(ca.wq, dtype),
        "bq2": ca.wq.bias.detach().to(dtype).contiguous(),
        "wkv2": wkv2, "bkv2": bkv2,
        "wo2": _kernel_of(ca.wo, dtype),
        "bo2": ca.wo.bias.detach().to(dtype).contiguous(),
        "s2": s2, "b2": b2,
    })
    return out


class HeadPack(NamedTuple):
    """The head's weights, W [D, Vp] and b [Vp] with zeros past the V real
    columns (Vp = 8 ceil(V / 8)): ``fused_greedy_head(h, *pack)``."""
    w: torch.Tensor
    b: torch.Tensor
    V: int


def pad_head(w, b) -> HeadPack:
    """W [D, V], b [V] -> their HeadPack.  The pad makes W's rows 16-byte
    strided at bf16, as the tensor-core product's TMA reads need."""
    D, V = w.shape
    Vp = -(-V // 8) * 8
    wp = w.new_zeros((D, Vp))
    wp[:, :V] = w
    bp = b.new_zeros((Vp,))
    bp[:V] = b
    return HeadPack(wp, bp, V)


def pack_head_weights(proj, dtype) -> HeadPack:
    """Generator projection -> its HeadPack in the compute dtype."""
    return pad_head(_kernel_of(proj, dtype), proj.bias.detach().to(dtype))


# ---------------------------------------------------------------------------
# plain PyTorch twins (the CPU path, and the kernels' oracle on the card)
# ---------------------------------------------------------------------------

def refnorm_plain(x, scale, bias):
    """Two-pass RefLayerNorm in float32, output in x's dtype."""
    xf = x.float()
    d = xf.shape[-1]
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).sum(-1, keepdim=True) / max(d - 1, 1)
    y = (xf - mean) / (torch.sqrt(var) + NORM_EPS)
    return (y * scale + bias).to(x.dtype)


def linear_plain(a, w, b, relu: bool = False, res=None):
    """float32 sum, cast, + bias in the compute dtype, relu, + residual."""
    y = torch.matmul(a.float(), w.float()).to(a.dtype) + b
    if relu:
        y = torch.relu(y)
    if res is not None:
        y = y + res
    return y


def attention_plain(q, k, v, mask, num_heads: int):
    """q [B,Lq,D], k/v [B,Lk,D], bool mask [B,Lk] | [B,Lq,Lk] -> [B,Lq,D].
    The probabilities are normalised, rounded, then multiplied by V, at
    every key count."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    H = num_heads
    Dh = D // H
    qh = q.float().reshape(B, Lq, H, Dh)
    kh = k.float().reshape(B, Lk, H, Dh)
    vh = v.float().reshape(B, Lk, H, Dh)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(Dh)
    m = mask[:, None, None, :] if mask.dim() == 2 else mask[:, None]
    s = torch.where(m, s, MASK_FILL)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", p.float(), vh).to(q.dtype)
    return ctx.reshape(B, Lq, D)


def encoder_layer_plain(x, mask, w, num_heads: int):
    D = x.shape[-1]
    n0 = refnorm_plain(x, w["s0"], w["b0"])
    q, k, v = linear_plain(n0, w["wqkv"], w["bqkv"]).split(D, dim=-1)
    x = linear_plain(attention_plain(q, k, v, mask, num_heads), w["wo"],
                     w["bo"], res=x)
    n1 = refnorm_plain(x, w["s1"], w["b1"])
    f = linear_plain(n1, w["w1"], w["bf1"], relu=True)
    return linear_plain(f, w["w2"], w["bf2"], res=x)


def decoder_layer_plain(x, memory, tgt_mask, src_mask, w, num_heads: int,
                        kv=None):
    """kv: the layer's cross K|V of the memory, [B,R,2D] (as the stack
    projects it for every layer first), or None: projected here."""
    D = x.shape[-1]
    n0 = refnorm_plain(x, w["s0"], w["b0"])
    q, k, v = linear_plain(n0, w["wqkv"], w["bqkv"]).split(D, dim=-1)
    x = linear_plain(attention_plain(q, k, v, tgt_mask, num_heads), w["wo"],
                     w["bo"], res=x)
    # only the query side is normed: the memory is already encoder-normed
    n1 = refnorm_plain(x, w["s1"], w["b1"])
    q2 = linear_plain(n1, w["wq2"], w["bq2"])
    if kv is None:
        kv = linear_plain(memory, w["wkv2"], w["bkv2"])
    k2, v2 = kv.split(D, dim=-1)
    x = linear_plain(attention_plain(q2, k2, v2, src_mask, num_heads),
                     w["wo2"], w["bo2"], res=x)
    n2 = refnorm_plain(x, w["s2"], w["b2"])
    f = linear_plain(n2, w["w1"], w["bf1"], relu=True)
    return linear_plain(f, w["w2"], w["bf2"], res=x)


def greedy_head_plain(h, w, b, V: Optional[int] = None, pad_id: int = 0):
    """h [B,T,D] -> (ids int64, tok_lp, entropy, lp[pad_id]), each [B,T],
    over the first V columns of w [D, >= V] and b (all of them if V is
    None)."""
    if V is not None:
        w, b = w[:, :V], b[:V]
    acc = torch.matmul(h.float(), w.float())
    if h.dtype == torch.bfloat16:
        logits = (acc.to(torch.bfloat16) + b.to(torch.bfloat16)).float()
    else:
        logits = acc + b.float()
    lp = torch.log_softmax(logits, dim=-1)
    ids = torch.argmax(logits, dim=-1)
    tok = torch.gather(lp, -1, ids[..., None])[..., 0]
    ent = -(torch.exp(lp) * lp).sum(-1)
    return ids, tok, ent, lp[..., pad_id]


def window_layer_plain(x, k_cache, v_cache, k2, v2, tgt_mask, src_mask, w,
                       num_heads: int):
    """One windowed decoder layer: x [B,W,D]; self-attention keys are the
    cache [B,L,D] followed by the window's fresh K/V (``k_cache=None``: the
    window's alone, as the wide stack round); cross K/V k2/v2 [B,R,D]
    pre-projected; bool tgt_mask [B,W,L+W] (cache columns, then window
    columns), src_mask [B,R] or [B,W,R].  Returns (x, k_new, v_new), the
    last two [B,W,D]."""
    D = x.shape[-1]
    n0 = refnorm_plain(x, w["s0"], w["b0"])
    q, k, v = linear_plain(n0, w["wqkv"], w["bqkv"]).split(D, dim=-1)
    if k_cache is None:
        keys, vals = k, v
    else:
        keys, vals = torch.cat([k_cache, k], 1), torch.cat([v_cache, v], 1)
    x = linear_plain(attention_plain(q, keys, vals, tgt_mask, num_heads),
                     w["wo"], w["bo"], res=x)
    n1 = refnorm_plain(x, w["s1"], w["b1"])
    q2 = linear_plain(n1, w["wq2"], w["bq2"])
    x = linear_plain(attention_plain(q2, k2, v2, src_mask, num_heads),
                     w["wo2"], w["bo2"], res=x)
    n2 = refnorm_plain(x, w["s2"], w["b2"])
    f = linear_plain(n2, w["w1"], w["bf1"], relu=True)
    return (linear_plain(f, w["w2"], w["bf2"], res=x), k.contiguous(),
            v.contiguous())


def scatter_window(cache, new, w_start) -> None:
    """In place: rows w_start[b] .. w_start[b] + W - 1 of cache [B,L,D]
    take new [B,W,D]; every other row is left as it was."""
    B, L, D = cache.shape
    W = new.shape[1]
    rows = (torch.arange(B, device=cache.device)[:, None] * L
            + w_start.long()[:, None]
            + torch.arange(W, device=cache.device)[None, :]).reshape(-1)
    cache.view(B * L, D).index_copy_(0, rows, new.reshape(B * W, D))


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _kernels():
    from ._build import kernels
    return kernels()


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _tensors(obj):
    """The tensors of a wrapper operand: a tensor, or those inside a weight
    dict, a pack or a sequence."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _route(x: torch.Tensor, *operands) -> bool:
    """True for the kernel path (CUDA), False for the plain twin (CPU),
    by ``x``'s device.  The kernels have no backward: with grad mode on, an
    operand that requires grad raises ``ValueError`` on either device,
    rather than being detached or sent down the plain path."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in _tensors((x,) + operands)):
        raise ValueError(
            "a kernel wrapper got a tensor that requires grad: the kernels "
            "are inference-only (no backward); run them under "
            "torch.no_grad(), or call the plain modules to train")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernels take float32 or bfloat16, not {x.dtype}")
    return True


def _mask_strides(mask, B: int, Lq: int, Lk: int, device, name: str):
    """bool [B, Lk] (rows broadcast) or [B, Lq, Lk] -> (sample, row)
    strides of its bytes."""
    if mask.dim() == 2:
        _require(mask, name, torch.bool, (B, Lk), device)
        return Lk, 0
    _require(mask, name, torch.bool, (B, Lq, Lk), device)
    return Lq * Lk, Lk


_NORM_KEYS = ("s0", "b0", "s1", "b1", "s2", "b2")   # float32 norm params


def _check_weights(w: Dict[str, torch.Tensor], shapes, dtype, device):
    for key, shape in shapes.items():
        _require(w[key], key, torch.float32 if key in _NORM_KEYS else dtype,
                 shape, device)


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _fields(spec: str, ctype):
    return [(name, ctype) for name in spec.split()]


class _EncoderLayerArgs(ctypes.Structure):
    """Mirror of csrc/encoder_layer.cu ``BfcEncoderLayerArgs``."""
    _fields_ = (_fields("x mask", _P) + _fields("mask_sb mask_sq", _LL)
                + _fields("s0 b0 s1 b1 wqkv bqkv wo bo w1 bf1 w2 bf2 "
                          "scratch out", _P)
                + _fields("B R D F H", _I))


class _DecoderLayerArgs(ctypes.Structure):
    """Mirror of csrc/decoder_layer.cu ``BfcDecoderLayerArgs``."""
    _fields_ = (_fields("x memory tgt_mask", _P)
                + _fields("tgt_sb tgt_sq", _LL) + _fields("src_mask", _P)
                + _fields("src_sb src_sq", _LL)
                + _fields("s0 b0 s1 b1 s2 b2 wqkv bqkv wo bo wq2 bq2 wkv2 "
                          "bkv2 wo2 bo2 w1 bf1 w2 bf2 scratch out", _P)
                + _fields("B L R D F H", _I))


class _WindowLayerArgs(ctypes.Structure):
    """Mirror of csrc/window_layer.cu ``BfcWindowLayerArgs``."""
    _fields_ = (_fields("x k_cache v_cache k2 v2 tgt_mask", _P)
                + _fields("tgt_sb tgt_sq", _LL) + _fields("src_mask", _P)
                + _fields("src_sb src_sq", _LL)
                + _fields("s0 b0 s1 b1 s2 b2 wqkv bqkv wo bo wq2 bq2 wo2 bo2 "
                          "w1 bf1 w2 bf2 scratch out k_new v_new", _P)
                + _fields("B W L R D F H", _I))


def _launch_layer(entry: str, args: ctypes.Structure, x: torch.Tensor,
                  lib_name: Optional[str] = None, extra=()):
    """Run one layer or stack entry of the kernel libraries (``extra``: the
    arguments between its struct and its stream) on x's device and current
    stream; raises on a struct-layout mismatch or a CUDA error."""
    k = _kernels()
    lib = getattr(k, lib_name or entry)
    size = getattr(lib, f"bfc_{lib_name or entry}_args_size")()
    if size != ctypes.sizeof(args):
        raise RuntimeError(f"{entry}: argument struct is {size} bytes in C, "
                           f"{ctypes.sizeof(args)} in Python")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    k.check(getattr(lib, f"bfc_{entry}")(_DTYPE_CODE[x.dtype],
                                         x.device.index,
                                         ctypes.byref(args), *extra, stream),
            entry)


def _pointers(w: Dict[str, torch.Tensor], keys) -> Dict[str, int]:
    return {k: w[k].data_ptr() for k in keys}


_ENC_KEYS = ("s0", "b0", "s1", "b1", "wqkv", "bqkv", "wo", "bo", "w1", "bf1",
             "w2", "bf2")
_DEC_KEYS = _ENC_KEYS + ("s2", "b2", "wq2", "bq2", "wkv2", "bkv2", "wo2",
                         "bo2")
_WIN_KEYS = _ENC_KEYS + ("s2", "b2", "wq2", "bq2", "wo2", "bo2")


def weight_shapes(keys, D: int, F: int, lead=()) -> Dict[str, tuple]:
    """The shapes of the packed weights ``keys``, each behind ``lead``
    (``(NL,)`` for a stacked pack)."""
    lead = tuple(lead)
    shapes = {"s0": (D,), "b0": (D,), "wqkv": (D, 3 * D), "bqkv": (3 * D,),
              "wo": (D, D), "bo": (D,), "s1": (D,), "b1": (D,),
              "wq2": (D, D), "bq2": (D,), "wkv2": (D, 2 * D),
              "bkv2": (2 * D,), "wo2": (D, D), "bo2": (D,), "s2": (D,),
              "b2": (D,), "w1": (D, F), "bf1": (F,), "w2": (F, D),
              "bf2": (D,)}
    return {k: lead + shapes[k] for k in keys}


def check_product_shape(dtype, widths: Dict[str, int],
                        tensors: Optional[Dict[str, torch.Tensor]] = None
                        ) -> None:
    """Raise ValueError unless the layer kernels' products can take these
    operands.  The bf16 product (csrc/wgmma_gemm.cuh) reads A [M, K] and
    W [K, N] with TMA, which needs 16-byte row strides and bases: every
    product width (``widths``: K and N) a multiple of 8, every tensor the
    kernel reads with TMA (``tensors``) 16-byte aligned.  float32 takes any
    shape."""
    if dtype != torch.bfloat16:
        return
    for name, n in widths.items():
        if n % 8:
            raise ValueError(
                f"{name} = {n}: the bf16 tensor-core product reads rows with "
                f"TMA, which needs widths that are multiples of 8 (16-byte "
                f"row strides)")
    for name, t in (tensors or {}).items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned: the bf16 "
                             f"tensor-core product reads it with TMA")


def row_key_max(dtype) -> int:
    """Keys the row path takes at ``dtype`` (csrc/attention.cuh
    ``row_key_max``): ROW_KEY_MAX at bf16 (its wide score rows), KEY_MAX at
    float32 (past it ffma_long is the faster path)."""
    return ROW_KEY_MAX if dtype == torch.bfloat16 else KEY_MAX


def attention_path(Lq: int, Lk: int, dtype) -> Optional[str]:
    """The path of the attention block for an Lq x Lk attention at ``dtype``
    (the C library's ``bfc_attention_path``): 'row' up to LQ_ROW query
    rows and ``row_key_max`` keys, else 'tile' at bf16, and at float32
    'ffma' up to KEY_MAX keys and 'ffma_long' past them; None without
    keys."""
    if Lk < 1:
        return None
    if Lq <= LQ_ROW and Lk <= row_key_max(dtype):
        return "row"
    if dtype == torch.bfloat16:
        return "tile"
    return "ffma_long" if Lk > KEY_MAX else "ffma"


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def shared_bytes(Lq: int, Lk: int, Dh: int, dtype,
                 path: Optional[str] = None) -> int:
    """Shared memory of one block on ``path`` (None: the one
    ``attention_path`` gives; csrc/attention.cuh ``attention_smem``): none
    on the row path; the tile path's bf16 Q [16-row tiles][Dh + pad] (past
    KEY_MAX keys one group of TILE_LONG_WARPS tiles) and K, V [16-key
    tiles][Dh + pad], rows padded to a multiple of 16 columns plus 8; the
    ffma path's float32 K [Lk, Dh+1], V [Lk, Dh], Q [Lq, Dh] and a
    probability row a warp; the ffma_long block's float32 Q^T [Dh,
    FL_ROWS + 4], score rows [FL_ROWS, Lk to a multiple of 4], K/V ring
    [2, FL_KEYS, Dh + 1] and mask bits [FL_ROWS, Lk / 32 words] (its query
    tile, not Lq, sets it)."""
    path = path or attention_path(Lq, Lk, dtype)
    if path == "row":
        return 0
    if path == "tile":
        lq = _round16(Lq)
        if Lk > KEY_MAX:
            lq = min(lq, TILE_LONG_WARPS * 16)
        return 2 * (lq + 2 * _round16(Lk)) * (_round16(Dh) + 8)
    if path == "ffma_long":
        return 4 * (Dh * (FL_ROWS + 4) + FL_ROWS * ((Lk + 3) // 4 * 4)
                    + 2 * FL_KEYS * (Dh + 1) + FL_ROWS * ((Lk + 31) // 32))
    return 4 * (Lk * (Dh + 1) + Lk * Dh + Lq * Dh + ATT_WARPS * Lk)


def check_attention_shape(attentions: Dict[str, Tuple[int, int, bool]],
                          Dh: int, dtype) -> None:
    """Raise ValueError unless the attention block (csrc/attention.cuh
    ``launch_attention``) takes these attentions (``attentions``: name ->
    (query rows, keys, whether the keys are a cache and fresh rows copied
    out, as the window layers' self-attention)) at head width ``Dh`` and
    ``dtype``: heads of at most DH_MAX; past KEY_MAX keys only one key
    source with no copy (the bf16 wide row path, the tile path's chunked
    kernel and ffma_long take one); and at most SMEM_LIMIT bytes of shared
    memory a block on the path taken (``shared_bytes``)."""
    if Dh > DH_MAX:
        raise ValueError(f"head width {Dh}: the attention block takes heads "
                         f"of at most {DH_MAX}")
    for name, (Lq, Lk, cached) in attentions.items():
        if Lk > KEY_MAX and cached:
            raise ValueError(
                f"{name} = {Lk} keys from a cache and fresh rows: the "
                f"attention block takes more than {KEY_MAX} keys (the key "
                f"bound) only from one source")
        smem = shared_bytes(Lq, Lk, Dh, dtype)
        if smem > SMEM_LIMIT:
            raise ValueError(
                f"{name}: {Lq} x {Lk} at head width {Dh} needs {smem} bytes "
                f"of shared memory a block, over the {SMEM_LIMIT} the card "
                f"gives")


# the window layer's product weights, read with TMA
_WIN_PRODUCT_KEYS = ("wqkv", "wo", "wq2", "wo2", "w1", "w2")


def check_window_products(dtype, D: int, F: int, x_win, w) -> None:
    """``check_product_shape`` for a window layer or stack (csrc/window.cuh):
    its products' widths D and d_ff, x_win (the first residual) and the
    product weights ``w`` (per layer or stacked)."""
    check_product_shape(dtype, {"D": D, "d_ff": F},
                        {"x_win": x_win,
                         **{k: w[k] for k in _WIN_PRODUCT_KEYS}})


def encoder_call(entry: str, x, mask, w, num_heads: int,
                 NL: Optional[int] = None):
    """Check an encoder layer's operands and run ``entry`` of
    csrc/encoder_layer.cu: the layer (w per layer) or, with ``NL``, the
    whole stack (w stacked, [NL, ...]).  Returns the output [B,R,D]."""
    B, R, D = x.shape
    F = w["w1"].shape[-1]
    dev, dt = x.device, x.dtype
    _require(x, "x", dt, (B, R, D), dev)
    msb, msq = _mask_strides(mask, B, R, R, dev, "mask")
    lead = () if NL is None else (NL,)
    _check_weights(w, weight_shapes(_ENC_KEYS, D, F, lead), dt, dev)
    check_product_shape(dt, {"D": D, "d_ff": F}, {"x": x})
    check_attention_shape({"self-attention": (R, R, False)}, D // num_heads,
                          dt)
    lib = _kernels().encoder_layer
    n_scratch = getattr(lib, f"bfc_{entry}_scratch")(B, R, D, F)
    scratch = torch.empty(n_scratch, dtype=dt, device=dev)
    out = torch.empty_like(x)
    args = _EncoderLayerArgs(
        x=x.data_ptr(), mask=mask.data_ptr(), mask_sb=msb, mask_sq=msq,
        scratch=scratch.data_ptr(), out=out.data_ptr(),
        B=B, R=R, D=D, F=F, H=num_heads, **_pointers(w, _ENC_KEYS))
    _launch_layer(entry, args, x, "encoder_layer", lead)
    return out


def decoder_call(entry: str, x, memory, tgt_mask, src_mask, w,
                 num_heads: int, NL: Optional[int] = None):
    """Check a decoder layer's operands and run ``entry`` of
    csrc/decoder_layer.cu: the layer (w per layer) or, with ``NL``, the
    whole stack (w stacked, [NL, ...]).  Returns the output [B,L,D]."""
    B, L, D = x.shape
    R = memory.shape[1]
    F = w["w1"].shape[-1]
    dev, dt = x.device, x.dtype
    _require(x, "x", dt, (B, L, D), dev)
    _require(memory, "memory", dt, (B, R, D), dev)
    tsb, tsq = _mask_strides(tgt_mask, B, L, L, dev, "tgt_mask")
    ssb, ssq = _mask_strides(src_mask, B, L, R, dev, "src_mask")
    lead = () if NL is None else (NL,)
    _check_weights(w, weight_shapes(_DEC_KEYS, D, F, lead), dt, dev)
    check_product_shape(dt, {"D": D, "d_ff": F}, {"x": x, "memory": memory})
    check_attention_shape({"self-attention": (L, L, False),
                           "cross-attention": (L, R, False)},
                          D // num_heads, dt)
    ptrs = _pointers(w, _DEC_KEYS)
    if NL is not None:
        # the stack projects every layer's cross K|V in one product, on
        # the side-by-side weight (pack_decoder_stack's "wkv2_all")
        if "wkv2_all" not in w:
            raise ValueError("the decoder stack takes pack_decoder_stack's "
                             "weights: 'wkv2_all' is missing")
        _require(w["wkv2_all"], "wkv2_all", dt, (D, NL * 2 * D), dev)
        ptrs["wkv2"] = w["wkv2_all"].data_ptr()
    lib = _kernels().decoder_layer
    n_scratch = (lib.bfc_decoder_layer_scratch(B, L, R, D, F) if NL is None
                 else lib.bfc_decoder_stack_scratch(B, L, R, D, F, NL))
    scratch = torch.empty(n_scratch, dtype=dt, device=dev)
    out = torch.empty_like(x)
    args = _DecoderLayerArgs(
        x=x.data_ptr(), memory=memory.data_ptr(),
        tgt_mask=tgt_mask.data_ptr(), tgt_sb=tsb, tgt_sq=tsq,
        src_mask=src_mask.data_ptr(), src_sb=ssb, src_sq=ssq,
        scratch=scratch.data_ptr(), out=out.data_ptr(),
        B=B, L=L, R=R, D=D, F=F, H=num_heads, **ptrs)
    _launch_layer(entry, args, x, "decoder_layer", lead)
    return out


def decoder_launches(NL: Optional[int] = None) -> Dict[str, int]:
    """The port's kernel launches of one decoder-layer call (NL None, #2)
    or one decoder-stack call of NL layers (#5), by kind, at either dtype;
    mirrors csrc/decoder_layer.cu.  A layer: 3 refnorm, 7 products (its own
    cross K|V projection among them), 2 attention.  The stack: one product
    for every layer's cross K|V first, then per layer the layer's launches
    without that projection."""
    if NL is None:
        return {"products": 7, "attention": 2, "refnorm": 3}
    return {"products": 1 + 6 * NL, "attention": 2 * NL, "refnorm": 3 * NL}


def fused_encoder_layer(x, mask, w, num_heads: int):
    """One pre-norm encoder layer, inference: x [B,R,D], bool mask [B,R]
    (padding) or [B,R,R], w from ``pack_encoder_layer``.  On CUDA: one call
    of csrc/encoder_layer.cu (2 refnorm, 4 gemm, 1 attention launches)."""
    if not _route(x, mask, w):
        return encoder_layer_plain(x, mask, w, num_heads)
    out = encoder_call("encoder_layer", x, mask, w, num_heads)
    fused_encoder_layer.launches += 1
    return out


def fused_decoder_layer(x, memory, tgt_mask, src_mask, w, num_heads: int):
    """One pre-norm decoder layer, inference: x [B,L,D], memory [B,R,D],
    bool tgt_mask [B,L,L], bool src_mask [B,R] or [B,L,R], w from
    ``pack_layer_weights``.  On CUDA: one call of csrc/decoder_layer.cu
    (``decoder_launches``: 3 refnorm, 7 products, 2 attention; at bf16
    each launch chained to the one before it)."""
    if not _route(x, memory, tgt_mask, src_mask, w):
        return decoder_layer_plain(x, memory, tgt_mask, src_mask, w,
                                   num_heads)
    out = decoder_call("decoder_layer", x, memory, tgt_mask, src_mask, w,
                       num_heads)
    fused_decoder_layer.launches += 1
    return out


def fused_greedy_head(h, w, b, V: Optional[int] = None, pad_id: int = 0):
    """Greedy head: h [B,T,D], w [D,Vp], b [Vp] (compute dtype) whose first
    V columns are the vocabulary (V None: all Vp; ``*pack_head_weights(...)``
    passes w, b and V) -> (ids int64, tok_logprobs, entropy, lp[pad_id]),
    each [B,T] float32, without forming [B,T,V].  On CUDA: one call of
    csrc/greedy_head.cu (head_partial, head_combine launches); there w must
    be padded to Vp < V + 8 (``pad_head``), and at bf16 Vp and D must be
    multiples of 8 and h, w 16-byte aligned, or it raises ValueError."""
    Vp = w.shape[-1]
    V = Vp if V is None else V
    if not _route(h, w, b):
        return greedy_head_plain(h, w, b, V, pad_id)
    B, T, D = h.shape
    dev, dt = h.device, h.dtype
    _require(h, "h", dt, (B, T, D), dev)
    _require(w, "w", dt, (D, Vp), dev)
    _require(b, "b", dt, (Vp,), dev)
    if not 0 < V <= Vp < V + 8:
        raise ValueError(f"w has {Vp} columns for a vocabulary of {V}: pad "
                         f"it to a multiple of 8 with pad_head")
    if not 0 <= pad_id < V:
        raise ValueError(f"pad_id {pad_id} outside the vocabulary [0, {V})")
    check_product_shape(dt, {"D": D, "padded vocabulary": Vp},
                        {"h": h, "w": w})
    N = B * T
    k = _kernels()
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = torch.empty(k.greedy_head.bfc_greedy_head_scratch(N, V), **f32)
    ids = torch.empty((B, T), dtype=torch.int64, device=dev)
    tok = torch.empty((B, T), **f32)
    ent = torch.empty((B, T), **f32)
    lpp = torch.empty((B, T), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    k.check(k.greedy_head.bfc_greedy_head(
        _DTYPE_CODE[dt], dev.index, h.data_ptr(), w.data_ptr(), b.data_ptr(),
        N, V, Vp, D, pad_id, scratch.data_ptr(), ids.data_ptr(), tok.data_ptr(),
        ent.data_ptr(), lpp.data_ptr(), stream), "greedy_head")
    fused_greedy_head.launches += 1
    return ids, tok, ent, lpp


def fused_window_decoder_layer(x_win, k_cache, v_cache, k2, v2, tgt_mask,
                               src_mask, w, num_heads: int):
    """One windowed decoder layer, inference: x_win [B,W,D], the layer's
    caches k_cache/v_cache [B,L,D], pre-projected cross K/V k2/v2 [B,R,D],
    bool tgt_mask [B,W,L+W] (cache columns, then window columns), bool
    src_mask [B,R] or [B,W,R], w one of ``pack_window_weights(...).layers``
    (ops/stack.py).  Returns
    (x [B,W,D], k_new, v_new [B,W,D]); the caller scatters the fresh K/V
    into the caches.  On CUDA: one call of csrc/window_layer.cu (3 refnorm,
    6 products, 2 attention launches; the self-attention block writes
    k_new / v_new)."""
    if not _route(x_win, k_cache, v_cache, k2, v2, w):
        return window_layer_plain(x_win, k_cache, v_cache, k2, v2, tgt_mask,
                                  src_mask, w, num_heads)
    out = window_layer_call(x_win, k_cache, v_cache, k2, v2, tgt_mask,
                            src_mask, w, num_heads)
    fused_window_decoder_layer.launches += 1
    return out


def window_layer_call(x_win, k_cache, v_cache, k2, v2, tgt_mask, src_mask, w,
                      num_heads: int, lib: str = "window_layer",
                      entry: str = "window_layer", extra=()):
    """Check a window layer's operands (``fused_window_decoder_layer``'s)
    and run ``entry`` of the library ``lib`` (csrc/window_layer.cu, or
    csrc/window_parts.cu's entries, which take the same argument struct;
    ``extra``: the arguments between it and the stream); returns (x,
    k_new, v_new)."""
    B, W, D = x_win.shape
    L = k_cache.shape[1]
    R = k2.shape[1]
    F = w["w1"].shape[1]
    dev, dt = x_win.device, x_win.dtype
    _require(x_win, "x_win", dt, (B, W, D), dev)
    for name, t, rows in (("k_cache", k_cache, L), ("v_cache", v_cache, L),
                          ("k2", k2, R), ("v2", v2, R)):
        _require(t, name, dt, (B, rows, D), dev)
    tsb, tsq = _mask_strides(tgt_mask, B, W, L + W, dev, "tgt_mask")
    ssb, ssq = _mask_strides(src_mask, B, W, R, dev, "src_mask")
    _check_weights(w, weight_shapes(_WIN_KEYS, D, F), dt, dev)
    check_window_products(dt, D, F, x_win, w)
    check_attention_shape({"self-attention": (W, L + W, True),
                           "cross-attention": (W, R, False)},
                          D // num_heads, dt)
    n_scratch = getattr(getattr(_kernels(), lib), f"bfc_{lib}_scratch")(
        B, W, D, F)
    scratch = torch.empty(n_scratch, dtype=dt, device=dev)
    out = torch.empty_like(x_win)
    k_new = torch.empty_like(x_win)
    v_new = torch.empty_like(x_win)
    args = _WindowLayerArgs(
        x=x_win.data_ptr(), k_cache=k_cache.data_ptr(),
        v_cache=v_cache.data_ptr(), k2=k2.data_ptr(), v2=v2.data_ptr(),
        tgt_mask=tgt_mask.data_ptr(), tgt_sb=tsb, tgt_sq=tsq,
        src_mask=src_mask.data_ptr(), src_sb=ssb, src_sq=ssq,
        scratch=scratch.data_ptr(), out=out.data_ptr(),
        k_new=k_new.data_ptr(), v_new=v_new.data_ptr(),
        B=B, W=W, L=L, R=R, D=D, F=F, H=num_heads, **_pointers(w, _WIN_KEYS))
    _launch_layer(entry, args, x_win, lib, extra)
    return out, k_new, v_new


def fused_linear(a, w, b, relu: bool = False, res=None):
    """One product of the layer kernels alone, for timing it: a [..., K],
    w [K, N], b [N], res (optional) [..., N], all in the compute dtype ->
    ``linear_plain(a, w, b, relu, res)``.  On CUDA: one call of bfc_gemm
    (csrc/decoder_layer.cu), the tensor-core product at bf16, the FFMA
    product at float32.  No decode path calls it."""
    if not _route(a, w, b, res):
        return linear_plain(a, w, b, relu, res)
    K, N = a.shape[-1], w.shape[-1]
    M = a.numel() // K if K else 0
    dev, dt = a.device, a.dtype
    _require(a, "a", dt, None, dev)
    _require(w, "w", dt, (K, N), dev)
    _require(b, "b", dt, (N,), dev)
    out = torch.empty((*a.shape[:-1], N), dtype=dt, device=dev)
    if res is not None:
        _require(res, "res", dt, out.shape, dev)
    check_product_shape(dt, {"K": K, "N": N}, {"a": a, "w": w})
    k = _kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    k.check(k.decoder_layer.bfc_gemm(
        _DTYPE_CODE[dt], dev.index, a.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if res is None else res.data_ptr(), out.data_ptr(), M, N, K,
        int(relu), stream), "gemm")
    fused_linear.launches += 1
    return out


def fused_refnorm(x, scale, bias):
    """One RefLayerNorm of the layer kernels alone, for timing it: x [..., D]
    in the compute dtype, float32 scale and bias [D] ->
    ``refnorm_plain(x, scale, bias)``.  On CUDA: one call of bfc_refnorm
    (csrc/decoder_layer.cu over refnorm.cuh).  No decode path calls it."""
    if not _route(x, scale, bias):
        return refnorm_plain(x, scale, bias)
    D = x.shape[-1]
    dev = x.device
    _require(x, "x", x.dtype, None, dev)
    _require(scale, "scale", torch.float32, (D,), dev)
    _require(bias, "bias", torch.float32, (D,), dev)
    out = torch.empty_like(x)
    k = _kernels()
    k.check(k.decoder_layer.bfc_refnorm(
        _DTYPE_CODE[x.dtype], dev.index, x.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), x.numel() // D if D else 0, D,
        torch.cuda.current_stream(dev).cuda_stream), "refnorm")
    fused_refnorm.launches += 1
    return out


def product_tile(M: int, N: int, dtype=torch.bfloat16
                 ) -> Tuple[int, int, int]:
    """The layer kernels' tile for an M x N product at ``dtype`` (the
    tensor-core product at bf16, the FFMA product at float32): (BM, BN,
    blocks)."""
    bm, bn = ctypes.c_int(), ctypes.c_int()
    blocks = _kernels().decoder_layer.bfc_gemm_tile(
        _DTYPE_CODE[dtype], M, N, ctypes.byref(bm), ctypes.byref(bn))
    return bm.value, bn.value, blocks


fused_encoder_layer.launches = 0
fused_decoder_layer.launches = 0
fused_greedy_head.launches = 0
fused_window_decoder_layer.launches = 0
fused_linear.launches = 0
fused_refnorm.launches = 0

# this module's counted wrappers, by kernel name (``ops.launch_counts``)
COUNTED = {"encoder_layer": fused_encoder_layer,
           "decoder_layer": fused_decoder_layer,
           "greedy_head": fused_greedy_head,
           "window_layer": fused_window_decoder_layer,
           "linear": fused_linear,
           "refnorm": fused_refnorm}


# ---------------------------------------------------------------------------
# stacks of layer launches (the JAX package's fused_encoder_forward /
# fused_decoder_forward; the one-call stacks are in ops/stack.py)
# ---------------------------------------------------------------------------

def fused_encoder_forward(x, src_mask: Optional[torch.Tensor],
                          packed: List[Dict[str, torch.Tensor]], final_norm,
                          num_heads: int):
    """Encoder stack: one ``fused_encoder_layer`` per layer (``packed``: the
    per-layer weights), then the final RefLayerNorm (plain torch; it lies
    outside the TPU kernel too)."""
    B, R, _ = x.shape
    if src_mask is None:
        src_mask = torch.ones((B, R), dtype=torch.bool, device=x.device)
    src_mask = src_mask.contiguous()
    for w in packed:
        x = fused_encoder_layer(x, src_mask, w, num_heads)
    return refnorm_plain(x, *final_norm)


def fused_decoder_forward(x, memory, tgt_mask, src_mask, packed, final_norm,
                          num_heads: int):
    """Decoder stack: one ``fused_decoder_layer`` per layer, then the final
    RefLayerNorm."""
    B, R = memory.shape[:2]
    if src_mask is None:
        src_mask = torch.ones((B, R), dtype=torch.bool, device=x.device)
    tgt_mask, src_mask = tgt_mask.contiguous(), src_mask.contiguous()
    for w in packed:
        x = fused_decoder_layer(x, memory, tgt_mask, src_mask, w, num_heads)
    return refnorm_plain(x, *final_norm)


# ---------------------------------------------------------------------------
# windowed SA fill (the JAX package's project_cross_kv /
# fused_window_decoder_forward)
# ---------------------------------------------------------------------------

def project_cross_kv(wkv2, bkv2, memory):
    """Every layer's cross-attention K/V of the memory, once per decode (they
    do not change across the SA rounds): wkv2 [NL,D,2D], bkv2 [NL,2D],
    memory [B,R,D] -> (k2s, v2s) [NL,B,R,D].  The product sums in float32
    and rounds to the compute dtype, then the bias adds, as the JAX einsum
    outside the kernels does."""
    D = memory.shape[-1]
    kv = torch.matmul(memory.float()[None], wkv2.float()[:, None])
    kv = kv.to(memory.dtype) + bkv2[:, None, None, :]
    return kv[..., :D].contiguous(), kv[..., D:].contiguous()


def fused_window_decoder_forward(x_win, w_start, k_caches, v_caches, k2s,
                                 v2s, tgt_mask, src_mask, packed, final_norm,
                                 num_heads: int):
    """Windowed decoder stack, one ``fused_window_decoder_layer`` per layer,
    then the final RefLayerNorm on the window.  k_caches/v_caches
    [NL,B,L,D] are updated in place: after each layer its fresh K/V are
    written at rows w_start[b] .. w_start[b] + W - 1 (a torch index write,
    as the JAX package scatters in XLA between launches).  Returns
    (h_win, k_caches, v_caches)."""
    tgt_mask, src_mask = tgt_mask.contiguous(), src_mask.contiguous()
    for i, w in enumerate(packed):
        x_win, kn, vn = fused_window_decoder_layer(
            x_win, k_caches[i], v_caches[i], k2s[i], v2s[i], tgt_mask,
            src_mask, w, num_heads)
        scatter_window(k_caches[i], kn, w_start)
        scatter_window(v_caches[i], vn, w_start)
    return refnorm_plain(x_win, *final_norm), k_caches, v_caches
