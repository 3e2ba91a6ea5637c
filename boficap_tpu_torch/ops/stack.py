"""Whole-stack kernels: the port of the JAX package's
``ops/pallas_stack.py``.

Four wrappers replace the four TPU kernels that run all NL layers of a
stack in one launch:

  ``fused_encoder_stack_forward`` <- ``_enc_stack_kernel``      (pallas_stack.py:415)
  ``fused_decoder_stack_forward`` <- ``_dec_stack_kernel``      (pallas_stack.py:258)
  ``fused_window_decoder_stack``  <- ``_win_stack_kernel``      (pallas_stack.py:551)
  ``fused_window_wide_stack``     <- ``_win_wide_stack_kernel`` (pallas_stack.py:712)

On a CUDA tensor each makes one call into its kernel library: the entries
``bfc_encoder_stack`` of ``csrc/encoder_layer.cu`` and
``bfc_decoder_stack`` of ``csrc/decoder_layer.cu`` loop those files'
layer bodies over the layers (the decoder stack first projects every
layer's cross K|V in one product, and at bf16 chains its launches by
programmatic dependent launch); ``bfc_window_stack`` and
``bfc_window_wide_stack`` of ``csrc/window_stack.cu`` loop
``csrc/window.cuh``'s (11 launches a layer).  Around the call the wrapper
runs nothing but ``torch.empty``, then the final RefLayerNorm in plain
torch (it lies outside the TPU kernels too).  On a CPU tensor it runs its
plain twin (``*_plain``).  Each counts its CUDA calls in ``.launches``
(``COUNTED``).

The TPU kernels take one ``[NL, ROWS, 512]`` weight blob with ``w1``
transposed (a VMEM/DMA layout), block-diagonal masks and a one-hot scatter
matrix.  None of that is ported: the weights are stacked per name
(``[NL, ...]``: ``StackPack``, ``WindowPack``), the masks are per sample,
and the narrow SA round takes its window starts as ``[B]`` int32.

Bounds on the H100 at B = 64, D = 512, d_ff = 2048, 6 layers, R = 36,
L = 20: the encoder stack does ~88 GFLOP and the NA decoder stack ~72
GFLOP against ~75 / ~100 MB of float32 weights, bound by operations in
both types.  An SA narrow round (W = 8) moves ~208 MB in float32 and ~104
MB in bf16 for ~23 GFLOP; a wide round (W = 20) ~176 / ~88 MB for ~57
GFLOP.  On float32 FFMA both are bound by operations; in bf16 the narrow
round is bound by bytes (its weights and cross K/V are read again every
round) and the wide round by operations.  Every stack's bf16 products
run on the tensor cores (csrc/wgmma_gemm.cuh, the layer kernels' product),
so at bf16 the widths D and d_ff must be multiples of 8 and the wrappers
raise ``ValueError`` otherwise (``check_product_shape``); the float32
products run on float32 FFMA.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Tuple

import torch

from .decoder_layer import (_I, _LL, _P, _WIN_KEYS, _check_weights, _fields,
                            _kernels, _launch_layer, _mask_strides, _require,
                            _route, check_attention_shape,
                            check_window_products, decoder_call,
                            decoder_layer_plain, encoder_call,
                            encoder_layer_plain, linear_plain,
                            pack_encoder_layer, pack_layer_weights,
                            refnorm_plain,
                            scatter_window, window_layer_plain,
                            weight_shapes)


class StackPack(NamedTuple):
    """An encoder or decoder stack's weights: ``stack`` holds each name
    stacked over the layers ([NL, ...], the stack kernel's operands),
    ``layers`` the per-layer views of it (the layer kernel's), and
    ``final_norm`` the stack's final RefLayerNorm (scale, bias)."""
    stack: Dict[str, torch.Tensor]
    layers: List[Dict[str, torch.Tensor]]
    final_norm: Tuple[torch.Tensor, torch.Tensor]


def _stacked(per_layer: List[Dict[str, torch.Tensor]]):
    """Per-layer packs -> (each name stacked [NL, ...], per-layer views)."""
    stack = {k: torch.stack([w[k] for w in per_layer]).contiguous()
             for k in per_layer[0]}
    return stack, [_layer_views(stack, i) for i in range(len(per_layer))]


def _final_norm(norm):
    return norm.scale.detach().float(), norm.bias.detach().float()


def pack_encoder_stack(encoder, dtype) -> StackPack:
    """Encoder -> ``StackPack`` in the compute dtype (norms float32)."""
    return StackPack(*_stacked([pack_encoder_layer(layer, dtype)
                                for layer in encoder.layers()]),
                     _final_norm(encoder.RefLayerNorm_0))


def pack_decoder_stack(decoder, dtype) -> StackPack:
    """Decoder -> ``StackPack`` in the compute dtype (norms float32).  Its
    ``stack`` also holds ``wkv2_all`` [D, NL*2D], every layer's cross K|V
    projection side by side (layer l at columns 2Dl ..): the stack kernel
    projects the memory for every layer in one product on it."""
    stack, layers = _stacked([pack_layer_weights(layer, dtype)
                              for layer in decoder.layers()])
    NL, D, D2 = stack["wkv2"].shape
    stack["wkv2_all"] = stack["wkv2"].permute(1, 0, 2).reshape(
        D, NL * D2).contiguous()
    return StackPack(stack, layers, _final_norm(decoder.norm))


class WindowPack(NamedTuple):
    """A decoder stack's window weights: ``stack`` holds each name stacked
    over the layers ([NL, ...], the stack kernels' operands), ``layers`` the
    per-layer views of it (the per-layer kernel's), ``final_norm`` the
    decoder's final RefLayerNorm, ``wkv2`` [NL, D, 2D] / ``bkv2`` [NL, 2D]
    the cross K|V projections for ``project_cross_kv``."""
    stack: Dict[str, torch.Tensor]
    layers: List[Dict[str, torch.Tensor]]
    final_norm: Tuple[torch.Tensor, torch.Tensor]
    wkv2: torch.Tensor
    bkv2: torch.Tensor


def pack_window_weights(decoder, dtype) -> WindowPack:
    """Decoder -> ``WindowPack`` in the compute dtype (norms float32)."""
    per_layer = [pack_layer_weights(layer, dtype) for layer in decoder.layers()]
    wkv2 = torch.stack([w.pop("wkv2") for w in per_layer]).contiguous()
    bkv2 = torch.stack([w.pop("bkv2") for w in per_layer]).contiguous()
    return WindowPack(*_stacked(per_layer), _final_norm(decoder.norm), wkv2,
                      bkv2)


def _layer_views(stacked: Dict[str, torch.Tensor], i: int):
    return {k: v[i] for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

def encoder_stack_plain(x, src_mask, stacked, final_norm, num_heads: int):
    """``encoder_layer_plain`` over the layers, then the final norm."""
    for i in range(stacked["w1"].shape[0]):
        x = encoder_layer_plain(x, src_mask, _layer_views(stacked, i),
                                num_heads)
    return refnorm_plain(x, *final_norm)


def decoder_stack_plain(x, memory, tgt_mask, src_mask, stacked, final_norm,
                        num_heads: int):
    """The kernel's schedule: every layer's cross K|V of the memory first
    (each rounded as ``project_cross_kv`` and ``linear_plain`` round), then
    ``decoder_layer_plain`` over the layers on them, then the final norm."""
    NL = stacked["w1"].shape[0]
    kvs = [linear_plain(memory, stacked["wkv2"][i], stacked["bkv2"][i])
           for i in range(NL)]
    for i in range(NL):
        x = decoder_layer_plain(x, memory, tgt_mask, src_mask,
                                _layer_views(stacked, i), num_heads,
                                kv=kvs[i])
    return refnorm_plain(x, *final_norm)


def window_stack_plain(x_win, w_start, k_caches, v_caches, k2s, v2s,
                       tgt_mask, src_mask, stacked, final_norm,
                       num_heads: int):
    """The narrow round: per layer, ``window_layer_plain`` over that layer's
    cache as it was before this layer, then its fresh K/V written into the
    cache at rows w_start[b] .. w_start[b] + W - 1 (in place)."""
    for i in range(k_caches.shape[0]):
        x_win, kn, vn = window_layer_plain(
            x_win, k_caches[i], v_caches[i], k2s[i], v2s[i], tgt_mask,
            src_mask, _layer_views(stacked, i), num_heads)
        scatter_window(k_caches[i], kn, w_start)
        scatter_window(v_caches[i], vn, w_start)
    return refnorm_plain(x_win, *final_norm), k_caches, v_caches


def window_wide_stack_plain(x_win, k2s, v2s, tgt_mask, src_mask, stacked,
                            final_norm, num_heads: int):
    """The wide round (W == L): no cache keys; each layer's fresh K/V are
    its whole new cache."""
    ks, vs = [], []
    for i in range(k2s.shape[0]):
        x_win, kn, vn = window_layer_plain(
            x_win, None, None, k2s[i], v2s[i], tgt_mask, src_mask,
            _layer_views(stacked, i), num_heads)
        ks.append(kn)
        vs.append(vn)
    return (refnorm_plain(x_win, *final_norm), torch.stack(ks),
            torch.stack(vs))


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def fused_encoder_stack_forward(x, src_mask, stacked, final_norm,
                                num_heads: int):
    """The whole encoder stack, inference: x [B,R,D], bool src_mask [B,R]
    (padding; None: every region) or [B,R,R], ``stacked`` the
    ``StackPack.stack`` weights.  Returns the output after the final norm.
    On CUDA: one call of csrc/encoder_layer.cu (7 launches a layer)."""
    B, R, _ = x.shape
    if src_mask is None:
        src_mask = torch.ones((B, R), dtype=torch.bool, device=x.device)
    src_mask = src_mask.contiguous()
    if not _route(x, src_mask, stacked, final_norm):
        return encoder_stack_plain(x, src_mask, stacked, final_norm,
                                   num_heads)
    h = encoder_call("encoder_stack", x, src_mask, stacked, num_heads,
                     NL=stacked["w1"].shape[0])
    fused_encoder_stack_forward.launches += 1
    return refnorm_plain(h, *final_norm)


def fused_decoder_stack_forward(x, memory, tgt_mask, src_mask, stacked,
                                final_norm, num_heads: int):
    """The whole decoder stack, inference: x [B,L,D], memory [B,R,D], bool
    tgt_mask [B,L,L], bool src_mask [B,R] (None: every region) or [B,L,R],
    ``stacked`` the ``StackPack.stack`` weights of ``pack_decoder_stack``.
    Returns the output after the final norm.  On CUDA: one call of
    csrc/decoder_layer.cu (``decoder_launches``: every layer's cross K|V in
    one product, then 11 launches a layer, chained at bf16)."""
    B, R = memory.shape[:2]
    if src_mask is None:
        src_mask = torch.ones((B, R), dtype=torch.bool, device=x.device)
    tgt_mask, src_mask = tgt_mask.contiguous(), src_mask.contiguous()
    if not _route(x, memory, tgt_mask, src_mask, stacked, final_norm):
        return decoder_stack_plain(x, memory, tgt_mask, src_mask, stacked,
                                   final_norm, num_heads)
    h = decoder_call("decoder_stack", x, memory, tgt_mask, src_mask, stacked,
                     num_heads, NL=stacked["w1"].shape[0])
    fused_decoder_stack_forward.launches += 1
    return refnorm_plain(h, *final_norm)


class _WindowStackArgs(ctypes.Structure):
    """Mirror of csrc/window_stack.cu ``BfcWindowStackArgs``."""
    _fields_ = (_fields("x k_caches v_caches k2s v2s w_start tgt_mask", _P)
                + _fields("tgt_sb tgt_sq", _LL) + _fields("src_mask", _P)
                + _fields("src_sb src_sq", _LL)
                + _fields("s0 b0 s1 b1 s2 b2 wqkv bqkv wo bo wq2 bq2 wo2 bo2 "
                          "w1 bf1 w2 bf2 scratch out", _P)
                + _fields("NL B W L R D F H", _I))


def _launch_stack(entry: str, x_win, k_caches, v_caches, k2s, v2s, w_start,
                  tgt_mask, src_mask, stacked, num_heads: int, Lk: int):
    """Check the operands and run one stack entry; returns the stack's
    output before the final norm."""
    B, W, D = x_win.shape
    NL, _, L, _ = k_caches.shape
    R = k2s.shape[2]
    F = stacked["w1"].shape[-1]
    dev, dt = x_win.device, x_win.dtype
    _require(x_win, "x_win", dt, (B, W, D), dev)
    for name, t, rows in (("k_caches", k_caches, L), ("v_caches", v_caches, L),
                          ("k2s", k2s, R), ("v2s", v2s, R)):
        _require(t, name, dt, (NL, B, rows, D), dev)
    if w_start is not None:
        _require(w_start, "w_start", torch.int32, (B,), dev)
    tsb, tsq = _mask_strides(tgt_mask, B, W, Lk, dev, "tgt_mask")
    ssb, ssq = _mask_strides(src_mask, B, W, R, dev, "src_mask")
    _check_weights(stacked, weight_shapes(_WIN_KEYS, D, F, (NL,)), dt, dev)
    check_window_products(dt, D, F, x_win, stacked)
    check_attention_shape({"self-attention": (W, Lk, True),
                           "cross-attention": (W, R, False)},
                          D // num_heads, dt)
    n_scratch = _kernels().window_stack.bfc_window_stack_scratch(B, W, D, F)
    scratch = torch.empty(n_scratch, dtype=dt, device=dev)
    out = torch.empty_like(x_win)
    args = _WindowStackArgs(
        x=x_win.data_ptr(), k_caches=k_caches.data_ptr(),
        v_caches=v_caches.data_ptr(), k2s=k2s.data_ptr(), v2s=v2s.data_ptr(),
        w_start=None if w_start is None else w_start.data_ptr(),
        tgt_mask=tgt_mask.data_ptr(), tgt_sb=tsb, tgt_sq=tsq,
        src_mask=src_mask.data_ptr(), src_sb=ssb, src_sq=ssq,
        scratch=scratch.data_ptr(), out=out.data_ptr(),
        NL=NL, B=B, W=W, L=L, R=R, D=D, F=F, H=num_heads,
        **{k: stacked[k].data_ptr() for k in _WIN_KEYS})
    _launch_layer(entry, args, x_win, lib_name="window_stack")
    return out


def fused_window_decoder_stack(x_win, w_start, k_caches, v_caches, k2s, v2s,
                               tgt_mask, src_mask, stacked, final_norm,
                               num_heads: int):
    """One narrow SA fill round through the whole windowed decoder stack.

    x_win [B,W,D]; w_start int32 [B], the window's first decoder position
    (in [0, L - W]); k_caches/v_caches [NL,B,L,D]; k2s/v2s [NL,B,R,D]
    pre-projected cross K/V; bool tgt_mask [B,W,L+W] (cache columns, then
    window columns); bool src_mask [B,R] or [B,W,R]; ``stacked`` the
    ``WindowPack.stack`` weights.  Returns (h_win [B,W,D] after the final
    norm, k_caches, v_caches).

    The caches are UPDATED IN PLACE, as the TPU kernel aliases them input
    to output: each layer's fresh K/V replace rows w_start[b] ..
    w_start[b] + W - 1 after that layer's self-attention has read them, and
    no other row is written.  The returned caches are the input tensors; a
    caller must not reuse their old contents.  On CUDA: one call of
    csrc/window_stack.cu (11 launches a layer; the self-attention block
    writes the fresh K/V)."""
    if not _route(x_win, k_caches, v_caches, k2s, v2s, stacked):
        return window_stack_plain(x_win, w_start, k_caches, v_caches, k2s,
                                  v2s, tgt_mask, src_mask, stacked,
                                  final_norm, num_heads)
    L, W = k_caches.shape[2], x_win.shape[1]
    if W > L:
        raise ValueError(f"window {W} wider than the cache {L}")
    h = _launch_stack("window_stack", x_win, k_caches, v_caches, k2s, v2s,
                      w_start, tgt_mask.contiguous(), src_mask.contiguous(),
                      stacked, num_heads, L + W)
    fused_window_decoder_stack.launches += 1
    return refnorm_plain(h, *final_norm), k_caches, v_caches


def fused_window_wide_stack(x_win, k2s, v2s, tgt_mask, src_mask, stacked,
                            final_norm, num_heads: int):
    """One wide SA fill round (W == L) through the whole windowed decoder
    stack, with no cache keys: x_win [B,L,D], k2s/v2s [NL,B,R,D], bool
    tgt_mask [B,L,L], bool src_mask [B,R] or [B,L,R].  Returns (h_win
    after the final norm, the new caches k [NL,B,L,D], v [NL,B,L,D]): each
    layer's fresh K/V.  On CUDA: one call of csrc/window_stack.cu."""
    if not _route(x_win, k2s, v2s, stacked):
        return window_wide_stack_plain(x_win, k2s, v2s, tgt_mask, src_mask,
                                       stacked, final_norm, num_heads)
    NL = k2s.shape[0]
    B, W, D = x_win.shape
    k_new = torch.empty((NL, B, W, D), dtype=x_win.dtype, device=x_win.device)
    v_new = torch.empty_like(k_new)
    h = _launch_stack("window_wide_stack", x_win, k_new, v_new, k2s, v2s,
                      None, tgt_mask.contiguous(), src_mask.contiguous(),
                      stacked, num_heads, W)
    fused_window_wide_stack.launches += 1
    return refnorm_plain(h, *final_norm), k_new, v_new


fused_encoder_stack_forward.launches = 0
fused_decoder_stack_forward.launches = 0
fused_window_decoder_stack.launches = 0
fused_window_wide_stack.launches = 0

# this module's counted wrappers, by kernel name (``ops.launch_counts``)
COUNTED = {"encoder_stack": fused_encoder_stack_forward,
           "decoder_stack": fused_decoder_stack_forward,
           "window_stack": fused_window_decoder_stack,
           "window_wide_stack": fused_window_wide_stack}
