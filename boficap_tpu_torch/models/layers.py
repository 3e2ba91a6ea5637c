"""Transformer primitives: the port of the JAX package's
``models/layers.py`` (reference annotated-transformer pieces,
captioning/models/TransformerModel.py:1312-1507).

Numerics follow the JAX modules:

  * ``Dense`` is flax ``nn.Dense(dtype=...)``: input and parameters cast to
    the compute dtype, the product rounds to it, then the bias adds in it;
    parameters are stored in float32;
  * attention scores and softmax are float32, masked with the finite
    ``MASK_FILL`` (a fully masked row comes out uniform, never NaN), and
    the probabilities cast to the compute dtype before ``@ v``;
  * ``RefLayerNorm`` uses the unbiased std with eps added to the std.

``MultiHeadAttention.use_core`` (set for a whole model by
``BoFiCap.set_attention_core``, from the config's ``use_pallas``) routes
every attention with a rank-2 or rank-3 mask through the attention-core
kernel (``ops/attention.py``), as the JAX package's ``use_pallas`` routes
them to its TPU kernel; here it is a per-module attribute, not a process
global.  ``attend`` counts its calls by branch (``obs``:
``attend_calls.core``, ``attend_calls.plain``) while the counters record.

``AttentionRouting.capture_attention`` is the JAX package's
``set_capture_attention`` (its layers.py:34-38): inside it every
``attend`` takes the plain branch, whatever ``use_core`` says (the kernel
never forms the probabilities), and records its post-softmax
probabilities [B, H, Lq, Lk], before dropout, under the key that JAX's
``tree_flatten_with_path`` gives the sown value: the module's flax path
and the sow index, ``['decoder0']/['layer0']/['self_attn']/['attn']/[1]``.

``Encoder(remat=True)`` and ``Decoder(remat=True)`` (the config's
``remat``) recompute each layer in the backward pass instead of keeping
its activations (``remat_call``), as the JAX package's ``nn.remat`` does.

Casts to another dtype go through ``cast``, which counts the bytes each
writes (``obs``: ``cast_bytes.param`` for a parameter, ``cast_bytes.act``
for an activation) while the program's counters record.

``Dense.tp`` is None but on a tensor-parallel slice of the layer
(``parallel/mesh.py::shard_params``): then the slice's forward runs with
the collectives of ``parallel/tensor_parallel.py``.

Dropout sits at every site of the flax modules (attention
probabilities, the FFN's inner activation, each residual branch, the
positional encoding) and follows flax's law (``dropout``).  Every forward
takes ``rng``, a ``torch.Generator`` on the activations' device: None, the
default, is the JAX package's ``deterministic=True`` and draws nothing;
only the training forward passes one.  ``Module.training`` is never read,
so a decode on a model left in ``train()`` stays deterministic.

Submodule and parameter names mirror the flax parameter tree
(``layer{i}``, ``sub0.norm``, ``ffn.Dense_0``, ``Embed_0``...), so the
weight bridge (``convert.py``) is a mechanical renaming.  Parameters are
created zero-filled; ``convert.init_params`` or ``load_jax_params`` fill
them.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import obs
from ..ops.attention import attention_core

MASK_FILL = -1e9
# the counters of ``cast``: bytes written by casts of parameters and of
# activations
PARAM = "cast_bytes.param"
ACT = "cast_bytes.act"
# the counters of ``MultiHeadAttention.attend``: calls by branch
CORE_CALLS = "attend_calls.core"
PLAIN_CALLS = "attend_calls.plain"


def cast(x, dtype, counter: str):
    """``x.to(dtype)``; where that makes a copy, its bytes are added to
    ``counter`` (``PARAM`` or ``ACT``) while the counters record."""
    y = x.to(dtype)
    if y is not x and obs.recording():
        obs.count(counter, y.numel() * y.element_size())
    return y


def dropout(x, rate: float, rng: Optional[torch.Generator]):
    """flax ``nn.Dropout``: ``x`` itself when ``rng`` is None
    (deterministic) or the rate is 0; else each element kept with
    probability 1 - rate and scaled by 1 / (1 - rate), the mask drawn from
    ``rng``; rate 1 gives exact zeros, as flax does."""
    if rng is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=rng, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


def widen(x):
    """``x`` in float32 for the reductions, or float64 where it already is
    (a model whose compute dtype is float64: the float64 witness that
    ``chip_smoke.py`` holds float32 gradients to)."""
    return x if x.dtype == torch.float64 else cast(x, torch.float32, ACT)


class Dense(nn.Module):
    """``y = cast(x) @ cast(W).T`` rounded to the compute dtype, then
    ``+ cast(b)``; ``weight`` is [out, in] as in ``nn.Linear``.
    ``use_bias=False`` has no ``bias`` (flax ``use_bias=False``)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.float32, device=None, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(out_features, in_features, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if use_bias else None)
        self.compute_dtype = dtype
        # a parallel.tensor_parallel slice rule, set by shard_params
        self.tp = None

    def forward(self, x):
        if self.tp is not None:
            return self.tp.forward(self, x)
        dt = self.compute_dtype
        y = torch.matmul(cast(x, dt, ACT), cast(self.weight, dt, PARAM).t())
        return y if self.bias is None else y + cast(self.bias, dt, PARAM)


class Embed(nn.Module):
    """flax ``nn.Embed``: a lookup table cast to the compute dtype."""

    def __init__(self, num: int, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num, dim, device=device))
        self.compute_dtype = dtype

    def forward(self, ids):
        return cast(F.embedding(ids, self.weight), self.compute_dtype, ACT)


class MultiHeadAttention(nn.Module):
    """Scaled dot-product MHA (reference TransformerModel.py:1421-1467);
    heads are column slices ``h*Dh:(h+1)*Dh`` of the projections.
    ``q_in``: the query's width, when it is not ``d_model`` (AoANet's
    decoder attention reads the LSTM's hidden state)."""

    def __init__(self, num_heads: int, d_model: int, dtype=torch.float32,
                 device=None, dropout_rate: float = 0.1,
                 q_in: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.d_model = d_model
        self.compute_dtype = dtype
        self.dropout_rate = dropout_rate
        # route rank-2/3-masked calls through the attention-core kernel
        self.use_core = False
        # capture_attention's (store, key prefix), else None
        self.capture = None
        # ranks of the 'model' axis the heads are split over (shard_params)
        self.tp_size = 1
        self.wq = Dense(q_in or d_model, d_model, dtype, device)
        for name in ("wk", "wv", "wo"):
            setattr(self, name, Dense(d_model, d_model, dtype, device))

    def _heads(self, x):
        B, L, _ = x.shape
        H = self.num_heads
        return x.reshape(B, L, H, self.d_model // H)

    def project_q(self, x):
        return self._heads(self.wq(x))

    def project_kv(self, x):
        return self._heads(self.wk(x)), self._heads(self.wv(x))

    def attend(self, qh, kh, vh, mask=None, rng=None):
        """qh [B,Lq,H,Dh], kh/vh [B,Lk,H,Dh]; bool mask [B,Lk] | [B,Lq,Lk]
        | 4-D broadcastable over [B,H,Lq,Lk] (True = attend).  With
        ``use_core`` and no ``rng`` (deterministic) a rank-2/3 mask routes
        to the attention-core kernel (layers.py:115-130 of the JAX
        package); the views it is handed are read in place.  With ``rng``
        the probabilities take dropout, on the plain path."""
        B, Lq, H, Dh = qh.shape
        if self.use_core and self.tp_size > 1:
            raise ValueError("a tensor-parallel slice runs the plain "
                             "attention: turn use_pallas off")
        if (self.use_core and self.capture is None and rng is None
                and mask is not None and mask.dim() in (2, 3)):
            obs.count(CORE_CALLS, 1)
            Lk = kh.shape[1]
            m3 = mask[:, None, :] if mask.dim() == 2 else mask
            out = attention_core(qh.transpose(1, 2), kh.transpose(1, 2),
                                 vh.transpose(1, 2), m3.expand(B, Lq, Lk))
            return self.wo(out.transpose(1, 2).reshape(B, Lq, self.d_model))
        obs.count(PLAIN_CALLS, 1)
        scores = torch.einsum("bqhd,bkhd->bhqk", widen(qh),
                              widen(kh)) / math.sqrt(Dh)
        if mask is not None:
            if mask.dim() == 2:
                mask = mask[:, None, None, :]
            elif mask.dim() == 3:
                mask = mask[:, None, :, :]
            # a Python scalar: a tensor made here would be a blocking
            # host-to-device copy, a stream sync on every call
            scores = torch.where(mask, scores, MASK_FILL)
        probs = cast(torch.softmax(scores, dim=-1), self.compute_dtype, ACT)
        if self.capture is not None:
            store, prefix = self.capture
            n = sum(k.startswith(prefix) for k in store)
            store[f"{prefix}/[{n}]"] = probs.detach()
        probs = dropout(probs, self.dropout_rate, rng)
        out = torch.einsum("bhqk,bkhd->bqhd", widen(probs), widen(vh))
        out = cast(out, self.compute_dtype, ACT).reshape(B, Lq, self.d_model)
        return self.wo(out)

    def forward(self, q, k, v, mask=None, rng=None):
        qh = self.project_q(q)
        kh = self._heads(self.wk(k))
        vh = self._heads(self.wv(v))
        return self.attend(qh, kh, vh, mask, rng)


class AttentionRouting:
    """The attention-core switch of a whole model (a mixin of its
    ``nn.Module``): every ``MultiHeadAttention`` it holds."""

    def set_attention_core(self, enabled: bool) -> None:
        """Route (or stop routing) every attention of the model whose mask
        has rank 2 or 3 through the attention-core kernel
        (``MultiHeadAttention.use_core``): the config's ``use_pallas``, as
        the JAX package's ``models.setup`` reads it."""
        for m in self.modules():
            if isinstance(m, MultiHeadAttention):
                m.use_core = bool(enabled)

    @contextlib.contextmanager
    def plain_attention(self):
        """Every attention on the plain path inside the block, the
        attention-core setting restored after it: for a forward that
        autograd records (the XE step, the RL re-score), since the kernel
        has no backward and its wrapper refuses operands that require
        grad."""
        mods = [m for m in self.modules()
                if isinstance(m, MultiHeadAttention)]
        was = [m.use_core for m in mods]
        for m in mods:
            m.use_core = False
        try:
            yield
        finally:
            for m, w in zip(mods, was):
                m.use_core = w

    @contextlib.contextmanager
    def capture_attention(self):
        """Attention-map capture (the JAX package's
        ``set_capture_attention``, the reference's ``glo`` accumulator fed
        at TransformerModel.py:1461-1462): yields a dict that every
        ``attend`` inside the block fills with its probabilities, on the
        plain path, keyed as JAX's ``tree_flatten_with_path`` keys the sown
        'intermediates' (the flax path from the weight bridge's
        ``flax_layout``, then ``['attn']/[i]``, i the call's index at that
        module)."""
        from ..convert import flax_layout
        layout = flax_layout(self)
        store = {}
        mods = []
        for name, m in self.named_modules():
            if isinstance(m, MultiHeadAttention):
                path = layout[f"{name}.wq.weight"][0][:-2]
                m.capture = (store, "/".join(f"['{p}']" for p in path)
                             + "/['attn']")
                mods.append(m)
        try:
            yield store
        finally:
            for m in mods:
                m.capture = None


class PositionwiseFFN(nn.Module):
    """d -> d_ff -> relu -> dropout -> d (reference :1469-1478)."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.float32,
                 device=None, dropout_rate: float = 0.1):
        super().__init__()
        self.Dense_0 = Dense(d_model, d_ff, dtype, device)
        self.Dense_1 = Dense(d_ff, d_model, dtype, device)
        self.dropout_rate = dropout_rate

    def forward(self, x, rng=None):
        h = dropout(torch.relu(self.Dense_0(x)), self.dropout_rate, rng)
        return self.Dense_1(h)


class RefLayerNorm(nn.Module):
    """``scale * (x - mean) / (std + eps) + bias`` with the UNBIASED std
    (torch ``x.std(-1)``), eps outside the sqrt (reference
    TransformerModel.py:1338-1349).  Computed in float32 with the JAX
    module's shifted one-pass moments, output in the compute dtype."""

    def __init__(self, d: int, eps: float = 1e-6, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x):
        d = x.shape[-1]
        xf = widen(x)
        xs = xf - xf[..., :1]
        m1 = xs.mean(-1, keepdim=True)
        m2 = (xs * xs).mean(-1, keepdim=True)
        var = torch.clamp(m2 - m1 * m1, min=0.0) * (d / max(d - 1, 1))
        y = (xs - m1) / (torch.sqrt(var) + self.eps)
        return cast(y * self.scale + self.bias, self.compute_dtype, ACT)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (not the reference's norm, ``RefLayerNorm``):
    float32 moments in one pass, ``var = max(0, E[x^2] - E[x]^2)`` (flax's
    ``use_fast_variance``), ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``, output in the compute dtype."""

    def __init__(self, d: int, eps: float = 1e-6, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x):
        xf = widen(x)
        mu = xf.mean(-1, keepdim=True)
        mu2 = (xf * xf).mean(-1, keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return cast((xf - mu) * mul + self.bias, self.compute_dtype, ACT)


class PreNormResidual(nn.Module):
    """``x + dropout(f(norm(x)))`` (reference SublayerConnection
    :1351-1363)."""

    def __init__(self, d: int, dtype=torch.float32, device=None,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.norm = RefLayerNorm(d, dtype=dtype, device=device)
        self.dropout_rate = dropout_rate

    def forward(self, x, fn, rng=None):
        return x + dropout(fn(self.norm(x)), self.dropout_rate, rng)

    def norm_only(self, x):
        return self.norm(x)


@contextlib.contextmanager
def _replayed_routing(mods, cores):
    """Inside the block each attention of ``mods`` takes the route it took
    in the forward (``cores``: whether that was the attention core); the
    settings of the moment come back after it."""
    was = [m.use_core for m in mods]
    for m, core in zip(mods, cores):
        m.use_core = core
    try:
        yield
    finally:
        for m, core in zip(mods, was):
            m.use_core = core


def remat_call(layer, *args, rng=None, **kwargs):
    """``layer(*args, rng=rng, **kwargs)`` rematerialized (JAX
    ``nn.remat``): ``torch.utils.checkpoint``, non-reentrant, keeps none
    of the layer's activations and runs the layer again in the backward
    pass, where they are needed.

    The recompute must see what the forward saw.  The dropout masks:
    checkpoint restores only the global RNGs, not ``rng``, so the layer
    runs on a generator of its own set to ``rng``'s state before the
    layer, in the forward and again in the recompute, and ``rng`` then
    takes the state the forward left it in: the masks, and ``rng``'s state
    after the step, are those of the plain call.  The attention routes:
    the backward runs outside the caller's ``plain_attention`` block, so
    the recompute takes each attention's route of the forward."""
    mods = [m for m in layer.modules() if isinstance(m, MultiHeadAttention)]
    # a capturing attention takes the plain branch whatever use_core says
    cores = [m.use_core and m.capture is None for m in mods]
    start = None if rng is None else rng.get_state()
    replay = None if rng is None else torch.Generator(device=rng.device)

    def run(*a):
        if replay is not None:
            replay.set_state(start)
        return layer(*a, rng=replay, **kwargs)

    out = checkpoint(run, *args, use_reentrant=False, context_fn=lambda: (
        contextlib.nullcontext(), _replayed_routing(mods, cores)))
    if rng is not None:
        rng.set_state(replay.get_state())
    return out


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ff: int, num_heads: int,
                 dtype=torch.float32, device=None, dropout_rate: float = 0.1):
        super().__init__()
        dd = dict(device=device, dropout_rate=dropout_rate)
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype, **dd)
        self.ffn = PositionwiseFFN(d_model, d_ff, dtype, **dd)
        self.sub0 = PreNormResidual(d_model, dtype, **dd)
        self.sub1 = PreNormResidual(d_model, dtype, **dd)

    def forward(self, x, mask, rng=None):
        x = self.sub0(x, lambda y: self.self_attn(y, y, y, mask, rng), rng)
        return self.sub1(x, lambda y: self.ffn(y, rng), rng)


class Encoder(nn.Module):
    """N self-attention layers + final norm over region features
    (reference :1325-1336).

    ``remat``: each layer is rematerialized in the backward pass
    (``remat_call``): its activations are recomputed instead of stored,
    so each layer's forward runs twice a step, for O(layers) less training
    memory.
    Parameters, flax layout and numerics are unchanged (the gradients
    bitwise, dropout included), and so is every pass without autograd:
    remat acts only where ``torch.is_grad_enabled()``.  The final norm is
    not rematerialized."""

    def __init__(self, num_layers: int, d_model: int, d_ff: int,
                 num_heads: int, dtype=torch.float32, device=None,
                 dropout_rate: float = 0.1, remat: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.remat = remat
        for i in range(num_layers):
            self.add_module(f"layer{i}", EncoderLayer(
                d_model, d_ff, num_heads, dtype, device, dropout_rate))
        self.RefLayerNorm_0 = RefLayerNorm(d_model, dtype=dtype,
                                           device=device)

    def layers(self):
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def forward(self, x, mask, rng=None):
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers():
            x = (remat_call(layer, x, mask, rng=rng) if remat
                 else layer(x, mask, rng))
        return self.RefLayerNorm_0(x)


class DecoderLayer(nn.Module):
    """self-attn + cross-attn + ffn over any bool tgt mask (reference
    :1398-1413); also the length-predictor layer (:1016-1029)."""

    def __init__(self, d_model: int, d_ff: int, num_heads: int,
                 dtype=torch.float32, device=None, dropout_rate: float = 0.1):
        super().__init__()
        dd = dict(device=device, dropout_rate=dropout_rate)
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype, **dd)
        self.src_attn = MultiHeadAttention(num_heads, d_model, dtype, **dd)
        self.ffn = PositionwiseFFN(d_model, d_ff, dtype, **dd)
        self.sub0 = PreNormResidual(d_model, dtype, **dd)
        self.sub1 = PreNormResidual(d_model, dtype, **dd)
        self.sub2 = PreNormResidual(d_model, dtype, **dd)

    def forward(self, x, memory, src_mask, tgt_mask, kv=None, rng=None,
                grouped: bool = False):
        """``kv`` (optional) supplies distinct self-attention keys/values,
        normed with the same parameters (the fast bounding path);
        ``grouped``: see ``_cross``."""
        if kv is None:
            x = self.sub0(x, lambda y: self.self_attn(y, y, y, tgt_mask, rng),
                          rng)
        else:
            nkv = self.sub0.norm_only(kv)
            x = self.sub0(x, lambda y: self.self_attn(y, nkv, nkv, tgt_mask,
                                                      rng), rng)
        x = self.sub1(x, lambda y: self._cross(y, memory, src_mask, rng,
                                               grouped), rng)
        return self.sub2(x, lambda y: self.ffn(y, rng), rng)

    def _cross(self, y, memory, src_mask, rng, grouped: bool):
        """Cross-attention.  With ``grouped`` and a query batch k times the
        memory's, the k caption rows of each image (image-major, the
        ``repeat_interleave`` order of the training collate) fold into the
        query-length axis over that image's keys, [B*k, L, d] -> [B, k*L,
        d]: row for row the same as repeating the memory, with one K/V
        projection per image (JAX ``layers.py:323-352``).  A batch
        mismatch without ``grouped`` raises."""
        B = memory.shape[0]
        if y.shape[0] != B:
            if not (grouped and y.shape[0] % B == 0):
                raise ValueError(
                    f"cross-attention query batch {y.shape[0]} != memory "
                    f"batch {B}: repeat the memory to match, or pass "
                    "grouped=True for image-major caption rows")
            yr = y.reshape(B, -1, y.shape[-1])
            out = self.src_attn(yr, memory, memory, src_mask, rng)
            return out.reshape(y.shape)
        return self.src_attn(y, memory, memory, src_mask, rng)

    def cross_only(self, x, memory, src_mask, rng=None):
        """N_len == 0 predictor variant: one cross-attention sublayer."""
        return self.sub0(x, lambda y: self.src_attn(y, memory, memory,
                                                    src_mask, rng), rng)

    def init_cache(self, memory, max_len: int):
        """Per-layer KV cache: zeroed self-attention K/V [B, max_len, H, Dh]
        and the cross-attention K/V of the encoder memory, projected once."""
        kc, vc = self.src_attn.project_kv(memory)
        B, _, H, Dh = kc.shape
        z = torch.zeros((B, max_len, H, Dh), dtype=kc.dtype,
                        device=kc.device)
        return {"ks": z, "vs": z.clone(), "kc": kc, "vc": vc}

    def step(self, x_t, cache, pos: int, src_mask, vis):
        """One causal decode step (deterministic): x_t [B, 1, d] at 0-based
        position ``pos``.  Returns (out_t [B, 1, d], cache).  Unlike the
        JAX package's immutable arrays, the cache's self-attention K/V are
        written IN PLACE at ``pos`` and the same dict comes back.  ``vis``,
        the self-attention's mask, is made once a step for all layers
        (``Decoder.step``).  With the self-attention's ``use_core`` it is
        an all-True [B, pos + 1], and the attention core reads the written
        rows 0..pos alone (views of the cache, read in place); else it is
        the rank-4 visibility mask of keys <= pos (``step_mask``) over every
        row, on the plain path, as in the JAX package.  The
        cross-attention's [B, R] mask may take the attention core either
        way."""
        n = self.sub0.norm_only(x_t)
        kh, vh = self.self_attn.project_kv(n)
        ks, vs = cache["ks"], cache["vs"]
        ks[:, pos] = kh[:, 0]
        vs[:, pos] = vh[:, 0]
        q = self.self_attn.project_q(n)
        if self.self_attn.use_core:
            att = self.self_attn.attend(q, ks[:, :pos + 1], vs[:, :pos + 1],
                                        vis)
        else:
            att = self.self_attn.attend(q, ks, vs, vis)
        x = x_t + att
        q1 = self.src_attn.project_q(self.sub1.norm_only(x))
        x = x + self.src_attn.attend(q1, cache["kc"], cache["vc"], src_mask)
        return self.sub2(x, self.ffn), cache


class Decoder(nn.Module):
    """N DecoderLayers + final norm (reference :1379-1396).  ``remat``:
    see ``Encoder``; it reaches ``forward`` only: the cached inference
    step (``init_cache``, ``step``) runs the layers as they are."""

    def __init__(self, num_layers: int, d_model: int, d_ff: int,
                 num_heads: int, dtype=torch.float32, device=None,
                 dropout_rate: float = 0.1, remat: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.remat = remat
        for i in range(num_layers):
            self.add_module(f"layer{i}", DecoderLayer(
                d_model, d_ff, num_heads, dtype, device, dropout_rate))
        self.norm = RefLayerNorm(d_model, dtype=dtype, device=device)

    def layers(self):
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def forward(self, x, memory, src_mask, tgt_mask, rng=None,
                grouped: bool = False):
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers():
            if remat:
                x = remat_call(layer, x, memory, src_mask, tgt_mask,
                               rng=rng, grouped=grouped)
            else:
                x = layer(x, memory, src_mask, tgt_mask, rng=rng,
                          grouped=grouped)
        return self.norm(x)

    def init_cache(self, memory, max_len: int):
        """Every layer's cache (``DecoderLayer.init_cache``), each holding
        ``keep``, one all-True [max_len] row made once a decode: the
        attention core's mask of the written keys (``step``)."""
        keep = torch.ones(max_len, dtype=torch.bool, device=memory.device)
        return [{**layer.init_cache(memory, max_len), "keep": keep}
                for layer in self.layers()]

    def step(self, x_t, caches, pos: int, src_mask):
        """One KV-cached step through every layer (caches updated in
        place), then the final norm.  The self-attention's mask, made once
        for all layers by the routing ``set_attention_core`` gives them
        alike: on the attention core, ``keep``'s first pos + 1 entries
        expanded over B (batch stride 0, no copy); else ``step_mask``."""
        if self.layer0.self_attn.use_core:
            vis = caches[0]["keep"][None, :pos + 1].expand(x_t.shape[0],
                                                           pos + 1)
        else:
            vis = step_mask(caches[0]["ks"].shape[1], pos, x_t.device)
        for layer, cache in zip(self.layers(), caches):
            x_t, _ = layer.step(x_t, cache, pos, src_mask, vis)
        return self.norm(x_t), caches


class TokenEmbed(nn.Module):
    """Embedding scaled by sqrt(d) (reference Embeddings :1480-1487)."""

    def __init__(self, vocab: int, d_model: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.d_model = d_model
        self.Embed_0 = Embed(vocab, d_model, dtype, device)

    def forward(self, ids):
        return self.Embed_0(ids) * math.sqrt(self.d_model)


@functools.lru_cache(maxsize=16)
def sinusoid_np(max_len: int, d_model: int) -> np.ndarray:
    """Sinusoid position table [max_len, d_model], float32."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class PositionalEncoding(nn.Module):
    """Sinusoid PE added to [..., L, d], then dropout (reference
    :1489-1507), starting at row ``offset`` (a single-token decode step's
    position); the table is a non-persistent buffer, so it never enters a
    checkpoint."""

    def __init__(self, d_model: int, max_len: int = 5000, device=None,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.max_len = max_len
        self.dropout_rate = dropout_rate
        self.register_buffer(
            "pe", torch.from_numpy(sinusoid_np(max_len, d_model).copy()).to(
                device), persistent=False)

    def forward(self, x, offset: int = 0, rng=None):
        x = x + self.pe[offset:offset + x.shape[-2]].to(x.dtype)
        return dropout(x, self.dropout_rate, rng)


class Generator(nn.Module):
    """Linear d -> vocab, log_softmax in float32 (reference :1312-1319)."""

    def __init__(self, d_model: int, vocab: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.proj = Dense(d_model, vocab, dtype, device)

    def forward(self, x):
        return torch.log_softmax(self.logits(x), dim=-1)

    def logits(self, x):
        return widen(self.proj(x))


def causal_mask(L: int, device=None) -> torch.Tensor:
    """[L, L] lower-triangular visibility (reference subsequent_mask
    :1415-1419)."""
    return torch.tril(torch.ones((L, L), dtype=torch.bool, device=device))


def step_mask(Lk: int, pos: int, device=None) -> torch.Tensor:
    """[1, 1, 1, Lk] visibility of a decode step's keys: key <= pos."""
    return (torch.arange(Lk, device=device) <= pos)[None, None, None, :]


def prefix_mask(prefix: torch.Tensor, Lk: int) -> torch.Tensor:
    """[..., Lk] visibility: key < prefix[...]."""
    key = torch.arange(Lk, device=prefix.device)
    return key < prefix[..., None]
