"""The LSTM captioners: the port of the JAX package's
``models/lstm_caption.py``: FC (Show&Tell), UpDown (Anderson et al. 2018),
Att2in2 (Rennie et al. 2017) and AoANet (Huang et al. 2019).

They speak BoFiCap's AR protocol (``LSTMCaptioner``), so ``decode/ar.py``,
the XE and RL steps, ``eval_split`` and the server drive them unchanged:

    encode(att_feats, att_masks)          -> memory
    init_ar_cache(memory, max_len)        -> {"state", "memory", "pre"}
    ar_step(it, pos, cache, src_mask)     -> (logprob [B, V], cache)
    forward(att, att_masks, labels, ...)  -> {"logprob": [B, L+1, V]}

plus ``gather_ar_cache`` (a beam search's reorder: the whole carry) and
``copy_ar_cache`` (a beam group's own copy of the carry).  Unlike BoFiCap's
KV cache, the carry is never written in place: each step returns a new one.

Numerics follow the flax modules:

  * ``LSTMCell`` is flax's ``nn.OptimizedLSTMCell``: gates i, f, g, o,
    ``c' = sigmoid(f) c + sigmoid(i) tanh(g)``, ``h' = sigmoid(o)
    tanh(c')``, the carry (c, h); the input kernels ``ii/if/ig/io`` have no
    bias, the hidden kernels ``hi/hf/hg/ho`` have one.  The eight kernels
    are put side by side once a forward or a decode
    (``LSTMCell.weights``, held in the cache's ``pre``), not once a step;
    autograd flows through the ``cat``;
  * Dense, Embed and the cell run in the compute dtype; the additive
    attention's scores are float32, filled with ``MASK_FILL``, softmaxed in
    float32 and cast back before the weighted sum; every ``log_softmax`` of
    ``logit`` is float32;
  * dropout (``rng``, a ``torch.Generator``; None is deterministic) on h
    every step at ``drop_prob_lm``, 0.1 on the probabilities of AoANet's
    refiner attention, none on its decoder attention.

AoANet's two multi-head attentions take the attention-core kernel
(``ops/attention.py``) under ``use_pallas`` (``set_attention_core``), as
the JAX package sends them to its TPU kernel: the refiner's self-attention
(a rank-2 mask, ``N_enc`` launches an encode) and the decoder's attention
(one query row, one launch an AR step).  With ``rng`` they take the plain
path.

Submodule and parameter names mirror the flax tree (``core.cell.if`` is
``core/cell/if``, ``ref0.MultiHeadAttention_0.wq``...), so ``convert.py``
maps them mechanically.

fc features: the masked mean of the region features (the reference's own
fallback when no fc store exists, dataloader.py:492-495).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils._pytree import tree_map

from .layers import (MASK_FILL, AttentionRouting, Dense, Embed, LayerNorm,
                     MultiHeadAttention, dropout, widen)


def masked_mean(att_feats, att_masks):
    """The mean over the live regions (all of them without a mask)."""
    if att_masks is None:
        return att_feats.mean(1)
    m = att_masks.to(att_feats.dtype)[..., None]
    return (att_feats * m).sum(1) / torch.clamp(m.sum(1), min=1e-6)


class LSTMCell(nn.Module):
    """flax ``nn.OptimizedLSTMCell`` over ``in_features`` inputs."""

    def __init__(self, in_features: int, hidden: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.compute_dtype = dtype
        for g in "ifgo":
            # "if" is a Python keyword: registered by name
            self.add_module(f"i{g}", Dense(in_features, hidden, dtype,
                                           device, use_bias=False))
        for g in "ifgo":
            self.add_module(f"h{g}", Dense(hidden, hidden, dtype, device))

    def weights(self):
        """(Wi [4H, in], Wh [4H, H], bh [4H]) in the compute dtype, the
        gates side by side in i, f, g, o order."""
        dt = self.compute_dtype
        sub = [self.get_submodule(f"i{g}") for g in "ifgo"]
        hid = [self.get_submodule(f"h{g}") for g in "ifgo"]
        return (torch.cat([m.weight for m in sub]).to(dt),
                torch.cat([m.weight for m in hid]).to(dt),
                torch.cat([m.bias for m in hid]).to(dt))

    def step(self, w, carry, x):
        """One step on ``weights()``: (c, h), x -> ((c', h'), h')."""
        Wi, Wh, bh = w
        c, h = carry
        dt = self.compute_dtype
        y = (torch.matmul(h, Wh.t()) + bh) + torch.matmul(x.to(dt), Wi.t())
        i, f, g, o = y.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


class LSTMCore(nn.Module):
    """One LSTM layer whose output takes dropout."""

    def __init__(self, in_features: int, rnn_size: int, drop: float = 0.5,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.rnn_size = rnn_size
        self.drop = drop
        self.compute_dtype = dtype
        self.cell = LSTMCell(in_features, rnn_size, dtype, device)

    def init_state(self, B: int, device):
        z = torch.zeros((B, self.rnn_size), dtype=self.compute_dtype,
                        device=device)
        return (z, z)

    def forward(self, w, state, x, rng=None):
        state, h = self.cell.step(w, state, x)
        return state, dropout(h, self.drop, rng)


class LSTMCaptioner(AttentionRouting, nn.Module):
    """The AR protocol over a model's ``encode``, ``_carry_init``,
    ``_precompute`` and ``_step_core`` (the JAX package's ``_ARMixin``).
    Parameters are created zero-filled; ``convert.init_params`` or a loader
    fill them."""

    def __init__(self, tgt_vocab: int, d_model: int, rnn_size: int,
                 drop_prob_lm: float, max_length: int, att_feat_size: int,
                 max_boxes: int, dtype):
        super().__init__()
        self.tgt_vocab = tgt_vocab
        self.d_model = d_model
        self.rnn_size = rnn_size
        self.drop_prob_lm = drop_prob_lm
        self.max_length = max_length
        # the feature store's width and region count (the server's
        # request shape)
        self.att_feat_size = att_feat_size
        self.max_boxes = max_boxes
        # the JAX package builds every LSTM captioner as an AIC model
        self.train_mode = "AIC"
        self.dtype = dtype

    def invalidate_packed(self):
        """No kernel weights are packed: nothing to drop."""

    def generate(self, h):
        """Log-probabilities of ``logit(h)``, float32."""
        return torch.log_softmax(widen(self.logit(h)), dim=-1)

    def _cells(self):
        """The packed weights of each LSTM core, by attribute name."""
        return {name: m.cell.weights() for name, m in self.named_children()
                if isinstance(m, LSTMCore)}

    def _precompute(self, memory):
        """The loop-invariant part of a step, computed once a forward or a
        decode: the cores' packed weights, and the model's projections of
        the memory.  Rows follow the memory's, so a beam's rows of one
        image hold equal values."""
        return {"cells": self._cells()}

    def forward(self, att_feats, att_masks, labels, phrase_num=None,
                phrase_length=None, phrase_syn=None, glat_p=None, rng=None,
                ss_prob: float = 0.0):
        """Teacher-forced log-probs [B, L+1, V] of ``labels`` [B, L+2] (k
        rows an image: the memory is repeated, image-major).  The phrase
        tensors and ``glat_p`` are the BoFiCap signature's and unused.
        ``ss_prob`` > 0 is scheduled sampling (reference
        AttModel.py:141-160): at every step after the first, each row's
        input is, with that probability, a draw from the previous step's
        distribution; the coins and draws come from ``rng``."""
        memory = self.encode(att_feats, att_masks, rng)
        src_mask = None if att_masks is None else att_masks.bool()
        if labels.shape[0] != memory.shape[0]:
            k = labels.shape[0] // memory.shape[0]
            memory = memory.repeat_interleave(k, dim=0)
            if src_mask is not None:
                src_mask = src_mask.repeat_interleave(k, dim=0)
        seq = labels[:, :-1]
        B, T = seq.shape
        if ss_prob > 0.0 and rng is None:
            raise ValueError("scheduled sampling draws from a generator: "
                             "pass rng")
        pre = self._precompute(memory)
        carry = self._carry_init(memory, rng, pre)
        lps = []
        for t in range(T):
            it = seq[:, t]
            if ss_prob > 0.0 and t > 0:
                flip = (torch.rand(B, generator=rng, device=it.device)
                        < ss_prob)
                drawn = torch.multinomial(torch.exp(lps[-1].detach()), 1,
                                          generator=rng)[:, 0]
                it = torch.where(flip, drawn, it)
            lp, carry = self._step_core(it, carry, memory, src_mask, rng,
                                        pre)
            lps.append(lp)
        return {"logprob": torch.stack(lps, dim=1)}

    def init_ar_cache(self, memory, max_len: int):
        """The decode's cache: the carry, the memory and ``_precompute``'s
        values (the decode runs under ``no_grad``)."""
        del max_len
        pre = self._precompute(memory)
        return {"state": self._carry_init(memory, None, pre),
                "memory": memory, "pre": pre}

    def ar_step(self, it, pos: int, cache, src_mask, syn_t=None):
        """One step: token ids ``it`` [B] -> (logprob [B, V] float32, the
        next cache).  ``cache["pre"]`` None computes the loop-invariant
        part inline."""
        del pos, syn_t
        lp, state = self._step_core(it, cache["state"], cache["memory"],
                                    src_mask, None, cache["pre"])
        return lp, {**cache, "state": state}

    @staticmethod
    def gather_ar_cache(cache, flat_ix):
        """The cache's rows reordered by ``flat_ix`` (a beam search's
        parents): the whole carry.  The memory and its projections are left
        as they are: the rows of one image are equal."""
        return {**cache, "state": tree_map(lambda t: t[flat_ix],
                                           cache["state"])}

    @staticmethod
    def copy_ar_cache(cache):
        """A beam group's own copy of the carry ``init_ar_cache`` made
        (for FC, the state after the image embedding); the memory and its
        projections are shared."""
        return {**cache, "state": tree_map(torch.clone, cache["state"])}


class FCModel(LSTMCaptioner):
    """Show&Tell-style FC-LSTM: the image embedding feeds the LSTM once,
    then pure language modelling."""

    def __init__(self, tgt_vocab: int, d_model: int = 512,
                 rnn_size: int = 512, drop_prob_lm: float = 0.5,
                 max_length: int = 20, att_feat_size: int = 2048,
                 max_boxes: int = 36, dtype=torch.float32, device=None):
        super().__init__(tgt_vocab, d_model, rnn_size, drop_prob_lm,
                         max_length, att_feat_size, max_boxes, dtype)
        dd = dict(dtype=dtype, device=device)
        self.img_embed = Dense(att_feat_size, d_model, **dd)
        self.embed = Embed(tgt_vocab, d_model, **dd)
        self.core = LSTMCore(d_model, rnn_size, drop_prob_lm, **dd)
        self.logit = Dense(rnn_size, tgt_vocab, **dd)

    def encode(self, att_feats, att_masks=None, rng=None):
        """memory = [B, 1, d], the image embedding (no attention)."""
        fc = masked_mean(att_feats.to(self.dtype), att_masks)
        return self.img_embed(fc)[:, None, :]

    def _carry_init(self, memory, rng=None, pre=None):
        """The image embedding as the pre-bos input (Show&Tell's x_{-1} =
        CNN(I))."""
        cells = (pre or self._precompute(memory))["cells"]
        state = self.core.init_state(memory.shape[0], memory.device)
        state, _ = self.core(cells["core"], state, memory[:, 0], rng)
        return state

    def _step_core(self, it, state, memory, src_mask, rng=None, pre=None):
        cells = (pre or self._precompute(memory))["cells"]
        state, h = self.core(cells["core"], state, self.embed(it), rng)
        return self.generate(h), state


class Attention(nn.Module):
    """Additive (tanh) attention over region features (UpDown eq. 3-5)."""

    def __init__(self, rnn_size: int, att_hid: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.h2att = Dense(rnn_size, att_hid, dtype, device)
        self.alpha = Dense(att_hid, 1, dtype, device)

    def forward(self, h, att_feats, p_att_feats, att_masks=None):
        """p_att_feats: the precomputed projection of att_feats [B, R,
        att_hid]."""
        ah = self.h2att(h)
        dot = self.alpha(torch.tanh(p_att_feats + ah[:, None, :]))
        dot = widen(dot[..., 0])
        if att_masks is not None:
            dot = torch.where(att_masks, dot, MASK_FILL)
        w = torch.softmax(dot, dim=-1).to(att_feats.dtype)
        return (w[:, :, None] * att_feats).sum(1)


class UpDownModel(LSTMCaptioner):
    """Bottom-up / top-down captioner: an attention LSTM and a language
    LSTM."""

    def __init__(self, tgt_vocab: int, d_model: int = 512,
                 rnn_size: int = 512, att_hid_size: int = 512,
                 att_feat_size: int = 2048, drop_prob_lm: float = 0.5,
                 max_length: int = 20, max_boxes: int = 36,
                 dtype=torch.float32, device=None):
        super().__init__(tgt_vocab, d_model, rnn_size, drop_prob_lm,
                         max_length, att_feat_size, max_boxes, dtype)
        dd = dict(dtype=dtype, device=device)
        self.att_embed = Dense(att_feat_size, rnn_size, **dd)
        self.embed = Embed(tgt_vocab, d_model, **dd)
        self.att_lstm = LSTMCore(2 * rnn_size + d_model, rnn_size,
                                 drop_prob_lm, **dd)
        self.lang_lstm = LSTMCore(2 * rnn_size, rnn_size, drop_prob_lm,
                                  **dd)
        self.p_att = Dense(rnn_size, att_hid_size, **dd)
        self.attention = Attention(rnn_size, att_hid_size, **dd)
        self.logit = Dense(rnn_size, tgt_vocab, **dd)

    def encode(self, att_feats, att_masks=None, rng=None):
        return torch.relu(self.att_embed(att_feats.to(self.dtype)))

    def _carry_init(self, memory, rng=None, pre=None):
        B, dev = memory.shape[0], memory.device
        return {"att": self.att_lstm.init_state(B, dev),
                "lang": self.lang_lstm.init_state(B, dev)}

    def _precompute(self, memory):
        return {**super()._precompute(memory), "p_att": self.p_att(memory)}

    def _step_core(self, it, state, memory, src_mask, rng=None, pre=None):
        cells = (pre or super()._precompute(memory))["cells"]
        p_att = pre["p_att"] if pre is not None else self.p_att(memory)
        fc = masked_mean(memory, src_mask)
        h_lang_prev = state["lang"][1]
        x = torch.cat([h_lang_prev, fc, self.embed(it)], dim=-1)
        att_state, h_att = self.att_lstm(cells["att_lstm"], state["att"], x,
                                         rng)
        ctx = self.attention(h_att, memory, p_att, src_mask)
        lang_state, h_lang = self.lang_lstm(
            cells["lang_lstm"], state["lang"],
            torch.cat([ctx, h_att], dim=-1), rng)
        return self.generate(h_lang), {"att": att_state, "lang": lang_state}


class Att2in2Model(LSTMCaptioner):
    """Att2in2 (SCST, Rennie et al. 2017): one LSTM whose cell candidate
    receives the attended context through its own projection, a 2-way
    maxout in_transform, the attention reading the raw region features."""

    def __init__(self, tgt_vocab: int, d_model: int = 512,
                 rnn_size: int = 512, att_hid_size: int = 512,
                 att_feat_size: int = 2048, drop_prob_lm: float = 0.5,
                 max_length: int = 20, max_boxes: int = 36,
                 dtype=torch.float32, device=None):
        super().__init__(tgt_vocab, d_model, rnn_size, drop_prob_lm,
                         max_length, att_feat_size, max_boxes, dtype)
        dd = dict(dtype=dtype, device=device)
        self.embed = Embed(tgt_vocab, d_model, **dd)
        self.i2h = Dense(d_model, 5 * rnn_size, **dd)
        self.h2h = Dense(rnn_size, 5 * rnn_size, **dd)
        self.a2c = Dense(att_feat_size, 2 * rnn_size, **dd)
        self.ctx2att = Dense(att_feat_size, att_hid_size, **dd)
        self.attention = Attention(rnn_size, att_hid_size, **dd)
        self.logit = Dense(rnn_size, tgt_vocab, **dd)

    def encode(self, att_feats, att_masks=None, rng=None):
        # att2in attends over the raw (unprojected) region features
        return att_feats.to(self.dtype)

    def _carry_init(self, memory, rng=None, pre=None):
        z = torch.zeros((memory.shape[0], self.rnn_size), dtype=self.dtype,
                        device=memory.device)
        return (z, z)

    def _precompute(self, memory):
        return {"p_att": self.ctx2att(memory)}

    def _step_core(self, it, state, memory, src_mask, rng=None, pre=None):
        h_prev, c_prev = state
        p_att = pre["p_att"] if pre is not None else self.ctx2att(memory)
        att_res = self.attention(h_prev, memory, p_att, src_mask)
        s = self.i2h(self.embed(it)) + self.h2h(h_prev)
        R = self.rnn_size
        in_gate = torch.sigmoid(s[:, :R])
        forget_gate = torch.sigmoid(s[:, R:2 * R])
        out_gate = torch.sigmoid(s[:, 2 * R:3 * R])
        cand = s[:, 3 * R:] + self.a2c(att_res)
        in_transform = torch.maximum(cand[:, :R], cand[:, R:])
        c = forget_gate * c_prev + in_gate * in_transform
        h = dropout(out_gate * torch.tanh(c), self.drop_prob_lm, rng)
        return self.generate(h), (h, c)


class AoA(nn.Module):
    """Attention on attention: a GLU over [attended; query]."""

    def __init__(self, in_features: int, d_model: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.info = Dense(in_features, d_model, dtype, device)
        self.gate = Dense(in_features, d_model, dtype, device)

    def forward(self, q, v):
        x = torch.cat([v, q], dim=-1)
        return self.info(x) * torch.sigmoid(self.gate(x))


class AoARefinerLayer(nn.Module):
    """Self-attention (probability dropout 0.1), the AoA gate, a residual
    and flax's LayerNorm."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.MultiHeadAttention_0 = MultiHeadAttention(
            num_heads, d_model, dtype, device, dropout_rate=0.1)
        self.AoA_0 = AoA(2 * d_model, d_model, dtype, device)
        self.LayerNorm_0 = LayerNorm(d_model, dtype=dtype, device=device)

    def forward(self, x, mask, rng=None):
        att = self.MultiHeadAttention_0(x, x, x, mask, rng)
        return self.LayerNorm_0(x + self.AoA_0(x, att))


class AoANet(LSTMCaptioner):
    """Attention-on-attention captioner: an AoA self-attention refiner over
    the region features and an LSTM decoder with an AoA-gated multi-head
    attention."""

    def __init__(self, tgt_vocab: int, d_model: int = 512,
                 rnn_size: int = 512, num_heads: int = 8, N_enc: int = 6,
                 att_feat_size: int = 2048, drop_prob_lm: float = 0.5,
                 max_length: int = 20, max_boxes: int = 36,
                 dtype=torch.float32, device=None):
        super().__init__(tgt_vocab, d_model, rnn_size, drop_prob_lm,
                         max_length, att_feat_size, max_boxes, dtype)
        dd = dict(dtype=dtype, device=device)
        self.N_enc = N_enc
        self.num_heads = num_heads
        self.att_embed = Dense(att_feat_size, d_model, **dd)
        for i in range(N_enc):
            self.add_module(f"ref{i}", AoARefinerLayer(d_model, num_heads,
                                                       **dd))
        self.embed = Embed(tgt_vocab, d_model, **dd)
        self.core = LSTMCore(2 * d_model, rnn_size, drop_prob_lm, **dd)
        self.dec_att = MultiHeadAttention(num_heads, d_model, dtype, device,
                                          dropout_rate=0.0, q_in=rnn_size)
        self.dec_aoa = AoA(d_model + rnn_size, d_model, **dd)
        self.logit = Dense(d_model, tgt_vocab, **dd)

    def refiner(self):
        return [self.get_submodule(f"ref{i}") for i in range(self.N_enc)]

    def encode(self, att_feats, att_masks=None, rng=None):
        x = torch.relu(self.att_embed(att_feats.to(self.dtype)))
        mask = None if att_masks is None else att_masks.bool()
        for layer in self.refiner():
            x = layer(x, mask, rng)
        return x

    def _carry_init(self, memory, rng=None, pre=None):
        B, dev = memory.shape[0], memory.device
        return {"state": self.core.init_state(B, dev),
                "ctx": torch.zeros((B, self.d_model), dtype=self.dtype,
                                   device=dev)}

    def _precompute(self, memory):
        # the decoder attention's K / V of the refined memory, once
        kh, vh = self.dec_att.project_kv(memory)
        return {**super()._precompute(memory), "kh": kh, "vh": vh}

    def _step_core(self, it, carry, memory, src_mask, rng=None, pre=None):
        if pre is None:
            cells = super()._precompute(memory)["cells"]
            kh, vh = self.dec_att.project_kv(memory)
        else:
            cells, kh, vh = pre["cells"], pre["kh"], pre["vh"]
        fc = masked_mean(memory, src_mask)
        x = torch.cat([self.embed(it), fc + carry["ctx"]], dim=-1)
        state, h = self.core(cells["core"], carry["state"], x, rng)
        qh = self.dec_att.project_q(h[:, None, :])
        att = self.dec_att.attend(qh, kh, vh, src_mask, rng)[:, 0]
        ctx = self.dec_aoa(h, att)
        return self.generate(ctx), {"state": state, "ctx": ctx}
