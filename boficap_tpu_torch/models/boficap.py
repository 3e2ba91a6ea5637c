"""BoFiCap: the port of the JAX package's ``models/boficap.py`` (reference
TransformerModel.py:97-175, 386-587, 1713-1789).

Inference: the parameters each train_mode's flax tree holds, ``encode``,
the cached bounding step (the N_len == 1 path every shipped config uses)
and the general ``bound_step``, the add | single | gate decoder-input mix
(over the whole frame, or over a window of slots for the SA fill),
``decode_na``, ``decode_sa``, ``decode_a``, the KV-cached AR step
(``init_ar_cache``, ``ar_step``) and the generator.

NNAIC's whole-caption length head (``nnaic_logits``, ``nnaic_length``).

PB_pad's phrase-based packed baseline: the compressed phrase embeddings
(``pb_compress``), the per-slot next-length predictor
(``pb_length_predict``) and the packed decode (``pb_decode``, norm modes
copy | compress | complex); its inference loop is ``decode/pb.py``.

Training: ``forward`` / ``decode_train``, the teacher-forced pass of every
train_mode, with the one-pass teacher-forced bounding (``bound_teacher``)
and glancing training (GLAT).  Dropout follows the layers' rule (``layers.dropout``): ``rng``, a
``torch.Generator`` on the model's device, or None for the deterministic
pass that every decode takes.  ``remat`` (the config's) rematerializes
the encoder's layers and every decoder stack's in the backward pass
(``layers.remat_call``), as the JAX package's ``nn.remat``; the length
predictor's layer, the embeddings, the norms and the heads keep their
activations, as there.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import obs
from ..constants import BOS, EOS, LEN, LENGTH_DIM, PAD, SYN_DIM
from ..data import phrase_ops as po
from .layers import (
    ACT,
    AttentionRouting,
    Decoder,
    DecoderLayer,
    Dense,
    Encoder,
    Generator,
    PositionalEncoding,
    RefLayerNorm,
    TokenEmbed,
    cast,
    causal_mask,
    dropout,
    prefix_mask,
    widen,
)

# decoder-stack role table: train_mode -> {role: stack_index}
DECODER_ROLES = {
    "AIC": {"A": 0},
    "auto": {"A": 0},
    "NNAIC": {"A": 0, "NA": 0},
    "NAIC": {"NA": 0},
    "SAIC": {"SA": 0},
    "UIC": {"SA": 0, "NA": 0},
    "UIC_ds": {"SA": 0, "NA": 1},
    "UIC_s": {"A": 0, "SA": 1, "NA": 2},
    "UIC_u": {"A": 0, "SA": 0, "NA": 0},
    "PB_pad": {"PB": 0},
}

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# PB_pad's packed-decode inputs: copied words, compressed phrase
# embeddings, or their sum
NORM_MODES = ("copy", "compress", "complex")

# train_modes whose flax tree holds no length/syntax predictor and no syn
# embedding: their training forward never calls them
NO_PREDICTOR = ("AIC", "auto", "NNAIC")


def decoder_roles(train_mode: str, role: Optional[str] = None):
    """DECODER_ROLES lookup with the mismatch named instead of a bare
    KeyError."""
    roles = DECODER_ROLES.get(train_mode)
    if roles is None:
        raise ValueError(f"unknown train_mode {train_mode!r} "
                         f"(known: {sorted(DECODER_ROLES)})")
    if role is None:
        return roles
    if role not in roles:
        raise ValueError(
            f"train_mode {train_mode!r} has no {role!r} decoder role "
            f"(has: {sorted(roles)}); pick an inference_mode this model "
            f"serves (A->AIC, SA->SAIC, NA->NAIC)")
    return roles[role]


class BoFiCap(AttentionRouting, nn.Module):
    def __init__(self, tgt_vocab: int, d_model: int = 512, d_ff: int = 2048,
                 N_enc: int = 6, N_dec: int = 6, N_len: int = 1,
                 num_heads: int = 8, att_feat_size: int = 2048,
                 max_boxes: int = 100, max_length: int = 20,
                 train_mode: str = "UIC", decoder_input_mode: str = "add",
                 dtype=torch.float32, device=None, dropout_rate: float = 0.1,
                 drop_prob_lm: float = 0.5, self_dis: bool = False,
                 norm_mode: str = "copy", remat: bool = False):
        super().__init__()
        if decoder_input_mode not in ("add", "single", "gate"):
            raise ValueError(f"decoder_input_mode {decoder_input_mode!r}")
        if norm_mode not in NORM_MODES:
            raise ValueError(f"norm_mode {norm_mode!r} (known: {NORM_MODES})")
        self.tgt_vocab = tgt_vocab
        self.d_model = d_model
        self.d_ff = d_ff
        self.N_enc, self.N_dec, self.N_len = N_enc, N_dec, N_len
        self.num_heads = num_heads
        self.att_feat_size = att_feat_size
        self.max_boxes = max_boxes
        self.max_length = max_length
        self.train_mode = train_mode
        self.decoder_input_mode = decoder_input_mode
        # PB_pad's packed-decode input (pb_decode)
        self.norm_mode = norm_mode
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.drop_prob_lm = drop_prob_lm
        # uic_loss's self-distillation term (the config's self_dis)
        self.self_dis = bool(self_dis)
        dd = dict(dtype=dtype, device=device)
        ddr = dict(dd, dropout_rate=dropout_rate)
        L2 = max_length + 2

        self.att_embed = Dense(att_feat_size, d_model, **dd)
        # the encoder's and the decoder stacks' layers are rematerialized
        # under remat; the length predictor's layers below are not (JAX
        # boficap.py:112-131)
        self.remat = bool(remat)
        self.encoder = Encoder(N_enc, d_model, d_ff, num_heads, **ddr,
                               remat=self.remat)
        n_stacks = max(decoder_roles(train_mode).values()) + 1
        self.n_stacks = n_stacks
        for i in range(n_stacks):
            self.add_module(f"decoder{i}",
                            Decoder(N_dec, d_model, d_ff, num_heads, **ddr,
                                    remat=self.remat))
        # length/syntax predictor (reference LengthPredictor_UIC :333-383)
        self.n_lp = 0 if train_mode in NO_PREDICTOR else max(N_len, 1)
        # (the parameters are created in this order, which fixes the order
        # init_params draws them in)
        self.word_embed = TokenEmbed(tgt_vocab, d_model, **dd)
        # PB_pad's predictor reads words (its own table), not syn ids, and
        # has no syntax head: its flax tree holds neither
        pb = train_mode == "PB_pad"
        if self.n_lp and not pb:
            self.syn_embed = TokenEmbed(SYN_DIM, d_model, **dd)
        self.posenc = PositionalEncoding(d_model, max(5000, L2), device,
                                         dropout_rate)
        self.generator = Generator(d_model, tgt_vocab, **dd)

        for i in range(self.n_lp):
            self.add_module(f"lp{i}",
                            DecoderLayer(d_model, d_ff, num_heads, **ddr))
        if self.n_lp and N_len == 0 and not pb:
            # one cross-attention sublayer (DecoderLayer.cross_only); the
            # flax tree holds no parameters for the parts it never calls
            for name in ("self_attn", "ffn", "sub1", "sub2"):
                delattr(self.lp0, name)
        if self.n_lp:
            self.lp_norm = RefLayerNorm(d_model, **dd)
            self.len_head1 = Dense(d_model, 100, **dd)
            self.len_head2 = Dense(100, LENGTH_DIM, **dd)
        if self.n_lp and not pb:
            self.syn_head1 = Dense(d_model, 100, **dd)
            self.syn_head2 = Dense(100, SYN_DIM, **dd)

        if pb:
            self.lp_word_embed = TokenEmbed(tgt_vocab, d_model, **dd)
        if train_mode == "NNAIC":
            self.nn_len_l1 = Dense(d_model, max_length, **dd)
            self.nn_len_l2 = Dense(max_boxes * max_length, max_length, **dd)
        if decoder_input_mode == "gate":
            self.sa_gate = Dense(2 * d_model, d_model, **dd)
            self.na_gate = Dense(2 * d_model, d_model, **dd)
        self._packed: Dict[tuple, object] = {}

    # --------------------------------------------------- packed kernel weights
    # Packed once per model and cached: every loader clears the cache
    # (load_state_dict, .to()/.cuda()); code that writes parameters in place
    # calls invalidate_packed(), as the training step does after each
    # optimizer update (train/steps.py).
    def invalidate_packed(self):
        self._packed.clear()

    def _apply(self, fn, *args, **kwargs):
        self.invalidate_packed()
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self.invalidate_packed()
        return super().load_state_dict(*args, **kwargs)

    def lp_layers(self):
        return [getattr(self, f"lp{i}") for i in range(self.n_lp)]

    def packed_encoder(self):
        """The encoder's weights for the kernels (``ops.stack.StackPack``)."""
        from ..ops.stack import pack_encoder_stack
        key = ("enc",)
        if key not in self._packed:
            with torch.no_grad():
                self._packed[key] = pack_encoder_stack(self.encoder,
                                                       self.dtype)
        return self._packed[key]

    def packed_decoder(self, role: str):
        """``role``'s decoder stack's weights for the kernels
        (``ops.stack.StackPack``)."""
        from ..ops.stack import pack_decoder_stack
        key = ("dec", role)
        if key not in self._packed:
            with torch.no_grad():
                self._packed[key] = pack_decoder_stack(self._decoder(role),
                                                       self.dtype)
        return self._packed[key]

    def packed_window(self, role: str):
        """The windowed SA fill's weights of ``role``'s decoder stack
        (``ops.stack.WindowPack``)."""
        from ..ops.stack import pack_window_weights
        key = ("win", role)
        if key not in self._packed:
            with torch.no_grad():
                self._packed[key] = pack_window_weights(self._decoder(role),
                                                        self.dtype)
        return self._packed[key]

    def packed_head(self):
        """The generator's weights as the head kernel takes them
        (``ops.decoder_layer.HeadPack``: W and b padded, and V)."""
        from ..ops.decoder_layer import pack_head_weights
        key = ("head",)
        if key not in self._packed:
            with torch.no_grad():
                self._packed[key] = pack_head_weights(self.generator.proj,
                                                      self.dtype)
        return self._packed[key]

    # ------------------------------------------------------------ primitives
    def embed_att(self, att_feats, rng=None):
        """2048-d region features -> d_model (reference att_embed,
        TransformerModel.py:1642-1647: Linear + ReLU +
        Dropout(drop_prob_lm))."""
        x = torch.relu(self.att_embed(cast(att_feats, self.dtype, ACT)))
        return dropout(x, self.drop_prob_lm, rng)

    def encode(self, att_feats, att_masks=None, rng=None):
        """Region features + padding mask -> encoder memory [B, R, d]."""
        x = self.embed_att(att_feats, rng)
        src_mask = None if att_masks is None else att_masks.bool()
        return self.encoder(x, src_mask, rng)

    def _decoder(self, role: str) -> Decoder:
        return getattr(self, f"decoder{decoder_roles(self.train_mode, role)}")

    def _lp_heads(self, h, rng=None):
        """[..., d] -> (length logprob [..., 20], syn logprob [..., 10])."""
        r = self.dropout_rate
        lh = dropout(torch.relu(self.len_head1(h)), r, rng)
        len_lp = torch.log_softmax(widen(self.len_head2(lh)), dim=-1)
        sh = dropout(torch.relu(self.syn_head1(h)), r, rng)
        syn_lp = torch.log_softmax(widen(self.syn_head2(sh)), dim=-1)
        return len_lp, syn_lp

    def _lp_embed(self, ids, use_syn: bool, rng=None):
        emb = self.syn_embed(ids) if use_syn else self.word_embed(ids)
        return self.posenc(emb, rng=rng)

    # -------------------------------------------------- teacher-forced bound
    def bound_teacher(self, ids, phrase_length, memory, src_mask,
                      use_syn: bool, rng=None):
        """Teacher-forced bounding, every step in one pass.  ids [B, L2]:
        the predictor input (the word row with [LEN] at 0 for the SA
        branch, ``extend_syn_seq`` for the NA branch).  Returns (len, syn)
        log-probs [B, S, .], S = L + 1: slot k is the prediction after
        phrases 1..k (the reference's ``predict_*_logprob[:, 1:, :]``)."""
        L2 = ids.shape[-1]
        S = self.max_length + 1
        y = self._lp_embed(ids, use_syn, rng)                     # [B, L2, d]
        B, _, d = y.shape
        if self.N_len == 1:
            # only the [LEN] row reaches the heads and its query is the
            # same at every step: the steps become stacked query rows
            prefixes = po.bound_prefixes(phrase_length, S)        # [B, S]
            q = y[:, 0:1, :].expand(B, S, d)
            mask = prefix_mask(prefixes, L2)                      # [B, S, L2]
            h = self.lp_norm(self.lp0(q, memory, src_mask, mask, kv=y,
                                      rng=rng))
        elif self.N_len == 0:
            # one cross-attention sublayer, blind to the bound mask: every
            # step gives the same [LEN] row
            h0 = self.lp_norm(self.lp0.cross_only(y, memory, src_mask,
                                                  rng))[:, 0:1, :]
            h = h0.expand(B, S, d)
        else:
            # the S step masks stacked as a batch dimension
            masks = po.bound_step_masks(phrase_length, S, L2)     # [B,S,L2,L2]
            R = memory.shape[1]
            x = y[:, None].expand(B, S, L2, d).reshape(B * S, L2, d)
            ms = masks.reshape(B * S, L2, L2)
            mem = memory[:, None].expand(B, S, R, d).reshape(B * S, R, d)
            sm = None if src_mask is None else src_mask[:, None].expand(
                B, S, R).reshape(B * S, R)
            for layer in self.lp_layers():
                x = layer(x, mem, sm, ms, rng=rng)
            h = self.lp_norm(x)[:, 0, :].reshape(B, S, -1)
        return self._lp_heads(h, rng)

    # -------------------------------------------------------------- bounding
    def bound_cache(self, memory, use_syn: bool = True):
        """Loop-invariant tensors of the inference bounding step (N_len ==
        1): cross-attention K/V of the memory, the SYN_DIM x L2 table of
        self-attention K/V rows (they depend only on token id and
        position), and the constant [LEN] query row."""
        layer = self.lp0
        kc, vc = layer.src_attn.project_kv(memory)
        L2 = self.max_length + 2
        pe = self.posenc.pe[:L2].to(self.dtype)
        cache = {"kc": kc, "vc": vc}
        emb_mod = self.syn_embed if use_syn else self.word_embed
        dev = memory.device
        if use_syn:
            y = emb_mod(torch.arange(SYN_DIM, device=dev))        # [Vs, d]
            y_vp = y[:, None, :] + pe[None, :, :]                 # [Vs, L2, d]
            n = layer.sub0.norm_only(y_vp)
            cache["kt"] = layer.self_attn.wk(n)
            cache["vt"] = layer.self_attn.wv(n)
        x0 = emb_mod(torch.full((1, 1), LEN, device=dev))[0, 0] + pe[0]
        n0 = layer.sub0.norm_only(x0[None, None, :])
        cache["qh"] = layer.self_attn.project_q(n0)               # [1,1,H,Dh]
        cache["x0"] = x0
        return cache

    def bound_step_cached(self, cache, ids, prefix, src_mask,
                          use_syn: bool = True):
        """``bound_step`` with the loop-invariant work taken from
        ``cache`` (see ``bound_cache``); the same math."""
        layer = self.lp0
        B, L2 = ids.shape
        if "kt" in cache:
            pos = torch.arange(L2, device=ids.device)[None, :]
            kh = layer.self_attn._heads(cache["kt"][ids, pos])
            vh = layer.self_attn._heads(cache["vt"][ids, pos])
        else:
            y = self._lp_embed(ids, use_syn)
            n = layer.sub0.norm_only(y)
            kh, vh = layer.self_attn.project_kv(n)
        qh = cache["qh"].expand((B,) + tuple(cache["qh"].shape[1:]))
        mask = prefix_mask(prefix, L2)[:, None, :]                 # [B, 1, L2]
        att = layer.self_attn.attend(qh, kh, vh, mask)
        x = cache["x0"][None, None, :] + att
        n1 = layer.sub1.norm_only(x)
        q1 = layer.src_attn.project_q(n1)
        att1 = layer.src_attn.attend(q1, cache["kc"], cache["vc"], src_mask)
        x = x + att1
        x = layer.sub2(x, layer.ffn)
        h = self.lp_norm(x)[:, 0, :]
        return self._lp_heads(h)

    def bound_step(self, ids, prefix, memory, src_mask, use_syn: bool):
        """One inference bounding step: ids [B, L2] predictor input, prefix
        [B] visible prefix of the [LEN] query -> ([B,20], [B,10])
        log-probs."""
        L2 = ids.shape[-1]
        y = self._lp_embed(ids, use_syn)
        if self.N_len == 1:
            q = y[:, 0:1, :]
            mask = prefix_mask(prefix, L2)[:, None, :]
            h = self.lp0(q, memory, src_mask, mask, kv=y)
            h = self.lp_norm(h)[:, 0, :]
        elif self.N_len == 0:
            h1 = self.lp0.cross_only(y, memory, src_mask)
            h = self.lp_norm(h1)[:, 0, :]
        else:
            # rows < prefix see keys < prefix, rows beyond it see key 0
            L2a = torch.arange(L2, device=ids.device)
            rowvis = torch.where(L2a[None, :] < prefix[:, None],
                                 prefix[:, None], torch.ones_like(L2a)[None])
            rowvis[:, 0] = prefix
            mask = L2a[None, None, :] < rowvis[:, :, None]
            x = y
            for layer in self.lp_layers():
                x = layer(x, memory, src_mask, mask)
            h = self.lp_norm(x)[:, 0, :]
        return self._lp_heads(h)

    # --------------------------------------------------------------- filling
    def _mix_embed(self, word_seq, syn_seq, gate: str):
        """decoder_input_mode add | single | gate word/syn embedding mix,
        without positions (reference :520-530, :570-587)."""
        w = self.word_embed(word_seq)
        s = self.syn_embed(syn_seq)
        if self.decoder_input_mode == "add":
            return w + s
        if self.decoder_input_mode == "single":
            return w if gate == "sa" else s
        g = torch.sigmoid((self.sa_gate if gate == "sa" else self.na_gate)(
            torch.cat([w, s], dim=-1)))
        return g * w + (1 - g) * s

    def _mix_inputs(self, word_seq, syn_seq, gate: str, rng=None):
        return self.posenc(self._mix_embed(word_seq, syn_seq, gate), rng=rng)

    def mix_inputs_window(self, word_seq, syn_seq, pos, gate: str):
        """``_mix_inputs`` for a window of decoder slots: embeds only the
        [B, W] window's tokens and adds the positional rows of their
        absolute positions ``pos`` [B, W].  The JAX package selects those
        rows with a one-hot product (a TPU gather workaround); indexing
        ``pe`` gives the same values exactly."""
        x = self._mix_embed(word_seq, syn_seq, gate)
        return x + self.posenc.pe[pos].to(x.dtype)

    def decode_sa(self, word_seq, syn_seq, memory, src_mask, tgt_mask,
                  rng=None, grouped: bool = False):
        """SA fill: copied-word + syn input, blockwise mask. [B, L] ->
        [B, L, d].  ``grouped``: the caption rows are image-major over a
        memory of one row per image (``layers.DecoderLayer._cross``)."""
        return self._decoder("SA")(
            self._mix_inputs(word_seq, syn_seq, "sa", rng), memory, src_mask,
            tgt_mask, rng, grouped)

    def na_inputs(self, syn_seq, rng=None, glat_input=None):
        """Embedded NA fill inputs: BOS words (or the glanced words) + the
        planned syn ids."""
        word_seq = (torch.full_like(syn_seq, BOS) if glat_input is None
                    else glat_input)
        return self._mix_inputs(word_seq, syn_seq, "na", rng)

    def decode_na(self, syn_seq, memory, src_mask, tgt_mask, rng=None,
                  glat_input=None, grouped: bool = False):
        """NA fill: bos (or glanced) word + syn input. [B, L] -> [B, L, d]."""
        return self._decoder("NA")(self.na_inputs(syn_seq, rng, glat_input),
                                   memory, src_mask, tgt_mask, rng, grouped)

    def decode_a(self, word_seq, memory, src_mask, tgt_mask, syn_seq=None,
                 rng=None, grouped: bool = False):
        """AR decode, teacher-forced over the whole frame; UIC_s/u variants
        add syn embeddings (reference :832-834).  [B, L] -> [B, L, d]."""
        x = self.word_embed(word_seq)
        if syn_seq is not None:
            x = x + self.syn_embed(syn_seq)
        return self._decoder("A")(self.posenc(x, rng=rng), memory, src_mask,
                                  tgt_mask, rng, grouped)

    def init_ar_cache(self, memory, max_len: int):
        """KV cache of the AR decoder: per layer, the cross-attention K/V
        projected once and zeroed self-attention K/V [B, max_len, H, Dh]."""
        return self._decoder("A").init_cache(memory, max_len)

    def ar_step(self, it, pos: int, cache, src_mask, syn_t=None):
        """One KV-cached AR step: token ids ``it`` [B] at position ``pos``
        -> (logprob [B, V] float32, cache).  The cache's self-attention
        K/V are written in place at ``pos``."""
        with obs.span("bfc.ar.layers"):
            x = self.word_embed(it[:, None])
            if syn_t is not None:
                x = x + self.syn_embed(syn_t[:, None])
            x = self.posenc(x, offset=pos)
            h, cache = self._decoder("A").step(x, cache, pos, src_mask)
        return self.generate(h)[:, 0], cache

    @staticmethod
    def gather_ar_cache(cache, flat_ix):
        """The AR cache's rows reordered by ``flat_ix`` (a beam search's
        parents, [B*K]): the self-attention K/V.  The cross-attention K/V
        are left as they are: the K rows of an image hold the same memory,
        so their K/V are equal and the reorder would not change them."""
        return [{**c, "ks": c["ks"][flat_ix], "vs": c["vs"][flat_ix]}
                for c in cache]

    @staticmethod
    def copy_ar_cache(cache):
        """Another AR cache over the same memory, for a beam group: zeroed
        self-attention K/V of its own; the cross-attention K/V, never
        written, are shared."""
        return [{**c, "ks": torch.zeros_like(c["ks"]),
                 "vs": torch.zeros_like(c["vs"])} for c in cache]

    def nnaic_logits(self, memory, rng=None):
        """NNAIC's whole-caption length logits [B, max_length], float32:
        the memory zero-padded to ``max_boxes`` regions, ``relu(nn_len_l1)``
        with dropout from ``rng``, flattened, then ``nn_len_l2``."""
        B, R, d = memory.shape
        if R > self.max_boxes:
            # more regions than the head was built for would change
            # nn_len_l2's flattened input width (reference asserts, :1240)
            raise ValueError(
                f"nnaic_length: {R} regions > max_boxes={self.max_boxes} "
                f"(the length head is built at max_boxes*max_length); raise "
                f"max_boxes in the config to cover the feature store")
        if R < self.max_boxes:
            memory = torch.cat([memory, memory.new_zeros(
                (B, self.max_boxes - R, d))], dim=1)
        x = dropout(torch.relu(self.nn_len_l1(memory)), self.dropout_rate,
                    rng)
        return widen(self.nn_len_l2(x.reshape(B, -1)))

    def nnaic_length(self, memory, rng=None):
        """NNAIC's whole-caption length [B] (int64): softmax of
        ``nnaic_logits`` in float32, argmax (the first index on a tie).  The
        reference argmaxes ``.data`` (LengthPredictor_NNAIC,
        TransformerModel.py:1234-1250), so the head gets no gradient; it
        runs under ``no_grad`` here."""
        with torch.no_grad():
            return torch.argmax(torch.softmax(self.nnaic_logits(memory, rng),
                                              dim=-1), dim=-1)

    # ---------------------------------------------------------------- PB_pad
    def pb_compress(self, labels, phrase_length, predictor: bool = False):
        """Per-slot compressed phrase embeddings [B, L2, d]: the sum of the
        word embeddings inside each phrase (reference CompressEmbedding,
        TransformerModel.py:994-1013), as the JAX package's one-hot segment
        sum; slot 0 is the bos phrase, slots past phrase_num are zero.
        ``predictor`` reads the length predictor's private table
        ``lp_word_embed`` (reference :1085), else ``word_embed`` (:1168)."""
        L2 = labels.shape[1]
        table = self.lp_word_embed if predictor else self.word_embed
        emb = table(labels)                                   # [B, L2, d]
        ends = po.phrase_word_ends(phrase_length)             # [B, L2-1]
        pos = torch.arange(L2, device=labels.device)[None, :]
        # label position 0 -> slot 0; position p >= 1 -> 1 + the real slot
        # of p - 1
        k = ((pos[:, 1:, None] - 1) >= ends[:, None, :]).sum(-1)
        slot = torch.cat([torch.zeros_like(k[:, :1]), 1 + k], dim=1)
        total = po.total_words(phrase_length)
        valid = (pos == 0) | (pos <= total[:, None])
        onehot = (torch.nn.functional.one_hot(
            torch.where(valid, slot, L2 - 1), L2).to(emb.dtype)
            * valid[..., None].to(emb.dtype))
        return torch.einsum("bld,blk->bkd", emb, onehot)

    def pb_length_predict(self, labels, phrase_num, phrase_length, memory,
                          src_mask, rng=None):
        """Per-slot next-phrase length log-probs [B, L2, 20], float32
        (reference LengthPredictorPB_pad, TransformerModel.py:1032-1090):
        the compressed phrase embeddings with positions through the
        predictor layers under a causal slot mask, keys past phrase_num
        masked; slot j (having seen phrases 0..j) predicts phrase j+1's
        length."""
        L2 = labels.shape[1]
        x = self.posenc(self.pb_compress(labels, phrase_length,
                                         predictor=True), rng=rng)
        slot = torch.arange(L2, device=labels.device)
        pad_ok = slot[None, :] < phrase_num[:, None]
        mask = pad_ok[:, None, :] & (slot[None, None, :]
                                     <= slot[None, :, None])
        for layer in self.lp_layers():
            x = layer(x, memory, src_mask, mask, rng=rng)
        h = self.lp_norm(x)
        lh = dropout(torch.relu(self.len_head1(h)), self.dropout_rate, rng)
        return torch.log_softmax(widen(self.len_head2(lh)), dim=-1)

    def pb_decode(self, packed_ids, packed_slot, labels, phrase_length,
                  memory, src_mask, packed_mask, rng=None,
                  norm_mode: Optional[str] = None,
                  return_hidden: bool = False, grouped: bool = False):
        """Packed phrase-parallel decode (reference EncoderDecoderPB_pad
        .decode, TransformerModel.py:1138-1213).  ``packed_ids``: the
        copy-init word of each packed position; ``packed_slot``: its phrase
        slot (norm modes compress and complex); ``packed_mask`` [B, Lp,
        Lp]: key padding and the phrase-blockwise causal mask.  Returns
        log-probs [B, Lp, V], or the decoder's hidden states [B, Lp, D]
        with ``return_hidden`` (the decode loop applies the vocabulary head
        to the new column's window only, decode/pb.py).  ``grouped``: the
        caption rows are image-major over a memory of one row per image
        (``layers.DecoderLayer._cross``)."""
        norm_mode = norm_mode or self.norm_mode
        if norm_mode == "copy":
            x = self.word_embed(packed_ids)
        else:
            comp = self.pb_compress(labels, phrase_length)
            idx = packed_slot.long()[..., None].expand(
                -1, -1, comp.shape[-1])
            x = torch.gather(comp, 1, idx)
            if norm_mode == "complex":
                x = x + self.word_embed(packed_ids)
        h = self._decoder("PB")(self.posenc(x, rng=rng), memory, src_mask,
                                packed_mask, rng, grouped)
        return h if return_hidden else self.generate(h)

    def generate(self, h):
        return self.generator(h)

    def generate_logits(self, h):
        return self.generator.logits(h)

    # ----------------------------------------------------------- train paths
    def forward(self, att_feats, att_masks, labels, phrase_num=None,
                phrase_length=None, phrase_syn=None, glat_p=None, rng=None
                ) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward of the train_mode (the JAX package's
        ``__call__``): log-probability tensors named as the reference's
        ``_forward`` outputs (TransformerModel.py:1713-1789).  ``labels``
        is the bos-framed [B, L2] row; the phrase tensors follow
        ``phrase_ops``.  ``rng`` None is the deterministic pass."""
        memory = self.encode(att_feats, att_masks, rng)
        src_mask = None if att_masks is None else att_masks.bool()
        return self.decode_train(memory, src_mask, labels, phrase_num,
                                 phrase_length, phrase_syn, glat_p, rng)

    def decode_train(self, memory, src_mask, labels, phrase_num=None,
                     phrase_length=None, phrase_syn=None, glat_p=None,
                     rng=None) -> Dict[str, torch.Tensor]:
        """Teacher-forced decode from the encoder memory.  ``labels`` may
        have k times the memory's rows (the collate's seq_per_img caption
        rows, image-major): the word decoders then fold them over one
        image's keys (``grouped``), the predictors take the memory
        repeated.  ``glat_p`` None or < 0 turns glancing off; GLAT draws
        its reveal from ``rng``."""
        L = self.max_length
        mem_dec, srcm_dec = memory, src_mask
        if labels.shape[0] != memory.shape[0]:
            k = labels.shape[0] // memory.shape[0]
            memory = memory.repeat_interleave(k, dim=0)
            if src_mask is not None:
                src_mask = src_mask.repeat_interleave(k, dim=0)
        dec = dict(rng=rng, grouped=True)
        mode = self.train_mode
        out: Dict[str, torch.Tensor] = {}

        if mode in ("AIC", "auto"):
            seq = labels[:, :-1]
            tgt = (seq != EOS) & (seq != PAD)
            tgt[:, 0] = True
            tgt_mask = tgt[:, None, :] & causal_mask(seq.shape[1],
                                                     seq.device)[None]
            h = self.decode_a(seq, mem_dec, srcm_dec, tgt_mask, **dec)
            out["logprob"] = self.generate(h)
            return out
        if mode == "NNAIC":
            # naive NA: every kept input is BOS, the keys are the non-EOS,
            # non-PAD positions (reference _forward NNAIC branch,
            # TransformerModel.py:1737-1748)
            seq = labels[:, :-1]
            keep = (seq != EOS) & (seq != PAD)
            keep[:, 0] = True
            new_seq = torch.where(keep, BOS, PAD)
            h = self.decode_a(new_seq, mem_dec, srcm_dec, keep[:, None, :],
                              **dec)
            out["logprob"] = self.generate(h)
            out["length_pred"] = self.nnaic_length(memory, rng)
            return out
        if mode == "PB_pad":
            # the packed layouts depend on the batch and are built on the
            # host (data/pb_pack.py; the XE step feeds them, train/steps.py):
            # this pass runs every PB module on a stand-in layout, as the
            # JAX package's does
            B = labels.shape[0]
            out["pb_len_logprob"] = self.pb_length_predict(
                labels, phrase_num, phrase_length, memory, src_mask, rng)
            ids = labels[:, 1:-1]
            out["pb_logprob"] = self.pb_decode(
                ids, torch.zeros_like(ids), labels, phrase_length, mem_dec,
                srcm_dec, torch.ones((B, L, L), dtype=torch.bool,
                                     device=labels.device), **dec)
            return out

        extend_syn = po.extend_syn_seq(phrase_length, phrase_syn, L)
        word_syn = extend_syn[:, 1:-1]                            # [B, L]
        sa_mask = po.blockwise_mask(phrase_length, L)             # [B, L, L]
        total = po.total_words(phrase_length)
        ar = torch.arange(L, device=labels.device)
        na_mask = (ar[None, None, :] < total[:, None, None]).expand(
            labels.shape[0], L, L)

        if mode in ("SAIC", "UIC", "UIC_ds"):
            lp_words = labels.clone()
            lp_words[:, 0] = LEN
            out["sa_len_logprob"], out["sa_syn_logprob"] = self.bound_teacher(
                lp_words, phrase_length, memory, src_mask, False, rng)
            copied = po.copy_init(labels, phrase_length, L)
            h_sa = self.decode_sa(copied, word_syn, mem_dec, srcm_dec,
                                  sa_mask, **dec)
            out["sa_logprob"] = self.generate(h_sa)
            if mode == "SAIC":
                return out

        if mode in ("NAIC", "UIC", "UIC_ds"):
            out["na_len_logprob"], out["na_syn_logprob"] = self.bound_teacher(
                extend_syn, phrase_length, memory, src_mask, True, rng)
            glanced = None
            if glat_p is not None and glat_p >= 0:
                glanced, out["glat_mismatch"] = self._glance(
                    word_syn, mem_dec, srcm_dec, na_mask, labels,
                    phrase_length, total, glat_p, rng)
            h_na = self.decode_na(word_syn, mem_dec, srcm_dec, na_mask,
                                  glat_input=glanced, **dec)
            out["na_logprob"] = self.generate(h_na)
            return out

        if mode in ("UIC_s", "UIC_u"):
            # one syn-input predictor + AR/SA/NA decodes (reference :772-788)
            out["len_logprob"], out["syn_logprob"] = self.bound_teacher(
                extend_syn, phrase_length, memory, src_mask, True, rng)
            seq = labels[:, :-1]
            keep = (seq != EOS) & (seq != PAD)
            keep[:, 0] = True
            a_mask = (keep[:, None, :] & causal_mask(seq.shape[1],
                                                     seq.device)[None]
                      )[:, 1:, 1:]
            h_a = self.decode_a(labels[:, :-2], mem_dec, srcm_dec, a_mask,
                                syn_seq=word_syn, **dec)
            copied = po.copy_init(labels, phrase_length, L)
            h_sa = self.decode_sa(copied, word_syn, mem_dec, srcm_dec,
                                  sa_mask, **dec)
            h_na = self.decode_na(word_syn, mem_dec, srcm_dec, na_mask, **dec)
            out["a_logits"] = self.generate_logits(h_a)
            out["a_logprob"] = torch.log_softmax(out["a_logits"], dim=-1)
            out["sa_logits"] = self.generate_logits(h_sa)
            out["sa_logprob"] = torch.log_softmax(out["sa_logits"], dim=-1)
            out["na_logprob"] = self.generate(h_na)
            return out
        raise NotImplementedError(mode)

    def _glance(self, word_syn, memory, src_mask, na_mask, labels,
                phrase_length, total, glat_p: float, rng):
        """Glancing training (reference :437-464): a no-grad NA pass, then
        each gt word revealed with probability mismatch_rate * glat_p, the
        coins drawn from ``rng``.  Returns (glanced words [B, L], the mean
        mismatch rate)."""
        if rng is None:
            raise ValueError("GLAT draws its reveal from rng; pass the "
                             "training generator")
        L = self.max_length
        with torch.no_grad():
            h0 = self.decode_na(word_syn, memory, src_mask, na_mask, rng=rng,
                                grouped=True)
            pred = torch.argmax(self.generate(h0), dim=-1)
        real = labels[:, 1:-1]
        wmask = po.word_loss_mask(phrase_length, L)
        tokens_len = total.float().clamp_min(1.0)
        same = ((pred == real) & wmask).sum(-1)
        mismatch = (total - same) / tokens_len
        keep_prob = (mismatch * glat_p)[:, None] * wmask
        u = torch.rand(real.shape, generator=rng, device=real.device)
        glanced = torch.where(u < keep_prob, real, BOS)
        return glanced, mismatch.mean()


def build_model(cfg, vocab_size: int, device=None) -> BoFiCap:
    """BoFiCap from a config (reference models.setup), parameters zeroed:
    fill them with ``convert.init_params`` or a loader.  ``use_pallas``
    routes the eligible attentions through the attention-core kernel
    (``BoFiCap.set_attention_core``); ``remat`` recomputes the encoder's
    and the decoder stacks' layers in the backward pass."""
    from ..device import resolve_device
    model = BoFiCap(
        tgt_vocab=vocab_size + 4,
        d_model=cfg.d_model,
        d_ff=cfg.d_ff,
        N_enc=cfg.N_enc,
        N_dec=cfg.N_dec,
        N_len=cfg.get("N_len", 0),
        num_heads=cfg.get("num_att_heads", 8),
        att_feat_size=cfg.att_feat_size,
        max_boxes=cfg.get("max_boxes", 100) or 100,
        max_length=cfg.get("max_length", 20) or 20,
        train_mode=cfg.get("train_mode", "AIC"),
        decoder_input_mode=cfg.get("decoder_input_mode", "add"),
        dtype=DTYPES[cfg.get("dtype", "bfloat16")],
        device=resolve_device(device),
        dropout_rate=cfg.get("dropout", 0.1),
        drop_prob_lm=cfg.get("drop_prob_lm", 0.5),
        self_dis=bool(cfg.get("self_dis", False)),
        norm_mode=cfg.get("norm_mode", "copy") or "copy",
        remat=bool(cfg.get("remat", 0)),
    )
    model.set_attention_core(bool(cfg.get("use_pallas", False)))
    return model
