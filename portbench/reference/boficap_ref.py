"""Plain float32 reference of the two BoFiCap captioners the benchmark runs:
UIC (the bound-then-fill model: a length/syntax predictor that plans the
phrases, one NA decoder pass that fills the words) and AIC (the paper's
autoregressive Transformer baseline).

It follows the published model (BoFiCap, captioning/models/
TransformerModel.py): annotated-transformer layers with pre-norm residuals,
the reference's LayerNorm (unbiased std, eps added to the std), sinusoid
positions, embeddings scaled by sqrt(d_model), masked scores filled with
-1e9, a log-softmax generator.  Every product is float32 with TF32 off.
It imports torch alone: nothing of the program, nothing of JAX.

Weights are a dict of float32 tensors under the names ``param_shapes``
gives; the benchmark makes them from the seed and hands the same tensors to
the program.  ``quant='fp8'`` computes every dense product on operands
rounded to float8 e4m3 (a scale per row of the activations and per output
channel of the weights): the control that the output comparison has to
fail.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

PAD, BOS, EOS, LEN = 0, 1, 2, 3
SYN_LOWER, SYN_UPPER = 4, 6
LENGTH_DIM, SYN_DIM = 20, 10
MASK_FILL = -1e9
NORM_EPS = 1e-6
FP8_MAX = 448.0


def _attn_names(prefix: str, d: int) -> List[Tuple[str, tuple]]:
    out = []
    for w in ("wq", "wk", "wv", "wo"):
        out += [(f"{prefix}.{w}.weight", (d, d)), (f"{prefix}.{w}.bias", (d,))]
    return out


def _norm_names(prefix: str, d: int) -> List[Tuple[str, tuple]]:
    return [(f"{prefix}.scale", (d,)), (f"{prefix}.bias", (d,))]


def _ffn_names(prefix: str, d: int, dff: int) -> List[Tuple[str, tuple]]:
    return [(f"{prefix}.Dense_0.weight", (dff, d)),
            (f"{prefix}.Dense_0.bias", (dff,)),
            (f"{prefix}.Dense_1.weight", (d, dff)),
            (f"{prefix}.Dense_1.bias", (d,))]


def _dec_layer_names(prefix: str, d: int, dff: int):
    out = _attn_names(f"{prefix}.self_attn", d)
    out += _attn_names(f"{prefix}.src_attn", d)
    out += _ffn_names(f"{prefix}.ffn", d, dff)
    for s in ("sub0", "sub1", "sub2"):
        out += _norm_names(f"{prefix}.{s}.norm", d)
    return out


def param_shapes(cfg: dict) -> List[Tuple[str, tuple]]:
    """Every parameter of the configured model, (name, shape), in a fixed
    order.  ``cfg``: the benchmark's configuration (train_mode UIC or AIC,
    N_len 1)."""
    d, dff = cfg["d_model"], cfg["d_ff"]
    V = cfg["vocab_size"] + 4
    mode = cfg["train_mode"]
    if mode not in ("UIC", "AIC") or (mode == "UIC" and cfg["N_len"] != 1):
        raise ValueError(f"reference covers UIC with N_len 1 and AIC, not "
                         f"{mode} N_len {cfg.get('N_len')}")
    out = [("att_embed.weight", (d, cfg["att_feat_size"])),
           ("att_embed.bias", (d,))]
    for i in range(cfg["N_enc"]):
        p = f"encoder.layer{i}"
        out += _attn_names(f"{p}.self_attn", d)
        out += _ffn_names(f"{p}.ffn", d, dff)
        out += _norm_names(f"{p}.sub0.norm", d) + _norm_names(
            f"{p}.sub1.norm", d)
    out += _norm_names("encoder.RefLayerNorm_0", d)
    for i in range(cfg["N_dec"]):
        out += _dec_layer_names(f"decoder0.layer{i}", d, dff)
    out += _norm_names("decoder0.norm", d)
    out += [("word_embed.Embed_0.weight", (V, d))]
    if mode == "UIC":
        out += [("syn_embed.Embed_0.weight", (SYN_DIM, d))]
    out += [("generator.proj.weight", (V, d)), ("generator.proj.bias", (V,))]
    if mode == "UIC":
        out += _dec_layer_names("lp0", d, dff)
        out += _norm_names("lp_norm", d)
        out += [("len_head1.weight", (100, d)), ("len_head1.bias", (100,)),
                ("len_head2.weight", (LENGTH_DIM, 100)),
                ("len_head2.bias", (LENGTH_DIM,)),
                ("syn_head1.weight", (100, d)), ("syn_head1.bias", (100,)),
                ("syn_head2.weight", (SYN_DIM, 100)),
                ("syn_head2.bias", (SYN_DIM,))]
    return out


def param_law(name: str) -> str:
    """The initialisers' law of a parameter: 'one' for norm scales, 'zero'
    for biases, 'xavier' (uniform) for matrices and tables."""
    leaf = name.rsplit(".", 1)[-1]
    return {"scale": "one", "bias": "zero"}.get(leaf, "xavier")


def sinusoid(L: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(L, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros((L, d), dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.float()


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (amax / 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Reference:
    """The model of ``cfg`` over ``weights``, in float32 (or with float8
    dense products under ``quant='fp8'``)."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg: dict,
                 quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant {quant!r}")
        self.w = weights
        self.cfg = cfg
        self.quant = quant
        self.d = cfg["d_model"]
        self.H = cfg["num_att_heads"]
        self.L = cfg["max_length"]

    # ------------------------------------------------------------ pieces
    def dense(self, x, name: str):
        w = self.w[f"{name}.weight"].float()
        b = self.w.get(f"{name}.bias")
        if self.quant == "fp8":
            # rounded in the forward; the gradient passes as it is
            x = x + (fp8_round(x, -1) - x).detach()
            w = w + (fp8_round(w, -1) - w).detach()
        y = x @ w.t()
        return y if b is None else y + b.float()

    def norm(self, x, name: str):
        mean = x.mean(-1, keepdim=True)
        std = x.std(-1, keepdim=True, unbiased=True)
        return (self.w[f"{name}.scale"] * (x - mean) / (std + NORM_EPS)
                + self.w[f"{name}.bias"])

    def mha(self, xq, xkv, mask, name: str):
        """xq [B, Lq, d], xkv [B, Lk, d], bool mask broadcastable to
        [B, Lq, Lk] (True = attend)."""
        B, Lq, d = xq.shape
        Lk = xkv.shape[1]
        H, Dh = self.H, d // self.H
        q = self.dense(xq, f"{name}.wq").reshape(B, Lq, H, Dh).transpose(1, 2)
        k = self.dense(xkv, f"{name}.wk").reshape(B, Lk, H, Dh).transpose(1, 2)
        v = self.dense(xkv, f"{name}.wv").reshape(B, Lk, H, Dh).transpose(1, 2)
        s = (q @ k.transpose(-1, -2)) / math.sqrt(Dh)
        s = s.masked_fill(~mask[:, None], MASK_FILL)
        o = torch.softmax(s, dim=-1) @ v
        return self.dense(o.transpose(1, 2).reshape(B, Lq, d), f"{name}.wo")

    def ffn(self, x, name: str):
        return self.dense(torch.relu(self.dense(x, f"{name}.Dense_0")),
                          f"{name}.Dense_1")

    def embed(self, ids, table: str):
        return self.w[f"{table}.Embed_0.weight"][ids] * math.sqrt(self.d)

    def dec_layer(self, x, mem, src_mask, tgt_mask, name: str, kv=None):
        """Pre-norm decoder layer; ``kv`` (the predictor's layer): the
        self-attention keys and values come from these rows, normed
        alike."""
        n0 = self.norm(x, f"{name}.sub0.norm")
        nkv = n0 if kv is None else self.norm(kv, f"{name}.sub0.norm")
        x = x + self.mha(n0, nkv, tgt_mask, f"{name}.self_attn")
        x = x + self.mha(self.norm(x, f"{name}.sub1.norm"), mem,
                         src_mask[:, None, :], f"{name}.src_attn")
        return x + self.ffn(self.norm(x, f"{name}.sub2.norm"), f"{name}.ffn")

    def decoder(self, x, mem, src_mask, tgt_mask):
        for i in range(self.cfg["N_dec"]):
            x = self.dec_layer(x, mem, src_mask, tgt_mask,
                               f"decoder0.layer{i}")
        return self.norm(x, "decoder0.norm")

    def logprobs(self, h):
        return torch.log_softmax(self.dense(h, "generator.proj"), dim=-1)

    # ------------------------------------------------------------ model
    def encode(self, att, am):
        """att [B, R, F] float32, am [B, R] -> memory [B, R, d], src mask."""
        src = am.bool()
        x = torch.relu(self.dense(att.float(), "att_embed"))
        for i in range(self.cfg["N_enc"]):
            p = f"encoder.layer{i}"
            x = x + self.mha(self.norm(x, f"{p}.sub0.norm"),
                             self.norm(x, f"{p}.sub0.norm"),
                             src[:, None, :], f"{p}.self_attn")
            x = x + self.ffn(self.norm(x, f"{p}.sub1.norm"), f"{p}.ffn")
        return self.norm(x, "encoder.RefLayerNorm_0"), src

    def bound_logprobs(self, mem, src, extend_syn, last):
        """One bounding step of the length/syntax predictor (N_len 1): the
        [LEN] row attends to the plan's rows before ``last``.  extend_syn
        [B, L+2] syn ids ([LEN] at 0), last [B] -> (length log-probs
        [B, 20], syntax log-probs [B, 10])."""
        L2 = extend_syn.shape[1]
        y = self.embed(extend_syn, "syn_embed") + sinusoid(
            L2, self.d, mem.device)[None]
        key = torch.arange(L2, device=mem.device)
        mask = (key[None, :] < last[:, None])[:, None, :]
        x = self.dec_layer(y[:, :1], mem, src, mask, "lp0", kv=y)
        h = self.norm(x, "lp_norm")[:, 0]
        len_lp = torch.log_softmax(self.dense(torch.relu(
            self.dense(h, "len_head1")), "len_head2"), dim=-1)
        syn_lp = torch.log_softmax(self.dense(torch.relu(
            self.dense(h, "syn_head1")), "syn_head2"), dim=-1)
        return len_lp, syn_lp

    def na_fill_logprobs(self, mem, src, syn_seq, total):
        """The NA fill: BOS words plus the plan's syn ids at positions
        0..L-1, every row seeing the keys before ``total`` -> word
        log-probs [B, L, V]."""
        B, L = syn_seq.shape
        bos = torch.full_like(syn_seq, BOS)
        x = (self.embed(bos, "word_embed") + self.embed(syn_seq, "syn_embed")
             + sinusoid(L, self.d, mem.device)[None])
        key = torch.arange(L, device=mem.device)
        mask = (key[None, :] < total[:, None])[:, None, :]
        return self.logprobs(self.decoder(x, mem, src, mask))

    def ar_logprobs(self, mem, src, seq):
        """Teacher-forced AR decode over the words ``seq`` [B, L]: the
        input at position t is BOS for t = 0, else seq[t-1]; causal
        self-attention -> word log-probs [B, L, V] of each position."""
        B, L = seq.shape
        inp = torch.cat([torch.full_like(seq[:, :1], BOS), seq[:, :-1]], 1)
        x = self.embed(inp, "word_embed") + sinusoid(L, self.d,
                                                     mem.device)[None]
        mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                     device=mem.device))[None]
        return self.logprobs(self.decoder(x, mem, src, mask))
