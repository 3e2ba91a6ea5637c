"""Plain float32 reference of the UIC cross-entropy training step, followed
for the first steps of a run from the same weights, the same batches and
the same dropout draws as the program.

The step (BoFiCap, captioning/modules/loss_wrapper.py and
losses.py:315-369; the shipped ``configs/uic_sd.yml``): the regions
embedded (ReLU, dropout ``drop_prob_lm``) and encoded once an image; each
caption's two teacher-forced branches over that memory: SA (the
length/syntax predictor reading the words, the fill decoder reading each
phrase's words copied from the phrase before) and NA (the predictor
reading the syntax ids, the fill decoder reading BOS words); six NLL terms
and the self-distillation KL(NA <- SA, the SA side detached), each summed
and divided by the batch's word count; gradients by autograd; each value
clipped to [-0.1, 0.1]; Adam (0.9, 0.98, 1e-9, bias-corrected moments, eps
outside the root) at the noam rate d^-0.5 min(t^-0.5, t w^-1.5).

Dropout: the program draws every mask from one generator, in the order of
its forward, at the whole batch's shapes (``torch.rand(shape) < 1 - p``).
``Drops`` draws the same masks from a generator seeded alike, in the same
order (the first block of rows runs the whole forward and draws them), and
hands each block of rows its slice, so the reference can run the batch in
blocks that fit the card in float32.

Everything the program derives from the inputs is worked out here again
from the corpus and the images' ids: the framed labels and phrase rows,
the syntax row, the copied words of the SA input, the masks.  It imports
torch and numpy alone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .boficap_ref import BOS, EOS, LEN, PAD, MASK_FILL, Reference, sinusoid

CLIP = 0.1
ADAM = (0.9, 0.98, 1e-9)


class Drops:
    """Dropout masks of one step: drawn whole on the first block of rows,
    in call order, then sliced for every block.  ``per`` of a call: 'img'
    when its rows are images, 'cap' when they are captions (``k`` an
    image)."""

    def __init__(self, gen: torch.Generator, n_img: int, k: int):
        self.gen, self.n_img, self.k = gen, n_img, k
        self.masks: List[torch.Tensor] = []
        self.i = 0
        self.rows = (0, n_img)

    def block(self, i0: int, i1: int) -> None:
        self.i, self.rows = 0, (i0, i1)

    def __call__(self, x, rate: float, per: str):
        if rate == 0.0:
            return x
        s = 1 if per == "img" else self.k
        if self.i == len(self.masks):
            shape = (self.n_img * s,) + tuple(x.shape[1:])
            self.masks.append(torch.rand(shape, generator=self.gen,
                                         device=x.device) < 1.0 - rate)
        keep = self.masks[self.i][self.rows[0] * s:self.rows[1] * s]
        self.i += 1
        if keep.shape != x.shape:
            raise ValueError(f"dropout call {self.i}: mask {keep.shape} "
                             f"for rows {x.shape}")
        return torch.where(keep, x / (1.0 - rate), 0.0)


def frame(corpus: Dict[str, np.ndarray], ids, k: int, L: int, device
          ) -> Dict[str, torch.Tensor]:
    """The batch of images ``ids`` (each with its ``k`` captions, rows
    i*k .. i*k + k - 1 of the corpus), framed as the published collate
    frames it, and every input of the step worked out from it."""
    rows = np.concatenate([np.arange(i * k, i * k + k) for i in ids])
    words, pn = corpus["labels"][rows], corpus["phrase_num"][rows]
    lens, syns = corpus["phrase_length"][rows], corpus["phrase_syn"][rows]
    C, L2 = len(rows), L + 2
    labels = np.zeros((C, L2), np.int64)
    plen = np.zeros((C, L2), np.int64)
    psyn = np.zeros((C, L2), np.int64)
    ext = np.full((C, L2), PAD, np.int64)
    copied = np.full((C, L), PAD, np.int64)
    sa_vis = np.zeros((C, L), np.int64)
    total = np.zeros(C, np.int64)
    for c in range(C):
        n = int(pn[c])
        ls, ss = [int(x) for x in lens[c, :n]], [int(x) for x in syns[c, :n]]
        labels[c, 0], labels[c, 1:L + 1], labels[c, L + 1] = BOS, words[c], EOS
        plen[c, 0], plen[c, 1:n + 1] = 1, ls
        psyn[c, 0], psyn[c, 1:n + 1], psyn[c, n + 1] = BOS, ss, EOS
        T = sum(ls)
        total[c] = T
        ext[c, 0] = LEN
        p = 0
        prev_start, prev = 0, 1            # the BOS "phrase" at label 0
        for j in range(n):
            cur = ls[j]
            for o in range(cur):
                ext[c, 1 + p + o] = ss[j]
                sa_vis[c, p + o] = p + cur
                if cur <= prev:            # the last cur words before
                    src = prev_start + prev - cur + o
                else:                      # each word repeated, the last
                    ct, r = divmod(cur, prev)      # r ones once more
                    head = (prev - r) * ct
                    src = prev_start + (o // ct if o < head else
                                        prev - r + (o - head) // (ct + 1))
                copied[c, p + o] = labels[c, src]
            prev_start, prev = 1 + p, cur
            p += cur
        sa_vis[c, T:] = T
    t = {name: torch.as_tensor(v, device=device) for name, v in (
        ("labels", labels), ("phrase_length", plen), ("phrase_syn", psyn),
        ("phrase_num", pn.astype(np.int64) + 1), ("extend_syn", ext),
        ("copied", copied), ("sa_vis", sa_vis), ("total", total))}
    return t


class TrainReference(Reference):
    """The UIC training forward and loss, in float32 (float8 dense
    products under ``quant='fp8'``), with dropout from ``drops``."""

    def __init__(self, weights, cfg, drops: Drops,
                 quant: Optional[str] = None):
        super().__init__(weights, cfg, quant)
        self.drop = drops
        self.p = cfg["dropout"]
        self.p_lm = cfg.get("drop_prob_lm", 0.5)

    def mha_d(self, xq, xkv, mask, name: str, per: str):
        """Attention with dropout on the probabilities; ``mask``
        broadcastable to [B, 1, Lq, Lk]."""
        B, Lq, d = xq.shape
        Lk = xkv.shape[1]
        H, Dh = self.H, d // self.H
        q = self.dense(xq, f"{name}.wq").reshape(B, Lq, H, Dh).transpose(1, 2)
        k = self.dense(xkv, f"{name}.wk").reshape(B, Lk, H, Dh).transpose(1, 2)
        v = self.dense(xkv, f"{name}.wv").reshape(B, Lk, H, Dh).transpose(1, 2)
        s = (q @ k.transpose(-1, -2)) / math.sqrt(Dh)
        p = self.drop(torch.softmax(s.masked_fill(~mask, MASK_FILL), -1),
                      self.p, per)
        o = (p @ v).transpose(1, 2).reshape(B, Lq, d)
        return self.dense(o, f"{name}.wo")

    def ffn_d(self, x, name: str, per: str):
        h = self.drop(torch.relu(self.dense(x, f"{name}.Dense_0")), self.p,
                      per)
        return self.dense(h, f"{name}.Dense_1")

    def encode_t(self, att, src):
        x = self.drop(torch.relu(self.dense(att, "att_embed")), self.p_lm,
                      "img")
        m = src[:, None, None, :]
        for i in range(self.cfg["N_enc"]):
            p = f"encoder.layer{i}"
            n = self.norm(x, f"{p}.sub0.norm")
            x = x + self.drop(self.mha_d(n, n, m, f"{p}.self_attn", "img"),
                              self.p, "img")
            n = self.norm(x, f"{p}.sub1.norm")
            x = x + self.drop(self.ffn_d(n, f"{p}.ffn", "img"), self.p, "img")
        return self.norm(x, "encoder.RefLayerNorm_0")

    def layer_t(self, x, mem, src, tgt, name: str, kv=None,
                grouped: bool = False):
        """A decoder layer over caption rows ``x``; ``grouped``: ``mem``
        has one row an image and each image's captions attend to it as
        one query block (the program's grouped cross-attention)."""
        n0 = self.norm(x, f"{name}.sub0.norm")
        nkv = n0 if kv is None else self.norm(kv, f"{name}.sub0.norm")
        x = x + self.drop(self.mha_d(n0, nkv, tgt[:, None],
                                     f"{name}.self_attn", "cap"),
                          self.p, "cap")
        n1 = self.norm(x, f"{name}.sub1.norm")
        sm = src[:, None, None, :]
        if grouped:
            c = self.mha_d(n1.reshape(mem.shape[0], -1, n1.shape[-1]), mem,
                           sm, f"{name}.src_attn", "img").reshape(n1.shape)
        else:
            c = self.mha_d(n1, mem, sm, f"{name}.src_attn", "cap")
        x = x + self.drop(c, self.p, "cap")
        n2 = self.norm(x, f"{name}.sub2.norm")
        return x + self.drop(self.ffn_d(n2, f"{name}.ffn", "cap"), self.p,
                             "cap")

    def bound_t(self, ids, plen, mem_rep, src_rep, table: str):
        """Teacher-forced bounding, every step at once: the [LEN] row at
        step s sees the plan's rows before 1 + l_1 + ... + l_s."""
        C, L2 = ids.shape
        S = self.L + 1
        y = self.drop(self.embed(ids, table)
                      + sinusoid(L2, self.d, ids.device)[None], self.p, "cap")
        ends = torch.cumsum(plen[:, 1:], -1)[:, :S - 1]
        prefix = 1 + torch.cat([torch.zeros_like(ends[:, :1]), ends], 1)
        mask = torch.arange(L2, device=ids.device)[None, None] < prefix[
            ..., None]
        q = y[:, :1].expand(C, S, self.d)
        h = self.norm(self.layer_t(q, mem_rep, src_rep, mask, "lp0", kv=y),
                      "lp_norm")
        lh = self.drop(torch.relu(self.dense(h, "len_head1")), self.p, "cap")
        sh = self.drop(torch.relu(self.dense(h, "syn_head1")), self.p, "cap")
        return (torch.log_softmax(self.dense(lh, "len_head2"), -1),
                torch.log_softmax(self.dense(sh, "syn_head2"), -1))

    def fill_t(self, words, syn, mem, src, tgt):
        x = self.drop(self.embed(words, "word_embed")
                      + self.embed(syn, "syn_embed")
                      + sinusoid(self.L, self.d, words.device)[None],
                      self.p, "cap")
        for i in range(self.cfg["N_dec"]):
            x = self.layer_t(x, mem, src, tgt, f"decoder0.layer{i}",
                             grouped=True)
        return self.logprobs(self.norm(x, "decoder0.norm"))

    def loss_sum(self, att, am, b: Dict[str, torch.Tensor]):
        """The block's six terms and the KL, summed (not yet divided by
        the batch's word count)."""
        L, k = self.L, self.drop.k
        src = am.bool()
        mem = self.encode_t(att, src)
        mem_rep, src_rep = (mem.repeat_interleave(k, 0),
                            src.repeat_interleave(k, 0))
        key = torch.arange(L, device=att.device)
        wm = (key[None] < b["total"][:, None]).float()
        na_mask = (key[None, None] < b["total"][:, None, None]).expand(
            -1, L, L)
        sa_mask = key[None, None] < b["sa_vis"][..., None]
        word_syn = b["extend_syn"][:, 1:-1]
        lp_words = b["labels"].clone()
        lp_words[:, 0] = LEN
        sa_len, sa_syn = self.bound_t(lp_words, b["phrase_length"], mem_rep,
                                      src_rep, "word_embed")
        sa_w = self.fill_t(b["copied"], word_syn, mem, src, sa_mask)
        na_len, na_syn = self.bound_t(b["extend_syn"], b["phrase_length"],
                                      mem_rep, src_rep, "syn_embed")
        na_w = self.fill_t(torch.full_like(word_syn, BOS), word_syn, mem, src,
                           na_mask)
        S = L + 1
        sm = (torch.arange(S, device=att.device)[None]
              < b["phrase_num"][:, None]).float()
        tgt_w = b["labels"][:, 1:L + 1, None]
        tgt_l = b["phrase_length"][:, 1:S + 1, None]
        tgt_s = b["phrase_syn"][:, 1:S + 1, None]
        total = 0.0
        for lp in (sa_w, na_w):
            total = total - (lp.gather(-1, tgt_w)[..., 0] * wm).sum()
        for ln, sy in ((sa_len, sa_syn), (na_len, na_syn)):
            total = total - (ln.gather(-1, tgt_l)[..., 0] * sm).sum()
            total = total - (sy.gather(-1, tgt_s)[..., 0] * sm).sum()
        if self.cfg.get("self_dis", False):
            t = sa_w.detach()
            total = total + ((t.exp() * (t - na_w)).sum(-1) * wm).sum()
        return total


def noam(cfg: dict, t: int) -> float:
    """The noam rate of step t (from 1), in float32."""
    w = np.float32(cfg["noamopt_warmup"] ** -1.5)
    s = np.float32(t)
    scale = np.float32(cfg.get("noamopt_factor", 1.0)
                       * cfg["d_model"] ** -0.5)
    return float(scale * np.minimum(s ** np.float32(-0.5), s * w))


def follow(weights: Dict[str, torch.Tensor], cfg: dict,
           corpus: Dict[str, np.ndarray], att_store, am_store,
           batches: List[List[int]], seed_gen: torch.Generator, block: int,
           device, quant: Optional[str] = None) -> dict:
    """The reference's first ``len(batches)`` steps from ``weights``: each
    step's loss, the first step's clipped gradient by leaf (``g1``, and
    its norms) and the norm of each leaf's change after the last step.  ``seed_gen``:
    a generator in the state the program's was in before its first step;
    ``block``: images a block of rows; ``device``: where it runs (the
    weights and the store may lie in host memory)."""
    k, L = cfg["seq_per_img"], cfg["max_length"]
    b1, b2, eps = ADAM
    names = list(weights)
    p = {n: weights[n].detach().to(device).float().clone()
         .requires_grad_(True) for n in names}
    m = {n: torch.zeros_like(p[n]) for n in names}
    v = {n: torch.zeros_like(p[n]) for n in names}
    losses, g1 = [], None
    for t, ids in enumerate(batches, start=1):
        b = frame(corpus, ids, k, L, device)
        idx = torch.as_tensor(ids, device=att_store.device)
        am = am_store.index_select(0, idx).to(device)
        att = att_store.index_select(0, idx).to(device) * am[..., None]
        pad = cfg["max_boxes"] - att.shape[1]      # the collate's width
        att = torch.nn.functional.pad(att, (0, 0, 0, pad))
        am = torch.nn.functional.pad(am, (0, pad))
        drops = Drops(seed_gen, len(ids), k)
        ref = TrainReference(p, cfg, drops, quant)
        denom = b["total"].sum().clamp_min(1).double()
        loss = torch.zeros((), dtype=torch.float64, device=att.device)
        for i0 in range(0, len(ids), block):
            i1 = min(i0 + block, len(ids))
            drops.block(i0, i1)
            rows = {n: x[i0 * k:i1 * k] for n, x in b.items()}
            part = ref.loss_sum(att[i0:i1], am[i0:i1], rows) / denom.float()
            part.backward()
            loss += part.detach().double()
        del drops, ref
        losses.append(float(loss))
        with torch.no_grad():
            g = {n: p[n].grad.clamp(-CLIP, CLIP) for n in names}
            if g1 is None:
                g1 = g
            lr = noam(cfg, t)
            for n in names:
                m[n].mul_(b1).add_(g[n], alpha=1 - b1)
                v[n].mul_(b2).add_(g[n] * g[n], alpha=1 - b2)
                mh = m[n] / (1 - b1 ** t)
                vh = v[n] / (1 - b2 ** t)
                p[n] -= lr * mh / (vh.sqrt() + eps)
                p[n].grad = None
    with torch.no_grad():
        change = {n: float((p[n] - weights[n].to(device).float()).norm())
                  for n in names}
    return {"loss": losses, "g1": g1,
            "grad1": {n: float(g1[n].norm()) for n in names},
            "change": change}
