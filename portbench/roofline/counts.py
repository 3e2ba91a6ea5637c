"""Frozen work counts: the operations and bytes each function of the
captioners needs at given shapes, and the least time the card could take
for them (the larger of operations over the peak rate and bytes over the
memory bandwidth, ``peaks.json``).

Operations count a multiply-add as two; only the products are counted (the
norms, softmaxes and elementwise work are a few percent and go uncounted,
so a share read against these counts is a floor).  Bytes count each input
read once and each output written once: activations and weights at the
compute dtype's width, masks at one byte, float32 norm parameters, and the
greedy head's four outputs a row (an int64 id, three float32).

The counts are of the function, whatever implements it: a kernel that
fuses two of them, or a later redesign, reads against the same work.
"""

from __future__ import annotations

import json
import os
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))
ES = {"bfloat16": 2, "float16": 2, "float32": 4}


def peaks() -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def _work(flops: float, nbytes: float) -> Dict[str, float]:
    return {"flops": float(flops), "bytes": float(nbytes)}


def encoder_layer(B: int, R: int, d: int, dff: int, dtype: str):
    """One pre-norm encoder layer over [B, R, d]: q, k, v, o, the FFN and
    the two attention products."""
    es = ES[dtype]
    flops = 2 * B * R * (4 * d * d + 2 * d * dff) + 4 * B * R * R * d
    w = (4 * d * d + 2 * d * dff + 5 * d + dff) * es + 2 * 2 * d * 4
    nbytes = 2 * B * R * d * es + B * R + w
    return _work(flops, nbytes)


def decoder_layer(B: int, L: int, R: int, d: int, dff: int, dtype: str):
    """One pre-norm decoder layer: self-attention over the L rows,
    cross-attention over R memory rows (their K and V projected here),
    the FFN."""
    es = ES[dtype]
    flops = (2 * B * L * (4 * d * d + 2 * d * d + 2 * d * dff)
             + 2 * B * R * 2 * d * d + 4 * B * L * L * d + 4 * B * L * R * d)
    w = (8 * d * d + 2 * d * dff + 9 * d + dff) * es + 3 * 2 * d * 4
    nbytes = (2 * B * L * d + B * R * d) * es + B * L * L + B * R + w
    return _work(flops, nbytes)


def greedy_head(M: int, d: int, V: int, dtype: str):
    """The generator's product over M rows, reduced to id, token
    log-prob, entropy and the PAD log-prob a row."""
    es = ES[dtype]
    flops = 2 * M * d * V
    nbytes = M * d * es + (d * V + V) * es + M * (8 + 3 * 4)
    return _work(flops, nbytes)


def attention_core(B: int, H: int, Lq: int, Lk: int, Dh: int, dtype: str):
    """softmax(q k^T / sqrt(Dh)) v over [B, H] heads, masked."""
    es = ES[dtype]
    flops = 4 * B * H * Lq * Lk * Dh
    nbytes = (2 * B * H * Lq * Dh + 2 * B * H * Lk * Dh) * es + B * Lq * Lk
    return _work(flops, nbytes)


def window_layer(B: int, W: int, L: int, R: int, d: int, dff: int,
                 dtype: str):
    """One windowed decoder layer (an SA round): W query rows a sample
    over its L cached rows and the W new ones; q, k, v and o of the
    self-attention and q and o of the cross-attention on the W rows, the
    cross K/V given (projected once a round), the FFN."""
    es = ES[dtype]
    flops = (2 * B * W * (6 * d * d + 2 * d * dff) + 4 * B * W * (L + W) * d
             + 4 * B * W * R * d)
    w = (6 * d * d + 2 * d * dff + 9 * d + dff) * es + 3 * 2 * d * 4
    nbytes = ((B * W * d + 2 * B * L * d + 2 * B * R * d + 3 * B * W * d)
              * es + B * W * (L + W) + B * R + w)
    return _work(flops, nbytes)


def linear(M: int, K: int, N: int, dtype: str):
    """One product [M, K] x [K, N] with its bias."""
    es = ES[dtype]
    return _work(2 * M * K * N, (M * K + K * N + N + M * N) * es)


def refnorm(M: int, d: int, dtype: str):
    """One RefLayerNorm over M rows of d."""
    es = ES[dtype]
    return _work(0, 2 * M * d * es + 2 * d * 4)


def least_time_s(work: Dict[str, float], dtype: str) -> float:
    p = peaks()
    return max(work["flops"] / p["flops_per_s"][dtype],
               work["bytes"] / p["hbm_bytes_per_s"])


# ---------------------------------------------------------------- model
def embed_flops(R: int, F: int, d: int) -> float:
    return 2 * R * F * d


def na_caption_flops(cfg: dict, R: int) -> float:
    """The model FLOPs of one NA caption (UIC, N_len 1): region embedding,
    the encoder, the bounding loop's L steps of the predictor's layer on
    its one [LEN] row (the plan rows' K/V are a per-model table), its
    heads, then the fill's decoder over L rows and the generator."""
    d, dff, L = cfg["d_model"], cfg["d_ff"], cfg["max_length"]
    V = cfg["vocab_size"] + 4
    dt = cfg["dtype"]
    enc = cfg["N_enc"] * encoder_layer(1, R, d, dff, dt)["flops"]
    cross_kv = 2 * R * 2 * d * d
    step = (2 * (d * d + 2 * d * d + 2 * d * dff) + 4 * (L + 2) * d
            + 4 * R * d + 2 * (2 * d * 100 + 100 * 30))
    fill = cfg["N_dec"] * decoder_layer(1, L, R, d, dff, dt)["flops"]
    head = 2 * L * d * V
    return (embed_flops(R, cfg["att_feat_size"], d) + enc + cross_kv
            + L * step + fill + head)


def ar_caption_flops(cfg: dict, R: int) -> float:
    """The model FLOPs of one greedy AR caption (AIC): region embedding,
    the encoder, every layer's cross K/V once, then L KV-cached steps of
    one row through the decoder (self-attention over the t + 1 cached
    rows) and the generator."""
    d, dff, L = cfg["d_model"], cfg["d_ff"], cfg["max_length"]
    V = cfg["vocab_size"] + 4
    dt = cfg["dtype"]
    enc = cfg["N_enc"] * encoder_layer(1, R, d, dff, dt)["flops"]
    cross_kv = cfg["N_dec"] * 2 * R * 2 * d * d
    steps = 0.0
    for t in range(L):
        per_layer = (2 * (6 * d * d + 2 * d * dff) + 4 * (t + 1) * d
                     + 4 * R * d)
        steps += cfg["N_dec"] * per_layer + 2 * d * V
    return embed_flops(R, cfg["att_feat_size"], d) + enc + cross_kv + steps


def uic_xe_forward_flops(cfg: dict, n_images: int, k: int, R: int) -> float:
    """The model FLOPs of one teacher-forced UIC training forward over
    ``n_images`` images of ``k`` captions each: region embedding and the
    encoder once an image; then for each caption both branches' one-pass
    bounding (the predictor's layer on its L + 1 stacked [LEN] query rows
    over the L + 2 plan rows and the caption's repeated memory, the two
    heads) and both branches' decoders over L rows (their cross K/V once
    an image) and generators."""
    d, dff, L = cfg["d_model"], cfg["d_ff"], cfg["max_length"]
    V = cfg["vocab_size"] + 4
    dt = cfg["dtype"]
    N, S, L2 = n_images * k, L + 1, L + 2
    enc = n_images * (embed_flops(R, cfg["att_feat_size"], d)
                      + cfg["N_enc"] * encoder_layer(1, R, d, dff, dt)[
                          "flops"])
    bound = (2 * S * (2 * d * d) + 2 * L2 * 2 * d * d + 4 * S * L2 * d
             + 2 * S * 2 * d * d + 2 * R * 2 * d * d + 4 * S * R * d
             + 2 * S * 2 * d * dff + 2 * S * (2 * d * 100 + 100 * 30))
    layer = decoder_layer(1, L, R, d, dff, dt)["flops"] - 2 * R * 2 * d * d
    dec = cfg["N_dec"] * (N * layer + n_images * 2 * R * 2 * d * d)
    head = 2 * L * d * V
    return enc + 2 * (N * bound + dec + N * head)


def xe_step_flops(cfg: dict, n_images: int, k: int, R: int) -> float:
    """One XE step: the forward and a backward of twice its products."""
    return 3.0 * uic_xe_forward_flops(cfg, n_images, k, R)
