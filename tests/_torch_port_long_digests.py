"""The seeded calls past 128 keys whose outputs the card tests hold
bitwise to frozen hashes (tests/test_torch_port_cuda.py
``test_attention_long_digests_match_parent``), and the operands they are
made of; scripts/attention_long_ab.py prints the same hashes and times
the attention block on the same operands."""

from __future__ import annotations

import hashlib

import numpy as np
import torch

# (Lq, Lk) of the attention core's digests at B = 64: PB_pad's lossless
# packed width, a 14 x 14 image grid's self-attention, the decoder's and
# narrow round's cross-attention, 256 keys, and a long key row
DIGEST_SHAPES = ((211, 211), (196, 196), (20, 196), (8, 196), (256, 256),
                 (3, 500))


def digest(t) -> str:
    """The first 16 hex digits of the SHA-256 of ``t``'s bytes."""
    return hashlib.sha256(t.detach().cpu().contiguous().view(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest()[:16]


def attention_operands(rs, B, Lq, Lk, dtype, device, H=8, Dh=64):
    """q, k, v as transposed views of [B, L, H, Dh] projections (as attend
    hands them over) and a padded bool mask [B, Lq, Lk]: sample 0 fully
    masked, row 0 of sample 1 fully masked, from numpy ``rs``."""

    def heads(rows):
        x = rs.standard_normal((B, rows, H, Dh)).astype(np.float32)
        return torch.from_numpy(x).to(device, dtype).transpose(1, 2)

    q, k, v = heads(Lq), heads(Lk), heads(Lk)
    live = rs.randint(1, Lk + 1, size=B)
    live[0] = 0
    mask = np.broadcast_to(np.arange(Lk)[None, None, :]
                           < live[:, None, None], (B, Lq, Lk)).copy()
    if B > 1:
        mask[1, 0] = False
    return q, k, v, torch.from_numpy(mask).to(device)


def layer_weights(rs, keys, D, F, dtype, device):
    """A layer's packed weights (ops.decoder_layer.weight_shapes): norm
    scales near 1 and biases near 0 in float32, the products' weights
    scaled by 1 / sqrt(fan-in) in ``dtype``."""
    from boficap_tpu_torch.ops import decoder_layer as dl
    out = {}
    for key, shape in dl.weight_shapes(keys, D, F).items():
        x = rs.standard_normal(shape).astype(np.float32)
        if key in dl._NORM_KEYS:
            x = (1.0 + 0.05 * x) if key.startswith("s") else 0.05 * x
            out[key] = torch.from_numpy(x).to(device)
        else:
            x = x / np.sqrt(shape[0]) if len(shape) == 2 else 0.05 * x
            out[key] = torch.from_numpy(x).to(device, dtype)
    return out


def digest_cases(device):
    """The calls whose outputs ``output_digests`` hashes, by name: each a
    function of the ops modules returning one tensor, on operands made here
    from numpy seeds.  The attention core (path left to attention_path) at
    each long shape and B = 64 (and 211 x 211 at B = 5), both dtypes but
    float32 at 3 x 500 (the ffma block does not fit there); the encoder
    layer over 196 regions and the decoder layer's cross-attention over
    them, D = 512, 8 heads, B = 16, both dtypes."""
    from boficap_tpu_torch.ops import attention as at
    from boficap_tpu_torch.ops import decoder_layer as dl
    cases = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        shapes = [(64, Lq, Lk) for Lq, Lk in DIGEST_SHAPES]
        shapes.append((5, 211, 211))
        for B, Lq, Lk in shapes:
            if dtype == torch.float32 and Lk == 500:
                continue
            ops = attention_operands(np.random.RandomState(Lq * 1000 + Lk),
                                     B, Lq, Lk, dtype, device)
            cases[f"core_{name}_b{B}_{Lq}x{Lk}"] = (
                lambda ops=ops: at.attention_core(*ops))
        rs = np.random.RandomState(196)
        D, F, H, Bl, R, L = 512, 2048, 8, 16, 196, 20
        x = torch.from_numpy(rs.standard_normal((Bl, R, D)).astype(
            np.float32)).to(device, dtype)
        live = rs.randint(1, R + 1, size=Bl)
        live[0] = 0
        src = torch.from_numpy(np.arange(R)[None, :] < live[:, None]).to(
            device)
        enc = layer_weights(rs, dl._ENC_KEYS, D, F, dtype, device)
        cases[f"encoder_layer_{name}_{R}"] = (
            lambda x=x, src=src, enc=enc: dl.fused_encoder_layer(x, src, enc,
                                                                 H))
        y = torch.from_numpy(rs.standard_normal((Bl, L, D)).astype(
            np.float32)).to(device, dtype)
        tgt = torch.ones((Bl, L, L), dtype=torch.bool, device=device)
        dec = layer_weights(rs, dl._DEC_KEYS, D, F, dtype, device)
        cases[f"decoder_layer_{name}_{L}x{R}"] = (
            lambda y=y, x=x, tgt=tgt, src=src, dec=dec:
            dl.fused_decoder_layer(y, x, tgt, src, dec, H))
    return cases


def output_digests(cases) -> dict:
    """A hash of each case's output, by name (on the card)."""
    out = {}
    for name, fn in cases.items():
        t = fn()
        torch.cuda.synchronize()
        out[name] = digest(t)
    return out
