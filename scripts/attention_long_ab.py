"""Time and hash the attention block past 128 keys in one checkout, for A/B
runs of two commits on one card.

    python3 scripts/attention_long_ab.py CHECKOUT LABEL

CHECKOUT is the root of a checkout of this repository (its
``boficap_tpu_torch`` and ``chip_smoke.py`` are imported from there, its
kernels built into its own ``_build``).  On one NVIDIA card it prints the
nvidia-smi line, then one line ``LONG {...}`` with:

  attention     by dtype and (Lq, Lk) past 128 keys, at B = 64, H = 8,
                Dh = 64 (a padded mask, a fully masked sample and row): the
                path ``attention_path`` gives, its device ms
                (chip_smoke.device_ms), each other path the dtype has,
                forced, where it fits (``by_path_ms``: at float32 the ffma
                block, the parent's path past 128 keys), the plain twin's
                and SDPA's ms (SDPA: the yardstick, never called by the
                port), the bound (chip_smoke.attention_bound) and the error
                against the twin;
  digest        ``output_digests`` of ``digest_cases``
                (tests/_torch_port_long_digests.py): a hash of each output
                of the attention core, the encoder layer (#1) and the
                decoder layer (#2) past 128 keys at both dtypes, on seeded
                operands (tests/test_torch_port_cuda.py holds the parent's
                hashes frozen);
  grid          chip_smoke.measure_grid (#1, #2, #4-#9 over 196 regions,
                float32 weights), each row with its error against its twin
                (chip_smoke.check_grid_kernels);
  split_196     torch.profiler's device ms a call of #1 (self 196 x 196),
                #2 (cross 20 x 196) and #4 over 196 regions at both dtypes,
                by building block (products, each attention kernel,
                refnorm, other), with launches (chip_smoke.profile_split);
  pb_w211       PB_pad's float32 decode at the lossless packed width 211
                (chip_smoke.check_pb_decode: its checks, and the ms of the
                decode with the attention core against the plain path);
  aic_grid_ms   the AR decode (ar_sample, bf16, transformer.yml) over 196
                regions with the attention core (#9 at 1 x 196) and
                without it, medians of 5.

Run it in turns on the parent and the change in one call (parent, change,
change, parent).  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time

# the digest cases and their operands, from this script's tree
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from tests._torch_port_long_digests import (  # noqa: E402
    attention_operands, digest_cases, output_digests)

# (Lq, Lk) past 128 keys: PB_pad's lossless packed width, a 14 x 14 image
# grid's self-attention, the decoder's and narrow round's cross-attention,
# AIC's step over the grid, 256 keys, and a long key row
LONG_SHAPES = ((211, 211), (196, 196), (20, 196), (8, 196), (1, 196),
               (1, 211), (256, 256), (3, 500))


def attention_times(cs) -> dict:
    import numpy as np
    import torch
    from boficap_tpu_torch.ops import attention as at
    out = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        res = out[name] = {}
        paths = ("row", "tile") if dtype == torch.bfloat16 else tuple(
            p for p in at.PATHS if p not in ("tile",))
        for Lq, Lk in LONG_SHAPES:
            q, k, v, m = attention_operands(
                np.random.RandomState(Lq + Lk), cs.B, Lq, Lk, dtype, "cuda")
            path = at.attention_path(Lq, Lk, dtype)
            want = at.attention_core_plain(q, k, v, m)
            try:
                got = at.attention_core(q, k, v, m)
            except ValueError as e:        # a checkout that refuses it
                res[f"{Lq}x{Lk}"] = {"path": path, "refused": str(e)}
                continue
            torch.cuda.synchronize()
            bound, by = cs.attention_bound(q, k, v, m, name)
            by_path = {}
            for p in paths:
                if p == path:
                    continue
                try:
                    at.check_operands(q, k, v, m, p)
                except ValueError:
                    continue
                by_path[p] = cs.device_ms(
                    lambda p=p: at.attention_core(q, k, v, m, path=p))
            res[f"{Lq}x{Lk}"] = {
                "path": path,
                "ms": cs.device_ms(lambda: at.attention_core(q, k, v, m)),
                "by_path_ms": by_path,
                "plain_ms": cs.device_ms(
                    lambda: at.attention_core_plain(q, k, v, m)),
                "sdpa_ms": cs.device_ms(
                    lambda: cs.library_attention(q, k, v, m)),
                "bound_ms": bound, "bound_by": by,
                "rel_err": cs.rel_err(got, want),
                "max_abs_err": (got.float() - want.float()).abs().max()
                .item()}
    return out


SPLIT_PARTS = {"products": "gemm_tc_kernel",
               "ffma_products": "ffma_gemm_kernel",
               "attention_tile": "attention_tile_kernel",
               "attention_tile_long": "attention_tile_long_kernel",
               "attention_ffma": "attention_ffma_kernel",
               "attention_ffma_long": "attention_ffma_long_kernel",
               "attention_row": "attention_row_kernel",
               "refnorm": "refnorm_kernel"}


def split_196(cs, model) -> dict:
    import torch
    from boficap_tpu_torch.ops import decoder_layer as dl
    from boficap_tpu_torch.ops import stack as st
    H = model.num_heads
    out = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        enc_w = dl.pack_encoder_layer(model.encoder.layer0, dtype)
        dec_w = dl.pack_layer_weights(model.decoder0.layer0, dtype)
        enc = st.pack_encoder_stack(model.encoder, dtype)
        x_enc, src, x_dec, mem, tgt, _ = cs.layer_inputs(dtype, 4, cs.GRID)
        calls = {
            "encoder_layer": lambda: dl.fused_encoder_layer(x_enc, src,
                                                            enc_w, H),
            "decoder_layer": lambda: dl.fused_decoder_layer(
                x_dec, mem, tgt, src, dec_w, H),
            "encoder_stack": lambda: st.fused_encoder_stack_forward(
                x_enc, src, enc.stack, enc.final_norm, H)}
        res = out[name] = {}
        for key, fn in calls.items():
            split = res[key] = cs.profile_split(fn, SPLIT_PARTS)
            split["device_ms"] = cs.device_ms(fn)
    return out


def aic_grid_ms(cs) -> dict:
    import torch
    from boficap_tpu_torch.decode.ar import ar_sample
    from boficap_tpu_torch.decode.bound_fill import fused_encode
    aic = cs.build(None, "transformer.yml")
    g = torch.Generator().manual_seed(43)
    att = torch.randn((cs.B, cs.GRID, 2048), generator=g).to("cuda")
    am = torch.ones((cs.B, cs.GRID), device="cuda")
    src = am.bool()
    out = {}
    with torch.no_grad():
        for on in (True, False):
            aic.set_attention_core(on)
            fn = lambda: ar_sample(aic, fused_encode(aic, att, am), src)
            fn()
            readings = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                readings.append((time.perf_counter() - t0) * 1e3)
            out["core" if on else "plain"] = {
                "ms": sorted(readings)[2], "readings": readings}
        aic.set_attention_core(False)
    return out


def pb_w211(cs) -> dict:
    import torch
    model = cs.build("float32", "pb.yml")
    att, am = cs.features(cs.B, seed=37)
    att, am = att.to("cuda"), am.to("cuda")
    cs.shape_pb_plans([model], att, am)
    with torch.no_grad():
        r = cs.check_pb_decode(model, "float32", att, am, 211)
    return {"ms": r["ms"], "plain_ms": r["plain_ms"],
            "rounds": r["stats"]["rounds"], "launches": r["launches"]}


def main(root: str, label: str) -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_long_ab: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from boficap_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    built = _build.build()
    _build.kernels()
    out = {"label": label, "build_s": built["seconds"]}
    with torch.no_grad():
        out["digest"] = output_digests(digest_cases("cuda"))
        out["attention"] = attention_times(cs)
        model = cs.build("float32")
        errs = cs.check_grid_kernels(model)
        out["grid"] = cs.measure_grid(model)
        for dt, rows in out["grid"].items():
            for name, row in rows.items():
                row["rel_err"] = errs[dt][name]["rel_err"]
        out["split_196"] = split_196(cs, model)
        del model
        out["aic_grid_ms"] = aic_grid_ms(cs)
    out["pb_w211"] = pb_w211(cs)
    print("LONG " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
