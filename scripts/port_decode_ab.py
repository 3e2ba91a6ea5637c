"""Time the PyTorch/CUDA port's bf16 decodes in one checkout, for A/B runs.

    python3 scripts/port_decode_ab.py CHECKOUT LABEL

CHECKOUT is the root of a checkout of this repository (its
``boficap_tpu_torch`` and ``chip_smoke.py`` are imported from there, its
kernels built into its own ``_build``).  On one NVIDIA card, at B = 64 and
uic_sd / transformer.yml widths with the default bfloat16 dtype and random
weights (``chip_smoke.build``; the length head's "stop" shifted down as the
smoke's timed decodes), it prints one line ``AB {...}`` with:

  na_ms, sa_ms, ar_ms   medians of 9 / 9 / 5 decodes (fused encode + decode,
                        host clock to a synchronize; AR with the attention
                        core on), each with its readings;
  na_breakdown          chip_smoke.breakdown: device ms of encode, bound,
                        fill and head, host enqueue and wall ms;
  encoder_stack_ms      the encoder-stack kernel's device ms a call.

To compare two commits, run it in turns on both checkouts in one call on
one card (parent, change, change, parent): the decodes are bound by the
host, whose speed drifts within a call.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time


def median_ms(fn, n: int):
    import torch
    fn()
    readings = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        readings.append((time.perf_counter() - t0) * 1e3)
    return sorted(readings)[n // 2], readings


def main(root: str, label: str) -> int:
    import torch
    if not torch.cuda.is_available():
        print("port_decode_ab: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from boficap_tpu_torch.decode.ar import ar_sample
    from boficap_tpu_torch.decode.bound_fill import (fused_encode, na_decode,
                                                     sa_decode)
    from boficap_tpu_torch.ops import _build
    from boficap_tpu_torch.ops import stack as st
    torch.backends.cuda.matmul.allow_tf32 = False
    built = _build.build()
    _build.kernels()
    model = cs.build()
    with torch.no_grad():
        model.len_head2.bias[0] -= cs.STOP_SHIFT
        model.syn_head2.bias[4:7] += cs.STOP_SHIFT
    model.invalidate_packed()
    aic = cs.build(None, "transformer.yml")
    aic.set_attention_core(True)
    att, am = cs.features(cs.B, seed=5)
    att, am = att.to("cuda"), am.to("cuda")
    src = am.bool()
    out = {"label": label, "build_s": built["seconds"]}
    with torch.no_grad():
        for key, n, fn in (
                ("na", 9, lambda: na_decode(model, fused_encode(model, att, am),
                                            src, fused_fill=True)),
                ("sa", 9, lambda: sa_decode(model, fused_encode(model, att, am),
                                            src, fused_fill=True)),
                ("ar", 5, lambda: ar_sample(aic, fused_encode(aic, att, am),
                                            src))):
            out[f"{key}_ms"], out[f"{key}_readings"] = median_ms(fn, n)
        out["na_breakdown"] = cs.breakdown(model, att, am)
        enc = model.packed_encoder()
        x = model.embed_att(att)
        out["encoder_stack_ms"] = cs.device_ms(
            lambda: st.fused_encoder_stack_forward(
                x, src, enc.stack, enc.final_norm, model.num_heads))
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
