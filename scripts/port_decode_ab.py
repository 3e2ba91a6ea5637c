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
  sa_breakdown          chip_smoke.sa_breakdown: device ms of encode,
                        predict, cross K/V, the fill by round kind (and a
                        round of each), head and other;
  kernel_ms             by dtype, the device ms a call (chip_smoke.device_ms)
                        of the attention core (#9, at the AR step's
                        cross-attention and an encoder self-attention), the
                        encoder and decoder layers and stacks (#1, #2, #4,
                        #5), the window layer and stacks (#8, #6, #7) and
                        the greedy head (#3), on the smoke's inputs;
  kernel_split          by dtype, torch.profiler's device ms a call of the
                        same #9 calls, #1, #2, #4 and #5, summed by building
                        block (products, attention, refnorm), with launches:
                        the kernels' own time without the launch, and the
                        norm's alone; for #2 and #5 also device_ms and
                        gap_ms, device_ms less the sum of the kernels' own
                        times (the dead time between dependent launches);
  digest                by dtype, a hash of every output of #9, #1, #2, #4,
                        #5, #8, #6 (the updated caches too) and #7 on the
                        smoke's inputs, and of the float32 NA and SA decodes
                        (fused kernels: the per-layer route): equal digests
                        across two checkouts mean bitwise equal outputs;
  products              at both dtypes, for each product of
                        chip_smoke.PRODUCTS (seeded operands, through
                        fused_linear) its device ms and a hash of its output,
                        and a hash of the head's ids: equal digests across
                        two checkouts mean bitwise equal outputs;
  grid                  past the row path's 128 keys, a 14 x 14 image grid
                        (196 regions): by dtype, chip_smoke.measure_grid's
                        row of #1, #2, #4-#9 (ms, plain, bound, library),
                        each with its error against its plain twin
                        (chip_smoke.check_grid_kernels, float32 weights).

To compare two commits, run it in turns on both checkouts in one call on
one card (parent, change, change, parent): the decodes are bound by the
host, whose speed drifts within a call.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import hashlib
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


def kernel_ms(cs, model):
    """Device ms a call of #9, #1, #2, #4, #5, #8, #6, #7 and #3 at both
    dtypes, on chip_smoke's inputs at B = 64 and the weights of
    ``model``."""
    import torch
    from boficap_tpu_torch.ops import attention as at
    from boficap_tpu_torch.ops import decoder_layer as dl
    from boficap_tpu_torch.ops import stack as st
    H = model.num_heads
    out = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        enc_w = dl.pack_encoder_layer(model.encoder.layer0, dtype)
        dec_w = dl.pack_layer_weights(model.decoder0.layer0, dtype)
        enc = st.pack_encoder_stack(model.encoder, dtype)
        dec = st.pack_decoder_stack(model._decoder("NA"), dtype)
        win = st.pack_window_weights(model._decoder("SA"), dtype)
        head = dl.pack_head_weights(model.generator.proj, dtype)
        x_enc, src, x_dec, mem, tgt, h = cs.layer_inputs(dtype, 4)
        xn, kc, vc, k2, v2, ws, tgn, srn = cs.window_inputs(dtype, cs.W_NARROW,
                                                            14)
        xw, _, _, _, _, _, tgw, srw = cs.window_inputs(dtype, cs.L, 15,
                                                       wide=True)
        cases = cs.attention_cases(dtype)
        aq, ak, av, am = cases["ar_cross"]
        eq, ek, ev, em = cases["encoder_self"]
        calls = {
            "attention_core": lambda: at.attention_core(aq, ak, av, am),
            "attention_core_encoder_self": lambda: at.attention_core(
                eq, ek, ev, em),
            "encoder_layer": lambda: dl.fused_encoder_layer(x_enc, src, enc_w,
                                                            H),
            "decoder_layer": lambda: dl.fused_decoder_layer(
                x_dec, mem, tgt, src, dec_w, H),
            "encoder_stack": lambda: st.fused_encoder_stack_forward(
                x_enc, src, enc.stack, enc.final_norm, H),
            "decoder_stack": lambda: st.fused_decoder_stack_forward(
                x_dec, mem, tgt, src, dec.stack, dec.final_norm, H),
            "window_layer": lambda: dl.fused_window_decoder_layer(
                xn, kc[0], vc[0], k2[0], v2[0], tgn, srn, win.layers[0], H),
            "window_stack": lambda: st.fused_window_decoder_stack(
                xn, ws, kc, vc, k2, v2, tgn, srn, win.stack, win.final_norm,
                H),
            "window_wide_stack": lambda: st.fused_window_wide_stack(
                xw, k2, v2, tgw, srw, win.stack, win.final_norm, H),
            "greedy_head": lambda: dl.fused_greedy_head(h, *head)}
        out[name] = {k: cs.device_ms(fn) for k, fn in calls.items()}
    return out


SPLIT_PARTS = {"products": "gemm", "attention": "attention",
               "refnorm": "refnorm_kernel"}


def digest(t):
    import torch
    return hashlib.sha256(t.cpu().contiguous().view(-1).view(torch.uint8)
                          .numpy().tobytes()).hexdigest()[:16]


def kernel_calls(cs, model, dtype):
    """The kernel calls that kernel_split and digest run, by name: each a
    function returning its outputs, on the smoke's inputs at B = 64."""
    from boficap_tpu_torch.ops import attention as at
    from boficap_tpu_torch.ops import decoder_layer as dl
    from boficap_tpu_torch.ops import stack as st
    H = model.num_heads
    enc_w = dl.pack_encoder_layer(model.encoder.layer0, dtype)
    dec_w = dl.pack_layer_weights(model.decoder0.layer0, dtype)
    enc = st.pack_encoder_stack(model.encoder, dtype)
    dec = st.pack_decoder_stack(model._decoder("NA"), dtype)
    win = st.pack_window_weights(model._decoder("SA"), dtype)
    x_enc, src, x_dec, mem, tgt, _ = cs.layer_inputs(dtype, 4)
    xn, kc, vc, k2, v2, ws, tgn, srn = cs.window_inputs(dtype, cs.W_NARROW, 14)
    xw, _, _, _, _, _, tgw, srw = cs.window_inputs(dtype, cs.L, 15, wide=True)
    cases = cs.attention_cases(dtype)
    return {
        "attention_core": lambda: (at.attention_core(*cases["ar_cross"]),),
        "attention_core_encoder_self": lambda: (
            at.attention_core(*cases["encoder_self"]),),
        "encoder_layer": lambda: (dl.fused_encoder_layer(x_enc, src, enc_w,
                                                         H),),
        "decoder_layer": lambda: (dl.fused_decoder_layer(
            x_dec, mem, tgt, src, dec_w, H),),
        "encoder_stack": lambda: (st.fused_encoder_stack_forward(
            x_enc, src, enc.stack, enc.final_norm, H),),
        "decoder_stack": lambda: (st.fused_decoder_stack_forward(
            x_dec, mem, tgt, src, dec.stack, dec.final_norm, H),),
        "window_layer": lambda: dl.fused_window_decoder_layer(
            xn, kc[0], vc[0], k2[0], v2[0], tgn, srn, win.layers[0], H),
        # the narrow round updates its caches in place: fresh copies a call
        "window_stack": lambda: st.fused_window_decoder_stack(
            xn, ws, kc.clone(), vc.clone(), k2, v2, tgn, srn, win.stack,
            win.final_norm, H),
        "window_wide_stack": lambda: st.fused_window_wide_stack(
            xw, k2, v2, tgw, srw, win.stack, win.final_norm, H)}


def kernel_split(cs, model):
    """torch.profiler's device ms a call of #9 (AR cross, encoder self),
    #1, #2, #4 and #5 at both dtypes, by building block
    (chip_smoke.profile_split), with launches a call; for #2 and #5 also
    the call's device_ms and its gap_ms (device_ms less the sum of the
    kernels' own times)."""
    import torch
    out = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        calls = kernel_calls(cs, model, dtype)
        out[name] = {k: cs.profile_split(calls[k], SPLIT_PARTS)
                     for k in ("attention_core", "attention_core_encoder_self",
                               "encoder_layer", "decoder_layer",
                               "encoder_stack", "decoder_stack")}
        for k in ("decoder_layer", "decoder_stack"):
            split = out[name][k]
            own = sum(split[f"{p}_ms"] for p in (*SPLIT_PARTS, "other"))
            split["device_ms"] = cs.device_ms(calls[k])
            split["gap_ms"] = split["device_ms"] - own
    return out


def digests(cs, model):
    """A hash of each kernel call's outputs at both dtypes, and of the
    float32 NA and SA decodes on the fused (per-layer) route."""
    import torch
    from boficap_tpu_torch.decode.bound_fill import (fused_encode, na_decode,
                                                     sa_decode)
    out = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        out[name] = {k: [digest(t) for t in fn()]
                     for k, fn in kernel_calls(cs, model, dtype).items()}
    m32 = cs.build("float32")
    with torch.no_grad():
        m32.len_head2.bias[0] -= cs.STOP_SHIFT
        m32.syn_head2.bias[4:7] += cs.STOP_SHIFT
    m32.invalidate_packed()
    att, am = cs.features(cs.B, seed=5)
    att, am = att.to("cuda"), am.to("cuda")
    for key, decode in (("na_decode", na_decode), ("sa_decode", sa_decode)):
        res = decode(m32, fused_encode(m32, att, am), am.bool(),
                     fused_fill=True)
        out["float32"][key] = {k: digest(v) for k, v in sorted(res.items())
                               if torch.is_tensor(v)}
    return out


def products(cs, model):
    """Each product of the smoke's PRODUCTS shapes through fused_linear, on
    operands made here from a seed, at both dtypes: sha256 (16 hex digits)
    of its output and its device ms a call (chip_smoke.device_ms); and the
    digest of the head's ids at B * L rows."""
    import torch
    from boficap_tpu_torch.ops import decoder_layer as dl

    out = {"digest": {}, "ms": {}}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        dig = out["digest"][name] = {}
        ms = out["ms"][name] = {}
        g = torch.Generator().manual_seed(31)
        for key, M, K, N, relu, residual in cs.PRODUCTS:
            a = torch.randn((M, K), generator=g).to("cuda", dtype)
            w = (torch.randn((K, N), generator=g) / K ** 0.5).to("cuda",
                                                                 dtype)
            b = (0.1 * torch.randn((N,), generator=g)).to("cuda", dtype)
            r = (torch.randn((M, N), generator=g).to("cuda", dtype)
                 if residual else None)
            dig[key] = digest(dl.fused_linear(a, w, b, relu, r))
            ms[key] = cs.device_ms(lambda: dl.fused_linear(a, w, b, relu, r))
        h = cs.layer_inputs(dtype, 4)[-1]
        head = dl.pack_head_weights(model.generator.proj, dtype)
        dig["greedy_head_ids"] = digest(dl.fused_greedy_head(h, *head)[0])
    return out


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
        out["sa_breakdown"] = cs.sa_breakdown(model, att, am)
        out["kernel_ms"] = kernel_ms(cs, model)
        out["kernel_split"] = kernel_split(cs, model)
        out["digest"] = digests(cs, model)
        out["products"] = products(cs, model)
        grid_model = cs.build("float32")
        errs = cs.check_grid_kernels(grid_model)
        out["grid"] = cs.measure_grid(grid_model)
        for dt, rows in out["grid"].items():
            for name, row in rows.items():
                row["rel_err"] = errs[dt][name]["rel_err"]
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
