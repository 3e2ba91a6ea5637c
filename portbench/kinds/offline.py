"""Offline captioning: a store of region features resident on the device,
captioned greedily in fixed batches taken from it in turn (a ring over the
store), one batch in flight while the next is enqueued.

The mix names what it drives and how it is judged, as data:

* ``encode``, ``decode``: the program's functions
  (``boficap_tpu_torch.<module>.<function>``), called as
  ``encode(model, feats, masks)`` and ``decode(model, memory, src_mask,
  **decode_kwargs)``; ``outputs``: the keys of the decode's result kept;
* ``served_tokens``: 'plan' (a caption serves its plan's words) or 'eos'
  (its words through the first EOS), to draw the longest into the sample;
* ``check``: the comparison (``reference.compare.na_gaps``);
* ``flops_per_caption``: the frozen count a caption
  (``roofline.counts.na_caption_flops``);
* ``rows_per_image``: rows a launch takes per image (beams; default 1);
* ``store_images``, ``regions``, ``live_min`` (live regions an image,
  drawn from live_min..regions), ``batch``, ``sample`` (captions the
  output check reads), ``trace_seconds``.

End-to-end: ``captions_per_s``, every caption of every batch enqueued in
the window over the time from the window's start to the last batch's end;
``setup_s``.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

from portbench import devtrace, gen, manifest, program
from portbench.cell import Outcome, RunData, Spans, memory_peak, sync
from portbench.reference import boficap_ref
from portbench.roofline import launches


def make_inputs(cell):
    cfg, tr, dev = cell.cfg, cell.traffic, cell.device
    weights = gen.model_weights(cfg, cell.seed, dev)
    att, am = gen.make_store(tr["store_images"], tr["regions"],
                             cfg["att_feat_size"], tr["live_min"], cell.seed,
                             dev)
    return weights, att, am


def program_step(model, tr: dict):
    """The mix's encode and decode over ``model``."""
    enc, dec = program.entry(tr["encode"]), program.entry(tr["decode"])
    kwargs, keys = tr.get("decode_kwargs", {}), tr["outputs"]

    def encode(x, m):
        return enc(model, x, m)

    def decode(mem, src):
        out = dec(model, mem, src, **kwargs)
        return {k: out[k] for k in keys}
    return encode, decode


def caption_lengths(served: str, out):
    """Tokens each caption served: the plan's words ('plan'), or the words
    through the first EOS ('eos')."""
    if served == "plan":
        return out["phrase_length"].sum(1)
    seq = out["seq"]
    eos = seq == boficap_ref.EOS
    L = seq.shape[1]
    return torch.where(eos.any(1), eos.float().argmax(1) + 1, L)


def run(cell) -> Outcome:
    cfg, tr, dev = cell.cfg, cell.traffic, cell.device
    B, n = int(tr["batch"]), int(tr["store_images"])
    weights, att, am = make_inputs(cell)
    model = program.build_model(cfg, weights, dev)
    encode, dec = program_step(model, tr)
    ring = torch.arange(B, device=dev)
    spans = Spans(False, dev)

    def one(i):
        with spans("upload"):
            idx = (ring + (i * B) % n) % n
            x, m = att.index_select(0, idx), am.index_select(0, idx)
        with spans("encode"):
            mem = encode(x, m)
        with spans("decode", host=True):
            out = dec(mem, m.bool())
        return idx, out

    with torch.no_grad():
        one(0)                                   # warm: the cell's one shape
        sync(dev)
    from boficap_tpu_torch import ops
    spans = Spans(cell.trace, dev)            # read by one() from here on
    ops.reset_launch_counts()
    prof = devtrace.start(cell.trace)
    setup_s = cell.age_s()
    done, flight = [], collections.deque()
    window = cell.window_s
    with torch.no_grad(), (torch.profiler.record_function(devtrace.WINDOW)
                           if prof else contextlib.nullcontext()):
        t0 = time.perf_counter()
        i = 0
        while True:
            idx, out = one(i)
            ev = torch.cuda.Event() if dev.type == "cuda" else None
            if ev is not None:
                ev.record()
            flight.append((idx, out, ev))
            i += 1
            if len(flight) > 1:
                with spans("wait"):
                    done.append(_finish(flight.popleft()))
            if time.perf_counter() - t0 >= window:
                break
        while flight:
            with spans("wait"):
                done.append(_finish(flight.popleft()))
        sync(dev)
        t1 = time.perf_counter()
    trace = (devtrace.collect(prof, ("upload", "encode", "decode", "wait"))
             if prof else None)
    launches_seen = {k: v for k, v in ops.launch_counts().items() if v}
    peak = memory_peak(dev)
    captions = B * len(done)
    elapsed = t1 - t0

    rd = RunData(kind="offline", window_s=elapsed, spans=spans.device_ms(),
                 launches=launches_seen, dtype=cfg["dtype"], trace=trace,
                 sizes=launches.sizes(
                     cfg, B * int(tr.get("rows_per_image", 1)),
                     tr["regions"]))
    rd.counts["captions"] = captions
    rd.counts["flops_per_caption"] = manifest.resolve(
        tr["flops_per_caption"])(cfg, tr["regions"])

    # the output check: a sample drawn from the seed of the captions the
    # window finished, the longest among them, judged once the program's
    # state is freed
    s_att, s_am, outs = sample_outputs(done, att, am, tr["served_tokens"],
                                       cell.seed, int(tr["sample"]))
    del model, done, flight, att, am, encode, dec
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = judge(cfg, weights, tr["check"], s_att, s_am, outs)
    e2e = {"captions_per_s": captions / elapsed, "setup_s": setup_s}
    return Outcome(e2e=e2e, readings=readings, attempted=captions, failed=0,
                   memory_peak=peak, run=rd)


def sample_outputs(done, att, am, served: str, seed: int, n: int):
    """``n`` captions of the finished batches ``done`` ([(store rows,
    outputs)]), drawn from the seed, the longest among them: their
    features, masks and outputs."""
    B = done[0][0].shape[0]
    lens = torch.stack([caption_lengths(served, o) for _, o in done])
    g = torch.Generator().manual_seed(gen.sub_seed(seed, "sample"))
    flat = torch.randperm(lens.numel(), generator=g)[:n - 1]
    flat = torch.cat([flat, lens.flatten().argmax().cpu()[None]])
    pick = list(zip((flat // B).tolist(), (flat % B).tolist()))
    rows = torch.stack([done[b][0][r] for b, r in pick])
    outs = {k: torch.stack([done[b][1][k][r] for b, r in pick])
            for k in done[0][1]}
    return att.index_select(0, rows), am.index_select(0, rows), outs


def judge(cfg, weights, check: str, att, am, outs, control=None):
    """The reference's readings of the sampled outputs (float32, TF32
    off); with ``control`` ('fp8'), the control's too."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = boficap_ref.Reference(weights, cfg)
        ctl = (boficap_ref.Reference(weights, cfg, quant=control)
               if control else None)
        return manifest.resolve(check)(ref, att, am, outs, control=ctl)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _finish(item):
    idx, out, ev = item
    if ev is not None:
        ev.synchronize()
    return idx, out
