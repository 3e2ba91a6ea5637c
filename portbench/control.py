"""Readings for the output check's limits: on each seed, the program's
numbers after the cell's own timed call, judged by the float32 reference,
and the control's (the reference computed with float8 products, in the
program's place), in one process.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        [--batches 3] [--faults 0] [--out control.jsonl]

One JSON line a seed: the program's numbers (those the cell's limits
compare) and the control's (``ctrl_*``).  Offline: after ``batches``
batches; the control's number is the gap of the token the float8
reference puts first, at the same points.  Training: the first steps of
the mix; the control's numbers are the float8 reference's steps against
the float32 one's, and with ``--faults 1`` also ``half_*``: the program
with half of each batch left out (the mean taken over the rest).  A limit
lies above every program reading and below every control and fault
reading (PERF.md gives them).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def readings(cell, batches: int, control: str = "fp8",
             faults: bool = False) -> dict:
    """The program's and the control's readings on ``cell``."""
    if cell.traffic["kind"] == "train":
        return train_readings(cell, control, faults)
    import torch
    from portbench.cell import sync
    from portbench.kinds import offline
    from portbench.program import build_model
    tr = cell.traffic
    B, n = int(tr["batch"]), int(tr["store_images"])
    weights, att, am = offline.make_inputs(cell)
    model = build_model(cell.cfg, weights, cell.device)
    encode, dec = offline.program_step(model, tr)
    ring = torch.arange(B, device=cell.device)
    done = []
    with torch.no_grad():
        for i in range(batches):
            idx = (ring + (i * B) % n) % n
            m = am.index_select(0, idx)
            out = dec(encode(att.index_select(0, idx), m), m.bool())
            done.append((idx, out))
    sync(cell.device)
    s_att, s_am, outs = offline.sample_outputs(
        done, att, am, tr["served_tokens"], cell.seed, int(tr["sample"]))
    del model, done, att, am
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    return offline.judge(cell.cfg, weights, tr["check"], s_att, s_am, outs,
                         control=control)


@contextlib.contextmanager
def half_batch():
    """The program's XE step handed the first half of each batch's
    images: half of the batch left out, the mean taken over the rest."""
    from boficap_tpu_torch.train import steps
    whole = steps.to_device

    def half(batch, device):
        out = whole(batch, device)
        n = out["att_feats"].shape[0] // 2
        return {k: v[:n] for k, v in out.items()}
    steps.to_device = half
    try:
        yield
    finally:
        steps.to_device = whole


def train_readings(cell, control: str, faults: bool) -> dict:
    import torch
    from portbench.kinds import train
    from portbench.reference import compare
    n = int(cell.traffic["checked_steps"])
    weights, corpus, att, am, host = train.make_inputs(cell)
    on_card, weights = weights, train.to_host(weights)

    def program_steps():
        t = train.Trainer(cell, on_card, corpus, host)
        first = t.first_steps(n, weights)
        t.close()
        del t
        if cell.device.type == "cuda":
            torch.cuda.empty_cache()
        return first

    first = program_steps()
    ref = train.reference_readings(cell, weights, corpus, att, am,
                                   first["ids"])
    out = compare.train_gaps(first, ref)
    out["losses"] = first["loss"]
    ctl = train.reference_readings(cell, weights, corpus, att, am,
                                   first["ids"], quant=control)
    out.update({"ctrl_" + k: v for k, v in
                compare.train_gaps(ctl, ref).items()})
    if faults:
        with half_batch():
            bad = program_steps()
        out.update({"half_" + k: v for k, v in
                    compare.train_gaps(bad, ref).items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--batches", type=int, default=3,
                    help="batches of the timed call (offline cells)")
    ap.add_argument("--faults", type=int, choices=(0, 1), default=0,
                    help="also read the planted faults (training cells)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    from portbench import manifest
    from portbench.cell import Cell
    bench = manifest.load()
    w = manifest.workload(bench, args.workload)
    dev = (torch.device("cuda", 0) if torch.cuda.is_available()
           else torch.device("cpu"))
    for seed in [int(s) for s in args.seeds.split(",")]:
        cell = Cell(name=w["name"], cfg=manifest.config(bench, w["config"]),
                    traffic=manifest.traffic(w["traffic"]), limits={},
                    seed=seed, seconds=0.0, trace=False, device=dev,
                    age_s=lambda: 0.0)
        t = time.perf_counter()
        r = readings(cell, args.batches, faults=bool(args.faults))
        line = json.dumps({"workload": w["name"], "seed": seed,
                           "seconds": time.perf_counter() - t, **r})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
