"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port (``boficap_tpu_torch``).  The cell's configuration, traffic mix
and limits are found by name (``manifest.py``); the mix's ``kind`` names
the runner (``portbench/kinds/<kind>.py``) that builds the inputs from the
seed, warms every shape the cell uses, measures for ``--seconds`` and
checks what the timed path produced against the plain reference.
``--trace 1`` runs the profiler over the window and reports the per-layer
metrics instead of the end-to-end ones.

Standard output's last line is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each compared number with its limit); standard error ends
with the same comparisons.  Without a CUDA card, with fewer cards than the
cell asks for, or with JAX or the JAX package loaded, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.monotonic()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# names whose presence in sys.modules (by top-level name, whole) fails a run
FORBIDDEN = ("jax", "jaxlib", "flax", "boficap_tpu")


def process_age_s() -> float:
    """Seconds since this process started (from /proc where it can be
    read, else since this module was loaded)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - T_START


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the port's own nvcc builds already live in ``boficap_tpu_torch/_build``;
    these cover PyTorch's extension and Triton caches, and keep
    ``transformers`` from loading JAX, should the program come to use
    them (a later change to the program cannot edit this file)."""
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def run_cell(bench: dict, w: dict, seed: int, seconds: float, trace: bool,
             device) -> dict:
    """Run the cell ``w`` (a ``BENCHMARK.json`` workload entry) once on
    ``device`` and return its result object.  ``main`` looks for the card
    first; a test may hand the CPU here, where the kernel wrappers run
    their plain twins."""
    import torch
    from portbench import cell as cellmod
    from portbench import manifest
    cell = cellmod.Cell(
        name=w["name"], cfg=manifest.config(bench, w["config"]),
        traffic=manifest.traffic(w["traffic"]),
        limits=manifest.limits(w["name"]), seed=seed, seconds=seconds,
        trace=trace, device=device, age_s=process_age_s)
    out = manifest.runner(cell.traffic["kind"]).run(cell)
    if trace:
        metrics = manifest.read_metrics(bench, cell.name, out.run)
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {m["name"]: {"value": float(out.e2e[m["name"]]),
                               "unit": units[m["name"]]}
                   for m in manifest.end_to_end(bench, cell.name)}
    checks, ok = cellmod.checks(out.readings, cell.limits)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": w["chips"],
           "memory_peak_bytes": out.memory_peak}
    result = {"correct": ok and out.failed == 0, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if trace and out.run.trace is not None:
        dev["busy_s"] = out.run.trace.busy_s()
        dev["window_s"] = out.run.trace.window_s
        result["breakdown"] = {"device_ops": out.run.trace.device_ops(),
                               "idle_gaps": out.run.trace.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    sys.path.insert(0, ROOT)

    import torch
    from portbench import manifest

    bench = manifest.load(ROOT)
    w = manifest.workload(bench, args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA card; this benchmark runs only on one",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < w["chips"]:
        print(f"portbench: the cell asks for {w['chips']} cards, "
              f"{torch.cuda.device_count()} seen", file=sys.stderr)
        return 2
    result = run_cell(bench, w, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
