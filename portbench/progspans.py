"""The program's own spans and counters (``boficap_tpu_torch/obs.py``),
read by the per-layer metrics after a traced run.

While the profiler records, the program keeps its ``bfc.*`` spans (host
stamps on ``time.perf_counter_ns`` and device milliseconds from CUDA
events) and its counters in a registry of its own, which it empties when
the profiler starts; ``obs.snapshot()`` gives them.  A batch is one of the
benchmark's ``decode`` spans, a step one of its training steps.

The idle metrics put each device gap of the traced window down to the
program span the host was in when the gap began.  The profiler's event
times reach the benchmark only relative to its trace's own start, so the
program's host stamps are brought onto that clock by the benchmark's
``step`` spans: the k-th step's first program span (``bfc.xe.upload``) is
paired with the k-th ``step`` span, and each pair's difference of starts is
the offset of the two clocks less the benchmark's lateness entering the
step (its own CUDA event's record, which waits while the launch queue is
full: 0.1-2.8 ms on an H100).  All spans move by the largest difference,
the step entered quickest, and must then lie inside their steps: spans that
fall outside (clocks that drift apart, pairs that do not match) read None.
So every span sits early by the quickest step's lateness (115-125 us on an
H100), and no check here bounds it: a lateness alike in every step passes
unseen.  The idle put down to ``bfc.xe.upload``, where that lateness falls,
reads low by up to it a step (3-13% on an H100); the later spans' idle
lies within 0.1% of a split on the profiler's own times of the labels.

Every function returns None where the program has no ``obs`` module (a
checkout from before it), where the run kept no trace or recorded no CUDA
event, or where the counts of the paired spans differ: never a wrong
number.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

# rounding allowed where a moved span meets its step's edge, us
SLACK_US = 1.0
# the XE step's program spans, in the order they run, one after another;
# the first anchors a step
XE_SPANS = ("bfc.xe.upload", "bfc.xe.forward", "bfc.xe.backward",
            "bfc.xe.optimizer")


def snapshot() -> Optional[dict]:
    """The program's registry, or None without ``obs``."""
    try:
        from boficap_tpu_torch import obs
    except ImportError:
        return None
    return obs.snapshot()


def units(run) -> int:
    """Batches (offline) or steps (training) of the run's window."""
    if run.kind == "offline":
        return len(run.spans.get("decode", ()))
    return int(run.counts.get("steps", 0))


def device_ms(run, name: str) -> Optional[float]:
    """Device milliseconds a batch or step summed over the span ``name``."""
    snap, n = snapshot(), units(run)
    recs = (snap or {}).get("spans", {}).get(name)
    if not recs or not n or any(ms is None for _, _, ms in recs):
        return None
    return sum(ms for _, _, ms in recs) / n


def host_ms(run, name: str) -> Optional[float]:
    """Host milliseconds a batch or step summed over the span ``name``."""
    snap, n = snapshot(), units(run)
    recs = (snap or {}).get("spans", {}).get(name)
    if not recs or not n:
        return None
    return sum(t1 - t0 for t0, t1, _ in recs) / n / 1e6


def counter_mb(run, name: str) -> Optional[float]:
    """The counter ``name`` a batch or step, in MB (1e6 bytes)."""
    snap, n = snapshot(), units(run)
    if snap is None or not n or not snap["spans"]:
        return None
    return snap["counts"].get(name, 0) / n / 1e6


def gaps(trace) -> List[Tuple[float, float]]:
    """The device's idle gaps of the traced window (us), on the
    profiler's clock."""
    merged = trace.merged()
    edges = [trace.t0] + [x for iv in merged for x in iv] + [trace.t1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_by(trace, spans: List[Tuple[str, float, float]]
            ) -> Dict[str, float]:
    """Idle milliseconds of the window by the span (name, start us, end
    us; spans that follow one another) open when each gap began; gaps
    that began outside every span are left out."""
    pieces = sorted((s, e, name) for name, s, e in spans)
    starts = [p[0] for p in pieces]
    out = {name: 0.0 for name, _, _ in spans}
    for s, e in gaps(trace):
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < pieces[i][1]:
            out[pieces[i][2]] += (e - s) * 1e-3
    return out


def anchored(run) -> Optional[List[Tuple[str, float, float]]]:
    """The XE step's program spans on the profiler's clock (us), moved by
    the largest start difference of a step's first span and the
    benchmark's ``step`` span around it; None where they cannot be
    brought there (see the module's docstring)."""
    snap = snapshot()
    if snap is None or run.trace is None:
        return None
    recs = {n: sorted(snap["spans"].get(n, [])) for n in XE_SPANS}
    steps = sorted((s, e) for n, s, e in run.trace.spans if n == "step")
    if not steps or any(len(r) != len(steps) or any(
            ms is None for _, _, ms in r) for r in recs.values()):
        return None
    offset = max(b[0] - a[0] * 1e-3
                 for a, b in zip(recs[XE_SPANS[0]], steps))
    out = []
    for name, rs in recs.items():
        for (t0, t1, _), (s, e) in zip(rs, steps):
            a, b = t0 * 1e-3 + offset, t1 * 1e-3 + offset
            if a < s - SLACK_US or b > e + SLACK_US:
                return None
            out.append((name, a, b))
    return out


def idle_ms(run, name: str) -> Optional[float]:
    """Device idle milliseconds a step that began while the host was in
    the XE step's program span ``name``."""
    n = units(run)
    spans = anchored(run) if n else None
    if spans is None:
        return None
    return idle_by(run.trace, spans)[name] / n
