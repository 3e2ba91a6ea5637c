"""What a kind's runner is handed (``Cell``) and what it hands back
(``Outcome``, with the per-layer readings in ``RunData``)."""

from __future__ import annotations

import contextlib
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch


@dataclass
class Cell:
    name: str
    cfg: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    age_s: Callable[[], float]

    @property
    def window_s(self) -> float:
        """The measured window: ``--seconds``, or in a traced run at most
        the mix's ``trace_seconds`` (the profiler's trace grows with every
        kernel it records)."""
        if self.trace and "trace_seconds" in self.traffic:
            return min(self.seconds, float(self.traffic["trace_seconds"]))
        return self.seconds


@dataclass
class RunData:
    """What the per-layer readers (``portbench/metrics``) read."""
    kind: str
    window_s: float = 0.0
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counts: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    # the cell's sizes (``roofline/launches.py``)
    sizes: Dict[str, int] = field(default_factory=dict)
    dtype: str = "bfloat16"
    trace: Any = None

    def mean(self, span: str) -> Optional[float]:
        v = self.spans.get(span)
        return statistics.fmean(v) if v else None


@dataclass
class Outcome:
    e2e: Dict[str, float]
    readings: Dict[str, float]
    attempted: int
    failed: int
    memory_peak: int
    run: RunData


class Spans:
    """The benchmark's own spans around its calls into the program: with
    ``on``, a ``record_function`` label for the profiler and CUDA events
    for each span's device time; off, nothing at all."""

    def __init__(self, on: bool, device: torch.device):
        self.on = on and device.type == "cuda"
        self.pending: List[tuple] = []
        self.host: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, host: bool = False):
        if not self.on:
            yield
            return
        from torch.profiler import record_function
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with record_function(name):
            a.record()
            t = time.perf_counter()
            yield
            if host:
                self.host.setdefault(name + "_host", []).append(
                    (time.perf_counter() - t) * 1e3)
            b.record()
        self.pending.append((name, a, b))

    def device_ms(self) -> Dict[str, List[float]]:
        """Each span's device milliseconds (call after a synchronize)."""
        out: Dict[str, List[float]] = dict(self.host)
        for name, a, b in self.pending:
            out.setdefault(name, []).append(a.elapsed_time(b))
        return out


def checks(readings: Dict[str, float], limits: dict):
    """Each compared number beside its limit (``limits``: number name ->
    limit; keys starting with ``_`` are notes).  Returns (checks, ok): ok
    when every number was read and lies at or below its limit; a null
    limit is not set yet and fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        if name.startswith("_"):
            continue
        value = readings.get(name)
        out[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and limit is not None and (
            value <= limit)
    return out, ok and bool(out)


def memory_peak(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
