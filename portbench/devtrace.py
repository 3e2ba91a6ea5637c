"""The traced run's readings: device activity from ``torch.profiler`` (CUDA
activities through CUPTI), host spans from the benchmark's own
``record_function`` labels around its calls into the program, and the
reduction of both to busy time, idle gaps and time by kernel.

The program's own kernels are told apart by name: every kernel of
``boficap_tpu_torch/csrc`` lives in the C++ namespace ``bfc``.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

PORT_KERNEL_MARK = "bfc::"
# the host span around the whole traced window
WINDOW = "portbench.window"
# device events that are copies and fills, not kernels
NOT_KERNELS = ("Memcpy", "Memset")


@dataclass
class Trace:
    """Device intervals (us) by name, host spans (us) by label, and the
    traced window (us)."""
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    t0: float = 0.0
    t1: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def merged(self) -> List[Tuple[float, float]]:
        """The union of the device intervals inside the window."""
        iv = sorted((max(s, self.t0), min(e, self.t1))
                    for _, s, e in self.device if e > self.t0 and s < self.t1)
        out: List[List[float]] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) * 1e-6

    def kernel_s(self, mark: str) -> float:
        """Summed device time of the kernels whose name holds ``mark``."""
        return sum(e - s for n, s, e in self.device if mark in n) * 1e-6

    def count(self, exclude=()) -> int:
        """Device events in the window, leaving out those whose name starts
        with one of ``exclude``."""
        return sum(1 for n, s, e in self.device
                   if self.t0 <= s < self.t1 and not n.startswith(exclude))

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s) * 1e-6
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], v] for n, v in rows]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The longest gaps between device work in the window, each named
        by the host span that was running when the device went idle."""
        merged = self.merged()
        edges = [self.t0] + [x for iv in merged for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        spans = sorted(self.spans, key=lambda x: x[1])
        starts = [a for _, a, _ in spans]
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            i = bisect.bisect_right(starts, s) - 1
            inside = i >= 0 and spans[i][1] <= s < spans[i][2]
            out.append([spans[i][0] if inside else "between spans",
                        (e - s) * 1e-6])
        return out


def start(enabled: bool):
    """A started profiler over CPU and CUDA activity, or None."""
    if not enabled:
        return None
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def collect(prof, labels) -> Trace:
    """Stop ``prof`` and keep its device events and the host spans named
    in ``labels``; the traced window is the host span ``WINDOW``."""
    prof.stop()
    tr = Trace()
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == cuda and (getattr(ev, "is_user_annotation",
                                               False) or ev.name == WINDOW
                                       or ev.name in labels):
            continue                  # a label's span copied onto the device
        if ev.device_type == cuda:
            tr.device.append((ev.name, s, e))
        elif ev.name == WINDOW:
            window = (s, e)
        elif ev.name in labels:
            tr.spans.append((ev.name, s, e))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    tr.t0, tr.t1 = window
    return tr
