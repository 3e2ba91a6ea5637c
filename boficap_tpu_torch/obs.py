"""Spans and counters inside the port, for a profiler's trace and for the
per-layer metrics that read them after a traced run.

``span(name)`` is a context manager and ``count(name, n)`` adds ``n`` to a
counter.  Both record only while a ``torch.profiler`` session is recording
(``torch.autograd.profiler._is_profiler_enabled``) or between ``enable()``
and ``disable()``; nothing in the program turns them on.  Off, a site costs
one flag check, and ``span`` hands back one shared no-op context: no CUDA
event, no allocation, no ``record_function``.  On, a span opens a
``record_function`` label under its name (so it sits in the profiler's
trace beside the device activity it launched), takes the host clock
(``time.perf_counter_ns``) at both ends and, once CUDA is initialised,
records a CUDA event on the current stream at both ends, from which its
device milliseconds are read.

The registry is this process's: it starts afresh when a profiler session
starts (a hook on ``torch.autograd.profiler._run_on_profiler_start``), on
``enable()`` and on ``reset()``.  ``snapshot()`` gives each span's records
in the order they closed, as (host start ns, host end ns, device ms or
None), each counter's total, and the kernel wrappers' launch counts
(``ops.launch_counts()``, which stay the one count of launches).  The
program records from one thread.

Span names start with ``bfc.``, so no span takes the name of a label a
caller of the program puts around its calls.  The sites:

* ``bfc.na.bound``, ``bfc.na.fill``, ``bfc.na.head``
  (``decode/bound_fill.py``): the bounding loop, the fill's decoder stack,
  the greedy head (or the plain generator, choice and entropy);
* ``bfc.ar.step`` (``decode/ar.py::ar_sample``, one a step) and, inside it,
  ``bfc.ar.layers`` (``models/boficap.py::ar_step``: the embedding and the
  cached decoder layers, before the vocabulary work);
* ``bfc.xe.upload``, ``bfc.xe.forward``, ``bfc.xe.backward``,
  ``bfc.xe.optimizer`` (``train/steps.py``): the batch's copy to the
  device, the forward and loss, autograd, the clip and update;
* counters ``cast_bytes.param`` and ``cast_bytes.act``
  (``models/layers.py::cast``): bytes written by each cast of a parameter,
  or of an activation, to another dtype;
* counters ``attend_calls.core`` and ``attend_calls.plain``
  (``models/layers.py::MultiHeadAttention.attend``): its calls that took
  the attention core, and those that took the plain path.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

_NOOP = contextlib.nullcontext()
# enable() / disable()
_forced = False
# span name -> [[host start ns, host end ns, start event or device ms, end
# event or None]] and counter name -> total
_spans: Dict[str, List[list]] = {}
_counts: Dict[str, float] = {}


def recording() -> bool:
    """Whether spans and counters record now."""
    return _forced or _profiler._is_profiler_enabled


def reset() -> None:
    """Empty the registry."""
    _spans.clear()
    _counts.clear()


def enable() -> None:
    """Record without a profiler session, into an emptied registry."""
    global _forced
    reset()
    _forced = True


def disable() -> None:
    global _forced
    _forced = False


def _event():
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    __slots__ = ("name", "label", "t0", "ev0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.label = torch.profiler.record_function(self.name)
        self.label.__enter__()
        self.t0 = time.perf_counter_ns()
        self.ev0 = _event()
        return self

    def __exit__(self, *exc):
        ev1 = _event()
        t1 = time.perf_counter_ns()
        self.label.__exit__(*exc)
        _spans.setdefault(self.name, []).append([self.t0, t1, self.ev0, ev1])
        return False


def span(name: str):
    """A context that records the block under ``name`` while recording."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _NOOP
    return _Span(name)


def count(name: str, n: float) -> None:
    """Add ``n`` to the counter ``name`` while recording."""
    if not (_forced or _profiler._is_profiler_enabled):
        return
    _counts[name] = _counts.get(name, 0) + n


def _device_ms(rec: list) -> Optional[float]:
    """A record's device milliseconds, read once (waiting for its end
    event) and kept in place of its events."""
    if rec[3] is not None:
        rec[3].synchronize()
        rec[2], rec[3] = rec[2].elapsed_time(rec[3]), None
    return rec[2]


def snapshot() -> dict:
    """{'spans': name -> [(host start ns, host end ns, device ms or
    None)], 'counts': name -> total, 'launches': ops.launch_counts()}."""
    from . import ops
    spans: Dict[str, List[Tuple[int, int, Optional[float]]]] = {
        name: [(r[0], r[1], _device_ms(r)) for r in recs]
        for name, recs in _spans.items()}
    return {"spans": spans, "counts": dict(_counts),
            "launches": ops.launch_counts()}


def _hook_profiler_start() -> None:
    """Empty the registry whenever a profiler session starts: wrap the
    function every ``torch.autograd.profiler`` session calls as it starts
    recording (where this PyTorch has it; without it only ``reset`` and
    ``enable`` empty the registry)."""
    start = getattr(_profiler, "_run_on_profiler_start", None)
    if start is None or getattr(start, "obs_hook", False):
        return

    def run_on_profiler_start():
        start()
        reset()

    run_on_profiler_start.obs_hook = True
    _profiler._run_on_profiler_start = run_on_profiler_start


_hook_profiler_start()
