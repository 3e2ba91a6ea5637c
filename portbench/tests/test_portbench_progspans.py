"""The readers of the program's own spans and counters
(``portbench/progspans.py`` and the metrics that use it) on synthetic
traces and registries: a gap inside a span is put down to it, a step the
benchmark entered late leaves the program's spans where they ran, clocks
that drift apart or counts that differ read None, as does a program
without ``obs``; every metric this reads has its file and its cells."""

import pytest

from portbench import manifest, progspans
from portbench.cell import RunData
from portbench.devtrace import Trace

NEW = {"bound_ms.offline", "fill_ms.offline", "head_ms.offline",
       "ar_layers_ms.offline", "ar_step_ms.offline",
       "param_cast_mb.offline", "act_cast_mb.offline",
       "param_cast_mb.train", "act_cast_mb.train", "upload_host_ms.train",
       "idle_upload_ms.train", "idle_forward_ms.train",
       "idle_backward_ms.train", "idle_optimizer_ms.train"}
# the program's host clock (ns) stands this far from the profiler's clock
# (us)
HOST_US = 5_000_000.0


def _registry(calls, drift=(0.0, 0.0)):
    """The XE spans of each call, (name, start, end) in profiler us, as
    the program's registry holds them: host ns, device ms; the host clock
    of call k stands ``drift[k]`` us further off."""
    spans = {}
    for call, d in zip(calls, drift):
        for name, s, e in call:
            spans.setdefault(name, []).append(
                ((s + HOST_US + d) * 1e3, (e + HOST_US + d) * 1e3,
                 (e - s) * 1e-3))
    return {"spans": spans, "counts": {"cast_bytes.act": 6e6},
            "launches": {}}


CALLS = [
    [("bfc.xe.upload", 102, 200), ("bfc.xe.forward", 200, 500),
     ("bfc.xe.backward", 500, 800), ("bfc.xe.optimizer", 800, 1000)],
    [("bfc.xe.upload", 1202, 1290), ("bfc.xe.forward", 1290, 1600),
     ("bfc.xe.backward", 1600, 1900), ("bfc.xe.optimizer", 1900, 2100)],
]
# each entered 2 us before its upload
STEPS = [("step", 100, 1100), ("step", 1200, 2200)]
# busy intervals: gaps 150-250 (upload), 600-650 (backward), 1150-1200
# (between the steps), 1295-1400 (forward, 5 us after the second call's
# upload ended), 1950-1960 (optimizer); 0-100 before the first step
BUSY = [(100, 150), (250, 600), (650, 1150), (1200, 1295), (1400, 1950),
        (1960, 2300)]
WANT = {"upload": 0.1 / 2, "forward": 0.105 / 2, "backward": 0.05 / 2,
        "optimizer": 0.01 / 2}


def _train_run(steps=STEPS):
    tr = Trace(device=[("k", s, e) for s, e in BUSY], spans=list(steps),
               t0=0.0, t1=2300.0)
    return RunData(kind="train", window_s=2.3e-3, trace=tr,
                   counts={"steps": 2})


@pytest.fixture
def registry(monkeypatch):
    def use(reg):
        monkeypatch.setattr(progspans, "snapshot", lambda: reg)
    return use


def _idle(run):
    return {m: manifest.reader(f"idle_{m}_ms.train")(run)
            for m in ("upload", "forward", "backward", "optimizer")}


def test_a_gap_is_put_down_to_the_span_it_began_in(registry):
    registry(_registry(CALLS))
    got = _idle(_train_run())
    assert got == pytest.approx(WANT)
    # the gap between the steps and the one before the first are nobody's
    assert sum(got.values()) * 2 < 1e-3 * (2300 - sum(
        e - s for s, e in BUSY))


def test_a_late_entry_leaves_the_spans_where_they_ran(registry):
    """The benchmark entered the second step 300 us before the program's
    upload began (its event's record waited): anchored on that step, the
    second call's spans would run 298 us early and its forward would take
    the gap at 1150, which began before the step; on the step entered
    quickest, every span stays 2 us before where it ran."""
    registry(_registry(CALLS))
    late = [STEPS[0], ("step", 902, 2200)]
    assert _idle(_train_run(late)) == pytest.approx(WANT)
    spans = progspans.anchored(_train_run(late))
    ups = sorted(s for n, s, e in spans if n == "bfc.xe.upload")
    assert ups == pytest.approx([100, 1200])


def test_clocks_apart_or_counts_that_differ_read_none(registry):
    # the second call's stamps 300 us early: moved onto its step, the
    # first call's spans run 300 us past theirs
    registry(_registry(CALLS, drift=(0.0, -300.0)))
    assert set(_idle(_train_run()).values()) == {None}
    registry(_registry(CALLS, drift=(0.0, 50.0)))
    assert None not in _idle(_train_run()).values()
    assert set(_idle(_train_run(STEPS[:1])).values()) == {None}
    registry(_registry(CALLS[:1]))
    assert set(_idle(_train_run()).values()) == {None}


def test_no_trace_no_event_or_no_obs_reads_none(registry):
    reg = _registry(CALLS)
    registry(reg)
    run = _train_run()
    run.trace = None
    assert set(_idle(run).values()) == {None}
    for recs in reg["spans"].values():
        recs[:] = [(a, b, None) for a, b, _ in recs]
    assert set(_idle(_train_run()).values()) == {None}
    registry(None)
    for name in NEW:
        kind = "train" if name.endswith(".train") else "offline"
        run = RunData(kind=kind, window_s=1.0, trace=_train_run().trace,
                      spans={"decode": [1.0, 2.0]}, counts={"steps": 2})
        assert manifest.reader(name)(run) is None, name


def test_per_batch_and_per_step_readings(registry):
    reg = {"spans": {"bfc.na.bound": [(0, 2e6, 3.0), (5e6, 6e6, 5.0)],
                     "bfc.xe.upload": [(0, 4e6, None), (5e6, 7e6, None)]},
           "counts": {"cast_bytes.param": 3e6, "cast_bytes.act": 8e6},
           "launches": {}}
    registry(reg)
    off = RunData(kind="offline", spans={"decode": [9.0, 9.0]})
    assert manifest.reader("bound_ms.offline")(off) == pytest.approx(4.0)
    assert manifest.reader("fill_ms.offline")(off) is None
    assert manifest.reader("param_cast_mb.offline")(off) == pytest.approx(
        1.5)
    assert manifest.reader("act_cast_mb.offline")(off) == pytest.approx(4.0)
    assert manifest.reader("param_cast_mb.train")(off) is None
    train = RunData(kind="train", counts={"steps": 2})
    assert manifest.reader("upload_host_ms.train")(
        train) == pytest.approx(3.0)
    assert manifest.reader("act_cast_mb.train")(train) == pytest.approx(4.0)
    assert manifest.reader("bound_ms.offline")(train) is None


def test_every_new_metric_has_its_reader_and_cells():
    bench = manifest.load()
    by = {m["name"]: m for m in bench["per_layer"]}
    assert NEW <= set(by)
    cells = {w["name"] for w in bench["workloads"]}
    for name in NEW:
        assert callable(manifest.reader(name))
        assert by[name]["workloads"] and set(by[name]["workloads"]) <= cells
        kind = "train" if name.endswith(".train") else "offline"
        for cell in by[name]["workloads"]:
            assert ("train" in cell) == (kind == "train")
