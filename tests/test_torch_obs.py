"""The port's spans and counters (``boficap_tpu_torch/obs.py``) on the CPU:
off, nothing is recorded and no CUDA event made; under a profiler session
every span of the NA decode, the AR decode and the XE step appears once a
call (``bfc.ar.*`` once a step), nested as documented, in the registry and
in the profiler's events; the cast counters against the bytes a cast
writes; a new session empties the registry; no span takes a name the
benchmark gives its own labels."""

from __future__ import annotations

import glob
import os
import re
import time

import numpy as np
import pytest
import torch

from boficap_tpu_torch import obs
from boficap_tpu_torch.config import make_config
from boficap_tpu_torch.convert import flax_layout, init_params
from boficap_tpu_torch.data import dataset as tds
from boficap_tpu_torch.decode import ar as ar_mod
from boficap_tpu_torch.decode import bound_fill as bf
from boficap_tpu_torch.models import layers
from boficap_tpu_torch.train import optim
from boficap_tpu_torch.train import steps as steps_mod

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
L, R, VOCAB = 6, 5, 20
TINY = dict(N_enc=1, N_dec=1, d_model=32, d_ff=64, num_att_heads=4,
            max_length=L, att_feat_size=2048, max_boxes=R, dtype="float32")

# each path's spans: how many a call, and the span each nests in (None:
# directly in the call)
SPANS = {
    "na": {"bfc.na.bound": (1, None), "bfc.na.fill": (1, None),
           "bfc.na.head": (1, None)},
    "ar": {"bfc.ar.step": (L, None), "bfc.ar.layers": (L, "bfc.ar.step")},
    "xe": {"bfc.xe.upload": (1, None), "bfc.xe.forward": (1, None),
           "bfc.xe.backward": (1, None), "bfc.xe.optimizer": (1, None)},
}


def _model(mode: str, device="cpu"):
    cfg = make_config(train_mode=mode, **TINY)
    return cfg, init_params(cfg, VOCAB, seed=0, device=device)


def _feats(B: int = 3, device="cpu"):
    rs = np.random.RandomState(0)
    att = torch.from_numpy(rs.randn(B, R, 2048).astype(np.float32))
    am = torch.ones(B, R)
    am[0, -2:] = 0
    return att.to(device), am.to(device)


def _na(device="cpu"):
    _, model = _model("UIC", device)
    att, am = _feats(device=device)
    mem = bf.fused_encode(model, att, am)
    return lambda: bf.na_decode(model, mem, am.bool(), fused_fill=True)


def _ar(device="cpu"):
    _, model = _model("AIC", device)
    att, am = _feats(device=device)
    mem = model.encode(att, am)
    return lambda: ar_mod.ar_sample(model, mem, am.bool())


def _xe(device="cpu"):
    cfg, model = _model("UIC", device)
    cfg.update(input_json="synthetic", input_att_dir="synthetic",
               batch_size=2, seq_per_img=2, data_prefetch=0)
    loader = tds.CaptionData(cfg, labels=tds.LabelStore.synthetic(
        n_images=20, vocab_size=VOCAB, L=L))
    layout = flax_layout(model)
    opt = optim.Optimizer(optim.build_optimizer(cfg, layout), model, layout)
    step = steps_mod.make_xe_step(model, opt)
    batch = loader.get_batch("train")
    rng = torch.Generator(device=device).manual_seed(0)
    return lambda: steps_mod.run_xe_step(step, batch, rng,
                                         device=torch.device(device))


PATHS = {"na": _na, "ar": _ar, "xe": _xe}


class FakeEvent:
    """A CUDA event's interface on the host clock, counting those made."""
    made = 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture(autouse=True)
def _fresh_registry():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


@pytest.mark.parametrize("path", sorted(PATHS))
def test_off_records_nothing(path, monkeypatch):
    """With no profiler recording nothing is kept and no CUDA event is
    made, even where CUDA would be there; after ``enable()`` each span
    takes two events and reads device milliseconds."""
    run = PATHS[path]()
    FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert not obs.recording()
    run()
    snap = obs.snapshot()
    assert snap["spans"] == {} and snap["counts"] == {}
    assert FakeEvent.made == 0
    assert obs.span("bfc.any") is obs.span("bfc.other")
    obs.enable()
    run()
    obs.disable()
    spans = obs.snapshot()["spans"]
    assert {k: len(v) for k, v in spans.items()} == {
        k: n for k, (n, _) in SPANS[path].items()}
    assert FakeEvent.made == 2 * sum(n for n, _ in SPANS[path].values())
    for recs in spans.values():
        for t0, t1, ms in recs:
            assert t0 <= t1 and ms is not None and ms >= 0


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_under_a_profiler(path):
    """Under a CPU profiler session each span appears in the registry and
    among the profiler's events, once a call (the AR spans once a step),
    each inside the span the table names and the top ones one after
    another, in the registry's host stamps and in the profiler's times."""
    run = PATHS[path]()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    spans = obs.snapshot()["spans"]
    want = SPANS[path]
    assert {k: len(v) for k, v in spans.items()} == {
        k: n for k, (n, _) in want.items()}
    events = {}
    for ev in prof.events():
        if ev.name.startswith("bfc."):
            events.setdefault(ev.name, []).append(
                (ev.time_range.start, ev.time_range.end))
    assert {k: len(v) for k, v in events.items()} == {
        k: n for k, (n, _) in want.items()}
    for got in ({k: [(a, b) for a, b, _ in v] for k, v in spans.items()},
                events):
        for name, (_, parent) in want.items():
            for i, iv in enumerate(sorted(got[name])):
                if parent is not None:
                    assert _inside(iv, sorted(got[parent])[i])
        tops = sorted(iv for name, (_, parent) in want.items()
                      if parent is None for iv in got[name])
        for a, b in zip(tops, tops[1:]):
            assert a[1] <= b[0]
    assert all(ms is None for v in spans.values() for _, _, ms in v)


def test_new_session_starts_afresh():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with obs.span("bfc.first"):
            obs.count("cast_bytes.act", 3)
    assert set(obs.snapshot()["spans"]) == {"bfc.first"}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert obs.snapshot()["spans"] == {}
        assert obs.snapshot()["counts"] == {}
        with obs.span("bfc.second"):
            pass
    snap = obs.snapshot()
    assert set(snap["spans"]) == {"bfc.second"} and snap["counts"] == {}
    from boficap_tpu_torch import ops
    assert snap["launches"] == ops.launch_counts()


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_dense_casts_counted(compute):
    """One ``Dense`` call at ``compute`` over float32 parameters: the
    parameter casts write (out x in + out) elements, the input's cast B x
    in, each at the compute dtype's size; a float32 layer casts nothing."""
    dt = getattr(torch, compute)
    d = layers.Dense(16, 8, dtype=dt)
    x = torch.randn(3, 16)
    size = torch.tensor([], dtype=dt).element_size()
    obs.enable()
    d(x)
    counts = obs.snapshot()["counts"]
    if compute == "float32":
        assert counts.get(layers.PARAM, 0) == 0
        assert counts.get(layers.ACT, 0) == 0
    else:
        assert counts[layers.PARAM] == (8 * 16 + 8) * size
        assert counts[layers.ACT] == 3 * 16 * size
    obs.reset()
    d(x.to(dt))
    assert obs.snapshot()["counts"].get(layers.ACT, 0) == 0


def _program_span_names():
    names = set()
    for path in glob.glob(os.path.join(ROOT, "boficap_tpu_torch", "**",
                                       "*.py"), recursive=True):
        with open(path) as f:
            names |= set(re.findall(r'obs\.span\("([^"]+)"\)', f.read()))
    return names


def _benchmark_labels():
    labels = set()
    files = [os.path.join(ROOT, "portbench", "devtrace.py")] + glob.glob(
        os.path.join(ROOT, "portbench", "kinds", "*.py"))
    for path in files:
        with open(path) as f:
            text = f.read()
        labels |= set(re.findall(r'spans\("([^"]+)"', text))
        labels |= set(re.findall(r'WINDOW = "([^"]+)"', text))
        for group in re.findall(r"collect\(prof, \(([^)]*)\)", text):
            labels |= set(re.findall(r'"([^"]+)"', group))
    return labels


def test_span_names_leave_the_benchmark_labels_alone():
    """Every span of the program is one of the documented ``bfc.`` spans,
    and none takes a name the benchmark gives its own labels."""
    names = _program_span_names()
    labels = _benchmark_labels()
    assert {"portbench.window", "upload", "encode", "decode", "wait",
            "batch", "step"} <= labels
    assert names == {n for v in SPANS.values() for n in v}
    assert all(n.startswith("bfc.") for n in names)
    assert not names & labels


def test_smoke_profile_leaves_labels_out():
    """``chip_smoke.device_rows`` keeps the card's kernels and leaves out a
    label's span copied onto the device (a CUDA row marked as a user
    annotation, such as a ``bfc.*`` span) and rows with no device time."""
    import types
    import chip_smoke

    def row(key, us, count, device, annotation=False):
        return types.SimpleNamespace(
            key=key, self_device_time_total=us, count=count,
            device_type=device, is_user_annotation=annotation)
    rows = [row("bfc.na.bound", 900.0, 1, "DeviceType.CUDA", True),
            row("gemm_kernel", 300.0, 4, "DeviceType.CUDA"),
            row("copy_kernel", 50.0, 2, "DeviceType.CUDA"),
            row("aten::mm", 0.0, 4, "DeviceType.CPU"),
            row("bfc.na.fill", 0.0, 1, "DeviceType.CPU")]
    assert chip_smoke.device_rows(rows) == [(300.0, "gemm_kernel", 4),
                                            (50.0, "copy_kernel", 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(PATHS))
def test_smoke_profile_counts_no_span(path, monkeypatch):
    """On the card ``chip_smoke.profile_decode`` of one call (its profiler
    turns the spans on) counts the kernels it counts with every span site
    off, keeps its busy time within the call, and lists no span among the
    kernels."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the profile reads the card's kernels")
    from boficap_tpu_torch.ops import _build
    if _build.find_nvcc() is None:
        pytest.skip(f"no nvcc: {_build.probe()}")
    _build.kernels()
    import chip_smoke
    run = PATHS[path]("cuda")
    on = chip_smoke.profile_decode(run)
    assert set(obs.snapshot()["spans"]) == set(SPANS[path])
    monkeypatch.setattr(obs, "span", lambda name: obs._NOOP)
    off = chip_smoke.profile_decode(run)
    assert on["cuda_kernels"] == off["cuda_kernels"] > 0
    assert on["device_busy_ms"] <= on["wall_ms"]
    assert not any(k["name"].startswith("bfc.") for k in on["top_kernels"])
