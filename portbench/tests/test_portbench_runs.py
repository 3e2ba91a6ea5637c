"""Whole runs of tiny cells on the CPU (the kernel wrappers run their plain
twins there): correct on the sound path, not correct with the timed path
broken underneath (a token altered where it is produced; in training a
state left unchanged, half of the batch left out, a gradient altered), no
JAX loaded; ``run.py`` refusing to run without a card or without the
program; and, on a card, the control failing the real cells' limits at
the cells' own widths."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import manifest
from portbench.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "boficap_tpu"}
OFFLINE = ["tiny_uic_sd.na_offline_b8192",
           "tiny_transformer.ar_offline_b16384"]
TRAIN = "tiny_uic_sd.xe_train_b512x5"

# faults planted in the program, each where its answer is produced
ALTER_NA = """
from boficap_tpu_torch.decode import bound_fill as _bf
_na = _bf.na_decode
def _broken(*a, **k):
    out = _na(*a, **k)
    out['seq'][:, 0] = (out['seq'][:, 0] + 1) % 44
    return out
_bf.na_decode = _broken
"""
ALTER_AR = ALTER_NA.replace("bound_fill as _bf", "ar as _bf").replace(
    "na_decode", "ar_sample")
# training: a step that leaves the state as it was
STATE_UNCHANGED = """
from boficap_tpu_torch.train import optim as _o
_o.Optimizer.step = lambda self, grads: None
"""
# training: half of each batch left out, the mean taken over the rest
HALF_BATCH = """
from portbench.control import half_batch
_fault = half_batch()
_fault.__enter__()
"""
# training: one leaf's gradient altered where the step hands it over
ALTER_GRAD = """
from boficap_tpu_torch.train import optim as _o
_step = _o.Optimizer.step
def _broken(self, grads):
    grads = list(grads)
    grads[0] = grads[0] * 2
    return _step(self, grads)
_o.Optimizer.step = _broken
"""
FAULTS = [(OFFLINE[0], ALTER_NA), (OFFLINE[1], ALTER_AR),
          (TRAIN, STATE_UNCHANGED), (TRAIN, HALF_BATCH), (TRAIN, ALTER_GRAD)]
MEMORY = {"train_peak_gb"}            # read on a card only


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", OFFLINE + [TRAIN])
def test_tiny_cell_runs_correct(tiny_root, cell, trace):
    res = tiny.run_cell(tiny_root, cell, trace=trace)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert not FORBIDDEN & set(res["modules"])
    assert "boficap_tpu_torch" in res["modules"]
    bench = manifest.load(tiny_root)
    if trace:
        assert "breakdown" in res and res["device"]["window_s"] > 0
        want = {m["name"] for m in manifest.per_layer(bench, cell)}
        assert set(res["metrics"]) <= want and res["metrics"]
    else:
        want = {m["name"] for m in manifest.end_to_end(bench, cell)}
        assert set(res["metrics"]) == want
        assert all(m["value"] > 0 for n, m in res["metrics"].items()
                   if n not in MEMORY)
    assert list(res)[-2] == "checks"


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=["na_token", "ar_token", "train_state",
                              "train_half_batch", "train_gradient"])
def test_fault_where_produced_fails(tiny_root, cell, fault):
    res = tiny.run_cell(tiny_root, cell, prelude=fault)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_run_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "uic_sd.na_offline_b8192", "--seed", str(2 ** 31 + 3), "--seconds",
         "1", "--trace", "0"], cwd=tiny.REPO, capture_output=True, text=True)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_run_without_the_program_fails(tiny_root, tmp_path):
    """A directory with only BENCHMARK.json and portbench/: no result."""
    import shutil
    bare = tmp_path / "bare"
    shutil.copytree(tiny_root, bare)
    code = tiny.RUN_CELL.format(name=OFFLINE[0], seed=5, seconds=0.2,
                                trace=False)
    env = dict(os.environ, PYTHONPATH=str(bare))
    p = subprocess.run([sys.executable, "-c", code], cwd=bare, env=env,
                       capture_output=True, text=True)
    assert p.returncode != 0
    assert "boficap_tpu_torch" in p.stderr
    assert p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell,size", [
    ("uic_sd.na_offline_b8192", {"batch": 512}),
    ("transformer.ar_offline_b16384", {"batch": 512}),
    ("uic_sd.xe_train_b512x5", {"images_per_step": 64})])
def test_control_fails_the_limits(cell, size):
    """At the cell's widths and a smaller batch, on three seeds: every
    program reading within its limit, the float8 control over one of
    them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from portbench import control
    from portbench.cell import Cell
    bench = manifest.load()
    w = manifest.workload(bench, cell)
    lim = {k: v for k, v in manifest.limits(cell).items()
           if not k.startswith("_")}
    tr = dict(manifest.traffic(w["traffic"]), **size)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        c = Cell(name=cell, cfg=manifest.config(bench, w["config"]),
                 traffic=tr, limits=lim, seed=seed, seconds=0.0,
                 trace=False, device=torch.device("cuda", 0),
                 age_s=lambda: 0.0)
        r = control.readings(c, batches=1)
        assert all(r[k] <= v for k, v in lim.items()), r
        assert any(r["ctrl_" + k] > v for k, v in lim.items()
                   if "ctrl_" + k in r), r
