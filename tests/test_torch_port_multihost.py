"""Multi-process training of the port on the CPU, against itself and the
JAX package's entry points: the port's training CLI as 2 OS processes x 2
gloo ranks (``--multihost``) against 1 process x 4 ranks, the RL stage
under the mesh, a rank's failure ending the run in bounded time, and
``graft_entry`` (``entry`` against JAX's
``__graft_entry__.entry`` on carried-over weights; ``dryrun_multichip(4)``
on 4 CPU ranks).

As the JAX package's ``tests/test_multihost.py``: every spawned process
has a timeout and is killed after it, and a pair whose bring-up fails is
retried once on a fresh port (gloo's first connections can skew under
host load); a correctness failure fails both attempts."""

import json
import os
import re
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from boficap_tpu_torch import graft_entry
from boficap_tpu_torch.config import parse_opt
from boficap_tpu_torch.convert import load_jax_params
from boficap_tpu_torch.parallel.mesh import free_port
from boficap_tpu_torch.tools import train as ttrain
from tests._torch_port_util import to_numpy_tree

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TIMEOUT = 240


def _start(ckpt, extra):
    cmd = [sys.executable, "-m", "boficap_tpu_torch.tools.train",
           "--cfg", os.path.join(ROOT, "configs", "synthetic_smoke.yml"),
           "--id", "mh", "--checkpoint_path", ckpt, "--device", "cpu",
           "--batch_size", "8", "--losses_log_every", "1",
           "--save_checkpoint_every", "2", "--language_eval", "0",
           "--val_images_use", "2", "--max_epochs", "1"] + extra
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=ROOT)


def _finish(procs):
    """Each process's (return code, output); every one killed at the
    timeout, and none left running."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        outs = [(None, "<timeout>")] * len(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _pair(tmp_path, extra, per_process):
    """2 processes of ``per_process`` ranks each, --multihost; one retry
    on a fresh port.  Returns (outputs, checkpoint dirs)."""
    for attempt in range(2):
        port = free_port()
        dirs = [str(tmp_path / f"a{attempt}" / f"p{p}") for p in (0, 1)]
        res = _finish([_start(dirs[p], [
            "--multihost", "1", "--dist_coordinator", f"localhost:{port}",
            "--dist_num_processes", "2", "--dist_process_id", str(p),
            "--mesh_shape", str(2 * per_process)] + extra) for p in (0, 1)])
        if all(rc == 0 for rc, _ in res):
            return [o for _, o in res], dirs
        sys.stderr.write("\n[multihost] bring-up failed "
                         f"{[rc for rc, _ in res]}; retrying once\n"
                         + "\n".join(o[-2000:] for _, o in res))
    for rc, out in res:
        assert rc == 0, out[-4000:]


def _losses(out):
    return [float(m.group(1)) for m in
            re.finditer(r"iter \d+ \(epoch \d+\) loss (-?[\d.]+)", out)]


def _jsonl_losses(ckpt):
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


def test_two_process_multihost_matches_single_process(tmp_path):
    """2 processes x 2 ranks print the same losses, equal bitwise (the
    lead's metrics.jsonl) to 1 process x 4 ranks; only rank 0's directory
    gets files."""
    outs, (ck0, ck1) = _pair(tmp_path, [], 2)
    for out in outs:
        assert "data-parallel mesh over 4 devices" in out
    l0, l1 = _losses(outs[0]), _losses(outs[1])
    assert len(l0) >= 2, outs[0][-2000:]
    assert l0 == l1
    for f in ("model.ckpt", "metrics.jsonl", "infos_mh.pkl",
              "histories_mh.pkl"):
        assert os.path.exists(os.path.join(ck0, f)), f
    assert not os.path.isdir(ck1) or not os.listdir(ck1)
    single = str(tmp_path / "single")
    (rc, out), = _finish([_start(single, ["--mesh_shape", "4"])])
    assert rc == 0, out[-4000:]
    assert "data-parallel mesh over 4 devices" in out
    assert _losses(out) == l0
    assert _jsonl_losses(single) == _jsonl_losses(ck0)


@pytest.mark.parametrize("extra", [
    ["--train_mode", "AIC", "--self_critical_after", "0"],
    ["--structure_after", "0"],
], ids=["scst", "structure"])
def test_two_process_multihost_rl_stage(tmp_path, extra):
    """The RL stage under --multihost (1 rank a process): each rank
    samples its images, the sampled ids are gathered for the host scorer,
    and both processes print the same losses."""
    outs, (ck0, _) = _pair(tmp_path, extra + [
        "--train_sample_n", "2", "--save_checkpoint_every", "99"], 1)
    l0, l1 = _losses(outs[0]), _losses(outs[1])
    assert len(l0) >= 2, outs[0][-2000:]
    assert l0 == l1
    with open(os.path.join(ck0, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert all("reward" in r for r in recs)


# a training CLI whose rank 1 raises in its second XE step: the patch
# runs at import, so in every spawned rank too (spawn re-runs this file)
_FAILS_AT_STEP_2 = """
import sys
sys.path.insert(0, {root!r})
import torch.distributed as dist
from boficap_tpu_torch.train import steps

_make = steps.make_xe_step


def make_xe_step(*a, **k):
    step, n = _make(*a, **k), [0]

    def failing(*x, **y):
        n[0] += 1
        if dist.get_rank() == 1 and n[0] == 2:
            raise RuntimeError("rank 1 fails at step 2")
        return step(*x, **y)
    return failing


steps.make_xe_step = make_xe_step

if __name__ == "__main__":
    from boficap_tpu_torch.tools import train
    train.main(sys.argv[1:])
"""

# rank 1 raises; rank 0 then waits where no collective will end it
_STUCK_AFTER_A_FAILED_RANK = """
import sys
import time
sys.path.insert(0, {root!r})
from boficap_tpu_torch.parallel import mesh


def body(rank, world, init):
    mesh.init_group(rank, world, init, "cpu", timeout_s=600)
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    time.sleep(600)


if __name__ == "__main__":
    mesh.FAILED_RANK_GRACE_S = 2.0
    mesh.launch(body, 2)
"""


def _run_script(tmp_path, text, args=()):
    """(return code, output, seconds) of ``text`` run as a script."""
    script = tmp_path / "script.py"
    script.write_text(text.format(root=ROOT))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    t0 = time.monotonic()
    p = subprocess.Popen([sys.executable, str(script), *args], cwd=ROOT,
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    (rc, out), = _finish([p])
    return rc, out, time.monotonic() - t0


def test_train_cli_fails_when_a_rank_fails(tmp_path):
    """Rank 1 of 2 raises in its second step: the CLI exits non-zero
    within a bounded time (rank 0's next collective fails on the dead
    rank; it does not wait out the group's timeout), after rank 0's
    crash-save."""
    rc, out, secs = _run_script(tmp_path, _FAILS_AT_STEP_2, [
        "--cfg", os.path.join(ROOT, "configs", "synthetic_smoke.yml"),
        "--id", "mhfail", "--checkpoint_path", str(tmp_path / "ck"),
        "--device", "cpu", "--batch_size", "8", "--mesh_shape", "2",
        "--language_eval", "0", "--max_epochs", "1"])
    assert rc not in (0, None), out[-3000:]
    assert secs < 120, secs
    assert "rank 1 fails at step 2" in out
    assert "Save ckpt on exception" in out


def test_launch_ends_a_rank_stuck_after_a_failed_rank(tmp_path):
    """A spawned rank fails while this process's rank waits where no
    collective will wake it (as a NCCL collective on a dead peer): the
    process ends within the grace after the failure, naming the rank."""
    rc, out, secs = _run_script(tmp_path, _STUCK_AFTER_A_FAILED_RANK)
    assert rc == 1, out[-3000:]
    assert secs < 60, secs
    assert "ranks [(1, 1)] (rank, exit code) failed and rank 0 did not " \
        "return within 2 s" in out


def test_multihost_flags_are_checked():
    """--multihost without its coordinator flags, or a global rank count
    that does not divide batch_size, raises ValueError."""
    base = ["--cfg", os.path.join(ROOT, "configs", "synthetic_smoke.yml"),
            "--device", "cpu", "--batch_size", "6"]
    with pytest.raises(ValueError, match="dist_coordinator"):
        ttrain.rank_plan(parse_opt(base + ["--multihost", "1"]))
    with pytest.raises(ValueError, match="divisible by the global device"):
        ttrain.rank_plan(parse_opt(base + [
            "--multihost", "1", "--dist_coordinator", "localhost:1",
            "--dist_num_processes", "2", "--dist_process_id", "0",
            "--mesh_shape", "4"]))
    assert ttrain.rank_plan(parse_opt(base)) is None


def test_graft_entry_matches_jax():
    """The port's entry() on the parameters of JAX's entry(): the same
    batch, and the loss within 1e-5."""
    import __graft_entry__ as jge
    jfn, jargs = jge.entry()
    want = float(jax.jit(jfn)(*jargs))
    fn, args = graft_entry.entry("cpu")
    model = args[0]
    load_jax_params(model, to_numpy_tree(jax.device_get(jargs[0])))
    for g, w in zip(args[1:], jargs[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = float(fn(*args))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_dryrun_multichip_4_cpu_ranks(capsys):
    """dp 2 x tp 2 on 4 gloo ranks: a finite step loss and the
    tensor-parallel decode token-identical to the single-device one."""
    out = graft_entry.dryrun_multichip(4, "cpu")
    assert (out["dp"], out["tp"]) == (2, 2)
    assert np.isfinite(out["loss"]) and out["seq_shape"] == (4, 20)
    assert "token-identical" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
