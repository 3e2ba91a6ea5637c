"""The port's training updates, checkpoints and CLI against the JAX
package on the CPU, on shared weights at float32 with dropout off: the
parameters after three updates of each package's step under noam and a
plain rate, grad_accum 2 at equal token counts, ``optimizer.ckpt``
resumed across the two packages in both directions, the training CLI in a
subprocess (every file of the JAX layout, read by the JAX package, and a
``--start_from`` resume), and the eval loss (and decoding in train mode)."""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boficap_tpu.config import default_config as jax_default_config
from boficap_tpu.eval import eval_utils as jeu
from boficap_tpu.models.boficap import build_model as jax_build_model
from boficap_tpu.train import optim as joptim
from boficap_tpu.train import state as jstate
from boficap_tpu.train import steps as jsteps
from boficap_tpu_torch.config import make_config
from boficap_tpu_torch.convert import flax_layout, load_jax_params, to_jax_tree
from boficap_tpu_torch.eval import eval_utils as teu
from boficap_tpu_torch.train import optim as toptim
from boficap_tpu_torch.train import state as tstate
from boficap_tpu_torch.train import steps as tsteps
from tests._torch_port_train_util import (ROOT, UPDATE, built_cache, close,
                                          same_params, train_loader)
from tests._torch_port_util import L, R, VOCAB


NOAM = {"noamopt": True, "noamopt_warmup": 4}


@pytest.fixture(scope="module")
def built():
    return built_cache(jax_grads=False)


def _jax_cfg(**fields):
    cfg = jax_default_config()
    cfg.update(d_model=64, **fields)
    return cfg


def _jax_step(s, fields, grad_accum=1):
    """The JAX package's jitted step for ``fields``, made once per set of
    fields (its compile is shared between the tests)."""
    key = (tuple(sorted(fields.items())), grad_accum)
    if key not in s["jax_steps"]:
        tx = joptim.build_optimizer(_jax_cfg(**fields))
        s["jax_steps"][key] = (tx, jsteps.make_xe_step(s["jm"], tx,
                                                       grad_accum=grad_accum))
    return s["jax_steps"][key]


def _run_both(s, fields, steps=3, grad_accum=1, batch=None):
    """``steps`` updates of each package's make_xe_step from the shared
    weights; returns (jax params, params before)."""
    tm, start = s["tm"], s["start"]
    batch = s["batch"] if batch is None else batch
    tx, jstep = _jax_step(s, fields, grad_accum)
    state = jstate.create_state(s["params"], tx)
    layout = flax_layout(tm)
    opt = toptim.Optimizer(toptim.build_optimizer(make_config(
        d_model=64, **fields), layout), tm, layout)
    tstep = tsteps.make_xe_step(tm, opt, grad_accum=grad_accum)
    gen = torch.Generator()
    for i in range(steps):
        state, jm_ = jsteps.run_xe_step(jstep, state, batch,
                                        jax.random.PRNGKey(i))
        tm_ = tsteps.run_xe_step(tstep, batch, gen, device="cpu")
        close(tm_["loss"], jm_["loss"])
    return state, start, (jstep, tx)


@pytest.mark.parametrize("fields,kind", [
    (NOAM, "adam"),
    ({"optim": "sgd", "learning_rate": 0.05}, "sgd")], ids=["noam", "plain"])
def test_three_updates_match_jax(built, fields, kind):
    """UIC (self_dis): the parameters after three updates of each
    package's step (noam's Adam; the injected plain rate on SGD), within
    UPDATE[kind] of the largest update."""
    s = built("UIC")
    state, start, _ = _run_both(s, fields)
    same_params(s["tm"], state.params, start, s["grads"], UPDATE[kind])


def test_grad_accum_matches_jax(built):
    """grad_accum 2 over two images with equal token counts (image 1's
    captions are image 0's: the reference's per-microbatch normalisation
    then weights every caption alike)."""
    s = built("UIC")
    batch = dict(s["batch"])
    for k in tsteps.LABEL_KEYS:
        v = np.array(batch[k])
        v[1] = v[0]
        batch[k] = v
    state, start, _ = _run_both(s, {"optim": "sgd", "learning_rate": 0.05},
                                steps=2, grad_accum=2, batch=batch)
    same_params(s["tm"], state.params, start, s["grads"], UPDATE["sgd"])




# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def test_resume_across_packages(built, tmp_path):
    """JAX writes optimizer.ckpt after two steps, the port resumes and its
    third step gives JAX's third; then the port writes after two and JAX
    resumes for the third."""
    s = built("UIC")
    tm, batch, start = s["tm"], s["batch"], s["start"]
    jcfg = _jax_cfg(**NOAM)
    tx, jstep = _jax_step(s, NOAM)
    layout = flax_layout(tm)

    def port_opt():
        return toptim.Optimizer(toptim.build_optimizer(
            make_config(d_model=64, **NOAM), layout), tm, layout)

    # JAX -> port
    state = jstate.create_state(jax.tree_util.tree_map(jnp.asarray, start),
                                tx)
    for i in range(2):
        state, _ = jsteps.run_xe_step(jstep, state, batch,
                                      jax.random.PRNGKey(i))
    jdir = tmp_path / "jax"
    jcfg.update(checkpoint_path=str(jdir), id="x")
    jstate.save_checkpoint(jcfg, state, {"iter": 2}, {})
    state, _ = jsteps.run_xe_step(jstep, state, batch, jax.random.PRNGKey(2))
    opt = port_opt()
    tstate.resume_state({"start_from": str(jdir)}, tm, opt)
    assert opt.state["1"]["0"]["count"] == 2
    tsteps.run_xe_step(tsteps.make_xe_step(tm, opt), batch,
                       torch.Generator(), device="cpu")
    same_params(tm, state.params, start, s["grads"], UPDATE["adam"])

    # port -> JAX
    load_jax_params(tm, start)
    opt = port_opt()
    step = tsteps.make_xe_step(tm, opt)
    for _ in range(2):
        tsteps.run_xe_step(step, batch, torch.Generator(), device="cpu")
    tcfg = make_config(checkpoint_path=str(tmp_path / "port"), id="x")
    tstate.save_checkpoint(tcfg, to_jax_tree(tm), {"iter": 2},
                           optimizer=opt.state_tree(), histories={})
    fresh = jstate.create_state(jax.tree_util.tree_map(jnp.asarray, start),
                                tx)
    jcfg.update(start_from=str(tmp_path / "port"))
    resumed = jstate.resume_state(jcfg, fresh)
    assert int(resumed.opt_state[1][0].count) == 2
    resumed, _ = jsteps.run_xe_step(jstep, resumed, batch,
                                    jax.random.PRNGKey(2))
    tsteps.run_xe_step(step, batch, torch.Generator(), device="cpu")
    same_params(tm, resumed.params, start, s["grads"], UPDATE["adam"])


def _train_cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "boficap_tpu_torch.tools.train", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_train_cli_writes_jax_files_and_resumes(tmp_path):
    """The training CLI on configs/synthetic_smoke.yml (CPU): every file of
    the JAX package's layout, read by its load_params / load_infos /
    resume_state; then --start_from continues the iteration count with
    the saved optimizer state."""
    ck = tmp_path / "ckpt"
    base = ["--cfg", os.path.join(ROOT, "configs", "synthetic_smoke.yml"),
            "--id", "smoke", "--checkpoint_path", str(ck), "--device", "cpu"]
    out = _train_cli(base, str(tmp_path))
    assert "val[SAIC]" in out and "val[NAIC]" in out and "new best" in out
    for name in ("model.ckpt", "model_best.ckpt", "optimizer.ckpt",
                 "optimizer_best.ckpt", "infos_smoke.pkl",
                 "infos_smoke_best.pkl", "histories_smoke.pkl",
                 "histories_smoke_best.pkl"):
        assert (ck / name).is_file(), name
    infos = jstate.load_infos(str(ck), "smoke")
    with open(ck / "histories_smoke.pkl", "rb") as f:
        assert "val_result_history" in pickle.load(f)
    opt = jax_default_config()
    opt.update(infos["opt"])
    jm = jax_build_model(opt, infos["opt"]["vocab_size"])
    z = jnp.zeros((2, opt.max_length + 2), jnp.int32)
    template = jm.init({"params": jax.random.PRNGKey(0)},
                       jnp.zeros((2, 3, opt.att_feat_size)),
                       jnp.ones((2, 3)), z, jnp.ones((2,), jnp.int32), z, z,
                       glat_p=-1.0)
    params = jstate.load_params(str(ck / "model_best.ckpt"), template)
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(template))
    opt.update(start_from=str(ck))
    state = jstate.resume_state(
        opt, jstate.create_state(template, joptim.build_optimizer(opt)))
    assert int(state.opt_state[1][0].count) == infos["iter"]
    first = infos["iter"]
    out = _train_cli(base + ["--start_from", str(ck), "--max_epochs", "2"],
                     str(tmp_path))
    assert "mismatch" not in out
    infos2 = tstate.load_infos(str(ck), "smoke")
    assert infos2["iter"] > first and infos2["epoch"] == 2


def test_eval_in_train_mode_and_eval_loss_match_jax(built):
    """eval_split on a model left in train() mode decodes as in eval mode
    (dropout never reaches a decode), and its loss is JAX's eval loss."""
    s = built("UIC")
    jm, tm = s["jm"], s["tm"]
    kw = {"split": "test", "num_images": -1, "language_eval": 0,
          "verbose_loss": 1}
    want = jeu.eval_split(jm, s["params"], jax_loader(), dict(kw),
                          inference_mode="NAIC")
    got_eval = teu.eval_split(tm.eval(), train_loader("UIC", 3), dict(kw),
                              "NAIC")
    got_train = teu.eval_split(tm.train(), train_loader("UIC", 3),
                               dict(kw), "NAIC")
    tm.eval()
    assert [p["caption"] for p in got_train["predictions"]] == [
        p["caption"] for p in got_eval["predictions"]]
    assert got_train["loss"] == got_eval["loss"]
    close(got_eval["loss"], want["loss"])
    assert want["loss"] > 0


def jax_loader():
    from boficap_tpu.config import finalize
    from boficap_tpu.data import dataset as jds
    cfg = jax_default_config()
    cfg.update(train_mode="UIC", input_json="synthetic",
               input_att_dir="synthetic", batch_size=3, seq_per_img=2,
               max_boxes=R, max_length=L, data_prefetch=0)
    labels = jds.LabelStore.synthetic(n_images=20, vocab_size=VOCAB, L=L)
    return jds.CaptionData(finalize(cfg), labels=labels)
