"""The port's optimizers and schedules (``boficap_tpu_torch/train/optim.py``)
against optax and the JAX package's ``train/optim.py``: three updates of a
small parameter tree for every ``optim`` kind, both clips, coupled weight
decay, noam and the fused Adam; the state tree against the bytes flax
writes; the schedules and ``PlateauTracker``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from boficap_tpu.config import default_config as jax_default_config
from boficap_tpu.train import optim as joptim
from boficap_tpu_torch.config import make_config
from boficap_tpu_torch.convert import flax_layout, to_jax_tree
from boficap_tpu_torch.models.layers import DecoderLayer
from boficap_tpu_torch.train import optim as toptim
from boficap_tpu_torch.utils.flax_msgpack import msgpack_restore

STEPS = 3


def _layer(seed=0):
    """A small port module (Dense kernels transposed against flax, biases,
    norm scales) with seeded weights, and its flax tree."""
    torch.manual_seed(seed)
    m = DecoderLayer(8, 16, 2)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape) * 0.5)
    return m


def _grads(m, step):
    rs = np.random.RandomState(100 + step)
    # some values above the 0.1 value clip, some below
    return [torch.from_numpy((rs.randn(*p.shape) * 0.2).astype(np.float32))
            for _, p in m.named_parameters()]


def _jax_tree(m, tensors):
    from boficap_tpu_torch.convert import tree_from_named
    names = [n for n, _ in m.named_parameters()]
    return jax.tree_util.tree_map(
        jnp.asarray, tree_from_named(dict(zip(names, tensors)),
                                     flax_layout(m)))


CASES = {
    "adam": {}, "adam_norm_clip": {"grad_clip_mode": "norm",
                                   "grad_clip_value": 0.5},
    "adam_wd": {"weight_decay": 0.01}, "adamw": {"optim": "adamw",
                                                 "weight_decay": 0.01},
    "sgd": {"optim": "sgd"}, "sgdm": {"optim": "sgdm"},
    "sgdmom": {"optim": "sgdmom"}, "rmsprop": {"optim": "rmsprop"},
    "adagrad": {"optim": "adagrad"},
    "noam": {"noamopt": True, "noamopt_warmup": 3},
    "fused": {"fused_optimizer": True, "weight_decay": 0.01},
    "fused_noam": {"fused_optimizer": True, "noamopt": True,
                   "noamopt_warmup": 3},
    "fused_norm_clip": {"fused_optimizer": True, "grad_clip_mode": "norm",
                        "grad_clip_value": 0.5},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax(case):
    """Three updates from the same parameters and gradients: parameters
    within 1e-5 of the largest update, moments and counts as optax's, and
    the state tree holds flax's keys (the ``optimizer.ckpt`` layout)."""
    fields = dict(d_model=8, learning_rate=0.01, **CASES[case])
    jcfg = jax_default_config()
    jcfg.update(fields)
    tcfg = make_config(**fields)
    m = _layer()
    layout = flax_layout(m)
    tx = joptim.build_optimizer(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(m))
    jstate = tx.init(jparams)
    opt = toptim.Optimizer(toptim.build_optimizer(tcfg, layout), m, layout)
    start = to_jax_tree(m)
    for step in range(STEPS):
        g = _grads(m, step)
        upd, jstate = tx.update(_jax_tree(m, g), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, upd)
        opt.step(g)
    got, want = to_jax_tree(m), jparams
    moved = max(np.abs(np.asarray(w) - s).max() for w, s in zip(
        jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(start)))
    assert moved > 0
    for g_, w_ in zip(jax.tree_util.tree_leaves(got),
                      jax.tree_util.tree_leaves(want)):
        assert np.abs(g_ - np.asarray(w_)).max() <= 1e-5 * moved
    jtree = msgpack_restore(serialization.to_bytes(
        jax.tree_util.tree_map(np.asarray, jstate)))
    ttree = opt.state_tree()
    assert (jax.tree_util.tree_structure(ttree)
            == jax.tree_util.tree_structure(jtree))
    for a, b in zip(jax.tree_util.tree_leaves(ttree),
                    jax.tree_util.tree_leaves(jtree)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_state_tree_round_trip_and_mismatch():
    """load_state_tree restores a saved state; another optimizer's tree
    raises ValueError and leaves the state as it was."""
    m = _layer()
    layout = flax_layout(m)
    adam = toptim.Optimizer(toptim.build_optimizer(make_config(), layout),
                            m, layout)
    adam.step(_grads(m, 0))
    tree = adam.state_tree()
    fresh = toptim.Optimizer(toptim.build_optimizer(make_config(), layout),
                             m, layout)
    fresh.load_state_tree(tree)
    for a, b in zip(jax.tree_util.tree_leaves(fresh.state_tree()),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    noam = toptim.Optimizer(toptim.build_optimizer(
        make_config(noamopt=True, d_model=8), layout), m, layout)
    before = noam.state_tree()
    with pytest.raises(ValueError):
        noam.load_state_tree(tree)
    assert (jax.tree_util.tree_structure(noam.state_tree())
            == jax.tree_util.tree_structure(before))


def test_set_lr_and_noam_schedule():
    m = _layer()
    layout = flax_layout(m)
    opt = toptim.Optimizer(toptim.build_optimizer(make_config(), layout), m,
                           layout)
    opt.set_lr(0.123)
    assert opt.state["hyperparams"]["learning_rate"] == float(
        np.float32(0.123))
    jsched = joptim.noam_schedule(512, 1.0, 2000)
    tsched = toptim.noam_schedule(512, 1.0, 2000)
    for s in (0, 1, 10, 1999, 2000, 50000):
        assert abs(tsched(s) - float(jsched(jnp.int32(s)))) <= 1e-6 * abs(
            tsched(s))


@pytest.mark.parametrize("fn", ["epoch_lr", "scheduled_sampling_prob",
                                "glat_rate"])
def test_schedules_match_jax(fn):
    fields = [{}, {"learning_rate_decay_start": 0, "learning_rate": 1e-3},
              {"scheduled_sampling_start": 1,
               "scheduled_sampling_increase_every": 2},
              {"glancing_token": True},
              {"glancing_token": True, "unmasked_rate_decay_start": 1}]
    for f in fields:
        jcfg = jax_default_config()
        jcfg.update(f)
        tcfg = make_config(**f)
        for epoch in range(12):
            assert getattr(toptim, fn)(tcfg, epoch) == pytest.approx(
                getattr(joptim, fn)(jcfg, epoch), abs=0, rel=1e-12)


def test_plateau_tracker_matches_jax():
    scores = [0.1, 0.2, 0.15, 0.15, 0.1, 0.05, 0.3, 0.2, 0.2, 0.2, 0.2, 0.1]
    j, t = joptim.PlateauTracker(0.5, 2), toptim.PlateauTracker(0.5, 2)
    for s in scores:
        assert t.update(s) == j.update(s)
        assert t.state_dict() == j.state_dict()
    t2 = toptim.PlateauTracker()
    t2.load_state_dict(t.state_dict())
    assert t2.state_dict() == t.state_dict()
