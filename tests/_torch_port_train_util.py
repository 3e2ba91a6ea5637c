"""Shared set-up of the port's training parity tests
(``tests/test_torch_port_train*.py``): one train batch of the synthetic
corpus, the JAX loss and gradients of it, and the comparisons."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from boficap_tpu.train import steps as jsteps
from boficap_tpu_torch.config import make_config
from boficap_tpu_torch.convert import (flax_layout, load_jax_params,
                                     to_jax_tree, tree_from_named)
from boficap_tpu_torch.data import dataset as tds
from boficap_tpu_torch.train import steps as tsteps
from tests._torch_port_util import L, R, VOCAB, make_pair, to_numpy_tree

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
REL = 1e-5                     # loss and metrics, relative
GRAD = 1e-4                    # each gradient leaf, of its largest magnitude
# a leaf whose gradient is zero in exact arithmetic (a key projection's
# bias: softmax ignores a shift common to every key) carries only rounding
# noise; such a leaf is held to this share of the largest gradient instead
ZERO_GRAD = 1e-6
# parameters after a few updates, of the largest update: 1e-4 under a
# plain-rate SGD step (linear in the gradient); under Adam, which divides
# each element by its own RMS, an element whose gradient is near zero
# turns its rounding noise (the two packages' float32 sums) into a step of
# up to the rate, so there the bound is 1e-2 (measured up to 1.1e-3 after
# three steps).  A leaf of structurally zero gradient (ZERO_GRAD) moves by
# rounding noise alone and is skipped
UPDATE = {"sgd": 1e-4, "adam": 1e-2}
NO_DROP = dict(dropout=0.0, drop_prob_lm=0.0)
SMOOTHING = {"AIC": 0.1}


def train_loader(mode, batch_size=2):
    cfg = make_config(train_mode=mode, input_json="synthetic",
                      input_att_dir="synthetic", batch_size=batch_size,
                      seq_per_img=2, max_boxes=R, max_length=L,
                      data_prefetch=0)
    labels = tds.LabelStore.synthetic(n_images=20, vocab_size=VOCAB, L=L)
    return tds.CaptionData(cfg, labels=labels)


def jax_batch(b):
    return {k: jnp.asarray(np.asarray(b[k]))
            for k in (("att_feats", "att_masks") + tsteps.LABEL_KEYS
                      + tsteps.PB_KEYS)
            if b.get(k) is not None}


def jax_grad_fn(jm, smoothing=0.0):
    def f(params, batch, glat):
        def lf(p):
            return jsteps.xe_loss_fn(jm, p, batch, jax.random.PRNGKey(0),
                                     glat, 0.0, deterministic=False,
                                     label_smoothing=smoothing)
        return jax.value_and_grad(lf, has_aux=True)(params)
    return jax.jit(f)


def leaf(tree, path):
    node = tree["params"]
    for p in path:
        node = node[p]
    return np.asarray(node)


def close(got, want, rel=REL):
    got = float(got.detach()) if hasattr(got, "detach") else float(got)
    assert abs(got - float(want)) <= rel * max(abs(float(want)), 1e-30), (
        got, want)


def same_grads(tm, tgrads, jgrads):
    layout = flax_layout(tm)
    gmax = max(float(np.abs(np.asarray(x)).max())
               for x in jax.tree_util.tree_leaves(jgrads))
    for (name, _), g in zip(tm.named_parameters(), tgrads):
        path, tr = layout[name]
        want = leaf(jgrads, path)
        got = g.numpy().T if tr else g.numpy()
        scale = float(np.abs(want).max())
        if scale <= ZERO_GRAD * gmax:
            assert float(np.abs(got).max()) <= ZERO_GRAD * gmax, name
        else:
            assert float(np.abs(got - want).max()) <= GRAD * scale, name


def zero_leaves(jgrads):
    """Paths of the leaves whose gradient is zero in exact arithmetic."""
    leaves = jax.tree_util.tree_leaves_with_path(jgrads)
    gmax = max(float(np.abs(np.asarray(x)).max()) for _, x in leaves)
    return {jax.tree_util.keystr(p) for p, x in leaves
            if float(np.abs(np.asarray(x)).max()) <= ZERO_GRAD * gmax}


def same_params(tm, jparams, start, jgrads, tol):
    moved = max(float(np.abs(np.asarray(w) - s).max()) for w, s in zip(
        jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(start)))
    assert moved > 0
    zero = zero_leaves(jgrads)
    got = jax.tree_util.tree_leaves_with_path(to_jax_tree(tm))
    for (path, g), w in zip(got, jax.tree_util.tree_leaves(jparams)):
        if jax.tree_util.keystr(path) not in zero:
            assert float(np.abs(g - np.asarray(w)).max()) <= tol * moved


def built_cache(jax_grads: bool = True):
    """A getter that builds, per mode and once: the pair on shared weights
    (dropout off, self_dis on), one train batch, and the loss, metrics and
    gradients of it: JAX's, or with ``jax_grads`` False the port's
    gradients only, as a flax tree (enough to find the leaves of zero
    gradient).  Every get reloads the shared weights."""
    cache = {}

    def get(mode):
        if mode not in cache:
            jm, params, tm = make_pair(mode, self_dis=True, **NO_DROP)
            jsteps.set_self_dis(jm, True)
            batch = train_loader(mode).get_batch("train")
            jb = jax_batch(batch)
            s = dict(jm=jm, params=params, tm=tm, batch=batch, jb=jb,
                     start=to_numpy_tree(params), jax_steps={})
            if jax_grads:
                fn = jax_grad_fn(jm, SMOOTHING.get(mode, 0.0))
                (s["loss"], s["metrics"]), s["grads"] = fn(params, jb, None)
            else:
                loss, _ = tsteps.xe_loss_fn(
                    tm, tsteps.to_device(batch, "cpu"), None)
                names = [n for n, _ in tm.named_parameters()]
                grads = torch.autograd.grad(loss, list(tm.parameters()),
                                            allow_unused=True)
                s["grads"] = tree_from_named(
                    {n: torch.zeros_like(p) if g is None else g for (n, p), g
                     in zip(tm.named_parameters(), grads)}, flax_layout(tm))
                assert names
            cache[mode] = s
        # each test starts from the shared weights
        load_jax_params(cache[mode]["tm"], cache[mode]["start"])
        return cache[mode]
    return get
