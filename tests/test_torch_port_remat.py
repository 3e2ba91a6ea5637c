"""``remat`` in the port (``models/layers.py::remat_call``): the encoder's
and the decoder stacks' layers recomputed in the backward pass, as the
JAX package's ``nn.remat``, on the CPU at tiny widths:

  * the port with ``remat: 1`` against JAX with ``remat: 1`` on shared
    weights (dropout off): the loss and every gradient leaf (UIC, SAIC,
    NAIC, AIC);
  * it recomputes: each encoder and stack-decoder layer runs twice as
    often under autograd, the length predictor's layer as often, and
    fewer bytes are saved for the backward;
  * with dropout 0.1 (GLAT, scheduled sampling, drop-worst, grad_accum
    in turn) ``remat: 1`` equals ``remat: 0`` bitwise from one generator
    seed: the loss, every gradient, the generator's state after the
    backward and the parameters after two Adam steps;
  * under ``no_grad`` nothing changes: the NA and SA decodes, the flax
    layout, and a checkpoint of a ``remat: 1`` model loads into JAX's
    ``remat: 0`` model;
  * a tensor-parallel step (tp 2, gloo ranks), whose recompute runs the
    row-parallel all-reduces again in the backward, against the single
    device; the RL step against ``remat: 0``; with ``use_pallas`` on,
    the recompute after a ``plain_attention`` block stays on the plain
    path.
"""

import jax
import numpy as np
import pytest
import torch

from boficap_tpu.train import state as jstate
from boficap_tpu.train import steps as jsteps
from boficap_tpu_torch.config import make_config
from boficap_tpu_torch.convert import flax_layout, to_jax_tree
from boficap_tpu_torch.decode import bound_fill as bf
from boficap_tpu_torch.models import layers
from boficap_tpu_torch.parallel import mesh as tmesh
from boficap_tpu_torch.train import optim as toptim
from boficap_tpu_torch.train import state as tstate
from boficap_tpu_torch.train import steps as tsteps
from tests import _torch_port_mesh_util as U
from tests._torch_port_train_util import (NO_DROP, SMOOTHING, close,
                                          jax_batch, jax_grad_fn, same_grads,
                                          train_loader)
from tests._torch_port_util import make_feats, make_pair

DROP = dict(dropout=0.1, drop_prob_lm=0.5)
# (train_mode, glat_p, drop_worst, ss_prob, grad_accum) of the bitwise
# dropout cases
CASES = [("UIC", 0.5, 0.0, 0.0, 1), ("UIC", 0.5, 0.0, 0.5, 1),
         ("UIC", 0.5, 0.0, 0.0, 2), ("NAIC", 0.5, 0.5, 0.0, 1),
         ("SAIC", None, 0.0, 0.0, 1), ("AIC", None, 0.0, 0.0, 1),
         ("UIC_s", 0.5, 0.0, 0.0, 1), ("NNAIC", None, 0.0, 0.0, 1),
         ("PB_pad", None, 0.0, 0.0, 1)]
# the tensor-parallel step: (mode, images, drop_worst, clip, grad_accum)
TP_CASES = [("UIC", 4, 0.0, "value", 1), ("AIC", 4, 0.0, "value", 1)]
RL_CASES = [("UIC", {"rl_kl": True}), ("UIC", {"structure_loss_weight": 0.5}),
            ("UIC_s", {"structure_loss_type": "seqnll"})]


def port_pair(mode, **fields):
    """The port's models with remat 0 and 1 on the same weights."""
    return [make_pair(mode, remat=r, **fields)[2] for r in (0, 1)]


def grads_of(tm, batch, gen, glat=None, drop_worst=0.0, ss_prob=0.0):
    """The XE loss and every gradient leaf, as the training step takes
    them (every attention on the plain path)."""
    with tm.plain_attention():
        loss, _ = tsteps.xe_loss_fn(tm, batch, gen, glat, drop_worst,
                                    SMOOTHING.get(tm.train_mode, 0.0),
                                    ss_prob)
    grads = torch.autograd.grad(loss, list(tm.parameters()),
                                allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(tm.parameters(), grads)]


@pytest.mark.parametrize("mode", ["UIC", "SAIC", "NAIC", "AIC"])
def test_remat_matches_jax_remat(mode):
    """Shared weights, dropout off: the port's loss and every gradient leaf
    with remat 1 against JAX's with remat 1 (REL, GRAD)."""
    jm, params, tm = make_pair(mode, remat=1, self_dis=True, **NO_DROP)
    assert jm.remat and tm.remat and tm.encoder.remat
    jsteps.set_self_dis(jm, True)
    batch = train_loader(mode).get_batch("train")
    (jloss, _), jgrads = jax_grad_fn(jm, SMOOTHING.get(mode, 0.0))(
        params, jax_batch(batch), None)
    loss, grads = grads_of(tm, tsteps.to_device(batch, "cpu"),
                           torch.Generator())
    close(loss, jloss)
    same_grads(tm, grads, jgrads)


@pytest.mark.parametrize("mode", ["UIC", "SAIC", "NAIC", "AIC"])
def test_remat_recomputes_the_stacks(mode):
    """Under autograd, remat 1 runs each encoder and stack-decoder layer
    twice for every time remat 0 runs it (the forward, then the recompute
    in the backward) and the length predictor's layer as often; fewer
    bytes pass through ``saved_tensors_hooks``."""
    batch = tsteps.to_device(train_loader(mode).get_batch("train"), "cpu")
    runs = []
    for tm in port_pair(mode, **DROP):
        calls, saved = {}, [0]

        def count(name):
            def hook(mod, args):
                calls[name] = calls.get(name, 0) + 1
            return hook

        def pack(t):
            saved[0] += t.numel() * t.element_size()
            return t

        layers = [n for n, _ in tm.named_modules()
                  if n.startswith(("encoder.layer", "decoder", "lp"))
                  and n.count(".") == (0 if n.startswith("lp") else 1)
                  and not n.endswith(".norm")]
        assert any(n.startswith("encoder.") for n in layers)
        handles = [tm.get_submodule(n).register_forward_pre_hook(count(n))
                   for n in layers]
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            grads_of(tm, batch, torch.Generator().manual_seed(0))
        for h in handles:
            h.remove()
        runs.append((calls, saved[0]))
    (plain, plain_bytes), (remat, remat_bytes) = runs
    assert set(plain) == set(remat) and plain
    for name, n in plain.items():
        want = n if name.startswith("lp") else 2 * n
        assert remat[name] == want, (name, remat[name], n)
    assert remat_bytes < plain_bytes, (remat_bytes, plain_bytes)


def test_remat_recompute_takes_the_forward_route(monkeypatch):
    """With use_pallas on, a forward on the plain path (inside
    ``plain_attention``, no generator: the RL re-score's) whose backward
    runs after the block: the recompute takes the plain path too (the
    attention core, which refuses operands that require grad on the card,
    is never called) and the gradients are remat 0's bit for bit."""
    batch = tsteps.to_device(train_loader("UIC").get_batch("train"), "cpu")
    models = port_pair("UIC", **NO_DROP)

    def refuse(*args, **kwargs):
        raise AssertionError("the attention core ran under autograd")

    monkeypatch.setattr(layers, "attention_core", refuse)
    runs = []
    for tm in models:
        tm.set_attention_core(True)
        loss, grads = grads_of(tm, batch, None)
        assert all(m.use_core for m in tm.modules()
                   if isinstance(m, layers.MultiHeadAttention))
        runs.append((loss, grads))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _adam_steps(tm, batch, seed, glat, drop_worst, ss_prob, grad_accum):
    layout = flax_layout(tm)
    opt = toptim.Optimizer(toptim.build_optimizer(make_config(
        noamopt=False, optim="adam", learning_rate=1e-3), layout), tm,
        layout)
    step = tsteps.make_xe_step(tm, opt, grad_accum=grad_accum)
    gen = torch.Generator().manual_seed(seed)
    losses = [step(batch, gen, glat, drop_worst, ss_prob)["loss"]
              for _ in range(2)]
    return losses, gen.get_state(), [p.detach().clone()
                                     for p in tm.parameters()]


@pytest.mark.parametrize("case", CASES, ids=[
    f"{m}-glat{g}-dw{d}-ss{s}-ga{a}" for m, g, d, s, a in CASES])
def test_remat_dropout_replays_bitwise(case):
    """Dropout 0.1 (drop_prob_lm 0.5) from one generator seed: remat 1's
    loss, every gradient and the generator's state after the backward are
    remat 0's bit for bit, and so are the losses, the generator's state
    and every parameter after two Adam steps of ``make_xe_step``."""
    mode, glat, drop_worst, ss_prob, accum = case
    batch = tsteps.to_device(train_loader(mode).get_batch("train"), "cpu")
    models = port_pair(mode, **DROP)
    first = []
    for tm in models:
        gen = torch.Generator().manual_seed(11)
        loss, grads = grads_of(tm, batch, gen, glat, drop_worst, ss_prob)
        first.append((loss, grads, gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = first
    assert torch.equal(l0, l1)
    for (name, _), a, b in zip(models[0].named_parameters(), g0, g1):
        assert torch.equal(a, b), name
    assert torch.equal(s0, s1)
    (loss0, gen0, p0), (loss1, gen1, p1) = [
        _adam_steps(tm, batch, 5, glat, drop_worst, ss_prob, accum)
        for tm in models]
    assert all(torch.equal(a, b) for a, b in zip(loss0, loss1))
    assert torch.equal(gen0, gen1)
    for (name, _), a, b in zip(models[0].named_parameters(), p0, p1):
        assert torch.equal(a, b), name


def test_remat_inference_and_checkpoint_unchanged(tmp_path):
    """Under no_grad remat 1 plans and decodes as remat 0 (NA and SA), with
    the same parameter names and flax layout; the checkpoint the port
    writes from a remat 1 model loads into JAX's remat 0 model, every
    leaf equal."""
    jm0, params0, tm0 = make_pair("UIC", remat=0)
    tm1 = make_pair("UIC", remat=1)[2]
    assert not jm0.remat and tm1.remat
    assert ([n for n, _ in tm0.named_parameters()]
            == [n for n, _ in tm1.named_parameters()])
    assert flax_layout(tm0) == flax_layout(tm1)
    att, am = (torch.from_numpy(x) for x in make_feats(4, seed=3))
    src = am.bool()
    with torch.no_grad():
        outs = [(bf.na_decode(m, m.encode(att, am), src),
                 bf.sa_decode(m, m.encode(att, am), src))
                for m in (tm0, tm1)]
    assert int((outs[0][0]["seq"] > 3).sum()) > 0
    for a, b in zip(outs[0], outs[1]):
        for k in ("seq", "phrase_num", "phrase_length", "phrase_syn"):
            assert torch.equal(a[k], b[k]), k
    cfg = make_config(checkpoint_path=str(tmp_path), id="remat")
    tstate.save_checkpoint(cfg, to_jax_tree(tm1), {"iter": 0})
    template = jax.tree_util.tree_map(np.zeros_like,
                                      jax.device_get(params0))
    got = jstate.load_params(str(tmp_path / "model.ckpt"), template)
    want = to_jax_tree(tm1)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert len(got_leaves) == len(jax.tree_util.tree_leaves(want))
    for (path, g), w in zip(got_leaves, jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def single_plain():
    return U.single_steps(TP_CASES)


@pytest.fixture(scope="module")
def tp2_remat():
    return tmesh.launch(U.step_worker, 2, (1, 2), TP_CASES, {"remat": 1})


@pytest.mark.parametrize("case", range(len(TP_CASES)),
                         ids=[c[0] for c in TP_CASES])
def test_remat_tp2_step_matches_single_device(case, single_plain,
                                              tp2_remat):
    """tp 2 (two gloo ranks, every attention's heads, the FFN and the
    generator split over 'model') with remat 1 against the single-device
    step with remat 0: the loss, the metrics and the updated parameters,
    within the mesh tests' tolerances."""
    from tests.test_torch_port_mesh import _same_step
    mode, bs = TP_CASES[case][:2]
    start = {k: v.detach().numpy().copy() for k, v in U.model_and_batch(
        U.config(mode, bs))[0].named_parameters()}
    _same_step(single_plain[case], tp2_remat[case], start)


@pytest.mark.parametrize("case", range(len(RL_CASES)),
                         ids=[f"{m}-{'-'.join(f)}" for m, f in RL_CASES])
def test_remat_rl_step_matches_plain(case):
    """``make_rl_step`` (fixed samples and seeded scores, its re-score and,
    at structure_loss_weight < 1, its gt XE term) with remat 1: the
    metrics and every updated parameter are remat 0's bit for bit."""
    mode, fields = RL_CASES[case]
    m0, p0 = U.rl_once(mode, fields)
    m1, p1 = U.rl_once(mode, {**fields, "remat": 1})
    assert m0 == m1
    assert set(p0) == set(p1)
    for k, v in p0.items():
        np.testing.assert_array_equal(p1[k], v, err_msg=k)
