"""Rank bodies of the port's multi-rank tests (``tests/test_torch_port_
mesh.py``): module-level, importing only the port, so that
``parallel.launch`` can start them in spawned processes.  Each builds the
same seeded tiny model and synthetic batch on every rank, and rank 0
returns its results to the test."""

from __future__ import annotations

import numpy as np
import torch

from boficap_tpu_torch.config import make_config
from boficap_tpu_torch.convert import fill_random, flax_layout
from boficap_tpu_torch.data import dataset as tds
from boficap_tpu_torch.decode import bound_fill as bf
from boficap_tpu_torch.models.boficap import build_model
from boficap_tpu_torch.parallel import (gather_params, gather_rows,
                                        init_group, make_mesh, shard_batch,
                                        shard_params)
from boficap_tpu_torch.train import optim as optim_mod
from boficap_tpu_torch.train import steps as tsteps

L, R, VOCAB = 8, 5, 46


def config(mode="UIC", batch_size=4, **kw):
    """make_cfg-sized (d 32, 1 layer, 2 heads), float32, no dropout; plain
    SGD at rate 1 after the value clip, so an update is the clipped
    gradient itself (Adam would turn the rounding noise of a near-zero
    gradient into a step of the full rate)."""
    return make_config(train_mode=mode, input_json="synthetic",
                       input_att_dir="synthetic", batch_size=batch_size,
                       seq_per_img=2, max_boxes=R, max_length=L,
                       N_enc=1, N_dec=1, d_model=32, d_ff=64,
                       num_att_heads=2, dtype="float32", dropout=0.0,
                       drop_prob_lm=0.0, noamopt=False, optim="sgd",
                       learning_rate=1.0, data_prefetch=0, **kw)


def model_and_batch(cfg, seed=0):
    labels = tds.LabelStore.synthetic(n_images=20, vocab_size=VOCAB, L=L,
                                      seed=1)
    batch = tds.CaptionData(cfg, labels=labels).get_batch("train")
    model = fill_random(build_model(cfg, VOCAB, device="cpu"), seed)
    return model, batch


def step_once(model, cfg, batch, mesh=None, drop_worst=0.0):
    """One XE step; (loss, metrics as floats)."""
    opt = optim_mod.Optimizer(optim_mod.build_optimizer(
        cfg, flax_layout(model)), model, flax_layout(model))
    step = tsteps.make_xe_step(model, opt, mesh=mesh,
                               grad_accum=int(cfg.grad_accum))
    m = step(tsteps.to_device(batch, "cpu"), None, None, drop_worst)
    return {k: float(v) for k, v in m.items()}


def whole_params(model):
    return {k: v.numpy() for k, v in gather_params(model).items()}


def step_worker(rank, world, init, shape, cases, fields=None):
    """Every case (mode, batch_size, drop_worst, grad_clip_mode,
    grad_accum) through one step on a ``shape`` = (data, model) mesh, with
    the config ``fields`` (e.g. remat) set; rank 0 returns each case's
    metrics and whole parameters."""
    torch.set_num_threads(1)
    init_group(rank, world, init, "cpu", timeout_s=120)
    mesh = make_mesh(axis_names=("data", "model"), shape=shape)
    out = []
    for mode, bs, drop, clip, accum in cases:
        cfg = config(mode, bs, grad_clip_mode=clip, grad_accum=accum,
                     **(fields or {}))
        model, batch = model_and_batch(cfg)
        shard_params(model, mesh)
        metrics = step_once(model, cfg, batch, mesh, drop)
        out.append((metrics, whole_params(model)))
    return out if rank == 0 else None


def single_steps(cases, fields=None):
    out = []
    for mode, bs, drop, clip, accum in cases:
        cfg = config(mode, bs, grad_clip_mode=clip, grad_accum=accum,
                     **(fields or {}))
        model, batch = model_and_batch(cfg)
        out.append((step_once(model, cfg, batch, None, drop),
                    {k: v.detach().numpy()
                     for k, v in model.named_parameters()}))
    return out


N = 2        # RL samples an image (= seq_per_img: sample j is caption j)


def rl_inputs(mode, fields, seed=3):
    """An RL case's config, model (seed 0) and its global inputs on the
    CPU: the batch as tensors, FIXED samples (sample j of image b is b's
    gt caption j, on every branch the mode samples; the plan of its
    phrases where the branch has one) and seeded host scores
    ([B, N] a branch, ``<branch>_self_cider`` [B] with its weight; classic
    SCST: ``scst_reward`` [B*N, L]).  The structure loss is
    new_self_critical unless ``fields`` names another (the config's
    default is seqnll)."""
    scst = fields == "scst"
    cfg = config(mode, 4, train_sample_n=N,
                 **({} if scst else dict(
                     {"structure_loss_type": "new_self_critical"},
                     **fields)))
    model, batch = model_and_batch(cfg)
    tb = tsteps.to_device(batch, "cpu")
    f = tsteps._flat(tb)
    one = {"seq": f["labels"][:, 1:-1].long()}
    if f.get("phrase_length") is not None and mode != "AIC":
        one.update(phrase_length=f["phrase_length"][:, 1:-1].long(),
                   phrase_syn=f["phrase_syn"][:, 1:-1].long())
    # the second half's images sample the batch's N shortest captions, so
    # the two 'data' shards' word counts differ by far (a shard's own
    # count in place of the global one then shows)
    rows = torch.arange(one["seq"].shape[0])
    short = torch.argsort((one["seq"] > 0).sum(-1), stable=True)[:N]
    rows[rows.shape[0] // 2:] = short.repeat(rows.shape[0] // (2 * N))
    one = {k: v[rows] for k, v in one.items()}
    branches = {"UIC": ("sa", "na"), "UIC_s": ("sa", "na", "sample"),
                "AIC": ("sample",)}[mode]
    samples = {k: dict(one) for k in branches}
    B = tb["att_feats"].shape[0]
    rs = np.random.RandomState(seed)
    if scst:
        scores = {"scst_reward": torch.from_numpy(np.repeat(
            rs.randn(B * N, 1).astype(np.float32), L, axis=1))}
    else:
        scores = {k: torch.from_numpy(rs.rand(B, N).astype(np.float32))
                  for k in branches}
        if cfg.get("self_cider_reward_weight", 0):
            scores.update({f"{k}_self_cider": torch.from_numpy(
                rs.rand(B).astype(np.float32)) for k in branches})
    return cfg, model, tb, samples, scores


def rl_once(mode, fields, mesh=None):
    """One RL step (``make_rl_step``, or ``make_scst_step`` for
    ``fields == 'scst'``) on ``rl_inputs``; under ``mesh`` the rank's rows
    of the batch, the samples and the scores, as the training CLI's
    ``rl_batch`` takes them.  (metrics as floats, whole parameters)."""
    cfg, model, tb, samples, scores = rl_inputs(mode, fields)
    if mesh is not None:
        shard_params(model, mesh)
        tb, scores = shard_batch(tb, mesh), shard_batch(scores, mesh)
        samples = {k: shard_batch(v, mesh) for k, v in samples.items()}
    opt = optim_mod.Optimizer(optim_mod.build_optimizer(
        cfg, flax_layout(model)), model, flax_layout(model))
    att, am = tb["att_feats"], tb["att_masks"]
    if fields == "scst":
        step = tsteps.make_scst_step(model, opt, cfg, mesh=mesh)
        m = step(att, am, samples, scores["scst_reward"])
    else:
        gt = None
        if cfg.get("structure_loss_weight", 1.0) < 1.0:
            gt = {k: tb[k] for k in tsteps.LABEL_KEYS if k in tb}
        step = tsteps.make_rl_step(model, opt, cfg, mesh=mesh)
        m = step(att, am, samples, scores, gt=gt, rng=torch.Generator())
    return ({k: float(v) for k, v in m.items()},
            whole_params(model) if mesh is not None else
            {k: v.detach().numpy() for k, v in model.named_parameters()})


def rl_worker(rank, world, init, shape, cases):
    """Every (mode, fields) RL case through one step on a ``shape`` =
    (data, model) mesh; rank 0 returns each case's result."""
    torch.set_num_threads(1)
    init_group(rank, world, init, "cpu", timeout_s=120)
    mesh = make_mesh(axis_names=("data", "model"), shape=shape)
    out = [rl_once(mode, fields, mesh) for mode, fields in cases]
    return out if rank == 0 else None


def decodes(model, att, am):
    """NA and SA decodes on the plain path: (seq, phrase_num,
    phrase_length) of each."""
    mem = model.encode(att, am)
    src = am.bool()
    na = bf.na_decode(model, mem, src)
    sa = bf.sa_decode(model, mem, src)
    return [x for o in (na, sa)
            for x in (o["seq"], o["phrase_num"], o["phrase_length"])]


def tp_decode_worker(rank, world, init, shape, seed):
    """The NA and SA decodes of a seeded UIC model with its biases nudged
    toward non-empty plans, on the batch sharded over 'data' and the
    weights over 'model', gathered; rank 0 returns them with the
    single-device decodes of the same model and batch."""
    torch.set_num_threads(1)
    init_group(rank, world, init, "cpu", timeout_s=120)
    mesh = make_mesh(axis_names=("data", "model"), shape=shape)
    cfg = config("UIC", 8)
    model, _ = model_and_batch(cfg, seed)
    with torch.no_grad():
        model.len_head2.bias += torch.tensor([1.0] + [1.5] * 3 + [0.0] * 16)
        model.syn_head2.bias += torch.tensor([0.0] * 4 + [2.0] * 3
                                             + [0.0] * 3)
    rs = np.random.RandomState(seed)
    att = torch.from_numpy(rs.randn(8, R, 2048).astype(np.float32))
    am = torch.ones(8, R)
    am[0, -2:] = 0
    with torch.no_grad():
        want = decodes(model, att, am)
        shard_params(model, mesh)
        local = shard_batch({"att": att, "am": am}, mesh)
        got = [gather_rows(x, mesh)
               for x in decodes(model, local["att"], local["am"])]
    return ([w.numpy() for w in want], [g.numpy() for g in got]) \
        if rank == 0 else None
