"""The port's RL stage against the JAX package on the CPU, on shared weights
at float32 with dropout off.

The two packages' draws differ, so a loss over sampled captions cannot be
compared across them: the step is held on FIXED samples (captions and
plans taken from the gt batch, a different caption for each sample of an
image) and fixed scores.  Held: ``frame_plan`` and ``rl_rescore`` (both
settings of ``use_logsoftmax``) to 1e-5; the sampler's own
``tok_logprobs`` against its re-score to 1e-5; one ``make_rl_step``
update under a plain-rate SGD for UIC, SAIC, NAIC, UIC_s and AIC
(new_self_critical), a margin loss, ``structure_loss_weight`` 0.5 with the
gt batch, ``rl_kl``, and the entropy and self-CIDEr weights, and one
``make_scst_step`` update for AIC: the loss and metrics to 1e-5 relative,
the parameters to 1e-4 of the largest update.  Then the training CLI with
``structure_after 0`` and an SCST -> structure switch."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boficap_tpu.config import default_config as jax_default_config
from boficap_tpu.train import optim as joptim
from boficap_tpu.train import state as jstate
from boficap_tpu.train import steps as jsteps
from boficap_tpu_torch.config import make_config
from boficap_tpu_torch.convert import flax_layout
from boficap_tpu_torch.models.layers import MultiHeadAttention
from boficap_tpu_torch.train import optim as toptim
from boficap_tpu_torch.train import steps as tsteps
from tests._torch_port_train_util import (REL, ROOT, UPDATE, built_cache,
                                          same_params)
from tests._torch_port_util import L

N = 2                           # samples an image (= seq_per_img)
LR = 0.05
BRANCHES = {"UIC": ("sa", "na"), "SAIC": ("sa",), "NAIC": ("na",),
            "UIC_s": ("sa", "na", "sample"), "AIC": ("sample",)}
RESCORE = 1e-5


@pytest.fixture(scope="module")
def built():
    return built_cache(jax_grads=False)


def fixed_samples(s, mode):
    """Per branch {seq, phrase_length, phrase_syn} [B*N, L], numpy: sample
    j of image b is the gt caption j of b."""
    f = {k: np.asarray(v).reshape((-1,) + np.asarray(v).shape[2:])
         for k, v in s["batch"].items()
         if k in ("labels", "phrase_length", "phrase_syn")}
    S = np.asarray(s["batch"]["labels"]).shape[1]
    B = np.asarray(s["batch"]["labels"]).shape[0]
    idx = np.array([b * S + j % S for b in range(B) for j in range(N)])
    one = {"seq": f["labels"][idx, 1:-1]}
    if "phrase_length" in f:
        one.update(phrase_length=f["phrase_length"][idx, 1:-1],
                   phrase_syn=f["phrase_syn"][idx, 1:-1])
    return {k: dict(one) for k in BRANCHES[mode]}


def to_torch(samples):
    return {k: {n: torch.as_tensor(np.asarray(v)).long()
                for n, v in d.items()} for k, d in samples.items()}


def to_jax(samples):
    return {k: {n: jnp.asarray(np.asarray(v, np.int32))
                for n, v in d.items()} for k, d in samples.items()}


def fixed_scores(B, branches, seed=3, self_cider=False):
    rs = np.random.RandomState(seed)
    out = {k: rs.rand(B, N).astype(np.float32) for k in branches}
    if self_cider:
        out.update({f"{k}_self_cider": rs.rand(B).astype(np.float32)
                    for k in branches})
    return out


def feats(s):
    b = s["batch"]
    return (torch.from_numpy(np.asarray(b["att_feats"])),
            torch.from_numpy(np.asarray(b["att_masks"])),
            jnp.asarray(b["att_feats"]), jnp.asarray(b["att_masks"]))


@pytest.mark.parametrize("mode", ["UIC", "UIC_s", "AIC"])
def test_frame_plan_matches_jax(built, mode):
    s = built(mode)
    sm = fixed_samples(s, mode)
    for d in sm.values():
        if "phrase_length" not in d:
            continue
        want = jsteps.frame_plan(jnp.asarray(d["seq"]),
                                 jnp.asarray(d["phrase_length"]),
                                 jnp.asarray(d["phrase_syn"]), L)
        got = tsteps.frame_plan(torch.as_tensor(d["seq"]),
                                torch.as_tensor(d["phrase_length"]),
                                torch.as_tensor(d["phrase_syn"]), L)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", ["UIC", "UIC_s", "AIC"])
@pytest.mark.parametrize("use_ls", [True, False])
def test_rl_rescore_matches_jax(built, mode, use_ls):
    s = built(mode)
    sm = fixed_samples(s, mode)
    att, am, jatt, jam = feats(s)
    want = jsteps.rl_rescore(s["jm"], s["params"], jax.random.PRNGKey(0),
                             jatt, jam, to_jax(sm), N, deterministic=True,
                             use_logsoftmax=use_ls)
    got = tsteps.rl_rescore(s["tm"], att, am, to_torch(sm), N,
                            use_logsoftmax=use_ls)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].detach().numpy(), w,
                                   rtol=RESCORE, atol=RESCORE, err_msg=k)
        # log-softmax rows sum to one; raw logits do not
        assert np.allclose(np.exp(w).sum(-1), 1.0, atol=1e-3) == use_ls


def test_rl_rescore_plain_under_attention_core(built):
    """use_pallas (the attention core) on: the re-score runs every
    attention on the plain path (the kernel has no backward) and equals
    the core-off re-score; the setting is restored after it, and a
    differentiable forward outside the re-score still meets the core
    wrapper's refusal."""
    s = built("AIC")
    m = s["tm"]
    sm = to_torch(fixed_samples(s, "AIC"))
    att, am, _, _ = feats(s)
    want = tsteps.rl_rescore(m, att, am, sm, N)["a_logprob"]
    m.set_attention_core(True)
    try:
        got = tsteps.rl_rescore(m, att, am, sm, N)["a_logprob"]
        assert got.requires_grad
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert all(a.use_core for a in m.modules()
                   if isinstance(a, MultiHeadAttention))
        with pytest.raises(ValueError, match="grad"):
            m.encode(att, am)
    finally:
        m.set_attention_core(False)


def _written(key, d):
    """The positions a sampler wrote a token log-prob at."""
    seq = d["seq"]
    if "phrase_length" in d:
        total = d["phrase_length"].sum(-1)
        return torch.arange(seq.shape[1])[None, :] < total[:, None]
    # AR: up to and including the first EOS
    ended = torch.cumsum((seq == 0).long(), -1)
    return (ended - (seq == 0).long()) == 0


@pytest.mark.parametrize("mode", ["UIC", "UIC_s", "AIC"])
def test_sampler_logprobs_equal_rescore(built, mode):
    """make_rl_sample (the kernel wrappers' twins on the CPU) draws real
    samples; their tok_logprobs are the re-score's values at the drawn
    words, where the sampler wrote them."""
    s = built(mode)
    att, am, _, _ = feats(s)
    sample = tsteps.make_rl_sample(s["tm"], "sample", 1.0, N)
    samples = sample(att, am, torch.Generator().manual_seed(5))
    want = set(BRANCHES[mode]) | ({"greedy"} if mode == "AIC" else set())
    assert set(samples) == want
    lps = tsteps.rl_rescore(s["tm"], att, am, samples, N)
    n_checked = 0
    for key, lp_key in (("sa", "sa_logprob"), ("na", "na_logprob"),
                        ("sample", "a_logprob")):
        if key not in samples:
            continue
        d = samples[key]
        assert d["seq"].shape == (att.shape[0] * N, L)
        got = torch.gather(lps[lp_key], -1, d["seq"][..., None])[..., 0]
        m = _written(key, d)
        n_checked += int(m.sum())
        np.testing.assert_allclose(got.detach()[m].numpy(),
                                   d["tok_logprobs"][m].numpy(),
                                   rtol=RESCORE, atol=RESCORE, err_msg=key)
    assert n_checked > 0


def _jax_opt():
    cfg = jax_default_config()
    cfg.update(d_model=64, optim="sgd", learning_rate=LR)
    return joptim.build_optimizer(cfg)


def _port_opt(tm):
    layout = flax_layout(tm)
    return toptim.Optimizer(toptim.build_optimizer(make_config(
        d_model=64, optim="sgd", learning_rate=LR), layout), tm, layout)


def _term_scales(s, sm):
    """Each branch's mean |log-prob| of its sampled words.  A structure
    loss is a sum of such terms weighted by advantages that sum to zero
    over an image's samples (the leave-one-out baseline), so its value
    cancels: its float32 rounding is relative to this scale, not to the
    value."""
    att, am, _, _ = feats(s)
    with torch.no_grad():
        lps = tsteps.rl_rescore(s["tm"], att, am, to_torch(sm), N)
    out = {}
    for key, lp_key in (("sa", "sa_logprob"), ("na", "na_logprob"),
                        ("sample", "a_logprob")):
        if key in sm:
            seq = torch.as_tensor(sm[key]["seq"]).long()
            tok = torch.gather(lps[lp_key], -1, seq[..., None])[..., 0]
            out[f"{key}_struc_loss"] = float(tok.abs().mean())
    return out


def _check_update(s, jstate_new, jm_metrics, tm_metrics, scales=None):
    """The metrics to REL relative (a structure loss and the total to REL
    of the larger of the value and its terms' scale), the parameters to
    UPDATE['sgd'] of the largest update."""
    assert sorted(tm_metrics) == sorted(jm_metrics)
    scales = scales or {}
    total = sum(scales.values()) + sum(
        abs(float(jm_metrics[k])) for k in ("lm_loss", "rl_kl")
        if k in jm_metrics)
    for k, v in jm_metrics.items():
        want = float(v)
        scale = total if k == "loss" else scales.get(k, 0.0)
        got = float(tm_metrics[k])
        assert abs(got - want) <= REL * max(abs(want), scale), (k, got, want)
    start = s["start"]
    # under plain-rate SGD the update is the gradient times the rate: it
    # marks the leaves of structurally zero gradient as the gradient would
    update = jax.tree_util.tree_map(lambda w, b: np.asarray(w) - b,
                                    jstate_new.params, start)
    same_params(s["tm"], jstate_new.params, start, update, UPDATE["sgd"])


RL_CASES = [("UIC", {}), ("SAIC", {}), ("NAIC", {}), ("UIC_s", {}),
            ("AIC", {}),
            ("UIC", {"structure_loss_type": "max_margin"}),
            ("UIC", {"structure_loss_weight": 0.5}),
            ("UIC", {"rl_kl": True}),
            ("UIC", {"entropy_reward_weight": 0.3,
                     "self_cider_reward_weight": 0.5})]


@pytest.mark.parametrize("mode,fields", RL_CASES,
                         ids=[f"{m}-{'-'.join(f) or 'nscl'}"
                              for m, f in RL_CASES])
def test_rl_step_matches_jax(built, mode, fields):
    s = built(mode)
    cfg = {"train_sample_n": N, "structure_loss_type": "new_self_critical",
           **fields}
    sm = fixed_samples(s, mode)
    att, am, jatt, jam = feats(s)
    B = att.shape[0]
    scores = fixed_scores(B, BRANCHES[mode],
                          self_cider="self_cider_reward_weight" in fields)
    gt = None
    if fields.get("structure_loss_weight", 1.0) < 1.0:
        gt = {k: np.asarray(s["batch"][k]) for k in tsteps.LABEL_KEYS
              if s["batch"].get(k) is not None}
    scales = _term_scales(s, sm)             # at the start weights
    tx = _jax_opt()
    state = jstate.create_state(
        jax.tree_util.tree_map(jnp.asarray, s["start"]), tx)
    jstep = jsteps.make_rl_step(s["jm"], tx, cfg)
    state, jm_ = jstep(state, jax.random.PRNGKey(1), jatt, jam, to_jax(sm),
                       {k: jnp.asarray(v) for k, v in scores.items()},
                       gt=None if gt is None else
                       {k: jnp.asarray(v) for k, v in gt.items()})
    tstep = tsteps.make_rl_step(s["tm"], _port_opt(s["tm"]), cfg)
    packs = s["tm"].packed_encoder()
    tm_ = tstep(att, am, to_torch(sm),
                {k: torch.from_numpy(v) for k, v in scores.items()},
                gt=None if gt is None else
                {k: torch.from_numpy(v).long() for k, v in gt.items()},
                rng=torch.Generator())
    assert s["tm"].packed_encoder() is not packs     # packs dropped
    _check_update(s, state, jm_, tm_, scales)
    if gt is not None:
        with pytest.raises(ValueError, match="lm_loss"):
            tsteps.rl_loss_fn(s["tm"], att, am, to_torch(sm),
                              {k: torch.from_numpy(v)
                               for k, v in scores.items()}, cfg)


def test_scst_step_matches_jax(built):
    s = built("AIC")
    cfg = {"train_sample_n": N}
    sm = fixed_samples(s, "AIC")
    att, am, jatt, jam = feats(s)
    rs = np.random.RandomState(4)
    rewards = np.repeat(rs.randn(att.shape[0] * N, 1).astype(np.float32), L,
                        axis=1)
    tx = _jax_opt()
    state = jstate.create_state(
        jax.tree_util.tree_map(jnp.asarray, s["start"]), tx)
    state, jm_ = jsteps.make_scst_step(s["jm"], tx, cfg)(
        state, jax.random.PRNGKey(1), jatt, jam, to_jax(sm),
        jnp.asarray(rewards))
    tm_ = tsteps.make_scst_step(s["tm"], _port_opt(s["tm"]), cfg)(
        att, am, to_torch(sm), torch.from_numpy(rewards))
    _check_update(s, state, jm_, tm_)


# ---------------------------------------------------------------------------
# the training CLI's RL epochs
# ---------------------------------------------------------------------------

def _train_cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "boficap_tpu_torch.tools.train", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _records(ck):
    with open(os.path.join(ck, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _cli_base(tmp_path, *extra):
    # 18 train images, batch 9: the JAX order draws one batch before the
    # loop, so an epoch of a fresh run is 2 iterations
    return ["--cfg", os.path.join(ROOT, "configs", "synthetic_smoke.yml"),
            "--id", "rl", "--checkpoint_path", str(tmp_path / "ck"),
            "--device", "cpu", "--batch_size", "9", "--train_sample_n", "2",
            "--losses_log_every", "1", "--save_checkpoint_every", "1000",
            "--language_eval", "0", *extra]


def test_train_cli_structure_stage(tmp_path):
    """structure_after 0: every iteration is an RL step; the RL keys reach
    metrics.jsonl; the JAX package's files are written."""
    _train_cli(_cli_base(tmp_path, "--structure_after", "0",
                         "--structure_loss_type", "new_self_critical",
                         "--max_epochs", "1"), str(tmp_path))
    recs = _records(tmp_path / "ck")
    assert [r["iter"] for r in recs] == [1, 2]
    for r in recs:
        assert {"reward", "sa_struc_loss", "na_struc_loss", "loss"} <= set(r)
        assert np.isfinite(r["loss"])
    for name in ("model.ckpt", "optimizer.ckpt", "infos_rl.pkl",
                 "histories_rl.pkl"):
        assert (tmp_path / "ck" / name).is_file(), name


def test_train_cli_scst_then_structure(tmp_path):
    """AIC: classic SCST in epoch 0, the structure loss from epoch 1 (the
    step rebuilt); a phrase train_mode keeps XE under self_critical_after
    and warns."""
    _train_cli(_cli_base(tmp_path, "--train_mode", "AIC",
                         "--self_critical_after", "0", "--structure_after",
                         "1", "--structure_loss_type", "new_self_critical",
                         "--max_epochs", "2"), str(tmp_path))
    recs = _records(tmp_path / "ck")
    scst = [r for r in recs if r["epoch"] < 1 or r["iter"] <= 2]
    struc = [r for r in recs if r["iter"] > 2]
    assert scst and struc
    assert all("sample_struc_loss" not in r and "reward" in r for r in scst)
    assert all("sample_struc_loss" in r for r in struc)
    out = _train_cli(_cli_base(tmp_path / "xe", "--self_critical_after", "0",
                               "--max_epochs", "1"), str(tmp_path))
    assert "WARNING: self_critical_after set" in out
    assert all("reward" not in r for r in _records(tmp_path / "xe" / "ck"))
