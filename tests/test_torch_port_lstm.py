"""The port's LSTM captioners (FC, UpDown, Att2in2, AoANet) against the JAX
package on the CPU, on shared weights (JAX ``model.init``, carried across
by ``load_jax_params``) at float32 and small widths: d 32, rnn 48, att_hid
24, 2 heads, N_enc 2, 9 regions (some padded), L 6.

Held per model: the teacher-forced forward's log-probs to 1e-5 with one
and two captions an image; ``encode``, ``init_ar_cache`` and one
``ar_step`` to 1e-5, and the step on ``_precompute``'s values bitwise
equal to the inline projections; ``ar_sample`` greedy, ``ar_beam_search``
(K 3) and ``ar_diverse_beam_search`` (K 4, 2 groups): seq identical,
log-probs and scores to 1e-5; one XE step with dropout off: the loss to
1e-5 relative, every gradient leaf to 1e-4 of its largest magnitude;
``rl_rescore``, one ``make_scst_step`` and one ``make_rl_step`` on fixed
samples at the RL slice's bounds (``tests/test_torch_port_rl.py``);
``to_jax_tree`` giving JAX's tree back bitwise.  AoANet with
``use_pallas``: the attention core's twin against JAX's kernel in interpret
mode on the encode and the decodes.  The model's own scheduled sampling at
ss_prob 0 and 1.

End to end: a JAX-written ``model.ckpt`` through the port's ``eval_split``
and its eval CLI to JAX's captions; the port's training CLI on fc and aoa,
its checkpoint evaluated by JAX to the same captions; the AIC server on
the CPU against a direct decode."""

import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from boficap_tpu.config import default_config as jax_default_config
from boficap_tpu.config import finalize as jax_finalize
from boficap_tpu.data import dataset as jds
from boficap_tpu.data.readers import SyntheticFeatures as JaxFeatures
from boficap_tpu.decode import ar as jar
from boficap_tpu.eval import eval_utils as jeu
from boficap_tpu.models import setup as jax_setup
from boficap_tpu.models.layers import set_pallas_attention
from boficap_tpu.train import state as jstate
from boficap_tpu.train import steps as jsteps
from boficap_tpu_torch import config as tconfig
from boficap_tpu_torch.convert import (load_jax_checkpoint, load_jax_params,
                                       to_jax_tree)
from boficap_tpu_torch.data import dataset as tds
from boficap_tpu_torch.data.readers import SyntheticFeatures
from boficap_tpu_torch.decode import ar as tar
from boficap_tpu_torch.eval import eval_utils as teu
from boficap_tpu_torch.models import setup as tsetup
from boficap_tpu_torch.serve import CaptionServer
from boficap_tpu_torch.tools import eval as teval
from boficap_tpu_torch.train import steps as tsteps
from tests._torch_port_train_util import REL, ROOT, same_grads
from tests.test_torch_port_rl import (N, _check_update, _jax_opt, _port_opt,
                                      _term_scales, fixed_samples,
                                      fixed_scores, to_jax, to_torch)

torch.set_num_threads(2)

CMS = ("fc", "updown", "att2in2", "aoa")
VOCAB = 46                  # + 4 control ids
L = 6
R = 9
B = 4
TOL = 1e-5
WIDTHS = dict(input_encoding_size=32, rnn_size=48, att_hid_size=24,
              N_enc=2, num_att_heads=2, max_boxes=R, max_length=L,
              dtype="float32", drop_prob_lm=0.0, train_mode="AIC")


def jax_cfg(cm, **fields):
    cfg = jax_default_config()
    cfg.update(caption_model=cm, **{**WIDTHS, **fields})
    return jax_finalize(cfg)


def port_cfg(cm, **fields):
    return tconfig.make_config(caption_model=cm, **{**WIDTHS, **fields})


def make_feats(n=B, seed=0):
    """Region features [n, R, 2048] and masks [n, R]: sample 0 has three
    padded regions, sample 1 one."""
    rs = np.random.RandomState(seed)
    att = rs.randn(n, R, 2048).astype(np.float32)
    am = np.ones((n, R), np.float32)
    am[0, -3:] = 0
    am[1, -1:] = 0
    return att, am


def _nudge_logit(tree, seed):
    """The logit kernel scaled up (a random model's words barely depend on
    its input), seeded noise on the bias, the other control ids lowered
    and EOS raised, so greedy captions hold words, vary between images and
    some end early."""
    rs = np.random.RandomState(seed)
    tree["params"]["logit"]["kernel"] = tree["params"]["logit"]["kernel"] * 8
    b = tree["params"]["logit"]["bias"]
    b = b + 0.5 * rs.randn(*b.shape).astype(np.float32)
    b[[0, 1, 3]] -= 6.0
    b[2] += 1.0
    tree["params"]["logit"]["bias"] = b


def build_pair(cm, seed=0, vocab=VOCAB):
    """(jax_model, jax_params, port_model) on the weights of JAX's
    ``model.init`` (the logit bias nudged)."""
    jm = jax_setup(jax_cfg(cm), vocab)
    att, am = make_feats(2)
    labels = np.ones((2, L + 2), np.int32)
    params = jax.jit(lambda k, a, m, y: jm.init(
        {"params": k}, a, m, y, deterministic=True))(
        jax.random.PRNGKey(seed), jnp.asarray(att), jnp.asarray(am),
        jnp.asarray(labels))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jax.device_get(params))
    _nudge_logit(tree, seed + 11)
    tm = tsetup(port_cfg(cm), vocab, device="cpu")
    load_jax_params(tm, tree)
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), tm, tree


_PAIRS = {}


def pair(cm):
    """The pair of ``cm``, built once; every get reloads the shared
    weights into the port model (a step test moves them)."""
    if cm not in _PAIRS:
        _PAIRS[cm] = build_pair(cm, seed=CMS.index(cm))
    jm, params, tm, tree = _PAIRS[cm]
    load_jax_params(tm, tree)
    tm.set_attention_core(False)
    return jm, params, tm, tree


@contextlib.contextmanager
def pallas(tm, on: bool):
    """use_pallas on both sides: JAX's global in interpret mode (reset in
    ``finally``) and the port model's attention-core routing."""
    tm.set_attention_core(on)
    set_pallas_attention(on, interpret=True)
    try:
        yield
    finally:
        set_pallas_attention(False)
        tm.set_attention_core(False)


def memories(jm, params, tm, att, am):
    jmem = jm.apply(params, jnp.asarray(att), jnp.asarray(am),
                    deterministic=True, method="encode")
    with torch.no_grad():
        tmem = tm.encode(torch.from_numpy(att), torch.from_numpy(am))
    return (jmem, jnp.asarray(am).astype(bool), tmem,
            torch.from_numpy(am).bool())


def close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def labels_for(n_rows, seed):
    rs = np.random.RandomState(seed)
    lab = rs.randint(4, VOCAB + 4, (n_rows, L + 2)).astype(np.int64)
    lab[:, 0] = 1
    lab[:, -1] = 0
    lab[0, 3] = 2                                       # an early EOS
    lab[0, 4:] = 0
    return lab


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cm", CMS)
def test_forward_matches_jax(cm, k):
    """The teacher-forced log-probs, k captions an image (the memory
    repeated image-major)."""
    jm, params, tm, _ = pair(cm)
    att, am = make_feats()
    lab = labels_for(B * k, seed=k)
    want = jax.jit(lambda p, a, m, y: jm.apply(p, a, m, y,
                                                deterministic=True))(
        params, jnp.asarray(att), jnp.asarray(am), jnp.asarray(lab, jnp.int32))
    with torch.no_grad():
        got = tm(torch.from_numpy(att), torch.from_numpy(am),
                 torch.from_numpy(lab))
    assert got["logprob"].shape == (B * k, L + 1, VOCAB + 4)
    close(got["logprob"], want["logprob"])


@pytest.mark.parametrize("cm", CMS)
def test_encode_step_and_precompute_match_jax(cm):
    """encode, then init_ar_cache and two ar_steps against JAX's; the step
    on the cache's precomputed values bitwise equal to the inline ones."""
    jm, params, tm, _ = pair(cm)
    att, am = make_feats(seed=1)
    jmem, jsrc, tmem, tsrc = memories(jm, params, tm, att, am)
    close(tmem, jmem, what="encode")
    jc = jm.apply(params, jmem, L + 1, method="init_ar_cache")
    with torch.no_grad():
        tc = tm.init_ar_cache(tmem, L + 1)
        for pos, ids in enumerate(([1] * B, [5, 9, 13, 2])):
            it = np.array(ids)
            jlp, jc = jm.apply(params, jnp.asarray(it, jnp.int32), pos, jc,
                               jsrc, method="ar_step")
            inline, _ = tm.ar_step(torch.from_numpy(it), pos,
                                   {**tc, "pre": None}, tsrc)
            tlp, tc = tm.ar_step(torch.from_numpy(it), pos, tc, tsrc)
            close(tlp, jlp, what=f"ar_step {pos}")
            assert torch.equal(inline, tlp)
    # the carry, leaf for leaf (dict keys sorted, tuples in order)
    for got, want in zip(jax.tree_util.tree_leaves(tc["state"]),
                         jax.tree_util.tree_leaves(jc["state"])):
        close(got, want, what="carry")


@pytest.mark.parametrize("cm", CMS)
def test_ar_sample_matches_jax(cm):
    jm, params, tm, _ = pair(cm)
    att, am = make_feats(seed=2)
    jmem, jsrc, tmem, tsrc = memories(jm, params, tm, att, am)
    want = jar.ar_sample(jm, params, jax.random.PRNGKey(0), jmem, jsrc)
    got = tar.ar_sample(tm, tmem, tsrc)
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    for k in ("tok_logprobs", "entropy"):
        close(got[k], want[k], what=k)
    # words, and captions that differ between images
    assert (got["seq"] > 3).any() and len({tuple(r) for r in
                                           got["seq"].tolist()}) > 1


@pytest.mark.parametrize("kind", ["beam", "diverse"])
@pytest.mark.parametrize("cm", CMS)
def test_beam_searches_match_jax(cm, kind):
    """ar_beam_search K 3, and ar_diverse_beam_search K 4 in 2 groups (each
    group's own copy of the carry): seq identical, scores and token
    log-probs to 1e-5."""
    jm, params, tm, _ = pair(cm)
    att, am = make_feats(seed=3)
    jmem, jsrc, tmem, tsrc = memories(jm, params, tm, att, am)
    if kind == "beam":
        want = jar.ar_beam_search(jm, params, jmem, jsrc, beam_size=3)
        got = tar.ar_beam_search(tm, tmem, tsrc, beam_size=3)
    else:
        want = jar.ar_diverse_beam_search(jm, params, jmem, jsrc,
                                          beam_size=4, group_size=2)
        got = tar.ar_diverse_beam_search(tm, tmem, tsrc, beam_size=4,
                                         group_size=2)
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    for k in ("scores", "tok_logprobs"):
        close(got[k], want[k], what=k)


@pytest.mark.parametrize("cm", CMS)
def test_to_jax_tree_is_jax_tree(cm):
    _, _, tm, tree = pair(cm)
    back = to_jax_tree(tm)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(tree)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("ss", [0.0, 1.0])
def test_scheduled_sampling(ss):
    """ss_prob 0 is the forward; at 1 every input after BOS is a draw from
    the previous step's distribution: the run equals the teacher-forced
    forward over the inputs it fed, and those differ from the labels."""
    _, _, tm, _ = pair("updown")
    att, am = make_feats(seed=4)
    lab = torch.from_numpy(labels_for(B, seed=5))
    a, m = torch.from_numpy(att), torch.from_numpy(am)
    fed = []
    hook = tm.embed.register_forward_hook(
        lambda mod, args, out: fed.append(args[0].clone()))
    try:
        with torch.no_grad():
            out = tm(a, m, lab, ss_prob=ss,
                     rng=torch.Generator().manual_seed(3))
    finally:
        hook.remove()
    with torch.no_grad():
        ref = tm(a, m, lab)
    inputs = torch.stack(fed, 1)                       # [B, L+1]
    if ss == 0.0:
        assert torch.equal(out["logprob"], ref["logprob"])
        assert torch.equal(inputs, lab[:, :-1])
        return
    assert torch.equal(inputs[:, 0], lab[:, 0])
    assert not torch.equal(inputs[:, 1:], lab[:, 1:-1])
    drawn = torch.cat([inputs, lab[:, -1:]], 1)
    with torch.no_grad():
        again = tm(a, m, drawn)
    torch.testing.assert_close(out["logprob"], again["logprob"], rtol=0,
                               atol=0)
    # each draw has probability > 0 under the step before it
    lp = out["logprob"][:, :-1].gather(-1, inputs[:, 1:, None])
    assert torch.isfinite(lp).all()
    with pytest.raises(ValueError, match="generator"):
        tm(a, m, lab, ss_prob=0.5)


# ---------------------------------------------------------------------------
# AoANet on the attention core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["encode", "greedy", "beam"])
def test_aoa_attention_core_matches_jax(what):
    """use_pallas on both sides: the refiner's self-attentions and the
    decoder attention through the attention core (JAX: its TPU kernel in
    interpret mode; the port: the core's CPU twin), against JAX, and the
    port's plain path."""
    jm, params, tm, _ = pair("aoa")
    att, am = make_feats(seed=6)
    _, _, plain_mem, tsrc = memories(jm, params, tm, att, am)
    with pallas(tm, True):
        jmem, jsrc, tmem, tsrc = memories(jm, params, tm, att, am)
        if what == "encode":
            close(tmem, jmem)
            close(tmem, plain_mem)
            return
        if what == "greedy":
            want = jar.ar_sample(jm, params, jax.random.PRNGKey(0), jmem,
                                 jsrc)
            got = tar.ar_sample(tm, tmem, tsrc)
            keys = ("tok_logprobs", "entropy")
        else:
            want = jar.ar_beam_search(jm, params, jmem, jsrc, beam_size=3)
            got = tar.ar_beam_search(tm, tmem, tsrc, beam_size=3)
            keys = ("scores", "tok_logprobs")
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    for k in keys:
        close(got[k], want[k], what=k)


# ---------------------------------------------------------------------------
# training: the XE step, the RL re-score and steps
# ---------------------------------------------------------------------------

def train_batch():
    """One train batch (4 images x 2 captions) of a synthetic corpus with
    a varying region count."""
    cfg = tconfig.make_config(train_mode="AIC", input_json="synthetic",
                              input_att_dir="synthetic", batch_size=B,
                              seq_per_img=2, max_boxes=R, max_length=L,
                              data_prefetch=0)
    labels = tds.LabelStore.synthetic(n_images=20, vocab_size=VOCAB, L=L)
    feats = SyntheticFeatures(n_regions=R, variable_regions=True)
    return tds.CaptionData(cfg, labels=labels,
                           features=feats).get_batch("train")


_BATCH = []


def batch_state(cm):
    """The shared pair, the train batch, and the dict the RL checks read."""
    if not _BATCH:
        _BATCH.append(train_batch())
    jm, params, tm, tree = pair(cm)
    return {"jm": jm, "params": params, "tm": tm, "batch": _BATCH[0],
            "start": tree}


@pytest.mark.parametrize("cm", CMS)
def test_xe_step_matches_jax(cm):
    """One XE step, dropout off (AoANet's refiner drops at a fixed 0.1, so
    JAX runs deterministic): the loss and every gradient leaf."""
    s = batch_state(cm)
    b = s["batch"]
    jb = {k: jnp.asarray(np.asarray(b[k]))
          for k in ("att_feats", "att_masks", "labels", "masks")}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jsteps.xe_loss_fn(s["jm"], p, jb, jax.random.PRNGKey(0),
                                    None, 0.0, deterministic=True),
        has_aux=True))(s["params"])
    tm = s["tm"]
    loss, _ = tsteps.xe_loss_fn(tm, tsteps.to_device(b, "cpu"), None)
    grads = torch.autograd.grad(loss, list(tm.parameters()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(tm.parameters(), grads)]
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= REL * abs(float(jloss))
    same_grads(tm, grads, jgrads)


@pytest.mark.parametrize("cm", CMS)
def test_rl_rescore_matches_jax(cm):
    """rl_rescore's a_logprob (the LSTM branch: the full forward over the
    sampled rows), on fixed samples, against JAX's; plain under the
    attention core."""
    s = batch_state(cm)
    sm = fixed_samples(s, "AIC")
    b = s["batch"]
    jatt, jam = jnp.asarray(b["att_feats"]), jnp.asarray(b["att_masks"])
    want = jsteps.rl_rescore(s["jm"], s["params"], jax.random.PRNGKey(0),
                             jatt, jam, to_jax(sm), N)
    tm = s["tm"]
    tm.set_attention_core(True)
    try:
        got = tsteps.rl_rescore(tm, torch.from_numpy(b["att_feats"]),
                                torch.from_numpy(b["att_masks"]),
                                to_torch(sm), N)
    finally:
        tm.set_attention_core(False)
    assert sorted(got) == ["a_logprob"]
    assert got["a_logprob"].requires_grad
    close(got["a_logprob"].detach(), want["a_logprob"])


@pytest.mark.parametrize("cm", CMS)
def test_scst_step_matches_jax(cm):
    s = batch_state(cm)
    sm = fixed_samples(s, "AIC")
    b = s["batch"]
    att, am = torch.from_numpy(b["att_feats"]), torch.from_numpy(
        b["att_masks"])
    rs = np.random.RandomState(4)
    rewards = np.repeat(rs.randn(att.shape[0] * N, 1).astype(np.float32), L,
                        axis=1)
    tx = _jax_opt()
    # the JAX step donates its state: a copy of the shared weights
    state = jstate.create_state(
        jax.tree_util.tree_map(jnp.asarray, s["start"]), tx)
    state, jm_ = jsteps.make_scst_step(s["jm"], tx, {"train_sample_n": N})(
        state, jax.random.PRNGKey(1), jnp.asarray(b["att_feats"]),
        jnp.asarray(b["att_masks"]), to_jax(sm), jnp.asarray(rewards))
    tm_ = tsteps.make_scst_step(s["tm"], _port_opt(s["tm"]),
                                {"train_sample_n": N})(
        att, am, to_torch(sm), torch.from_numpy(rewards))
    _check_update(s, state, jm_, tm_)


@pytest.mark.parametrize("cm", CMS)
def test_rl_step_matches_jax(cm):
    """One structure-loss step (new_self_critical) on fixed samples and
    scores."""
    s = batch_state(cm)
    cfg = {"train_sample_n": N, "structure_loss_type": "new_self_critical"}
    sm = fixed_samples(s, "AIC")
    b = s["batch"]
    att, am = torch.from_numpy(b["att_feats"]), torch.from_numpy(
        b["att_masks"])
    scores = fixed_scores(att.shape[0], ("sample",))
    scales = _term_scales(s, sm)
    tx = _jax_opt()
    # the JAX step donates its state: a copy of the shared weights
    state = jstate.create_state(
        jax.tree_util.tree_map(jnp.asarray, s["start"]), tx)
    state, jm_ = jsteps.make_rl_step(s["jm"], tx, cfg)(
        state, jax.random.PRNGKey(1), jnp.asarray(b["att_feats"]),
        jnp.asarray(b["att_masks"]), to_jax(sm),
        {k: jnp.asarray(v) for k, v in scores.items()})
    tm_ = tsteps.make_rl_step(s["tm"], _port_opt(s["tm"]), cfg)(
        att, am, to_torch(sm),
        {k: torch.from_numpy(v) for k, v in scores.items()},
        rng=torch.Generator())
    _check_update(s, state, jm_, tm_, scales)


# ---------------------------------------------------------------------------
# end to end: checkpoints, eval, the CLIs, the server
# ---------------------------------------------------------------------------

# the eval CLI reads the synthetic corpus of its infos' options: 30
# images, 40 words, every region live
LOADER = dict(input_json="synthetic", input_att_dir="synthetic",
              batch_size=3)
CLI_VOCAB = 40


def loaders(cm):
    """A JAX and a port CaptionData over one 25-image corpus (a 5-image
    test split in batches of 3) with a varying region count."""
    out = []
    for mod, cfg, feats in ((jds, jax_cfg(cm, **LOADER), JaxFeatures),
                            (tds, port_cfg(cm, **LOADER),
                             SyntheticFeatures)):
        labels = mod.LabelStore.synthetic(n_images=25, vocab_size=CLI_VOCAB,
                                          L=L)
        out.append(mod.CaptionData(cfg, labels=labels, features=feats(
            n_regions=R, variable_regions=True)))
    return out


def same_predictions(got, want):
    assert [p["image_id"] for p in got] == [p["image_id"] for p in want]
    assert [p["caption"] for p in got] == [p["caption"] for p in want]
    for g, w in zip(got, want):
        for k in ("perplexity", "entropy"):
            assert (g[k] is None and w[k] is None) or abs(g[k] - w[k]) <= TOL
    assert any(p["caption"] for p in got)


@pytest.mark.parametrize("cm", ["fc", "aoa"])
def test_jax_checkpoint_through_eval_split_and_cli(cm, tmp_path,
                                                   monkeypatch, capsys):
    """The JAX package's save_checkpoint writes the model; the port's
    setup + load_jax_checkpoint read it, and its eval_split (greedy, with
    the eval loss) and its eval CLI give JAX's eval_split's captions."""
    jm, params, _, _ = build_pair(cm, seed=5, vocab=CLI_VOCAB)
    cfg = jax_cfg(cm, **LOADER, id="lstm",
                  checkpoint_path=str(tmp_path / "ck"))
    jdata, tdata = loaders(cm)
    infos = {"iter": 0, "epoch": 0, "loader_state_dict": None,
             "vocab": jdata.ix_to_word, "opt": dict(cfg),
             "best_val_score": None}
    jstate.save_checkpoint(cfg, jstate.create_state(params, optax.sgd(0.1)),
                           infos, {})
    ckpt = str(tmp_path / "ck" / "model.ckpt")
    kw = {"split": "test", "num_images": -1, "language_eval": 1,
          "verbose_loss": 1}
    want = jeu.eval_split(jm, params, jdata, dict(kw))
    tm = load_jax_checkpoint(ckpt, tsetup(port_cfg(cm), CLI_VOCAB, "cpu"))
    got = teu.eval_split(tm, tdata, dict(kw))
    same_predictions(got["predictions"], want["predictions"])
    assert abs(got["loss"] - want["loss"]) <= TOL * want["loss"]
    assert got["lang_stats"] == pytest.approx(want["lang_stats"], abs=TOL)
    # the eval CLI on the written files, over its own corpus
    jcli = jeu.eval_split(jm, params, jds.CaptionData(cfg),
                          {"split": "test", "num_images": -1,
                           "language_eval": 0, "verbose_loss": 0})
    monkeypatch.chdir(tmp_path)
    res = teval.main(["--model", ckpt, "--infos_path",
                      str(tmp_path / "ck" / "infos_lstm.pkl"), "--device",
                      "cpu", "--num_images", "-1", "--language_eval", "0",
                      "--split", "test"])
    assert "decode_time" in capsys.readouterr().out
    same_predictions(res["predictions"], jcli["predictions"])


@pytest.mark.parametrize("cm", ["fc", "aoa"])
def test_train_cli_checkpoint_reads_in_jax(cm, tmp_path):
    """The port's training CLI on an LSTM config (3 iterations, float32,
    the CPU): a validation, a model.ckpt that JAX's eval reads to the
    port's captions, and a resume from its own files."""
    ck = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    base = [sys.executable, "-m", "boficap_tpu_torch.tools.train", "--cfg",
            os.path.join(ROOT, "configs", f"{cm}.yml"), "--id", cm,
            "--checkpoint_path", str(ck), "--device", "cpu",
            "--input_json", "synthetic", "--input_att_dir", "synthetic",
            "--dtype", "float32",
            "--batch_size", "6", "--max_boxes", "9",
            "--input_encoding_size", "32", "--rnn_size", "48",
            "--num_att_heads", "2", "--N_enc", "1", "--max_length", str(L),
            "--val_images_use", "6",
            "--save_checkpoint_every", "2", "--language_eval", "0"]
    out = subprocess.run(base + ["--max_epochs", "1"], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "val[AIC]" in out.stdout
    infos = jstate.load_infos(str(ck), cm)
    opt = jax_default_config()
    opt.update(infos["opt"])
    jax_finalize(opt)
    jm = jax_setup(opt, infos["opt"]["vocab_size"])
    lab = jnp.ones((2, opt.max_length + 2), jnp.int32)
    template = jm.init({"params": jax.random.PRNGKey(0)},
                       jnp.zeros((2, 3, opt.att_feat_size)),
                       jnp.ones((2, 3)), lab, deterministic=True)
    params = jstate.load_params(str(ck / "model.ckpt"), template)
    kw = {"split": "test", "num_images": -1, "language_eval": 0,
          "verbose_loss": 1}
    want = jeu.eval_split(jm, params, jds.CaptionData(opt), dict(kw))
    topt = tconfig.default_config()
    topt.update(infos["opt"])
    tconfig.finalize(topt)
    tdata = tds.CaptionData(topt)
    tm = load_jax_checkpoint(str(ck / "model.ckpt"),
                             tsetup(topt, tdata.vocab_size, device="cpu"))
    got = teu.eval_split(tm, tdata, dict(kw))
    same_predictions(got["predictions"], want["predictions"])
    assert abs(got["loss"] - want["loss"]) <= TOL * want["loss"]
    out = subprocess.run(base + ["--max_epochs", "2", "--start_from",
                                 str(ck)], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert jstate.load_infos(str(ck), cm)["iter"] > infos["iter"]


@pytest.mark.parametrize("cm", ["updown", "aoa"])
def test_caption_server_aic_matches_direct_decode(cm):
    """CaptionServer(mode="AIC") on the CPU (aoa with use_pallas: the
    core's twin): each answer equals a direct ar_sample of its rows."""
    _, _, tm, _ = pair(cm)
    tm.set_attention_core(cm == "aoa")
    att, am = make_feats(n=5, seed=8)
    words = {str(i): f"w{i}" for i in range(4, VOCAB + 4)}
    srv = CaptionServer(tm, words, mode="AIC", max_batch=4, device="cpu")
    try:
        futs = [srv.submit(att[i], am[i]) for i in range(5)]
        outs = [f.wait(timeout=120) for f in futs]
    finally:
        srv.close()
    with torch.no_grad():
        a, m = torch.from_numpy(att), torch.from_numpy(am)
        want = tar.ar_sample(tm, tm.encode(a, m), m.bool())["seq"].numpy()
    tm.set_attention_core(False)
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o["seq"], want[i])
    assert any(o["caption"] for o in outs)
