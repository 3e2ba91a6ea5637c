"""The port's XE training stage against the JAX package on the CPU, on
shared weights at float32 with dropout off: the loss, its terms and every
gradient of one step for UIC (self_dis), SAIC, NAIC, AIC (label smoothing)
and UIC_s, and with drop-worst at 0.5 in every mode; dropout at rate 1
(flax's exact zeros pin every site), the keep share at 0.1, a seeded step
repeated bitwise; GLAT at rates where its reveal is deterministic,
``ss_sa_forward`` at ss_prob 0; ``phrase_ops`` and every loss.  Updates,
checkpoints, the CLI and the eval loss:
``tests/test_torch_port_train_ckpt.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boficap_tpu import losses as jlosses
from boficap_tpu.data import phrase_ops as jpo
from boficap_tpu.train import steps as jsteps
from boficap_tpu_torch import losses as tlosses
from boficap_tpu_torch.data import phrase_ops as tpo
from boficap_tpu_torch.models.layers import dropout
from boficap_tpu_torch.train import steps as tsteps
from tests._torch_port_train_util import (REL, SMOOTHING, built_cache, close,
                                          jax_batch, jax_grad_fn, same_grads,
                                          train_loader)
from tests._torch_port_util import L, VOCAB, make_pair
from tests.oracles import random_phrase_row

MODES = ("UIC", "SAIC", "NAIC", "AIC", "UIC_s", "NNAIC", "UIC_ds", "UIC_u",
         "auto")


@pytest.fixture(scope="module")
def built():
    return built_cache()


@pytest.mark.parametrize("mode", MODES)
def test_xe_step_matches_jax(built, mode):
    """One step's loss, every metric and every gradient leaf."""
    s = built(mode)
    tm = s["tm"]
    tb = tsteps.to_device(s["batch"], "cpu")
    loss, metrics = tsteps.xe_loss_fn(tm, tb, torch.Generator(), None, 0.0,
                                      SMOOTHING.get(mode, 0.0))
    grads = torch.autograd.grad(loss, list(tm.parameters()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(tm.parameters(), grads)]
    close(loss.detach(), s["loss"])
    assert sorted(metrics) == sorted(s["metrics"])
    for k, v in s["metrics"].items():
        close(metrics[k], v)
    same_grads(tm, grads, s["grads"])


@pytest.mark.parametrize("mode", MODES)
def test_drop_worst_step_matches_jax(built, mode):
    """drop_worst_rate 0.5 inside ``xe_loss_fn``: the per-caption losses
    ranked and the worst half dropped, in both packages; the loss and
    every gradient leaf."""
    s = built(mode)
    smoothing = SMOOTHING.get(mode, 0.0)
    (jloss, _), jgrads = jax_grad_fn(s["jm"], smoothing, drop_worst=0.5)(
        s["params"], s["jb"], None)
    tm = s["tm"]
    tb = tsteps.to_device(s["batch"], "cpu")
    loss, _ = tsteps.xe_loss_fn(tm, tb, torch.Generator(), None, 0.5,
                                smoothing)
    grads = torch.autograd.grad(loss, list(tm.parameters()),
                                allow_unused=True)
    close(loss.detach(), jloss)
    # the dropped half moves the loss off the full batch's
    assert float(loss.detach()) != float(s["loss"])
    same_grads(tm, [torch.zeros_like(p) if g is None else g
                    for p, g in zip(tm.parameters(), grads)], jgrads)


def test_dropout_rate_one_matches_jax():
    """dropout = drop_prob_lm = 1: flax returns exact zeros at every site,
    so both packages' losses are deterministic and must agree."""
    jm, params, tm = make_pair("UIC", self_dis=True, dropout=1.0,
                               drop_prob_lm=1.0)
    jsteps.set_self_dis(jm, True)
    batch = train_loader("UIC").get_batch("train")
    jloss, _ = jax.jit(lambda p, b: jsteps.xe_loss_fn(
        jm, p, b, jax.random.PRNGKey(0), None, 0.0, deterministic=False))(
        params, jax_batch(batch))
    tloss, _ = tsteps.xe_loss_fn(tm, tsteps.to_device(batch, "cpu"),
                                 torch.Generator())
    close(tloss, jloss)
    x = torch.randn(64, 3)
    assert torch.equal(dropout(x, 1.0, torch.Generator()),
                       torch.zeros_like(x))


def test_dropout_law_and_determinism():
    """Keep share at p = 0.1 within 6 binomial sigmas, kept values scaled by
    1/0.9; no generator: the input itself; a seeded step repeats bitwise."""
    n = 200_000
    x = torch.ones(n)
    y = dropout(x, 0.1, torch.Generator().manual_seed(3))
    kept = int((y != 0).sum())
    sigma = (n * 0.9 * 0.1) ** 0.5
    assert abs(kept - 0.9 * n) <= 6 * sigma
    assert torch.all(y[y != 0] == torch.tensor(1 / 0.9))
    assert dropout(x, 0.1, None) is x
    _, _, tm = make_pair("UIC", seed=3)
    batch = tsteps.to_device(train_loader("UIC").get_batch("train"), "cpu")
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        loss, _ = tsteps.xe_loss_fn(tm, batch, gen, 0.3)
        grads = torch.autograd.grad(loss, list(tm.parameters()),
                                    allow_unused=True)
        runs.append((loss, grads))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("glat", [0.0, 1e9])
def test_glat_matches_jax(built, glat):
    """At glat_p 0 no word is revealed and at 1e9 every word of a sample
    with a mismatch is: the reveal is deterministic, so loss and mismatch
    rate agree."""
    s = built("NAIC")
    jloss, jmet = jax.jit(lambda p, b, g: jsteps.xe_loss_fn(
        s["jm"], p, b, jax.random.PRNGKey(0), g, 0.0, deterministic=False))(
        s["params"], s["jb"], jnp.float32(glat))
    tb = tsteps.to_device(s["batch"], "cpu")
    tloss, tmet = tsteps.xe_loss_fn(s["tm"], tb, torch.Generator(), glat)
    close(tloss, jloss)
    close(tmet["glat_mismatch"], jmet["glat_mismatch"])


def test_ss_sa_forward_matches_jax(built):
    """Scheduled sampling at ss_prob 0 takes the gt branch everywhere: the
    re-scored SA log-probs equal JAX's."""
    s = built("UIC")
    b = s["jb"]
    f = jsteps._flat(b)
    jout = jsteps.ss_sa_forward(s["jm"], s["params"], jax.random.PRNGKey(0),
                                b["att_feats"], b["att_masks"], f["labels"],
                                f["phrase_length"], f["phrase_syn"], 0.0,
                                deterministic=True)
    tb = tsteps.to_device(s["batch"], "cpu")
    tf = tsteps._flat(tb)
    with torch.no_grad():
        tout = tsteps.ss_sa_forward(s["tm"], torch.Generator(),
                                    tb["att_feats"], tb["att_masks"],
                                    tf["labels"], tf["phrase_length"],
                                    tf["phrase_syn"], 0.0)
    for got, want in zip(tout[:3], jout[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=0, atol=1e-4)


def _plans(n=40, seed=0):
    """Random phrase plans of width L + 2, with an empty plan and plans
    that fill L words."""
    rs = np.random.RandomState(seed)
    rows = [random_phrase_row(rs, L, vocab=VOCAB + 4) for _ in range(n)]
    labels = np.stack([r[0] for r in rows])
    num = np.array([r[1] for r in rows])
    pl = np.stack([r[2] for r in rows])
    syn = np.stack([r[3] for r in rows])
    pl[0] = 0
    pl[0, 0] = 1
    syn[0] = 0
    syn[0, :2] = (1, 2)
    num[0] = 1
    for i in (1, 2):                      # plans that fill L
        pl[i] = 0
        pl[i, 0] = 1
        pl[i, 1:1 + (L // 2)] = 2 if i == 1 else 0
        if i == 2:
            pl[i, 1] = L
        num[i] = int((pl[i, 1:] > 0).sum()) + 1
    return labels, num, pl, syn


def test_phrase_ops_match_jax():
    labels, num, pl, syn = _plans()
    t = {k: torch.from_numpy(v) for k, v in
         dict(labels=labels, num=num, pl=pl, syn=syn).items()}
    cases = [
        ("phrase_word_ends", (pl,), (t["pl"],)),
        ("total_words", (pl,), (t["pl"],)),
        ("extend_syn_seq", (pl, syn, L), (t["pl"], t["syn"], L)),
        ("copy_init", (labels, pl, L), (t["labels"], t["pl"], L)),
        ("blockwise_visible", (pl, L), (t["pl"], L)),
        ("blockwise_mask", (pl, L), (t["pl"], L)),
        ("bound_prefixes", (pl, L + 1), (t["pl"], L + 1)),
        ("bound_step_masks", (pl, L + 1, L + 2), (t["pl"], L + 1, L + 2)),
        ("word_loss_mask", (pl, L), (t["pl"], L)),
        ("slot_loss_mask", (num, L + 1), (t["num"], L + 1)),
    ]
    for name, jargs, targs in cases:
        want = getattr(jpo, name)(*jargs)
        got = getattr(tpo, name)(*targs)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    src, valid = tpo.copy_init_src_indices(t["pl"], L)
    jsrc, jvalid = jpo.copy_init_src_indices(pl, L)
    np.testing.assert_array_equal(src.numpy(), jsrc)
    np.testing.assert_array_equal(valid.numpy(), jvalid)


def _lp(rs, *shape):
    x = rs.randn(*shape).astype(np.float32)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_losses_match_jax(reduction):
    """Every criterion of losses.py on random log-probs and plans."""
    rs = np.random.RandomState(1)
    labels, num, pl, syn = _plans(8, seed=2)
    B, V, S = labels.shape[0], VOCAB + 4, L + 1
    word = [_lp(rs, B, L, V) for _ in range(3)]
    ln, sy = _lp(rs, B, S, 20), _lp(rs, B, S, 10)
    mask = (labels > 0).astype(np.float32)
    T = lambda x: torch.from_numpy(np.asarray(x))            # noqa: E731

    def both(name, *args, **kw):
        arr = [isinstance(a, np.ndarray) for a in args]
        want = getattr(jlosses, name)(*[jnp.asarray(a) if is_a else a
                                        for a, is_a in zip(args, arr)], **kw)
        got = getattr(tlosses, name)(*[T(a) if is_a else a
                                       for a, is_a in zip(args, arr)], **kw)
        if isinstance(want, dict):
            assert sorted(got) == sorted(want), name
            for k in want:
                np.testing.assert_allclose(got[k].numpy(), want[k],
                                           rtol=REL, atol=1e-6,
                                           err_msg=f"{name}.{k}")
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=REL,
                                       atol=1e-6, err_msg=name)

    tgt = labels[:, 1:]
    both("lm_loss", word[0], tgt, mask[:, 1:], reduction=reduction)
    both("label_smoothing_loss", word[0], tgt, mask[:, 1:], 0.1,
         reduction=reduction)
    both("naic_loss", ln, sy, word[0], num, pl, syn, labels,
         reduction=reduction)
    for sd in (False, True):
        both("uic_loss", ln, sy, word[0], ln[::-1].copy(), sy, word[1],
             num, pl, syn, labels, self_dis=sd, reduction=reduction)
    both("tuic_loss", ln, sy, word[0], word[1], word[2], num, pl, syn,
         labels, reduction=reduction)
    both("nnaic_loss", rs.randint(0, L, B).astype(np.float32), word[0],
         tgt, mask[:, 1:], reduction=reduction)
    seq = labels[:, 1:-1]
    both("reward_criterion", word[0], seq, rs.randn(B).astype(np.float32),
         reduction=reduction)
    both("pb_pad_loss", labels[:, 1:-1], word[0], mask[:, 1:-1], num,
         pl[:, 1:], ln, reduction=reduction)
    n = 4
    scores = rs.rand(B // n, n).astype(np.float32)
    for lt in ("seqnll", "risk", "max_margin", "multi_margin",
               "softmax_margin", "real_softmax_margin",
               "new_self_critical"):
        both("structure_loss", word[0], seq, scores, lt,
             entropy_reward_weight=0.1, reduction="mean")
    per = rs.rand(B).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.drop_worst(T(per), 0.25).numpy(),
        jlosses.drop_worst(jnp.asarray(per), 0.25), rtol=REL)


