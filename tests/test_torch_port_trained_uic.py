"""Port parity on a trained UIC model (CPU, float32): SA rounds wider than
the window in ``sa_decode`` and the RL sampler, and scheduled sampling
above ``ss_prob`` 0.

A small UIC model (tiny_cfg's widths, L = 20) is trained by the port on a
seeded corpus built in memory in the layout of
``scripts/make_synth_corpus.py`` (``tests/_torch_port_trained_util.py``),
and its weights carried to the JAX package.

  * Wide rounds: the corpus' phrases have at most 3 words, so a trained
    model never plans one wider than the window (``SA_WINDOW``).  The
    length head's LONG-word bias is raised, in both packages, until about
    SHARE of the plans open with a LONG-word phrase (chip_smoke.py's
    ``shape_plans`` nudge).  Then ``sa_decode`` greedy on the plain route
    and on the windowed fill's twins, and the RL sampler at top1, against
    JAX's greedy sampler, and ``rl_rescore`` of those samples: plans, seq
    and the wide rounds identical, log-probs within TOL.
  * Scheduled sampling at ``ss_prob`` SS, greedy, with both loops given the
    same coins: the port's through ``bound_fill._ss_coins``, JAX's by a
    stand-in for ``jax.random`` inside its loop body (``jax_coins``), which
    reads the same table by step; nothing in the JAX package changes.  The
    loop's outputs identical and the XE loss and gradients of
    ``xe_loss_fn`` (PR 10's rule), on the trained pair, on the same pair
    with every plan opening with a LONG-word phrase (a clamped sample then
    takes the gt branch), and on random weights.

Alone: ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_port_trained_uic.py -q -p no:randomly`` (about 30 s on one
worker)."""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boficap_tpu.decode import bound_fill as jbf
from boficap_tpu.train import steps as jsteps
from boficap_tpu_torch.constants import LEN, PAD
from boficap_tpu_torch.convert import init_params, to_jax_tree
from boficap_tpu_torch.decode import bound_fill as tbf
from boficap_tpu_torch.train import steps as tsteps
from tests._torch_port_train_util import jax_batch, same_grads
from tests._torch_port_trained_util import (DEC_B, L, VOCAB, ArrayFeatures,
                                            loader_fields, memories,
                                            model_cfg, port_cfg, stores,
                                            to_np, trained_pair)

torch.set_num_threads(2)

TOL = 1e-5          # log-probs, the loss (relative)
LONG = 10           # the opening phrase the shaped plans take (> the window)
SHARE = 0.2         # ... in about this share of the plans
SS = 0.5            # ss_prob
SN = 2              # the RL sampler's samples an image


@pytest.fixture(scope="module")
def uic():
    return trained_pair("UIC")


# ---------------------------------------------------------------------------
# SA rounds wider than the window: sa_decode and the RL sampler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shaped(uic):
    """The UIC pair with the length head's LONG-word bias raised until
    about SHARE of the decode batch's plans open with a LONG-word phrase
    (read on the port's first bounding step), in both packages."""
    tm = copy.deepcopy(uic.tm)
    return _shift_pair(uic, tm, _long_shift(tm, uic.tmem, uic.tsrc, SHARE))


def _long_shift(tm, mem, src, q):
    """The raise of the LONG-word length bias that makes LONG the first
    phrase's argmax in a share ``q`` of the samples of ``mem``."""
    with torch.no_grad():
        B = mem.shape[0]
        ids = torch.full((B, L + 2), PAD, dtype=torch.long)
        ids[:, 0] = LEN
        len_lp, _ = tm.bound_step_cached(tm.bound_cache(mem, False), ids,
                                         torch.ones(B, dtype=torch.long),
                                         src, use_syn=False)
        others = len_lp.clone()
        others[:, LONG] = -math.inf
        gap = others.max(-1).values - len_lp[:, LONG]
        return float(torch.quantile(gap, q)) + 1e-3


def _shift_pair(base, tm, shift):
    """A copy of ``base`` whose port model is ``tm`` with the LONG-word
    length bias raised by ``shift``, the JAX params the same."""
    with torch.no_grad():
        tm.len_head2.bias[LONG] += shift
    tm.invalidate_packed()
    p = copy.copy(base)
    p.tm = tm
    p.params = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(tm))
    return p


def wide_rounds(phrase_length):
    """The rounds a plan takes wider than the window: the phrase slots
    whose longest phrase over the batch is."""
    return int((np.asarray(phrase_length).max(0) > tbf.SA_WINDOW).sum())


@pytest.fixture(scope="module")
def jax_sampler(shaped):
    """JAX's RL sampler at greedy on the shaped pair (SN samples an image:
    its SA branch is the greedy SA decode of the repeated memory)."""
    p = shaped
    out = jsteps.make_rl_sample(p.jm, "greedy", 1.0, SN)(
        p.params, jax.random.PRNGKey(0), jnp.asarray(p.att),
        jnp.asarray(p.am))
    return {k: to_np(v) for k, v in out.items()}


PLAN = ("seq", "phrase_num", "phrase_length", "phrase_syn")


@pytest.mark.parametrize("route", ["plain", "window_layer", "window_stack"])
def test_sa_decode_wide_rounds_match_jax(shaped, jax_sampler, route):
    """Greedy SA on the shaped plans: the plain route and the windowed
    fill's twins (per layer and whole stack), each against JAX: plans and
    seq identical, the wide rounds the plan's, log-probs within TOL."""
    p, want = shaped, jax_sampler["sa"]
    stats = {}
    got = to_np(tbf.sa_decode(p.tm, p.tmem.repeat_interleave(SN, 0),
                            p.tsrc.repeat_interleave(SN, 0),
                            fused_fill=route != "plain",
                            stacked=route == "window_stack", stats=stats))
    for k in PLAN:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("tok_logprobs", "entropy"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    wide = wide_rounds(want["phrase_length"])
    assert wide >= 1
    opens = (want["phrase_length"][:, 0] == LONG).mean()
    assert 0 < opens < 0.5, opens
    if route != "plain":
        assert stats["wide"] == wide, stats


def test_rl_sampler_wide_rounds_match_jax(shaped, jax_sampler, monkeypatch):
    """The RL sampler at top1 against JAX's greedy sampler on the shaped
    plans (SA with wide rounds, NA), then rl_rescore of those samples."""
    p, want = shaped, jax_sampler
    rounds = []
    sa_decode = tbf.sa_decode

    def counting(*a, **kw):
        stats = {}
        out = sa_decode(*a, stats=stats, **kw)
        rounds.append(stats)
        return out

    monkeypatch.setattr(tbf, "sa_decode", counting)
    att, am = torch.from_numpy(p.att), torch.from_numpy(p.am)
    got = tsteps.make_rl_sample(p.tm, "top1", 1.0, SN)(
        att, am, torch.Generator().manual_seed(0))
    for branch in ("sa", "na"):
        g, w = to_np(got[branch]), to_np(want[branch])
        for k in PLAN:
            np.testing.assert_array_equal(g[k], w[k], err_msg=(branch, k))
        np.testing.assert_allclose(g["tok_logprobs"], w["tok_logprobs"],
                                   rtol=TOL, atol=TOL, err_msg=branch)
    wide = wide_rounds(want["sa"]["phrase_length"])
    assert len(rounds) == 1 and rounds[0]["wide"] == wide >= 1, rounds

    tl = tsteps.rl_rescore(p.tm, att, am, got, SN)
    jl = jsteps.rl_rescore(p.jm, p.params, jax.random.PRNGKey(0),
                           jnp.asarray(p.att), jnp.asarray(p.am),
                           {k: {n: jnp.asarray(x) for n, x in v.items()}
                            for k, v in want.items()}, SN)
    for k in ("sa_logprob", "na_logprob"):
        np.testing.assert_allclose(tl[k].detach().numpy(), np.asarray(jl[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


# ---------------------------------------------------------------------------
# scheduled sampling at ss_prob 0.5 with shared coins
# ---------------------------------------------------------------------------

class _CoinRandom:
    """``jax.random`` for the JAX loop body's draws: a key is (step, slot)
    as uint32, ``split`` moves the step on by one and numbers the slots,
    and ``uniform`` of slot 2 (the body's coin key) or 3 (its bos-input
    key) reads row ``step`` of the table: 0 where the coin is set, else
    1."""

    def __init__(self, coin_u, sub_u):
        self.coin_u, self.sub_u = coin_u, sub_u

    def split(self, key, num=2):
        step = key[0] + jnp.uint32(1)
        return jnp.stack([jnp.stack([step, jnp.uint32(k)])
                          for k in range(num)])

    def uniform(self, key, shape=(), *args, **kwargs):
        return jnp.where(key[1] == 2, self.coin_u[key[0]],
                         self.sub_u[key[0]])

    def __getattr__(self, name):
        return getattr(jax.random, name)


class _JaxWithRandom:
    def __init__(self, random):
        self.random = random

    def __getattr__(self, name):
        return getattr(jax, name)


def jax_coins(fn, coin_u, sub_u):
    """fn() with JAX's ss_sa_loop drawing its coins from the tables: the
    loop's ``jax`` is one whose ``random`` is ``_CoinRandom``, and its rng
    the key (0, 0); both restored after."""
    loop = jbf.ss_sa_loop

    def fixed(model, params, rng, *args, **kwargs):
        return loop(model, params, jnp.zeros(2, jnp.uint32), *args, **kwargs)

    jbf.jax = _JaxWithRandom(_CoinRandom(coin_u, sub_u))
    jbf.ss_sa_loop = fixed
    try:
        return fn()
    finally:
        jbf.jax = jax
        jbf.ss_sa_loop = loop


def coin_tables(B, seed, model_first=False):
    """[L + 2, B] bool: each step's model-branch and bos-input coins.
    ``model_first``: every sample takes the model's plan at step 1 and the
    gt plan at step 2."""
    rs = np.random.RandomState(seed)
    use = rs.rand(L + 2, B) < SS
    bos = rs.rand(L + 2, B) < 0.5
    if model_first:
        use[1], use[2] = True, False
    return use, bos


def port_coins(monkeypatch, use, bos):
    monkeypatch.setattr(tbf, "_ss_coins", lambda step, B, ss_prob, rng, dev:
                        (torch.from_numpy(use[step]),
                         torch.from_numpy(bos[step])))


@pytest.fixture(scope="module")
def ss_pairs(uic):
    """The pairs of the scheduled-sampling cases: the trained UIC pair;
    the same with every plan opening with a LONG-word phrase, so that the
    second phrase step clamps (a sample taking the gt branch there ends on
    the model's length); and random weights of the same model, the heads
    nudged as make_pair's so that plans are not empty."""
    tm = copy.deepcopy(uic.tm)
    clamp = _shift_pair(uic, tm, _long_shift(tm, uic.tmem, uic.tsrc, 1.0)
                        + 1.0)
    rnd = init_params(port_cfg(model_cfg("UIC")), VOCAB, seed=1,
                      device="cpu").eval()
    with torch.no_grad():
        rs = np.random.RandomState(101)
        rnd.len_head2.bias += torch.from_numpy(
            np.array([1.0] + [1.5] * 3 + [0.0] * 16, np.float32)
            + rs.randn(20).astype(np.float32) * 0.5)
        rnd.syn_head2.bias += torch.tensor([0.0] * 4 + [2.0] * 3 + [0.0] * 3)
    rnd.invalidate_packed()
    return {"trained": uic, "clamp": clamp,
            "random": _shift_pair(uic, rnd, 0.0)}


@pytest.fixture(scope="module")
def ss_batch(uic):
    """One train batch of DEC_B images (one caption each)."""
    from boficap_tpu_torch.data import dataset as tds
    cfg = port_cfg(model_cfg("UIC"), **loader_fields(DEC_B))
    loader = tds.CaptionData(cfg, labels=stores(uic.data)[1],
                             features=ArrayFeatures(uic.data[2]))
    return loader.get_batch("train")


LOOP = ("extend_word", "extend_syn", "extend_len", "plan_len", "plan_syn",
        "vis_dec", "seq")
SS_CASES = ["trained", "clamp", "random"]


@pytest.fixture(scope="module")
def jax_ss_loop(uic):
    """JAX's ss_sa_loop of the UIC model, jitted once for every case (the
    weights and the coin tables are its arguments)."""
    jm = uic.jm

    @jax.jit
    def f(params, mem, src, lab, pl, ps, coin_u, sub_u):
        return jax_coins(lambda: jbf.ss_sa_loop(
            jm, params, None, mem, src, lab, pl, ps, SS), coin_u, sub_u)
    return f


@pytest.mark.parametrize("case", SS_CASES)
def test_ss_sa_loop_matches_jax(ss_pairs, ss_batch, jax_ss_loop, case,
                                monkeypatch):
    """The loop's outputs identical given the same coins; in the clamp
    case some sample clamps at a step where it takes the gt branch."""
    p = ss_pairs[case]
    b = tsteps.to_device(ss_batch, "cpu")
    att, am = b["att_feats"], b["att_masks"]
    lab, pl, ps = (b[k][:, 0] for k in ("labels", "phrase_length",
                                        "phrase_syn"))
    B = lab.shape[0]
    use, bos = coin_tables(B, seed=3, model_first=case == "clamp")
    jmem, jsrc, tmem, tsrc = memories(p.jm, p.params, p.tm, att.numpy(),
                                       am.numpy())
    f = jax_ss_loop
    want = to_np(f(p.params, jmem, jsrc, *(jnp.asarray(x.numpy(), jnp.int32)
                                        for x in (lab, pl, ps)),
                 jnp.asarray(np.where(use, 0.0, 1.0), jnp.float32),
                 jnp.asarray(np.where(bos, 0.0, 1.0), jnp.float32)))
    port_coins(monkeypatch, use, bos)
    steps = []
    bound = p.tm.bound_step_cached

    def record(cache, ids, prefix, *a, **kw):
        out = bound(cache, ids, prefix, *a, **kw)
        steps.append((out[0].argmax(-1), prefix.clone()))
        return out

    monkeypatch.setattr(p.tm, "bound_step_cached", record)
    got = to_np(tbf.ss_sa_loop(p.tm, tmem, tsrc, lab, pl, ps, SS,
                             torch.Generator().manual_seed(0)))
    for k in LOOP:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["plan_len"][:, 1:] > 0).any()
    took_model = [(use[i] & (got["plan_len"][:, i] > 0)).any()
                  for i in range(1, len(steps) + 1)]
    assert any(took_model)
    if case == "clamp":
        clamped_gt = [((len_n + prefix).numpy() >= L + 1) & ~use[i]
                      & (got["plan_len"][:, i] > 0)
                      for i, (len_n, prefix) in enumerate(steps, 1)]
        assert np.any(clamped_gt)


@pytest.fixture(scope="module")
def jax_ss_grads(uic):
    """JAX's XE loss and gradients of the UIC model at ss_prob SS, jitted
    once for every case (the weights and the coin tables are arguments)."""
    jm = uic.jm

    @jax.jit
    def f(params, batch, coin_u, sub_u):
        def lf(q):
            return jsteps.xe_loss_fn(jm, q, batch, jax.random.PRNGKey(0),
                                     -1.0, 0.0, deterministic=True,
                                     ss_prob=SS)
        return jax_coins(lambda: jax.value_and_grad(lf, has_aux=True)(
            params), coin_u, sub_u)
    return f


@pytest.mark.parametrize("case", SS_CASES)
def test_ss_xe_loss_and_grads_match_jax(ss_pairs, ss_batch, jax_ss_grads,
                                        case, monkeypatch):
    """xe_loss_fn at ss_prob SS (ss_sa_forward, then the NA branch and the
    UIC loss) with the same coins: the loss within 1e-5 relative, each
    gradient leaf within 1e-4 of its largest magnitude."""
    p = ss_pairs[case]
    B = ss_batch["labels"].shape[0]
    use, bos = coin_tables(B, seed=5, model_first=case == "clamp")
    f = jax_ss_grads
    (jloss, _), jgrads = f(p.params, jax_batch(ss_batch),
                           jnp.asarray(np.where(use, 0.0, 1.0), jnp.float32),
                           jnp.asarray(np.where(bos, 0.0, 1.0), jnp.float32))
    port_coins(monkeypatch, use, bos)
    loss, _ = tsteps.xe_loss_fn(p.tm, tsteps.to_device(ss_batch, "cpu"),
                                torch.Generator().manual_seed(0), ss_prob=SS)
    grads = torch.autograd.grad(loss, list(p.tm.parameters()),
                                allow_unused=True)
    assert abs(float(loss.detach()) - float(jloss)) <= TOL * abs(float(jloss))
    same_grads(p.tm, [torch.zeros_like(w) if g is None else g
                      for w, g in zip(p.tm.parameters(), grads)], jgrads)
