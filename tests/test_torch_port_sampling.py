"""The port's sampled decoding against the JAX package on the CPU.

The draws cannot equal the JAX package's (the RNGs differ), so the sampled
route is held three deterministic ways: the filters (``top_k_filter``,
``top_p_filter``) against JAX's on the same inputs, ties included; each
method's frequencies against its closed form (a fixed-seed chi-square
test); and ``top1`` decodes, NA, SA (plain and on the kernel wrappers'
twins), AR and ``uic_s_ar_decode``, against the JAX package's greedy
decodes on shared weights: plans and ``seq`` identical, ``tok_logprobs``
within 1e-5.  A sampled call without a generator raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from boficap_tpu.decode import ar as jar
from boficap_tpu.decode import bound_fill as jbf
from boficap_tpu.decode import sampling as jsampling
from boficap_tpu_torch.decode import ar as tar
from boficap_tpu_torch.decode import bound_fill as tbf
from boficap_tpu_torch.decode import sampling as tsampling
from tests._torch_port_util import make_feats, make_pair
from tests.test_torch_port_ar import _nudge_generator

DRAWS = 20_000
P_MIN = 1e-4                   # the chi-square test's bound on the p-value
KEYS_EXACT = ("seq", "phrase_num", "phrase_length", "phrase_syn")


def _tied_logprobs(seed: int, shape=(6, 3, 16)):
    """log-softmax rows whose logits take few distinct values, so the k-th
    largest and the nucleus threshold often fall on ties."""
    rs = np.random.RandomState(seed)
    logits = np.round(rs.randn(*shape) * 2) / 2
    return np.array(jax.nn.log_softmax(jnp.asarray(logits, jnp.float32)))


@pytest.mark.parametrize("k", [1, 2, 3, 7, 16])
def test_top_k_filter_matches_jax(k):
    lp = _tied_logprobs(1)
    want = np.asarray(jsampling.top_k_filter(jnp.asarray(lp), k))
    got = tsampling.top_k_filter(torch.from_numpy(lp), k).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # ties at the k-th value are kept: at least k entries survive a row
    assert ((got > tsampling.NEG_INF / 2).sum(-1) >= k).all()


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9, 0.99])
def test_top_p_filter_matches_jax(p):
    lp = _tied_logprobs(2)
    want = np.asarray(jsampling.top_p_filter(jnp.asarray(lp), p))
    got = tsampling.top_p_filter(torch.from_numpy(lp), p).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _draw_source(lp: np.ndarray, method: str, T: float) -> torch.Tensor:
    """The log-probs ``sample_next_word`` draws over: the law of its draw
    is their softmax."""
    x = torch.from_numpy(lp)
    if method == "gumbel":
        # argmax((lp + g) / T) = argmax(lp + g): the law is softmax(lp)
        return x
    x = x / T
    if method.startswith("top"):
        num = float(method[3:])
        x = (tsampling.top_p_filter(x, num) if 0 < num < 1
             else tsampling.top_k_filter(x, int(num)))
    return x


@pytest.mark.parametrize("method", ["sample", "gumbel", "top3", "top0.9"])
@pytest.mark.parametrize("T", [0.7, 1.0])
def test_sampling_law(method, T):
    """DRAWS draws from one fixed row against the closed form: a chi-square
    test on the words of non-zero probability, and no draw outside them."""
    lp = np.log(np.array([0.3, 0.2, 0.15, 0.12, 0.1, 0.08, 0.05],
                         np.float32))
    src = _draw_source(lp, method, T)
    want = torch.softmax(src.double(), -1).numpy()
    gen = torch.Generator().manual_seed(11)
    ids, tok = tsampling.sample_next_word(
        torch.from_numpy(lp).expand(DRAWS, -1), method, T, gen)
    counts = np.bincount(ids.numpy(), minlength=lp.size)
    live = want > 1e-9
    assert counts[~live].sum() == 0, (method, counts)
    expected = want[live] / want[live].sum()
    p = stats.chisquare(counts[live], DRAWS * expected)
    assert p.pvalue > P_MIN, (method, T, counts, want)
    # the gathered log-prob: the original for gumbel, the tempered and
    # filtered one for the sample family
    gathered = torch.from_numpy(lp) if method == "gumbel" else src
    np.testing.assert_allclose(tok.numpy(), gathered[ids].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_sampled_without_generator_raises():
    lp = torch.log_softmax(torch.randn(2, 5), -1)
    for method in ("sample", "gumbel", "top2", "top0.5"):
        with pytest.raises(ValueError, match="Generator"):
            tsampling.sample_next_word(lp, method)
    # greedy needs none
    ids, _ = tsampling.sample_next_word(lp, "greedy")
    assert torch.equal(ids, lp.argmax(-1))


# ---------------------------------------------------------------------------
# top1 decodes equal the JAX package's greedy decodes
# ---------------------------------------------------------------------------

def _np(out):
    return {k: np.array(v) for k, v in out.items()}


def _assert_same(got, want, keys=KEYS_EXACT, rtol=1e-5, atol=1e-5):
    for k in keys:
        if k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["tok_logprobs"], want["tok_logprobs"],
                               rtol=rtol, atol=atol)


def _memories(jm, params, tm, att, am):
    jmem = jm.apply(params, jnp.asarray(att), jnp.asarray(am),
                    deterministic=True, method="encode")
    with torch.no_grad():
        tmem = tm.encode(torch.from_numpy(att), torch.from_numpy(am))
    return (jmem, jnp.asarray(am).astype(bool), tmem,
            torch.from_numpy(am).bool())


@pytest.fixture(scope="module")
def uic():
    jm, params, tm = make_pair("UIC", "add", seed=4)
    att, am = make_feats(B=4, seed=5)
    return jm, params, tm, _memories(jm, params, tm, att, am)


@pytest.mark.parametrize("decoder", ["na", "sa"])
@pytest.mark.parametrize("fused", [False, True])
def test_top1_phrase_decodes_equal_jax_greedy(uic, decoder, fused):
    jm, params, tm, (jmem, jsrc, tmem, tsrc) = uic
    jdec = jbf.na_decode if decoder == "na" else jbf.sa_decode
    tdec = tbf.na_decode if decoder == "na" else tbf.sa_decode
    want = _np(jdec(jm, params, jax.random.PRNGKey(0), jmem, jsrc,
                    sample_method="greedy"))
    assert want["phrase_num"].max() > 0
    got = _np(tdec(tm, tmem, tsrc, sample_method="top1", fused_fill=fused,
                   generator=torch.Generator().manual_seed(0)))
    _assert_same(got, want)


def test_top1_ar_equals_jax_greedy():
    jm, params, tm = make_pair("AIC", seed=2)
    params = _nudge_generator(params, tm)
    att, am = make_feats(B=4, seed=5)
    jmem, jsrc, tmem, tsrc = _memories(jm, params, tm, att, am)
    want = _np(jar.ar_sample(jm, params, jax.random.PRNGKey(0), jmem, jsrc,
                             sample_method="greedy"))
    got = _np(tar.ar_sample(tm, tmem, tsrc, sample_method="top1",
                            generator=torch.Generator().manual_seed(0)))
    assert (want["seq"] > 3).any()
    _assert_same(got, want)


def test_top1_uic_s_ar_equals_jax_greedy():
    jm, params, tm = make_pair("UIC_s", "add", seed=4)
    params = _nudge_generator(params, tm)
    att, am = make_feats(B=4, seed=5)
    jmem, jsrc, tmem, tsrc = _memories(jm, params, tm, att, am)
    want = _np(jbf.uic_s_ar_decode(jm, params, jax.random.PRNGKey(0), jmem,
                                   jsrc, sample_method="greedy"))
    got = _np(tbf.uic_s_ar_decode(tm, tmem, tsrc, sample_method="top1",
                                  generator=torch.Generator().manual_seed(0)))
    assert want["phrase_num"].max() > 0
    _assert_same(got, want)


def test_sampled_decodes_are_seeded():
    """A sampled decode repeats bitwise from the same seed, and draws from
    its generator (another seed gives another caption somewhere)."""
    jm, params, tm = make_pair("UIC", "add", seed=4)
    att, am = make_feats(B=4, seed=5)
    _, _, tmem, tsrc = _memories(jm, params, tm, att, am)

    def run(seed):
        return tbf.sa_decode(tm, tmem.repeat_interleave(4, 0),
                             tsrc.repeat_interleave(4, 0),
                             sample_method="sample",
                             generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["seq"], c["seq"])
    with pytest.raises(ValueError, match="Generator"):
        tbf.na_decode(tm, tmem, tsrc, sample_method="sample")
