"""Port parity, the diverse decoders: ``ar_diverse_beam_search``,
``ar_old_beam_search``, ``ar_diverse_sample``, eval's
``sample_n_captions`` and the multi-sample metrics, against the JAX
package on shared weights (CPU, float32).  ``seq`` identical, scores and
log-probs within 1e-5 (the legacy beam's row buffers and their sums
relative 1e-5, their -inf entries at the same places), metrics to 1e-9.

A sampled diverse decode cannot give the JAX package's draws (the RNGs
differ): its first step is held to the closed form of the penalised
distribution by a chi-square test instead."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from boficap_tpu.decode import ar as jar
from boficap_tpu.eval import eval_utils as jeu
from boficap_tpu.eval import multi_metrics as jmm
from boficap_tpu_torch.constants import BOS
from boficap_tpu_torch.decode import ar as tar
from boficap_tpu_torch.eval import eval_utils as teu
from boficap_tpu_torch.eval import multi_metrics as tmm
from boficap_tpu_torch.text import decode_sequence
from tests._torch_port_util import L, make_feats, make_pair
from tests.test_torch_port_ar import (IX_TO_WORD, _memories,
                                      _nudge_generator, _np, _same, pallas)

B = 4
TOL = 1e-5
OPTIONS = dict(temperature=0.7, decoding_constraint=True,
               suppress_unk_idx=11, bad_endings_ix=(47, 11))
DRAWS = 4000
P_MIN = 1e-4                   # the chi-square test's bound on the p-value


@pytest.fixture(scope="module")
def aic():
    jm, params, tm = make_pair("AIC", seed=2)
    params = _nudge_generator(params, tm)
    att, am = make_feats(B=B, seed=1)
    return (jm, params, tm) + _memories(jm, params, tm, att, am)


@pytest.mark.parametrize("K,G,penalty,options,core", [
    (4, 2, "", False, False), (4, 2, "wu_0.7", True, False),
    (3, 3, "avg_1.0", True, False), (6, 2, "", True, False),
    (4, 2, "", False, True)])
def test_diverse_beam_search_matches_jax(aic, K, G, penalty, options, core):
    """(K, G) = (4, 2), (3, 3) and (6, 2), with the length penalties and
    every option of the step; (4, 2) with use_pallas on both sides (the
    attention core at B·K/G rows a group)."""
    jm, params, tm, jmem, jsrc, tmem, tsrc = aic
    kw = dict(beam_size=K, group_size=G, diversity_lambda=0.8,
              length_penalty=penalty, **(OPTIONS if options else {}))
    with pallas(tm, core):
        want = jar.ar_diverse_beam_search(jm, params, jmem, jsrc, **kw)
        got = tar.ar_diverse_beam_search(tm, tmem, tsrc, **kw)
    _same(_np(got), want, close=("tok_logprobs", "scores"))
    assert got["seq"].shape == (B, K, L)
    # the diversity term changes the beams
    plain = tar.ar_diverse_beam_search(tm, tmem, tsrc,
                                       **{**kw, "diversity_lambda": 0.0})
    assert not torch.equal(got["seq"], plain["seq"])


def test_diverse_beam_search_rejects_uneven_groups(aic):
    _, _, tm, _, _, tmem, tsrc = aic
    with pytest.raises(ValueError, match="divide"):
        tar.ar_diverse_beam_search(tm, tmem, tsrc, beam_size=4, group_size=3)


def _same_rows(got, want):
    """Row buffers: -inf at the same places, the rest relative 1e-5."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("G,constrained", [
    (1, False), (1, True), (2, False), (2, True)])
def test_old_beam_search_matches_jax(aic, G, constrained):
    """The legacy loop for one and two groups, with and without
    decoding_constraint and remove_bad_endings (the exact -inf they write
    reaches the stored rows); the two-group constrained case also at
    T = 0.7, a length penalty and suppress_unk_idx."""
    jm, params, tm, jmem, jsrc, tmem, tsrc = aic
    kw = dict(beam_size=3 * G, group_size=G, diversity_lambda=0.8)
    if constrained:
        kw.update(decoding_constraint=True, remove_bad_endings=True,
                  bad_endings_ix=(47, 11))
        if G == 2:
            kw.update(temperature=0.7, length_penalty="wu_0.7",
                      suppress_unk_idx=11)
    want = jar.ar_old_beam_search(jm, params, jmem, jsrc, **kw)
    got = _np(tar.ar_old_beam_search(tm, tmem, tsrc, **kw))
    np.testing.assert_array_equal(got["seq"], np.asarray(want["seq"]))
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]),
                               rtol=TOL, atol=TOL)
    _same_rows(got["row_logprobs"], want["row_logprobs"])
    _same_rows(got["unaug_p"], want["unaug_p"])
    assert got["row_logprobs"].shape == (B, 3 * G, L, tm.tgt_vocab)
    assert np.isneginf(got["row_logprobs"]).any() == constrained


@pytest.mark.parametrize("options", [False, True])
def test_diverse_sample_greedy_matches_jax(aic, options):
    """Three greedy groups, each penalised by the earlier groups' words;
    with decoding_constraint, block_trigrams and bad endings."""
    jm, params, tm, jmem, jsrc, tmem, tsrc = aic
    kw = dict(group_size=3, diversity_lambda=0.8)
    if options:
        kw.update(decoding_constraint=True, block_trigrams=True,
                  bad_endings_ix=(47, 11))
    want = jar.ar_diverse_sample(jm, params, jax.random.PRNGKey(0), jmem,
                                 jsrc, **kw)
    got = _np(tar.ar_diverse_sample(tm, tmem, tsrc, **kw))
    _same(got, want, close=("tok_logprobs",))
    assert got["seq"].shape == (B, 3, L)
    assert (got["seq"][:, 0] != got["seq"][:, 1]).any()


def test_diverse_sample_law(aic):
    """Two sampled groups (T = 0.7, lambda = 1.5) of DRAWS copies of one
    image: the pairs of first words against the closed form p0(w0) x
    q(w1 | w0), p0 = softmax(lp0 / T) and q = softmax((lp0 - lambda
    e_w0) / T), lp0 the first step's log-probs (a chi-square test over the
    pairs expected at least 5 times, the rest pooled); both groups draw
    from the one generator."""
    _, _, tm, _, _, tmem, tsrc = aic
    T, lam = 0.7, 1.5
    mem = tmem[:1].expand(DRAWS, -1, -1)
    src = tsrc[:1].expand(DRAWS, -1)
    gen = torch.Generator().manual_seed(5)
    out = tar.ar_diverse_sample(tm, mem, src, group_size=2,
                                diversity_lambda=lam, sample_method="sample",
                                temperature=T, generator=gen)
    with torch.no_grad():
        lp0, _ = tm.ar_step(torch.full((1,), BOS), 0,
                            tm.init_ar_cache(tmem[:1], L + 1), tsrc[:1])
    lp0 = lp0[0].double()
    V = lp0.numel()
    p0 = torch.softmax(lp0 / T, -1)
    q = torch.softmax((lp0[None, :] - lam * torch.eye(V, dtype=lp0.dtype))
                      / T, -1)
    expected = (DRAWS * p0[:, None] * q).flatten().numpy()
    w = out["seq"][:, :, 0]
    counts = np.bincount((w[:, 0] * V + w[:, 1]).numpy(), minlength=V * V)
    big = expected >= 5
    assert big.sum() >= 10
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    assert stats.chisquare(obs, exp).pvalue > P_MIN
    # the penalty shows: the second group repeats the first's word less
    same = float((w[:, 0] == w[:, 1]).float().mean())
    assert same < float((p0 * p0).sum())


@pytest.mark.parametrize("method", ["bs", "dbs", "dgreedy"])
def test_sample_n_captions_matches_jax(aic, method):
    jm, params, tm, jmem, jsrc, tmem, tsrc = aic
    kw = {"sample_n": 3, "sample_n_method": method, "diversity_lambda": 0.8,
          "decoding_constraint": 1}
    want = np.asarray(jeu.sample_n_captions(jm, params, jmem, jsrc,
                                            jax.random.PRNGKey(0), kw))
    got = teu.sample_n_captions(tm, tmem, tsrc, kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (B, 3, L)


def test_multi_sample_eval_matches_jax(aic):
    """div1/div2/mBLEU_4, the oracle scores, self-CIDEr and the in-process
    allspice stand-in on the same n_predictions and references."""
    _, _, tm, _, _, tmem, tsrc = aic
    ids = teu.sample_n_captions(tm, tmem, tsrc, {
        "sample_n": 3, "sample_n_method": "dgreedy",
        "diversity_lambda": 2.0}).numpy()
    preds, gts = [], {}
    rs = np.random.RandomState(4)
    for i in range(B):
        for cap in decode_sequence(IX_TO_WORD, ids[i]):
            preds.append({"image_id": i, "caption": cap})
        gts[i] = decode_sequence(IX_TO_WORD, rs.randint(4, 50, (5, L)))
    assert len({p["caption"] for p in preds}) > B
    got = tmm.multi_sample_eval(preds, gts)
    want = jmm.multi_sample_eval(preds, gts)
    assert sorted(got) == sorted(want)
    assert got["allspice"] is None
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            assert abs(got[k] - v) <= 1e-9, (k, got[k], v)
