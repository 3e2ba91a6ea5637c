"""Port parity on trained weights, the AR decodes (CPU, float32): the
branches that random weights with a raised EOS bias never take for real.

A small AIC model (tiny_cfg's widths, L = 20) is trained by the port on a
seeded corpus built in memory in the layout of
``scripts/make_synth_corpus.py`` (``tests/_torch_port_trained_util.py``),
and its weights carried to the JAX package.  Held against JAX:
``ar_sample`` greedy, ``ar_beam_search`` at K = 3 with and without a
length penalty, the diverse beam search at 2 groups, each also with the
attention core's twin against JAX's interpret-mode kernel (#9), and
``eval_split`` AIC greedy and at beam K.

The model is an AIC one: a UIC model has no AR decoder
(``DECODER_ROLES['UIC']`` is SA and NA, in both packages).  The collate
pins EOS at the frame's last slot (``data/dataset.py``), so a model
trained on the script's label rows learns to emit PAD after a caption,
which ends the caption's text but not the decode's row: both packages'
loops end a row on EOS only, and every beam would enter the done pool at
the last step.  The corpus' rows here hold EOS after their last word, so
the model learns to end its rows; its captions are 5 or 6 words
(``SHORT``), so the done pools hold ended beams of two lengths.  The
fixture asserts both.

seq is identical except in a sample whose first differing word (in a beam
search: any top-K selection) lies where the port's own top-2 gap is below
NOISE, the cross-backend noise on trained weights
(``tests/test_trained_parity.py``); log-probs and scores within TOL.
The SA, RL-sampler and scheduled-sampling holds on a trained UIC model
are in ``tests/test_torch_port_trained_uic.py``.

Alone: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_trained.py
-q -p no:randomly`` (about 30 s on one worker)."""

import math

import jax
import numpy as np
import pytest
import torch

from boficap_tpu.decode import ar as jar
from boficap_tpu.eval import eval_utils as jeu
from boficap_tpu.models.layers import set_pallas_attention
from boficap_tpu_torch.constants import EOS, PAD
from boficap_tpu_torch.decode import ar as tar
from boficap_tpu_torch.decode.sampling import NEG_INF
from boficap_tpu_torch.eval import eval_utils as teu
from tests._torch_port_trained_util import (DEC_B, L, loaders, to_np,
                                            trained_pair)

torch.set_num_threads(2)

NOISE = 1e-3        # cross-backend noise of a top-2 gap on trained weights
TOL = 1e-5          # log-probs, scores, entropies
LANG_TOL = 1e-9     # lang_stats where the captions are equal
K = 3               # beams


# ---------------------------------------------------------------------------
# the port's own top-2 gaps, recorded during its decode
# ---------------------------------------------------------------------------

def greedy_gaps(tm, decode):
    """decode()'s outputs and each AR step's top-2 log-prob gap [B, steps],
    read at the generator."""
    gaps, generate = [], tm.generate

    def record(h):
        lp = generate(h)
        top2 = lp.topk(2, dim=-1).values
        gaps.append((top2[..., 0] - top2[..., 1]).reshape(h.shape[0], -1))
        return lp

    tm.generate = record
    try:
        out = decode()
    finally:
        del tm.generate
    return to_np(out), torch.cat(gaps, -1).numpy()


def beam_gaps(decode, n):
    """decode()'s outputs and each sample's smallest gap between
    neighbouring entries of any top-K selection it made (candidates and
    done-pool merges; NEG_INF fillers left out)."""
    top_k, mins = tar._top_k, torch.full((n,), math.inf)

    def record(x, k):
        vals, idx = top_k(x, min(k + 1, x.shape[-1]))
        gap = torch.where(vals[..., 1:] > NEG_INF / 2,
                          vals[..., :-1] - vals[..., 1:], math.inf)
        mins.copy_(torch.minimum(mins, gap.reshape(n, -1).min(-1).values))
        return vals[..., :k], idx[..., :k]

    tar._top_k = record
    try:
        out = decode()
    finally:
        tar._top_k = top_k
    return to_np(out), mins.numpy()


def same_ar(got, want, gaps, close=("tok_logprobs", "entropy")):
    """seq identical but where the first differing word's gap is below
    NOISE; ``close`` within TOL in the other samples."""
    diff = got["seq"] != want["seq"]
    has = diff.any(-1)
    first = diff.argmax(-1)
    excused = has & (gaps[np.arange(len(first)), first] < NOISE)
    assert not (has & ~excused).any(), np.nonzero(has & ~excused)
    for k in close:
        np.testing.assert_allclose(got[k][~has], np.asarray(want[k])[~has],
                                   rtol=TOL, atol=TOL, err_msg=k)


def same_beams(got, want, gaps):
    """Done pools identical (seq) but in a sample with a selection gap
    below NOISE; scores and token log-probs within TOL in the others."""
    n = got["seq"].shape[0]
    diff = (got["seq"] != want["seq"]).reshape(n, -1).any(-1)
    excused = diff & (gaps < NOISE)
    assert not (diff & ~excused).any(), np.nonzero(diff & ~excused)
    for k in ("scores", "tok_logprobs"):
        np.testing.assert_allclose(got[k][~diff], np.asarray(want[k])[~diff],
                                   rtol=TOL, atol=TOL, err_msg=k)


def end_pos(seq):
    """Each row's EOS position, L where it has none."""
    is_end = seq == EOS
    return np.where(is_end.any(-1), is_end.argmax(-1), L)


# ---------------------------------------------------------------------------
# the trained pair
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def aic():
    """The AIC pair, its reach asserted: at least half of the greedy rows
    end before L, and some sample's beam-3 done pool holds ended beams of
    two lengths."""
    p = trained_pair("AIC", eos=True)
    tm = p.tm
    seq = tar.ar_sample(tm, p.tmem, p.tsrc)["seq"].numpy()
    ends = end_pos(seq)
    assert (ends < L - 1).mean() >= 0.5, ends
    pool = tar.ar_beam_search(tm, p.tmem, p.tsrc, beam_size=K)["seq"]
    pool_ends = end_pos(pool.numpy())
    assert (pool_ends < L).all()
    assert (pool_ends.min(-1) != pool_ends.max(-1)).any(), pool_ends
    return p


@pytest.fixture
def core(request, aic):
    """use_pallas on both sides when the test's ``core`` is set: JAX's
    attention-core kernel in interpret mode (a process global, reset in
    finally) and the port's attention-core routing (its twin here)."""
    on = request.param
    aic.tm.set_attention_core(on)
    set_pallas_attention(on, interpret=True)
    try:
        yield on
    finally:
        set_pallas_attention(False)
        aic.tm.set_attention_core(False)


# ---------------------------------------------------------------------------
# AR: greedy, beam search, diverse beam search, eval_split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("core", [False, True], indirect=True)
def test_ar_sample_matches_jax(aic, core):
    p = aic
    want = jar.ar_sample(p.jm, p.params, jax.random.PRNGKey(0), p.jmem,
                         p.jsrc)
    got, gaps = greedy_gaps(p.tm, lambda: tar.ar_sample(p.tm, p.tmem,
                                                        p.tsrc))
    same_ar(got, want, gaps)
    ends = end_pos(got["seq"])
    after = np.arange(L)[None, :] > ends[:, None]
    assert (got["seq"][after] == PAD).all()
    assert not got["tok_logprobs"][after].any()


@pytest.mark.parametrize("core", [False, True], indirect=True)
@pytest.mark.parametrize("penalty", ["", "wu_0.7"])
def test_ar_beam_search_matches_jax(aic, core, penalty):
    """K = 3 with and without a length penalty: the done pools (beams of
    two lengths) and their scores."""
    p = aic
    want = jar.ar_beam_search(p.jm, p.params, p.jmem, p.jsrc, beam_size=K,
                              length_penalty=penalty)
    got, gaps = beam_gaps(lambda: tar.ar_beam_search(
        p.tm, p.tmem, p.tsrc, beam_size=K, length_penalty=penalty), DEC_B)
    same_beams(got, want, gaps)
    ends = end_pos(got["seq"])
    assert (ends.min(-1) != ends.max(-1)).any()


@pytest.mark.parametrize("core", [False, True], indirect=True)
def test_ar_diverse_beam_search_matches_jax(aic, core):
    """Beam 4 in 2 groups."""
    p = aic
    want = jar.ar_diverse_beam_search(p.jm, p.params, p.jmem, p.jsrc,
                                      beam_size=4, group_size=2)
    got, gaps = beam_gaps(lambda: tar.ar_diverse_beam_search(
        p.tm, p.tmem, p.tsrc, beam_size=4, group_size=2), DEC_B)
    same_beams(got, want, gaps)


@pytest.mark.parametrize("beam", [1, K])
def test_eval_split_aic_matches_jax(aic, beam):
    """eval_split AIC over the val split (20 images, two batches): the
    captions, each prediction's perplexity and entropy and their means
    within TOL, the language metrics within LANG_TOL."""
    jdata, tdata = loaders(aic.data, "AIC", batch_size=10)
    kw = {"split": "val", "num_images": -1, "language_eval": 1,
          "beam_size": beam, "verbose_loss": 0}
    want = jeu.eval_split(aic.jm, aic.params, jdata, dict(kw),
                          inference_mode="AIC")
    got = teu.eval_split(aic.tm, tdata, dict(kw), inference_mode="AIC")
    gp, wp = got["predictions"], want["predictions"]
    assert [g["image_id"] for g in gp] == [w["image_id"] for w in wp]
    assert [g["caption"] for g in gp] == [w["caption"] for w in wp]
    assert all(g["caption"] for g in gp)
    for g, w in zip(gp, wp):
        for k in ("perplexity", "entropy"):
            assert (g[k] is None) == (w[k] is None)
            if w[k] is not None:
                assert abs(g[k] - w[k]) <= TOL, (k, g[k], w[k])
    gs, ws = dict(got["lang_stats"]), dict(want["lang_stats"])
    for k in ("perplexity", "entropy"):    # means of the token log-probs
        g, w = gs.pop(k), ws.pop(k)
        assert (g is None and w is None) or abs(g - w) <= TOL, k
    assert sorted(gs) == sorted(ws)
    for k, w in ws.items():
        if isinstance(w, float):
            assert abs(gs[k] - w) <= LANG_TOL * max(1.0, abs(w)), (k, gs[k], w)
        else:
            assert gs[k] == w, k
    assert gs["CIDEr"] > 0
