"""The port's caption metrics and reward scorers (pure Python copies)
against the JAX package's on the same captions: BLEU, CIDEr-D, CIDEr (and
its self-CIDEr Gram matrix), ROUGE-L, METEOR_approx, SPICE_approx and
language_eval, with bad endings and empty captions.  The arithmetic is the
same on both sides, so values agree to 1e-9."""

import numpy as np
import pytest

from boficap_tpu.eval import meteor as jax_meteor
from boficap_tpu.eval import metrics as jax_metrics
from boficap_tpu.eval import spice as jax_spice
from boficap_tpu.rewards import bleu as jax_bleu
from boficap_tpu.rewards import cider as jax_cider
from boficap_tpu.rewards import ngrams as jax_ngrams
from boficap_tpu_torch.eval import meteor, metrics, spice
from boficap_tpu_torch.rewards import bleu, cider, ngrams

TOL = 1e-9
WORDS = ("a man woman dog cat riding sitting standing on in of with the "
         "horse beach street table red large two people is are photo "
         "picture next to near playing frisbee grass white black and an "
         "bus car holding umbrella young boy girl bike").split()


def _sentence(rs, lo=0, hi=12):
    return " ".join(rs.choice(WORDS, rs.randint(lo, hi + 1)))


def _corpus(seed=0, n=24):
    """{id: [5 refs]} and predictions, with empty captions and captions that
    end on a bad ending ('a', 'the', 'of', ...)."""
    rs = np.random.RandomState(seed)
    gts = {i: [_sentence(rs, 3, 12) for _ in range(5)] for i in range(n)}
    preds = []
    for i in range(n):
        cap = _sentence(rs, 0, 10)
        if i % 6 == 0:
            cap = ""
        elif i % 6 == 1:
            cap = cap + " the"
        preds.append({"image_id": i, "caption": cap.strip(),
                      "perplexity": float(rs.rand() * 3),
                      "entropy": None if i % 5 == 0 else float(rs.rand())})
    return gts, preds


def _close(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif a is None or isinstance(a, str):
        assert a == b
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_language_eval_matches_jax(seed):
    gts, preds = _corpus(seed)
    got = metrics.language_eval(preds, gts)
    want = jax_metrics.language_eval(preds, gts)
    _close(got, want)
    assert got["bad_count_rate"] > 0 and got["METEOR"] is None


def test_bleu_and_cider_scorers_match_jax():
    gts, preds = _corpus(2)
    res = {p["image_id"]: [p["caption"]] for p in preds}
    _close(bleu.Bleu(4).compute_score(gts, res),
           jax_bleu.Bleu(4).compute_score(gts, res))
    for name in ("CiderD", "Cider"):
        got = getattr(cider, name)(df="corpus").compute_score(gts, res)
        want = getattr(jax_cider, name)(df="corpus").compute_score(gts, res)
        _close(got, want)
    # a cached document frequency (rewards/ngrams.py), as RL loads it
    df, n = ngrams.build_doc_freq(gts.values())
    jdf, jn = jax_ngrams.build_doc_freq(gts.values())
    assert dict(df) == dict(jdf) and n == jn
    got = cider.CiderD(df="cached", df_dict=df, ref_len=n).compute_score(
        gts, res)
    want = jax_cider.CiderD(df="cached", df_dict=jdf, ref_len=jn
                            ).compute_score(gts, res)
    _close(got, want)
    groups = [[p["caption"] for p in preds[i:i + 4]] for i in (0, 8, 16)]
    for g, w in zip(cider.Cider().my_self_cider(groups),
                    jax_cider.Cider().my_self_cider(groups)):
        _close(g, w)


def test_rouge_meteor_spice_match_jax():
    gts, preds = _corpus(3)
    for p in preds:
        refs = gts[p["image_id"]]
        c = p["caption"]
        _close(metrics.rouge_l(c, refs), jax_metrics.rouge_l(c, refs))
        _close(meteor.meteor(c, refs), jax_meteor.meteor(c, refs))
        _close(spice.spice(c, refs), jax_spice.spice(c, refs))
    assert metrics.BAD_ENDINGS == jax_metrics.BAD_ENDINGS
