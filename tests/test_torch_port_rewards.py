"""The port's RL rewards (``rewards/self_critical.py``, ``native/``) against
the JAX package's on the same arrays (CPU): ``pack_refs``, ``get_scores``,
``get_self_critical_reward``, ``get_self_cider_scores`` and
``rl_host_scores`` to 1e-6, with the native scorer and with the Python one;
the port's native and Python paths against each other; a cached df
(``cached_tokens``) pickle built from the synthetic corpus; and the native
scorer's errors."""

import numpy as np
import pytest
import torch

from boficap_tpu.native import get_ciderd as jax_native
from boficap_tpu.rewards import ngrams as jngrams
from boficap_tpu.rewards import self_critical as jsc
from boficap_tpu.train import steps as jsteps
from boficap_tpu_torch import native as tnative
from boficap_tpu_torch.ops._build import load_once
from boficap_tpu_torch.rewards import self_critical as tsc
from boficap_tpu_torch.train import steps as tsteps
from tests._torch_port_train_util import train_loader
from tests._torch_port_util import L, VOCAB

N = 3                           # samples an image
TOL = dict(rtol=1e-6, atol=1e-6)


def _opt(**kw):
    """The options the reward functions read, as a dict."""
    return {"train_sample_n": N, "cider_reward_weight": 1,
            "bleu_reward_weight": 0, **kw}


@pytest.fixture(scope="module")
def batch():
    """A synthetic train batch's references and seeded sampled ids: some
    rows copy a reference, the rest random, zeros after a random end."""
    data = train_loader("UIC", batch_size=4).get_batch("train")
    gts = data["gts"]
    rs = np.random.RandomState(7)
    n_img = len(gts)
    seqs = rs.randint(4, VOCAB + 4, (n_img * N, L)).astype(np.int64)
    for r in range(n_img * N):
        if r % N == 0:
            seqs[r] = gts[r // N][0][:L]
        end = rs.randint(1, L + 1)
        seqs[r, end:] = 0
    greedy = seqs[::N].copy()
    greedy[:, 3:] = 0
    return gts, seqs, greedy


def _init_both(cached="corpus", use_native=True, base_dir="data"):
    jsc.init_scorer(cached, base_dir=base_dir, use_native=use_native)
    tsc.init_scorer(cached, base_dir=base_dir, use_native=use_native)
    if use_native:
        assert jsc._native is not None and tsc._native is not None


def test_pack_refs_matches_jax(batch):
    gts = batch[0]
    for a, b in zip(tsc.pack_refs(gts), jsc.pack_refs(gts)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("use_native", [True, False])
def test_scores_match_jax(batch, use_native):
    gts, seqs, greedy = batch
    _init_both(use_native=use_native)
    opt = _opt()
    np.testing.assert_allclose(tsc.get_scores(gts, seqs, opt),
                               jsc.get_scores(gts, seqs, opt), **TOL)
    np.testing.assert_allclose(
        tsc.get_self_critical_reward(greedy, gts, seqs, opt),
        jsc.get_self_critical_reward(greedy, gts, seqs, opt), **TOL)
    np.testing.assert_allclose(tsc.get_self_cider_scores(gts, seqs, opt),
                               jsc.get_self_cider_scores(gts, seqs, opt),
                               **TOL)
    # BLEU on: the string path in both packages
    bleu = _opt(bleu_reward_weight=0.5)
    np.testing.assert_allclose(tsc.get_scores(gts, seqs, bleu),
                               jsc.get_scores(gts, seqs, bleu), **TOL)


@pytest.mark.parametrize("use_native", [True, False])
def test_rl_host_scores_match_jax(batch, use_native):
    """Every branch, with the self-CIDEr bonus, and the classic SCST
    reward; the port's ids arrive as tensors (one copy to the host)."""
    gts, seqs, greedy = batch
    _init_both(use_native=use_native)
    opt = _opt(self_cider_reward_weight=0.5)
    jsamples = {k: {"seq": seqs} for k in ("sa", "na", "sample")}
    tsamples = {k: {"seq": torch.from_numpy(seqs)} for k in jsamples}
    want = jsteps.rl_host_scores(jsamples, gts, opt)
    got = tsteps.rl_host_scores(tsamples, gts, opt)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL)
    assert got["sa"].shape == (len(gts), N)
    scst = {"sample": {"seq": seqs}, "greedy": {"seq": greedy}}
    want = jsteps.rl_host_scores(scst, gts, opt, classic_scst=True)
    got = tsteps.rl_host_scores(
        {k: {"seq": torch.from_numpy(v["seq"])} for k, v in scst.items()},
        gts, opt, classic_scst=True)
    np.testing.assert_allclose(got["scst_reward"], want["scst_reward"],
                               **TOL)


def test_native_matches_python_scorer(batch):
    gts, seqs, greedy = batch
    opt = _opt()
    out = {}
    for use_native in (True, False):
        tsc.init_scorer("corpus", use_native=use_native)
        out[use_native] = (tsc.get_scores(gts, seqs, opt),
                           tsc.get_self_critical_reward(greedy, gts, seqs,
                                                        opt))
    for a, b in zip(out[True], out[False]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_native_bitwise_jax_native():
    """The port's copy of ciderd.cpp gives the JAX package's scores bit for
    bit, both entries, corpus and cached df."""
    port, jax_ = tnative.get_ciderd(), jax_native()
    rs = np.random.RandomState(3)

    def sent():
        words = rs.randint(4, 30, rs.randint(1, 12))
        return " ".join(map(str, words)) + " 0"

    cands = [sent() for _ in range(24)]
    refs = [[sent() for _ in range(rs.randint(1, 5))] for _ in cands]
    c = rs.randint(0, 30, (24, L)).astype(np.int32)
    cw = np.full(24, L, np.int32)
    bank = rs.randint(0, 30, (6, 4, L + 1)).astype(np.int32)
    rc = rs.randint(1, 5, 6).astype(np.int32)
    rw = np.full(6, L + 1, np.int32)
    idx = (np.arange(24) // 4).astype(np.int32)
    for df in (None, (["4", "4 5", "6 7 8", "9 10 11 12"],
                      [3.0, 2.0, 1.0, 1.0], 12.0)):
        for s in (port, jax_):
            s.set_df(*df) if df else s.clear_df()
        assert port.score(cands, refs) == jax_.score(cands, refs)
        assert (port.score_ids(c, cw, bank, rc, rw, idx)
                == jax_.score_ids(c, cw, bank, rc, rw, idx))
    port.clear_df()
    jax_.clear_df()


def test_cached_tokens_df_pickle(batch, tmp_path):
    """A df pickle of the synthetic corpus' references (the
    scripts/prepro_ngrams.py layout) as ``cached_tokens``: both packages and
    both scorers give the same scores, and not the corpus-mode ones."""
    gts, seqs, greedy = batch
    loader = train_loader("UIC", batch_size=4)
    st = loader.labels
    refs = []
    for ix in range(len(st.label_start_ix)):
        rows = st.labels[st.label_start_ix[ix] - 1:st.label_end_ix[ix]]
        refs.append([jsc.array_to_str(np.append(r[r > 0], 0)) for r in rows])
    df, n = jngrams.build_doc_freq(refs)
    jngrams.save_doc_freq(str(tmp_path / "synth-idxs.p"), df, n)
    opt = _opt()
    _init_both(use_native=False)
    corpus = tsc.get_scores(gts, seqs, opt)
    got = {}
    for use_native in (True, False):
        _init_both("synth-idxs", use_native=use_native,
                   base_dir=str(tmp_path))
        want = jsc.get_scores(gts, seqs, opt)
        got[use_native] = tsc.get_scores(gts, seqs, opt)
        np.testing.assert_allclose(got[use_native], want, **TOL)
    np.testing.assert_allclose(got[True], got[False], rtol=1e-5, atol=1e-6)
    assert not np.allclose(got[False], corpus)
    tsc.init_scorer("corpus")


def test_native_errors_and_no_fallback(monkeypatch, tmp_path):
    """Bad arguments raise; a failed build raises from init_scorer (no
    quiet fallback); use_native=False runs the Python scorer without it."""
    s = tnative.get_ciderd()
    ok = np.zeros((2, 3), np.int32)
    w = np.full(2, 3, np.int32)
    bank = np.zeros((1, 1, 3), np.int32)
    one = np.ones(1, np.int32)
    with pytest.raises(ValueError, match="int32"):
        s.score_ids(ok.astype(np.int64), w, bank, one, one * 3,
                    np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="shape mismatch"):
        s.score_ids(ok, w[:1], bank, one, one * 3, np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="out of range"):
        s.score_ids(ok, w, bank, one, one * 3, np.full(2, 5, np.int32))
    with pytest.raises(ValueError, match="out of range"):
        s.score_ids(ok, w, bank, one * 2, one * 3, np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="length mismatch"):
        s.score(["1 0"], [])
    with pytest.raises(TypeError):
        s.score(["1 0"], ["1 0"])

    # a fresh load-once, so that this process builds again
    monkeypatch.setattr(tnative, "_scorer", load_once(tnative._load))
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(tnative, "SOURCE", tmp_path / "broken.cpp")
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tsc.init_scorer("corpus")
    assert not list((tmp_path / "b").glob("*.tmp"))
    tsc.init_scorer("corpus", use_native=False)
    assert tsc._native is None
    gts = [np.array([[4, 5, 6, 0]]), np.array([[7, 8, 9, 0]])]
    got = tsc.get_scores(gts, np.array([[4, 5, 6, 0], [4, 5, 6, 0]]),
                         _opt(train_sample_n=1))
    assert got[0] > got[1]
