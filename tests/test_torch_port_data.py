"""The port's data layer (``data/readers.py``, ``data/dataset.py``) against
the JAX package's on the same configuration: the synthetic corpus and
features, every batch key bitwise for train (with and without the
prefetcher), val and test across a wrap, PB_pad's packed layouts, sampler
state round trips, and the label files the JAX package writes (CPU)."""

import numpy as np
import pytest

from boficap_tpu.config import default_config as jax_default_config
from boficap_tpu.config import finalize as jax_finalize
from boficap_tpu.data import dataset as jds
from boficap_tpu.data import readers as jrd
from boficap_tpu_torch.config import default_config, finalize
from boficap_tpu_torch.data import dataset as tds
from boficap_tpu_torch.data import readers as trd


def _cfgs(**kw):
    """The same options on both sides."""
    out = []
    for make, fin in ((jax_default_config, jax_finalize),
                      (default_config, finalize)):
        cfg = make()
        cfg.update({"train_mode": "UIC", "input_json": "synthetic",
                    "input_att_dir": "synthetic", "batch_size": 4,
                    "max_boxes": 9, "seq_per_img": 3, "seed": 5, **kw})
        out.append(fin(cfg))
    return out


def _same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k
        elif k == "gts":
            assert len(g) == len(w)
            assert all(np.array_equal(a, b) for a, b in zip(g, w))
        else:
            assert g == w, k


def test_synthetic_store_and_features_equal_jax():
    for kw in ({}, {"n_images": 50, "vocab_size": 97, "L": 12, "seed": 3}):
        a, b = tds.LabelStore.synthetic(**kw), jds.LabelStore.synthetic(**kw)
        assert a.images == b.images and a.ix_to_word == b.ix_to_word
        for k in ("labels", "label_start_ix", "label_end_ix", "phrase_num",
                  "phrase_length", "phrase_syn"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k
    for var in (False, True):
        fa = trd.SyntheticFeatures(n_regions=20, dim=16, variable_regions=var)
        fb = jrd.SyntheticFeatures(n_regions=20, dim=16, variable_regions=var)
        for key in ("0", "17", "img"):
            assert fa.get(key).tobytes() == fb.get(key).tobytes()


@pytest.mark.parametrize("prefetch", [0, 2])
def test_batches_equal_jax_across_a_wrap(prefetch):
    """18 train images at B = 4: 7 batches wrap the split twice; val and
    test (6 images) wrap once."""
    jcfg, tcfg = _cfgs(data_prefetch=prefetch)
    jd, td = jds.CaptionData(jcfg), tds.CaptionData(tcfg)
    try:
        for split, n in (("train", 7), ("val", 3), ("test", 3)):
            wrapped = False
            for _ in range(n):
                want, got = jd.get_batch(split), td.get_batch(split)
                _same_batch(got, want)
                wrapped |= want["bounds"]["wrapped"]
            assert wrapped, split
    finally:
        jd._close_prefetcher()
        td._close_prefetcher()


@pytest.mark.parametrize("pp_mode", ["word", "phrase_2"])
def test_pp_mode_batches_equal_jax(pp_mode):
    jcfg, tcfg = _cfgs(preprocess_mode=pp_mode, data_prefetch=0)
    jd, td = jds.CaptionData(jcfg), tds.CaptionData(tcfg)
    for _ in range(3):
        _same_batch(td.get_batch("train"), jd.get_batch("train"))


def test_state_dict_resumes_at_the_same_batch():
    """A loader restored from state_dict (taken with batches in the
    prefetch queue) draws the batch the first would have drawn next."""
    _, tcfg = _cfgs(data_prefetch=2)
    a = tds.CaptionData(tcfg)
    try:
        for _ in range(3):
            a.get_batch("train")
        a.get_batch("val")
        state = a.state_dict()
        nxt_train, nxt_val = a.get_batch("train"), a.get_batch("val")
    finally:
        a._close_prefetcher()
    b = tds.CaptionData(tcfg)
    try:
        b.load_state_dict(state)
        for split, want in (("train", nxt_train), ("val", nxt_val)):
            got = b.get_batch(split)
            assert [i["ix"] for i in got["infos"]] == [
                i["ix"] for i in want["infos"]]
            assert got["bounds"] == want["bounds"]
            assert got["att_feats"].tobytes() == want["att_feats"].tobytes()
    finally:
        b._close_prefetcher()


def test_from_files_equals_jax(tmp_path):
    """Label files written by the JAX package's LabelStore.save read to the
    same store; a loader over them gives JAX's batches."""
    jds.LabelStore.synthetic(n_images=20, vocab_size=30, L=10,
                             seed=4).save(str(tmp_path))
    args = (str(tmp_path / "data.json"), str(tmp_path / "label.h5"))
    for phrases in (False, True):
        a = tds.LabelStore.from_files(*args, need_phrases=phrases)
        b = jds.LabelStore.from_files(*args, need_phrases=phrases)
        assert a.images == b.images and a.ix_to_word == b.ix_to_word
        for k in ("labels", "label_start_ix", "label_end_ix", "phrase_num",
                  "phrase_length", "phrase_syn"):
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None and y is None) or np.array_equal(x, y), k
    jcfg, tcfg = _cfgs(input_json=args[0], input_label_h5=args[1],
                       data_prefetch=0, max_length=10)
    jd, td = jds.CaptionData(jcfg), tds.CaptionData(tcfg)
    for split in ("train", "test"):
        _same_batch(td.get_batch(split), jd.get_batch(split))


def test_directory_feature_reader_equals_jax(tmp_path):
    rs = np.random.RandomState(0)
    for i in range(3):
        np.savez(tmp_path / f"{i}.npz", feat=rs.randn(5, 8).astype(np.float32))
    for mem in (False, True):
        a = trd.FeatureReader(str(tmp_path), ".npz", in_memory=mem)
        b = jrd.FeatureReader(str(tmp_path), ".npz", in_memory=mem)
        for i in range(3):
            assert a.get(str(i)).tobytes() == b.get(str(i)).tobytes()


@pytest.mark.parametrize("prefetch", [0, 2])
def test_pb_pad_batches_match_jax(prefetch):
    """PB_pad batches carry the packed layouts (pb_labels, pb_word_mask,
    pb_ids, pb_slot, pb_mask) bitwise as the JAX package's, train (with
    and without the prefetcher) and test across a wrap."""
    jcfg, tcfg = _cfgs(train_mode="PB_pad", data_prefetch=prefetch)
    jd, td = jds.CaptionData(jcfg), tds.CaptionData(tcfg)
    try:
        for split in ("train", "train", "test", "test"):
            got, want = td.get_batch(split), jd.get_batch(split)
            assert "pb_mask" in got and got["pb_mask"].dtype == bool
            _same_batch(got, want)
    finally:
        jd._close_prefetcher()
        td._close_prefetcher()
