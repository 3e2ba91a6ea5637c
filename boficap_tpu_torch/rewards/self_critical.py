"""Self-critical reward plumbing: the port's copy of the JAX package's
``rewards/self_critical.py`` (parity with captioning/utils/rewards.py).

Host-side: sequences arrive as numpy int arrays (one device-to-host copy of
the sampled ids a step), rewards leave as numpy float arrays (copied back
to the card for the RL loss).  The scorers are initialised once per run
from a cached df pickle or 'corpus' mode, as the reference's
``init_scorer`` does (rewards.py:25-31).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import List, Optional

import numpy as np

from .bleu import Bleu
from .cider import Cider, CiderD
from .ngrams import load_doc_freq

CiderD_scorer: Optional[CiderD] = None
Cider_scorer: Optional[Cider] = None
Bleu_scorer: Optional[Bleu] = None
_native = None


def init_scorer(cached_tokens: str = "corpus", base_dir: str = "data",
                use_native: bool = True):
    """cached_tokens: 'corpus' or the stem of a '<stem>-idxs.p' pickle
    produced by scripts/prepro_ngrams.py.

    ``use_native`` (the default): the native C++ CIDEr-D
    (``boficap_tpu_torch/native``) scores the RL steps, built at first use;
    a failed build raises.  The Python scorer runs only when the caller
    passes ``use_native=False``; it stays the oracle of the tests and the
    scorer of the metrics."""
    global CiderD_scorer, Cider_scorer, Bleu_scorer, _native
    df_dict, ref_len = None, None
    if cached_tokens and cached_tokens != "corpus":
        path = cached_tokens if cached_tokens.endswith(".p") else \
            os.path.join(base_dir, cached_tokens + ".p")
        if os.path.exists(path):
            df_dict, ref_len = load_doc_freq(path)
    mode = "cached" if df_dict is not None else "corpus"
    CiderD_scorer = CiderD(df=mode, df_dict=df_dict, ref_len=ref_len)
    Cider_scorer = Cider(df=mode, df_dict=df_dict, ref_len=ref_len)
    Bleu_scorer = Bleu(4)
    _native = None
    if use_native:
        from ..native import get_ciderd
        _native = get_ciderd()
        if df_dict is not None:
            keys = [" ".join(k) for k in df_dict.keys()]
            _native.set_df(keys, [float(v) for v in df_dict.values()],
                           float(ref_len))
        else:
            _native.clear_df()


def _cider_scores(res_list, refs_list):
    """res_list: [cand str]; refs_list: [[ref str]] aligned.  The native
    C++ scorer when ``init_scorer`` loaded it, else the Python one
    (identical results, tested)."""
    if _native is not None:
        return np.asarray(_native.score(res_list, list(refs_list)),
                          np.float32)
    gts = {i: r for i, r in enumerate(refs_list)}
    res = [{"image_id": i, "caption": [c]} for i, c in enumerate(res_list)]
    _, scores = CiderD_scorer.compute_score(gts, res)
    return scores.astype(np.float32)


def _native_ids() -> bool:
    """True when the native scorer (and its int-array entry) is loaded."""
    return _native is not None


def pack_refs(data_gts):
    """Pack per-image reference id rows into the [M, R, L] int32 bank +
    counts + true-width arrays ``_ciderd.score_ids`` consumes.  Zero
    padding is safe because the true width rides alongside (a row filled
    to its width without a 0 must NOT grow a trailing '0' token — the
    array_to_str convention the string path implements).  Shared across
    branches in the UIC RL step, like _gts_dict was for the string path."""
    M = len(data_gts)
    arrs = [np.asarray(g) for g in data_gts]
    R = max((a.shape[0] for a in arrs), default=1)
    L = max((a.shape[1] for a in arrs), default=1)
    bank = np.zeros((M, R, L), np.int32)
    counts = np.zeros((M,), np.int32)
    widths = np.zeros((M,), np.int32)
    for m, a in enumerate(arrs):
        bank[m, :a.shape[0], :a.shape[1]] = a
        counts[m] = a.shape[0]
        widths[m] = a.shape[1]
    return bank, counts, widths


def _cider_scores_ids(cands: np.ndarray, cand_width: np.ndarray,
                      gts_pack, img_idx: np.ndarray) -> np.ndarray:
    bank, counts, widths = gts_pack
    out = _native.score_ids(
        np.ascontiguousarray(cands, np.int32),
        np.ascontiguousarray(cand_width, np.int32), bank, counts, widths,
        np.ascontiguousarray(img_idx, np.int32))
    return np.asarray(out, np.float32)


def array_to_str(arr) -> str:
    """Space-joined token ids, stopping at the first 0 (rewards.py:33-39)."""
    out = []
    for x in arr:
        out.append(str(int(x)))
        if int(x) == 0:
            break
    # the reference includes the terminating '0'; strip() only whitespace
    return " ".join(out)


def _opt_get(opt, key, default):
    if hasattr(opt, "get"):
        return opt.get(key, default)
    return getattr(opt, key, default)


def _gts_dict(data_gts) -> "OrderedDict[int, List[str]]":
    gts = OrderedDict()
    for i, img_refs in enumerate(data_gts):
        gts[i] = [array_to_str(img_refs[j]) for j in range(len(img_refs))]
    return gts


def get_self_critical_reward(greedy_res: np.ndarray, data_gts,
                             gen_result: np.ndarray, opt) -> np.ndarray:
    """Classic SCST: reward = score(sample) - score(greedy baseline)
    (rewards.py:41-84).  Returns [B*n, L] rewards broadcast over time."""
    batch_size = len(data_gts)
    gen_result = np.asarray(gen_result)
    greedy_res = np.asarray(greedy_res)
    n_gen = gen_result.shape[0]
    seq_per_img = n_gen // batch_size

    cw = _opt_get(opt, "cider_reward_weight", 1)
    bw = _opt_get(opt, "bleu_reward_weight", 0)
    use_ids = _native_ids() and not (bw > 0)
    if not use_ids:
        res = {i: [array_to_str(gen_result[i])] for i in range(n_gen)}
        res.update({n_gen + i: [array_to_str(greedy_res[i])]
                    for i in range(batch_size)})
        gts0 = _gts_dict(data_gts)
        gts = {i: gts0[i // seq_per_img] for i in range(n_gen)}
        gts.update({n_gen + i: gts0[i] for i in range(batch_size)})
    scores = 0.0
    if cw > 0:
        if use_ids:
            # one native call over [gen; greedy] — corpus-mode df must see
            # the combined candidate set (ref_len = n_gen + B), exactly
            # like the single score() call the string path makes
            Lg, Lb = gen_result.shape[1], greedy_res.shape[1]
            L = max(Lg, Lb)
            cands = np.zeros((n_gen + batch_size, L), np.int32)
            cands[:n_gen, :Lg] = gen_result
            cands[n_gen:, :Lb] = greedy_res
            width = np.concatenate([np.full(n_gen, Lg, np.int32),
                                    np.full(batch_size, Lb, np.int32)])
            img_idx = np.concatenate([
                np.arange(n_gen, dtype=np.int32) // seq_per_img,
                np.arange(batch_size, dtype=np.int32)])
            cider = _cider_scores_ids(cands, width, pack_refs(data_gts),
                                      img_idx)
        else:
            ids = list(range(n_gen + batch_size))
            cider = _cider_scores([res[i][0] for i in ids],
                                  [gts[i] for i in ids])
        scores = scores + cw * cider
    if bw > 0:
        _, bleu = Bleu_scorer.compute_score(gts, res)
        scores = scores + bw * np.array(bleu[3])

    adv = (scores[:n_gen].reshape(batch_size, seq_per_img)
           - scores[n_gen:][:, None]).reshape(n_gen)
    return np.repeat(adv[:, None], gen_result.shape[1], 1).astype(np.float32)


def get_scores(data_gts, gen_result: np.ndarray, opt,
               gts_strs=None, gts_pack=None) -> np.ndarray:
    """Per-sample scores for the structure losses (rewards.py:86-117).

    ``gts_strs`` / ``gts_pack``: precomputed shared reference forms — the
    UIC RL step scores two branches (SA + NA) against the SAME references,
    and reference serialization was ~15% of the host phase; callers scoring
    several branches share one (train/steps.py::rl_host_scores).
    ``gts_strs`` is a ``_gts_dict(data_gts)`` for the string path,
    ``gts_pack`` a ``pack_refs(data_gts)`` for the native int-array path
    (used when the extension exposes score_ids and BLEU is off)."""
    gen_result = np.asarray(gen_result)
    B = gen_result.shape[0]
    seq_per_img = B // len(data_gts)

    cw = _opt_get(opt, "cider_reward_weight", 1)
    bw = _opt_get(opt, "bleu_reward_weight", 0)
    use_ids = _native_ids() and not (bw > 0)
    if not use_ids:
        res = {i: [array_to_str(gen_result[i])] for i in range(B)}
        gts0 = _gts_dict(data_gts) if gts_strs is None else gts_strs
        gts = {i: gts0[i // seq_per_img] for i in range(B)}
    scores = 0.0
    if cw > 0:
        if use_ids:
            width = np.full(B, gen_result.shape[1], np.int32)
            img_idx = np.arange(B, dtype=np.int32) // seq_per_img
            pack = pack_refs(data_gts) if gts_pack is None else gts_pack
            cider = _cider_scores_ids(gen_result, width, pack, img_idx)
        else:
            cider = _cider_scores([res[i][0] for i in range(B)],
                                  [gts[i] for i in range(B)])
        scores = scores + cw * cider
    if bw > 0:
        _, bleu = Bleu_scorer.compute_score(gts, res)
        scores = scores + bw * np.array(bleu[3])
    return np.asarray(scores, np.float32)


def get_self_cider_scores(data_gts, gen_result: np.ndarray, opt) -> np.ndarray:
    """Eigenvalue diversity of each image's sample group (rewards.py:119-138)."""
    gen_result = np.asarray(gen_result)
    B = gen_result.shape[0]
    seq_per_img = B // len(data_gts)
    res = [array_to_str(gen_result[i]) for i in range(B)]
    out = []
    for i in range(len(data_gts)):
        G = Cider_scorer.my_self_cider(
            [res[i * seq_per_img:(i + 1) * seq_per_img]])[0]
        eig = np.clip(np.linalg.eigvalsh(G / 10.0), 0, None)
        sq = np.sqrt(eig)
        denom = max(sq.sum(), 1e-12)
        out.append(-np.log(max(sq[-1], 1e-12) / denom) / np.log(len(eig)))
    return np.array(out, np.float32)
