"""Multi-sample caption metrics (sample_n > 1): diversity stats, oracle
scores, self-CIDEr (the port's copy of the JAX package's
``eval/multi_metrics.py``).

The reference's ``language_eval`` imports ``eval_multi`` for these whenever
``preds_n`` is non-empty (captioning/utils/eval_utils.py:105-121) — but that
module is NOT shipped in the reference fork (captioning/utils/ has no
eval_multi.py), so its multi-sample metrics path crashes on import.  This
module provides the intended capability with the framework's own
from-scratch scorers:

  * ``div_stats``: div-1 / div-2 — the ratio of DISTINCT 1/2-grams to total
    1/2-grams over an image's n captions (higher = more diverse), averaged
    over images — and mBLEU-4: each caption BLEU-4-scored against the
    image's other n-1 captions as references (LOWER = more diverse).
  * ``oracle``: per-image best candidate (max over the n candidates),
    averaged over images; reported as ``oracle_<metric>`` for CIDEr,
    Bleu_4 and ROUGE_L.
  * ``self_cider``: eigenvalue diversity of each image's pairwise tf-idf
    Gram matrix — the same math the training-time self-CIDEr diversity
    reward uses (reference rewards.py:119-138; rewards/self_critical.py).
  * allspice needs the external java SPICE models: reported absent (None),
    never faked (same policy as METEOR/SPICE in eval/metrics.py);
    ``allspice_approx`` is the in-process stand-in — the union of an
    image's n candidate tuple sets F1-scored against the reference tuple
    union (eval/spice.py).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

import numpy as np

from ..rewards.bleu import Bleu
from ..rewards.cider import Cider, CiderD
from .metrics import rouge_l


def _group(preds_n: List[dict]) -> "OrderedDict[object, List[str]]":
    groups: "OrderedDict[object, List[str]]" = OrderedDict()
    for p in preds_n:
        groups.setdefault(p["image_id"], []).append(p["caption"])
    return groups


def _distinct_ratio(caps: List[str], n: int) -> float:
    grams = []
    for c in caps:
        w = c.split()
        grams += [tuple(w[i:i + n]) for i in range(len(w) - n + 1)]
    return len(set(grams)) / max(len(grams), 1)


def div_stats(preds_n: List[dict], groups=None) -> Dict[str, float]:
    """{'div1', 'div2', 'mBLEU_4'} averaged over images."""
    groups = _group(preds_n) if groups is None else groups
    bleu4 = Bleu(4)                  # stateless across compute_score calls
    d1, d2, mb = [], [], []
    for caps in groups.values():
        d1.append(_distinct_ratio(caps, 1))
        d2.append(_distinct_ratio(caps, 2))
        if len(caps) > 1:
            scores = []
            for k, cap in enumerate(caps):
                others = caps[:k] + caps[k + 1:]
                bleu, _ = bleu4.compute_score({0: others}, {0: [cap]})
                scores.append(bleu[3])
            mb.append(float(np.mean(scores)))
    out = {"div1": float(np.mean(d1)), "div2": float(np.mean(d2))}
    if mb:
        out["mBLEU_4"] = float(np.mean(mb))
    return out


def oracle(preds_n: List[dict], gts: Dict, groups=None) -> Dict[str, float]:
    """Per-image MAX over the n candidates, averaged: the quality ceiling a
    perfect re-ranker would reach (``oracle_CIDEr`` / ``oracle_Bleu_4`` /
    ``oracle_ROUGE_L``)."""
    groups = _group(preds_n) if groups is None else groups
    sub_gts = {i: gts[i] for i in groups if i in gts}
    cider = CiderD(df="corpus")
    cider._prepare_df(sub_gts)
    bleu4 = Bleu(4)
    oc, ob, orl = [], [], []
    for i, caps in groups.items():
        refs = gts.get(i)
        if not refs:
            continue
        oc.append(max(cider.score_one(c, refs) for c in caps))
        bs = []
        for c in caps:
            bleu, _ = bleu4.compute_score({0: refs}, {0: [c]})
            bs.append(bleu[3])
        ob.append(max(bs))
        orl.append(max(rouge_l(c, refs) for c in caps))
    if not oc:              # no scored image had references
        return {"oracle_CIDEr": None, "oracle_Bleu_4": None,
                "oracle_ROUGE_L": None}
    return {"oracle_CIDEr": float(np.mean(oc)),
            "oracle_Bleu_4": float(np.mean(ob)),
            "oracle_ROUGE_L": float(np.mean(orl))}


def self_cider(preds_n: List[dict], groups=None) -> Dict[str, float]:
    """Mean eigenvalue-diversity score of each image's sample group
    (rewards/self_critical.py:get_self_cider_scores, on words)."""
    groups = _group(preds_n) if groups is None else groups
    scorer = Cider(df="corpus")
    scorer._prepare_df({i: caps for i, caps in groups.items()})
    vals = []
    for caps in groups.values():
        if len(caps) < 2:
            continue
        G = scorer.my_self_cider([caps])[0]
        eig = np.clip(np.linalg.eigvalsh(G / 10.0), 0, None)
        sq = np.sqrt(eig)
        denom = max(sq.sum(), 1e-12)
        vals.append(-np.log(max(sq[-1], 1e-12) / denom) / np.log(len(eig)))
    # absent (None), never faked: a 0.0 here would read as "zero diversity"
    # when no image even had >= 2 captions to compare (same policy as oracle)
    return {"self_cider": float(np.mean(vals)) if vals else None}


def multi_sample_eval(preds_n: List[dict], gts: Dict,
                      eval_oracle: bool = True) -> Dict[str, float]:
    """The reference language_eval's preds_n block (eval_utils.py:105-121):
    allspice (absent) + div stats + optional oracle + self-CIDEr."""
    out: Dict[str, float] = {"allspice": None}
    from .spice import allspice as _allspice
    groups = _group(preds_n)
    vals = [_allspice(caps, gts[i]) for i, caps in groups.items()
            if gts.get(i)]
    out["allspice_approx"] = float(np.mean(vals)) if vals else None
    out.update(div_stats(preds_n, groups=groups))
    if eval_oracle:
        out.update(oracle(preds_n, gts, groups=groups))
    out.update(self_cider(preds_n, groups=groups))
    return out
