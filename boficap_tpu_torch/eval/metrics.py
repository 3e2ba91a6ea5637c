"""Caption metrics: BLEU-1..4, ROUGE-L, CIDEr + bad-ending rate (the port's
copy of the JAX package's ``eval/metrics.py``).

The reference shells out to the external ``coco-caption`` java/python package
(captioning/utils/eval_utils.py:21-26, :75-127).  Here the text metrics are
computed in-process: BLEU and CIDEr reuse the reward scorers
(``rewards/``), ROUGE-L is implemented below.  METEOR and SPICE need
external java models; they are reported as absent (None) rather than faked,
with clearly-named in-process approximations alongside (METEOR_approx,
eval/meteor.py; SPICE_approx, eval/spice.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..rewards.bleu import Bleu
from ..rewards.cider import CiderD
# trailing words that make a caption a "bad ending" (reference
# AttModel.py:30-31 bad_endings list + 'the')
from ..text import BAD_ENDINGS

__all__ = ["BAD_ENDINGS", "language_eval", "rouge_l"]


def rouge_l(cand: str, refs: List[str], beta: float = 1.2) -> float:
    """ROUGE-L F-measure, max over refs (Lin 2004; same formula as
    pycocoevalcap.rouge)."""
    c = cand.split()

    def lcs(a, b):
        dp = np.zeros((len(a) + 1, len(b) + 1), dtype=np.int32)
        for i in range(1, len(a) + 1):
            for j in range(1, len(b) + 1):
                if a[i - 1] == b[j - 1]:
                    dp[i, j] = dp[i - 1, j - 1] + 1
                else:
                    dp[i, j] = max(dp[i - 1, j], dp[i, j - 1])
        return int(dp[-1, -1])

    best = 0.0
    for ref in refs:
        r = ref.split()
        ll = lcs(c, r)
        if ll == 0 or not c or not r:
            continue
        prec = ll / len(c)
        rec = ll / len(r)
        f = ((1 + beta ** 2) * prec * rec) / (rec + beta ** 2 * prec)
        best = max(best, f)
    return best


def language_eval(predictions: List[dict], gts: Dict,
                  bad_endings: Optional[List[str]] = None) -> Dict[str, float]:
    """predictions: [{'image_id', 'caption'}]; gts: {image_id: [ref str]}.

    Returns the metric dict the reference's language_eval produces
    (eval_utils.py:100-127): Bleu_1..4, ROUGE_L, CIDEr, bad_count_rate
    (+ METEOR/SPICE keys set to None — external java scorers unavailable).
    """
    bad_endings = bad_endings if bad_endings is not None else BAD_ENDINGS
    ids = [p["image_id"] for p in predictions]
    res = {i: [p["caption"]] for i, p in zip(ids, predictions)}
    sub_gts = {i: gts[i] for i in ids}

    out: Dict[str, float] = {}
    bleu, _ = Bleu(4).compute_score(sub_gts, res)
    for n in range(4):
        out[f"Bleu_{n + 1}"] = bleu[n]
    # coco-caption's reported "CIDEr" is computed with count clipping and
    # the gaussian length penalty ("vrama91: added clipping / length based
    # gaussian penalty" in pycocoevalcap/cider/cider_scorer.py) — i.e.
    # CIDEr-D math; mirror that so checkpoint numbers are comparable, and
    # so oracle_CIDEr (CiderD, multi_metrics.py) upper-bounds this value
    cider = CiderD(df="corpus")
    out["CIDEr"], _ = cider.compute_score(
        sub_gts, [{"image_id": i, "caption": res[i]} for i in ids])
    out["ROUGE_L"] = float(np.mean(
        [rouge_l(res[i][0], sub_gts[i]) for i in ids]))
    # official METEOR/SPICE need external java models (WordNet synonymy /
    # dependency parses): absent, never faked.  METEOR_approx
    # (eval/meteor.py: exact+stem+synonym stages) and SPICE_approx
    # (eval/spice.py: rule-based scene-graph tuple F1) are the in-process
    # implementations, named so they are never confused with the official
    # scorers' numbers.
    out["METEOR"] = None
    out["SPICE"] = None
    from .meteor import meteor as _meteor
    from .spice import spice as _spice
    out["METEOR_approx"] = float(np.mean(
        [_meteor(res[i][0], sub_gts[i]) for i in ids]))
    out["SPICE_approx"] = float(np.mean(
        [_spice(res[i][0], sub_gts[i]) for i in ids]))

    bad = sum(1 for p in predictions
              if p["caption"].split()[-1:] and
              p["caption"].split()[-1] in bad_endings)
    out["bad_count_rate"] = bad / max(len(predictions), 1)

    # reference eval_utils.py:80-94: mean per-caption perplexity/entropy
    # folded into the metric dict (absent for decode paths that expose no
    # per-word distribution entropies, e.g. beam search)
    ppl = [p["perplexity"] for p in predictions
           if p.get("perplexity") is not None]
    ent = [p["entropy"] for p in predictions if p.get("entropy") is not None]
    # absent -> None, matching the METEOR/SPICE absent-not-faked convention
    # above
    out["perplexity"] = float(np.mean(ppl)) if ppl else None
    out["entropy"] = float(np.mean(ent)) if ent else None
    return out
