"""BLEU scorer (Papineni et al., 2002; the port's copy of the JAX
package's ``rewards/bleu.py``) — same contract as the
``pycocoevalcap.bleu`` scorer the reference imports (captioning/utils/
rewards.py:16): ``compute_score(gts, res) -> (corpus [b1..b4],
per-sentence [[b1...], ..., [b4...]])``.

Corpus BLEU aggregates clipped n-gram matches over the whole set; the
per-sentence scores use the same modified precision with the tiny-epsilon
smoothing pycocoevalcap applies (prec = (matches + ~0) / (guesses + ~0)),
and the 'closest' reference length for the brevity penalty.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from .ngrams import precook

TINY = 1e-15
SMALL = 1e-9


def _closest_ref_len(lens: List[int], lc: int) -> int:
    return min(lens, key=lambda lr: (abs(lr - lc), lr))


class Bleu:
    def __init__(self, n: int = 4):
        self.n = n

    def _stats(self, cand: str, refs: List[str]):
        """(guess[n], match[n], len_cand, closest_ref_len)."""
        cc = precook(cand, self.n)
        maxref: Dict = defaultdict(int)
        for r in refs:
            for g, c in precook(r, self.n).items():
                maxref[g] = max(maxref[g], c)
        guess = np.zeros(self.n)
        match = np.zeros(self.n)
        lc = len(cand.split())
        for g, c in cc.items():
            k = len(g) - 1
            guess[k] += c
            match[k] += min(c, maxref[g])
        lr = _closest_ref_len([len(r.split()) for r in refs], lc)
        return guess, match, lc, lr

    @staticmethod
    def _bleu(guess, match, lc, lr, n):
        prec = (match + TINY) / (guess + SMALL)
        logp = np.log(np.maximum(prec[:n], TINY)).mean()
        bp = 1.0 if lc > lr else np.exp(1 - lr / max(lc, 1))
        return float(np.exp(logp) * bp)

    def compute_score(self, gts: Dict, res: Dict
                      ) -> Tuple[List[float], List[List[float]]]:
        ids = list(res.keys())
        tot_guess = np.zeros(self.n)
        tot_match = np.zeros(self.n)
        tot_lc = 0
        tot_lr = 0
        per = [[] for _ in range(self.n)]
        for i in ids:
            guess, match, lc, lr = self._stats(res[i][0], gts[i])
            tot_guess += guess
            tot_match += match
            tot_lc += lc
            tot_lr += lr
            for n in range(self.n):
                per[n].append(self._bleu(guess, match, lc, lr, n + 1))
        corpus = [self._bleu(tot_guess, tot_match, tot_lc, tot_lr, n + 1)
                  for n in range(self.n)]
        return corpus, per
