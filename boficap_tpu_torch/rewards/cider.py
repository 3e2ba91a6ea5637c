"""CIDEr / CIDEr-D scorers (Vedantam et al., CVPR 2015), from scratch (the
port's copy of the JAX package's ``rewards/cider.py``).

Same scoring semantics as the external ``pyciderevalcap`` package the
reference imports (captioning/utils/rewards.py:11-17):

  * tf-idf n-gram vectors (n = 1..4) with idf = log(ref_len) - log(max(1, df)),
  * CIDEr-D: candidate counts CLIPPED by the reference's counts in the
    similarity, plus a gaussian length penalty exp(-(lc-lr)^2 / (2 sigma^2)),
    sigma = 6, and a x10 scale,
  * CIDEr (plain): unclipped cosine similarity, no length penalty — used
    here only for the self-CIDEr diversity reward's Gram matrix.

df can be 'corpus' (computed from the gts handed to compute_score) or a
cached {ngram: df} dict + ref_len from rewards/ngrams.py.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from .ngrams import Ngram, build_doc_freq, precook

N_DEFAULT = 4
SIGMA = 6.0


class CiderBase:
    clip = False          # CIDEr-D clips candidate counts by reference's
    length_penalty = False

    def __init__(self, df="corpus", n: int = N_DEFAULT,
                 df_dict: Optional[Dict[Ngram, float]] = None,
                 ref_len: Optional[float] = None):
        self.n = n
        self.df_mode = df
        self.df_dict = df_dict
        self.ref_len = math.log(ref_len) if ref_len else None

    def _vec(self, counts: Dict[Ngram, int]):
        """tf-idf vector per n + L2 norms + unigram length."""
        vec = [defaultdict(float) for _ in range(self.n)]
        norm = [0.0] * self.n
        length = 0
        for ngram, tf in counts.items():
            df = math.log(max(1.0, self.df_dict.get(ngram, 0.0)))
            k = len(ngram) - 1
            if k >= self.n:
                continue
            vec[k][ngram] = float(tf) * (self.ref_len - df)
            norm[k] += vec[k][ngram] ** 2
            if k == 0:
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def _sim(self, vh, vr, nh, nr, lh, lr):
        val = np.zeros(self.n)
        for k in range(self.n):
            s = 0.0
            for ngram, w in vh[k].items():
                wr = vr[k].get(ngram, 0.0)
                s += (min(w, wr) if self.clip else w) * wr
            if nh[k] != 0 and nr[k] != 0:
                s /= nh[k] * nr[k]
            val[k] = s
        if self.length_penalty:
            delta = float(lh - lr)
            val *= math.exp(-(delta ** 2) / (2 * SIGMA ** 2))
        return val

    def _prepare_df(self, gts: Dict):
        if self.df_mode == "corpus" or self.df_dict is None:
            self.df_dict, count = build_doc_freq(gts.values(), self.n)
            self.ref_len = math.log(max(count, 1))

    def score_one(self, cand: str, refs: List[str]) -> float:
        vh, nh, lh = self._vec(precook(cand, self.n))
        score = np.zeros(self.n)
        for ref in refs:
            vr, nr, lr = self._vec(precook(ref, self.n))
            score += self._sim(vh, vr, nh, nr, lh, lr)
        score /= max(len(refs), 1)
        return float(score.mean() * 10.0)

    def compute_score(self, gts: Dict, res) -> Tuple[float, np.ndarray]:
        """gts: {id: [ref strings]}; res: [{'image_id': id, 'caption': [c]}]
        or {id: [c]} — both interfaces the reference uses
        (rewards.py:62-75)."""
        if isinstance(res, dict):
            items = [(i, caps[0]) for i, caps in res.items()]
        else:
            items = [(r["image_id"], r["caption"][0]) for r in res]
        self._prepare_df(gts)
        scores = np.array([self.score_one(c, gts[i]) for i, c in items])
        return float(scores.mean()), scores


class CiderD(CiderBase):
    clip = True
    length_penalty = True


class Cider(CiderBase):
    clip = False
    length_penalty = False

    def my_self_cider(self, res_groups: List[List[str]]) -> List[np.ndarray]:
        """Pairwise unclipped tf-idf Gram matrix among a group's samples —
        the self-CIDEr diversity kernel (rewards.py:119-138 feeds its
        eigenvalues into a log-ratio diversity score)."""
        out = []
        for group in res_groups:
            if self.df_dict is None:
                # fall back: df over the group itself
                self.df_dict, count = build_doc_freq([group], self.n)
                self.ref_len = math.log(max(count, 1))
            vecs = [self._vec(precook(c, self.n)) for c in group]
            m = len(group)
            G = np.zeros((m, m))
            for a in range(m):
                for b in range(m):
                    va, na, la = vecs[a]
                    vb, nb, lb = vecs[b]
                    G[a, b] = self._sim(va, vb, na, nb, la, lb).mean() * 10.0
            out.append(G)
        return out
