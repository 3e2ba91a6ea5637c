"""N-gram utilities + document-frequency cache for CIDEr-family scorers
(the port's copy of the JAX package's ``rewards/ngrams.py``).

The reference trains RL against document frequencies precomputed by
scripts/prepro_ngrams.py (reference scripts/prepro_ngrams.py:56-80) and
loaded from '<name>-idxs.p' pickles (captioning/utils/rewards.py:25-31).
This module provides the same artifact: ``build_doc_freq`` over a corpus of
reference captions and a pickle format {'document_frequency': {ngram: df},
'ref_len': n_images} round-trippable with the reference's files.

All computation is host-side numpy/python — rewards cross the device
boundary exactly once per RL step in each direction.
"""

from __future__ import annotations

import pickle
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

Ngram = Tuple[str, ...]


def precook(s: str, n: int = 4) -> Dict[Ngram, int]:
    """Count n-grams (1..n) of a whitespace-tokenized sentence."""
    words = s.split()
    counts: Dict[Ngram, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


def cook_refs(refs: List[str], n: int = 4) -> List[Dict[Ngram, int]]:
    return [precook(r, n) for r in refs]


def build_doc_freq(corpus_refs: Iterable[List[str]], n: int = 4):
    """df[ngram] = number of images in whose reference set the ngram appears
    (CIDEr's document = image).  Returns (df dict, n_images)."""
    df: Dict[Ngram, float] = defaultdict(float)
    count = 0
    for refs in corpus_refs:
        count += 1
        seen = set()
        for ref in refs:
            seen.update(precook(ref, n).keys())
        for g in seen:
            df[g] += 1.0
    return df, count


def save_doc_freq(path: str, df: Dict[Ngram, float], ref_len: int):
    with open(path, "wb") as f:
        pickle.dump({"document_frequency": dict(df), "ref_len": ref_len}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)


def load_doc_freq(path: str):
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="latin1")
    return d["document_frequency"], d["ref_len"]
