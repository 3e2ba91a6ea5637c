"""In-process METEOR (approximate): exact + Porter-stem matching stages
(the port's copy of the JAX package's ``eval/meteor.py``).

The reference gets METEOR from the external coco-caption java scorer
(captioning/utils/eval_utils.py:21-26), which also uses WordNet synonym and
paraphrase tables; those data files are not in this image, so this module
implements the METEOR algorithm (Banerjee & Lavie 2005) with three
matching stages:

  1. exact surface match,
  2. Porter-stem match,

  3. synonym match against a compact embedded table (a WordNet-free
     stand-in for the official scorer's WordNet synset stage, covering
     common caption-domain synsets; see ``_SYN_GROUPS``),

then the standard scoring: m unigram matches, P = m/|cand|, R = m/|ref|,
Fmean = 10PR / (R + 9P), chunk penalty 0.5 * (chunks/m)^3,
score = Fmean * (1 - penalty), max over references, corpus score = mean of
segment scores.  Alignment picks, per candidate word, the reference match
that continues the previous match when possible (the official tool's
exhaustive chunk-minimizing search differs on rare ties).

Reported as ``METEOR_approx`` so it is never confused with the official
java scorer's number (which stays ``None``/absent).
"""

from __future__ import annotations

from typing import List

_VOWELS = "aeiou"

# Compact synonym table: each tuple is one synset (words considered
# pairwise synonymous for stage 3).  Chosen for caption-domain coverage
# (COCO-style vocabulary) plus common English synsets the WordNet stage
# would match; membership is checked on the PORTER STEM of both words,
# so inflections hit the same group.
_SYN_GROUPS = (
    ("photo", "photograph", "picture", "image", "shot"),
    ("man", "guy", "gentleman", "male"),
    ("woman", "lady", "female", "gal"),
    ("child", "kid", "youngster"),
    ("person", "individual", "human"),
    ("people", "persons", "folks", "crowd"),
    ("couch", "sofa"),
    ("tv", "television"),
    ("cellphone", "phone", "telephone", "mobile"),
    ("car", "automobile", "auto", "vehicle"),
    ("bike", "bicycle", "cycle"),
    ("motorbike", "motorcycle"),
    ("bus", "coach"),
    ("plane", "airplane", "aeroplane", "aircraft", "jet"),
    ("boat", "ship", "vessel"),
    ("street", "road", "roadway"),
    ("sidewalk", "pavement"),
    ("store", "shop"),
    ("house", "home"),
    ("big", "large", "huge", "enormous", "giant"),
    ("small", "little", "tiny"),
    ("fast", "quick", "rapid", "speedy"),
    ("slow", "sluggish"),
    ("happy", "glad", "joyful", "cheerful"),
    ("sad", "unhappy", "sorrowful"),
    ("pretty", "beautiful", "lovely", "gorgeous"),
    ("begin", "start", "commence"),
    ("end", "finish", "conclude"),
    ("look", "gaze", "stare", "watch"),
    ("walk", "stroll"),
    ("run", "sprint", "jog"),
    ("jump", "leap", "hop"),
    ("talk", "speak", "chat", "converse"),
    ("eat", "consume", "dine"),
    ("hold", "grasp", "grip", "clutch"),
    ("toss", "throw", "hurl"),
    ("cut", "slice", "chop"),
    ("near", "close", "nearby"),
    ("under", "beneath", "underneath", "below"),
    ("above", "over", "atop"),
    ("beside", "alongside"),
    ("middle", "center", "centre"),
    ("rock", "stone", "boulder"),
    ("ocean", "sea"),
    ("forest", "woods", "woodland"),
    ("mountain", "mount", "peak"),
    ("field", "meadow", "pasture"),
    ("rug", "carpet"),
    ("sack", "bag"),
    ("cap", "hat"),
    ("coat", "jacket"),
    ("trousers", "pants", "slacks"),
    ("shoes", "footwear", "sneakers"),
    ("baby", "infant", "toddler"),
    ("dog", "canine", "puppy", "pup"),
    ("cat", "feline", "kitten", "kitty"),
    ("horse", "pony", "steed"),
    ("cow", "cattle", "bovine"),
    ("bird", "fowl"),
    ("bunny", "rabbit", "hare"),
    ("pig", "hog", "swine"),
    ("food", "meal", "cuisine", "dish"),
    ("tasty", "delicious", "yummy"),
    ("cold", "chilly", "freezing", "frigid"),
    ("hot", "warm"),
    ("wet", "damp", "moist", "soaked"),
    ("dry", "arid", "parched"),
    ("old", "elderly", "aged", "ancient"),
    ("new", "modern", "recent"),
    ("many", "numerous", "several"),
    ("group", "bunch", "cluster", "gathering"),
    ("smile", "grin"),
    ("ride", "mount"),
    ("carry", "haul", "lug", "tote"),
    ("sit", "seated"),
    ("stand", "standing"),
)


def _syn_index():
    """word-stem -> SET of group-ids, memoized on first use.  A stem can
    belong to several synsets (e.g. 'mount' is in both the mountain and the
    ride groups); keeping every membership means no declared pair is
    silently disabled by a cross-group stem collision."""
    global _SYN_IDX
    if _SYN_IDX is None:
        idx = {}
        for gid, group in enumerate(_SYN_GROUPS):
            for w in group:
                idx.setdefault(porter_stem(w), set()).add(gid)
        _SYN_IDX = idx
    return _SYN_IDX


_SYN_IDX = None


def _cons(w: str, i: int) -> bool:
    c = w[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _cons(w, i - 1)
    return True


def _measure(stem: str) -> int:
    """Porter's m: number of VC sequences."""
    m = 0
    prev_v = False
    for i in range(len(stem)):
        v = not _cons(stem, i)
        if prev_v and not v:
            m += 1
        prev_v = v
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(w: str) -> bool:
    return (len(w) >= 2 and w[-1] == w[-2] and _cons(w, len(w) - 1))


def _cvc(w: str) -> bool:
    return (len(w) >= 3 and _cons(w, len(w) - 3)
            and not _cons(w, len(w) - 2) and _cons(w, len(w) - 1)
            and w[-1] not in "wxy")


def porter_stem(word: str) -> str:
    """Classic Porter stemmer (Porter 1980), steps 1-5."""
    w = word.lower()
    if len(w) <= 2:
        return w

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # step 1b
    flag = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w = w[:-2]
        flag = True
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w = w[:-3]
        flag = True
    if flag:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"

    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # step 2
    for suf, rep in (("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
                     ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
                     ("alli", "al"), ("entli", "ent"), ("eli", "e"),
                     ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
                     ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
                     ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
                     ("iviti", "ive"), ("biliti", "ble")):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 3
    for suf, rep in (("icate", "ic"), ("ative", ""), ("alize", "al"),
                     ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
                     ("ness", "")):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 4
    for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                "ement", "ment", "ent", "ion", "ou", "ism", "ate", "iti",
                "ous", "ive", "ize"):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1:
                if suf == "ion" and not stem.endswith(("s", "t")):
                    pass
                else:
                    w = stem
            break

    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


def _align(cand: List[str], ref: List[str]):
    """Unigram alignment: exact stage, then stem stage, then synonym
    stage; each word used at most once.  Per candidate word, prefer the
    reference position that continues the previous match (approximate
    chunk minimization).

    Returns the list of (cand_idx, ref_idx) matches in candidate order."""
    syn_idx = _syn_index()
    used = [False] * len(ref)
    matches = []
    last_r = -2
    cstem = [porter_stem(c) for c in cand]
    rstem = [porter_stem(r) for r in ref]
    empty = frozenset()
    cgrp = [syn_idx.get(s, empty) for s in cstem]
    rgrp = [syn_idx.get(s, empty) for s in rstem]
    for ci, c in enumerate(cand):
        cands_exact = [rj for rj, r in enumerate(ref)
                       if not used[rj] and r == c]
        pool = cands_exact or [rj for rj in range(len(ref))
                               if not used[rj] and rstem[rj] == cstem[ci]]
        if not pool and cgrp[ci]:
            pool = [rj for rj in range(len(ref))
                    if not used[rj] and rgrp[rj] & cgrp[ci]]
        if not pool:
            continue
        # continuation first, else leftmost
        rj = next((j for j in pool if j == last_r + 1), pool[0])
        used[rj] = True
        matches.append((ci, rj))
        last_r = rj
    return matches


def _segment_score(cand: List[str], ref: List[str]) -> float:
    if not cand or not ref:
        return 0.0
    matches = _align(cand, ref)
    m = len(matches)
    if m == 0:
        return 0.0
    p = m / len(cand)
    r = m / len(ref)
    fmean = 10 * p * r / (r + 9 * p)
    chunks = 1
    for (c0, r0), (c1, r1) in zip(matches, matches[1:]):
        if c1 != c0 + 1 or r1 != r0 + 1:
            chunks += 1
    penalty = 0.5 * (chunks / m) ** 3
    return fmean * (1 - penalty)


def meteor(cand: str, refs: List[str]) -> float:
    """Segment METEOR-approx: best score over references."""
    c = cand.split()
    return max((_segment_score(c, ref.split()) for ref in refs),
               default=0.0)


class MeteorApprox:
    """compute_score interface matching the other scorers."""

    def compute_score(self, gts, res):
        ids = list(res.keys())
        scores = [meteor(res[i][0], gts[i]) for i in ids]
        import numpy as np
        return float(np.mean(scores)) if scores else 0.0, scores
