"""BPE-style greedy phrase-pair merging over the corpus and its application
back onto a label h5: the port's copy of the JAX package's
``prepro/phrase_pairs.py`` (parity with reference scripts/phrase_encoding.py,
scripts/prep_h5.py and scripts/KD_coco.py).

Sentences are rendered as '@tok@'-wrapped units (a merged phrase is the
concatenation '@a@@b@'); the most frequent adjacent pair is merged until no
pair clears the threshold.  ``apply_merges_to_h5`` rewrites
phrase_num/phrase_length so merged pairs become one phrase.
"""

from __future__ import annotations

import ast
import collections
import re
from typing import Dict, List, Tuple


def wrap(tok: str) -> str:
    return "@" + tok + "@"


def build_sentence_table(imgs, phrase_data=None) -> Dict[str, int]:
    """sentence (as space-joined phrase units) -> corpus frequency
    (reference phrase_encoding.py:9-45).  With ``phrase_data`` =
    (label_start_ix, phrase_num, phrase_length), units are existing phrases;
    otherwise single tokens."""
    table: Dict[str, int] = {}
    if phrase_data is None:
        for img in imgs:
            for sent in img["sentences"]:
                s = " ".join(wrap(w) for w in sent["tokens"])
                table[s] = table.get(s, 0) + 1
        return table
    label_start_ix, phrase_num, phrase_length = phrase_data
    for ix, img in enumerate(imgs):
        if img.get("split") in ("test", "val"):
            continue
        for j, sent in enumerate(img["sentences"]):
            cur = label_start_ix[ix] - 1 + j
            units = []
            bos = 0
            for k in range(phrase_num[cur]):
                n = int(phrase_length[cur][k])
                units.append("".join(wrap(w)
                                     for w in sent["tokens"][bos:bos + n]))
                bos += n
            s = " ".join(units)
            table[s] = table.get(s, 0) + 1
    return table


def best_pair(table: Dict[str, int]):
    pairs: Dict[Tuple[str, str], int] = collections.defaultdict(int)
    for sent, freq in table.items():
        units = sent.split()
        for i in range(len(units) - 1):
            pairs[units[i], units[i + 1]] += freq
    if not pairs:
        return None, 0
    b = max(pairs, key=pairs.get)
    return b, pairs[b]


def merge_pair(pair, table):
    bigram = re.escape(" ".join(pair))
    p = re.compile(r"(?<!\S)" + bigram + r"(?!\S)")
    return {p.sub("".join(pair), s): f for s, f in table.items()}


def learn_phrase_pairs(imgs, phrase_data=None, threshold: int = 5,
                       num_merges: int = 1000) -> Dict[str, int]:
    """Greedy merge loop (reference phrase_encoding.py:66-87)."""
    table = build_sentence_table(imgs, phrase_data)
    record: Dict[str, int] = {}
    for _ in range(num_merges):
        pair, freq = best_pair(table)
        if pair is None or freq < threshold:
            break
        record[str(pair)] = freq
        table = merge_pair(pair, table)
    return record


def apply_merges_to_h5(imgs, label_start_ix, phrase_num, phrase_length,
                       merges: Dict[str, int]):
    """Rewrite (phrase_num, phrase_length) so adjacent phrases whose unit
    pair was merged become one phrase (reference scripts/prep_h5.py).
    Merges may chain (pair units are already-merged strings)."""
    merged_units = set()
    for key in merges:
        # keys are str((a, b)) from learn_phrase_pairs; literal_eval, never
        # eval — merge tables round-trip through json files
        a, b = ast.literal_eval(key)
        merged_units.add(a + b)

    pn = phrase_num.copy()
    pl = phrase_length.copy()
    for ix, img in enumerate(imgs):
        for j, sent in enumerate(img["sentences"]):
            cur = label_start_ix[ix] - 1 + j
            units = []
            bos = 0
            for k in range(phrase_num[cur]):
                n = int(phrase_length[cur][k])
                units.append("".join(wrap(w)
                                     for w in sent["tokens"][bos:bos + n]))
                bos += n
            # repeatedly merge adjacent units whose concat is a known merge
            changed = True
            lens = [int(x) for x in phrase_length[cur][:phrase_num[cur]]]
            while changed:
                changed = False
                for k in range(len(units) - 1):
                    if units[k] + units[k + 1] in merged_units:
                        units[k] = units[k] + units[k + 1]
                        lens[k] = lens[k] + lens[k + 1]
                        del units[k + 1]
                        del lens[k + 1]
                        changed = True
                        break
            pn[cur] = len(lens)
            pl[cur] = 0
            pl[cur][:len(lens)] = lens
    return pn, pl


def splice_kd_captions(ori: dict, kd: Dict[str, List[str]],
                       max_bad: int = 100) -> dict:
    """Replace train-split captions with teacher beams (reference
    scripts/KD_coco.py:4-36): beams 0..3 overwrite sentences 1..4; every
    other image also gets beam 4 into sentence 0 ("kd90"-style mix)."""
    imgs = ori["images"]
    bad = cnt = 0
    for img in imgs:
        if img.get("split") not in ("train", "restval"):
            continue
        cocoid = str(img.get("cocoid", img.get("id")))
        if cocoid not in kd:
            bad += 1
            if bad > max_bad:
                raise RuntimeError("too many images missing KD captions")
            continue
        ref = kd[cocoid]
        for j in range(1, min(5, len(ref) + 1)):
            img["sentences"][j]["raw"] = ref[j - 1]
            img["sentences"][j]["tokens"] = ref[j - 1].split()
        cnt += 1
        if cnt % 2 == 1 and len(ref) > 4:
            img["sentences"][0]["raw"] = ref[4]
            img["sentences"][0]["tokens"] = ref[4].split()
    return {"images": imgs}
