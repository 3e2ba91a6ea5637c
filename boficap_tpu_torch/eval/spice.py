"""In-process SPICE (approximate): semantic-proposition F-score (the
port's copy of the JAX package's ``eval/spice.py``).

The reference gets SPICE from the external coco-caption java scorer
(captioning/utils/eval_utils.py:75-127), which parses captions with a
dependency parser into scene graphs — tuples of objects ``(o,)``,
attributes ``(o, a)`` and relations ``(o, r, o')`` — and scores the
candidate's tuple set against the union of the references' tuple sets with
an F1, matching tuple elements up to WordNet synonymy.  Neither the java
models nor a dependency parser exist in this image, so this module
implements the same *scoring semantics* over tuples produced by a
rule-based extractor tuned to caption-style English:

  * a POS-lite tagger (closed-class lexicons for determiners /
    prepositions / copulas / conjunctions, morphological ``-ing``/``-ed``
    verb cues with a determiner-context noun override, and a compact
    caption-domain verb lexicon),
  * NP chunks = maximal content-word runs; the last word is the object
    head, every earlier content word an attribute (the dependency
    ``amod``/``nn``/``num`` tuple family),
  * relations from ``NP (copula?) VERB (PREP?) NP`` and ``NP PREP NP``
    with nearest-NP (right) attachment; ``copula + predicate`` emits
    attributes ("the horse is brown" -> (horse, brown)),
  * tuple elements are Porter-stemmed; element equality is stem equality
    or shared membership in the embedded synonym table (eval/meteor.py's
    ``_SYN_GROUPS`` — the WordNet-free stand-in for SPICE's synset match).

Per image: P = |cand tuples matching any ref tuple| / |cand tuples|,
R likewise over the reference union, F = 2PR/(P+R); corpus score = mean of
per-image F (exactly the official scorer's aggregation).

Reported as ``SPICE_approx`` so it is never confused with the official
java scorer's number (which stays ``None``/absent).  Known bias: the
extractor has no true parser, so attachment and copular-predicate
decisions can differ from Stanford scene-graph parses on complex clauses;
on COCO-style simple captions the tuple inventories agree closely.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Sequence, Set, Tuple

import numpy as np

from .meteor import _syn_index, porter_stem

DETS = {
    "a", "an", "the", "this", "that", "these", "those", "his", "her", "its",
    "their", "my", "our", "your", "some", "few", "several", "many", "each",
    "every", "another", "other", "both", "all", "no",
}
NUMBERS = {
    "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
    "ten", "eleven", "twelve", "dozen",
}
PREPS = {
    "in", "on", "at", "of", "with", "near", "under", "over", "above",
    "below", "beside", "behind", "by", "into", "onto", "along", "across",
    "around", "through", "against", "atop", "beneath", "underneath",
    "inside", "outside", "between", "during", "without", "beyond", "off",
    "up", "down", "toward", "towards", "past", "from", "to", "for",
}
# multiword prepositions, matched greedily before single-word tagging
MULTI_PREPS = (
    ("next", "to"), ("close", "to"), ("in", "front", "of"),
    ("on", "top", "of"), ("out", "of"), ("in", "the", "middle", "of"),
)
COPULAS = {"is", "are", "was", "were", "be", "been", "being"}
CONJS = {"and", "or"}
# relative pronouns: dropped so the following verb attaches to the
# preceding head ("a man who is riding" -> man riding)
REL_PRONOUNS = {"who", "which", "that"}
CLAUSE_BREAKS = {"while", "as", ",", ";", ".", "!", "?"}

# -ing words that are (almost always) nouns in captions
NOUN_ING = {
    "building", "ceiling", "painting", "clothing", "lightning", "morning",
    "evening", "awning", "railing", "dressing", "icing", "frosting",
    "landing", "crossing", "clearing", "opening", "wedding", "living",
    "dining", "everything", "something", "nothing", "anything", "king",
    "ring", "spring", "string", "swing", "thing", "wing",
}
# irregular plurals: a base-form lexicon verb after one of these (or any
# -s word) is a verb, not a compound-noun tail ("people walk" vs
# "a gold watch")
PLURAL_IRREG = {"people", "men", "women", "children", "sheep", "geese",
                "police", "cattle", "mice", "feet", "teeth"}
# compact adjective lexicon gating conjunction continuation: "black and
# white dog" keeps one NP; "a man and woman" stays two objects
ADJ_WORDS = {
    "black", "white", "red", "blue", "green", "yellow", "brown", "gray",
    "grey", "orange", "purple", "pink", "golden", "gold", "silver", "tan",
    "beige", "dark", "light", "bright", "colorful",
    "big", "large", "small", "little", "tall", "short", "long", "tiny",
    "huge", "wide", "narrow", "thin", "thick", "young", "old", "new",
    "open", "closed", "empty", "full", "clean", "dirty", "wet", "dry",
    "hot", "cold", "fresh", "shiny", "rusty", "wooden", "metal", "plastic",
    "striped", "spotted", "furry", "fluffy", "cute", "pretty", "beautiful",
}
# caption-domain verbs whose 3rd-person/base forms carry no -ing/-ed cue;
# checked on the PORTER STEM so "sits"/"sit"/"holds" all hit
VERB_STEMS = {porter_stem(v) for v in (
    "sit", "sits", "stand", "stands", "hold", "holds", "ride", "rides",
    "eat", "eats", "walk", "walks", "run", "runs", "play", "plays",
    "look", "looks", "wear", "wears", "carry", "carries", "fly", "flies",
    "jump", "jumps", "drive", "drives", "watch", "watches", "read",
    "reads", "talk", "talks", "smile", "smiles", "pose", "poses", "lay",
    "lays", "lie", "lies", "lean", "leans", "hang", "hangs", "rest",
    "rests", "sleep", "sleeps", "swim", "swims", "surf", "surfs", "ski",
    "skis", "skate", "skates", "throw", "throws", "catch", "catches",
    "hit", "hits", "kick", "kicks", "swing", "swings", "cook", "cooks",
    "drink", "drinks", "feed", "feeds", "pull", "pulls", "push", "pushes",
    "climb", "climbs", "cross", "crosses", "wait", "waits", "work",
    "works", "use", "uses", "graze", "grazes", "perch", "perches",
    "jump", "point", "points", "reach", "reaches", "serve", "serves",
    "perform", "performs", "dance", "dances", "sing", "sings", "stare",
    "stares", "gaze", "gazes", "glide", "glides", "soar", "soars",
    "race", "races", "chase", "chases", "lead", "leads", "face", "faces",
    "contain", "contains", "show", "shows", "display", "displays",
    "feature", "features", "overlook", "overlooks",
)}

_D, _P, _C, _J, _V, _W, _B = "DET PREP COP CONJ VERB WORD BREAK".split()


def _tag(tokens: Sequence[str]) -> List[Tuple[str, str]]:
    """POS-lite tagging -> [(tag, token)]; multiword preps collapse to one
    PREP token joined by spaces; relative pronouns vanish."""
    out: List[Tuple[str, str]] = []
    i = 0
    n = len(tokens)
    while i < n:
        w = tokens[i].lower()
        hit = None
        for mp in MULTI_PREPS:
            if tuple(t.lower() for t in tokens[i:i + len(mp)]) == mp:
                hit = mp
                break
        if hit:
            out.append((_P, " ".join(hit)))
            i += len(hit)
            continue
        if w in REL_PRONOUNS:
            i += 1
            continue
        if w in CLAUSE_BREAKS:
            out.append((_B, w))
        elif w in DETS or w in NUMBERS:
            out.append((_D, w))
        elif w in PREPS:
            out.append((_P, w))
        elif w in COPULAS:
            out.append((_C, w))
        elif w in CONJS:
            out.append((_J, w))
        elif w.endswith("ing") and len(w) > 4 and w not in NOUN_ING:
            # determiner context makes it a noun ("a painting"); the
            # NOUN_ING table catches bare-noun uses
            prev_det = out and out[-1][0] == _D
            out.append((_W if prev_det else _V, w))
        elif (porter_stem(w) in VERB_STEMS
              and not (out and out[-1][0] == _D)
              and (not (out and out[-1][0] == _W) or w.endswith("s")
                   or out[-1][1].endswith("s")
                   or out[-1][1] in PLURAL_IRREG)):
            # a lexicon stem mid-NP is a noun head ("a gold watch") UNLESS
            # it carries the 3sg -s inflection ("a dog sits") or follows a
            # plural subject ("two giraffes stand", "people walk"); plural
            # nouns after a determiner/number are caught by the _D check
            out.append((_V, w))
        elif (w.endswith("ed") and len(w) > 4
              and not (out and out[-1][0] == _D)):
            # past participle heading a reduced clause: "a bus parked on
            # the street"; after a determiner it is a modifier instead
            out.append((_V, w))
        else:
            out.append((_W, w))
        i += 1
    return out


Tup = Tuple[str, ...]


def _tokenize(caption: str) -> List[str]:
    """Lowercase word/punctuation tokens; '.', ',', ';' surface as their
    own tokens so attached punctuation never pollutes tuple elements and
    the CLAUSE_BREAKS entries actually fire."""
    import re
    return re.findall(r"[a-z0-9']+|[.,;!?]", caption.lower())


def parse_tuples(caption: str) -> Set[Tup]:
    """caption text -> set of stemmed semantic tuples:
    ("o", head) / ("a", head, attr) / ("r", subj, rel, obj)."""
    tags = _tag(_tokenize(caption))
    tuples: Set[Tup] = set()

    nps: List[List[str]] = []       # content-word runs (stemmed)
    np_end: List[int] = []          # tag index one past each NP
    np_pred: List[bool] = []        # run was a bare copular predicate
    cur: List[str] = []
    cur_words: List[str] = []       # raw surface forms of the pending run
    cur_counts: List[str] = []      # number words modifying the pending NP
    pred = False                    # run opened right after a bare copula
    prev_tag = _B
    for idx, (t, w) in enumerate(tags + [(_B, "")]):
        if t == _W:
            if not cur:
                # "is brown" (no determiner) is a copular predicate, not an
                # object NP; the relation scan below emits its attributes
                pred = prev_tag == _C
            cur.append(porter_stem(w))
            cur_words.append(w)
            prev_tag = t
            continue
        if t == _D and w in NUMBERS:
            cur_counts.append(w)
            prev_tag = t
            continue
        if (t == _J and cur and idx + 1 < len(tags)
                and tags[idx + 1][0] == _W
                and cur_words and cur_words[-1] in ADJ_WORDS):
            # conjoined MODIFIERS continue the NP: "a black and white dog"
            # -> attrs (dog, black), (dog, white), not a spurious
            # (o, black) object; conjoined NOUNS ("a man and woman") still
            # close the run so both objects survive
            prev_tag = t
            continue
        if cur:
            if not pred:
                head = cur[-1]
                tuples.add(("o", head))
                for mod in cur[:-1]:
                    tuples.add(("a", head, mod))
                for num in cur_counts:
                    tuples.add(("a", head, num))
            nps.append(cur)
            np_end.append(idx)
            np_pred.append(pred)
            cur, cur_words, cur_counts, pred = [], [], [], False
        prev_tag = t

    # relations: scan tag stream tracking the most recent NP head on the
    # left; VERB/PREP sequences bind it to the next NP head
    def np_before(idx: int) -> int:
        # most recent REFERRING NP: copular predicates ("is full") are not
        # relation subjects — "a bowl is full of fruit" relates bowl, not
        # full, to fruit
        k = -1
        for j, e in enumerate(np_end):
            if e <= idx and not np_pred[j]:
                k = j
        return k

    i = 0
    n = len(tags)
    while i < n:
        t, w = tags[i]
        if t == _C:
            # copula: progressive ("is riding" -> verb path), predicate
            # adjective/nominal ("is brown" -> attribute), or locative
            # ("is on the table" -> preposition relation)
            subj = np_before(i)
            j = i + 1
            while j < n and tags[j][0] == _D:
                j += 1
            if subj >= 0 and j < n and tags[j][0] == _W:
                # predicate words up to the next non-content tag
                k = j
                while k < n and tags[k][0] == _W:
                    tuples.add(("a", nps[subj][-1], porter_stem(tags[k][1])))
                    k += 1
                i = k
                continue
            i += 1
            continue
        if t in (_V, _P):
            subj = np_before(i)
            rel = [porter_stem(w)] if t == _V else [w]
            j = i + 1
            if t == _V and j < n and tags[j][0] == _P:
                rel.append(tags[j][1])
                j += 1
            # find the object NP that starts right here
            obj = None
            k = j
            while k < n and tags[k][0] == _D:
                k += 1
            if k < n and tags[k][0] == _W:
                for q, e in enumerate(np_end):
                    if e > k:
                        obj = q
                        break
            if subj >= 0 and obj is not None and obj != subj:
                tuples.add(("r", nps[subj][-1], " ".join(rel),
                            nps[obj][-1]))
            i = j
            continue
        i += 1
    return tuples


def _elements_match(a: str, b: str, syn) -> bool:
    if a == b:
        return True
    # multiword relation strings match wordwise
    aw, bw = a.split(), b.split()
    if len(aw) != len(bw):
        return False
    for x, y in zip(aw, bw):
        if x != y and not (syn.get(x, frozenset()) & syn.get(y, frozenset())):
            return False
    return True


def _tuple_match(a: Tup, b: Tup, syn) -> bool:
    return (len(a) == len(b) and a[0] == b[0]
            and all(_elements_match(x, y, syn) for x, y in
                    zip(a[1:], b[1:])))


def _f1(cand: Set[Tup], ref: Set[Tup], syn) -> float:
    if not cand or not ref:
        return 0.0
    pm = sum(1 for c in cand if any(_tuple_match(c, r, syn) for r in ref))
    rm = sum(1 for r in ref if any(_tuple_match(r, c, syn) for c in cand))
    p = pm / len(cand)
    r = rm / len(ref)
    return 2 * p * r / (p + r) if p + r > 0 else 0.0


def spice(cand: str, refs: List[str]) -> float:
    """Per-image SPICE-approx F1: candidate tuples vs the union of the
    references' tuples (official aggregation, Anderson et al. 2016 §3)."""
    syn = _syn_index()
    ref_tuples: Set[Tup] = set()
    for ref in refs:
        ref_tuples |= parse_tuples(ref)
    return _f1(parse_tuples(cand), ref_tuples, syn)


def allspice(cands: List[str], refs: List[str]) -> float:
    """Multi-sample variant: UNION of the n candidates' tuples scored
    against the reference union (the eval_multi 'allspice' semantics — the
    sample set is one combined scene graph, so coverage across diverse
    samples raises recall)."""
    syn = _syn_index()
    cand_tuples: Set[Tup] = set()
    for c in cands:
        cand_tuples |= parse_tuples(c)
    ref_tuples: Set[Tup] = set()
    for ref in refs:
        ref_tuples |= parse_tuples(ref)
    return _f1(cand_tuples, ref_tuples, syn)


class SpiceApprox:
    """compute_score interface matching the other scorers."""

    def compute_score(self, gts: Dict, res: Dict):
        ids = list(res.keys())
        scores = [spice(res[i][0], gts[i]) for i in ids]
        return (float(np.mean(scores)) if scores else 0.0, scores)
