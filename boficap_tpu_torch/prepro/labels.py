"""Offline label preprocessing: the port's copy of the JAX package's
``prepro/labels.py`` (vocab build, caption encoding and the phrase
cutters; parity with reference scripts/prepro_labels.py and
scripts/prepro_labels_stanford.py).

Three cutters share one span-matching + gap-filling assembler
(reference prepro_labels_stanford.py:255-300):

  * ``stanza_chunks``  - constituency VP/NP at a target tree depth
    (gather_phrase_level, prepro_labels_stanford.py:182-208), emits
    per-phrase labels VP=4, NP=5; inter-phrase gaps become CP=6,
  * ``spacy_chunks``   - noun chunks (prepro_labels.py:157-186); chunks
    labeled NP, gaps CP,
  * ``heuristic_chunks`` - the dependency-free stand-in: splits before
    function words (determiners, prepositions, conjunctions, copulas) so
    chunks approximate NP/VP groupings; the dataset format is identical,
    only cut quality differs.

spaCy and stanza are imported only when their cutter is asked for; where
they are missing the cutter raises ``ImportError`` naming the package.

``prepro_captions`` turns a Karpathy-format image list into the arrays and
the vocabulary in memory (``label_store`` makes a ``LabelStore`` of them,
with no file and no h5py); ``write_prepro`` writes the cocotalk json and
the label h5 (h5py imported there, ``ImportError`` without it);
``run_prepro`` is the two, file to files.

Id scheme (matches the data loader): the h5 stores the TRAIN-TIME ids
directly - real words start at 4, {0:pad 1:bos 2:eos 3:sep} reserved
(reference prepro_labels.py:337 applies the same +4 at its encode step);
no later offset is applied anywhere.
"""

from __future__ import annotations

import json
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..constants import LENGTH_DIM, SYN_CP, SYN_NP, SYN_VP

FUNCTION_WORDS = {
    "a", "an", "the", "in", "on", "at", "of", "with", "for", "to", "by",
    "from", "and", "or", "but", "is", "are", "was", "were", "near", "under",
    "over", "into", "onto", "while", "as", "that", "who", "which",
}
VERBY_SUFFIXES = ("ing", "ed", "es")
# word classes for the chunking rules (heuristic_chunks); PREPOSITIONS is a
# superset of the prepositions in FUNCTION_WORDS — caption vocabulary leans
# on spatial relations the generic function-word list lacks
PREPOSITIONS = {
    "in", "on", "at", "of", "with", "for", "to", "by", "from", "near",
    "under", "over", "into", "onto", "around", "through", "down", "up",
    "across", "behind", "beside", "between", "along", "above", "below",
    "beneath", "against", "during", "without", "inside", "outside", "atop",
    "while", "as",
}
DETERMINERS = {"a", "an", "the"}
CONJUNCTIONS = {"and", "or", "but"}
RELATIVIZERS = {"who", "that", "which"}
COPULAS = {"is", "are", "was", "were"}


def _verby(t: str) -> bool:
    return (t.endswith(VERBY_SUFFIXES) and t not in FUNCTION_WORDS
            and t not in PREPOSITIONS)


def build_vocab(imgs: List[dict], count_thr: int = 5) -> List[str]:
    """Words with count > thr; others map to UNK
    (reference prepro_labels_stanford.py:52-103)."""
    counts: Dict[str, int] = {}
    for img in imgs:
        for sent in img["sentences"]:
            for w in sent["tokens"]:
                counts[w] = counts.get(w, 0) + 1
    vocab = [w for w, n in counts.items() if n > count_thr]
    bad = sum(n for w, n in counts.items() if n <= count_thr)
    if bad > 0:
        vocab.append("UNK")
    for img in imgs:
        img["final_captions"] = [
            [w if counts.get(w, 0) > count_thr else "UNK" for w in s["tokens"]]
            for s in img["sentences"]]
    return vocab


def encode_captions(imgs: List[dict], max_length: int, wtoi: Dict[str, int]):
    """-> (labels [M, L], label_start_ix, label_end_ix, label_length).
    Word ids come straight from ``wtoi`` (run_prepro builds it 4-based, see
    module docstring); start/end pointers are 1-indexed (reference
    :120-154)."""
    N = len(imgs)
    M = sum(len(img["final_captions"]) for img in imgs)
    labels = np.zeros((M, max_length), dtype=np.uint32)
    start = np.zeros(N, dtype=np.uint32)
    end = np.zeros(N, dtype=np.uint32)
    length = np.zeros(M, dtype=np.uint32)
    cap = 0
    counter = 1
    for i, img in enumerate(imgs):
        n = len(img["final_captions"])
        assert n > 0, "image with no captions"
        for s in img["final_captions"]:
            length[cap] = min(max_length, len(s))
            for k, w in enumerate(s[:max_length]):
                labels[cap, k] = wtoi[w]
            cap += 1
        start[i] = counter
        end[i] = counter + n - 1
        counter += n
    return labels, start, end, length


# ---------------------------------------------------------------------------
# Cutters: tokens -> list of (span_start, span_len, syn_label) proposals
# ---------------------------------------------------------------------------

def split_run(L: int, limit: int = 5) -> List[int]:
    """The reference's split of an L-word run into <=limit-word chunks
    (prepro_labels.py:204-272): part = ((L-1)//limit)+1 near-equal chunks,
    the first part-1 of size ceil(L/part), the last takes the remainder."""
    if L <= limit:
        return [L]
    part = ((L - 1) // limit) + 1
    n = L // part
    if L % part != 0:
        n += 1
    return [n] * (part - 1) + [L - n * (part - 1)]


def heuristic_chunks(tokens: List[str]) -> List[Tuple[int, int, int]]:
    """Parser-free chunking approximating the reference's constituency
    gathers (gather_phrase_level, prepro_labels_stanford.py:182-208), with
    verb-containing chunks labeled VP and the rest NP.  Five rules, each
    validated against the 43 hand-derived constituency goldens
    (tests/goldens/constituency_cuts.json; boundary F1 0.892 overall,
    worst category 0.750, exact segmentation 19/43 — up from 0.659 /
    0.286 / 4 for plain function-word splitting):

      1. break before function words AND before verb-ish tokens — a
         participle after an NP starts its own chunk ("a young boy |
         holding | a bat"), the gathers' most common boundary;
      2. a chunk-leading preposition becomes a singleton ("of | people"),
         matching the gap rows the constituency cut emits between NPs;
      3. a relativizer directly followed by a copula merges with it
         ("who is"), and the clause remainder forms one VP ("running in
         the park") — the rel-clause gather shape;
      4. a verb chunk absorbs its trailing lone prepositions ("sitting
         on", "standing next to"), the verb-group rule;
      5. a verb-less copular chunk absorbs following conjunction chunks
         of bare adjectives plus a trailing lone preposition ("is clean
         and ready for | guests"), the predicative-adjective gather.

    Chunks longer than 5 words are split like the reference spaCy
    cutter's (prepro_labels.py:219-249) — without it a caption could
    become ONE caption-long phrase, which overflows the 20-class length
    head downstream."""
    n_tok = len(tokens)
    # rule 1: break before function words / prepositions / verby tokens
    spans: List[Tuple[int, int]] = []
    start = 0
    for i, w in enumerate(tokens):
        if i > start and (w in FUNCTION_WORDS or w in PREPOSITIONS
                          or _verby(w)):
            spans.append((start, i))
            start = i
    if start < n_tok:
        spans.append((start, n_tok))
    # rule 2: leading preposition -> singleton chunk
    out: List[Tuple[int, int]] = []
    for s, e in spans:
        if tokens[s] in PREPOSITIONS and e - s > 1:
            out += [(s, s + 1), (s + 1, e)]
        else:
            out.append((s, e))
    spans = out
    # rule 3: relativizer + copula merge; clause remainder = one chunk
    for i, (s, e) in enumerate(spans):
        if (tokens[s] in RELATIVIZERS and e - s == 1
                and i + 1 < len(spans)):
            s2, _ = spans[i + 1]
            if tokens[s2] in COPULAS:
                spans = spans[:i] + [(s, s2 + 1)]
                if s2 + 1 < n_tok:
                    spans.append((s2 + 1, n_tok))
                break
    # rule 4: verb chunk absorbs trailing lone prepositions
    out = []
    for s, e in spans:
        if out and tokens[s] in PREPOSITIONS and e - s == 1:
            ps, pe = out[-1]
            if pe == s and any(_verby(t) for t in tokens[ps:pe]):
                out[-1] = (ps, e)
                continue
        out.append((s, e))
    spans = out
    # rule 5: copular-adjective group gathers conj chunks + trailing prep
    out = []
    i = 0
    while i < len(spans):
        s, e = spans[i]
        if tokens[s] in COPULAS and not any(_verby(t)
                                            for t in tokens[s:e]):
            j = i + 1
            while j < len(spans):
                s2, e2 = spans[j]
                seg = tokens[s2:e2]
                if (tokens[s2] in CONJUNCTIONS
                        and not any(t in DETERMINERS for t in seg)
                        and not any(_verby(t) for t in seg)):
                    e = e2
                    j += 1
                    continue
                if (tokens[s2] in PREPOSITIONS and e2 - s2 == 1
                        and j + 1 < len(spans)):
                    e = e2
                    j += 1
                break
            out.append((s, e))
            i = j
        else:
            out.append((s, e))
            i += 1
    spans = out
    # label + length-limit split
    res = []
    for s, e in spans:
        syn = SYN_VP if any(_verby(t) for t in tokens[s:e]) else SYN_NP
        for piece in split_run(e - s):
            res.append((s, piece, syn))
            s += piece
    return res


def spacy_chunks(tokens, nlp) -> List[Tuple[int, int, int]]:
    """Noun chunks via spaCy (reference prepro_labels.py:157-186); chunks
    longer than 5 words are split (reference :219-249 splits >5)."""
    doc = nlp(" ".join(tokens))
    out = []
    for chunk in doc.noun_chunks:
        s, n = chunk.start, chunk.end - chunk.start
        while n > 5:
            out.append((s, 5, SYN_NP))
            s += 5
            n -= 5
        if n:
            out.append((s, n, SYN_NP))
    return out


def stanza_chunks(tokens, nlp, depth: int = 0) -> List[Tuple[int, int, int]]:
    """VP/NP spans at constituency depth ``depth``
    (reference gather_phrase_level, prepro_labels_stanford.py:182-208)."""
    doc = nlp(" ".join(tokens))
    phrases: List[Tuple[List[str], int]] = []

    def walk(node, cur_dep):
        label = getattr(node, "label", None)
        if label in ("VP", "NP"):
            cur_dep += 1
            if cur_dep == depth:
                phrases.append((_leaves(node),
                                SYN_VP if label == "VP" else SYN_NP))
                return True
        gathered = False
        for child in getattr(node, "children", []) or []:
            if walk(child, cur_dep):
                gathered = True
        if gathered:
            return True
        if label in ("VP", "NP"):
            phrases.append((_leaves(node), SYN_VP if label == "VP" else SYN_NP))
            return True
        return False

    def _leaves(node):
        kids = getattr(node, "children", []) or []
        if not kids:
            return [str(node.label)]
        out = []
        for c in kids:
            out += _leaves(c)
        return out

    for sentence in doc.sentences:
        walk(sentence.constituency, 0)

    # align phrase word lists back to token offsets (reference :258-280)
    out = []
    start = 0
    for words, lab in phrases:
        found = -1
        for i in range(start, len(tokens) - len(words) + 1):
            if tokens[i:i + len(words)] == words:
                found = i
                break
        if found < 0:
            raise ValueError("phrase can't be found")
        out.append((found, len(words), lab))
        start = found + len(words)
    return out


def assemble_phrases(n_tokens: int, spans: List[Tuple[int, int, int]],
                     max_length: int):
    """Sorted non-overlapping spans + CP gap filling
    (reference prepro_labels_stanford.py:281-300).  Returns
    (phrase_length [max_length], phrase_label [max_length], phrase_num).

    Any phrase (span or gap) of LENGTH_DIM(=20)+ words is split with the
    reference's split_run rule: the length head has LENGTH_DIM classes
    (class 0 = stop), so a phrase of 20+ words is untrainable — the
    reference's own stanford cutter would emit it and its criterion would
    crash on the out-of-range class (a latent defect, not replicated;
    phrases of 6-19 words pass through untouched like the reference's)."""
    pl = np.zeros(max_length, dtype=np.uint32)
    lab = np.zeros(max_length, dtype=np.uint32)
    cnt = 0
    end = 0

    def emit(n, syn):
        nonlocal cnt
        for piece in split_run(n, LENGTH_DIM - 1) if n >= LENGTH_DIM \
                else (n,):
            pl[cnt] = piece
            lab[cnt] = syn
            cnt += 1

    for s, n, syn in spans:
        if s > end:
            emit(s - end, SYN_CP)
        emit(n, syn)
        end = s + n
    if n_tokens > end:
        emit(n_tokens - end, SYN_CP)
    return pl, lab, cnt


def cut_captions(imgs: List[dict], max_length: int, cutter: str = "heuristic",
                 depth: int = 0):
    """Phrase-cut every final caption.  Returns (phrase_num [M],
    phrase_length [M, L], phrase_label [M, L]).  Parse failures fall back to
    all-length-1 CP phrases (reference :299-309)."""
    nlp = None
    if cutter == "spacy":
        nlp = _import("spacy").load("en_core_web_sm")
    elif cutter == "stanza":
        nlp = _import("stanza").Pipeline(
            lang="en", processors="tokenize,pos,constituency")
    M = sum(len(img["final_captions"]) for img in imgs)
    pn = np.zeros(M, dtype=np.uint32)
    pls = np.zeros((M, max_length), dtype=np.uint32)
    labs = np.zeros((M, max_length), dtype=np.uint32)
    cap = 0
    errors = 0
    for img in imgs:
        for s in img["final_captions"]:
            tokens = s[:max_length]
            try:
                if cutter == "spacy":
                    spans = spacy_chunks(tokens, nlp)
                elif cutter == "stanza":
                    spans = stanza_chunks(tokens, nlp, depth)
                else:
                    spans = heuristic_chunks(tokens)
                pl, lab, cnt = assemble_phrases(len(tokens), spans,
                                                max_length)
            except Exception:
                errors += 1
                cnt = len(tokens)
                pl = np.zeros(max_length, dtype=np.uint32)
                lab = np.zeros(max_length, dtype=np.uint32)
                pl[:cnt] = 1
                lab[:cnt] = SYN_CP
            pn[cap] = cnt
            pls[cap] = pl
            labs[cap] = lab
            cap += 1
    if errors:
        print(f"cut_captions: {errors}/{M} captions fell back to 1-word cuts")
    return pn, pls, labs


class Prepro(NamedTuple):
    """What ``prepro_captions`` makes: ``info`` (the cocotalk json:
    ix_to_word and the images' split / id / file_path), the label arrays
    and, with phrases, the cutter's (None without)."""
    info: dict
    labels: np.ndarray
    label_start_ix: np.ndarray
    label_end_ix: np.ndarray
    label_length: np.ndarray
    phrase_num: Optional[np.ndarray]
    phrase_length: Optional[np.ndarray]
    phrase_label: Optional[np.ndarray]
    vocab: List[str]


def _import(name: str):
    """``import name``, or ImportError naming the package and its cutter."""
    import importlib
    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(f"the {name} cutter needs the {name} package, "
                          f"which is not installed ({e})") from e


def prepro_captions(imgs: List[dict], max_length: int = 20,
                    word_count_threshold: int = 5,
                    cutter: str = "heuristic", depth: int = 0,
                    need_phrases: bool = True) -> Prepro:
    """A dataset_coco.json image list -> its ``Prepro``, in memory
    (reference main(), prepro_labels_stanford.py:340-406).  ``imgs`` gain
    their ``final_captions`` (``build_vocab``)."""
    vocab = build_vocab(imgs, word_count_threshold)
    # 4-indexed vocab: {0:pad 1:bos 2:eos 3:sep}, real words from 4
    # (reference prepro_labels_stanford.py:375-376) - the h5 stores these
    # ids directly, no later offset
    itow = {i + 4: w for i, w in enumerate(vocab)}
    wtoi = {w: i + 4 for i, w in enumerate(vocab)}
    labels, start, end, length = encode_captions(imgs, max_length, wtoi)
    pn = pls = labs = None
    if need_phrases:
        pn, pls, labs = cut_captions(imgs, max_length, cutter, depth)
    info = {"ix_to_word": {str(k): w for k, w in itow.items()},
            "images": []}
    for img in imgs:
        jimg = {"split": img.get("split", "train"),
                "id": img.get("cocoid", img.get("imgid"))}
        if "filename" in img:
            jimg["file_path"] = img.get("filepath", "") + "/" + img["filename"]
        if "cocoid" in img:
            jimg["id"] = img["cocoid"]
        info["images"].append(jimg)
    return Prepro(info, labels, start, end, length, pn, pls, labs, vocab)


def write_prepro(res: Prepro, output_json: str, output_h5: str) -> None:
    """The cocotalk json and the label h5 of ``res`` (reference
    prepro_labels_stanford.py:391-406).  h5py is imported here: without it
    this raises ImportError, and writes nothing."""
    import h5py
    with h5py.File(output_h5, "w") as f:
        f.create_dataset("labels", dtype="uint32", data=res.labels)
        f.create_dataset("label_start_ix", dtype="uint32",
                         data=res.label_start_ix)
        f.create_dataset("label_end_ix", dtype="uint32",
                         data=res.label_end_ix)
        f.create_dataset("label_length", dtype="uint32",
                         data=res.label_length)
        if res.phrase_num is not None:
            f.create_dataset("phrase_num", dtype="uint32",
                             data=res.phrase_num)
            f.create_dataset("phrase_length", dtype="uint32",
                             data=res.phrase_length)
            f.create_dataset("phrase_label", dtype="uint32",
                             data=res.phrase_label)
    with open(output_json, "w") as f:
        json.dump(res.info, f)


def run_prepro(input_json: str, output_json: str, output_h5: str,
               max_length: int = 20, word_count_threshold: int = 5,
               cutter: str = "heuristic", depth: int = 0,
               need_phrases: bool = True) -> List[str]:
    """dataset_coco.json -> cocotalk json + label h5; returns the vocab."""
    with open(input_json) as f:
        imgs = json.load(f)["images"]
    res = prepro_captions(imgs, max_length, word_count_threshold, cutter,
                          depth, need_phrases)
    write_prepro(res, output_json, output_h5)
    return res.vocab


def label_store(res: Prepro):
    """The ``LabelStore`` that ``LabelStore.from_files`` would read from
    ``write_prepro``'s files, built in memory (no h5py)."""
    from ..data.dataset import LabelStore
    return LabelStore(res.info["images"], res.info["ix_to_word"],
                      res.labels, res.label_start_ix, res.label_end_ix,
                      res.phrase_num, res.phrase_length, res.phrase_label)
