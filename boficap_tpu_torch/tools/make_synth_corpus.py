"""Generate a LEARNABLE synthetic caption corpus + feature store: the JAX
package's ``scripts/make_synth_corpus.py``, the same flags and files.

The reference ships no test fixtures and trains only on COCO (which is not
available here); this script builds a corpus where captions are a
deterministic function of the region features, so an end-to-end training run
can demonstrate real learning (CIDEr going from ~0 to near-perfect) through
the full two-stage recipe (XE -> SCST), exercising the same artifact formats
the reference's dataloader consumes (data.json + label.h5 + a directory of
.npz att features; reference captioning/data/dataloader.py:296-352).

Task design ("slot-vocabulary sorting"):
  * 6 caption slots, each with a disjoint 10-word sub-vocabulary (V=60).
  * An image = one word chosen per slot; its caption is always those 6
    words in slot order, so the target order is derivable from word
    identity alone (the encoder sees a SET of regions — no positional
    signal is needed or provided, matching real region features).
  * Region r < 6 carries slot-r's word as a fixed random 2048-d code plus
    Gaussian noise; 3 extra regions are pure-noise distractors, so
    attention must be learned, not averaged.
  * Phrase structure (for bounding supervision) is a deterministic
    function of the slot-0 word: pattern index = word_id % 3 over
    {[2,2,2], [3,3], [1,2,3]}, syn tags cycling NP/VP/CP — so the length
    predictor's targets are inferable from the image.
  * All 5 captions per image are identical (CIDEr-D of an exact match is
    10.0, making the learning curve easy to read).

Usage:
  python -m boficap_tpu_torch.tools.make_synth_corpus --out data_synth \\
      --n_images 400

Writing the label h5 needs h5py.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..constants import EOS
from ..data.dataset import LabelStore

SLOTS = 6
WORDS_PER_SLOT = 10
VOCAB = SLOTS * WORDS_PER_SLOT                       # 60 words, ids 4..63
PATTERNS = [(2, 2, 2), (3, 3), (1, 2, 3)]
SYNS = (5, 4, 6)                                      # NP, VP, CP cycle
N_DISTRACT = 3
FEAT_DIM = 2048


def caption_for(slot_words):
    """slot_words: 6 raw ids in [0, VOCAB) -> (label row ids, pattern)."""
    pat = PATTERNS[slot_words[0] % len(PATTERNS)]
    return [w + 4 for w in slot_words], pat


class ArrayFeatures:
    """Region features by image id, over an array (a feature reader for
    ``CaptionData``, in place of the att directory)."""

    def __init__(self, att):
        self.att = att

    def get(self, key: str) -> np.ndarray:
        return self.att[int(key)]


def build(n: int, cpi: int = 5, L: int = 20, noise: float = 0.1,
          seed: int = 0, short: int = 0, eos: bool = False):
    """The corpus in memory, drawn from ``seed`` in the order ``main``
    writes it.  ``short``: an image whose last slot word is among the first
    ``short`` of its slot's words drops it (a 5-word caption, its last
    phrase one word shorter); ``eos``: each label row holds EOS after its
    last word.  Returns ((labels, label_start_ix, label_end_ix,
    phrase_num, phrase_length, phrase_syn), images, region features
    [n, SLOTS + N_DISTRACT, FEAT_DIM])."""
    rng = np.random.RandomState(seed)

    # fixed word codebook (shared across images; row-normalized)
    codes = rng.randn(VOCAB, FEAT_DIM).astype(np.float32)
    codes /= np.linalg.norm(codes, axis=1, keepdims=True)

    n_caps = n * cpi
    labels = np.zeros((n_caps, L), np.int32)
    pn = np.zeros(n_caps, np.int32)
    pls = np.zeros((n_caps, L), np.int32)
    syns = np.zeros((n_caps, L), np.int32)
    att = np.zeros((n, SLOTS + N_DISTRACT, FEAT_DIM), np.float32)
    images = []

    n_tr = int(n * 0.8)
    n_va = int(n * 0.1)
    for ix in range(n):
        slot_words = [rng.randint(WORDS_PER_SLOT) + s * WORDS_PER_SLOT
                      for s in range(SLOTS)]
        word_ids, pat = caption_for(slot_words)
        pat = list(pat)
        if slot_words[-1] % WORDS_PER_SLOT < short:
            word_ids = word_ids[:-1]
            pat[-1] -= 1
        rows = slice(ix * cpi, (ix + 1) * cpi)
        labels[rows, :len(word_ids)] = word_ids
        if eos:
            labels[rows, len(word_ids)] = EOS
        pn[rows] = len(pat)
        pls[rows, :len(pat)] = pat
        syns[rows, :len(pat)] = [SYNS[k % 3] for k in range(len(pat))]

        feats = np.concatenate([
            codes[slot_words] + noise * rng.randn(SLOTS, FEAT_DIM),
            rng.randn(N_DISTRACT, FEAT_DIM) / np.sqrt(FEAT_DIM),
        ]).astype(np.float32)
        perm = rng.permutation(SLOTS + N_DISTRACT)    # region order is a set
        att[ix] = feats[perm]

        split = ("train" if ix < n_tr
                 else "val" if ix < n_tr + n_va else "test")
        images.append({"id": ix, "split": split, "file_path": f"img{ix}.jpg"})

    start = np.arange(n) * cpi + 1                    # 1-based, ref format
    end = start + cpi - 1
    return (labels, start, end, pn, pls, syns), images, att


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data_synth")
    ap.add_argument("--n_images", type=int, default=400)
    ap.add_argument("--caps_per_img", type=int, default=5)
    ap.add_argument("--L", type=int, default=20)
    ap.add_argument("--noise", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    n, cpi = args.n_images, args.caps_per_img
    arrays, images, att = build(n, cpi, args.L, args.noise, args.seed)
    labels = arrays[0]

    feat_dir = os.path.join(args.out, "att")
    os.makedirs(feat_dir, exist_ok=True)
    for ix in range(n):
        np.savez_compressed(os.path.join(feat_dir, f"{ix}.npz"), feat=att[ix])

    ix_to_word = {str(i + 4): f"w{i}" for i in range(VOCAB)}
    store = LabelStore(images, ix_to_word, *arrays)
    store.save(args.out)

    # karpathy-format raw json so prepro_ngrams (SCST stage) runs
    # unchanged on this corpus
    raw = []
    for ix, img in enumerate(images):
        sents = []
        for c in range(cpi):
            row = labels[ix * cpi + c]
            toks = [f"w{int(w) - 4}" for w in row if w > 0]
            sents.append({"tokens": toks})
        raw.append({"split": img["split"], "cocoid": img["id"],
                    "sentences": sents})
    with open(os.path.join(args.out, "raw.json"), "w") as f:
        json.dump({"images": raw}, f)
    print(f"wrote {n} images / {n * cpi} captions to {args.out}")


if __name__ == "__main__":
    main()
