"""Cached CIDEr document frequencies: the JAX package's
``scripts/prepro_ngrams.py`` (reference scripts/prepro_ngrams.py), the
same flags; writes ``<output_pkl>-words.p`` and ``<output_pkl>-idxs.p``,
which the RL stage's ``cached_tokens`` reads.

    python -m boficap_tpu_torch.tools.prepro_ngrams \\
        --input_json data/dataset_coco.json --dict_json data/cocotalk.json \\
        --output_pkl data/coco-train --split train
"""

from __future__ import annotations

import argparse
import json

from ..rewards.ngrams import build_doc_freq, save_doc_freq


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_json", default="data/dataset_coco.json")
    p.add_argument("--dict_json", default="data/cocotalk.json")
    p.add_argument("--output_pkl", default="data/coco-all")
    p.add_argument("--split", default="all")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    with open(a.dict_json) as f:
        itow = json.load(f)["ix_to_word"]
    wtoi = {w: i for i, w in itow.items()}
    with open(a.input_json) as f:
        imgs = json.load(f)["images"]

    refs_words, refs_idxs = [], []
    for img in imgs:
        if not (a.split == "all" or img["split"] == a.split or
                (a.split == "train" and img["split"] == "restval")):
            continue
        rw, ri = [], []
        for sent in img["sentences"]:
            toks = [w if w in wtoi else "UNK" for w in sent["tokens"]]
            # '<eos>' terminator id 0, matching array_to_str's trailing 0
            rw.append(" ".join(toks + ["<eos>"]))
            ri.append(" ".join([str(wtoi.get(w, 0)) for w in toks] + ["0"]))
        refs_words.append(rw)
        refs_idxs.append(ri)

    dfw, n = build_doc_freq(refs_words)
    dfi, _ = build_doc_freq(refs_idxs)
    save_doc_freq(a.output_pkl + "-words.p", dfw, n)
    save_doc_freq(a.output_pkl + "-idxs.p", dfi, n)
    print(f"wrote df over {n} images to {a.output_pkl}-words.p / -idxs.p")


if __name__ == "__main__":
    main()
