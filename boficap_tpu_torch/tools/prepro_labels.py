"""Vocab, caption encoding and phrase cutting: the JAX package's
``scripts/prepro_labels.py`` (reference scripts/prepro_labels.py), the same
flags and files.

    python -m boficap_tpu_torch.tools.prepro_labels \\
        --input_json data/dataset_coco.json \\
        --output_json data/cocotalk.json --output_h5 data/cocotalk

writes ``<output_json>`` and ``<output_h5>_label.h5``.  Falls back to the
dependency-free heuristic cutter when spaCy is absent (``--cutter
heuristic`` asks for it).  Writing the h5 needs h5py.
"""

from __future__ import annotations

import argparse

from ..prepro.labels import run_prepro


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_json", required=True)
    p.add_argument("--output_json", default="data/cocotalk.json")
    p.add_argument("--output_h5", default="data/cocotalk")
    p.add_argument("--max_length", type=int, default=20)
    p.add_argument("--word_count_threshold", type=int, default=5)
    p.add_argument("--cutter", default="spacy",
                   choices=["spacy", "stanza", "heuristic"])
    p.add_argument("--no_phrases", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    try:
        run_prepro(a.input_json, a.output_json, a.output_h5 + "_label.h5",
                   a.max_length, a.word_count_threshold, a.cutter,
                   need_phrases=not a.no_phrases)
    except ImportError as e:
        print(f"{e}; retrying with the heuristic cutter")
        run_prepro(a.input_json, a.output_json, a.output_h5 + "_label.h5",
                   a.max_length, a.word_count_threshold, "heuristic",
                   need_phrases=not a.no_phrases)


if __name__ == "__main__":
    main()
