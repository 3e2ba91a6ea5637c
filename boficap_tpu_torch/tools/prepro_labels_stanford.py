"""Stanza constituency phrase cutting with VP/NP/CP labels: the JAX
package's ``scripts/prepro_labels_stanford.py`` (reference
scripts/prepro_labels_stanford.py), the same flags and files.

    python -m boficap_tpu_torch.tools.prepro_labels_stanford \\
        --input_json data/dataset_coco.json --depth 0

writes ``<output_json>`` and ``<output_h5>_label.h5``; without stanza, the
heuristic cutter.  Writing the h5 needs h5py.
"""

from __future__ import annotations

import argparse

from ..prepro.labels import run_prepro


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_json", required=True)
    p.add_argument("--output_json", default="data/cocotalk_stanza.json")
    p.add_argument("--output_h5", default="data/cocotalk_stanza")
    p.add_argument("--max_length", type=int, default=20)
    p.add_argument("--word_count_threshold", type=int, default=5)
    p.add_argument("--depth", type=int, default=0,
                   help="constituency depth at which VP/NP are gathered")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    try:
        run_prepro(a.input_json, a.output_json, a.output_h5 + "_label.h5",
                   a.max_length, a.word_count_threshold, "stanza", a.depth)
    except ImportError as e:
        print(f"{e}; retrying with the heuristic cutter")
        run_prepro(a.input_json, a.output_json, a.output_h5 + "_label.h5",
                   a.max_length, a.word_count_threshold, "heuristic")


if __name__ == "__main__":
    main()
