"""BPE-style greedy phrase-pair merging: the JAX package's
``scripts/phrase_encoding.py`` (reference scripts/phrase_encoding.py), the
same flags; writes the merge table ``phrase_pair.json``.

    python -m boficap_tpu_torch.tools.phrase_encoding \\
        --input_json data/dataset_coco.json \\
        --input_h5 data/cocotalk_label.h5 --output_json data/phrase_pair.json

With ``--input_h5`` (read with h5py) the units are the label file's
phrases, else single words.
"""

from __future__ import annotations

import argparse
import json

from ..prepro.phrase_pairs import learn_phrase_pairs


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_json", required=True)
    p.add_argument("--input_h5", default="")
    p.add_argument("--output_json", default="data/phrase_pair.json")
    p.add_argument("--phrase_count_threshold", type=int, default=5)
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    with open(a.input_json) as f:
        imgs = json.load(f)["images"]
    phrase_data = None
    if a.input_h5:
        import h5py
        with h5py.File(a.input_h5, "r") as h5:
            phrase_data = (h5["label_start_ix"][:], h5["phrase_num"][:],
                           h5["phrase_length"][:])
    rec = learn_phrase_pairs(imgs, phrase_data, a.phrase_count_threshold)
    with open(a.output_json, "w") as f:
        json.dump(rec, f)
    print(f"{len(rec)} merges -> {a.output_json}")


if __name__ == "__main__":
    main()
