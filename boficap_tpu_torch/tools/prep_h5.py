"""Apply learned phrase-pair merges back onto a label h5: the JAX
package's ``scripts/prep_h5.py`` (reference scripts/prep_h5.py), the same
flags; rewrites phrase_num and phrase_length, copies every other dataset.

    python -m boficap_tpu_torch.tools.prep_h5 --input_json \\
        data/dataset_coco.json --input_h5 data/cocotalk_label.h5 \\
        --pair_json data/phrase_pair.json --output_h5 data/merged_label.h5

Reads and writes the h5 with h5py.
"""

from __future__ import annotations

import argparse
import json

from ..prepro.phrase_pairs import apply_merges_to_h5


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_json", required=True)
    p.add_argument("--input_h5", required=True)
    p.add_argument("--pair_json", required=True)
    p.add_argument("--output_h5", required=True)
    return p.parse_args(argv)


def main(argv=None):
    import h5py
    a = parse_args(argv)
    with open(a.input_json) as f:
        imgs = json.load(f)["images"]
    with open(a.pair_json) as f:
        merges = json.load(f)
    with h5py.File(a.input_h5, "r") as h5:
        data = {k: h5[k][:] for k in h5.keys()}
    pn, pl = apply_merges_to_h5(imgs, data["label_start_ix"],
                                data["phrase_num"], data["phrase_length"],
                                merges)
    data["phrase_num"], data["phrase_length"] = pn, pl
    with h5py.File(a.output_h5, "w") as f:
        for k, v in data.items():
            f.create_dataset(k, data=v)
    print(f"wrote {a.output_h5}")


if __name__ == "__main__":
    main()
