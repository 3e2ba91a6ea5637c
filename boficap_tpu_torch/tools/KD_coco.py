"""Splice teacher beam captions into dataset_coco.json: the JAX package's
``scripts/KD_coco.py`` (reference scripts/KD_coco.py), the same flags.

    python -m boficap_tpu_torch.tools.KD_coco \\
        --input_json data/dataset_coco.json --kd_json KD_dataset/0305.json \\
        --output_json data/dataset_coco_kd90.json

``--kd_json`` is what the eval CLI's ``--KD_file`` dumps: image id -> its
teacher beams.
"""

from __future__ import annotations

import argparse
import json

from ..prepro.phrase_pairs import splice_kd_captions


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_json", default="data/dataset_coco.json")
    p.add_argument("--kd_json", default="KD_dataset/0305.json")
    p.add_argument("--output_json", default="data/dataset_coco_kd90.json")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    with open(a.input_json) as f:
        ori = json.load(f)
    with open(a.kd_json) as f:
        kd = json.load(f)
    out = splice_kd_captions(ori, kd)
    with open(a.output_json, "w") as f:
        json.dump(out, f)
    print(f"wrote {a.output_json}")


if __name__ == "__main__":
    main()
