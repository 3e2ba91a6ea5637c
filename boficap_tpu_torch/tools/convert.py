"""Convert a checkpoint of the original PyTorch reference into the pair the
port's and the JAX package's eval CLIs read (``model.ckpt`` and
``infos_<id>.pkl``): the JAX package's ``tools/convert.py``, without flax.

    python -m boficap_tpu_torch.tools.convert --torch model_best.pth \\
        --infos infos_uic_sd-best.pkl --out_dir converted/

then evaluate it as any checkpoint:

    python -m boficap_tpu_torch.tools.eval --model converted/model.ckpt \\
        --infos_path converted/infos_converted.pkl --inference_mode NAIC

The reference pickles its argparse Namespace into ``infos['opt']`` (its
tools/train.py:62-69); it is written back as a plain dict, so the eval
CLI's option merge reads it.  Without ``--infos``, ``--train_mode`` and
``--input_json`` (the cocotalk vocabulary json) stand in.  The weights go
through ``convert.load_reference_checkpoint`` (``torch_to_flax``) and the
port's msgpack writer: the bytes ``flax.serialization.to_bytes`` writes.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

from ..convert import load_reference_checkpoint
from ..train.state import _SafeUnpickler
from ..utils.flax_msgpack import msgpack_serialize


class _InfosUnpickler(_SafeUnpickler):
    """``safe_load``'s data-only rule, and the argparse Namespace the
    reference keeps its options in."""

    def find_class(self, module: str, name: str):
        if (module, name) == ("argparse", "Namespace"):
            return argparse.Namespace
        return super().find_class(module, name)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--torch", type=str, required=True,
                   help="reference model .pth (a torch state dict)")
    p.add_argument("--infos", type=str, default="",
                   help="reference infos_*.pkl (vocab + saved train opts)")
    p.add_argument("--train_mode", type=str, default="",
                   help="override / supply when --infos is absent")
    p.add_argument("--input_json", type=str, default="",
                   help="cocotalk json for the vocab when --infos is absent")
    p.add_argument("--out_dir", type=str, default="converted")
    p.add_argument("--id", type=str, default="converted")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    opt = {}
    vocab = None
    if args.infos:
        with open(args.infos, "rb") as f:
            infos = _InfosUnpickler(f).load()
        raw = infos.get("opt", {})
        opt = dict(vars(raw)) if hasattr(raw, "__dict__") else dict(raw)
        vocab = infos.get("vocab")
    train_mode = args.train_mode or opt.get("train_mode") or "AIC"
    if vocab is None:
        if not args.input_json:
            raise SystemExit("need --infos or --input_json for the vocab")
        with open(args.input_json) as f:
            vocab = json.load(f)["ix_to_word"]
    opt["train_mode"] = train_mode
    opt["id"] = args.id

    params = load_reference_checkpoint(args.torch, train_mode)

    os.makedirs(args.out_dir, exist_ok=True)
    model_path = os.path.join(args.out_dir, "model.ckpt")
    with open(model_path, "wb") as f:
        f.write(msgpack_serialize(params))
    infos_path = os.path.join(args.out_dir, f"infos_{args.id}.pkl")
    with open(infos_path, "wb") as f:
        pickle.dump({"opt": opt, "vocab": vocab, "iter": 0, "epoch": 0,
                     "vocab_size": len(vocab)}, f)
    print(f"wrote {model_path} and {infos_path} (train_mode={train_mode}, "
          f"vocab {len(vocab)})")
    return model_path, infos_path


if __name__ == "__main__":
    main()
