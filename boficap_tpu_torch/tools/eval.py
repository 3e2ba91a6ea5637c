"""Evaluation CLI of the port: the JAX package's ``tools/eval.py`` with the
same flags, precedence and outputs, on the card's kernels:

    python -m boficap_tpu_torch.tools.eval --model log_uic_sd/model_best.ckpt \\
        --infos_path log_uic_sd/infos_uic_sd_best.pkl \\
        --inference_mode NAIC --language_eval 1

It reads a checkpoint the JAX package wrote (``model.ckpt``, flax msgpack;
``infos_<id>.pkl``, a pickle read as data only), merges the options as
``build_eval_opt`` says, runs ``eval_split`` and writes
``eval_results/<id>_<split>.json`` (and ``vis/vis.json`` with
``--dump_json 1``) in the working directory; ``--only_lang_eval 1`` scores
the cached predictions again, with the multi-sample metrics of cached
``sample_n`` captions.  Every decoder of ``eval_split`` is reachable: NAIC,
SAIC, NNAIC, PB_pad (``--pb_packed_width`` raises its packed-width cap),
AIC greedy, beam and diverse beam (``--group_size``), and ``--sample_n``
captions (AIC).  ``--device`` is ``cuda`` by default;
``--device cpu`` runs the plain path.

``--image_folder DIR`` captions a folder of images (``data/raw.py``'s
``DataLoaderRaw``, ``--coco_json`` and ``--cnn_model`` as in the JAX
package): on the card each image goes through the ResNet-101 trunk
(``models/resnet.py``; ``$BOFICAP_CNN_WEIGHTS`` names a torchvision
state dict, random weights otherwise) to a 14 x 14 = 196-region memory,
on the CPU through the patch extractor.  The vocabulary comes from the
infos, language_eval is off (no ground truth) and ``image_root``
defaults to the folder (``--dump_images``, ``--dump_path``).

``--dump_attention 1`` (JAX tools/eval.py:213-240): one teacher-forced
pass of the split's first batch (its labels and phrase plan; dummy ones
for a raw folder's batch) with the attention capture on
(``capture_attention``: every attention on the plain path), every map
[B, H, Lq, Lk] saved to ``vis/attn.npz`` under JAX's keys, and the
reference-style 10 x 10 mean accumulator printed.

``--report_flops 1`` (JAX tools/eval.py:242-252): ``eval_utils.
report_flops`` on the same batch, one ``flops[program]`` line a program
(encode and the branch's decode), also written to the eval_results json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..config import (Config, add_eval_options, default_config, finalize,
                      load_yaml_with_base, restore_saved_opt)
from ..convert import load_jax_checkpoint
from ..data.dataset import CaptionData
from ..data.raw import DataLoaderRaw
from ..device import resolve_device
from ..eval import eval_utils
from ..eval.metrics import language_eval
from ..eval.multi_metrics import multi_sample_eval
from ..models import setup as models_setup
from ..train.state import safe_load


def parse_eval_opt(argv=None):
    # allow_abbrev=False so the explicit-flag scan below sees the exact
    # option strings the user typed
    parser = argparse.ArgumentParser(allow_abbrev=False)
    parser.add_argument("--model", type=str, required=True,
                        help="path to model .ckpt")
    parser.add_argument("--infos_path", type=str, required=True,
                        help="path to infos .pkl")
    parser.add_argument("--cfg", type=str, default=None)
    parser.add_argument("--id", type=str, default="")
    parser.add_argument("--beam_size", type=int, default=1)
    parser.add_argument("--sample_method", type=str, default="greedy")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--sample_n", type=int, default=1)
    parser.add_argument("--verbose", type=int, default=0)
    parser.add_argument("--verbose_beam", type=int, default=0)
    parser.add_argument("--remove_bad_endings", type=int, default=0)
    parser.add_argument("--length_penalty", type=str, default="")
    add_eval_options(parser)
    tokens = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(tokens)
    # which flags were EXPLICITLY given: build_eval_opt lets a --cfg file
    # override parser defaults but not typed flags
    explicit = set()
    for action in parser._actions:
        for opt_str in action.option_strings:
            if any(t == opt_str or t.startswith(opt_str + "=")
                   for t in tokens):
                explicit.add(action.dest)
    args._explicit = explicit
    return args


# reference's "replace" list (tools/eval.py:53): a truthy CLI value wins,
# otherwise the checkpoint's saved value stays
REPLACE_KEYS = ("input_fc_dir", "input_att_dir", "input_box_dir",
                "input_label_h5", "input_json", "batch_size", "id")


def build_eval_opt(args, infos) -> Config:
    """Merge: explicit CLI > --cfg file > eval-parser defaults > saved
    train opts > train defaults (the JAX package's ``build_eval_opt``, line
    for line).  Only None and 0 defer to the saved opts (outside
    language_eval / verbose, which keep their parser defaults); an empty
    string overrides a saved value.  ``replace`` keys: a truthy CLI value
    wins, otherwise the saved (or file) value stays."""
    merged = restore_saved_opt(infos.get("opt", {}))
    yaml_keys = frozenset()
    if args.cfg:
        y = load_yaml_with_base(args.cfg)
        yaml_keys = frozenset(y)
        merged.update(y)
    opt = default_config()
    opt.merge_from_dict(merged)
    # namespaces built by hand carry no _explicit: every flag takes the
    # precedence chain below
    explicit = getattr(args, "_explicit", frozenset())
    for k, v in vars(args).items():
        if k in ("model", "infos_path", "cfg", "_explicit"):
            continue
        if k in REPLACE_KEYS:
            if v:                # parser defaults here are all falsy
                opt[k] = v
        elif k in explicit:
            if v is not None:
                opt[k] = v
        elif k in yaml_keys:
            pass                 # the file beats an untyped parser default
        elif v is not None and (k not in opt or v != 0 or k in
                                ("language_eval", "verbose")):
            # reference rule: eval-namespace flags keep their parser
            # defaults over the checkpoint's saved opts
            opt[k] = v
    if not opt.get("id"):
        opt.id = infos.get("opt", {}).get("id", "model")
    finalize(opt)
    return opt


def _forward_args(ex, opt, device):
    """The teacher-forced forward's inputs of loader batch ``ex`` on
    ``device``: its labels and phrase plan, or for a raw folder's batch
    (no labels) the dummy ones of JAX tools/eval.py:195-204."""
    from ..train.steps import _flat, to_device
    tb = to_device(ex, device)
    f = _flat(tb)
    if f.get("labels") is None:
        B = tb["att_feats"].shape[0]
        L2 = int(opt.get("max_length", 20) or 20) + 2
        z = torch.zeros((B, L2), dtype=torch.long, device=device)
        f = {"labels": z.clone(), "phrase_length": z.clone(),
             "phrase_syn": z.clone(),
             "phrase_num": torch.full((B,), 2, dtype=torch.long,
                                      device=device)}
        f["labels"][:, 0] = 1
        f["phrase_length"][:, :2] = torch.tensor([1, 2])
        f["phrase_syn"][:, 1] = 5
    return tb["att_feats"], tb["att_masks"], f


@torch.no_grad()
def dump_attention(model, ex, opt, device) -> dict:
    """One teacher-forced pass of ``ex`` with the attention capture on:
    ``vis/attn.npz`` holds every map under JAX's keys (float32), and the
    10 x 10 mean accumulator is printed.  Returns the maps."""
    att, am, f = _forward_args(ex, opt, device)
    with model.capture_attention() as store:
        model(att, am, f["labels"], f.get("phrase_num"),
              f.get("phrase_length"), f.get("phrase_syn"), glat_p=None)

    def order(key):             # tree_flatten_with_path's order
        parts = key.split("/")
        return parts[:-1], int(parts[-1][1:-1])

    flat = {k: store[k].float().cpu().numpy() for k in sorted(store,
                                                                key=order)}
    os.makedirs("vis", exist_ok=True)
    np.savez("vis/attn.npz", **flat)
    acc = np.zeros((10, 10))
    for v in flat.values():                     # [B, H, Q, K] maps
        m = v.mean(axis=(0, 1))
        q, k = min(10, m.shape[0]), min(10, m.shape[1])
        acc[:q, :k] += m[:q, :k]
    print("attention 10x10 accumulator (saved full maps to vis/attn.npz)")
    print(np.array_str(acc, precision=3, suppress_small=True))
    return flat


def main(argv=None):
    args = parse_eval_opt(argv)
    with open(args.infos_path, "rb") as f:
        infos = safe_load(f)
    opt = build_eval_opt(args, infos)

    # opt holds the final merged value of every eval flag; args is only
    # read for the two checkpoint paths (and --cfg, read above)
    eval_kwargs = dict(opt)
    eval_kwargs["model"] = args.model
    eval_kwargs["infos_path"] = args.infos_path

    # cached-result short circuit (reference tools/eval.py:65-97)
    if opt.get("only_lang_eval") and not opt.get("force"):
        cached = eval_utils.load_cached(eval_kwargs)
        if cached is not None:
            stats = language_eval(cached["predictions"], cached["gts_words"])
            if cached.get("n_predictions"):
                stats.update(multi_sample_eval(
                    cached["n_predictions"], cached["gts_words"],
                    eval_oracle=bool(opt.get("eval_oracle", 1))))
            print(stats)
            return stats
        print("no cached predictions; running full eval")

    device = resolve_device(opt.get("device") or None)
    if opt.get("image_folder"):
        # a folder of raw images (reference tools/eval.py:109-118): the
        # features are made on the fly; the vocabulary comes from the
        # train infos, and without gt captions language_eval is off
        loader = DataLoaderRaw(
            opt.image_folder,
            batch_size=int(opt.get("batch_size", 10) or 10),
            coco_json=opt.get("coco_json") or "",
            cnn_model=opt.get("cnn_model", "resnet101"), device=device)
        loader.ix_to_word = infos["vocab"]
        loader.vocab_size = len(infos["vocab"])
        loader.seq_length = int(opt.get("max_length", 20) or 20)
        if eval_kwargs.get("language_eval"):
            print("--image_folder has no gt captions; language_eval -> 0")
        eval_kwargs["language_eval"] = 0
        if not eval_kwargs.get("image_root"):
            eval_kwargs["image_root"] = opt.image_folder
    else:
        loader = CaptionData(opt)
    model = models_setup(opt, loader.vocab_size, device)
    load_jax_checkpoint(args.model, model)
    model.eval()

    flops = None
    if opt.get("dump_attention") or opt.get("report_flops"):
        # the split's first batch, as the JAX CLI draws it for its template
        ex = loader.get_batch(opt.split)
        loader.reset_iterator(opt.split)
        if opt.get("dump_attention"):
            dump_attention(model, ex, opt, device)
        if opt.get("report_flops"):
            flops = eval_utils.report_flops(
                model, ex, eval_kwargs, inference_mode=opt.inference_mode,
                ix_to_word=getattr(loader, "ix_to_word", {}))
            for name, c in flops.items():
                print(f"flops[{name}]: {c['flops'] / 1e9:.3f} GFLOP/batch "
                      f"({c['per_image_gflops']:.3f} GFLOP/image), "
                      f"bytes {c['bytes_accessed'] / 1e6:.1f} MB")

    result = eval_utils.eval_split(model, loader, eval_kwargs,
                                   inference_mode=opt.inference_mode)
    print(f"decode_time {result['decode_time']:.3f}s "
          f"(compile {result['compile_time']:.3f}s), "
          f"images/s {result['images_per_s']:.2f}")
    if result["lang_stats"]:
        print(result["lang_stats"])

    eval_utils.save_cached(eval_kwargs, {
        "predictions": result["predictions"],
        "n_predictions": result.get("n_predictions") or [],
        "gts_words": result["gts_words"]})
    if opt.get("dump_json"):
        os.makedirs("vis", exist_ok=True)
        with open("vis/vis.json", "w") as f:
            json.dump(result["predictions"], f)
    # eval artifacts dir like the reference (eval_utils.py:660-664)
    os.makedirs("eval_results", exist_ok=True)
    with open(os.path.join("eval_results",
                           f"{opt.id}_{opt.split}.json"), "w") as f:
        json.dump({"predictions": result["predictions"],
                   "lang_stats": result["lang_stats"],
                   "decode_time": result["decode_time"],
                   "images_per_s": result["images_per_s"],
                   **({"flops": flops} if flops else {})}, f)
    return result


if __name__ == "__main__":
    main()
