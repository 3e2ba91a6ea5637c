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

Not ported (``NotImplementedError``, naming the ROADMAP item):
``--image_folder`` (raw images), ``--dump_attention``, ``--report_flops``
(XLA cost analysis has no counterpart yet).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..config import (Config, add_eval_options, default_config, finalize,
                      load_yaml_with_base, restore_saved_opt)
from ..convert import load_jax_checkpoint
from ..data.dataset import CaptionData
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

    if opt.get("image_folder"):
        eval_utils.not_ported("eval over a raw image folder (--image_folder:"
                              " models/resnet.py, data/raw.py)", 10)
    if opt.get("dump_attention"):
        eval_utils.not_ported("--dump_attention (attention maps of a "
                              "teacher-forced pass)", 12)
    if opt.get("report_flops"):
        eval_utils.not_ported("--report_flops (XLA cost analysis of the "
                              "decode programs has no counterpart yet)", 12)
    device = resolve_device(opt.get("device") or None)
    loader = CaptionData(opt)
    model = models_setup(opt, loader.vocab_size, device)
    load_jax_checkpoint(args.model, model)
    model.eval()

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
                   "images_per_s": result["images_per_s"]}, f)
    return result


if __name__ == "__main__":
    main()
