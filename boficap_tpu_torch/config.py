"""Configuration for the port: a reader for the repo's flat ``key: value``
YAML files, the JAX package's option defaults (``config/opts.py``), its
training and eval-CLI flags with their merge order (CLI > ``--set_cfgs`` >
``--cfg`` file > defaults), and the checks and derived defaults of its
``finalize``.

PyYAML is not assumed on the GPU machine, so this reader handles only the
subset the shipped configs use: one ``key: value`` per line, ``#``
comments, scalars (int, float, bool, null, bare or quoted strings) and an
optional ``_BASE_`` parent file.  Anything else (nesting, lists, block
scalars) raises, rather than being read wrongly.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Any, Dict

BASE_KEY = "_BASE_"

# the JAX package's config/opts.py DEFAULTS, key for key and value for
# value (tests/test_torch_port_eval.py holds the two equal), plus the port's
# ``use_cuda_fill``.  build_model reads the model fields; a file that names
# no dtype builds a bfloat16 model, as the JAX package does (set ``dtype:
# float32`` for float32).  ``use_pallas`` keeps the JAX package's key; in
# the port it routes the eligible attention calls through the
# attention-core kernel (ops/attention.py).  ``use_cuda_fill`` is the
# counterpart of ``use_pallas_fill``: 'auto' runs the eval decoders on the
# kernels when the model is on a CUDA device (eval/eval_utils.py).  Keys
# only the JAX package reads (TPU meshes, XLA options) stay, so a saved
# train opt and an eval merge see the same key set on both sides.
DEFAULTS: Dict[str, Any] = dict(
    # data input settings
    input_json="data/coco.json",
    input_fc_dir="data/cocotalk_fc",
    input_att_dir="data/cocotalk_att",
    input_box_dir="data/cocotalk_box",
    input_label_h5="data/coco_label.h5",
    input_multilabel_dir=None,
    data_in_memory=False,
    start_from=None,
    cached_tokens="coco-train-idxs",
    init_from=None,
    # model settings
    train_mode="AIC",
    preprocess_mode="phrase",
    norm_mode="copy",
    decoder_input_mode="add",
    N_len=0,
    self_dis=False,
    rl_kl=False,
    caption_model="transformer",
    rnn_size=512,
    num_layers=1,
    rnn_type="lstm",
    input_encoding_size=512,
    att_hid_size=512,
    fc_feat_size=2048,
    att_feat_size=2048,
    logit_layers=1,
    use_bn=0,
    max_boxes=100,
    norm_att_feat=0,
    use_box=0,
    norm_box_feat=0,
    N_enc=None,
    N_dec=None,
    d_model=None,
    d_ff=None,
    num_att_heads=8,
    dropout=0.1,
    max_length=20,
    # optimization: general
    max_epochs=-1,
    batch_size=16,
    grad_clip_mode="value",
    grad_clip_value=0.1,
    drop_prob_lm=0.5,
    self_critical_after=-1,
    seq_per_img=5,
    # optimization: for the language model
    optim="adam",
    learning_rate=4e-4,
    learning_rate_decay_start=-1,
    learning_rate_decay_every=3,
    learning_rate_decay_rate=0.8,
    optim_alpha=0.9,
    optim_beta=0.999,
    optim_epsilon=1e-8,
    weight_decay=0.0,
    label_smoothing=0.0,
    remat=0,
    noamopt=False,
    noamopt_warmup=2000,
    noamopt_factor=1.0,
    reduce_on_plateau=False,
    reduce_on_plateau_factor=0.5,
    reduce_on_plateau_patience=3,
    cached_transformer=False,
    use_warmup=False,
    scheduled_sampling_start=-1,
    scheduled_sampling_increase_every=5,
    scheduled_sampling_increase_prob=0.05,
    scheduled_sampling_max_prob=0.25,
    # glancing training (GLAT) anneal
    glancing_token=False,
    unmasked_rate_decay_start=2,
    unmasked_rate_decay_every=2,
    unmasked_rate_decay_rate=0.1,
    unmasked_rate_start=0.5,
    unmasked_rate_end=0.1,
    # evaluation/checkpointing
    val_images_use=3200,
    save_checkpoint_every=2500,
    save_every_epoch=False,
    save_history_ckpt=0,
    checkpoint_path=None,
    language_eval=0,
    losses_log_every=25,
    load_best_score=1,
    # misc
    id="",
    train_only=0,
    # reward
    cider_reward_weight=1.0,
    bleu_reward_weight=0.0,
    # structure loss
    structure_loss_weight=1.0,
    structure_after=-1,
    structure_loss_type="seqnll",
    struc_use_logsoftmax=False,
    entropy_reward_weight=0.0,
    self_cider_reward_weight=0.0,
    train_sample_n=16,
    train_sample_method="sample",
    train_beam_size=1,
    sc_sample_method="greedy",
    sc_beam_size=1,
    # drop worst
    drop_worst_after=-1,
    drop_worst_rate=0.0,
    # sampling defaults used by eval / SCST
    beam_size=1,
    sample_method="greedy",
    temperature=1.0,
    sample_n=1,
    group_size=1,
    diversity_lambda=0.5,
    decoding_constraint=0,
    block_trigrams=0,
    remove_bad_endings=0,
    suppress_UNK=1,
    length_penalty="",
    inference_mode="",
    # run-time knobs
    seed=42,
    device="",
    dtype="bfloat16",
    param_dtype="float32",
    mesh_shape=None,
    multihost=False,
    dist_coordinator="",
    dist_num_processes=0,
    dist_process_id=-1,
    data_prefetch=2,
    use_pallas=False,
    use_pallas_fill="auto",
    profile_steps=0,
    debug_checks=False,
    grad_accum=1,
    fused_optimizer=False,
    rng_impl="rbg",
    REFORWARD=False,
    use_cuda_fill="auto",
)


class Config(dict):
    """Attribute-accessible dict; unknown attributes raise AttributeError
    (use ``cfg.get(k, default)`` for optional keys)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def merge_from_dict(self, other: Dict[str, Any]) -> "Config":
        """Set every key of ``other``; a dict merges into a dict already
        there (the JAX package's ``Config.merge_from_dict``)."""
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), dict):
                sub = self[k]
                if not isinstance(sub, Config):
                    sub = self[k] = Config(sub)
                sub.merge_from_dict(v)
            else:
                self[k] = _wrap(v)
        return self

    def merge_from_list(self, kv_list) -> "Config":
        """``[key1, val1, key2, val2, ...]`` overrides (``--set_cfgs``), each
        string coerced to the type of the value it replaces."""
        if len(kv_list) % 2:
            raise ValueError(f"override list must have even length: "
                             f"{kv_list}")
        for k, v in zip(kv_list[0::2], kv_list[1::2]):
            node = self
            parts = k.split(".")
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = _coerce(v, node.get(parts[-1]))
        return self


def _coerce(v: Any, like: Any) -> Any:
    """A string override in the type of the value it replaces (the JAX
    package's ``_coerce``; a value with no type to follow is read as a
    flat YAML scalar)."""
    if not isinstance(v, str):
        return v
    if like is None:
        try:
            return _scalar(v.strip(), "--set_cfgs")
        except ValueError:
            return v
    if isinstance(like, bool):
        return v.lower() in ("1", "true", "yes", "on")
    if isinstance(like, int):
        try:
            return int(v)
        except ValueError:
            return float(v)
    if isinstance(like, float):
        return float(v)
    return v


def _wrap(v: Any) -> Any:
    if isinstance(v, dict) and not isinstance(v, Config):
        return Config({k: _wrap(x) for k, x in v.items()})
    return v


def default_config() -> Config:
    return Config(DEFAULTS)


_INT = re.compile(r"[-+]?\d+$")
_FLOAT = re.compile(r"[-+]?(\d+\.\d*|\.\d+|\d+)([eE][-+]?\d+)?$")


def _scalar(text: str, where: str) -> Any:
    if text == "" or text.lower() in ("null", "~", "none"):
        return None
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text[0] in "[{|>&*!%@`'\"":
        raise ValueError(f"{where}: unsupported YAML value {text!r} (the "
                         "port's reader takes flat scalars only)")
    return text


def read_flat_yaml(path: str) -> Dict[str, Any]:
    """Parse one flat ``key: value`` YAML file (no ``_BASE_`` resolution)."""
    out: Dict[str, Any] = {}
    with open(path) as f:
        for n, raw in enumerate(f, 1):
            where = f"{path}:{n}"
            line = raw.rstrip("\n")
            if "#" in line:
                # a comment starts at '#' outside quotes
                quote = None
                for i, ch in enumerate(line):
                    if ch in "'\"":
                        quote = None if quote == ch else (quote or ch)
                    elif ch == "#" and quote is None:
                        line = line[:i]
                        break
            if not line.strip() or line.strip() == "---":
                continue
            if line[0] in " \t":
                raise ValueError(f"{where}: nested YAML is not supported")
            key, sep, value = line.partition(":")
            if not sep or not key.strip() or " " in key.strip():
                raise ValueError(f"{where}: expected 'key: value', got "
                                 f"{raw.rstrip()!r}")
            out[key.strip()] = _scalar(value.strip(), where)
    return out


def load_config(path: str) -> Config:
    """DEFAULTS, then the ``_BASE_`` chain, then the file itself; with the
    derived defaults the JAX package's ``finalize`` applies."""
    cfg = Config(DEFAULTS)
    cfg.update(load_yaml_with_base(path))
    return finalize(cfg)


def load_yaml_with_base(path: str) -> Dict[str, Any]:
    """A flat YAML file over its ``_BASE_`` chain (the JAX package's
    ``load_yaml_with_base`` on the flat subset)."""
    own = read_flat_yaml(path)
    base = own.pop(BASE_KEY, None)
    if base is None:
        return own
    if not os.path.isabs(base):
        cand = os.path.join(os.path.dirname(path), base)
        base = cand if os.path.exists(cand) else base
    merged = load_yaml_with_base(base)
    merged.update(own)
    return merged


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(msg)


def finalize(cfg: Config) -> Config:
    """The JAX package's ``finalize`` (reference opts.py:279-298): validity
    checks (raising ``ValueError``), the checkpoint path from the id, the
    box-feature widening (once) and the transformer-dims fallbacks
    (reference TransformerModel.py:1631-1640)."""
    _check(cfg.batch_size >= 0, "batch_size should be >= 0")
    _check(cfg.seq_per_img > 0, "seq_per_img should be >0")
    _check(cfg.beam_size > 0, "beam_size should be >0")
    _check(cfg.save_checkpoint_every > 0, "save_checkpoint_every should be >0")
    _check(cfg.losses_log_every > 0, "losses_log_every should be >0")
    _check(cfg.language_eval in (0, 1), "language_eval should be 0 or 1")
    _check(cfg.load_best_score in (0, 1), "load_best_score should be 0 or 1")
    if not cfg.get("checkpoint_path"):
        cfg.checkpoint_path = "log_%s" % cfg.id
    if cfg.get("use_box") and not cfg.get("att_feat_size_box_widened"):
        cfg.att_feat_size = cfg.att_feat_size + 5
        cfg.att_feat_size_box_widened = True
    if cfg.get("N_enc") is None:
        cfg.N_enc = cfg.num_layers
    if cfg.get("N_dec") is None:
        cfg.N_dec = cfg.num_layers
    if cfg.get("d_model") is None:
        cfg.d_model = cfg.input_encoding_size
    if cfg.get("d_ff") is None:
        cfg.d_ff = cfg.rnn_size
    return cfg


def restore_saved_opt(saved) -> dict:
    """A train-saved opt dict (``infos['opt']``) made ready to finalize
    again: train saves opts finalized, so ``att_feat_size`` is already
    widened for use_box checkpoints; mark it so ``finalize`` stays
    idempotent (the JAX package's ``restore_saved_opt``)."""
    saved = dict(saved or {})
    if saved.get("use_box") and "att_feat_size_box_widened" not in saved:
        saved["att_feat_size_box_widened"] = True
    return saved


def add_eval_options(parser: argparse.ArgumentParser) -> None:
    """The eval-only flags of the JAX package's ``add_eval_options``
    (reference opts.py:303-382), with the same defaults except
    ``--device``: ``cuda`` (the card), ``cpu`` for the plain path."""
    parser.add_argument("--batch_size", type=int, default=0)
    parser.add_argument("--num_images", type=int, default=-1)
    parser.add_argument("--language_eval", type=int, default=0)
    parser.add_argument("--dump_images", type=int, default=1)
    parser.add_argument("--dump_json", type=int, default=1)
    parser.add_argument("--dump_path", type=int, default=0)
    parser.add_argument("--image_folder", type=str, default="")
    parser.add_argument("--image_root", type=str, default="")
    parser.add_argument("--split", type=str, default="test")
    # None = the checkpoint's value: max_length sizes the length heads
    parser.add_argument("--max_length", type=int, default=None)
    parser.add_argument("--group_size", type=int, default=1)
    parser.add_argument("--diversity_lambda", type=float, default=0.5)
    parser.add_argument("--decoding_constraint", type=int, default=0)
    parser.add_argument("--block_trigrams", type=int, default=0)
    parser.add_argument("--suppress_UNK", type=int, default=1)
    parser.add_argument("--sample_n_method", type=str, default="sample")
    parser.add_argument("--eval_oracle", type=int, default=1)
    parser.add_argument("--verbose_loss", type=int, default=0)
    parser.add_argument("--input_json", type=str, default="")
    parser.add_argument("--input_label_h5", type=str, default="")
    parser.add_argument("--input_fc_dir", type=str, default="")
    parser.add_argument("--input_att_dir", type=str, default="")
    parser.add_argument("--input_box_dir", type=str, default="")
    parser.add_argument("--cnn_model", type=str, default="resnet101")
    parser.add_argument("--coco_json", type=str, default="")
    parser.add_argument("--KD_file", type=str, default="")
    # reference tools/eval.py:40-41 defaults the eval CLI to SAIC
    parser.add_argument("--inference_mode", type=str, default="SAIC")
    parser.add_argument("--pb_packed_width", type=int, default=0)
    parser.add_argument("--only_lang_eval", type=int, default=0)
    parser.add_argument("--force", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dump_attention", type=int, default=0)
    parser.add_argument("--report_flops", type=int, default=0)


def _mesh_shape(v: str):
    """--mesh_shape: an int ("8") or a dict literal ("{'data': 8}"), as the
    JAX package's opts.py:294-302 parses it."""
    import ast
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        raise argparse.ArgumentTypeError(
            f"--mesh_shape wants an int or a dict literal, got {v!r}")


# the training CLI's flags of the JAX package's opts.py (every DEFAULTS key)
# whose DEFAULTS value is None and so carries no type
_NONE_FLAG_TYPES = {"N_enc": int, "N_dec": int, "d_model": int, "d_ff": int,
                    "mesh_shape": _mesh_shape}


def _str2bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def _build_parser() -> argparse.ArgumentParser:
    """The training CLI's parser (the JAX package's ``_build_parser``):
    ``--cfg``, ``--set_cfgs`` and one flag per DEFAULTS key, each None
    unless given."""
    parser = argparse.ArgumentParser(description="BoFiCap trainer (PyTorch)",
                                     allow_abbrev=False)
    parser.add_argument("--cfg", type=str, default=None,
                        help="config yaml (supports _BASE_)")
    parser.add_argument("--set_cfgs", nargs=argparse.REMAINDER, default=None,
                        help="override config keys: --set_cfgs k1 v1 k2 v2")
    for name, default in DEFAULTS.items():
        flag = "--" + name
        if isinstance(default, bool):
            parser.add_argument(flag, type=_str2bool, nargs="?", const=True,
                                default=None)
        elif default is None:
            parser.add_argument(flag, type=_NONE_FLAG_TYPES.get(name, str),
                                default=None)
        else:
            parser.add_argument(flag, type=type(default), default=None)
    return parser


def merge_cli(cfg: Config, args: argparse.Namespace) -> Config:
    for k, v in vars(args).items():
        if k in ("cfg", "set_cfgs") or v is None:
            continue
        cfg[k] = v
    return cfg


def parse_opt(argv=None) -> Config:
    """The training CLI's options: DEFAULTS < ``--cfg`` file <
    ``--set_cfgs`` < explicit flags, finalized; ``device`` is ``cuda``
    unless one of them names another."""
    args = _build_parser().parse_args(argv)
    cfg = default_config()
    if args.cfg is not None:
        cfg.merge_from_dict(load_yaml_with_base(args.cfg))
    if args.set_cfgs:
        cfg.merge_from_list(args.set_cfgs)
    merge_cli(cfg, args)
    finalize(cfg)
    if not cfg.get("device"):
        cfg.device = "cuda"
    return cfg


def make_config(**fields) -> Config:
    """DEFAULTS overridden by ``fields``, finalized."""
    cfg = Config(DEFAULTS)
    cfg.update(fields)
    return finalize(cfg)
