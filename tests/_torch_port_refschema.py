"""A state_dict in the original PyTorch reference's key schema
(captioning/models/TransformerModel.py), built from a flax parameter tree:
the input of the converters' tests (``torch_to_flax`` of both packages and
the convert CLIs), written to a ``.pth`` with ``torch.save``.  numpy and
torch only, so the card's smoke run can use it too."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_LINEARS = {"wq": "0", "wk": "1", "wv": "2", "wo": "3"}


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _decoder_names(train_mode: str) -> Dict[str, str]:
    if train_mode == "UIC_ds":
        return {"decoder0": "decoder_SA", "decoder1": "decoder_NA"}
    if train_mode == "UIC_s":
        return {"decoder0": "decoder_A", "decoder1": "decoder_SA",
                "decoder2": "decoder_NA"}
    return {"decoder0": "decoder"}


def _layer_key(rest, ffn: str) -> str:
    """A layer's flax sub-path -> the reference's key suffix."""
    if rest[0] in ("self_attn", "src_attn"):
        leaf = "weight" if rest[2] == "kernel" else "bias"
        return f"{rest[0]}.linears.{_LINEARS[rest[1]]}.{leaf}"
    if rest[0] == "ffn":
        j = int(rest[1].split("_")[1]) + 1
        return f"{ffn}.w_{j}.{'weight' if rest[2] == 'kernel' else 'bias'}"
    j = rest[0][len("sub"):]
    return f"sublayer.{j}.norm.{'a_2' if rest[2] == 'scale' else 'b_2'}"


def _linear_leaf(leaf: str) -> str:
    return "weight" if leaf == "kernel" else "bias"


def reference_state_dict(tree: Mapping[str, Any], train_mode: str,
                         use_bn: int = 0, seed: int = 0
                         ) -> Dict[str, torch.Tensor]:
    """The flax tree ``tree`` (``{"params": ...}``) as the reference's
    state_dict of ``train_mode``: Linear weights [out, in], the keys the
    converters ignore included (the sinusoid buffers, the predictor's
    unused template copies).  ``use_bn=1`` puts a BatchNorm1d with
    statistics from ``seed`` before att_embed's Linear, whose weights are
    the tree's: the converters then fold the two into one Dense."""
    params = tree.get("params", tree)
    dec = _decoder_names(train_mode)
    pb = train_mode == "PB_pad"
    rs = np.random.RandomState(seed)
    out: Dict[str, np.ndarray] = {}
    att = params["att_embed"]
    i = "0"
    if use_bn:
        n = att["kernel"].shape[0]
        out["att_embed.0.weight"] = rs.uniform(0.5, 1.5, n)
        out["att_embed.0.bias"] = rs.randn(n) * 0.1
        out["att_embed.0.running_mean"] = rs.randn(n) * 0.1
        out["att_embed.0.running_var"] = rs.uniform(0.5, 2.0, n)
        i = "1"
    out[f"att_embed.{i}.weight"] = np.asarray(att["kernel"]).T
    out[f"att_embed.{i}.bias"] = np.asarray(att["bias"])
    for path, v in _flatten(params):
        top, rest = path[0], path[1:]
        if top == "att_embed":
            continue
        if top == "encoder":
            if rest[0] == "RefLayerNorm_0":
                key = f"encoder.norm.{'a_2' if rest[1] == 'scale' else 'b_2'}"
            else:
                key = (f"encoder.layers.{rest[0][len('layer'):]}."
                       + _layer_key(rest[1:], "feed_forward"))
        elif top in dec:
            if rest[0] == "norm":
                key = f"{dec[top]}.norm.{'a_2' if rest[1] == 'scale' else 'b_2'}"
            else:
                key = (f"{dec[top]}.layers.{rest[0][len('layer'):]}."
                       + _layer_key(rest[1:], "feed_forward"))
        elif top == "word_embed":
            key = ("tgt_embed.0.lut.weight" if train_mode in ("AIC", "auto")
                   else "tgt_embed.lut.weight")
        elif top == "syn_embed":
            key = "syn_embed.lut.weight"
        elif top == "lp_word_embed":
            key = "length_predictor.word_embed.lut.weight"
        elif top == "generator":
            key = f"generator.proj.{_linear_leaf(rest[1])}"
        elif top.startswith("lp") and top[2:].isdigit():
            key = (f"length_predictor.LengthPredictor.{top[2:]}."
                   + _layer_key(rest, "ff"))
        elif top == "lp_norm":
            key = f"length_predictor.norm.{'a_2' if rest[0] == 'scale' else 'b_2'}"
        elif top.startswith(("len_head", "syn_head", "nn_len_l")):
            j = top[-1]
            if top.startswith("nn_len_l") or (pb and top.startswith("len")):
                name = f"L{j}"
            else:
                name = ("Length" if top.startswith("len") else
                        "Syntactic") + f"_classifier{j}"
            key = f"length_predictor.{name}.{_linear_leaf(rest[0])}"
        else:
            raise KeyError(f"no reference key for {'/'.join(path)}")
        out["model." + key] = v.T if path[-1] == "kernel" else v
    # keys the reference holds and the converters skip
    d = params["word_embed"]["Embed_0"]["embedding"].shape[1]
    out["model.pos_embed.pe"] = rs.randn(1, 64, d)
    if train_mode in ("AIC", "auto"):
        out["model.tgt_embed.1.pe"] = rs.randn(1, 64, d)
    if any(k.startswith("lp") and k[2:].isdigit() for k in params):
        out["model.length_predictor.length_attn.linears.0.weight"] = \
            rs.randn(d, d)
        out["model.length_predictor.ff.w_1.weight"] = rs.randn(2 * d, d)
        out["model.length_predictor.pos_embed.pe"] = rs.randn(1, 64, d)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
          for k, v in out.items()}
    if use_bn:
        sd["att_embed.0.num_batches_tracked"] = torch.tensor(7)
    return sd
