"""Weight bridge: the JAX package's flax parameter tree and ``.ckpt`` files
-> the port's modules and back, and random initialisation from a seed.

The port's parameter names mirror the flax tree, so a flax leaf
``encoder/layer0/self_attn/wq/kernel`` is the port's
``encoder.layer0.self_attn.wq.weight``:

  * Dense ``kernel`` [in, out] -> ``weight`` [out, in] (transposed),
  * ``Embed_0/embedding`` -> ``Embed_0.weight``,
  * RefLayerNorm and LayerNorm ``scale`` / ``bias`` and Dense ``bias`` map
    as they are.

The LSTM captioners' trees map the same way (``core/cell/if/kernel`` is
``core.cell.if.weight``), so ``load_jax_params``, ``to_jax_tree`` and
``init_params`` take any model ``models.setup`` builds.

``load_jax_checkpoint`` reads a ``model.ckpt`` the JAX package wrote
(``flax.serialization.to_bytes``, read by ``utils/flax_msgpack.py``);
``to_jax_tree`` is the inverse map, for writing one
(``train/state.py::save_checkpoint``).

The original PyTorch reference's ``model.pth`` (the port of the JAX
package's ``utils/convert.py``): ``torch_to_flax`` maps its
``TransformerModel`` state_dict onto the flax tree, every key consumed and
an unknown one raising ``KeyError``; ``load_reference_checkpoint`` reads
the file (``weights_only``); ``load_jax_params`` fills a model from the
tree.  Key schema (reference captioning/models/TransformerModel.py):

  att_embed.{0|1}.*                     -> att_embed (use_bn=1's leading
                                           BatchNorm1d folds into the Dense
                                           exactly at inference; use_bn=2's
                                           trailing BN sits after the ReLU,
                                           cannot fold -> rejected)
  model.encoder.layers.{i}.self_attn.linears.{0..3} -> encoder/layer{i}/self_attn/{wq,wk,wv,wo}
  model.encoder.layers.{i}.feed_forward.w_{1,2}     -> .../ffn/Dense_{0,1}
  model.encoder.layers.{i}.sublayer.{j}.norm.{a_2,b_2} -> .../sub{j}/norm/{scale,bias}
  model.encoder.norm.*                  -> encoder/RefLayerNorm_0
  model.decoder[_A|_SA|_NA].*           -> decoder{stack}/* per train_mode
  model.{tgt,word}_embed.lut.weight     -> word_embed/Embed_0/embedding
  model.syn_embed.lut.weight            -> syn_embed/Embed_0/embedding
  model.generator.proj.*                -> generator/proj
  model.length_predictor.LengthPredictor.{i}.* -> lp{i}/*
  model.length_predictor.norm.*         -> lp_norm
  model.length_predictor.{Length,Syntactic}_classifier{1,2} -> {len,syn}_head{1,2}
  model.length_predictor.L{1,2}.*       -> nn_len_l{1,2} (NNAIC), len_head{1,2}
                                           (PB_pad)
  model.length_predictor.word_embed.lut.weight -> lp_word_embed (PB_pad)
Ignored: pos_embed.pe and tgt_embed.1.pe (sinusoids, recomputed),
length_predictor.{length_attn,ff,pos_embed} (template copies the reference
builds and never calls when N_len >= 1, and its sinusoids).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .config import Config
from .models import setup
from .models.layers import Dense, Embed
from .utils.flax_msgpack import msgpack_restore


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def load_jax_params(model: torch.nn.Module, tree: Mapping[str, Any]):
    """Fill ``model`` (any model ``models.setup`` builds, or any of the
    port's layer modules) from
    the matching flax parameter tree given as nested dicts of numpy arrays
    (``{"params": {...}}`` or its inner dict).  Every parameter of the model
    must be present and every leaf used; shapes must agree."""
    params = dict(model.named_parameters())
    arrays = named_from_tree(tree, flax_layout(model))
    with torch.no_grad():
        for name, arr in arrays.items():
            p = params[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} != port "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
    _invalidate(model)
    return model


def _invalidate(model) -> None:
    """Drop a model's packed kernel weights after its parameters were
    written in place (a layer module has none)."""
    if hasattr(model, "invalidate_packed"):
        model.invalidate_packed()


def load_jax_checkpoint(path: str, model: torch.nn.Module):
    """Fill ``model`` from a ``model<app>.ckpt`` file the JAX package wrote
    (``train/state.py::save_checkpoint``); ``load_jax_params`` on the
    file's tree."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    return load_jax_params(model, tree)


def flax_layout(model: torch.nn.Module) -> Dict[str, Tuple[Tuple[str, ...],
                                                              bool]]:
    """Each parameter's place in the JAX package's flax tree: port name ->
    (path under ``params``, whether the flax leaf is the transpose).  A
    Dense ``weight`` [out, in] is the flax ``kernel`` [in, out]; an Embed
    ``weight`` is ``embedding``."""
    out = {}
    for mod_name, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            flax_leaf, transposed = leaf, False
            if isinstance(mod, Dense) and leaf == "weight":
                flax_leaf, transposed = "kernel", True
            elif isinstance(mod, Embed) and leaf == "weight":
                flax_leaf = "embedding"
            parts = tuple(mod_name.split(".")) if mod_name else ()
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            out[name] = (parts + (flax_leaf,), transposed)
    return out


def tree_from_named(named: Mapping[str, torch.Tensor], layout
                    ) -> Dict[str, Any]:
    """Tensors keyed by port parameter name (the parameters, or an
    optimizer's moments of them) -> the flax tree ``{"params": {...}}`` of
    float32 numpy arrays, laid out as ``layout`` (``flax_layout``) says."""
    root: Dict[str, Any] = {}
    for name, t in named.items():
        path, transposed = layout[name]
        arr = t.detach().float().cpu().numpy()
        node = root
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(arr.T if transposed else arr)
    return {"params": root}


def named_from_tree(tree: Mapping[str, Any], layout) -> Dict[str, np.ndarray]:
    """The inverse of ``tree_from_named``: float32 numpy arrays in the port's
    layout, by parameter name.  Every parameter must be present and every
    leaf used."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    flat = {tuple(k.split("/")): v for k, v in _flatten(tree).items()}
    out = {}
    for name, (path, transposed) in layout.items():
        if path not in flat:
            raise KeyError(f"flax tree lacks {'/'.join(path)!r} (port "
                           f"{name!r})")
        v = flat.pop(path)
        if torch.is_tensor(v):                         # bfloat16 leaves
            v = v.float().numpy()
        arr = np.array(v, dtype=np.float32)
        out[name] = np.ascontiguousarray(arr.T) if transposed else arr
    if flat:
        raise KeyError(f"flax leaves {sorted('/'.join(k) for k in flat)[:5]}"
                       f" have no port parameter")
    return out


def to_jax_tree(model: torch.nn.Module) -> Dict[str, Any]:
    """The model's parameters as the JAX package's flax tree
    (``{"params": {...}}`` of float32 numpy arrays), the inverse of
    ``load_jax_params``."""
    return tree_from_named(dict(model.named_parameters()),
                           flax_layout(model))


def init_params(cfg: Config, vocab_size: int, seed: int = 0,
                device=None) -> torch.nn.Module:
    """The model the config names (``models.setup``) with random weights
    made from ``seed`` (``fill_random``)."""
    return fill_random(setup(cfg, vocab_size, device), seed)


def fill_random(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Fill ``model``'s parameters from ``seed`` by a CPU ``torch.Generator``
    (so the weights do not depend on the device), in the flax
    initialisers' law: Xavier-uniform matrices and tables, zero biases,
    unit norm scales."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf == "bias":
                p.zero_()
            else:
                bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                w = torch.rand(p.shape, generator=gen) * (2 * bound) - bound
                p.copy_(w)
    _invalidate(model)
    return model


# ---------------------------------------------------------------------------
# the original reference's model.pth
# ---------------------------------------------------------------------------

LINEAR_NAMES = {"0": "wq", "1": "wk", "2": "wv", "3": "wo"}


def _decoder_map(train_mode: str) -> Dict[str, str]:
    """The reference's decoder attributes -> the flax decoder stacks."""
    if train_mode == "UIC_ds":
        return {"decoder_SA": "decoder0", "decoder_NA": "decoder1"}
    if train_mode == "UIC_s":
        return {"decoder_A": "decoder0", "decoder_SA": "decoder1",
                "decoder_NA": "decoder2"}
    return {"decoder": "decoder0"}


def _set(tree: Dict, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value)


def _layer_subkeys(rest: str):
    """One encoder / decoder / predictor layer key suffix -> (flax
    sub-path, whether the value is transposed)."""
    m = re.match(r"(self_attn|src_attn)\.linears\.(\d)\.(weight|bias)", rest)
    if m:
        attn, j, wb = m.groups()
        return ((attn, LINEAR_NAMES[j], "kernel" if wb == "weight" else
                 "bias"), wb == "weight")
    # feed_forward: the encoder and decoder layers; ff: the predictor's
    m = re.match(r"(?:feed_forward|ff)\.w_(\d)\.(weight|bias)", rest)
    if m:
        j, wb = m.groups()
        return (("ffn", f"Dense_{int(j) - 1}",
                 "kernel" if wb == "weight" else "bias"), wb == "weight")
    m = re.match(r"sublayer\.(\d)\.norm\.(a_2|b_2)", rest)
    if m:
        j, ab = m.groups()
        return ((f"sub{j}", "norm", "scale" if ab == "a_2" else "bias"),
                False)
    raise KeyError(rest)


def _to_np(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") else \
        np.asarray(v)


def _convert_att_embed(state_dict: Mapping[str, Any], p: Dict) -> set:
    """The att_embed Sequential onto the one flax Dense; returns the keys
    it consumed.  Reference layouts (TransformerModel.py:1642-1647):

      use_bn=0: (Linear, ReLU, Dropout)          -> Linear at 0
      use_bn=1: (BN, Linear, ReLU, Dropout)      -> BN at 0, Linear at 1
      use_bn=2: (BN, Linear, ReLU, Dropout, BN)  -> and a BN at 4

    The leading eval-mode BatchNorm1d is affine and folds into the Linear
    exactly: W' = W diag(g/sigma), b' = b + W (beta - mu g/sigma).  The
    trailing BN of use_bn=2 follows the ReLU and folds into nothing this
    model has: NotImplementedError."""
    keys = {k for k in state_dict if k.startswith("att_embed.")}
    if not keys:
        raise KeyError("state_dict has no att_embed.* keys (truncated or "
                       "non-TransformerModel checkpoint?)")
    if any(k.startswith("att_embed.4.") for k in keys):
        raise NotImplementedError(
            "use_bn=2 checkpoints (trailing BatchNorm after att_embed's "
            "ReLU, TransformerModel.py:1647) have no folding into this "
            "model's single att_embed Dense; retrain or export without it")
    if "att_embed.1.weight" in keys:                 # use_bn=1: BN + Linear
        g = _to_np(state_dict["att_embed.0.weight"])
        beta = _to_np(state_dict["att_embed.0.bias"])
        mu = _to_np(state_dict["att_embed.0.running_mean"])
        var = _to_np(state_dict["att_embed.0.running_var"])
        w = _to_np(state_dict["att_embed.1.weight"])     # [out, in]
        b = _to_np(state_dict["att_embed.1.bias"])
        scale = g / np.sqrt(var + 1e-5)                  # BatchNorm1d eps
        _set(p, ("att_embed", "kernel"), (w * scale[None, :]).T)
        _set(p, ("att_embed", "bias"), b + w @ (beta - mu * scale))
        extra = keys - {"att_embed.0.weight", "att_embed.0.bias",
                        "att_embed.0.running_mean", "att_embed.0.running_var",
                        "att_embed.0.num_batches_tracked",
                        "att_embed.1.weight", "att_embed.1.bias"}
    else:                                            # use_bn=0: a Linear
        w = _to_np(state_dict["att_embed.0.weight"])
        _set(p, ("att_embed", "kernel"), w.T)
        _set(p, ("att_embed", "bias"), _to_np(state_dict["att_embed.0.bias"]))
        extra = keys - {"att_embed.0.weight", "att_embed.0.bias"}
    if extra:
        raise KeyError(f"unmapped att_embed keys: {sorted(extra)}")
    return keys


def _kernel_or_bias(wb: str, v):
    """A Linear's weight (transposed to the flax kernel) or bias."""
    return ("kernel", v.T) if wb == "weight" else ("bias", v)


def torch_to_flax(state_dict: Mapping[str, Any], train_mode: str) -> Dict:
    """A reference state_dict (tensors or numpy arrays) -> ``{"params":
    ...}``, the flax tree the JAX package and ``load_jax_params`` read.
    Every key must be consumed: an unknown one raises ``KeyError``."""
    p: Dict[str, Any] = {}
    dmap = _decoder_map(train_mode)
    att_consumed = _convert_att_embed(state_dict, p)
    for key, val in state_dict.items():
        if key in att_consumed:
            continue
        v = _to_np(val)
        if not key.startswith("model."):
            raise KeyError(f"unmapped reference key: {key}")
        k = key[len("model."):]
        if k.startswith("pos_embed.") or re.match(r"tgt_embed\.1\.pe", k):
            continue                                   # sinusoids
        if re.match(r"(tgt_embed|word_embed)(?:\.0)?\.lut\.weight", k):
            # AIC wraps Embeddings + PositionalEncoding in a Sequential
            # (tgt_embed.0.lut, tgt_embed.1.pe); the phrase modes keep them
            # apart (tgt_embed.lut, pos_embed.pe)
            _set(p, ("word_embed", "Embed_0", "embedding"), v)
            continue
        if k == "syn_embed.lut.weight":
            _set(p, ("syn_embed", "Embed_0", "embedding"), v)
            continue
        m = re.match(r"generator\.proj\.(weight|bias)", k)
        if m:
            leaf, val_ = _kernel_or_bias(m.group(1), v)
            _set(p, ("generator", "proj", leaf), val_)
            continue
        m = re.match(r"encoder\.layers\.(\d+)\.(.*)", k)
        if m:
            i, rest = m.groups()
            path, tr = _layer_subkeys(rest)
            _set(p, ("encoder", f"layer{i}") + path, v.T if tr else v)
            continue
        m = re.match(r"encoder\.norm\.(a_2|b_2)", k)
        if m:
            _set(p, ("encoder", "RefLayerNorm_0",
                     "scale" if m.group(1) == "a_2" else "bias"), v)
            continue
        m = re.match(r"(decoder(?:_A|_SA|_NA)?)\.layers\.(\d+)\.(.*)", k)
        if m:
            dname, i, rest = m.groups()
            path, tr = _layer_subkeys(rest)
            _set(p, (dmap[dname], f"layer{i}") + path, v.T if tr else v)
            continue
        m = re.match(r"(decoder(?:_A|_SA|_NA)?)\.norm\.(a_2|b_2)", k)
        if m:
            dname, ab = m.groups()
            _set(p, (dmap[dname], "norm",
                     "scale" if ab == "a_2" else "bias"), v)
            continue
        m = re.match(r"length_predictor\.LengthPredictor\.(\d+)\.(.*)", k)
        if m:
            i, rest = m.groups()
            path, tr = _layer_subkeys(rest)
            _set(p, (f"lp{i}",) + path, v.T if tr else v)
            continue
        m = re.match(r"length_predictor\.norm\.(a_2|b_2)", k)
        if m:
            _set(p, ("lp_norm",
                     "scale" if m.group(1) == "a_2" else "bias"), v)
            continue
        m = re.match(r"length_predictor\.(Length|Syntactic)_classifier(\d)"
                     r"\.(weight|bias)", k)
        if m:
            head, j, wb = m.groups()
            name = ("len_head" if head == "Length" else "syn_head") + j
            leaf, val_ = _kernel_or_bias(wb, v)
            _set(p, (name, leaf), val_)
            continue
        m = re.match(r"length_predictor\.L(\d)\.(weight|bias)", k)
        if m:
            # PB_pad's per-slot length MLP (LengthPredictorPB_pad.L1/L2,
            # TransformerModel.py:1047-1048: the d->100->20 shape of the
            # Length_classifier pair, so the len_head slots); NNAIC's
            # whole-caption head keeps nn_len_l{1,2}
            j, wb = m.groups()
            name = (f"len_head{j}" if train_mode == "PB_pad"
                    else f"nn_len_l{j}")
            leaf, val_ = _kernel_or_bias(wb, v)
            _set(p, (name, leaf), val_)
            continue
        if k == "length_predictor.word_embed.lut.weight":
            # the PB predictor's private table (TransformerModel.py:1040)
            _set(p, ("lp_word_embed", "Embed_0", "embedding"), v)
            continue
        if re.match(r"length_predictor\.(length_attn|ff|pos_embed)\.", k):
            continue        # unused template copies (N_len >= 1), sinusoids
        raise KeyError(f"unmapped reference key: {key}")
    return {"params": p}


def load_reference_checkpoint(path: str, train_mode: str) -> Dict:
    """A reference ``model.pth`` (a state_dict saved by ``torch.save``) ->
    the flax tree (``torch_to_flax``); read with ``weights_only``, so a
    file holding anything but tensors and containers raises."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return torch_to_flax(sd, train_mode)
