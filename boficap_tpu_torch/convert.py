"""Weight bridge: the JAX package's flax parameter tree and ``.ckpt`` files
-> the port's modules and back, and random initialisation from a seed.

The port's parameter names mirror the flax tree, so a flax leaf
``encoder/layer0/self_attn/wq/kernel`` is the port's
``encoder.layer0.self_attn.wq.weight``:

  * Dense ``kernel`` [in, out] -> ``weight`` [out, in] (transposed),
  * ``Embed_0/embedding`` -> ``Embed_0.weight``,
  * RefLayerNorm ``scale`` / ``bias`` and Dense ``bias`` map as they are.

``load_jax_checkpoint`` reads a ``model.ckpt`` the JAX package wrote
(``flax.serialization.to_bytes``, read by ``utils/flax_msgpack.py``);
``to_jax_tree`` is the inverse map, for writing one
(``train/state.py::save_checkpoint``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .config import Config
from .models.boficap import BoFiCap, build_model
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
    """Fill ``model`` (a BoFiCap, or any of the port's layer modules) from
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
    if isinstance(model, BoFiCap):
        model.invalidate_packed()
    return model


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
                device=None) -> BoFiCap:
    """A model with random weights made from ``seed`` (``fill_random``)."""
    return fill_random(build_model(cfg, vocab_size, device), seed)


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
    if isinstance(model, BoFiCap):
        model.invalidate_packed()
    return model
