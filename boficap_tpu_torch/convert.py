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
from typing import Any, Dict, Mapping

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


def flax_to_torch_name(path: str) -> str:
    parts = path.split("/")
    leaf = {"kernel": "weight", "embedding": "weight"}.get(parts[-1],
                                                           parts[-1])
    return ".".join(parts[:-1] + [leaf])


def load_jax_params(model: torch.nn.Module, tree: Mapping[str, Any]):
    """Fill ``model`` (a BoFiCap, or any of the port's layer modules) from
    the matching flax parameter tree given as nested dicts of numpy arrays
    (``{"params": {...}}`` or its inner dict).  Every parameter of the model
    must be present and every leaf used; shapes must agree."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    flat = _flatten(tree)
    params = dict(model.named_parameters())
    missing = set(params)
    with torch.no_grad():
        for path, value in flat.items():
            name = flax_to_torch_name(path)
            if name not in params:
                raise KeyError(f"flax leaf {path!r} has no port parameter "
                               f"{name!r}")
            if torch.is_tensor(value):                   # bfloat16 leaves
                value = value.float().numpy()
            arr = np.array(value, dtype=np.float32)       # a writable copy
            if path.endswith("/kernel"):
                arr = np.ascontiguousarray(arr.T)
            p = params[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{path}: shape {arr.shape} != port "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
            missing.discard(name)
    if missing:
        raise KeyError(f"flax tree lacks port parameters: {sorted(missing)}")
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


def to_jax_tree(model: torch.nn.Module) -> Dict[str, Any]:
    """The model's parameters as the JAX package's flax tree
    (``{"params": {...}}`` of float32 numpy arrays), the inverse of
    ``load_jax_params``: a Dense ``weight`` [out, in] becomes ``kernel``
    [in, out], an Embed ``weight`` becomes ``embedding``."""
    root: Dict[str, Any] = {}
    for mod_name, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            arr = p.detach().float().cpu().numpy()
            if isinstance(mod, Dense) and leaf == "weight":
                leaf, arr = "kernel", arr.T
            elif isinstance(mod, Embed) and leaf == "weight":
                leaf = "embedding"
            node = root
            for part in mod_name.split(".") if mod_name else []:
                node = node.setdefault(part, {})
            node[leaf] = np.ascontiguousarray(arr)
    return {"params": root}


def init_params(cfg: Config, vocab_size: int, seed: int = 0,
                device=None) -> BoFiCap:
    """A model with random weights made from ``seed`` by a CPU
    ``torch.Generator`` (so the weights do not depend on the device), in
    the flax initialisers' law: Xavier-uniform matrices and tables, zero
    biases, unit norm scales."""
    model = build_model(cfg, vocab_size, device)
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
    model.invalidate_packed()
    return model
