"""Checkpoint files (the port of the params and infos half of the JAX
package's ``train/state.py``; parity with reference utils/misc.py:87-102
save_checkpoint and tools/train.py:62-78 resume).

Layout under ``<checkpoint_path>/``, as the JAX package writes it:

  model<app>.ckpt       the flax parameter tree, ``flax.serialization``'s
                        msgpack bytes (read and written here by
                        ``utils/flax_msgpack.py``, without flax)
  infos_<id><app>.pkl   a plain pickle: iter / epoch / loader state /
                        vocab / opt / best_val_score

``append`` in {'', 'best', '<iter>'} names the file as the reference does.
The optimizer file, the histories and ``TrainState`` come with training.

An infos pickle is read by ``safe_load``, which rebuilds only builtin
containers and scalars, ``collections.OrderedDict`` / ``defaultdict`` and
numpy arrays, scalars and dtypes; any other class (a ``boficap_tpu`` one
included) raises ``pickle.UnpicklingError``.
"""

from __future__ import annotations

import collections
import importlib
import os
import pickle
from typing import Any, Dict

from ..utils.flax_msgpack import msgpack_restore, msgpack_serialize

# builtins an infos pickle may name: data types only
_BUILTINS = frozenset({"dict", "list", "tuple", "set", "frozenset", "int",
                       "float", "complex", "str", "bytes", "bytearray",
                       "bool", "slice", "range"})
_ALLOWED = {("collections", "OrderedDict"): collections.OrderedDict,
            ("collections", "defaultdict"): collections.defaultdict}
# numpy's array, scalar and dtype reconstruction; numpy 2 pickles name
# numpy._core, numpy 1 numpy.core: either is read by whichever numpy is here
_NUMPY = {("multiarray", "_reconstruct"), ("multiarray", "scalar"),
          ("numeric", "_frombuffer")}


def _numpy_core(sub: str):
    for base in ("numpy._core", "numpy.core"):
        try:
            return importlib.import_module(f"{base}.{sub}")
        except ImportError:
            continue
    raise pickle.UnpicklingError(f"numpy has no core.{sub}")


class _SafeUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module in ("builtins", "__builtin__") and name in _BUILTINS:
            return getattr(__import__("builtins"), name)
        if (module, name) in _ALLOWED:
            return _ALLOWED[(module, name)]
        if module == "_codecs" and name == "encode":   # protocol-2 bytes
            return __import__("codecs").encode
        if module == "numpy" and name in ("ndarray", "dtype"):
            import numpy
            return getattr(numpy, name)
        for base in ("numpy._core.", "numpy.core."):
            if module.startswith(base) and (
                    module[len(base):], name) in _NUMPY:
                return getattr(_numpy_core(module[len(base):]), name)
        raise pickle.UnpicklingError(
            f"infos pickle names {module}.{name}, which is not a data type "
            f"the port reads")


def safe_load(f) -> Any:
    """``pickle.load`` restricted to data (see the module docstring)."""
    return _SafeUnpickler(f).load()


def _atomic_write(path: str, data: bytes) -> None:
    """Write-then-rename, so a failure mid-save never truncates a good
    checkpoint file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_checkpoint(cfg, params: Dict[str, Any], infos: Dict,
                    append: str = "") -> None:
    """Write ``model<app>.ckpt`` (``params``: the flax tree, e.g.
    ``convert.to_jax_tree(model)``) and ``infos_<id><app>.pkl`` under
    ``cfg.checkpoint_path``, as the JAX package's ``save_checkpoint`` does,
    so its ``load_params`` reads the model file."""
    app = ("_" + str(append)) if append else ""
    path = cfg.checkpoint_path
    os.makedirs(path, exist_ok=True)
    payloads = [(f"model{app}.ckpt", msgpack_serialize(params)),
                (f"infos_{cfg.id}{app}.pkl", pickle.dumps(infos))]
    for name, data in payloads:
        _atomic_write(os.path.join(path, name), data)


def load_params(path: str) -> Dict[str, Any]:
    """The flax tree of a ``model<app>.ckpt`` (nested dicts of numpy arrays,
    bfloat16 leaves as torch tensors)."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def load_infos(start_from: str, cfg_id: str, append: str = "") -> Dict:
    app = ("_" + str(append)) if append else ""
    with open(os.path.join(start_from, f"infos_{cfg_id}{app}.pkl"),
              "rb") as f:
        return safe_load(f)
