"""Feature-store readers (the port's copy of the JAX package's
``data/readers.py``; parity with the reference ``HybridLoader``,
captioning/data/dataloader.py:24-86): a directory of ``.npz``/``.npy``
files, an h5 file, an lmdb database, or a ``.pth`` dict — behind one
``get(key) -> np.ndarray`` interface, with an optional in-memory cache
of decoded arrays (the reference caches compressed bytes; decoded caching
also skips the per-access npz parse).

Host-side, numpy only: batches are padded to static shapes by the collate
and copied to the card once per step.  The optional stores import their
packages (``lmdbdict``, ``h5py``, ``torch`` for ``.pth``) when opened.
"""

from __future__ import annotations

import io
import os
from typing import Dict

import numpy as np

__all__ = ["FeatureReader", "SyntheticFeatures"]


class FeatureReader:
    """db_path semantics (reference dataloader.py:32-55):

      * endswith '.lmdb'  -> lmdb database of serialized arrays
      * endswith '.pth'   -> torch-saved dict {key: array}
      * endswith '.h5'    -> h5 file with one dataset per key
      * otherwise         -> directory of '<key><ext>' files
    """

    def __init__(self, db_path: str, ext: str = ".npz",
                 in_memory: bool = False):
        self.db_path = db_path
        self.ext = ext
        self.in_memory = in_memory
        self._cache: Dict[str, np.ndarray] = {}
        if db_path.endswith(".lmdb"):
            self.db_type = "lmdb"
            try:
                from lmdbdict import lmdbdict  # optional dependency
                from lmdbdict.methods import DUMPS_FUNC, LOADS_FUNC
                self.lmdb = lmdbdict(db_path, unsafe=True)
                self.lmdb._key_dumps = DUMPS_FUNC["ascii"]
                self.lmdb._value_loads = LOADS_FUNC["identity"]
            except ImportError as e:  # pragma: no cover - env without lmdb
                raise ImportError(
                    "lmdb feature stores need the 'lmdbdict' package") from e
        elif db_path.endswith(".pth"):
            self.db_type = "pth"
            import torch
            self.feat_file = torch.load(db_path, map_location="cpu")
            self.loader = lambda x: np.asarray(x["feat"])
        elif db_path.endswith(".h5"):
            self.db_type = "h5"
            import h5py
            self.feat_file = h5py.File(db_path, "r")
        else:
            self.db_type = "dir"

    def _decode(self, byte_str: bytes) -> np.ndarray:
        buf = io.BytesIO(byte_str)
        if self.ext == ".npy":
            return np.load(buf)
        return np.load(buf)["feat"]

    def get(self, key: str) -> np.ndarray:
        # in_memory caches the DECODED array (the reference caches compressed
        # bytes, dataloader.py:60-67, and re-inflates per access; decoded
        # caching also skips the per-access npz parse, which dominated read
        # time on the synthetic corpus).  dict get/set are GIL-atomic, so the
        # cache is safe under the prefetch thread.
        if self.in_memory:
            arr = self._cache.get(key)
            if arr is not None:
                return arr
        if self.db_type == "lmdb":
            arr = self._decode(self.lmdb[key])
        elif self.db_type == "pth":
            arr = self.loader(self.feat_file[key])
        elif self.db_type == "h5":
            arr = np.asarray(self.feat_file[key]).astype(np.float32)
        else:  # directory
            path = os.path.join(self.db_path, key + self.ext)
            with open(path, "rb") as f:
                arr = self._decode(f.read())
        if self.in_memory:
            # Cached arrays are shared across accesses: freeze them so an
            # accidental in-place mutation raises instead of corrupting
            # features for the rest of the run.
            arr.setflags(write=False)
            self._cache[key] = arr
        return arr


class SyntheticFeatures:
    """Deterministic random region features keyed by id — the fake-device
    feature store for tests and benchmarks (the reference has no test
    fixtures at all; see SURVEY.md §4)."""

    def __init__(self, n_regions: int = 36, dim: int = 2048,
                 variable_regions: bool = False):
        self.n_regions = n_regions
        self.dim = dim
        self.variable_regions = variable_regions

    def get(self, key: str) -> np.ndarray:
        # zlib.crc32, NOT hash(): python string hashing is randomized per
        # process (PYTHONHASHSEED), which would give every process/run
        # different "features" — multihost training requires every host to
        # assemble identical batches (tools/train.py, tests/test_multihost)
        import zlib
        rng = np.random.RandomState(zlib.crc32(str(key).encode()))
        k = self.n_regions
        if self.variable_regions:
            k = rng.randint(max(1, self.n_regions // 2), self.n_regions + 1)
        return rng.randn(k, self.dim).astype(np.float32)
