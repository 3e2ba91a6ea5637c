"""The port's native CIDEr-D scorer (``ciderd.cpp``, a plain C interface
loaded with ``ctypes``).

``get_ciderd()`` returns the loaded scorer, building it at first use with
``g++ -O3 -std=c++17 -shared -fPIC`` into ``boficap_tpu_torch/_build/
native/`` through the kernels' build helpers (``ops/_build.py``: a name
keyed by a hash of the source and flags, a per-process temporary file
moved into place with ``os.replace``).  A failed build raises
``RuntimeError`` with the compiler's output: there is no quiet fallback
(callers that want the Python scorer say so,
``rewards.init_scorer(use_native=False)``).
"""

from __future__ import annotations

import ctypes
import shutil
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..ops import _build

SOURCE = Path(__file__).resolve().parent / "ciderd.cpp"
BUILD_DIR = _build.BUILD_ROOT / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
SIGNATURES = {
    "bfc_ciderd_set_df": ([_P, _P, _I, _P, _D], _I),
    "bfc_ciderd_clear_df": ([], _I),
    "bfc_ciderd_score": ([_P, _P, _I, _P, _P, _P, _P], _I),
    "bfc_ciderd_score_ids": ([_P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P,
                              _P], _I),
    "bfc_ciderd_error": ([_I], ctypes.c_char_p),
}


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile ``ciderd.cpp`` into ``build_dir`` (``BUILD_DIR`` by default)
    unless the library for its hash exists; returns the library's path.
    Raises RuntimeError when no compiler is found or the compile fails."""
    build_dir = BUILD_DIR if build_dir is None else build_dir
    out = build_dir / f"libciderd-{_build.digest(CXX_FLAGS, [SOURCE])}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native CIDEr-D scorer is "
                           "built from source at first use")
    build_dir.mkdir(parents=True, exist_ok=True)
    log, failed = _build.compile_all(cxx, CXX_FLAGS, {out: SOURCE})
    if failed:
        raise RuntimeError(f"g++ failed for {SOURCE.name}: "
                           f"{log.strip()[-2000:]}")
    return out


def _offsets(strings: Sequence[str]):
    """UTF-8 bytes of the strings end to end, and their int64 offsets."""
    blobs = [s.encode("utf-8") for s in strings]
    off = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=off[1:])
    return b"".join(blobs), off


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _int32_array(a, ndim: int, what: str) -> np.ndarray:
    a = np.asarray(a)
    if a.ndim != ndim:
        raise ValueError(f"{what} must be {ndim}-d, got {a.ndim}-d")
    if a.dtype != np.int32:
        raise ValueError(f"{what} must be int32, got {a.dtype}")
    return np.ascontiguousarray(a)


class NativeCiderD:
    """The loaded library: the JAX package's ``_ciderd`` module interface
    (``set_df``, ``clear_df``, ``score``, ``score_ids``) over ctypes."""

    def __init__(self, path: Path):
        self.lib = _build.bind(path, SIGNATURES)

    def _check(self, err: int, what: str) -> None:
        if err != 0:
            raise ValueError(
                f"{what}: {self.lib.bfc_ciderd_error(err).decode()}")

    def set_df(self, keys: List[str], vals: List[float],
               ref_len: float) -> None:
        """Install a cached document-frequency table (each key a
        space-joined n-gram); ``ref_len`` = the number of corpus images."""
        if not isinstance(keys, list) or not isinstance(vals, list):
            raise TypeError("keys and vals must be lists")
        if len(keys) != len(vals):
            raise ValueError("keys and vals length mismatch")
        blob, off = _offsets(keys)
        v = np.asarray(vals, np.float64)
        self._check(self.lib.bfc_ciderd_set_df(blob, _ptr(off), len(keys),
                                               _ptr(v), float(ref_len)),
                    "set_df")

    def clear_df(self) -> None:
        self._check(self.lib.bfc_ciderd_clear_df(), "clear_df")

    def score(self, cands: List[str], refs: List[List[str]]) -> List[float]:
        """CIDEr-D of each candidate string against its references; with
        no table installed, the df comes from this call's references."""
        if not isinstance(cands, list) or not isinstance(refs, list):
            raise TypeError("cands and refs must be lists")
        if len(cands) != len(refs):
            raise ValueError("cands and refs length mismatch")
        for r in refs:
            if not isinstance(r, list):
                raise TypeError("refs[i] must be a list")
        cblob, coff = _offsets(cands)
        flat = [s for r in refs for s in r]
        rblob, roff = _offsets(flat)
        refs_of = np.zeros(len(refs) + 1, np.int64)
        np.cumsum([len(r) for r in refs], out=refs_of[1:])
        out = np.zeros(len(cands), np.float64)
        self._check(self.lib.bfc_ciderd_score(
            cblob, _ptr(coff), len(cands), rblob, _ptr(roff), _ptr(refs_of),
            _ptr(out)), "score")
        return out.tolist()

    def score_ids(self, cands, cand_width, refs, ref_counts, ref_width,
                  img_idx) -> List[float]:
        """The same scores from int32 id arrays: cands [N, Lc], cand_width
        [N], refs [M, R, Lr], ref_counts [M], ref_width [M], img_idx [N]
        (see ``ciderd.cpp``)."""
        cands = _int32_array(cands, 2, "cands")
        cw = _int32_array(cand_width, 1, "cand_width")
        refs = _int32_array(refs, 3, "refs")
        rc = _int32_array(ref_counts, 1, "ref_counts")
        rw = _int32_array(ref_width, 1, "ref_width")
        idx = _int32_array(img_idx, 1, "img_idx")
        N, Lc = cands.shape
        M, R, Lr = refs.shape
        if cw.shape[0] != N or idx.shape[0] != N or rc.shape[0] != M \
                or rw.shape[0] != M:
            raise ValueError("score_ids shape mismatch")
        out = np.zeros(N, np.float64)
        self._check(self.lib.bfc_ciderd_score_ids(
            _ptr(cands), N, Lc, _ptr(cw), _ptr(refs), M, R, Lr, _ptr(rc),
            _ptr(rw), _ptr(idx), _ptr(out)), "score_ids")
        return out.tolist()


def _load() -> NativeCiderD:
    return NativeCiderD(build())


def get_ciderd() -> NativeCiderD:
    """Build (at first use) and load the native scorer, once per process;
    raises RuntimeError if it does not build."""
    return _scorer()


_scorer = _build.load_once(_load)
