"""Probe the CUDA toolchain and build the port's kernels.

The kernels are CUDA C++ sources under ``boficap_tpu_torch/csrc/``, each
with a plain C interface.  At first use every ``*.cu`` is compiled by its
own ``nvcc`` process (all started together) into a shared library for
``sm_90a``, loaded with ``ctypes``; PyTorch's headers are never included,
so a build takes seconds.  Libraries land in ``boficap_tpu_torch/_build/
<hash>/``, keyed by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one is reused.  A failed build raises with
nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)

# the entry points of each kernel library (one per csrc/*.cu): argument
# types and return type; the layer and stack entries take a pointer to
# their argument struct (ops/decoder_layer.py, ops/stack.py and
# ops/attention.py mirror it), the encoder and decoder stacks also the layer
# count (the decoder stack's scratch too: it holds every layer's cross
# K|V), the window layer's parts entry also its parts mask
# (ops/window_parts.py); bfc_gemm runs one product of the layer kernels
# alone, bfc_refnorm one norm
SIGNATURES = {
    "attention_core": {
        "bfc_attention_core": ([_I, _I, _P, _P], _I),
        "bfc_attention_core_scratch": ([_I, _I, _I, _I], _L),
        "bfc_attention_path": ([_I, _I, _I], _I),
        "bfc_attention_core_args_size": ([], _I),
        "bfc_error_string": ([_I], ctypes.c_char_p),
    },
    "encoder_layer": {
        "bfc_encoder_layer": ([_I, _I, _P, _P], _I),
        "bfc_encoder_layer_scratch": ([_I, _I, _I, _I], _L),
        "bfc_encoder_stack": ([_I, _I, _P, _I, _P], _I),
        "bfc_encoder_stack_scratch": ([_I, _I, _I, _I], _L),
        "bfc_encoder_layer_args_size": ([], _I),
        "bfc_error_string": ([_I], ctypes.c_char_p),
    },
    "decoder_layer": {
        "bfc_decoder_layer": ([_I, _I, _P, _P], _I),
        "bfc_decoder_layer_scratch": ([_I, _I, _I, _I, _I], _L),
        "bfc_decoder_stack": ([_I, _I, _P, _I, _P], _I),
        "bfc_decoder_stack_scratch": ([_I, _I, _I, _I, _I, _I], _L),
        "bfc_decoder_layer_args_size": ([], _I),
        "bfc_gemm": ([_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "bfc_gemm_tile": ([_I, _I, _I, _IP, _IP], _I),
        "bfc_refnorm": ([_I, _I, _P, _P, _P, _P, _I, _I, _P], _I),
        "bfc_error_string": ([_I], ctypes.c_char_p),
    },
    "greedy_head": {
        "bfc_greedy_head": ([_I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                             _P, _P, _P, _P], _I),
        "bfc_greedy_head_scratch": ([_I, _I], _L),
        "bfc_error_string": ([_I], ctypes.c_char_p),
    },
    "window_layer": {
        "bfc_window_layer": ([_I, _I, _P, _P], _I),
        "bfc_window_layer_scratch": ([_I, _I, _I, _I], _L),
        "bfc_window_layer_args_size": ([], _I),
        "bfc_error_string": ([_I], ctypes.c_char_p),
    },
    "window_parts": {
        "bfc_window_layer_parts": ([_I, _I, _P, _I, _P], _I),
        "bfc_window_layer_hb": ([_I, _I, _P, _P], _I),
        "bfc_window_parts_scratch": ([_I, _I, _I, _I], _L),
        "bfc_window_hb_smem": ([_I, _I, _I, _I], _L),
        "bfc_window_parts_tile": ([_I, _I, _I, _IP, _IP], _I),
        "bfc_window_parts_args_size": ([], _I),
        "bfc_error_string": ([_I], ctypes.c_char_p),
    },
    "window_stack": {
        "bfc_window_stack": ([_I, _I, _P, _P], _I),
        "bfc_window_wide_stack": ([_I, _I, _P, _P], _I),
        "bfc_window_stack_scratch": ([_I, _I, _I, _I], _L),
        "bfc_window_stack_args_size": ([], _I),
        "bfc_error_string": ([_I], ctypes.c_char_p),
    },
}


def find_nvcc() -> Optional[str]:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    return shutil.which("nvcc")


def probe() -> Dict[str, object]:
    """What this machine offers for the kernels: CUDA, the card, nvcc."""
    import torch
    out: Dict[str, object] = {"cuda": torch.cuda.is_available(),
                              "torch": torch.__version__,
                              "torch_cuda": torch.version.cuda}
    if out["cuda"]:
        out["device"] = torch.cuda.get_device_name(0)
        out["capability"] = list(torch.cuda.get_device_capability(0))
    nvcc = find_nvcc()
    out["nvcc"] = nvcc
    if nvcc:
        ver = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        out["nvcc_version"] = ver[-1] if ver else ""
    return out


def digest(flags, sources) -> str:
    """A hash of the compiler flags and of each source's name and bytes:
    the name of a build, so that a changed source or flag rebuilds."""
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def source_hash() -> str:
    return digest(NVCC_FLAGS, sorted(CSRC.glob("*.cu*")))


def compile_all(compiler: str, flags, jobs: Dict[Path, Path]):
    """Compile each source ``jobs[lib]`` into the library ``lib``, one
    compiler process each, all started together.  Each writes a
    per-process temporary file that ``os.replace`` moves into place, so a
    reader never loads a half-written library.  Returns (the compilers'
    output, the names of the sources that failed)."""
    procs = {}
    for lib, src in jobs.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[lib] = (src, tmp, subprocess.Popen(
            [compiler, *flags, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log, failed = [], []
    for lib, (src, tmp, proc) in procs.items():
        text, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    return "\n".join(log), failed


def bind(path: Path, signatures) -> ctypes.CDLL:
    """Load the library at ``path`` with each entry's argument and return
    types from ``signatures`` ({name: (argtypes, restype)})."""
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def load_once(make):
    """A function that returns ``make()``, made once per process (under a
    lock)."""
    lock, made = threading.Lock(), []

    def get():
        with lock:
            if not made:
                made.append(make())
            return made[0]

    return get


def build(build_root: Path = BUILD_ROOT) -> Dict[str, object]:
    """Compile every ``csrc/*.cu`` (one nvcc each, in parallel) unless the
    libraries for this source hash exist.  Returns {'dir', 'seconds',
    'built', 'log'}; raises RuntimeError with nvcc's output on failure."""
    out_dir = build_root / source_hash()
    names = sorted(SIGNATURES)
    libs = {n: out_dir / f"lib{n}.so" for n in names}
    if all(p.exists() for p in libs.values()):
        return {"dir": str(out_dir), "seconds": 0.0, "built": False,
                "log": ""}
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "kernels are built from source at first use")
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    log_text, failed = compile_all(
        nvcc, [*NVCC_FLAGS, "-I", str(CSRC)],
        {libs[n]: CSRC / f"{n}.cu" for n in names})
    (out_dir / "build.log").write_text(log_text)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log_text}")
    return {"dir": str(out_dir), "seconds": time.perf_counter() - t0,
            "built": True, "log": log_text}


class Kernels:
    """The loaded kernel libraries: ``kernels().greedy_head.bfc_greedy_head(
    ...)``."""

    def __init__(self, lib_dir: Path):
        for name, fns in SIGNATURES.items():
            setattr(self, name, bind(lib_dir / f"lib{name}.so", fns))

    def check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self.greedy_head.bfc_error_string(err).decode()
            raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# build (at first use) and load the kernel libraries, once per process
kernels = load_once(lambda: Kernels(Path(build()["dir"])))
