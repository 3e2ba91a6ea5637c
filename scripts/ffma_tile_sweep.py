"""Time the float32 FFMA product (csrc/ffma_gemm.cuh) on each of its tiles
alone, against its tile rule and cuBLAS, at the serving product shapes.

    python3 scripts/ffma_tile_sweep.py

On one NVIDIA card: builds csrc/decoder_layer.cu four times (one nvcc
each, in parallel), with -DBFC_FFMA_TILE=0 (the rule of ``tile_for``) and
1-3 (every product forced onto 128 x 128, 64 x 128 or 32 x 64),
into boficap_tpu_torch/_build/ffma_sweep/; then, for each shape of
chip_smoke.PRODUCTS, times bfc_gemm at float32 on each build
(chip_smoke.device_ms, the mean of 20 calls each timed alone) beside
torch.matmul(a, w) + b without TF32.  Prints the nvidia-smi line, then one
line ``SWEEP {...}``: per shape, ms by tile, the rule's tile and ms, the
best forced tile, and the library ms.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILES = (0, 1, 2, 3)


def build_variants(out_dir):
    from boficap_tpu_torch.ops import _build
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise SystemExit("ffma_tile_sweep: nvcc not found")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for t in TILES:
        lib = os.path.join(out_dir, f"libdecoder_layer_t{t}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, f"-DBFC_FFMA_TILE={t}", "-I",
               str(_build.CSRC), "-o", lib,
               str(_build.CSRC / "decoder_layer.cu")]
        procs[t] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    libs = {}
    for t, (path, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"ffma_tile_sweep: nvcc failed (tile {t}):\n"
                             f"{text}")
        lib = ctypes.CDLL(path)
        for fn, (argtypes, restype) in _build.SIGNATURES[
                "decoder_layer"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[t] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ffma_tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    libs = build_variants(os.path.join(HERE, "boficap_tpu_torch", "_build",
                                       "ffma_sweep"))
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for name, M, K, N, relu, residual in cs.PRODUCTS:
        a, w, b, relu, r = cs.product_operands(M, K, N, relu, residual,
                                               dtype=torch.float32)
        c = torch.empty((M, N), device=dev)
        ms, tiles = {}, {}
        for t, lib in libs.items():
            def call(lib=lib):
                err = lib.bfc_gemm(0, dev.index, a.data_ptr(), w.data_ptr(),
                                   b.data_ptr(),
                                   None if r is None else r.data_ptr(),
                                   c.data_ptr(), M, N, K, int(relu), stream)
                if err:
                    raise SystemExit(f"ffma_tile_sweep: CUDA error {err}")
            call()
            want = torch.matmul(a, w) + b
            if relu:
                want = torch.relu(want)
            if r is not None:
                want = want + r
            torch.cuda.synchronize()
            err = ((c - want).abs().max() / want.abs().max()).item()
            if not err < 1e-4:
                raise SystemExit(f"ffma_tile_sweep: {name} tile {t}: rel "
                                 f"err {err}")
            ms[t] = cs.device_ms(call)
            bm, bn = ctypes.c_int(), ctypes.c_int()
            lib.bfc_gemm_tile(0, M, N, ctypes.byref(bm), ctypes.byref(bn))
            tiles[t] = f"{bm.value}x{bn.value}"
        best = min((t for t in TILES if t), key=lambda t: ms[t])
        out[name] = {"m_k_n": [M, K, N],
                     "ms": {tiles[t]: ms[t] for t in TILES if t},
                     "rule_tile": tiles[0], "rule_ms": ms[0],
                     "best_tile": tiles[best], "best_ms": ms[best],
                     "library_ms": cs.device_ms(lambda: torch.matmul(a, w)
                                                + b)}
    print("SWEEP " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
