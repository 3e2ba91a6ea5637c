"""The PyTorch port stands alone: no file of ``boficap_tpu_torch/``, nor
``chip_smoke.py`` or the port's scripts (``scripts/port_decode_ab.py``,
``attention_long_ab.py``, ``ffma_tile_sweep.py``), imports jax, flax or
the JAX package; its C++ and CUDA sources (``native/``, ``csrc/``) include
no header of the JAX package and no Python header."""

import ast
import os

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "boficap_tpu")
# the dataset-building CLIs, one for each of the JAX package's scripts
PREPRO_TOOLS = ("prepro_labels", "prepro_labels_stanford", "stanford_cut",
                "phrase_encoding", "prep_h5", "KD_coco", "prepro_ngrams",
                "make_synth_corpus")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           *(os.path.join(ROOT, "scripts", f"{name}.py")
             for name in ("port_decode_ab", "attention_long_ab",
                          "ffma_tile_sweep"))]
    for d, _, files in os.walk(os.path.join(ROOT, "boficap_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_files_found():
    files = _port_files()
    assert len(files) >= 10
    assert all(os.path.exists(f) for f in files)
    for mod in (("native", "__init__.py"), ("eval", "multi_metrics.py"),
                ("prepro", "labels.py"), ("prepro", "phrase_pairs.py"),
                *(("tools", f"{name}.py") for name in PREPRO_TOOLS)):
        assert os.path.join(ROOT, "boficap_tpu_torch", *mod) in files


def _native_sources():
    out = []
    for sub in ("native", "csrc"):
        d = os.path.join(ROOT, "boficap_tpu_torch", sub)
        out += [os.path.join(d, f) for f in sorted(os.listdir(d))
                if f.endswith((".cpp", ".cu", ".cuh", ".h"))]
    return out


@pytest.mark.parametrize("path", _native_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_native_sources_include_no_jax_or_python(path):
    includes = [ln.split("include", 1)[1].strip()
                for ln in open(path).read().splitlines()
                if ln.lstrip().startswith("#") and "include" in ln]
    bad = [i for i in includes if "boficap_tpu/" in i or "Python.h" in i
           or "torch/" in i]
    assert not bad, f"{path} includes {bad}"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
