"""The PyTorch port stands alone: no file of ``boficap_tpu_torch/``, nor
``chip_smoke.py`` or ``scripts/port_decode_ab.py``, imports jax, flax or
the JAX package."""

import ast
import os

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "boficap_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "scripts", "port_decode_ab.py")]
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


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
