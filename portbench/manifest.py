"""``BENCHMARK.json`` and the files it names, found by name.

* configuration ``<c>``: ``portbench/configs/<c>.json``;
* traffic mix ``<t>``: ``portbench/traffic/<t>.json``; its ``kind`` names
  the runner of that kind (``portbench/kinds/<kind>.py``);
* cell ``<w>``: its output-check limits in ``portbench/limits/<w>.json``;
* per-layer metric ``<m>``: its reader ``portbench/metrics/<m>.py``, a
  function ``read(run)`` that returns a number or None;
* a function a mix names (a comparison, a frozen count):
  ``portbench/<module>.py``, by ``resolve``.

A later change adds a configuration, a mix, a cell or a metric by adding
such files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts: str) -> dict:
    with open(os.path.join(PKG, *parts)) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (has: "
                   f"{[w['name'] for w in bench['workloads']]})")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(ROOT, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def limits(workload_name: str) -> dict:
    return _json("limits", f"{workload_name}.json")


def _reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def end_to_end(bench: dict, cell: str) -> List[dict]:
    """The end-to-end metrics ``cell`` reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics ``cell`` reports: those that list it, or,
    without a list, those whose end-to-end metric it reports."""
    e2e = [m["name"] for m in end_to_end(bench, cell)]
    return [m for m in bench["per_layer"] if _reports(m, cell, e2e)]


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name: str) -> Callable:
    path = os.path.join(PKG, "metrics", f"{metric_name}.py")
    mod = _module(path, "portbench_metric_" + metric_name.replace(".", "_")
                  .replace("-", "_"))
    return mod.read


def runner(kind: str):
    return _module(os.path.join(PKG, "kinds", f"{kind}.py"),
                   f"portbench_kind_{kind}")


def resolve(dotted: str):
    """The function ``module.function`` of the benchmark's own package
    (``reference.compare.na_gaps``, ``roofline.counts.na_caption_flops``),
    as a mix names it."""
    module, name = dotted.rsplit(".", 1)
    return getattr(importlib.import_module("portbench." + module), name)


def read_metrics(bench: dict, cell: str, run) -> Dict[str, Optional[float]]:
    out = {}
    for m in per_layer(bench, cell):
        v = reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
