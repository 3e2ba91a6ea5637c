"""A copy of the benchmark with tiny cells beside the real ones, for the
CPU tests: each real configuration again as ``tiny_<config>`` (one layer,
width 32, a 40-word vocabulary, float32), each real cell again as
``tiny_<cell>`` over it (a 12-image store of 6 regions, batches of 8;
training steps of 4 images), with limits for the float32 plain path."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)

TINY_MODEL = dict(N_enc=1, N_dec=1, d_model=32, d_ff=64, num_att_heads=4,
                  vocab_size=40, att_feat_size=16, max_boxes=6,
                  dtype="float32")
TINY_TRAFFIC = dict(store_images=12, batch=8, regions=6, live_min=2,
                    sample=6, trace_seconds=0.5, images_per_step=4,
                    corpus_images=12, reference_images=2)
# the plain float32 path against the float32 reference: rounding alone
TINY_LIMIT = 1e-4
# a training step's change after three Adam steps of ~1e-8 a value: a few
# float32 roundings of each parameter
TINY_LIMITS = {"pad_errors": 0, "change_gap": 1e-3}


def make_copy(dest: str) -> str:
    """Write the copy under ``dest``; returns its root."""
    root = os.path.join(dest, "checkout")
    shutil.copytree(PKG, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in list(bench["configs"]):
        with open(os.path.join(root, c["file"])) as f:
            cfg = json.load(f)
        cfg.update(TINY_MODEL, name="tiny_" + c["name"])
        rel = f"portbench/configs/tiny_{c['name']}.json"
        with open(os.path.join(root, rel), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append(dict(c, name=cfg["name"], file=rel))
    for w in list(bench["workloads"]):
        with open(os.path.join(root, "portbench", "traffic",
                               w["traffic"] + ".json")) as f:
            tr = json.load(f)
        tr.update({k: v for k, v in TINY_TRAFFIC.items() if k in tr
                   or k == "trace_seconds"})
        name = "tiny_" + w["name"]
        with open(os.path.join(root, "portbench", "traffic",
                               "tiny_" + w["traffic"] + ".json"), "w") as f:
            json.dump(tr, f)
        with open(os.path.join(root, "portbench", "limits",
                               w["name"] + ".json")) as f:
            lim = json.load(f)
        lim = {k: TINY_LIMITS.get(k, TINY_LIMIT)
               for k in lim if not k.startswith("_")}
        with open(os.path.join(root, "portbench", "limits",
                               name + ".json"), "w") as f:
            json.dump(lim, f)
        bench["workloads"].append(dict(w, name=name,
                                       config="tiny_" + w["config"],
                                       traffic="tiny_" + w["traffic"]))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if w["name"] in m.get("workloads", ()):
                m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return root


def run_in(root: str, code: str, timeout: float = 300):
    """Run ``code`` in a fresh interpreter from ``root`` (the copy first on
    the path, then the repo for the program); returns the completed
    process."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, REPO]))
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)


RUN_CELL = """
import json, sys, torch
from portbench import manifest, run
bench = manifest.load()
w = manifest.workload(bench, {name!r})
res = run.run_cell(bench, w, {seed}, {seconds}, {trace}, torch.device('cpu'))
res['modules'] = sorted({{m.split('.')[0] for m in sys.modules}})
print(json.dumps(res))
"""


def run_cell(root: str, name: str, seed: int = 2 ** 31 + 11,
             seconds: float = 0.3, trace: bool = False, prelude: str = ""):
    """One tiny cell through ``run.run_cell`` on the CPU in a fresh
    interpreter (``prelude`` runs first: a fault planted in the program);
    returns its result object, with ``modules``: the top-level names the
    process loaded."""
    p = run_in(root, prelude + RUN_CELL.format(
        name=name, seed=seed, seconds=seconds, trace=trace))
    if p.returncode != 0:
        raise AssertionError(f"run failed ({p.returncode}):\n{p.stderr}")
    return json.loads(p.stdout.strip().splitlines()[-1])
