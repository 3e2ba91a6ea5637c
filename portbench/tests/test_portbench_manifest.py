"""BENCHMARK.json against the manifest's rules, and every name in it
resolving to its file; a new configuration, mix, cell and metric picked up
from new files alone."""

import json
import os
import re

import pytest

from portbench import manifest
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_keys_and_limits(bench):
    assert set(bench) == TOP
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        assert TEXT.match(word)
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    n_cells = len(bench["workloads"])
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 \
        + 1200 <= 43200
    assert 1 <= n_cells <= 24 and 1 <= len(bench["configs"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128


def test_names_units_text(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == CONFIG_KEYS
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == CELL_KEYS and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        names.append(m["name"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["source"] in SOURCES and TEXT.match(m["layer"])
        names.append(m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for n in names:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)
    assert "setup_s" in [m["name"] for m in bench["end_to_end"]]


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
    for cell in cells:
        reported = [m["name"] for m in manifest.end_to_end(bench, cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert manifest.per_layer(bench, cell)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in cells
            assert m["moves"] in [x["name"] for x in
                                  manifest.end_to_end(bench, cell)]
    for m in bench["end_to_end"]:
        for cell in m.get("workloads", []):
            assert cell in cells


def test_every_name_resolves(bench):
    for w in bench["workloads"]:
        cfg = manifest.config(bench, w["config"])
        assert cfg["name"] == w["config"]
        tr = manifest.traffic(w["traffic"])
        assert callable(manifest.runner(tr["kind"]).run)
        lim = manifest.limits(w["name"])
        assert lim and all(v is not None for v in lim.values()), w["name"]
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert os.path.exists(os.path.join(manifest.ROOT, c["file"]))
    for m in bench["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_new_files_alone_are_picked_up(tiny_root):
    """A configuration, a mix, a cell and a per-layer metric added as new
    files and entries, no existing file edited, run and report."""
    pb = os.path.join(tiny_root, "portbench")
    with open(os.path.join(pb, "configs", "tiny_uic_sd.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "added_cfg"
    with open(os.path.join(pb, "configs", "added_cfg.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic",
                           "tiny_na_offline_b8192.json")) as f:
        tr = json.load(f)
    tr["batch"] = 4
    with open(os.path.join(pb, "traffic", "added_mix.json"), "w") as f:
        json.dump(tr, f)
    with open(os.path.join(pb, "limits", "added_cfg.added_mix.json"),
              "w") as f:
        json.dump({"plan_gap": tiny.TINY_LIMIT, "word_gap": tiny.TINY_LIMIT,
                   "pad_errors": 0}, f)
    with open(os.path.join(pb, "metrics", "added_metric.py"), "w") as f:
        f.write("def read(run):\n    return run.counts.get('captions')\n")
    bench_path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "added_cfg", "source": "test",
                             "file": "portbench/configs/added_cfg.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "added_cfg.added_mix",
                               "config": "added_cfg", "traffic": "added_mix",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("added_cfg.added_mix")
    bench["per_layer"].append({"name": "added_metric", "unit": "captions",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "captions_per_s",
                               "workloads": ["added_cfg.added_mix"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    res = tiny.run_cell(tiny_root, "added_cfg.added_mix", trace=True)
    assert res["metrics"]["added_metric"]["value"] > 0
    assert res["correct"] is True


def test_every_counted_wrapper_is_in_the_launch_table():
    """Each of the port's counted kernel wrappers has its frozen work in
    the table, or is named there as one whose shapes no cell fixes."""
    from boficap_tpu_torch import ops
    from portbench.roofline import launches
    assert set(ops.launch_counts()) <= set(launches.WORK)


@pytest.mark.parametrize("name", ["linear", "refnorm", "a_new_kernel"])
def test_a_launch_of_unknown_work_leaves_the_roofline_silent(name):
    from portbench.cell import RunData
    from portbench.devtrace import Trace
    from portbench.roofline import launches
    bench = manifest.load()
    cfg = manifest.config(bench, "uic_sd")
    tr = Trace(device=[("void bfc::gemm<...>", 0.0, 5.0)], t0=0.0, t1=10.0)
    run = RunData(kind="offline", window_s=1.0, trace=tr,
                  launches={"decoder_layer": 6, name: 3},
                  sizes=launches.sizes(cfg, 64, 36))
    assert manifest.reader("kernel_roofline.offline")(run) is None
    run.launches = {"decoder_layer": 6}
    assert manifest.reader("kernel_roofline.offline")(run) > 0
