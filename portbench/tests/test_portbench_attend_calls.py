"""The reader of ``plain_attend_calls.offline`` on synthetic registries:
the program's ``attend_calls.plain`` counter a batch, 0 where only the
core's counter is there, None where the program counts no ``attend`` call
by branch (a checkout from before the counters) or keeps no ``obs``, and
in a training cell; the metric has its cells."""

import pytest

from portbench import manifest, progspans
from portbench.cell import RunData

NAME = "plain_attend_calls.offline"


@pytest.fixture
def registry(monkeypatch):
    def use(counts):
        reg = None if counts is None else {"spans": {}, "counts": counts,
                                           "launches": {}}
        monkeypatch.setattr(progspans, "snapshot", lambda: reg)
    return use


@pytest.mark.parametrize("counts,want", [
    ({"attend_calls.plain": 80.0, "attend_calls.core": 480.0}, 40.0),
    ({"attend_calls.core": 480.0, "cast_bytes.act": 8e6}, 0.0),
    ({"cast_bytes.act": 8e6}, None),
    ({}, None),
    (None, None),
], ids=["both", "core_only", "no_attend_counter", "empty", "no_obs"])
def test_plain_calls_a_batch(registry, counts, want):
    registry(counts)
    read = manifest.reader(NAME)
    assert read(RunData(kind="offline", spans={"decode": [9.0, 9.0]})) == want
    assert read(RunData(kind="offline")) is None
    assert read(RunData(kind="train", counts={"steps": 2})) is None


def test_the_metric_has_its_reader_and_offline_cells():
    bench = manifest.load()
    by = {m["name"]: m for m in bench["per_layer"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    assert by[NAME]["moves"] == "captions_per_s"
    assert by[NAME]["workloads"]
    for cell in by[NAME]["workloads"]:
        assert cells[cell]["traffic"].split("_")[1] == "offline"
