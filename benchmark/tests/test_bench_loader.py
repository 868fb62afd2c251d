"""The harness finds every configuration, traffic mix and metric reader of
BENCHMARK.json by name, and the file keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_parts_found_by_name(cell):
    entry, cfg, traffic = harness.cell_parts(SPEC, cell)
    assert cfg["name"] == entry["config"]
    assert traffic["kind"] in ("stream", "group")
    harness.kind_module(traffic["kind"])
    assert harness.cell_metrics(SPEC, cell, "per_layer")
    names = {m["name"] for m in harness.cell_metrics(SPEC, cell, "end_to_end")}
    assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.reader(metric))


def test_contract_shape():
    assert set(SPEC) == TOP
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    for p in SPEC["paths"]:
        assert os.path.isdir(os.path.join(harness.ROOT, p))
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in SPEC[kind]}) == len(SPEC[kind])
    assert len({m["name"] for k in ("end_to_end", "per_layer") for m in SPEC[k]}) == \
        len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert harness.load_json(os.path.join(harness.ROOT, c["file"]))["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        layers.add(m["layer"])
        for w in m["workloads"]:  # each listed cell reports the metric it moves
            assert m["moves"] in {x["name"] for x in harness.cell_metrics(SPEC, w, "end_to_end")}
    assert all("\n" not in x and "\t" not in x for x in layers)
