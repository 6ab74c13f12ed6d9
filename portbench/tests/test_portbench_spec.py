"""BENCHMARK.json against the contract's shape, and every cell resolved
to its files by name."""
import importlib
import json
import re

import pytest

from portbench import codes, harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_shape():
    assert set(BENCH) == KEYS["top"]
    assert BENCH["paths"] == ["portbench"]
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    # a full check of 24 cells fits its 43,200 seconds
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_shape(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        extra = set(e) - KEYS[group]
        assert extra <= {"workloads"} and (not extra or group in ("end_to_end", "per_layer"))
        assert NAME.match(e["name"])
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for w in e.get("workloads", []):
            assert w in CELLS


def test_cells_and_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"front door and plain stages", "kernels", "device"}
    for cell in CELLS:
        reported = {m for m in e2e if harness._reports(e2e[m], cell)}
        assert "setup_s" in reported and len(reported) >= 2
        per = [m for m in BENCH["per_layer"] if harness._reports(m, cell)]
        assert per
        for m in per:  # every cell that reports a metric reports what it moves
            assert m["moves"] in reported
    for m in BENCH["per_layer"]:
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = harness.resolve(BENCH, name)
    assert cell.chips == 1
    assert set(cell.limits) == set(cell.entry.CHECKS)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]))
    for key in ("build", "judge", "control", "work", "info_bits"):
        assert callable(getattr(cell.entry, key))
    assert cell.config["precision"] == {"llrs": "float32", "path_metrics": "float32", "tf32": False}


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_are_the_programs_registry_entries(config):
    body = json.loads((harness.ROOT / config["file"]).read_text())
    assert body["name"] == config["name"] and body["reduced"] == config["reduced"] == []
    assert codes.registry_mismatch(body) == []
    importlib.import_module(f"portbench.reference.{body.get('reference', 'conv')}")
