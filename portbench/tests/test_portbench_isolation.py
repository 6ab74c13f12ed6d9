"""Nothing the benchmark runs loads ``jax`` or the JAX package ``repro``,
and the plain reference loads nothing of the program either.  Top-level
module names are compared whole: ``repro_torch`` begins with ``repro``."""
import json
import shutil
import subprocess
import sys

import pytest

from portbench.harness import ROOT

IMPORT_ALL = """
import importlib, json, pathlib, sys
sys.path[:0] = [{root!r}, {src!r}]
pkg = pathlib.Path({root!r}) / "portbench"
names = ["portbench.run", "portbench.harness", "portbench.readings"]
for sub in ("entries", "loops", "metrics", "reference"):
    names += [f"portbench.{{sub}}.{{p.stem}}" for p in (pkg / sub).glob("*.py")]
for n in names:
    importlib.import_module(n)
for p in list((pkg / "configs").glob("*.json")) + list((pkg / "traffic").glob("*.json")):
    json.loads(p.read_text())
{extra}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(extra="", only_reference=False):
    code = IMPORT_ALL.format(root=str(ROOT), src=str(ROOT / "src"), extra=extra)
    if only_reference:
        code = (f"import sys, json; sys.path[:0] = [{str(ROOT)!r}]\n"
                "import portbench.reference.conv, portbench.work, portbench.generate\n"
                "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(ROOT)).stdout
    return set(json.loads(out.splitlines()[-1]))


def test_the_harness_and_every_file_of_it_load_neither_jax_nor_repro():
    loaded = _top_level()
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_a_run_of_the_program_loads_neither_jax_nor_repro():
    # the program's modules that a run imports, driven on the CPU
    run = """
import time
from portbench import harness
cell = harness.resolve(harness.load_benchmark(), "ccsds_tp_16x512k")
cell.traffic = dict(cell.traffic, frames=2, stages=1024, pool=1, samples=1)
harness.run_cell(cell, 1, 0.01, False, "cpu", time.perf_counter())
from portbench.run import forbidden_modules
assert forbidden_modules() == [], forbidden_modules()
"""
    loaded = _top_level(extra=run)
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(only_reference=True)
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in run.forbidden_modules()


RUN = [sys.executable, "-m", "portbench.run", "--workload", "ccsds_tiled_512x64k",
       "--seed", "5", "--seconds", "1"]


def test_without_a_card_the_run_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    res = subprocess.run(RUN, capture_output=True, text=True, cwd=str(ROOT))
    assert res.returncode != 0 and res.stdout == ""


def test_without_the_program_the_run_prints_no_result(tmp_path):
    # a directory that holds only BENCHMARK.json and the benchmark's files
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(RUN, capture_output=True, text=True, cwd=str(tmp_path))
    assert res.returncode != 0 and res.stdout == ""
