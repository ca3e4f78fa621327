"""The benchmark's layout: BENCHMARK.json keeps the contract's shape, every
name it gives finds its file, files added under a new name are found, and
nothing under the reference or the harness loads JAX or the JAX package."""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_shape():
    b = harness.spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][1].startswith("portbench/")
    assert 1 <= b["run_seconds"] <= 51
    cfgs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in b["workloads"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in cfgs
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        harness.find("mixes", w["traffic"])
        harness.find("limits", w["name"])
        assert len(harness.metrics_of(b, w["name"], False)) >= 2
        assert harness.metrics_of(b, w["name"], True)
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert callable(harness.reader(m["name"]))
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and NAME.match(m["name"])
        for w in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in harness.metrics_of(b, w, False)}
        assert callable(harness.reader(m["name"]))
    assert len(json.dumps(b)) < 64 * 1024


@pytest.fixture
def copy_of_bench(tmp_path, monkeypatch):
    """A copy of BENCHMARK.json and portbench/ in which the harness looks."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "BENCH", tmp_path / "portbench")
    return tmp_path


def test_new_mix_config_and_metric_are_found_by_name(copy_of_bench):
    root = copy_of_bench
    b = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/spectral-covtype.json").read_text())
    cfg["name"] = "spectral-new"
    (root / "portbench/configs/spectral-new.json").write_text(json.dumps(cfg))
    (root / "portbench/mixes/open_cluster.json").write_text(
        json.dumps({"kind": "spectral_cluster", "check_jobs": 1}))
    (root / "portbench/metrics/jobs_done.cluster.py").write_text(
        "def read(ctx):\n    return float(ctx['jobs'])\n")
    (root / "portbench/metrics/jobs_per_s.py").write_text(
        "def read(ctx):\n    return ctx['jobs'] / ctx['window_s']\n")
    b["configs"].append({"name": "spectral-new", "source": "x",
                         "file": "portbench/configs/spectral-new.json", "reduced": [], "why": "x"})
    b["workloads"].append({"name": "new-cell", "config": "spectral-new",
                           "traffic": "open_cluster", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "jobs_done.cluster", "unit": "count", "better": "higher",
                           "source": "program_counter", "layer": "x", "moves": "cluster_s"})
    cell, got_cfg, mix = harness.cell_of(b, "new-cell")
    assert got_cfg["name"] == "spectral-new" and mix["check_jobs"] == 1
    assert harness.reader("jobs_done.cluster")({"jobs": 3}) == 3.0
    assert harness.reader("jobs_per_s")({"jobs": 3, "window_s": 2.0}) == 1.5
    assert "jobs_done.cluster" in {m["name"] for m in harness.metrics_of(b, "new-cell", True)}
    # a metric without a reader of its own takes the reader of its first part
    ctx = {"summary": {"ops": [(0, 1, "k")], "busy_s": 0.25}, "window_s": 1.0}
    assert harness.reader("idle_share.new")(ctx) == pytest.approx(75.0)
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric.cluster")


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_for_test", object())
    assert "repro_torch_fake_for_test" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake_for_test", object())
    assert "repro.fake_for_test" in harness.forbidden_modules()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tops = set(_imports(path))
        assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, path


def test_no_harness_module_imports_jax():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "repro"}, path


def test_reference_loads_no_jax_in_a_fresh_process():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.krr, portbench.reference.spectral, "
            "portbench.reference.sketch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'repro', 'repro_torch')]; "
            "print(bad); sys.exit(1 if bad else 0)") % str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_data_is_made_by_the_module_the_configuration_names(monkeypatch):
    import types

    from portbench.yardstick import data

    fake = types.ModuleType("portbench.datasets.fake_for_test")
    fake.make = lambda cfg, seed, device: {"seed": seed, "device": device}
    monkeypatch.setitem(sys.modules, "portbench.datasets.fake_for_test", fake)
    cfg = {"data": {"kind": "fake_for_test"}}
    assert data.make(cfg, 5, "cpu") == {"seed": 5, "device": "cpu"}


def test_shared_code_names_no_kind_dataset_or_cell():
    names = {p.stem for folder in ("kinds", "datasets") for p in
             (ROOT / "portbench" / folder).glob("*.py") if not p.stem.startswith("_")}
    names -= {"base"}
    names |= {w["name"] for w in harness.spec()["workloads"]}
    shared = [ROOT / "portbench" / f for f in ("run.py", "harness.py", "control.py",
                                               "yardstick/data.py", "yardstick/traffic.py",
                                               "yardstick/trace.py")]
    for path in shared:
        text = path.read_text()
        assert not [n for n in names if n in text], path
