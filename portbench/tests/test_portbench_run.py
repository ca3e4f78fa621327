"""A whole run on the CPU at a small size (the harness's look for a card
skipped): the result line's schema, a sound run coming out correct, and runs
with the timed path broken underneath coming out not correct."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import ROOT, small

CELLS = ("covtype-cluster", "msd-fit-pcg")
SEED = 2**33 + 17


def _run(cell, seconds=0.5, trace=False):
    bench = harness.spec()
    _, cfg, _ = harness.cell_of(bench, cell)
    return harness.run_cell(cell, SEED, seconds, trace, device="cpu", bench=bench,
                            cfg=small(cfg))


def _kind(cell):
    return harness.kind_of(harness.cell_of(harness.spec(), cell)[2])


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_schema(cell):
    out = _run(cell)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    bench = harness.spec()
    want = {m["name"]: m["unit"] for m in harness.metrics_of(bench, cell, False)}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    limits = harness.load_json(harness.find("limits", cell))
    assert set(out["checks"]) == set(limits)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(out))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"] is True


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in _kind(c).FAULTS])
def test_run_with_a_fault_is_not_correct(cell, fault):
    """The timed path broken underneath (``FAULTS`` beside the kind's
    driver): a step that leaves its state unchanged, half of the sampled
    columns left out, an answer altered where it is produced."""
    with _kind(cell).fault(fault):
        out = _run(cell)
    assert out["correct"] is False
    assert out["failed"] >= 1
    assert any(not harness.within(c["value"], c["limit"]) for c in out["checks"].values())


def test_a_number_that_is_not_finite_fails():
    checks, failed = harness.checks_against([{"a": float("nan")}, {"a": 0.0}], {"a": 1.0})
    assert failed == 1 and checks[0][1] != checks[0][1]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                           CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
