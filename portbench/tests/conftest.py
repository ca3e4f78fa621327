"""Shared fixtures of the benchmark's tests: small configurations on the CPU,
and the card for the tests marked ``cuda``."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for path in (str(ROOT), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture(autouse=True)
def _autotune_isolation(tmp_path, monkeypatch):
    """A throwaway autotune cache: no test reads or writes the user's."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs the program's CUDA kernels")
    return "cuda"


def small(cfg: dict) -> dict:
    """A configuration cut to a size a CPU test holds."""
    cfg = copy.deepcopy(cfg)
    if cfg["job"] == "krr":
        cfg["n_train"] = 3000
        cfg["sketch"]["d"] = 128
    else:
        cfg["class_counts"] = [max(40, c // 200) for c in cfg["class_counts"]]
        cfg["sketch"]["d"] = 100
    return cfg
