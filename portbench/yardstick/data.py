"""The cells' data, made on the device from the seed in a few large calls.

Both sides of a run, the program and the reference, are handed the tensors
made here; nothing is downloaded.  A configuration's ``data`` group names its
``kind``: the module ``portbench/datasets/<kind>.py``, whose
``make(cfg, seed, device)`` returns the data, drawn from ``generator``.
"""
from __future__ import annotations

import importlib

import torch

from portbench.yardstick.traffic import stream

DATA_TAG = 0xDA7A


def generator(seed: int, device) -> torch.Generator:
    """The generator on ``device`` of the run's data stream."""
    return torch.Generator(device=device).manual_seed(stream(seed, DATA_TAG))


def make(cfg: dict, seed: int, device) -> dict:
    """The data of configuration ``cfg`` for ``seed``, on ``device``."""
    kind = importlib.import_module(f"portbench.datasets.{cfg['data']['kind']}")
    return kind.make(cfg, seed, device)
