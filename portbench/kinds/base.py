"""What every job kind shares: the precision the reference runs in, the
sample of the window's answers that the reference checks, and the planting
of a fault in the program.

A kind module defines ``Driver(cfg, mix, data, seed, device)`` with
``warm()`` (every shape the window will use, run once), ``run(job)`` (one
job of the window), ``work(job)`` (its FLOPs and its ``matfree_apply``
shapes), ``release()`` (frees the program's state), ``check()`` (once the
window has closed: the numbers compared, one dict an answer checked) and
``control(jobs)`` (the same numbers with the reference in TF32 in the
program's place).  Beside it, ``FAULTS`` names the faults a run of the kind
can have and ``fault(name)`` is a context in which the program has one; the
check has to find each.  It may define ``jobs(mix, cfg, seed)`` where its
requests need more than the general generator gives.
"""
from __future__ import annotations

import contextlib

import torch

from portbench.yardstick.traffic import stream

CHECK_TAG = 0xC4EC
# the precisions the reference runs in: the configuration's float32 is
# checked against float64; the control is the nearest precision below the
# configuration's float32 with TF32 off, float32 with TF32 products
PRECISIONS = ("float64", "tf32")


@contextlib.contextmanager
def precision(name: str):
    """(dtype of the reference's tensors) with TF32 products on for
    ``"tf32"`` and off otherwise; the flags are restored on exit."""
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {name!r}")
    cuda, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    on = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield torch.float32 if on else torch.float64
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def sample(kept: list, k: int, seed: int) -> list:
    """``k`` of the kept answers (all of them if fewer), drawn from the
    seed once the window has closed."""
    g = torch.Generator().manual_seed(stream(seed, CHECK_TAG))
    order = torch.randperm(len(kept), generator=g).tolist()
    return [kept[i] for i in sorted(order[:k])]


@contextlib.contextmanager
def patched(owner, name: str, wrap):
    """A context in which ``owner.name`` is ``wrap(the real one)``."""
    real = getattr(owner, name)
    setattr(owner, name, wrap(real))
    try:
        yield
    finally:
        setattr(owner, name, real)

