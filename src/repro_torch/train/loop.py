"""Fault-tolerant training loop: checkpoint and restart, straggler tracking,
deterministic data resume (ported from ``repro.train.loop``).

Restart contract: the loop derives everything from (config, latest
checkpoint), and the data stream is stateless in the step, so a preempted
job resumes with the token stream it would have seen.  ``run`` turns on
``torch.use_deterministic_algorithms`` for its duration (scatter-adds such
as the embedding's backward then sum in a fixed order), so a resumed run is
bitwise the uninterrupted one; on a CUDA device cuBLAS then needs
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment before CUDA starts,
and PyTorch raises at the first product without it.  Straggler mitigation:
each step's wall time (ending in the loss's read to the host) feeds an
EWMA, and a step slower than ``straggler_factor`` × the EWMA is logged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable

import torch
import torch.utils.deterministic

from repro_torch._util import tree_leaves
from repro_torch.checkpoint.ckpt import AsyncCheckpointer, latest_step, restore
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, global_batch, host_batch
from repro_torch.sharding import Mesh
from repro_torch.train.step import TrainConfig, TrainState, train_step


@dataclasses.dataclass
class LoopConfig:
    """Run length, checkpoint cadence and retention, logging."""

    total_steps: int = 100
    ckpt_dir: str = ""
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 2.0


@dataclasses.dataclass
class LoopReport:
    """What a run did: steps, where it resumed, the loss of each step."""

    steps_run: int
    resumed_from: int | None
    final_loss: float
    losses: list
    straggler_steps: list


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` inside the block, the
    previous setting restored after it.  Uninitialised memory is not filled:
    no result reads it."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.utils.deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.utils.deterministic.fill_uninitialized_memory = prev[2]


def run(cfg: ModelConfig, tc: TrainConfig, dc: DataConfig, lc: LoopConfig, *,
        init_params_fn: Callable[[], TrainState] | None = None, step_fn=None,
        log=print, mesh=None) -> LoopReport:
    """Train from ``init_params_fn()`` (or the newest checkpoint under
    ``lc.ckpt_dir``) to ``lc.total_steps``.  ``step_fn(state, tokens,
    labels, step) → (state, metrics)`` defaults to ``train_step``.  With a
    data mesh (``DataMesh``) of D ranks each rank takes its host's slice of
    the batch; on a 2-D mesh (``sharding.Mesh``) each rank makes the global
    batch and ``train_step`` keeps its ``batch_spec`` shard.  On either with
    D > 1 ranks each rank keeps its checkpoints (its own error feedback, or
    its shards, included) under ``ckpt_dir/rank<r>``.  Batches land on the
    parameters' device."""
    if init_params_fn is None:
        raise ValueError("provide init_params_fn")
    state = init_params_fn()
    device = tree_leaves(state.params)[0].device
    per_host = mesh is not None and not isinstance(mesh, Mesh)
    if per_host:
        dc = dataclasses.replace(dc, n_hosts=mesh.size, host_id=mesh.rank)

    def batch(step):
        if not per_host:
            return global_batch(dc, step, device=device)
        return host_batch(dc, step, device=device)

    resumed_from = None
    start = 0
    ckpt = None
    if lc.ckpt_dir:
        path = lc.ckpt_dir
        if mesh is not None and mesh.size > 1:
            path = os.path.join(path, f"rank{mesh.rank}")
        ckpt = AsyncCheckpointer(path, keep=lc.keep)
        if latest_step(path) is not None:
            state, start = restore(path, state)
            resumed_from = start
            log(f"[loop] resumed from step {start}")

    if step_fn is None:
        def step_fn(s, t, lb, i):
            return train_step(s, t, lb, i, cfg, tc, mesh=mesh)

    losses, stragglers = [], []
    ewma = None
    with deterministic():
        for step in range(start, lc.total_steps):
            toks, labs = batch(step)
            t0 = time.perf_counter()
            state, mets = step_fn(state, toks, labs, step)
            loss = float(mets["loss"])
            dt = time.perf_counter() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > lc.straggler_factor * ewma and step > start + 2:
                stragglers.append(step)
                log(f"[loop] straggler at step {step}: {dt:.3f}s vs ewma {ewma:.3f}s")
            losses.append(loss)
            if step % lc.log_every == 0:
                log(f"[loop] step {step} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
            if ckpt and (step + 1) % lc.ckpt_every == 0:
                ckpt.save(state, step=step + 1)
        if ckpt:
            ckpt.save(state, step=lc.total_steps)
            ckpt.wait()
    return LoopReport(
        steps_run=lc.total_steps - start, resumed_from=resumed_from,
        final_loss=losses[-1] if losses else float("nan"),
        losses=losses, straggler_steps=stragglers)
