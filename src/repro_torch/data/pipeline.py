"""Deterministic, stateless synthetic LM data (ported from
``repro.data.pipeline``).

Batch t is a pure function of (seed, step, host): a job restarted at step t
sees exactly the stream an uninterrupted job would have seen, with no
iterator state to checkpoint.  Each data-parallel host (rank) makes only its
slice.  The stream is an order-2 Markov chain over the vocabulary with a
power-law unigram marginal, so the cross-entropy has structure a model can
learn: a draw u ~ U[1e-6, 1) gives the base token ⌊V·u^2.5⌋ mod V, and each
position takes, with probability 1/2, (31·base[t−1] + 7) mod V instead (the
roll wraps, so position 0 reads the last base token).

The draws come from the host stream (seed, ``DATA_STREAM``, step, host) and
then move to the device, so the tokens do not depend on the card.  They are
not the reference's tokens (threefry is not reproduced); its statistics
are.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._util import DATA_STREAM, position_generator, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The stream's shape, seed and host partition."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


def _token_parts(g: torch.Generator, cfg: DataConfig, shape) -> tuple[torch.Tensor, torch.Tensor]:
    """(base tokens, the positions that take the Markov successor instead),
    drawn on the host."""
    u = torch.rand(shape, generator=g) * (1.0 - 1e-6) + 1e-6
    base = (cfg.vocab_size * u ** 2.5).to(torch.int64) % cfg.vocab_size
    return base, torch.rand(shape, generator=g) < 0.5


def _token_block(g: torch.Generator, cfg: DataConfig, shape) -> torch.Tensor:
    base, mix = _token_parts(g, cfg, shape)
    rolled = (torch.roll(base, 1, -1) * 31 + 7) % cfg.vocab_size
    return torch.where(mix, rolled, base)


def host_batch(cfg: DataConfig, step: int, *, device="cuda"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """This host's (tokens, labels) for ``step``: int64 tensors of shape
    (global_batch / n_hosts, seq_len) on ``device``, labels the tokens
    shifted by one."""
    if cfg.global_batch % cfg.n_hosts:
        raise ValueError(f"global_batch {cfg.global_batch} does not split over "
                         f"{cfg.n_hosts} hosts")
    per_host = cfg.global_batch // cfg.n_hosts
    g = position_generator(cfg.seed, DATA_STREAM, step, cfg.host_id)
    block = _token_block(g, cfg, (per_host, cfg.seq_len + 1)).to(resolve_device(device))
    return block[:, :-1].contiguous(), block[:, 1:].contiguous()


def global_batch(cfg: DataConfig, step: int, *, device="cuda"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every host's batch for ``step``, concatenated in host order."""
    parts = [host_batch(dataclasses.replace(cfg, host_id=h), step, device=device)
             for h in range(cfg.n_hosts)]
    return torch.cat([t for t, _ in parts]), torch.cat([lb for _, lb in parts])
