"""The one traffic generator: a mix file's parameters and a seed give the
sequence of jobs a run offers, in a closed loop (one client, each job sent
when the last has finished).

Job i carries its own seed, the stream (seed, i), so a job's inputs depend
on the run's seed and its place alone; the mix's ``kind`` (the entry the
window drives) makes the job's inputs from that seed.  A kind whose requests
need more than a seed defines its own ``jobs(mix, cfg, seed)`` beside its
driver.
"""
from __future__ import annotations

import itertools
from typing import Iterator

from portbench.reference.sketch import splitmix64

JOB_TAG = 0x10B5


def stream(seed: int, tag: int) -> int:
    """The seed of the stream (seed, tag)."""
    return splitmix64(int(seed), int(tag))


def job_seed(seed: int, job: int) -> int:
    """The seed of job number ``job`` of a run seeded with ``seed``."""
    return splitmix64(stream(seed, JOB_TAG), job)


def jobs(mix: dict, cfg: dict, seed: int) -> Iterator[dict]:
    """The run's jobs, endless, in the order they are offered."""
    for i in itertools.count():
        yield {"job": i, "seed": job_seed(seed, i)}
