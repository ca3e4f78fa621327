"""Measured autotune cache for the launch geometry of the port's CUDA kernels.

The counterpart of ``repro.kernels.accum_apply.autotune``, with the same
names and rules:

  * the first eligible call at a (kind, shape, dtype, device) key times the
    candidate geometries on the caller's real tensors and keeps the winner;
  * winners persist to a JSON file (``REPRO_AUTOTUNE_CACHE``, default
    ``~/.cache/repro_torch/autotune.json``) so later processes skip the
    measurement;
  * a missing file is a cold start; a corrupt or unreadable one falls back
    to ``STATIC_TABLE`` and is recorded as ``autotune.load:
    measured-cache -> static-table`` in ``resilience.degrade.global_health()``;
    a directory that cannot be written is not an error.

Keys are ``kind|shape…|dtype|cuda:<device name>|src:<hash>``: an entry
measured on one card never serves another, and the reference's
``cpu/interpret`` or ``tpu`` entries never match.  The last field is the
caller's ``source``, the hash of the kernel's CUDA source and nvcc flags
(``kernel.source_hash``), so an entry measured on one version of a kernel is
a miss for every other: a redesign measures anew instead of inheriting its
predecessor's geometry.  Values are lists of positive ints, so a file either
package wrote passes the other's validation.

Measuring happens only where it means something: on a CUDA device, gated by
``REPRO_AUTOTUNE`` (default on for CUDA tensors, off on the CPU, where the
plain versions have no geometry).  Candidates are timed with CUDA events
over back-to-back launches totalling at least ``MIN_RUN_MS``, in ``ROUNDS``
interleaved rounds, and ranked by their fastest round; the caller's
``bench_fn`` writes scratch outputs only.  An exception in a timed launch
propagates: a failed launch raises, as everywhere in the port.  Launches made
while measuring are counted in ``MEASURE_LAUNCHES``, not in each kernel's
``launches``.

Every candidate of a kernel gives the same bits (``PERF.md`` §6): the
geometry decides which block computes an output, never the order of a sum.

All reads go through ``os.environ`` at call time, so tests can repoint the
cache and the gate without reloads.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import json
import math
import os
import pathlib
import time

import torch

from repro_torch._util import env_flag

ENV_CACHE = "REPRO_AUTOTUNE_CACHE"
ENV_GATE = "REPRO_AUTOTUNE"

# the fallback geometry when the cache has no entry and measuring is off:
# the column gather's 0 leaves the rows a block to the body the launch
# takes (csrc launch_gather), and the faster
# of the tensor-core attention sweep's two block sizes on the H100
STATIC_TABLE: dict[str, tuple[int, ...]] = {
    "matfree_cols": (64,),         # matfree_apply: rows of X a block at small n (kernel.matfree_rows)
    "accum_apply": (0,),           # the gather of accum_apply / accum_step_slab: rows a block
    "sketch_both": (0,),           # accum_sketch_both's gather: rows a block
    "accum_grow": (0,),            # accum_grow_slabs' gather: rows a block
    "landmark_attention": (128,),  # query rows a block (8 where S ≤ 8, decode)
    "landmark_stats": (128,),      # landmark rows a block of the BmV sweep (8 where L ≤ 8)
}

# a candidate's timed run lasts at least this long (a single launch of the
# smallest kernels is 1–40 µs of device time), in at most MAX_CALLS calls;
# each candidate runs ROUNDS times, in turn with the others, and keeps its
# fastest: host jitter only adds time, and one run of ~1 ms of kernels near
# 0.1 ms each has ranked a candidate 15% slower first on the H100
MIN_RUN_MS = 1.0
MAX_CALLS = 200
ROUNDS = 3

# in-memory mirror of the JSON file, keyed by cache path so tests that
# repoint REPRO_AUTOTUNE_CACHE never see another file's entries
_MEM: dict[str, dict[str, list[int]]] = {}

# launches made while candidates were timed, by kernel name
MEASURE_LAUNCHES: collections.Counter = collections.Counter()
_measuring = False


def cache_path() -> pathlib.Path:
    """The cache file: ``REPRO_AUTOTUNE_CACHE`` or the per-user default."""
    env = os.environ.get(ENV_CACHE)
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".cache" / "repro_torch" / "autotune.json"


def measure_enabled(device) -> bool:
    """Measure by default only on CUDA tensors; ``REPRO_AUTOTUNE=0/1``
    overrides."""
    return env_flag(ENV_GATE, torch.device(device).type == "cuda")


def _load(path: pathlib.Path) -> dict[str, list[int]]:
    key = str(path)
    if key in _MEM:
        return _MEM[key]
    from repro_torch.resilience import faults

    entries: dict[str, list[int]] = {}
    try:
        faults.fault_point("autotune.load")  # simulated unreadable cache file
        raw = json.loads(path.read_text())
        # validate hard: a corrupt cache must fall back, not crash
        if isinstance(raw, dict):
            for k, v in raw.items():
                if (isinstance(k, str) and isinstance(v, list)
                        and all(isinstance(x, int) and x > 0 for x in v)):
                    entries[k] = v
    except FileNotFoundError:
        entries = {}  # a missing cache is the normal cold start, not a fault
    except faults.DeviceLost:
        raise  # simulated preemption is fatal, not a degradation
    except (OSError, ValueError, faults.FaultInjected) as e:
        # corrupt or unreadable cache: the static table, recorded
        from repro_torch.resilience.degrade import global_health

        entries = {}
        global_health().record(
            "autotune.load", rung_from="measured-cache", rung_to="static-table",
            detail=repr(e))
    _MEM[key] = entries
    return entries


def _store(path: pathlib.Path, entries: dict[str, list[int]]) -> None:
    """Best-effort atomic persist; an unwritable cache dir is not an error."""
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        tmp.write_text(json.dumps(entries, indent=2, sort_keys=True) + "\n")
        tmp.replace(path)
    except OSError:
        pass


@functools.cache
def _backend(device: torch.device) -> str:
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


def _key(kind: str, shape_key: tuple, dtype: torch.dtype, device,
         source: str | None = None) -> str:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    name = str(dtype).removeprefix("torch.")
    fields = [kind, *map(str, shape_key), name, _backend(device)]
    return "|".join(fields if source is None else [*fields, f"src:{source}"])


def lookup(kind: str, shape_key: tuple, dtype: torch.dtype, device,
           arity: int | None = None, *, source: str | None = None
           ) -> tuple[int, ...] | None:
    """The persisted winner for this key, or None (missing/corrupt cache).
    ``arity`` rejects entries of the wrong length — a hand-edited or
    stale-schema entry must fall back, not crash the caller's unpack.
    ``source`` is the kernel source's hash: an entry recorded under another
    hash (or none) is not this key's."""
    entry = _load(cache_path()).get(_key(kind, shape_key, dtype, device, source))
    if not entry or (arity is not None and len(entry) != arity):
        return None
    return tuple(entry)


def record(kind: str, shape_key: tuple, dtype: torch.dtype, device,
           blocks: tuple[int, ...], *, source: str | None = None) -> None:
    """Persist ``blocks`` as the winner for this key (and ``source``)."""
    path = cache_path()
    entries = dict(_load(path))
    entries[_key(kind, shape_key, dtype, device, source)] = [int(b) for b in blocks]
    _MEM[str(path)] = entries
    _store(path, entries)


@contextlib.contextmanager
def _measuring_launches():
    global _measuring
    _measuring = True
    try:
        yield
    finally:
        _measuring = False


# set by a caller that profiles the main paths (chip_smoke.py): each kernel
# wrapper then launches inside a ``torch.profiler.record_function`` range
# named ``launch:<wrapper>``, so the profiler can sum each wrapper's device
# time even where wrappers share a CUDA kernel (the column gather)
PROFILE_RANGES = False
_NO_RANGE = contextlib.nullcontext()


def launch_range(fn):
    """The context a kernel wrapper ``fn`` launches in: a profiler range
    named after it while ``PROFILE_RANGES`` is set and no candidate is being
    timed, else nothing."""
    if PROFILE_RANGES and not _measuring:
        return torch.profiler.record_function(f"launch:{fn.__name__}")
    return _NO_RANGE


def count_launch(fn) -> None:
    """Count one launch of the kernel wrapper ``fn``: in ``fn.launches``,
    or in ``MEASURE_LAUNCHES`` while candidates are being timed."""
    if _measuring:
        MEASURE_LAUNCHES[fn.__name__] += 1
    else:
        fn.launches += 1


def _run_ms(fn, calls: int, device: torch.device) -> float:
    """Milliseconds for ``calls`` back-to-back calls of ``fn``."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) * 1e3
    with torch.cuda.device(device):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)


def _time(fns: list, device: torch.device) -> list[float]:
    """Milliseconds per call of each of ``fns``: one warm-up call each, one
    call to size its runs, then ``ROUNDS`` rounds in which each in turn runs
    back to back for at least ``MIN_RUN_MS``; each keeps its fastest round."""
    for fn in fns:
        _run_ms(fn, 1, device)
    calls = [max(1, min(MAX_CALLS, math.ceil(MIN_RUN_MS / max(_run_ms(fn, 1, device), 1e-3))))
             for fn in fns]
    best = [math.inf] * len(fns)
    for _ in range(ROUNDS):
        for i, (fn, n) in enumerate(zip(fns, calls)):
            best[i] = min(best[i], _run_ms(fn, n, device) / n)
    return best


def measured_blocks(
    kind: str, shape_key: tuple, dtype: torch.dtype, device,
    candidates: list[tuple[int, ...]], bench_fn, fallback: tuple[int, ...],
    concrete: bool, source: str | None = None,
) -> tuple[int, ...]:
    """The autotune decision for one kernel call site.

    Resolution order: cache hit among ``candidates`` → (if ``concrete``
    inputs on a device where the gate allows) time ``bench_fn(blocks)`` for
    each candidate, persist and return the winner → ``fallback`` (the static
    geometry).  A hit that is not a candidate (a file written when the
    kernel took other geometries) counts as a miss, and so does an entry
    recorded under another ``source`` hash (another version of the kernel's
    CUDA source): the winner is recorded under this hash.  The caller drops
    candidates the device cannot launch before passing them; a single
    candidate is returned untimed.  ``bench_fn`` runs the caller's kernel on
    its real inputs into scratch outputs; ties go to the earlier candidate."""
    candidates = list(dict.fromkeys(tuple(c) for c in candidates))
    hit = lookup(kind, shape_key, dtype, device, arity=len(fallback), source=source)
    if hit is not None and hit in candidates:
        return hit
    if not concrete or not measure_enabled(device) or not candidates:
        return fallback
    if len(candidates) == 1:
        return candidates[0]
    device = torch.device(device)
    with _measuring_launches():
        times = _time([lambda c=c: bench_fn(c) for c in candidates], device)
    best = candidates[times.index(min(times))]
    record(kind, shape_key, dtype, device, best, source=source)
    return best


def is_concrete(*tensors: torch.Tensor) -> bool:
    """True unless a tensor is a placeholder (meta device) or the call is
    being traced by ``torch.compile`` — nothing can be timed there."""
    if torch.compiler.is_compiling():
        return False
    return not any(t.device.type == "meta" for t in tensors)
