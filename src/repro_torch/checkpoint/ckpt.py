"""Fault-tolerant checkpointing: npz payload + JSON metadata + atomic rename
+ retained history (ported from ``repro.checkpoint.ckpt``; the reference's
msgpack is replaced by numpy's ``.npz`` and the async writer is not ported).

Layout: <dir>/step_<n>/state.npz + meta.json + COMMITTED, written to a tmp
path and renamed (atomic on POSIX), so a kill mid-write never corrupts the
latest checkpoint.  Only directories with the COMMITTED marker count, and
``latest_step`` sweeps stale ``.tmp`` / uncommitted directories by default.
Tensors are stored on the host; bfloat16 travels as its uint16 bits with the
dtype in meta.json.  An npz is a zip with a CRC per array, so a bit-flipped
or torn payload fails to load instead of loading wrong numbers.

``save`` retries the write with exponential backoff, except on a
(simulated) device loss, which propagates untouched.  ``restore(step=None)``
walks committed steps newest-first and falls back past a corrupt payload to
step N−1, recording the skip in the global HealthReport.  The ``ckpt.write``
fault site (REPRO_FAULT_PLAN) can corrupt or truncate the payload of one
write attempt or kill it mid-write.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import time
from typing import Any

import numpy as np
import torch

from repro_torch._util import tree_leaves, tree_map
from repro_torch.resilience import faults

PyTree = Any
_COMMIT = "COMMITTED"


def _encode(x) -> tuple[np.ndarray, dict]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), {
                "dtype": "bfloat16", "torch": True}
        return t.numpy(), {"dtype": str(t.numpy().dtype), "torch": True}
    a = np.asarray(x)
    return a, {"dtype": str(a.dtype), "torch": False}


def _decode(a: np.ndarray, info: dict, like):
    if info["dtype"] == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, dtype=np.dtype(info["dtype"])))
    if isinstance(like, torch.Tensor):
        return t.to(like.device)
    return t.numpy() if not info["torch"] else t


def _step_dir(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:08d}")


def _write_attempt(tmp: str, final: str, payload: bytes, meta: dict) -> None:
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    # fault site: a "kill" dies after meta but before state — the partial
    # tmp dir a preemption leaves; "corrupt"/"truncate" mangle the payload
    payload = faults.corrupt("ckpt.write", payload)
    with open(os.path.join(tmp, "state.npz"), "wb") as f:
        f.write(payload)
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def save(path: str, tree: PyTree, *, step: int, extra: dict | None = None,
         keep_last: int | None = None, retries: int = 3, backoff: float = 0.05) -> str:
    """Atomic save with retry-with-backoff.  Returns the committed directory.

    Transient write errors are retried up to ``retries`` times (backoff
    doubling from ``backoff`` seconds); a DeviceLost propagates immediately.
    With ``keep_last``, older committed steps are removed after the commit."""
    final = _step_dir(path, step)
    tmp = final + ".tmp"
    encoded = [_encode(x) for x in tree_leaves(tree)]
    buf = io.BytesIO()
    np.savez(buf, **{f"leaf_{i}": a for i, (a, _) in enumerate(encoded)})
    meta = {"step": step, "leaves": [info for _, info in encoded], "extra": extra or {}}
    for attempt in range(max(1, retries)):
        try:
            _write_attempt(tmp, final, buf.getvalue(), meta)
            break
        except faults.DeviceLost:
            raise  # simulated preemption: no cleanup, no retry
        except Exception:
            if attempt >= max(1, retries) - 1:
                raise
            time.sleep(backoff * (2**attempt))
    if keep_last is not None:
        retain(path, keep_last)
    return final


def _restore_step(path: str, like: PyTree, step: int) -> PyTree:
    d = _step_dir(path, step)
    infos = read_meta(path, step)["leaves"]
    with open(os.path.join(d, "state.npz"), "rb") as f:
        with np.load(io.BytesIO(f.read()), allow_pickle=False) as z:
            arrays = [z[f"leaf_{i}"] for i in range(len(infos))]
    likes = tree_leaves(like)
    if len(likes) != len(arrays):
        raise ValueError(f"checkpoint step {step} holds {len(arrays)} arrays, the "
                         f"target structure {len(likes)}")
    it = iter(_decode(a, info, lk) for a, info, lk in zip(arrays, infos, likes))
    return tree_map(lambda _: next(it), like)


def restore(path: str, like: PyTree, *, step: int | None = None) -> tuple[PyTree, int]:
    """Restore into the structure of ``like`` (tensors land on the devices of
    ``like``'s tensors).  Returns (tree, step).  With ``step=None`` the newest
    committed checkpoint is loaded, falling back step by step past corrupt
    payloads, each skip recorded in the global HealthReport."""
    if step is not None:
        return _restore_step(path, like, step), step
    steps = committed_steps(path)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint under {path}")
    last_err: Exception | None = None
    for i, s in enumerate(steps):
        try:
            return _restore_step(path, like, s), s
        except Exception as e:  # noqa: BLE001 — any undecodable payload falls back
            last_err = e
            from repro_torch.resilience.degrade import global_health

            nxt = f"step_{steps[i + 1]}" if i + 1 < len(steps) else "none"
            global_health().record("ckpt.restore", rung_from=f"step_{s}", rung_to=nxt,
                                   detail=repr(e))
    raise last_err


def committed_steps(path: str) -> list[int]:
    """All committed step numbers under ``path``, newest first."""
    if not os.path.isdir(path):
        return []
    steps = [int(n.split("_")[1]) for n in os.listdir(path)
             if n.startswith("step_") and not n.endswith(".tmp")
             and os.path.exists(os.path.join(path, n, _COMMIT))]
    return sorted(steps, reverse=True)


def sweep_stale(path: str) -> list[str]:
    """Remove step entries lacking the COMMIT marker (``.tmp`` leftovers of
    mid-write kills included).  Returns the removed names.  Not safe to run
    beside a live writer on the same directory."""
    if not os.path.isdir(path):
        return []
    removed = []
    for name in sorted(os.listdir(path)):
        p = os.path.join(path, name)
        if not name.startswith("step_") or not os.path.isdir(p):
            continue
        if not os.path.exists(os.path.join(p, _COMMIT)):
            shutil.rmtree(p, ignore_errors=True)
            removed.append(name)
    return removed


def latest_step(path: str, *, sweep: bool = True) -> int | None:
    """Newest committed step, or None; sweeps stale directories first by
    default."""
    if sweep:
        sweep_stale(path)
    steps = committed_steps(path)
    return steps[0] if steps else None


def read_meta(path: str, step: int) -> dict:
    """The meta.json of a committed step ({"step", "leaves", "extra"})."""
    with open(os.path.join(_step_dir(path, step), "meta.json")) as f:
        return json.load(f)


def retain(path: str, keep: int = 3) -> None:
    """Remove all but the newest ``keep`` committed checkpoints."""
    for s in committed_steps(path)[keep:]:
        shutil.rmtree(_step_dir(path, s), ignore_errors=True)
