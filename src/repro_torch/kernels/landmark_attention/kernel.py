"""Build, bind and launch the two CUDA kernels in
``csrc/landmark_attention.cu``.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into its own
plain C-ABI shared library beside the accum_apply one (``build/repro_torch/``,
named by a hash of the source and the flags), with the same builder, and
loaded with ``ctypes``.

Each launcher checks device, dtype, shape and contiguity, allocates its
outputs and its split scratch with ``torch.empty``, launches on PyTorch's
current stream, raises if the C entry returns a CUDA error, and counts its
launches in a plain integer attribute (``landmark_attention.launches``,
``landmark_stats.launches``).  Launch shapes are fixed functions of the
input shapes (``plan``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels.accum_apply.kernel import (
    _check,
    _cuda_device,
    _int32,
    _raise_on,
    _stream,
    build_source,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "landmark_attention.cu"
_TYPES = (torch.float32, torch.bfloat16)
# keys a tile, value columns a block, and the block count a launch aims for
# (four blocks for each of the H100's 132 SMs) — constants of the csrc
KEY_TILE, VALUE_TILE, TARGET_BLOCKS = 32, 128, 4 * 132
MAX_HEAD_DIM = 256   # shared memory: the block's query rows and a key tile

BUILD_INFO: dict = {}


def build() -> Path:
    """Compile ``csrc/landmark_attention.cu`` if it is not built yet."""
    return build_source(SOURCE, BUILD_INFO)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_landmark_attention.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                             I, I, F, I, P]
    lib.repro_landmark_stats.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                         I, I, I, F, I, P]
    for fn in (lib.repro_landmark_attention, lib.repro_landmark_stats):
        fn.restype = ctypes.c_int
    return lib


def plan(P: int, S: int, Lk: int, Dv: int, *, min_split: int = 1
         ) -> tuple[int, int, int]:
    """(bq, nsplit, tiles_per_split) of the online-softmax sweep: 8 query
    rows a block where S ≤ 8 (decode: G rows), else 64; the key axis split
    across blocks until the launch has ``TARGET_BLOCKS`` blocks (flash-
    decoding), and at least ``min_split`` ways."""
    bq = 8 if S <= 8 else 64
    ntiles = max(1, math.ceil(Lk / KEY_TILE))
    blocks = math.ceil(S / bq) * P * math.ceil(Dv / VALUE_TILE)
    want = min(ntiles, max(min_split, math.ceil(TARGET_BLOCKS / max(blocks, 1))))
    per = math.ceil(ntiles / want)
    return bq, math.ceil(ntiles / per), per


def _scratch(nsplit: int, rows: int, Dv: int, dev):
    if nsplit == 1:
        return None, None, None
    f32 = torch.float32
    return (torch.empty((nsplit, rows), dtype=f32, device=dev),
            torch.empty((nsplit, rows), dtype=f32, device=dev),
            torch.empty((nsplit, rows, Dv), dtype=f32, device=dev))


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _limits(P: int, rows: int, Dh: int, Dv: int) -> None:
    """What the launches can take: the head dim that fits shared memory,
    P × value chunks in grid.z, and P·rows (the combine's grid and row
    index) in an int."""
    if not 0 < Dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} outside the kernels' (0, {MAX_HEAD_DIM}]")
    if P * math.ceil(Dv / VALUE_TILE) > 65535:
        raise ValueError(f"{P} problems × {math.ceil(Dv / VALUE_TILE)} value chunks "
                         "exceed the grid's 65535 z-blocks")
    _int32(rows=P * rows)


def landmark_attention(q: torch.Tensor, kt: torch.Tensor, M: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q k̃ᵀ/√Dh + bias)·M on the card for P problems: q (P, S, Dh),
    kt (P, L, Dh), M (P, L, Dv), one dtype (float32 or bfloat16), bias
    (P, L) float32 or None.  Returns (P, S, Dv) in q's dtype, computed in
    float32.  Replaces LA:54."""
    dev = _cuda_device(q)
    P, S, Dh = q.shape
    L, Dv = M.shape[1:]
    _check("q", q, (P, S, Dh), _TYPES, dev)
    _check("kt", kt, (P, L, Dh), (q.dtype,), dev)
    _check("M", M, (P, L, Dv), (q.dtype,), dev)
    if bias is not None:
        _check("bias", bias, (P, L), (torch.float32,), dev)
    _limits(P, S, Dh, Dv)
    out = torch.empty((P, S, Dv), dtype=q.dtype, device=dev)
    if P == 0 or S == 0 or Dv == 0:
        return out
    if L == 0:
        raise ValueError("landmark_attention needs at least one landmark")
    bq, nsplit, per = plan(P, S, L, Dv)
    pm, pd, pacc = _scratch(nsplit, P * S, Dv, dev)
    with torch.cuda.device(dev):
        err = _lib().repro_landmark_attention(
            q.data_ptr(), kt.data_ptr(), M.data_ptr(), _ptr(bias), out.data_ptr(),
            _ptr(pm), _ptr(pd), _ptr(pacc), P, S, L, Dh, Dv, nsplit, per, bq,
            1.0 / math.sqrt(Dh), int(q.dtype == torch.bfloat16), _stream(dev))
    landmark_attention.launches += 1
    _raise_on(err, "landmark_attention")
    return out


def landmark_stats(qt: torch.Tensor, kt: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, *, n_valid: int | None = None,
                   l_valid: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, BmV) on the card for P problems: qt, kt (P, L, Dh), k (P, S, Dh),
    v (P, S, Dv), one dtype.  W = softmax(q̃k̃ᵀ/√Dh) with landmark columns
    ≥ ``l_valid`` masked; BmV = softmax(q̃Kᵀ/√Dh)·V with keys ≥ ``n_valid``
    masked (both default to the full extent).  Returns (W (P, L, L),
    BmV (P, L, Dv)) float32.  Replaces LA:138: W once per problem, then the
    sweep over S split across blocks and combined in split order."""
    dev = _cuda_device(qt)
    P, L, Dh = qt.shape
    S, Dv = v.shape[1:]
    _check("qt", qt, (P, L, Dh), _TYPES, dev)
    _check("kt", kt, (P, L, Dh), (qt.dtype,), dev)
    _check("k", k, (P, S, Dh), (qt.dtype,), dev)
    _check("v", v, (P, S, Dv), (qt.dtype,), dev)
    _limits(P, L, Dh, Dv)
    n_valid = S if n_valid is None else n_valid
    l_valid = L if l_valid is None else l_valid
    if not (0 < n_valid <= S and 0 < l_valid <= L):
        raise ValueError(f"need 0 < n_valid ≤ {S} and 0 < l_valid ≤ {L}, got "
                         f"{n_valid}, {l_valid}")
    W = torch.empty((P, L, L), dtype=torch.float32, device=dev)
    BmV = torch.empty((P, L, Dv), dtype=torch.float32, device=dev)
    if P == 0 or Dv == 0:
        return W, BmV
    _, nsplit, per = plan(P, L, S, Dv, min_split=2)
    pm, pd, pacc = _scratch(nsplit, P * L, Dv, dev)
    with torch.cuda.device(dev):
        err = _lib().repro_landmark_stats(
            qt.data_ptr(), kt.data_ptr(), k.data_ptr(), v.data_ptr(), W.data_ptr(),
            BmV.data_ptr(), _ptr(pm), _ptr(pd), _ptr(pacc), P, L, S, Dh, Dv, n_valid,
            l_valid, nsplit, per, 1.0 / math.sqrt(Dh),
            int(qt.dtype == torch.bfloat16), _stream(dev))
    landmark_stats.launches += 1
    _raise_on(err, "landmark_stats")
    return W, BmV


KERNELS = (landmark_attention, landmark_stats)


def reset_launches() -> None:
    """Set both kernels' launch counts to 0."""
    for fn in KERNELS:
        fn.launches = 0


reset_launches()
