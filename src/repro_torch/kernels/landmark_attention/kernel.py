"""Build, bind and launch the two CUDA kernels in
``csrc/landmark_attention.cu``.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into its own
plain C-ABI shared library beside the accum_apply one (``build/repro_torch/``,
named by a hash of the source and the flags), with the same builder, and
loaded with ``ctypes``.

Each launcher checks device, dtype, shape and contiguity, allocates its
outputs and its split scratch (one ``torch.empty``), launches on PyTorch's
current stream, raises if the C entry returns a CUDA error, and counts its
launches in a plain integer attribute (``landmark_attention.launches``,
``landmark_stats.launches``; launches made while the autotune cache times
candidates are counted apart, ``autotune.count_launch``).

Two sweeps, by the rows S of a problem.  S ≤ 8 (decode) takes the
byte-bound decode sweep: all S rows in every warp, ``DECODE_WARPS`` warps a
block, each warp a run of keys read a row at a time, the splits combined by
the last block to arrive — one launch, with the arrival counters of
``_arrivals``.  S > 8 takes the tensor-core sweep (3×TF32) at 64 or 128 rows
a block and ``key_tile`` keys a tile, its splits combined by a second
launch.  Launch geometry: the key partition is a function of the input
shapes alone (``key_tile``, ``plan``); the rows a block
(``bq``, ``bs``, among ``block_rows(S)``: 8 alone on the decode sweep) are
the autotune cache's to choose (``ops``), and never change a sum's order.
``fits`` says whether a candidate can launch on the device.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels.accum_apply import autotune
from repro_torch.kernels.accum_apply.kernel import (
    _check,
    _cuda_device,
    _int32,
    _raise_on,
    build_source,
)
from repro_torch.kernels.accum_apply.kernel import source_hash as _source_hash

SOURCE = Path(__file__).resolve().parent / "csrc" / "landmark_attention.cu"
_TYPES = (torch.float32, torch.bfloat16)
# value columns a block, and the block count a launch aims for (four blocks
# for each of the H100's 132 SMs) — constants of the csrc
VALUE_TILE, TARGET_BLOCKS = 128, 4 * 132
# blocks a launch of the decode sweep aims for: two 8-warp blocks an SM
# (0.0125 ms against 0.0142 at one and 0.0169 at four, at the decode shape
# on an H100: scripts/bench_landmark.py --decode --plans)
DECODE_TARGET_BLOCKS = 2 * 132
MAX_HEAD_DIM = 256   # shared memory: the block's query rows and a key tile
# the rows a block the csrc instantiates: the decode sweep's (S ≤ 8: all of a
# problem's rows) and the tensor-core sweep's (4 or 8 warps of 16 rows)
DECODE_ROWS, SWEEP_ROWS = (8,), (64, 128)
BLOCK_ROWS = DECODE_ROWS + SWEEP_ROWS
# the decode sweep's partition: warps a block (at most the csrc's
# kDecodeMaxWarps), the unit of a warp's run of keys (every batch size
# divides it) and the most splits a launch takes (kDecodeMaxSplits: the last
# block stages every split's maxima in shared memory)
DECODE_WARPS, DECODE_RUN, DECODE_MAX_SPLITS = 8, 8, 64

BUILD_INFO: dict = {}
# the decode sweep's arrival counters, by (device index, stream)
_ARRIVALS: dict[tuple[int, int], torch.Tensor] = {}


def build() -> Path:
    """Compile ``csrc/landmark_attention.cu`` if it is not built yet."""
    return build_source(SOURCE, BUILD_INFO)


def source_hash() -> str:
    """The hash of ``csrc/landmark_attention.cu`` and the nvcc flags, which
    names its library and versions its autotune cache entries."""
    return _source_hash(SOURCE)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_landmark_attention.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I,
                                             I, I, I, I, F, I, P]
    lib.repro_landmark_stats.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                         I, I, I, I, I, F, I, P]
    lib.repro_landmark_check.argtypes = [I, I, I, P]
    for fn in (lib.repro_landmark_attention, lib.repro_landmark_stats,
               lib.repro_landmark_check):
        fn.restype = ctypes.c_int
    return lib


def block_rows(S: int) -> tuple[int, ...]:
    """The rows a block a sweep over S rows a problem can take."""
    return DECODE_ROWS if S <= 8 else SWEEP_ROWS


def static_bq(S: int, kind: str = "landmark_attention") -> int:
    """The rows a block of the static geometry: 8 where S ≤ 8 (decode: all
    of a problem's rows), else ``STATIC_TABLE[kind]``."""
    return DECODE_ROWS[0] if S <= 8 else autotune.STATIC_TABLE[kind][0]


def decode_rows(S: int) -> int:
    """The query rows the decode sweep holds for S ≤ 8 rows a problem: S
    rounded up to 1, 2, 4 or 8 (the csrc's instantiations)."""
    return 1 << max(S - 1, 0).bit_length()


def decode_batch(S: int, Dh: int) -> int:
    """Keys a warp of the decode sweep reads at once (the csrc's
    ``decode_batch_of``): at most 8 float4 registers of key rows a lane
    (4 keys where Dh > 128) and 32 dot products (U·G ≤ 32), and 2 where
    the lane holds 8 rows' queries and accumulators."""
    rows, halves = decode_rows(S), 2 if Dh > 128 else 1
    return 2 if rows == 8 else min(8 // halves, 32 // rows)


def key_tile(S: int, Dh: int, dtype: torch.dtype) -> int:
    """Keys a tile of the sweep over S rows a problem: on the decode sweep
    the keys a warp reads at once (``decode_batch``); on the tensor-core
    sweep 64 unless a float32 head dim above 192 (padded to 8) would
    overflow shared memory at 64 rows a block — the csrc's
    ``mma_key_tile``.  A function of the shape alone."""
    if S <= 8:
        return decode_batch(S, Dh)
    wide = dtype == torch.bfloat16 or -(-Dh // 8) * 8 <= 192
    return 64 if wide else 32


def plan(P: int, S: int, Lk: int, Dv: int, Dh: int, dtype: torch.dtype, *,
         min_split: int = 1) -> tuple[int, int]:
    """(nsplit, per) of the online-softmax sweep over Lk keys, a function of
    the shape alone, so every row's keys are summed in the same pieces
    whatever rows a block the launch takes.

    The key axis is split across blocks until a launch has about
    ``TARGET_BLOCKS`` blocks (flash-decoding), and at least ``min_split``
    ways where there are keys enough.  On the decode sweep (S ≤ 8) ``per``
    is the run of keys a warp walks, a multiple of ``DECODE_RUN``: split s
    takes keys [s·W·per, (s+1)·W·per) with W = ``DECODE_WARPS``, warp w of
    it the ``per`` keys from (s·W + w)·per (the csrc's rule), in at most
    ``DECODE_MAX_SPLITS`` splits; it depends on neither Dh nor the dtype.
    On the tensor-core sweep ``per`` counts tiles of ``key_tile`` keys a
    split, at ``static_bq(S)`` rows a block."""
    chunks = math.ceil(Dv / VALUE_TILE)
    if S <= 8:
        unit = DECODE_WARPS * DECODE_RUN
        want = max(min_split, math.ceil(DECODE_TARGET_BLOCKS / max(P * chunks, 1)))
        want = min(want, DECODE_MAX_SPLITS, max(1, math.ceil(Lk / unit)))
        run = math.ceil(Lk / (want * unit)) * DECODE_RUN
        return math.ceil(Lk / (DECODE_WARPS * run)), run
    ntiles = max(1, math.ceil(Lk / key_tile(S, Dh, dtype)))
    blocks = math.ceil(S / static_bq(S)) * P * chunks
    want = min(ntiles, max(min_split, math.ceil(TARGET_BLOCKS / max(blocks, 1))))
    per = math.ceil(ntiles / want)
    return math.ceil(ntiles / per), per


@functools.cache
def _fits(bq: int, Dh: int, variant: int, device_index: int) -> bool:
    flag = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _raise_on(_lib().repro_landmark_check(bq, Dh, variant, ctypes.byref(flag)),
                  "repro_landmark_check")
    return bool(flag.value)


def fits(bq: int, Dh: int, dtype: torch.dtype, out_dtype: torch.dtype,
         device: torch.device) -> bool:
    """Whether the sweep with ``bq`` rows a block (one of ``BLOCK_ROWS``)
    can launch on ``device`` for head dim Dh and these input and output
    dtypes, at the key tile of the shape: its shared memory within the
    device's opt-in limit and its registers leaving room for the block's
    threads (``cudaFuncGetAttributes``)."""
    if bq not in BLOCK_ROWS:
        return False
    variant = 0 if dtype == torch.float32 else (1 if out_dtype == dtype else 2)
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    return _fits(bq, Dh, variant, index)


def static_rows(S: int, Dh: int, dtype: torch.dtype, out_dtype: torch.dtype,
                device: torch.device, kind: str = "landmark_attention") -> int:
    """The static geometry where it can launch on ``device`` (``fits``),
    else the first of ``block_rows(S)`` that can: a float32 head dim above
    192 takes 64 rows a block, its 128 overflowing shared memory."""
    for b in (static_bq(S, kind), *block_rows(S)):
        if fits(b, Dh, dtype, out_dtype, device):
            return b
    raise ValueError(f"no geometry of the sweep over {S} rows fits head dim {Dh} "
                     f"({dtype} in, {out_dtype} out) on {device}")


def _block_rows(b: int, S: int, name: str) -> int:
    if b not in block_rows(S):
        raise ValueError(f"{name}={b}: a sweep over {S} rows a problem takes "
                         f"{block_rows(S)} rows a block")
    return b


def _arrivals(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters of the decode sweep for
    ``stream`` on ``dev``, all 0: each launch's last block resets the
    counters it used, so one buffer serves every launch on the stream (its
    launches run in order).  Allocated zeroed at the first call, or anew
    when a launch needs more."""
    key = (dev.index, stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < n:
        buf = _ARRIVALS[key] = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
    return buf


def _workspace(P: int, S: int, Dv: int, nsplit: int, dev, stream: int):
    """The split partials' scratch and the arrival counters of a sweep over
    S rows a problem; (None, None) for one split.  The decode sweep writes
    a partial of ``decode_rows(S)`` × (128 + 2) floats for every (problem,
    value chunk, split) and combines them in its own launch; the
    tensor-core sweep writes maxima and denominators (nsplit, P, S) and
    accumulators (nsplit, P, S, Dv) for its combine launch."""
    if nsplit == 1:
        return None, None
    chunks = math.ceil(Dv / VALUE_TILE)
    if S <= 8:
        n = P * chunks * nsplit * decode_rows(S) * (VALUE_TILE + 2)
        return (torch.empty(n, dtype=torch.float32, device=dev),
                _arrivals(dev, stream, P * chunks))
    return torch.empty(nsplit * P * S * (Dv + 2), dtype=torch.float32, device=dev), None


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
                       bias: torch.Tensor | None = None, *,
                       bq: int | None = None, lse: bool = False):
    """softmax(q k̃ᵀ/√Dh + bias)·M on the card for P problems: q (P, S, Dh),
    kt (P, L, Dh), M (P, L, Dv), one dtype (float32 or bfloat16), bias
    (P, L) float32 or None; ``bq`` query rows a block (default
    ``static_rows``).  Returns (P, S, Dv) in q's dtype, computed in
    float32; with ``lse`` (the decode sweep's alone, S ≤ 8) also each row's
    log-sum-exp of its logits, (P, S) float32, written by the same launch
    (no bit of the output changes).  Replaces LA:54."""
    dev = _cuda_device(q)
    P, S, Dh = q.shape
    L, Dv = M.shape[1:]
    _check("q", q, (P, S, Dh), _TYPES, dev)
    _check("kt", kt, (P, L, Dh), (q.dtype,), dev)
    _check("M", M, (P, L, Dv), (q.dtype,), dev)
    if bias is not None:
        _check("bias", bias, (P, L), (torch.float32,), dev)
    _limits(P, S, Dh, Dv)
    if bq is None:
        bq = static_rows(S, Dh, q.dtype, q.dtype, dev)
    bq = _block_rows(bq, S, "bq")
    if lse and S > 8:
        raise ValueError(f"the log-sum-exp output is the decode sweep's (S ≤ 8), not S={S}")
    out = torch.empty((P, S, Dv), dtype=q.dtype, device=dev)
    rows = torch.empty((P, S), dtype=torch.float32, device=dev) if lse else None
    if P == 0 or S == 0 or Dv == 0:
        return (out, rows) if lse else out
    if L == 0:
        raise ValueError("landmark_attention needs at least one landmark")
    nsplit, per = plan(P, S, L, Dv, Dh, q.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch, arrivals = _workspace(P, S, Dv, nsplit, dev, stream)
    with torch.cuda.device(dev), autotune.launch_range(landmark_attention):
        err = _lib().repro_landmark_attention(
            q.data_ptr(), kt.data_ptr(), M.data_ptr(), _ptr(bias), out.data_ptr(),
            _ptr(rows), _ptr(scratch), _ptr(arrivals), P, S, L, Dh, Dv, nsplit, per,
            DECODE_WARPS, bq, 1.0 / math.sqrt(Dh), int(q.dtype == torch.bfloat16), stream)
    autotune.count_launch(landmark_attention)
    _raise_on(err, "landmark_attention")
    return (out, rows) if lse else out


def landmark_stats(qt: torch.Tensor, kt: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, *, n_valid: int | None = None,
                   l_valid: int | None = None, bs: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, BmV) on the card for P problems: qt, kt (P, L, Dh), k (P, S, Dh),
    v (P, S, Dv), one dtype.  W = softmax(q̃k̃ᵀ/√Dh) with landmark columns
    ≥ ``l_valid`` masked; BmV = softmax(q̃Kᵀ/√Dh)·V with keys ≥ ``n_valid``
    masked (both default to the full extent); ``bs`` landmark rows a block
    of the BmV sweep (default ``static_rows``).  Returns (W (P, L, L),
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
    if bs is None:
        bs = static_rows(L, Dh, qt.dtype, torch.float32, dev, "landmark_stats")
    bs = _block_rows(bs, L, "bs")
    W = torch.empty((P, L, L), dtype=torch.float32, device=dev)
    BmV = torch.empty((P, L, Dv), dtype=torch.float32, device=dev)
    if P == 0 or Dv == 0:
        return W, BmV
    nsplit, per = plan(P, L, S, Dv, Dh, qt.dtype, min_split=2)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch, arrivals = _workspace(P, L, Dv, nsplit, dev, stream)
    with torch.cuda.device(dev), autotune.launch_range(landmark_stats):
        err = _lib().repro_landmark_stats(
            qt.data_ptr(), kt.data_ptr(), k.data_ptr(), v.data_ptr(), W.data_ptr(),
            BmV.data_ptr(), _ptr(scratch), _ptr(arrivals), P, L, S, Dh, Dv, n_valid,
            l_valid, nsplit, per, DECODE_WARPS, bs, 1.0 / math.sqrt(Dh),
            int(qt.dtype == torch.bfloat16), stream)
    autotune.count_launch(landmark_stats)
    _raise_on(err, "landmark_stats")
    return W, BmV


KERNELS = (landmark_attention, landmark_stats)


def reset_launches() -> None:
    """Set both kernels' launch counts to 0."""
    for fn in KERNELS:
        fn.launches = 0


reset_launches()
