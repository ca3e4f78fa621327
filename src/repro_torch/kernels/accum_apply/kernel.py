"""Build, bind and launch the seven entry points of ``csrc/accum_apply.cu``.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
plain C-ABI shared library under ``<repo>/build/repro_torch/`` (the path
comes from this file, not the working directory), named by a hash of the
source and the flags so that an edit rebuilds.  The library is loaded with
``ctypes``.

Each launcher checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream, raises if
the C entry returns a CUDA error, and counts its launches in a plain integer
attribute (``matfree_apply.launches`` and so on; ``autotune.count_launch``
counts launches made while the autotune cache times candidates apart).
Indices are taken as they come (checking them would wait for the device): an
index out of range reads nothing and gives NaN in the outputs it feeds.

``bm``, where a launcher takes it, is the rows a block takes: a launch
geometry the autotune cache chooses (``ops``), which changes neither a
thread's registers nor any sum's order.  The default is the static
geometry, ``autotune.STATIC_TABLE`` (``matfree_rows(n)`` for
``matfree_apply``); its 0 for the column gather leaves the rows to the body
the launch takes (csrc ``launch_gather``).  ``accum_apply_scalar`` takes no
rows: csrc ``scalar_rows`` sets them from R (``scalar_rows`` here asks it).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels.accum_apply import autotune

SOURCE = Path(__file__).resolve().parent / "csrc" / "accum_apply.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# a·bw for the kernels k = poly(a·r)·exp(−a·r) of r = ‖x − l‖
_SCALES = {("laplacian", None): 1.0, ("matern", 0.5): 1.0,
           ("matern", 1.5): math.sqrt(3.0), ("matern", 2.5): math.sqrt(5.0)}
# matfree shared memory: a block's column group is sized to fit 48 KB; one
# column's landmarks may take up to _MATFREE_SMEM (opted in above 48 KB)
_MATFREE_GROUP = 48 * 1024
_MATFREE_SMEM = 200 * 1024
_TYPES = (torch.float32, torch.bfloat16)

# set by build(): seconds the last compile took (0.0 when the library was
# already on disk) and what ptxas said about registers and shared memory
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                           "CUDA toolkit's nvcc (PATH or /usr/local/cuda/bin)")
    return found


@functools.cache
def source_hash(source: Path = SOURCE) -> str:
    """16 hex digits of the sha256 of ``source`` and the nvcc flags.  It
    names the built library, and the autotune cache keys its kernels'
    entries by it, so that a geometry measured on one version of a kernel
    never serves another (read once a process, as the library is loaded
    once)."""
    h = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(source: Path = SOURCE) -> Path:
    """Where the built library for ``source`` and the flags lives."""
    return BUILD_DIR / f"lib{source.stem}-{source_hash(source)}.so"


def build_source(source: Path, info: dict) -> Path:
    """Compile ``source`` if its library is not built yet.

    Writes to a temporary name and renames, so concurrent builders never
    load a half-written library.  ``info`` receives the seconds the compile
    took (0.0 when the library was on disk), the path, and ptxas's
    per-kernel register, spill and shared-memory report (``"ptxas"``); a
    later call for the same library keeps the report of the build."""
    out = library_path(source)
    if out.exists():
        if info.get("path") != str(out):
            info.update(seconds=0.0, path=str(out), ptxas="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    info.update(seconds=time.perf_counter() - t0, path=str(out),
                ptxas=proc.stderr)
    return out


def build() -> Path:
    """Compile ``csrc/accum_apply.cu`` if it is not built yet (``BUILD_INFO``)."""
    return build_source(SOURCE, BUILD_INFO)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_matfree_apply.argtypes = [P, P, P, P, I, I, I, I, I, I, F, F, F, I, I, P]
    lib.repro_accum_apply_left.argtypes = [P, P, P, P, I, I, I, I, I, P]
    lib.repro_accum_sketch_both.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, P]
    lib.repro_accum_apply.argtypes = [P, P, P, P, I, I, I, I, I, I, P]
    lib.repro_accum_step_slab.argtypes = [P, P, P, P, F, P, I, I, I, I, I, P]
    lib.repro_accum_grow_slabs.argtypes = [P, P, P, P, F, P, P, P, P, I, I, I, I, I, I, P]
    lib.repro_accum_apply_scalar.argtypes = [P, P, P, P, I, I, I, I, I, P]
    lib.repro_accum_apply_scalar_rows.argtypes = [I, I, I]
    for fn in (lib.repro_matfree_apply, lib.repro_accum_apply_left,
               lib.repro_accum_sketch_both, lib.repro_accum_apply,
               lib.repro_accum_step_slab, lib.repro_accum_grow_slabs,
               lib.repro_accum_apply_scalar, lib.repro_accum_apply_scalar_rows):
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, dtypes, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {t.device}")
    return t.device


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _int32(**dims: int) -> None:
    for name, v in dims.items():
        if not 0 <= v < 2**31:
            raise ValueError(f"{name}={v} does not fit the kernels' int sizes")


def _rows(bm: int | None, kind: str) -> int:
    """The rows a block takes: ``bm``, or the kind's static geometry; 0
    gives the column gather's body its own default (csrc ``launch_gather``).
    A row count changes only the grid (and the register gather's warps a
    block), so any one fits the device."""
    bm = autotune.STATIC_TABLE[kind][0] if bm is None else int(bm)
    if bm < 0:
        raise ValueError(f"bm={bm}: a block cannot take fewer than 0 rows")
    return bm


class MatfreeFold(NamedTuple):
    """The constants of ``matfree_apply``'s restated kernel, in float64 (the
    launch rounds each to float32 once).  Both points are multiplied by
    ``scale``, so their squared distance is q = scale²·d2: the Gaussian is
    2^(−q); the others take s = −√q and give (1 + p1·s + p2·s²)·2^s."""
    gauss: bool
    scale: float
    p1: float
    p2: float


def matfree_fold(kernel: str, bandwidth: float = 1.0, nu: float = 1.5) -> MatfreeFold:
    """The restated constants of a (kernel, bandwidth, nu) triple.

    Gaussian: exp(−d2/(2bw²)) = 2^(−q) with scale² = log2(e)/(2bw²).  The
    others are poly(a·r)·exp(−a·r) in r = √d2, a = (1, 1, √3, √5)/bw for
    Laplacian and Matérn ν = 0.5, 1.5, 2.5: with scale = log2(e)·a,
    exp(−a·r) = 2^s for s = −√q, and the prefactor 1 + a·r (+ (a·r)²/3 for
    ν = 2.5) is 1 − ln2·s (+ (ln2·s)²/3)."""
    if kernel == "gaussian":
        return MatfreeFold(True, math.sqrt(math.log2(math.e) / 2.0) / float(bandwidth),
                           0.0, 0.0)
    key = (kernel, float(nu) if kernel == "matern" else None)
    if key not in _SCALES:
        raise ValueError(f"unsupported kernel {kernel!r} (nu={nu})")
    ln2 = math.log(2.0)
    p1 = -ln2 if _SCALES[key] > 1.0 else 0.0
    p2 = ln2 * ln2 / 3.0 if key == ("matern", 2.5) else 0.0
    return MatfreeFold(False, math.log2(math.e) * _SCALES[key] / float(bandwidth), p1, p2)


def matfree_rows(n: int) -> int:
    """Rows of X a block of ``matfree_apply`` takes by default: 512, since
    each block stores its landmarks once and more rows spread that cost
    (64 → 512 rows: 0.357 → 0.315 ms at n = 2²¹ on an H100, PERF.md §6),
    halved down to the static table's 64 while the grid would hold fewer
    than 1024 blocks."""
    rows = 512
    while rows > autotune.STATIC_TABLE["matfree_cols"][0] and n < 1024 * rows:
        rows //= 2
    return rows


def matfree_floats(p: int) -> int:
    """Floats of shared memory a landmark takes in ``matfree_apply``: one
    float4 record (p ≤ 3) or two (p ≤ 7) and its coefficient; for larger p,
    p transposed weights, ‖l‖² and the coefficient (csrc
    ``matfree_quads``)."""
    return 5 if p <= 3 else 9 if p <= 7 else p + 2


def matfree_apply(X: torch.Tensor, L: torch.Tensor, coef: torch.Tensor, *,
                  kernel: str, bandwidth: float = 1.0, nu: float = 1.5,
                  bm: int | None = None) -> torch.Tensor:
    """C = K(X, L)·S on the card; X (n, p) and L (m·d, p) float32 or
    bfloat16 of one dtype, coef (m, d) float32; ``bm`` rows of X a block
    (default ``matfree_rows(n)``).  Returns (n, d) float32.

    Replaces AA:474 ``matfree_apply``; landmark row i·d + j belongs to
    column j of slab i, as in ``ops.expand_coef`` of the reference."""
    dev = _cuda_device(X)
    n, p = X.shape
    m, d = coef.shape
    _check("X", X, (n, p), _TYPES, dev)
    _check("L", L, (m * d, p), (X.dtype,), dev)
    _check("coef", coef, (m, d), (torch.float32,), dev)
    fold = matfree_fold(kernel, bandwidth, nu)
    per_col = m * matfree_floats(p) * 4
    if per_col > _MATFREE_SMEM:
        raise ValueError(f"{per_col} B of landmarks per output column exceeds "
                         f"the {_MATFREE_SMEM} B shared-memory budget of the "
                         "matfree kernel")
    jc = max(1, min(d, _MATFREE_GROUP // per_col))
    rows = matfree_rows(n) if bm is None else _rows(bm, "matfree_cols")
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return out
    _int32(n=n, p=p, md=m * d)
    with torch.cuda.device(dev), autotune.launch_range(matfree_apply):
        err = _lib().repro_matfree_apply(
            X.data_ptr(), L.data_ptr(), coef.data_ptr(), out.data_ptr(), n, p,
            m, d, jc, int(fold.gauss), fold.scale, fold.p1, fold.p2, rows,
            int(X.dtype == torch.bfloat16), _stream(dev))
    autotune.count_launch(matfree_apply)
    _raise_on(err, "matfree_apply")
    return out


def accum_apply_left(M: torch.Tensor, idx: torch.Tensor,
                     coef: torch.Tensor) -> torch.Tensor:
    """Sᵀ M on the card; M (N, c) float32 or bfloat16, idx (m, d) int32,
    coef (m, d) float32.  Returns (d, c) float32.  Replaces AA:229."""
    dev = _cuda_device(M)
    N, c = M.shape
    m, d = idx.shape
    _check("M", M, (N, c), _TYPES, dev)
    _check("idx", idx, (m, d), (torch.int32,), dev)
    _check("coef", coef, (m, d), (torch.float32,), dev)
    out = torch.empty((d, c), dtype=torch.float32, device=dev)
    if d == 0 or c == 0:
        return out
    _int32(N=N, c=c, md=m * d)
    with torch.cuda.device(dev), autotune.launch_range(accum_apply_left):
        err = _lib().repro_accum_apply_left(
            M.data_ptr(), idx.data_ptr(), coef.data_ptr(), out.data_ptr(), N,
            c, m, d, int(M.dtype == torch.bfloat16), _stream(dev))
    autotune.count_launch(accum_apply_left)
    _raise_on(err, "accum_apply_left")
    return out


def gather_plan(idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The order in which each block of the sorted column gather (csrc
    ``sketch_gather_kernel``, GATHER_SORTED_MIN ≤ m·d ≤ GATHER_SORTED_MAX)
    loads a row's sampled columns: its bitonic network over the keys
    (column as unsigned 32-bit, then slot i·d + j), padded to a power of
    two, step for step.
    Returns (columns as int64, slots), each (m·d,): the k-th load of a row
    reads K[r, columns[k]] into slot slots[k].  A column at or above N (a
    negative index reads as one above 2³¹) is not loaded; its slot gives NaN.
    The plan depends on idx alone."""
    md = idx.numel()
    np2 = 1 << max(0, (md - 1).bit_length())
    col = torch.full((np2,), 2**32, dtype=torch.int64)
    col[:md] = idx.reshape(-1).cpu().to(torch.int64) & 0xFFFFFFFF
    key = col * np2 + torch.arange(np2)      # (column, slot), lexicographic
    t = torch.arange(np2)
    k = 2
    while k <= np2:
        j = k >> 1
        while j > 0:
            lo = t[(t ^ j) > t]
            hi = lo ^ j
            x, y = key[lo], key[hi]
            swap = (x > y) == ((lo & k) == 0)
            key[lo], key[hi] = torch.where(swap, y, x), torch.where(swap, x, y)
            j >>= 1
        k <<= 1
    return key[:md] // np2, key[:md] % np2


def accum_sketch_both(K: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor, *,
                      bm: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, W) = (K S, SᵀC) on the card for square K (n, n) float32 or
    bfloat16; W folds from the float32 C; ``bm`` rows a block of the gather.
    Returns (C in K's dtype, W float32).  Replaces AA:164; two launches
    (gather, then left apply)."""
    dev = _cuda_device(K)
    n = K.shape[0]
    m, d = idx.shape
    _check("K", K, (n, n), _TYPES, dev)
    _check("idx", idx, (m, d), (torch.int32,), dev)
    _check("coef", coef, (m, d), (torch.float32,), dev)
    C32 = torch.empty((n, d), dtype=torch.float32, device=dev)
    W = torch.empty((d, d), dtype=torch.float32, device=dev)
    bf16 = K.dtype == torch.bfloat16
    C = torch.empty((n, d), dtype=K.dtype, device=dev) if bf16 else C32
    rows = _rows(bm, "sketch_both")
    if n == 0 or d == 0:
        return C, W.zero_()
    _int32(n=n, md=m * d)
    with torch.cuda.device(dev), autotune.launch_range(accum_sketch_both):
        err = _lib().repro_accum_sketch_both(
            K.data_ptr(), idx.data_ptr(), coef.data_ptr(), C32.data_ptr(),
            C.data_ptr() if bf16 else None, W.data_ptr(), n, n, m, d, rows,
            int(bf16), _stream(dev))
    autotune.count_launch(accum_sketch_both)
    _raise_on(err, "accum_sketch_both")
    return C, W


def accum_apply(K: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor, *,
                bm: int | None = None) -> torch.Tensor:
    """K S on the card for K (R, N) float32 or bfloat16, idx (m, d) int32,
    coef (m, d) float32, ``bm`` rows a block.  Returns (R, d) in K's dtype,
    summed in float32.  Replaces AA:84; one launch for any N."""
    dev = _cuda_device(K)
    R, N = K.shape
    m, d = idx.shape
    _check("K", K, (R, N), _TYPES, dev)
    _check("idx", idx, (m, d), (torch.int32,), dev)
    _check("coef", coef, (m, d), (torch.float32,), dev)
    out = torch.empty((R, d), dtype=K.dtype, device=dev)
    rows = _rows(bm, "accum_apply")
    if R == 0 or d == 0:
        return out
    _int32(R=R, N=N, md=m * d)
    with torch.cuda.device(dev), autotune.launch_range(accum_apply):
        err = _lib().repro_accum_apply(
            K.data_ptr(), idx.data_ptr(), coef.data_ptr(), out.data_ptr(), R, N,
            m, d, rows, int(K.dtype == torch.bfloat16), _stream(dev))
    autotune.count_launch(accum_apply)
    _raise_on(err, "accum_apply")
    return out


def accum_step_slab(K: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor,
                    Cin: torch.Tensor, a: float, *,
                    bm: int | None = None) -> torch.Tensor:
    """a·Cin + K·T̃ on the card for one slab: K (R, N) float32 or bfloat16,
    idx (1, d) int32, coef (1, d) float32, Cin (R, d) float32, ``a`` by
    value, ``bm`` rows a block.  Returns (R, d) float32.  Replaces AA:277."""
    dev = _cuda_device(K)
    R, N = K.shape
    d = idx.shape[1]
    _check("K", K, (R, N), _TYPES, dev)
    _check("idx", idx, (1, d), (torch.int32,), dev)
    _check("coef", coef, (1, d), (torch.float32,), dev)
    _check("Cin", Cin, (R, d), (torch.float32,), dev)
    out = torch.empty((R, d), dtype=torch.float32, device=dev)
    rows = _rows(bm, "accum_apply")
    if R == 0 or d == 0:
        return out
    _int32(R=R, N=N, d=d)
    with torch.cuda.device(dev), autotune.launch_range(accum_step_slab):
        err = _lib().repro_accum_step_slab(
            K.data_ptr(), idx.data_ptr(), coef.data_ptr(), Cin.data_ptr(),
            float(a), out.data_ptr(), R, N, d, rows, int(K.dtype == torch.bfloat16),
            _stream(dev))
    autotune.count_launch(accum_step_slab)
    _raise_on(err, "accum_step_slab")
    return out


def accum_grow_slabs(K: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor,
                     Cin: torch.Tensor, a: float, *,
                     out: torch.Tensor | None = None, bm: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(C_new, TᵀG, TᵀC) on the card for the B-slab block T: K (R, N) float32
    or bfloat16, idx (B, d) int32 with every index < R, coef (B, d) float32,
    Cin (R, d) float32, ``a`` by value, ``bm`` rows a block of the gather.
    C_new = a·Cin + G with G = K·T, all three float32.  ``out`` receives
    C_new and may be ``Cin`` itself: TᵀC is read from Cin before anything is
    written.  Replaces AA:370."""
    dev = _cuda_device(K)
    R, N = K.shape
    B, d = idx.shape
    _check("K", K, (R, N), _TYPES, dev)
    _check("idx", idx, (B, d), (torch.int32,), dev)
    _check("coef", coef, (B, d), (torch.float32,), dev)
    _check("Cin", Cin, (R, d), (torch.float32,), dev)
    if out is None:
        out = torch.empty((R, d), dtype=torch.float32, device=dev)
    else:
        _check("out", out, (R, d), (torch.float32,), dev)
    TtG = torch.empty((d, d), dtype=torch.float32, device=dev)
    TtC = torch.empty((d, d), dtype=torch.float32, device=dev)
    rows = _rows(bm, "accum_grow")
    if R == 0 or d == 0:
        return out, TtG.zero_(), TtC.zero_()
    G32 = torch.empty((R, d), dtype=torch.float32, device=dev)
    _int32(R=R, N=N, Bd=B * d)
    with torch.cuda.device(dev), autotune.launch_range(accum_grow_slabs):
        err = _lib().repro_accum_grow_slabs(
            K.data_ptr(), idx.data_ptr(), coef.data_ptr(), Cin.data_ptr(),
            float(a), out.data_ptr(), G32.data_ptr(), TtG.data_ptr(),
            TtC.data_ptr(), R, N, B, d, rows, int(K.dtype == torch.bfloat16),
            _stream(dev))
    autotune.count_launch(accum_grow_slabs)
    _raise_on(err, "accum_grow_slabs")
    return out, TtG, TtC


def accum_apply_scalar(K: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor, *,
                       bm: int = 256, bd: int = 8) -> torch.Tensor:
    """K S on the card for K (R, N) float32 or bfloat16, idx (m, d) int32,
    coef (m, d) float32.  Returns (R, d) in K's dtype, summed in float32 in
    the seed loop's order.  ``bm`` and ``bd`` are clipped to (R, d) and
    checked as the reference asserts them (``ValueError`` where they do not
    divide); the launch is the column gather's, at rows a block from a fixed
    rule on R (``scalar_rows``), with no autotune.  Replaces AA:529."""
    dev = _cuda_device(K)
    R, N = K.shape
    m, d = idx.shape
    _check("K", K, (R, N), _TYPES, dev)
    _check("idx", idx, (m, d), (torch.int32,), dev)
    _check("coef", coef, (m, d), (torch.float32,), dev)
    scalar_blocks(R, d, bm, bd)
    out = torch.empty((R, d), dtype=K.dtype, device=dev)
    _int32(R=R, N=N, md=m * d)
    with torch.cuda.device(dev), autotune.launch_range(accum_apply_scalar):
        err = _lib().repro_accum_apply_scalar(
            K.data_ptr(), idx.data_ptr(), coef.data_ptr(), out.data_ptr(), R, N,
            m, d, int(K.dtype == torch.bfloat16), _stream(dev))
    autotune.count_launch(accum_apply_scalar)
    _raise_on(err, "accum_apply_scalar")
    return out


def scalar_rows(R: int, m: int, d: int) -> int:
    """Rows a block of ``accum_apply_scalar`` at (R, m, d): csrc
    ``scalar_rows``, asked through the built library."""
    return _lib().repro_accum_apply_scalar_rows(R, m, d)


def scalar_blocks(R: int, d: int, bm: int, bd: int) -> tuple[int, int]:
    """(bm, bd) of ``accum_apply_scalar`` clipped to (R, d), as the
    reference clips them; raises ``ValueError`` where they do not divide
    (R, d), where the reference's assert fails."""
    bm, bd = min(bm, R), min(bd, d)
    if bm < 1 or bd < 1 or R % bm or d % bd:
        raise ValueError(f"accum_apply_scalar needs R % bm == 0 and d % bd == 0 "
                         f"after clipping: R={R}, bm={bm}, d={d}, bd={bd}")
    return bm, bd


KERNELS = (matfree_apply, accum_apply_left, accum_sketch_both, accum_apply,
           accum_step_slab, accum_grow_slabs, accum_apply_scalar)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


reset_launches()
