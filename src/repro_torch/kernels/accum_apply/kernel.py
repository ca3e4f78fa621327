"""Build, bind and launch the six CUDA kernels in ``csrc/accum_apply.cu``.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
plain C-ABI shared library under ``<repo>/build/repro_torch/`` (the path
comes from this file, not the working directory), named by a hash of the
source and the flags so that an edit rebuilds.  The library is loaded with
``ctypes``.

Each launcher checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream, raises if
the C entry returns a CUDA error, and counts its launches in a plain integer
attribute (``matfree_apply.launches`` and so on).  Indices are taken as they
come (checking them would wait for the device): an index out of range reads
nothing and gives NaN in the outputs it feeds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "accum_apply.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel-kind codes shared with csrc (enum KernelKind)
_KINDS = {("gaussian", None): 0, ("laplacian", None): 1, ("matern", 0.5): 2,
          ("matern", 1.5): 3, ("matern", 2.5): 4}
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


def library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libaccum_apply-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the library for this source is not built yet.

    Writes to a temporary name and renames, so concurrent builders never
    load a half-written library.  ``BUILD_INFO["ptxas"]`` keeps ptxas's
    per-kernel register, spill and shared-memory report of this build."""
    out = library_path()
    if out.exists():
        BUILD_INFO.update(seconds=0.0, path=str(out), ptxas="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(out),
                      ptxas=proc.stderr)
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_matfree_apply.argtypes = [P, P, P, P, I, I, I, I, I, I, F, F, I, P]
    lib.repro_accum_apply_left.argtypes = [P, P, P, P, I, I, I, I, I, P]
    lib.repro_accum_sketch_both.argtypes = [P, P, P, P, P, P, I, I, I, I, I, P]
    lib.repro_accum_apply.argtypes = [P, P, P, P, I, I, I, I, I, P]
    lib.repro_accum_step_slab.argtypes = [P, P, P, P, F, P, I, I, I, I, P]
    lib.repro_accum_grow_slabs.argtypes = [P, P, P, P, F, P, P, P, P, I, I, I, I, I, P]
    for fn in (lib.repro_matfree_apply, lib.repro_accum_apply_left,
               lib.repro_accum_sketch_both, lib.repro_accum_apply,
               lib.repro_accum_step_slab, lib.repro_accum_grow_slabs):
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


def _kernel_kind(kernel: str, nu: float) -> int:
    """The csrc ``KernelKind`` code for a (kernel, nu) pair."""
    key = (kernel, float(nu) if kernel == "matern" else None)
    if key not in _KINDS:
        raise ValueError(f"unsupported kernel {kernel!r} (nu={nu})")
    return _KINDS[key]


def matfree_apply(X: torch.Tensor, L: torch.Tensor, coef: torch.Tensor, *,
                  kernel: str, bandwidth: float = 1.0,
                  nu: float = 1.5) -> torch.Tensor:
    """C = K(X, L)·S on the card; X (n, p) and L (m·d, p) float32 or
    bfloat16 of one dtype, coef (m, d) float32.  Returns (n, d) float32.

    Replaces AA:474 ``matfree_apply``; landmark row i·d + j belongs to
    column j of slab i, as in ``ops.expand_coef`` of the reference."""
    dev = _cuda_device(X)
    n, p = X.shape
    m, d = coef.shape
    _check("X", X, (n, p), _TYPES, dev)
    _check("L", L, (m * d, p), (X.dtype,), dev)
    _check("coef", coef, (m, d), (torch.float32,), dev)
    kind = _kernel_kind(kernel, nu)
    per_col = m * (p + 2) * 4
    if per_col > _MATFREE_SMEM:
        raise ValueError(f"m·(p+2)·4 = {per_col} B of landmarks per output "
                         f"column exceeds the {_MATFREE_SMEM} B shared-memory "
                         "budget of the matfree kernel")
    jc = max(1, min(d, _MATFREE_GROUP // per_col))
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return out
    _int32(n=n, p=p, md=m * d)
    with torch.cuda.device(dev):
        err = _lib().repro_matfree_apply(
            X.data_ptr(), L.data_ptr(), coef.data_ptr(), out.data_ptr(), n, p,
            m, d, jc, kind, float(bandwidth), 2.0 * float(bandwidth) ** 2,
            int(X.dtype == torch.bfloat16), _stream(dev))
    matfree_apply.launches += 1
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
    with torch.cuda.device(dev):
        err = _lib().repro_accum_apply_left(
            M.data_ptr(), idx.data_ptr(), coef.data_ptr(), out.data_ptr(), N,
            c, m, d, int(M.dtype == torch.bfloat16), _stream(dev))
    accum_apply_left.launches += 1
    _raise_on(err, "accum_apply_left")
    return out


def accum_sketch_both(K: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, W) = (K S, SᵀC) on the card for square K (n, n) float32 or
    bfloat16; W folds from the float32 C.  Returns (C in K's dtype, W
    float32).  Replaces AA:164; two launches (gather, then left apply)."""
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
    if n == 0 or d == 0:
        return C, W.zero_()
    _int32(n=n, md=m * d)
    with torch.cuda.device(dev):
        err = _lib().repro_accum_sketch_both(
            K.data_ptr(), idx.data_ptr(), coef.data_ptr(), C32.data_ptr(),
            C.data_ptr() if bf16 else None, W.data_ptr(), n, n, m, d,
            int(bf16), _stream(dev))
    accum_sketch_both.launches += 1
    _raise_on(err, "accum_sketch_both")
    return C, W


def accum_apply(K: torch.Tensor, idx: torch.Tensor,
                coef: torch.Tensor) -> torch.Tensor:
    """K S on the card for K (R, N) float32 or bfloat16, idx (m, d) int32,
    coef (m, d) float32.  Returns (R, d) in K's dtype, summed in float32.
    Replaces AA:84; one launch for any N."""
    dev = _cuda_device(K)
    R, N = K.shape
    m, d = idx.shape
    _check("K", K, (R, N), _TYPES, dev)
    _check("idx", idx, (m, d), (torch.int32,), dev)
    _check("coef", coef, (m, d), (torch.float32,), dev)
    out = torch.empty((R, d), dtype=K.dtype, device=dev)
    if R == 0 or d == 0:
        return out
    _int32(R=R, N=N, md=m * d)
    with torch.cuda.device(dev):
        err = _lib().repro_accum_apply(
            K.data_ptr(), idx.data_ptr(), coef.data_ptr(), out.data_ptr(), R, N,
            m, d, int(K.dtype == torch.bfloat16), _stream(dev))
    accum_apply.launches += 1
    _raise_on(err, "accum_apply")
    return out


def accum_step_slab(K: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor,
                    Cin: torch.Tensor, a: float) -> torch.Tensor:
    """a·Cin + K·T̃ on the card for one slab: K (R, N) float32 or bfloat16,
    idx (1, d) int32, coef (1, d) float32, Cin (R, d) float32, ``a`` by
    value.  Returns (R, d) float32.  Replaces AA:277."""
    dev = _cuda_device(K)
    R, N = K.shape
    d = idx.shape[1]
    _check("K", K, (R, N), _TYPES, dev)
    _check("idx", idx, (1, d), (torch.int32,), dev)
    _check("coef", coef, (1, d), (torch.float32,), dev)
    _check("Cin", Cin, (R, d), (torch.float32,), dev)
    out = torch.empty((R, d), dtype=torch.float32, device=dev)
    if R == 0 or d == 0:
        return out
    _int32(R=R, N=N, d=d)
    with torch.cuda.device(dev):
        err = _lib().repro_accum_step_slab(
            K.data_ptr(), idx.data_ptr(), coef.data_ptr(), Cin.data_ptr(),
            float(a), out.data_ptr(), R, N, d, int(K.dtype == torch.bfloat16),
            _stream(dev))
    accum_step_slab.launches += 1
    _raise_on(err, "accum_step_slab")
    return out


def accum_grow_slabs(K: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor,
                     Cin: torch.Tensor, a: float, *,
                     out: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(C_new, TᵀG, TᵀC) on the card for the B-slab block T: K (R, N) float32
    or bfloat16, idx (B, d) int32 with every index < R, coef (B, d) float32,
    Cin (R, d) float32, ``a`` by value.  C_new = a·Cin + G with G = K·T, all
    three float32.  ``out`` receives C_new and may be ``Cin`` itself: TᵀC is
    read from Cin before anything is written.  Replaces AA:370."""
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
    if R == 0 or d == 0:
        return out, TtG.zero_(), TtC.zero_()
    G32 = torch.empty((R, d), dtype=torch.float32, device=dev)
    _int32(R=R, N=N, Bd=B * d)
    with torch.cuda.device(dev):
        err = _lib().repro_accum_grow_slabs(
            K.data_ptr(), idx.data_ptr(), coef.data_ptr(), Cin.data_ptr(),
            float(a), out.data_ptr(), G32.data_ptr(), TtG.data_ptr(),
            TtC.data_ptr(), R, N, B, d, int(K.dtype == torch.bfloat16),
            _stream(dev))
    accum_grow_slabs.launches += 1
    _raise_on(err, "accum_grow_slabs")
    return out, TtG, TtC


KERNELS = (matfree_apply, accum_apply_left, accum_sketch_both, accum_apply,
           accum_step_slab, accum_grow_slabs)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


reset_launches()
