"""Multi-process sharded sketching: row-shard X (and C) over a 1-D data mesh.

Accumulation keeps the effective matrix at d×d while n grows, so the n-sized
work — C = K S and its reductions — is what one device caps.  This layer
spreads it over the ranks of a ``torch.distributed`` process group, one
process a device (the reference runs one program over D devices with
``shard_map``):

  * rank r of D owns rows [r·⌈n/D⌉, min((r+1)·⌈n/D⌉, n)) of X and of C
    (``DataMesh.rows``).  Every rank passes the same replicated inputs (X, y,
    seeds, test rows) and takes its own rows; each computes its (rows, d)
    tile of C through the backend the single-device path uses (the
    ``matfree_apply`` kernel on a CUDA device, ``stream_cols`` on the CPU),
    with the m·d landmark rows replicated, so kernel evaluations never cross
    ranks;
  * every n-reduction — W = SᵀC, CᵀC and Cᵀy in the KRR solvers, the holdout
    row gathers, the Hutchinson contractions, the engine's T̃ᵀC and TᵀG —
    is one ``all_reduce(SUM)``, the reference's ``psum``, and the only
    collective used.  A row gather is a masked local gather, zero outside
    the rank's rows, summed over the ranks: exact, since every row has one
    owner, and within gloo, which reduces CUDA tensors but gathers none;
  * draws are made on a CPU generator (``_util.stream_generator``), so
    every rank holds bitwise the single-device indices, signs and holdout
    rows.

Outputs follow the reference's sharding: C, fitted values, predictions and
an engine state's C are the rank's rows; W, θ, the d×d blocks, the
estimates, m, passes and cluster labels are replicated.  ``gather_rows``
assembles a row-sharded result.

Pass ``mesh=`` (a ``DataMesh``, ``True`` for the default group, or its
size) to ``apply.sketch_both``, the engine (``accum_step``, ``accum_grow*``,
``grow_sketch_both``), the estimator factories, ``KernelOperator``'s
applies, ``krr_sketched_fit*``, ``SketchedKRR.predict`` and
``spectral_cluster``.  Several GPUs: start one process a GPU, call
``torch.distributed.init_process_group("nccl", ...)`` in each with its rank,
then ``make_data_mesh(device=f"cuda:{local_rank}")``.  One process:
``make_data_mesh()`` makes a one-rank group of its own.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch._util import resolve_device
from repro_torch.core import apply as A
from repro_torch.core.kernel_op import KernelOperator, stream_cols, stream_cols_slabs
from repro_torch.core.schemes import _rademacher
from repro_torch.core.sketch import AccumSketch, AccumState

# a rank that dies leaves the others waiting in a collective: give up then
TIMEOUT = timedelta(seconds=60)


# --------------------------------------------------------------------------- #
# mesh plumbing
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A 1-D data mesh: this process's rank in a process group of ``size``
    ranks, each owning a contiguous block of rows, computing on ``device``."""

    group: object                  # torch.distributed ProcessGroup
    rank: int
    size: int
    device: torch.device
    store_dir: str | None = None   # the FileStore of a group made here

    def rows(self, n: int) -> tuple[int, int]:
        """(lo, hi): this rank's rows [r·⌈n/D⌉, min((r+1)·⌈n/D⌉, n)) of n."""
        per = -(-n // self.size)
        lo = min(self.rank * per, n)
        return lo, min(lo + per, n)

    def close(self) -> None:
        """Destroy the one-rank group ``make_data_mesh`` made for this mesh;
        a group the caller initialised is left to the caller."""
        if self.store_dir is not None:
            if dist.is_initialized():
                dist.destroy_process_group()
            shutil.rmtree(self.store_dir, ignore_errors=True)


def make_data_mesh(num: int | None = None, *, device="cuda") -> DataMesh:
    """The data mesh over the default process group (initialised by the
    caller, one process a rank, with the backend of its choice); its size
    must be ``num`` when given.  Without one, and ``num`` None or 1, a
    one-rank group on a ``FileStore`` in a temporary directory is made here
    — NCCL for a CUDA device, gloo for the CPU — so every collective runs;
    a failing NCCL init raises.  ``device`` refuses CUDA without a card."""
    device = resolve_device(device)
    if dist.is_initialized():
        size = dist.get_world_size()
        if num is not None and num != size:
            raise ValueError(f"data mesh needs {num} ranks, the default "
                             f"process group has {size}")
        return DataMesh(dist.group.WORLD, dist.get_rank(), size, device)
    if num not in (None, 1):
        raise ValueError(
            f"data mesh needs {num} ranks and no process group is initialised: "
            f"start {num} processes (one a device) and call "
            "torch.distributed.init_process_group in each first")
    backend = "nccl" if device.type == "cuda" else "gloo"
    store_dir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    try:
        store = dist.FileStore(os.path.join(store_dir, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1,
                                timeout=TIMEOUT)
    except BaseException:
        shutil.rmtree(store_dir, ignore_errors=True)
        raise
    return DataMesh(dist.group.WORLD, 0, 1, device, store_dir)


def resolve_mesh(mesh, device=None) -> DataMesh:
    """Normalize the ``mesh=`` argument the entry points accept: ``True`` →
    the mesh over the default group, a positive int → that many ranks, a
    ``DataMesh`` → itself.  ``False`` and 0 are rejected: the unsharded path
    is ``mesh=None``.  ``device`` (the data's; default CUDA) is the device
    of a mesh made here."""
    device = "cuda" if device is None else device
    if mesh is True:
        return make_data_mesh(device=device)
    if isinstance(mesh, bool):
        raise ValueError("mesh=False is not a disable switch — pass "
                         "mesh=None for the unsharded path")
    if isinstance(mesh, int):
        if mesh < 1:
            raise ValueError(f"mesh rank count must be ≥ 1, got {mesh}")
        return make_data_mesh(mesh, device=device)
    if isinstance(mesh, DataMesh):
        return mesh
    raise TypeError(f"mesh must be True, an int, or a DataMesh; got {mesh!r}")


def _operator_required(K) -> KernelOperator:
    op = A._operator(K)
    if op is None:
        raise ValueError(
            "mesh= sharding requires a matrix-free KernelOperator — a dense "
            "(n, n) K already fits on one device, which is the regime "
            "sharding exists to escape")
    return op


def operator_mesh(K, mesh) -> tuple[KernelOperator, DataMesh]:
    """(the KernelOperator K, the resolved mesh on its data's device); a
    dense K raises before any group is made."""
    op = _operator_required(K)
    return op, resolve_mesh(mesh, op.X.device)


def all_reduce(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The sum of ``t`` over the mesh's ranks, in place (``t`` must be a
    fresh contiguous tensor); every rank gets the same bits."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_reduce_mean(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The mean of ``t`` over the mesh's ranks, as a new tensor (``t`` is
    left as it is); every rank gets the same bits."""
    return all_reduce(t.clone(memory_format=torch.contiguous_format), mesh).div_(mesh.size)


def shard_rows(mesh: DataMesh, arr: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the replicated ``arr`` (a view)."""
    lo, hi = mesh.rows(arr.shape[0])
    return arr[lo:hi]


def gather_rows(mesh: DataMesh, shard: torch.Tensor, n: int) -> torch.Tensor:
    """The (n, …) tensor whose rows are every rank's ``shard``, on every
    rank: each rank's rows placed in zeros, summed over the ranks."""
    lo, hi = mesh.rows(n)
    out = shard.new_zeros((n, *shard.shape[1:]))
    out[lo:hi] = shard
    return all_reduce(out, mesh)


def local_state(state: AccumState, mesh: DataMesh) -> AccumState:
    """``state`` with C as this rank's rows: a replicated (n, d) C, as
    ``accum_init`` makes, is cut to them; a shard passes."""
    lo, hi = mesh.rows(state.n)
    if state.C.shape[0] == hi - lo:
        return state
    if state.C.shape[0] == state.n:
        return dataclasses.replace(state, C=state.C[lo:hi])
    raise ValueError(f"state C has {state.C.shape[0]} rows: neither all "
                     f"{state.n} nor this rank's {hi - lo}")


# --------------------------------------------------------------------------- #
# reduction primitives: gathers and grams over row-sharded tensors
# --------------------------------------------------------------------------- #

def sharded_take_rows(M: torch.Tensor, idx: torch.Tensor, mesh: DataMesh,
                      n: int) -> torch.Tensor:
    """M[idx] (|idx|, c) for the row-sharded M of n rows (this rank's
    (rows, c) block): the rows this rank owns, zeros for the others (an index
    outside them is never clamped onto one), summed over the ranks."""
    lo, hi = mesh.rows(n)
    if M.shape[0] != hi - lo:
        raise ValueError(f"M has {M.shape[0]} rows, this rank owns {hi - lo} of {n}")
    idx = idx.reshape(-1).long()
    inside = (idx >= lo) & (idx < hi)
    local = M.index_select(0, torch.where(inside, idx - lo, 0))
    return all_reduce(torch.where(inside[:, None], local, 0), mesh)


def sharded_gram(Am: torch.Tensor, Bm: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Aᵀ B (x, y) for row-sharded A (rows, x) and B (rows, y): the rank's
    partial gram, summed over the ranks, at float32 at least."""
    if Am.shape[0] != Bm.shape[0]:
        raise ValueError(f"row blocks differ: {tuple(Am.shape)}, {tuple(Bm.shape)}")
    dt = torch.promote_types(torch.float32, torch.promote_types(Am.dtype, Bm.dtype))
    return all_reduce(Am.to(dt).T @ Bm.to(dt), mesh)


def sharded_sketch_left(sk: AccumSketch, M: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """W = Sᵀ M (d, c) for row-sharded M: the m·d landmark rows gathered
    (``sharded_take_rows``) and contracted with the replicated coefficients
    as ``apply.sketch_left`` contracts them."""
    return A.left_from_rows(sk, sharded_take_rows(M, sk.indices, mesh, sk.n))


# --------------------------------------------------------------------------- #
# sharded C = K(·)·S — a tile a rank through the single-device backends
# --------------------------------------------------------------------------- #

def _tile_cols(op: KernelOperator, xb: torch.Tensor, lm: torch.Tensor,
               coef: torch.Tensor, use_kernel: bool, chunk: int | None, *,
               slabwise: bool = False) -> torch.Tensor:
    """C rows for the X rows ``xb`` through the backend the single-device
    path uses: the ``matfree_apply`` kernel, else ``stream_cols``
    (``stream_cols_slabs`` for the engine's batches)."""
    if use_kernel:
        from repro_torch.kernels.accum_apply.ops import matfree_cols_kernel

        return matfree_cols_kernel(xb, lm, coef, kernel=op.kernel,
                                   bandwidth=op.bandwidth, nu=op.nu)
    if slabwise:
        return stream_cols_slabs(xb, lm, coef, op.kernel_fn, chunk=chunk)
    return stream_cols(xb, lm, coef, op.kernel_fn, chunk=chunk)


def sharded_weighted_cols(op: KernelOperator, Xq: torch.Tensor, idx: torch.Tensor,
                          coef: torch.Tensor, mesh: DataMesh, *,
                          chunk: int | None = None,
                          use_kernel: bool | None = None) -> torch.Tensor:
    """This rank's rows of K(Xq, ·)·S for the replicated Xq: the sharded
    primitive behind C, prediction and the engine's slabs.  The chunk budget
    is the operator's, by slab size, whatever rows the rank holds."""
    if use_kernel is None:
        use_kernel = A.default_use_kernel(Xq.device)
    if chunk is None:
        chunk = op._auto_chunk(idx.numel())
    lm = op.X.index_select(0, idx.reshape(-1))
    return _tile_cols(op, shard_rows(mesh, Xq), lm, coef, use_kernel, chunk)


def sharded_sketch_both(op: KernelOperator, sk: AccumSketch, mesh: DataMesh, *,
                        chunk: int | None = None, use_kernel: bool | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(C rows, W) = (K S on this rank's rows, SᵀK S replicated): W is the
    sum over the ranks of the landmark rows each owns, contracted."""
    C = sharded_weighted_cols(op, op.X, sk.indices, sk.coef, mesh, chunk=chunk,
                              use_kernel=use_kernel)
    return C, sharded_sketch_left(sk, C, mesh)


def sharded_matvec(op: KernelOperator, Z: torch.Tensor, mesh: DataMesh, *,
                   chunk: int | None = None) -> torch.Tensor:
    """This rank's rows of K @ Z for the replicated Z: its X rows streamed
    against all of X, O(chunk·n) peak."""
    return op.matvec_rows(shard_rows(mesh, op.X), Z, chunk=chunk)


# --------------------------------------------------------------------------- #
# progressive engine: a slab and a batch on the rank's rows
# --------------------------------------------------------------------------- #

def sharded_accum_step(K, state: AccumState, mesh, *,
                       use_kernel: bool | None = None) -> AccumState:
    """``apply.accum_step`` with the slab's column block computed on this
    rank's rows and the T̃ᵀC gather summed over the ranks.  ``state`` has
    all n rows of C or this rank's; the result has this rank's."""
    op, mesh = operator_mesh(K, mesh)
    state = local_state(state, mesh)
    idx_new, coef_new, a = A.slab_pieces(state)
    TtC = coef_new[:, None] * sharded_take_rows(state.C, idx_new, mesh, state.n)
    W_new = A.slab_w_update(state, TtC, op.submatrix(idx_new, idx_new), coef_new, a)
    G = sharded_weighted_cols(op, op.X, idx_new[None, :], coef_new[None, :], mesh,
                              use_kernel=use_kernel)
    return dataclasses.replace(state, C=a * state.C + G.float(), W=W_new,
                               m=state.m + 1)


def sharded_accum_grow_batched(K, state: AccumState, B: int, mesh, *,
                               use_kernel: bool | None = None) -> AccumState:
    """``apply.accum_grow_batched`` on this rank's rows: one column-block
    sweep for all B slabs, and both d×d pieces (TᵀC from the old C, TᵀG from
    the G just made) from row gathers summed over the ranks.  The draws are
    the replicated pre-draw, bitwise the single-device ones."""
    op, mesh = operator_mesh(K, mesh)
    state = local_state(state, mesh)
    if use_kernel is None:
        use_kernel = A.default_use_kernel(op.X.device)
    idx_blk, coef_blk, a = A.batch_pieces(state, B)
    lm = op.X.index_select(0, idx_blk.reshape(-1))
    G = _tile_cols(op, shard_rows(mesh, op.X), lm, coef_blk, use_kernel, None,
                   slabwise=True).float()
    TtG = A.block_from_rows(coef_blk, sharded_take_rows(G, idx_blk, mesh, state.n))
    TtC = A.block_from_rows(coef_blk, sharded_take_rows(state.C, idx_blk, mesh, state.n))
    return dataclasses.replace(state, C=a * state.C + G,
                               W=A.batch_w_update(state, TtC, TtG, a), m=state.m + B)


def gathered_refine(refine, mesh: DataMesh):
    """``refine(state, phase)`` run on the state with all n rows of C
    gathered (``gather_rows``), as the single-device refresh reads them; the
    result keeps this rank's rows.  One (n, d) reduction a phase."""

    def run(state: AccumState, phase: int) -> AccumState:
        full = dataclasses.replace(state, C=gather_rows(mesh, state.C, state.n))
        return dataclasses.replace(refine(full, phase), C=state.C)

    return run


# --------------------------------------------------------------------------- #
# shard-aware stopping estimators
# --------------------------------------------------------------------------- #

def make_sharded_holdout_estimator(generator: torch.Generator | None, K, mesh,
                                   num: int = 64, *, jitter: float = 1e-6,
                                   hold=None):
    """The holdout rule with the C row gather summed over the ranks.  The
    same generator draws the same rows as ``apply.make_holdout_estimator``
    (``hold`` gives them instead)."""
    op, mesh = operator_mesh(K, mesh)
    n = op.n
    if hold is None:
        hold = A._rows_without_replacement(generator, n, min(num, n))
    hold = torch.as_tensor(hold).to(op.X.device, torch.long)
    return A.holdout_rule(op.submatrix(hold, hold).float(),
                          lambda C: sharded_take_rows(C, hold, mesh, n), jitter)


def make_sharded_hutchinson_estimator(generator: torch.Generator | None, K, mesh,
                                      num_probes: int = 8, *,
                                      jitter: float = 1e-6, probes=None):
    """The Hutchinson rule: K Z once on this rank's rows
    (``sharded_matvec``), zᵀKz and each estimate's CᵀZ summed over the
    ranks.  The same generator draws the same probes as
    ``apply.make_hutchinson_estimator`` (``probes`` gives them instead)."""
    op, mesh = operator_mesh(K, mesh)
    if probes is None:
        probes = _rademacher(generator, (op.n, num_probes), torch.float32)
    Z = torch.as_tensor(probes).to(op.X.device, torch.float32)
    Zr = shard_rows(mesh, Z)
    zKz = all_reduce(torch.einsum("nq,nq->q", Zr, sharded_matvec(op, Z, mesh)), mesh)
    return A.hutchinson_rule(zKz, lambda C: sharded_gram(C, Zr, mesh), jitter)
