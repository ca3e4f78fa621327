"""Structural application of an AccumSketch — the paper's efficiency claim.

The identities (paper §3.3):

    K S     = Σ_i K S_(i)          — O(n·m·d) instead of O(n²·d)
    Sᵀ K S  = Σ_i S_(i)ᵀ (K S)     — O(m·d²)  instead of O(n·d²)

Because each S_(i) has one non-zero per column, K S_(i) is a signed,
rescaled column gather of K, and S_(i)ᵀ M a row gather of M.  None of these
routines materializes S.

The PROGRESSIVE ACCUMULATION ENGINE (``accum_init`` / ``accum_step`` /
``accum_grow_batched`` / ``accum_grow_adaptive`` / ``grow_sketch_both``)
grows m while the effective size d stays fixed, folding new sub-sampling
matrices into the running (C, W):

    S_{m+1} = sqrt(m/(m+1))·S_m + T̃_{m+1}
    C_{m+1} = sqrt(m/(m+1))·C_m + K T̃_{m+1}             (one column gather)
    W_{m+1} = (m/(m+1))·W_m + a·(T̃ᵀC_m + C_mᵀT̃) + T̃ᵀK T̃  (row gathers)

at O(n·d) per slab, until a plug-in error estimate clears the caller's
tolerance.  The reference's ``lax`` loops are Python loops here: the
stopping test reads one number from the device per estimate, O(log m) times
per fit on the doubling schedule.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch._util import HOLDOUT_STREAM, REFINE_STREAM, stream_generator
from repro_torch.core.schemes import _rademacher
from repro_torch.core.sketch import AccumSketch, AccumState, make_accum_sketch


# set by the trace-contract analyzer while a probe runs on the CPU
# (``repro_torch.analysis.trace.route_as_on_card``): the defaults then route
# to the kernel routers as on a card, where the CPU tensors take the plain
# versions, so that a probe counts the same dispatches on both
ROUTE_AS_ON_CARD = False


def default_use_kernel(device) -> bool:
    """Whether a structural application on ``device`` takes the CUDA kernel:
    True on a CUDA device, False on the CPU (where the plain version runs),
    unless ``ROUTE_AS_ON_CARD`` is set."""
    return ROUTE_AS_ON_CARD or torch.device(device).type == "cuda"


def _operator(K):
    """The KernelOperator behind K, or None for a dense tensor (lazy import:
    kernel_op imports this module)."""
    from repro_torch.core.kernel_op import KernelOperator

    return K if isinstance(K, KernelOperator) else None


def _device(K) -> torch.device:
    """The device of a dense K or of a KernelOperator's data."""
    op = _operator(K)
    return (op.X if op is not None else K).device


def _common(*ts: torch.Tensor) -> torch.dtype:
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def sketch_right(K: torch.Tensor, sk: AccumSketch) -> torch.Tensor:
    """K S for K of shape (r, n) → (r, d).  O(r·m·d)."""
    dt = _common(K, sk.coef)
    cols = K.index_select(1, sk.indices.reshape(-1))             # (r, m·d)
    cols = cols.reshape(K.shape[0], sk.m, sk.d)
    return torch.einsum("rmd,md->rd", cols.to(dt), sk.coef.to(dt))


def sketch_left(sk: AccumSketch, M: torch.Tensor) -> torch.Tensor:
    """Sᵀ M for M of shape (n, c) → (d, c).  O(m·d·c)."""
    return left_from_rows(sk, M.index_select(0, sk.indices.reshape(-1)))


def left_from_rows(sk: AccumSketch, rows: torch.Tensor) -> torch.Tensor:
    """Sᵀ M from the gathered landmark rows M[sk.indices] (m·d, c)."""
    dt = _common(rows, sk.coef)
    rows = rows.reshape(sk.m, sk.d, rows.shape[-1])
    return torch.einsum("mdc,md->dc", rows.to(dt), sk.coef.to(dt))


def sketch_vec(sk: AccumSketch, v: torch.Tensor) -> torch.Tensor:
    """Sᵀ v for v of shape (n,) → (d,)."""
    return sketch_left(sk, v[:, None])[:, 0]


def unsketch_vec(sk: AccumSketch, w: torch.Tensor) -> torch.Tensor:
    """S w for w of shape (d,) → (n,) by scatter-add."""
    contrib = (sk.coef * w[None, :]).reshape(-1)                 # (m·d,)
    out = torch.zeros((sk.n,), dtype=contrib.dtype, device=w.device)
    return out.index_add_(0, sk.indices.reshape(-1), contrib)


def unsketch_mat(sk: AccumSketch, W: torch.Tensor) -> torch.Tensor:
    """S W for W of shape (d, c) → (n, c)."""
    contrib = sk.coef[..., None] * W[None, ...]                  # (m, d, c)
    out = torch.zeros((sk.n, W.shape[-1]), dtype=contrib.dtype, device=W.device)
    return out.index_add_(0, sk.indices.reshape(-1),
                          contrib.reshape(-1, W.shape[-1]))


def sketch_both(K, sk: AccumSketch, *, use_kernel: bool | None = None,
                mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(K S, Sᵀ K S) sharing the K S intermediate, as in the paper.

    ``K`` is a dense (n, n) tensor or a matrix-free ``KernelOperator``.
    ``use_kernel`` (default: whether K is on a CUDA device) computes the
    dense pair with the ``accum_sketch_both`` kernel; W then stays float32.
    An operator routes C through the matrix-free kernel instead.  ``mesh``
    (operator only) computes this rank's rows of C and the replicated W
    (``core.distributed``)."""
    if mesh is not None:
        from repro_torch.core import distributed as D

        op, mesh = D.operator_mesh(K, mesh)
        return D.sharded_sketch_both(op, sk, mesh, use_kernel=use_kernel)
    op = _operator(K)
    if op is not None:
        return op.sketch_both(sk, use_kernel=use_kernel)
    if use_kernel is None:
        use_kernel = default_use_kernel(K.device)
    if use_kernel:
        from repro_torch.kernels.accum_apply.ops import sketch_both_kernel

        return sketch_both_kernel(K, sk)
    KS = sketch_right(K, sk)
    return KS, sketch_left(sk, KS)


def gram_sketch(sk: AccumSketch) -> torch.Tensor:
    """Sᵀ S (d, d) without materializing S: the m·d non-zeros are grouped by
    their row into the compressed (md, d) block B, and SᵀS = BᵀB."""
    idx = sk.indices.reshape(-1)
    cf = sk.coef.reshape(-1)
    col = torch.arange(sk.d, device=idx.device).repeat(sk.m)
    _, ranks = torch.unique(idx, return_inverse=True)
    B = torch.zeros((idx.shape[0], sk.d), dtype=cf.dtype, device=cf.device)
    B.index_put_((ranks, col), cf, accumulate=True)
    return B.T @ B


# --------------------------------------------------------------------------- #
# Progressive accumulation engine
# --------------------------------------------------------------------------- #

def _f32(x: float) -> float:
    """``x`` rounded to float32, as the reference's float32 scalars are (on
    the host: no tensor is made)."""
    return float(np.float32(x))


def _psd_apply_pinv(W: torch.Tensor, B: torch.Tensor,
                    jitter: float = 1e-6) -> torch.Tensor:
    """W⁺ B for PSD W via trace-scaled jitter and Cholesky; NaN where the
    factorization fails, as the reference's ``cho_factor`` gives."""
    d = W.shape[0]
    eps = jitter * (torch.trace(W) / d) + 1e-30
    L, info = torch.linalg.cholesky_ex(
        W + eps * torch.eye(d, dtype=W.dtype, device=W.device))
    return torch.where(info == 0, torch.cholesky_solve(B, L), float("nan"))


def accum_init(generator: torch.Generator, n: int, d: int, m_max: int,
               probs=None, *, signed: bool = True, scheme: str = "uniform",
               device="cuda") -> AccumState:
    """Draw all ``m_max`` sub-sampling matrices up front (the draw of
    ``make_accum_sketch`` at m_max, so growing to m_max replays it) and
    return the empty state: C and W zero, m = 0, err = +inf.

    ``scheme="leverage"`` starts from ``probs`` (or uniform) and lets the
    growth loops refine the tail; ``"poisson"`` pre-draws Poisson slabs.
    ``pdraw`` records the probabilities of the draw."""
    if scheme == "leverage":
        sk = dataclasses.replace(
            make_accum_sketch(generator, n, d, m_max, probs, signed=signed,
                              device=device), scheme=scheme)
    else:
        sk = make_accum_sketch(generator, n, d, m_max, probs, signed=signed,
                               scheme=scheme, device=device)
    dev = sk.device
    return AccumState(
        indices=sk.indices, signs=sk.signs, probs=sk.probs,
        pdraw=sk.probs[sk.indices.long()],
        C=torch.zeros((n, d), dtype=torch.float32, device=dev),
        W=torch.zeros((d, d), dtype=torch.float32, device=dev),
        m=0, err=math.inf, n=n, scheme=scheme)


def slab_pieces(state: AccumState):
    """(idx_new, coef_new, a) for folding slab ``state.m``: its indices, its
    coefficients normalized for the grown size t+1 from the at-draw
    probabilities, coef = r/sqrt(d (t+1) p), and the survivors' rescale
    a = sqrt(t/(t+1)) in float32 (t = 0 gives 0: C_1 = K T̃_1)."""
    t = state.m
    if t >= state.m_max:
        raise ValueError(f"all m_max={state.m_max} pre-drawn slabs are "
                         "already accumulated")
    coef_new = state.signs[t].float() / torch.sqrt(
        state.d * (t + 1.0) * state.pdraw[t].float())
    a = _f32(math.sqrt(_f32(t / (t + 1.0))))
    return state.indices[t], coef_new, a


def slab_w_update(state: AccumState, TtC: torch.Tensor, Ksub: torch.Tensor,
                  coef_new: torch.Tensor, a: float) -> torch.Tensor:
    """W_{t+1} = a²·W_t + a·(T̃ᵀC + (T̃ᵀC)ᵀ) + T̃ᵀK T̃, symmetrized."""
    TtKT = coef_new[:, None] * Ksub.float() * coef_new[None, :]
    W_new = (a * a) * state.W + a * (TtC + TtC.T) + TtKT
    return 0.5 * (W_new + W_new.T)


def batch_pieces(state: AccumState, B: int):
    """(idx_blk, coef_blk, a) for folding slabs [t, t+B) in one batch: the
    (B, d) block normalized for the grown size t+B, coef = r/sqrt(d (t+B) p),
    and the telescoped survivor rescale a = sqrt(t/(t+B)) — the product of
    the B per-step rescales of ``slab_pieces``."""
    t = state.m
    coef_blk = state.signs[t:t + B].float() / torch.sqrt(
        state.d * (t + float(B)) * state.pdraw[t:t + B].float())
    a = _f32(math.sqrt(_f32(t / (t + float(B)))))
    return state.indices[t:t + B], coef_blk, a


def block_left(idx_blk: torch.Tensor, coef_blk: torch.Tensor,
               M: torch.Tensor) -> torch.Tensor:
    """Tᵀ M (d, c) for the batch block T described by idx/coef (B, d): a
    B·d-row gather of M contracted with the coefficients, in float32."""
    return block_from_rows(coef_blk, M.index_select(0, idx_blk.reshape(-1)))


def block_from_rows(coef_blk: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Tᵀ M from the gathered rows M[idx_blk] (B·d, c)."""
    B, d = coef_blk.shape
    return torch.einsum("bdc,bd->dc", rows.reshape(B, d, -1).float(), coef_blk)


def batch_w_update(state: AccumState, TtC: torch.Tensor, TtG: torch.Tensor,
                   a: float) -> torch.Tensor:
    """W_{t+B} = a²·W_t + a·(TᵀC + (TᵀC)ᵀ) + TᵀKT, symmetrized."""
    W_new = (a * a) * state.W + a * (TtC + TtC.T) + TtG
    return 0.5 * (W_new + W_new.T)


def finish_grow(state: AccumState, m_max: int, passes: int | None = None):
    """What the growth entry points return: (sketch, C, W, info) with info's m, m_max,
    err and passes (the data sweeps taken: m on the unit schedule, O(log m)
    on the doubling one) as Python numbers."""
    info = {"m": state.m, "m_max": m_max, "err": state.err,
            "passes": state.m if passes is None else passes}
    return state.sketch(), state.C, state.W, info


def accum_step(K, state: AccumState, *, use_kernel: bool | None = None,
               mesh=None) -> AccumState:
    """Fold ONE new sub-sampling matrix into (C, W): O(n·d).

    ``K`` is a dense tensor or a ``KernelOperator`` (whose slab columns come
    from kernel evaluations).  ``use_kernel`` (default: whether K is on a
    CUDA device) takes the C update through ``sketch_step_kernel`` on a dense
    K, or the matrix-free kernel on an operator; the W pieces are d×d
    gathers either way.  ``mesh`` (operator only) computes the slab on this
    rank's rows of C and sums the T̃ᵀC gather over the ranks."""
    if mesh is not None:
        from repro_torch.core import distributed as D

        return D.sharded_accum_step(K, state, mesh, use_kernel=use_kernel)
    op = _operator(K)
    if use_kernel is None:
        use_kernel = default_use_kernel(_device(K))
    idx_new, coef_new, a = slab_pieces(state)

    # W from d×d gathers only: T̃ᵀC_t and (T̃ᵀK T̃)[i, j] = c_i K[n_i, n_j] c_j
    TtC = coef_new[:, None] * state.C.index_select(0, idx_new)
    if op is not None:
        Ksub = op.submatrix(idx_new, idx_new)
    else:
        Ksub = K.index_select(0, idx_new).index_select(1, idx_new)
    W_new = slab_w_update(state, TtC, Ksub, coef_new, a)

    if op is not None:
        G = op.weighted_cols(op.X, idx_new[None, :], coef_new[None, :],
                             use_kernel=use_kernel)
        C_new = a * state.C + G.float()
    elif use_kernel:
        from repro_torch.kernels.accum_apply.ops import sketch_step_kernel

        C_new = sketch_step_kernel(K, idx_new, coef_new, state.C, a)
    else:
        G = K.index_select(1, idx_new).float() * coef_new[None, :]
        C_new = a * state.C + G
    return dataclasses.replace(state, C=C_new, W=W_new, m=state.m + 1)


def accum_grow(K, state: AccumState, steps: int, *,
               use_kernel: bool | None = None, mesh=None) -> AccumState:
    """Fold in ``steps`` more slabs, one ``accum_step`` each (on ``mesh``:
    sharded steps)."""
    for _ in range(steps):
        state = accum_step(K, state, use_kernel=use_kernel, mesh=mesh)
    return state


def accum_grow_batched(K, state: AccumState, B: int, *,
                       use_kernel: bool | None = None,
                       donate: bool = False, mesh=None) -> AccumState:
    """Fold the next ``B`` pre-drawn slabs into (C, W) in ONE pass over the
    data: one column-block application G = K·T (a single
    ``accum_grow_slabs`` launch, kernel-evaluation sweep or gather), the
    update a·C + G, and two d×d gathers for W.  The draws are those of B
    ``accum_step`` calls, and (C, W) agree with theirs to summation order.

    ``donate=True`` lets the dense kernel route write the new C over the
    state's C (the reference donates the state's buffers); the caller's
    state must not be used afterwards.  ``mesh`` (operator only) sweeps this
    rank's rows and sums the W pieces' gathers over the ranks.  Requires
    1 ≤ B and m + B ≤ m_max."""
    if not 1 <= B <= state.m_max:
        raise ValueError(f"batch size B={B} outside [1, m_max={state.m_max}]")
    if state.m + B > state.m_max:
        raise ValueError(f"batch of {B} slabs from m={state.m} overruns the "
                         f"pre-drawn m_max={state.m_max}")
    if mesh is not None:
        from repro_torch.core import distributed as D

        return D.sharded_accum_grow_batched(K, state, B, mesh, use_kernel=use_kernel)
    op = _operator(K)
    if use_kernel is None:
        use_kernel = default_use_kernel(_device(K))
    idx_blk, coef_blk, a = batch_pieces(state, B)
    if op is not None:
        # one kernel-evaluation sweep for all B slabs; TᵀKT reuses G
        if use_kernel:
            G = op.weighted_cols(op.X, idx_blk, coef_blk, use_kernel=True).float()
        else:
            from repro_torch.core.kernel_op import stream_cols_slabs

            lm = op.X.index_select(0, idx_blk.reshape(-1))
            G = stream_cols_slabs(op.X, lm, coef_blk, op.kernel_fn).float()
        C_new = a * state.C + G
        TtG = block_left(idx_blk, coef_blk, G)
        TtC = block_left(idx_blk, coef_blk, state.C)
    elif use_kernel:
        from repro_torch.kernels.accum_apply.ops import accum_grow_kernel

        C_new, TtG, TtC = accum_grow_kernel(K, idx_blk, coef_blk, state.C, a,
                                            out=state.C if donate else None)
    else:
        n = K.shape[0]
        cols = K.index_select(1, idx_blk.reshape(-1)).float()
        G = torch.einsum("nbd,bd->nd", cols.reshape(n, B, state.d), coef_blk)
        C_new = a * state.C + G
        TtG = block_left(idx_blk, coef_blk, G)
        TtC = block_left(idx_blk, coef_blk, state.C)
    W_new = batch_w_update(state, TtC, TtG, a)
    return dataclasses.replace(state, C=C_new, W=W_new, m=state.m + B)


def doubling_schedule(m_start: int, m_max: int) -> list[int]:
    """Batch sizes 1, 2, 4, … (clamped into the remaining budget) that grow
    ``m_start`` → ``m_max`` in O(log m_max) batches."""
    out, t, B = [], m_start, 1
    while t < m_max:
        b = min(B, m_max - t)
        out.append(b)
        t += b
        B *= 2
    return out


def _estimate(est: torch.Tensor) -> float:
    """The estimate as a host float, +inf where it is not finite."""
    v = float(est)
    return v if math.isfinite(v) else math.inf


def _rows_without_replacement(generator: torch.Generator, n: int,
                              k: int) -> torch.Tensor:
    """k distinct rows of range(n), uniformly, by Floyd's algorithm: k
    draws from ``generator``, O(k) host work where a permutation of n rows
    costs O(n) (tens of milliseconds at n = 2²¹)."""
    rows: dict[int, None] = {}
    for j in range(n - k, n):
        t = int(torch.randint(j + 1, (), generator=generator,
                              device=generator.device))
        rows[j if t in rows else t] = None
    return torch.tensor(list(rows), dtype=torch.long)


def holdout_rule(Kh: torch.Tensor, take, jitter: float):
    """The holdout estimate ‖K_h − C_h W⁺ C_hᵀ‖/‖K_h‖ on the (h, h) block
    ``Kh``, with ``take(C)`` gathering the holdout rows C_h of a state's C."""
    denom = torch.clamp_min(torch.linalg.norm(Kh), 1e-30)

    def estimate(state: AccumState) -> float:
        Ch = take(state.C)
        Khat = Ch @ _psd_apply_pinv(state.W, Ch.T, jitter)
        return _estimate(torch.linalg.norm(Kh - Khat) / denom)

    return estimate


def hutchinson_rule(zKz: torch.Tensor, ctz, jitter: float):
    """The Hutchinson estimate of tr(K − K̂)/tr̂(K) from the probes' zᵀKz
    (q,), with ``ctz(C)`` the (d, q) product Cᵀ Z of a state's C."""
    denom = torch.clamp_min(torch.mean(zKz), 1e-30)

    def estimate(state: AccumState) -> float:
        CtZ = ctz(state.C)
        zKhatz = torch.einsum("dq,dq->q", CtZ,
                              _psd_apply_pinv(state.W, CtZ, jitter))
        return _estimate(torch.clamp_min(torch.mean(zKz - zKhatz), 0.0) / denom)

    return estimate


def make_holdout_estimator(generator: torch.Generator | None, K,
                           num: int = 64, *, jitter: float = 1e-6,
                           hold=None, mesh=None):
    """Plug-in stopping rule: the relative Nyström-reconstruction error of
    K̂ = C W⁺ Cᵀ on a random holdout principal submatrix, O(h²·d + d³) per
    estimate, independent of n.  The ``min(num, n)`` rows are drawn without
    replacement from ``generator``; ``hold`` gives them instead (a reference
    draw carried across).  With a ``KernelOperator`` the h×h block comes from
    h² kernel evaluations; ``mesh`` (operator only) sums the C row gather
    over the ranks, on the same rows."""
    if mesh is not None:
        from repro_torch.core import distributed as D

        return D.make_sharded_holdout_estimator(generator, K, mesh, num,
                                                jitter=jitter, hold=hold)
    op = _operator(K)
    n = K.shape[0]
    dev = _device(K)
    if hold is None:
        hold = _rows_without_replacement(generator, n, min(num, n))
    hold = torch.as_tensor(hold).to(dev, torch.long)
    if op is not None:
        Kh = op.submatrix(hold, hold).float()
    else:
        Kh = K.index_select(0, hold).index_select(1, hold).float()
    return holdout_rule(Kh, lambda C: C.index_select(0, hold), jitter)


def make_hutchinson_estimator(generator: torch.Generator | None, K,
                              num_probes: int = 8, *, jitter: float = 1e-6,
                              probes=None, mesh=None):
    """Plug-in stopping rule: the Hutchinson estimate of the relative trace
    residual tr(K − K̂)/tr̂(K) with (n, q) Rademacher probes drawn from
    ``generator`` (``probes`` gives them instead).  K Z is formed once, so
    each estimate costs O(n·d·q + d³); with a ``KernelOperator`` K Z is a
    streamed matvec, O(chunk·n) memory.  ``mesh`` (operator only) forms this
    rank's rows of K Z and sums every contraction over the ranks."""
    if mesh is not None:
        from repro_torch.core import distributed as D

        return D.make_sharded_hutchinson_estimator(generator, K, mesh, num_probes,
                                                   jitter=jitter, probes=probes)
    op = _operator(K)
    n = K.shape[0]
    dev = _device(K)
    if probes is None:
        probes = _rademacher(generator, (n, num_probes), torch.float32)
    Z = torch.as_tensor(probes).to(dev, torch.float32)
    KZ = op.matvec(Z) if op is not None else K.float() @ Z
    return hutchinson_rule(torch.einsum("nq,nq->q", Z, KZ), lambda C: C.T @ Z,
                           jitter)


def doubling_ladder(state: AccumState, m_max: int, tol: float, apply_batch,
                    estimator, refine=None) -> tuple[AccumState, int]:
    """The doubling-schedule loop: batches of 1, 2, 4, … from the state's
    m, the estimator once per batch, and a stop once the estimate clears
    ``tol`` (compared in float32, as the reference compares).
    ``apply_batch(state, B)`` folds one batch; ``refine(state, phase)``
    (optional) runs after each executed batch — the leverage scheme's
    refresh.  Returns ``(state, passes)``."""
    tol32 = _f32(tol)
    passes = 0
    for i, B in enumerate(doubling_schedule(state.m, m_max)):
        if not state.err > tol32:
            break
        state = apply_batch(state, B)
        state = dataclasses.replace(state, err=estimator(state))
        if refine is not None:
            state = refine(state, i)
        passes += 1
    return state, passes


def make_leverage_refine(seed: int, *, lam: float, mix: float = 0.1,
                         signed: bool = True):
    """The leverage scheme's per-phase refine for the growth loops: estimate
    ridge-leverage probabilities from the state's own (C, SᵀC) and redraw
    the slabs not yet accumulated from them, phase ``i`` from the stream
    (seed, ``REFINE_STREAM`` + i)."""
    from repro_torch.core import schemes as SCH

    def refine(state: AccumState, phase: int) -> AccumState:
        p_new = SCH.state_leverage_probs(state, lam, mix=mix)
        return SCH.refresh_tail(state,
                                stream_generator(seed, REFINE_STREAM + phase),
                                p_new, signed=signed)

    return refine


def accum_grow_doubling(K, state: AccumState, *, tol: float, estimator,
                        use_kernel: bool | None = None, refine=None,
                        mesh=None) -> tuple[AccumState, int]:
    """Adaptive growth on the DOUBLING schedule: fold B slabs in one data
    pass (``accum_grow_batched``), check the estimator, B ← 2B — O(log m)
    passes over K (or X).  With ``mesh`` (operator only) every batch is a
    sharded sweep; pass a shard-aware estimator (``make_*_estimator(mesh=…)``)
    and ``refine`` sees the state with all n rows of C
    (``distributed.gathered_refine``).  Returns ``(state, passes)``."""
    if mesh is not None and refine is not None:
        from repro_torch.core import distributed as D

        refine = D.gathered_refine(refine, D.operator_mesh(K, mesh)[1])

    def apply_batch(s, B):
        return accum_grow_batched(K, s, B, use_kernel=use_kernel, mesh=mesh)

    return doubling_ladder(state, state.m_max, tol, apply_batch, estimator,
                           refine=refine)


def accum_grow_adaptive(K, state: AccumState, *, tol: float, estimator,
                        check_every: int = 1, use_kernel: bool | None = None,
                        schedule: str = "unit", mesh=None) -> AccumState:
    """Grow until ``estimator(state) ≤ tol`` or the ``m_max`` pre-drawn
    slabs are used.  ``schedule="unit"`` folds one slab per pass and checks
    every ``check_every`` slabs (and at m_max); ``"doubling"`` delegates to
    ``accum_grow_doubling``.  With ``mesh`` (operator only) the steps are
    sharded; pass a shard-aware estimator (``make_*_estimator(mesh=…)``)."""
    if schedule not in ("unit", "doubling"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "doubling":
        state, _ = accum_grow_doubling(K, state, tol=tol, estimator=estimator,
                                       use_kernel=use_kernel, mesh=mesh)
        return state
    tol32 = _f32(tol)
    m_max = state.m_max
    while state.m < m_max and state.err > tol32:
        state = accum_step(K, state, use_kernel=use_kernel, mesh=mesh)
        if state.m % check_every == 0 or state.m >= m_max:
            state = dataclasses.replace(state, err=estimator(state))
    return state


def grow_sketch_both(seed: int, K, d: int, *, m_max: int = 32,
                     tol: float | None = None, probs=None, signed: bool = True,
                     estimator=None, check_every: int = 1,
                     use_kernel: bool | None = None,
                     schedule: str = "doubling", scheme: str = "uniform",
                     scheme_lam: float | None = None, scheme_mix: float = 0.1,
                     state: AccumState | None = None, mesh=None
                     ) -> tuple[AccumSketch, torch.Tensor, torch.Tensor, dict]:
    """One-call entry point: grow a sketch on K — a precomputed matrix or a
    ``KernelOperator`` — until the error target is met (or to m_max when
    ``tol`` is None) and return ``(sketch, C, W, info)`` with C = K S,
    W = SᵀKS at the final m and ``info`` holding m, m_max, err and passes.

    Callers give an error target, not m.  ``estimator`` defaults to the
    holdout rule; ``schedule="doubling"`` (default) folds batches of 1, 2,
    4, … in one data pass each, ``"unit"`` one slab per pass (estimated
    every ``check_every`` slabs).  ``scheme``: ``"uniform"``, ``"poisson"``,
    or ``"leverage"`` — after every batch, probabilities re-estimated from
    the sketch itself at ridge ``scheme_lam`` (default 1e-3), mixed with
    ``scheme_mix`` uniform, redraw the slabs not yet accumulated (doubling
    schedule only).

    The slabs are drawn from ``seed``'s stream, the holdout rows from
    (seed, ``HOLDOUT_STREAM``), the redraws of phase i from (seed,
    ``REFINE_STREAM`` + i).  ``state`` (an empty state with this n, d and
    m_max, e.g. ``interop.state_from_numpy``) replaces the seed's slab draw.
    The state lives on K's device.

    ``mesh`` (operator only) grows on this rank's rows (``core.distributed``):
    the same draws, holdout rows and redraws as on one device, every batch a
    sharded sweep; the returned C is this rank's rows, the rest replicated."""
    from repro_torch.core.schemes import validate_scheme

    validate_scheme(scheme)
    if scheme == "leverage" and schedule != "doubling":
        raise ValueError("scheme='leverage' refines between batches and "
                         "needs schedule='doubling'")
    if mesh is not None:
        from repro_torch.core import distributed as D

        mesh = D.operator_mesh(K, mesh)[1]
    n = K.shape[0]
    own = state is None           # a state drawn here may be grown in place
    if own:
        # rng-stream: slabs
        state = accum_init(stream_generator(seed), n, d, m_max, probs,
                           signed=signed, scheme=scheme, device=_device(K))
    elif (state.n, state.d, state.m_max, state.m) != (n, d, m_max, 0):
        raise ValueError(f"state (n={state.n}, d={state.d}, "
                         f"m_max={state.m_max}, m={state.m}) is not an empty "
                         f"state for n={n}, d={d}, m_max={m_max}")
    if mesh is not None:
        state = D.local_state(state, mesh)
    refine = None
    if scheme == "leverage":
        refine = make_leverage_refine(
            seed, lam=1e-3 if scheme_lam is None else scheme_lam,
            mix=scheme_mix, signed=signed)
    passes = None
    if tol is None:
        if refine is None:
            # fixed size is ONE batch: t = 0 makes the survivor rescale 0 and
            # the m_max-slab block is the one-shot sketch
            state = accum_grow_batched(K, state, m_max, use_kernel=use_kernel,
                                       donate=own, mesh=mesh)
            passes = 1
        else:
            # leverage at fixed size walks the doubling ladder so the
            # probabilities refine between batches
            if mesh is not None:
                refine = D.gathered_refine(refine, mesh)
            sched = doubling_schedule(0, m_max)
            for i, B in enumerate(sched):
                state = accum_grow_batched(K, state, B, use_kernel=use_kernel,
                                           mesh=mesh)
                if i < len(sched) - 1:
                    state = refine(state, i)
            passes = len(sched)
    else:
        if estimator is None:
            estimator = make_holdout_estimator(
                stream_generator(seed, HOLDOUT_STREAM), K, mesh=mesh)
        if schedule == "doubling":
            state, passes = accum_grow_doubling(
                K, state, tol=tol, estimator=estimator, use_kernel=use_kernel,
                refine=refine, mesh=mesh)
        else:
            state = accum_grow_adaptive(K, state, tol=tol, estimator=estimator,
                                        check_every=check_every,
                                        use_kernel=use_kernel,
                                        schedule=schedule, mesh=mesh)
    return finish_grow(state, m_max, passes=passes)


def sketch_kernel_cols(X: torch.Tensor, sk: AccumSketch, kernel_fn, *,
                       chunk: int | None = None) -> torch.Tensor:
    """C = K S without ever forming K: O(n·m·d) kernel evaluations, streamed
    over row chunks (``kernel_op.stream_cols``)."""
    from repro_torch.core.kernel_op import stream_cols

    landmarks = X.index_select(0, sk.indices.reshape(-1))        # (m·d, p)
    return stream_cols(X, landmarks, sk.coef, kernel_fn, chunk=chunk)
