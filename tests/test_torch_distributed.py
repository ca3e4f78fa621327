"""Port parity for the data mesh (``repro_torch.core.distributed``).

In process: ``resolve_mesh``'s forms and errors, and every ``mesh=`` entry
point refusing what the reference refuses (a dense K, a model fitted
without an operator, a raw-data matrix-free fit).

Across processes: this file is also the worker.  The test process computes
the JAX package's single-device results on the reference's data
(tests/test_distributed.py ``_data``, n = 320 and the ragged n = 301; its
blobs, at the ragged n = 161) and hands them to D ∈ {1, 2, 3} gloo ranks as
``.npy`` files, one spawn of D ranks a mesh size, each rank with a timeout.
The ranks import no JAX.  Each runs the sharded path and the port's
single-device path on the same draw, compares its own rows, and writes
squared-norm sums of its differences; the test process sums them over the
ranks and holds the global relative errors to the reference's tolerances
(1e-5 for C, W, fitted values and predictions; 1e-4 for the estimates).
The KRR fits' values are held against both packages in float64, where the
float32 spread of θ (ROADMAP queue 3) does not enter; the float32 fits hold
θ through its residual in the port's single-device d×d system (≤ 1e-5).
Draws, θ and labels are compared bit for bit across the ranks.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop  # noqa: E402
from repro_torch._util import HOLDOUT_STREAM  # noqa: E402
from repro_torch.core import apply as A  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import krr as K  # noqa: E402
from repro_torch.core import spectral as SP  # noqa: E402
from repro_torch.core.kernel_op import KernelOperator  # noqa: E402
from repro_torch.core.sketch import make_accum_sketch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SIZES = (1, 2, 3)
NS = (320, 301)
BLOBS = {301: 161}               # the spectral checks' n, run with n = 301
LAM = 5e-2
D_, M_ = 16, 4                   # the reference's d and m
# a guard against a hung rank, not a speed bound: the ranks are single-threaded
# and starve beside the suite's other workers (the two training ranks take 13
# s alone and did not finish in 180 s beside six CPU-bound processes)
SPAWN_TIMEOUT = 600
# error targets of the engine's checks at bandwidth 0.5: the unit schedule
# stops inside the budget (m = 6 at n = 320, m = 5 at n = 301) and the
# doubling schedule runs every batch size to m_max = 8
TOL = {320: 0.028, 301: 0.03}


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------- #
# in process: the forms resolve_mesh accepts, and what mesh= refuses
# --------------------------------------------------------------------------- #

def test_resolve_mesh_forms_and_errors():
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="mesh=None"):
        D.resolve_mesh(False, "cpu")
    with pytest.raises(ValueError, match="≥ 1"):
        D.resolve_mesh(0, "cpu")
    with pytest.raises(TypeError):
        D.resolve_mesh("data", "cpu")
    with pytest.raises(ValueError, match="init_process_group"):
        D.resolve_mesh(2, "cpu")
    mesh = D.resolve_mesh(True, "cpu")
    try:
        assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
        assert D.resolve_mesh(mesh) is mesh
        assert D.resolve_mesh(1, "cpu").group is mesh.group
        with pytest.raises(ValueError, match="has 1"):
            D.resolve_mesh(2, "cpu")
        assert mesh.rows(301) == (0, 301)
        x = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(D.gather_rows(mesh, D.shard_rows(mesh, x), 3), x)
    finally:
        mesh.close()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("n,size", [(320, 3), (301, 2), (301, 3), (2, 3)])
def test_rows_cover_every_row_once(n, size):
    spans = [D.DataMesh(None, r, size, torch.device("cpu")).rows(n)
             for r in range(size)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(hi - lo <= -(-n // size) for lo, hi in spans)


def test_default_mesh_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.make_data_mesh()
    assert not torch.distributed.is_initialized()


def _dense_problem(n=32, d=4, m=2):
    X = torch.rand((n, 3), generator=torch.Generator().manual_seed(0))
    op = KernelOperator(X, "gaussian", 0.6)
    g = torch.Generator().manual_seed(1)
    return op, op.dense(), make_accum_sketch(g, n, d, m, device="cpu")


@pytest.mark.parametrize("entry", [
    "sketch_both", "accum_step", "accum_grow", "accum_grow_batched",
    "grow_sketch_both", "holdout", "hutchinson", "krr_sketched_fit",
    "krr_sketched_fit_adaptive", "spectral_cluster"])
def test_dense_k_with_mesh_raises(entry):
    """A dense K with mesh= raises the reference's ValueError before any
    process group is made."""
    op, Kd, sk = _dense_problem()
    st = A.accum_init(torch.Generator().manual_seed(2), 32, 4, 4, device="cpu")
    y = torch.zeros(32)
    call = {
        "sketch_both": lambda: A.sketch_both(Kd, sk, mesh=1),
        "accum_step": lambda: A.accum_step(Kd, st, mesh=1),
        "accum_grow": lambda: A.accum_grow(Kd, st, 2, mesh=1),
        "accum_grow_batched": lambda: A.accum_grow_batched(Kd, st, 2, mesh=1),
        "grow_sketch_both": lambda: A.grow_sketch_both(0, Kd, 4, m_max=4, mesh=1),
        "holdout": lambda: A.make_holdout_estimator(torch.Generator(), Kd, mesh=1),
        "hutchinson": lambda: A.make_hutchinson_estimator(torch.Generator(), Kd, mesh=1),
        "krr_sketched_fit": lambda: K.krr_sketched_fit(Kd, y, LAM, sk, mesh=1),
        "krr_sketched_fit_adaptive": lambda: K.krr_sketched_fit_adaptive(
            Kd, y, LAM, 0, 4, m_max=4, mesh=1),
        "spectral_cluster": lambda: SP.spectral_cluster(0, Kd, 2, d=4, m=2, mesh=1),
    }[entry]
    with pytest.raises(ValueError, match="KernelOperator"):
        call()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("fit", ["matfree", "pcg"])
def test_raw_data_fit_with_mesh_raises(fit):
    op, _, sk = _dense_problem()
    fn = K.krr_sketched_fit_matfree if fit == "matfree" else K.krr_sketched_fit_pcg
    with pytest.raises(ValueError, match="KernelOperator input"):
        fn(op.X, torch.zeros(32), LAM, sk, op.kernel_fn, mesh=1)


def test_predict_with_mesh_needs_an_operator_model():
    op, _, sk = _dense_problem()
    model = K.krr_sketched_fit_matfree(op.X, torch.zeros(32), LAM, sk, op.kernel_fn)
    with pytest.raises(ValueError, match="KernelOperator"):
        model.predict(op.X[:4], mesh=1)


# --------------------------------------------------------------------------- #
# the worker: one rank of a gloo mesh (run as a script; imports no JAX)
# --------------------------------------------------------------------------- #

def _digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


class _Report:
    """What a rank writes: per check, squared-norm sums of its differences
    ([Σ diff², Σ ref², rows]: rows sums over the ranks, else the largest
    ratio counts), values, and digests."""

    def __init__(self, mesh):
        self.mesh, self.out = mesh, {}

    def err(self, name, got, ref, *, rows=False):
        """got: this rank's rows (rows=True) or a replicated result; ref:
        the full (all n rows) or replicated reference."""
        ref = _t(ref) if not isinstance(ref, torch.Tensor) else ref
        if rows:
            ref = D.shard_rows(self.mesh, ref)
        got, ref = got.double(), ref.double()
        self.out[name] = [float(((got - ref) ** 2).sum()), float((ref ** 2).sum()), rows]

    def put(self, name, value):
        self.out[name] = value


def _residual(C, W, y, theta) -> float:
    """‖Mθ − Cᵀy‖/‖Cᵀy‖ in float64 for the Woodbury system M = CᵀC + nλW of
    the full C: how well θ solves that system."""
    C, W, y, theta = (t.double() for t in (C, W, y, theta))
    rhs = C.T @ y
    return float((((C.T @ C + y.shape[0] * LAM * W) @ theta) - rhs).norm() / rhs.norm())


def _worker_checks(mesh, n: int, src: Path) -> dict:
    """The sharded paths against the port's single-device path and the JAX
    package's (``src``'s .npy files) on the reference's data of size n."""
    ld = {p.stem.split("_", 1)[1]: np.load(p) for p in src.glob(f"{n}_*.npy")}
    rep = _Report(mesh)
    lo, hi = mesh.rows(n)
    X, y = _t(ld["X"]), _t(ld["y"])
    op = KernelOperator(X, "gaussian", 0.6)
    sk = interop.sketch_from_numpy(ld["sk_idx"], ld["sk_signs"], ld["sk_probs"], n,
                                   coef=ld["sk_coef"], device="cpu")

    # primitives, with indices on every rank's rows and the ragged last shard
    rng = np.random.default_rng(n)
    M, B = _t(rng.normal(size=(n, 7))), _t(rng.normal(size=(n, 5)))
    # every rank's first and last row, the same indices on every rank
    edges = [e for r in range(mesh.size)
             for e in (lambda s: (s[0], s[1] - 1))(
                 D.DataMesh(None, r, mesh.size, mesh.device).rows(n))]
    idx = torch.as_tensor(np.r_[rng.integers(0, n, 13), edges])
    rep.put("take_rows_exact", torch.equal(
        D.sharded_take_rows(D.shard_rows(mesh, M), idx, mesh, n), M[idx]))
    rep.err("gram", D.sharded_gram(D.shard_rows(mesh, M), D.shard_rows(mesh, B), mesh),
            M.T @ B)
    rep.put("gather_rows_exact", torch.equal(D.gather_rows(mesh, M[lo:hi], n), M))
    C1, W1 = A.sketch_both(op, sk)
    rep.err("sketch_left", D.sharded_sketch_left(sk, C1[lo:hi], mesh), W1)
    Xq = X[:48] + 0.01
    rep.err("weighted_cols", op.weighted_cols(Xq, sk.indices, sk.coef, mesh=mesh),
            op.weighted_cols(Xq, sk.indices, sk.coef), rows=True)
    Z = _t(rng.normal(size=(n, 3)).astype(np.float32))
    rep.err("matvec", op.matvec(Z, mesh=mesh), op.matvec(Z), rows=True)

    # (C, W): the port's single device and the reference's
    for use_kernel in (False, True):
        C, W = A.sketch_both(op, sk, mesh=mesh, use_kernel=use_kernel)
        rep.err(f"sketch_both_C_port_uk{int(use_kernel)}", C, C1, rows=True)
        rep.err(f"sketch_both_W_port_uk{int(use_kernel)}", W, W1)
    rep.err("sketch_both_C_jax", C, ld["C"], rows=True)
    rep.err("sketch_both_W_jax", W, ld["W"])

    # the five KRR fits and predict in float64, against both packages
    op64 = KernelOperator(X.double(), "gaussian", 0.6)
    y64 = y.double()
    sk64 = interop.sketch_from_numpy(ld["sk64_idx"], ld["sk64_signs"], ld["sk64_probs"],
                                     n, coef=ld["sk64_coef"], device="cpu")
    Xt64 = Xq.double()
    fits = {
        "fit": lambda mesh: K.krr_sketched_fit(op64, y64, LAM, sk64, mesh=mesh),
        "matfree": lambda mesh: K.krr_sketched_fit_matfree(op64, y64, LAM, sk64, mesh=mesh),
        "pcg": lambda mesh: K.krr_sketched_fit_pcg(op64, y64, LAM, sk64, iters=40,
                                                   mesh=mesh),
    }
    for name, fit in fits.items():
        one, sh = fit(None), fit(mesh)
        rep.err(f"{name}_f64_port", sh.fitted, one.fitted, rows=True)
        rep.err(f"{name}_f64_jax", sh.fitted, ld[f"{name}_f64"], rows=True)
        rep.put(f"{name}_f64_theta", _digest(sh.theta))
    model = K.krr_sketched_fit(op64, y64, LAM, sk64, mesh=mesh)
    rep.err("predict_f64_port", model.predict(Xt64, mesh=mesh),
            K.krr_sketched_fit(op64, y64, LAM, sk64).predict(Xt64), rows=True)
    rep.err("predict_f64_jax", model.predict(Xt64, mesh=mesh), ld["pred_f64"], rows=True)
    rep.err("predict_replicated_f64_jax", model.predict(Xt64), ld["pred_f64"])
    # float32, the card's dtype: θ in the port's single-device d×d system
    Ws1 = 0.5 * (W1 + W1.T)
    for name, fit, W_ in (
            ("fit", lambda mesh: K.krr_sketched_fit(op, y, LAM, sk, mesh=mesh), W1),
            ("matfree", lambda mesh: K.krr_sketched_fit_matfree(op, y, LAM, sk,
                                                                mesh=mesh), Ws1),
            ("pcg", lambda mesh: K.krr_sketched_fit_pcg(op, y, LAM, sk, iters=40,
                                                        mesh=mesh), Ws1)):
        one, sh = fit(None), fit(mesh)
        rep.put(f"{name}_f32_residual", [_residual(C1, W_, y, sh.theta),
                                         _residual(C1, W_, y, one.theta)])
        rep.put(f"{name}_f32_theta", _digest(sh.theta))

    # the engine on the reference's accum_init draw and holdout rows
    op5 = KernelOperator(X, "gaussian", 0.5)
    hold = ld["hold"]

    def state():
        return interop.state_from_numpy(ld["st_idx"], ld["st_signs"], ld["st_probs"],
                                        ld["st_pdraw"], n, device="cpu")

    def est(mesh):
        return A.make_holdout_estimator(None, op5, hold=hold, mesh=mesh)

    grow1 = A.accum_grow(op5, state(), 5)
    grow = A.accum_grow(op5, state(), 5, mesh=mesh)
    rep.err("grow_C_port", grow.C, grow1.C, rows=True)
    rep.err("grow_C_jax", grow.C, ld["grow_C"], rows=True)
    rep.err("grow_W_port", grow.W, grow1.W)
    rep.err("grow_W_jax", grow.W, ld["grow_W"])
    step = A.accum_step(op5, A.accum_grow(op5, state(), 4, mesh=mesh), mesh=mesh)
    rep.put("step_bitwise_grow", torch.equal(step.C, grow.C) and torch.equal(step.W, grow.W))
    bat1 = A.accum_grow_batched(op5, A.accum_grow_batched(op5, state(), 3), 5)
    bat = A.accum_grow_batched(op5, A.accum_grow_batched(op5, state(), 3, mesh=mesh), 5,
                               mesh=mesh)
    rep.err("batched_C_port", bat.C, bat1.C, rows=True)
    rep.err("batched_C_jax", bat.C, ld["batched_C"], rows=True)
    rep.err("batched_W_port", bat.W, bat1.W)
    rep.err("batched_W_jax", bat.W, ld["batched_W"])
    grown = {}
    for schedule in ("doubling", "unit"):
        sk1, Cg1, Wg1, info1 = A.grow_sketch_both(0, op5, D_, m_max=8, tol=TOL[n],
                                                  estimator=est(None), state=state(),
                                                  schedule=schedule)
        skg, Cg, Wg, info = A.grow_sketch_both(0, op5, D_, m_max=8, tol=TOL[n],
                                               estimator=est(mesh), state=state(),
                                               schedule=schedule, mesh=mesh)
        rep.put(f"{schedule}_info", [info["m"], info["passes"], info["err"]])
        rep.put(f"{schedule}_info_port", [info1["m"], info1["passes"], info1["err"]])
        grown[schedule] = Cg1, Wg1
        rep.put(f"{schedule}_draws", [_digest(skg.indices), _digest(skg.signs),
                                      torch.equal(skg.indices, sk1.indices)
                                      and torch.equal(skg.signs, sk1.signs)])
        rep.err(f"{schedule}_C_port", Cg, Cg1, rows=True)
        rep.err(f"{schedule}_C_jax", Cg, ld[f"{schedule}_C"], rows=True)
        rep.err(f"{schedule}_W_port", Wg, Wg1)
        rep.err(f"{schedule}_W_jax", Wg, ld[f"{schedule}_W"])
    # the seed's own draws and holdout rows (the default estimator) on the mesh
    sk1, C1g, _, info1 = A.grow_sketch_both(7, op5, D_, m_max=8, tol=TOL[n])
    skg, Cg, _, info = A.grow_sketch_both(7, op5, D_, m_max=8, tol=TOL[n], mesh=mesh)
    rep.put("seeded_draws", [_digest(skg.indices), torch.equal(skg.indices, sk1.indices),
                             (info["m"], info["passes"]) == (info1["m"], info1["passes"])])
    rep.err("seeded_C_port", Cg, C1g, rows=True)
    # the leverage scheme: its redraws read all n rows of C, gathered
    sk1, C1g, _, info1 = A.grow_sketch_both(3, op5, D_, m_max=8, tol=TOL[n],
                                            scheme="leverage")
    skg, Cg, _, info = A.grow_sketch_both(3, op5, D_, m_max=8, tol=TOL[n],
                                          scheme="leverage", mesh=mesh)
    rep.put("leverage_draws", [_digest(skg.indices), torch.equal(skg.indices, sk1.indices),
                               (info["m"], info["passes"]) == (info1["m"], info1["passes"])])
    rep.err("leverage_C_port", Cg, C1g, rows=True)

    # the adaptive fits (float32, the engine's C): the same m and passes,
    # θ in the single-device engine's d×d system, fitted values to both
    for name, fit in {"adaptive": K.krr_sketched_fit_adaptive,
                      "pcg_adaptive": K.krr_sketched_fit_pcg_adaptive}.items():
        one = fit(op5, y, LAM, 0, D_, tol=TOL[n], m_max=8, estimator=est(None),
                  state=state())
        sh = fit(op5, y, LAM, 0, D_, tol=TOL[n], m_max=8, estimator=est(mesh),
                 state=state(), mesh=mesh)
        rep.put(f"{name}_info", [sh.info["m"], sh.info["passes"]])
        rep.put(f"{name}_info_port", [one.info["m"], one.info["passes"]])
        rep.put(f"{name}_residual", [_residual(*grown["doubling"], y, sh.theta),
                                     _residual(*grown["doubling"], y, one.theta),
                                     _residual(*grown["doubling"], y, _t(ld[f"{name}_theta"]))])
        rep.put(f"{name}_theta", _digest(sh.theta))

    # both estimators on the 5-slab state of ``grow``, the reference's rows
    # and probes
    hold_e, probes = ld["e_hold"], ld["e_probes"]
    rep.put("holdout", [A.make_holdout_estimator(None, op5, hold=hold_e, mesh=mesh)(grow),
                        A.make_holdout_estimator(None, op5, hold=hold_e)(grow1)])
    rep.put("hutchinson", [
        A.make_hutchinson_estimator(None, op5, probes=probes, mesh=mesh)(grow),
        A.make_hutchinson_estimator(None, op5, probes=probes)(grow1)])

    if n in BLOBS:
        _spectral_checks(mesh, BLOBS[n], ld, rep)
    return rep.out


def _spectral_checks(mesh, nb: int, ld: dict, rep: _Report) -> None:
    """Spectral clustering on the reference's blobs of nb rows."""
    Xs = _t(ld["blob_X"])
    ops = KernelOperator(Xs, "gaussian", 0.8)
    sks = interop.sketch_from_numpy(ld["blob_idx"], ld["blob_signs"], ld["blob_probs"],
                                    nb, coef=ld["blob_coef"], device="cpu")
    Cs, Ws = A.sketch_both(ops, sks, mesh=mesh)
    ev, U = SP.sketched_spectral_embedding(Cs.float(), Ws.float(), 2, mesh=mesh)
    U = D.gather_rows(mesh, U, nb)
    C1s, W1s = A.sketch_both(ops, sks)
    ev1, U1 = SP.sketched_spectral_embedding(C1s.float(), W1s.float(), 2)
    for who, (e_ref, u_ref) in {"port": (ev1, U1),
                                "jax": (_t(ld["blob_ev"]), _t(ld["blob_U"]))}.items():
        rep.put(f"spectral_ev_{who}", float(((ev - e_ref).abs() / e_ref.abs()).max()))
        # eigenvectors fixed up to a rotation of the top-k space: projectors
        rep.put(f"spectral_U_{who}", float((U @ U.T - u_ref @ u_ref.T).abs().max()))
    r1 = SP.spectral_cluster(0, ops, 2, d=24, m=4)
    rm = SP.spectral_cluster(0, ops, 2, d=24, m=4, mesh=mesh)
    lj = ld["blob_labels"]
    same_partition = bool(np.array_equal(rm.labels.numpy(), lj)
                          or np.array_equal(rm.labels.numpy(), 1 - lj))
    rep.put("spectral_labels", [_digest(rm.labels), torch.equal(rm.labels, r1.labels),
                                same_partition])
    rt = SP.spectral_cluster(0, ops, 2, d=24, tol=0.05, m_max=8, mesh=mesh)
    rt1 = SP.spectral_cluster(0, ops, 2, d=24, tol=0.05, m_max=8)
    rep.put("spectral_tol_labels", [_digest(rt.labels), torch.equal(rt.labels, rt1.labels),
                                    rt.info["m"] == rt1.info["m"]])


def _worker(rank: str, world: str, store: str, src: str, out: str) -> int:
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.FileStore(store, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=60))
    try:
        mesh = D.make_data_mesh(world, device="cpu")
        res = {n: _worker_checks(mesh, n, Path(src)) for n in NS}
    finally:
        torch.distributed.destroy_process_group()
    res["imports_jax"] = any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
    Path(out).write_text(json.dumps(res))
    return 0


# --------------------------------------------------------------------------- #
# the test process: JAX references, the spawns, the checks
# --------------------------------------------------------------------------- #

def _jax_references(dst: Path) -> None:
    """The JAX package's single-device results on the reference's data,
    written as ``{n}_{name}.npy``."""
    import jax
    import jax.numpy as jnp

    from repro.core import apply as AJ
    from repro.core import krr as KJ
    from repro.core import spectral as SJ
    from repro.core.kernel_op import KernelOperator as OpJ
    from repro.core.sketch import make_accum_sketch

    key = jax.random.PRNGKey(0)

    def save(n, **arrays):
        for k, v in arrays.items():
            np.save(dst / f"{n}_{k}.npy", np.asarray(v))

    def sketch(n, prefix, sk):
        save(n, **{f"{prefix}_idx": sk.indices, f"{prefix}_signs": sk.signs,
                   f"{prefix}_probs": sk.probs, f"{prefix}_coef": sk.coef})

    for n in NS:
        X = jax.random.uniform(key, (n, 3))          # tests/test_distributed.py _data
        y = (jnp.sin(3.0 * X[:, 0]) + X[:, 1] ** 2
             + 0.2 * jax.random.normal(jax.random.fold_in(key, 1), (n,)))
        save(n, X=X, y=y)
        opj = OpJ(X, "gaussian", bandwidth=0.6)
        skj = make_accum_sketch(key, n, D_, M_)
        sketch(n, "sk", skj)
        C, W = AJ.sketch_both(opj, skj, use_kernel=False)
        save(n, C=C, W=W)
        with jax.enable_x64(True):
            X64, y64 = jnp.asarray(np.asarray(X), jnp.float64), jnp.asarray(
                np.asarray(y), jnp.float64)
            op64 = OpJ(X64, "gaussian", bandwidth=0.6)
            sk64 = make_accum_sketch(key, n, D_, M_, dtype=jnp.float64)
            sketch(n, "sk64", sk64)
            f = KJ.krr_sketched_fit(op64, y64, LAM, sk64, use_kernel=False)
            save(n, fit_f64=f.fitted, pred_f64=f.predict(X64[:48] + 0.01),
                 matfree_f64=KJ.krr_sketched_fit_matfree(op64, y64, LAM, sk64,
                                                         use_kernel=False).fitted,
                 pcg_f64=KJ.krr_sketched_fit_pcg(op64, y64, LAM, sk64, iters=40,
                                                 use_kernel=False).fitted)
        op5 = OpJ(X, "gaussian", bandwidth=0.5)
        st = AJ.accum_init(key, n, D_, 8)
        save(n, st_idx=st.indices, st_signs=st.signs, st_probs=st.probs,
             st_pdraw=st.pdraw,
             hold=jax.random.choice(jax.random.fold_in(key, HOLDOUT_STREAM), n,
                                    shape=(min(64, n),), replace=False))
        g = AJ.accum_grow(op5, st, 5, use_kernel=False, donate=False)
        b = AJ.accum_grow_batched(op5, AJ.accum_grow_batched(
            op5, st, 3, use_kernel=False, donate=False), 5, use_kernel=False, donate=False)
        save(n, grow_C=g.C, grow_W=g.W, batched_C=b.C, batched_W=b.W)
        for schedule in ("doubling", "unit"):
            _, Cg, Wg, info = AJ.grow_sketch_both(key, op5, D_, m_max=8, tol=TOL[n],
                                                  use_kernel=False, schedule=schedule)
            save(n, **{f"{schedule}_C": Cg, f"{schedule}_W": Wg,
                       f"{schedule}_info": [int(info["m"]), int(info["passes"]),
                                            float(info["err"])]})
            if schedule == "doubling":
                # krr_sketched_fit_adaptive and _pcg_adaptive grow exactly this
                # (C, W) at this target (their default schedule and estimator)
                save(n, adaptive_theta=KJ._fit_from_C(Cg, Wg, y, LAM)[0],
                     pcg_adaptive_theta=KJ._pcg_solve(Cg, Wg, y, LAM, 30))
        # the estimators on the 5-slab state g
        hk = jax.random.fold_in(key, 5)
        save(n, e_hold=jax.random.choice(hk, n, shape=(64,), replace=False),
             e_probes=jax.random.rademacher(key, (n, 4), dtype=jnp.float32),
             e_values=[float(AJ.make_holdout_estimator(hk, op5)(g)),
                       float(AJ.make_hutchinson_estimator(key, op5, 4)(g))])
        if n not in BLOBS:
            continue
        # the reference's blobs (tests/test_distributed.py), 80 + (nb − 80) rows
        nb = BLOBS[n]
        k1, k2 = jax.random.split(key)
        Xs = jnp.concatenate([0.25 * jax.random.normal(k1, (80, 2)),
                              0.25 * jax.random.normal(k2, (nb - 80, 2))
                              + jnp.asarray([3.0, 0.0])])
        ops = OpJ(Xs, "gaussian", bandwidth=0.8)
        sks = make_accum_sketch(key, nb, 24, 4)
        sketch(n, "blob", sks)
        C0, W0 = AJ.sketch_both(ops, sks, use_kernel=False)
        ev, U = SJ.sketched_spectral_embedding(C0.astype(jnp.float32),
                                               W0.astype(jnp.float32), 2)
        save(n, blob_X=Xs, blob_ev=ev, blob_U=U, blob_labels=SJ.spectral_cluster(
            key, ops, 2, d=24, m=4, use_kernel=False).labels)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{D: [each rank's report]}: one spawn of D gloo ranks for each mesh
    size, all started together, each rank with its own timeout."""
    base = tmp_path_factory.mktemp("mesh")
    _jax_references(base)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    procs = {}
    for size in SIZES:
        store = base / f"store{size}"
        procs[size] = [(subprocess.Popen(
            [sys.executable, __file__, str(r), str(size), str(store), str(base),
             str(base / f"out{size}_{r}.json")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), base / f"out{size}_{r}.json")
            for r in range(size)]
    out = {}
    for size, ranks in procs.items():
        out[size] = []
        for p, path in ranks:
            try:
                log, _ = p.communicate(timeout=SPAWN_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                log = p.communicate()[0]
            out[size].append(json.loads(path.read_text()) if p.returncode == 0
                             else {"failed": f"exit {p.returncode}:\n{log[-4000:]}"})
    return out, base


def _reports(runs, size, n):
    reps = runs[0][size]
    for r in reps:
        assert "failed" not in r, r.get("failed")
        assert not r["imports_jax"]
    return [r[str(n)] for r in reps]


def _rel(reps, name):
    """The global relative error of a check from every rank's sums."""
    vals = [r[name] for r in reps]
    if vals[0][2]:
        return float(np.sqrt(sum(v[0] for v in vals) / max(sum(v[1] for v in vals), 1e-300)))
    return max(float(np.sqrt(v[0] / max(v[1], 1e-300))) for v in vals)


def _jax(runs, n, name):
    return np.load(runs[1] / f"{n}_{name}.npy")


CASES = [(s, n) for s in SIZES for n in NS]
IDS = [f"D{s}-n{n}" for s, n in CASES]


@pytest.mark.parametrize("size,n", CASES, ids=IDS)
def test_primitives(runs, size, n):
    reps = _reports(runs, size, n)
    assert all(r["take_rows_exact"] and r["gather_rows_exact"] for r in reps)
    assert _rel(reps, "gram") < 1e-5
    assert _rel(reps, "sketch_left") < 1e-6
    assert _rel(reps, "weighted_cols") < 1e-6
    assert _rel(reps, "matvec") < 1e-6


@pytest.mark.parametrize("size,n", CASES, ids=IDS)
def test_sketch_both(runs, size, n):
    reps = _reports(runs, size, n)
    for uk in (0, 1):
        assert _rel(reps, f"sketch_both_C_port_uk{uk}") < 1e-6
        assert _rel(reps, f"sketch_both_W_port_uk{uk}") < 1e-5
    assert _rel(reps, "sketch_both_C_jax") < 1e-5
    assert _rel(reps, "sketch_both_W_jax") < 1e-5


@pytest.mark.parametrize("fit", ["fit", "matfree", "pcg"])
@pytest.mark.parametrize("size,n", CASES, ids=IDS)
def test_krr_fits(runs, size, n, fit):
    """Fitted values to 1e-5 of both packages in float64.  In float32 the
    sums of CᵀC in another order move θ along the Woodbury system's
    ill-conditioned directions (the reference's own sharded float32 fitted
    values differ by up to 9.5e-6 on this data:
    scripts/reference_mesh_spread.py), so θ is held through the relative
    residual of the single-device d×d system instead."""
    reps = _reports(runs, size, n)
    assert _rel(reps, f"{fit}_f64_port") < 1e-5
    assert _rel(reps, f"{fit}_f64_jax") < 1e-5
    for r in reps:
        assert r[f"{fit}_f32_residual"][0] < 1e-5
    for dt in ("f64", "f32"):      # θ is replicated: the same bits on every rank
        assert len({r[f"{fit}_{dt}_theta"] for r in reps}) == 1


@pytest.mark.parametrize("size,n", CASES, ids=IDS)
def test_predict(runs, size, n):
    reps = _reports(runs, size, n)
    assert _rel(reps, "predict_f64_port") < 1e-5
    assert _rel(reps, "predict_f64_jax") < 1e-5
    assert _rel(reps, "predict_replicated_f64_jax") < 1e-5


@pytest.mark.parametrize("path", ["grow", "batched"])
@pytest.mark.parametrize("size,n", CASES, ids=IDS)
def test_engine_unconditional(runs, size, n, path):
    reps = _reports(runs, size, n)
    for who in ("port", "jax"):
        assert _rel(reps, f"{path}_C_{who}") < 1e-5
        assert _rel(reps, f"{path}_W_{who}") < 1e-5
    assert all(r["step_bitwise_grow"] for r in reps)


@pytest.mark.parametrize("schedule", ["doubling", "unit"])
@pytest.mark.parametrize("size,n", CASES, ids=IDS)
def test_engine_at_tol(runs, size, n, schedule):
    """The same m and passes as both packages' single-device growth, with
    bitwise the single-device draws on every rank."""
    reps = _reports(runs, size, n)
    jm = _jax(runs, n, f"{schedule}_info")
    for r in reps:
        m, passes, err = r[f"{schedule}_info"]
        assert [m, passes] == r[f"{schedule}_info_port"][:2] == [int(jm[0]), int(jm[1])]
        np.testing.assert_allclose(err, r[f"{schedule}_info_port"][2], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(err, jm[2], rtol=1e-4, atol=1e-6)
        assert 1 < m <= 8 and (err <= TOL[n] or m == 8)
        assert r[f"{schedule}_draws"][2]
    assert len({tuple(r[f"{schedule}_draws"][:2]) for r in reps}) == 1
    for who in ("port", "jax"):
        assert _rel(reps, f"{schedule}_C_{who}") < 1e-5
        assert _rel(reps, f"{schedule}_W_{who}") < 1e-5


@pytest.mark.parametrize("kind", ["seeded", "leverage"])
@pytest.mark.parametrize("size,n", CASES, ids=IDS)
def test_engine_own_draws(runs, size, n, kind):
    """The seed's own draws (and, for the leverage scheme, the redraws from
    the gathered C): bitwise the single-device draws on every rank."""
    reps = _reports(runs, size, n)
    assert all(r[f"{kind}_draws"][1] and r[f"{kind}_draws"][2] for r in reps)
    assert len({r[f"{kind}_draws"][0] for r in reps}) == 1
    assert _rel(reps, f"{kind}_C_port") < 1e-5


@pytest.mark.parametrize("fit", ["adaptive", "pcg_adaptive"])
@pytest.mark.parametrize("size,n", CASES, ids=IDS)
def test_adaptive_fits(runs, size, n, fit):
    reps = _reports(runs, size, n)
    jm = [int(v) for v in _jax(runs, n, "doubling_info")[:2]]
    for r in reps:
        assert r[f"{fit}_info"] == r[f"{fit}_info_port"] == jm
        # θ in the single-device engine's d×d system, as well solved as by
        # the port's and the reference's single-device θ (test_krr_fits)
        sharded, single, ref = r[f"{fit}_residual"]
        assert sharded < 1e-5 and single < 1e-5 and ref < 1e-5
    assert len({r[f"{fit}_theta"] for r in reps}) == 1


@pytest.mark.parametrize("kind", ["holdout", "hutchinson"])
@pytest.mark.parametrize("size,n", CASES, ids=IDS)
def test_estimators(runs, size, n, kind):
    reps = _reports(runs, size, n)
    ref = _jax(runs, n, "e_values")[0 if kind == "holdout" else 1]
    for r in reps:
        sharded, single = r[kind]
        np.testing.assert_allclose(sharded, single, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(sharded, ref, rtol=1e-4, atol=1e-6)
    assert len({r[kind][0] for r in reps}) == 1


@pytest.mark.parametrize("size,n", [(s, n) for s in SIZES for n in BLOBS],
                         ids=[f"D{s}-n{n}" for s in SIZES for n in BLOBS])
def test_spectral(runs, size, n):
    reps = _reports(runs, size, n)
    for r in reps:
        for who in ("port", "jax"):
            assert r[f"spectral_ev_{who}"] < 1e-5
            assert r[f"spectral_U_{who}"] < 1e-5
        assert all(r["spectral_labels"][1:]) and all(r["spectral_tol_labels"][1:])
    for key in ("spectral_labels", "spectral_tol_labels"):
        assert len({r[key][0] for r in reps}) == 1


if __name__ == "__main__":
    sys.exit(_worker(*sys.argv[1:]))
