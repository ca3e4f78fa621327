"""Port parity for training: ``models.common.chunked_xent``,
``models.model.loss_fn`` with its remat policies, ``train.step.train_step``,
the loop (``train.loop.run``) and the launcher (``launch.train``).

Both packages start from the same numpy inputs: the reference's
``init_params`` draw (widened to float32 unless a case says otherwise) and
its ``TrainState``, carried across with ``interop.train_state_from_numpy``;
the reference's tokens are fed to both.  Tolerances follow the forward's
2e-4 relative to the largest entry (tests/test_torch_models.py): the float32
sums of two packages drift through the blocks, and a gradient adds one
backward pass.  New parameters are bfloat16 in both packages (the
reference's ``train_step`` casts every leaf with ``adamw_update``'s default
``param_dtype``), so each is its float32 master rounded: they are held to
one bfloat16 rounding step (2⁻⁸ relative) beside the masters at 2e-4."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.core.sketch import make_accum_sketch as make_sketch_j  # noqa: E402
from repro.data.pipeline import DataConfig as DataJ  # noqa: E402
from repro.data.pipeline import global_batch as global_batch_j  # noqa: E402
from repro.models import common as CJ  # noqa: E402
from repro.models import model as MJ  # noqa: E402
from repro.optim.adamw import AdamWConfig as AdamJ  # noqa: E402
from repro.optim.compress import CompressConfig as CompJ  # noqa: E402
from repro.train import step as SJ  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch._util import tree_leaves  # noqa: E402
from repro_torch.configs import ARCHS as ARCHS_T  # noqa: E402
from repro_torch.configs import reduced as reduced_t  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import common as CT  # noqa: E402
from repro_torch.models import model as MT  # noqa: E402
from repro_torch.optim import compress as COMP_T  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.optim.compress import CompressConfig  # noqa: E402
from repro_torch.train import loop as LT  # noqa: E402
from repro_torch.train import step as ST  # noqa: E402

KEY = jax.random.PRNGKey(0)
TOL = 2e-4
BF16_STEP = 2.0 ** -8
LOSS_ARCHS = ["stablelm-3b", "minitron-8b", "qwen1.5-110b", "gemma3-12b"]


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _cfgs(arch, **kw):
    return (dataclasses.replace(reduced(ARCHS[arch]), **kw),
            dataclasses.replace(reduced_t(ARCHS_T[arch]), **kw))


def _tokens(vocab, shape=(2, 32), seed=1):
    tok = np.random.default_rng(seed).integers(0, vocab, (shape[0], shape[1] + 1))
    return tok[:, :-1], tok[:, 1:]


# --------------------------------------------------------------------------- #
# chunked_xent
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("chunk", [512, 16], ids=["one-chunk", "three-chunks"])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_xent_matches_reference(chunk, masked):
    rng = np.random.default_rng(0)
    B, S, D, V = 2, 48, 8, 40
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    emb = rng.standard_normal((V, D)).astype(np.float32)
    labels = rng.integers(0, V, (B, S))
    mask = (rng.random((B, S)) < 0.7).astype(np.float32) if masked else None

    def fj(hh, ee):
        return CJ.chunked_xent(hh, ee, jnp.asarray(labels), None if mask is None
                               else jnp.asarray(mask), chunk=chunk)
    (lj, cj), (ghj, gej) = jax.value_and_grad(fj, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(emb))
    ht = torch.from_numpy(h).requires_grad_()
    et = torch.from_numpy(emb).requires_grad_()
    lt, ct = CT.chunked_xent(ht, et, torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask), chunk=chunk)
    lt.backward()
    _close(lt.item(), lj, TOL)
    assert ct.item() == float(cj)
    _close(ht.grad, ghj, TOL)
    _close(et.grad, gej, TOL)


def test_chunked_xent_refuses_a_length_the_chunks_do_not_divide():
    h = np.zeros((1, 50, 4), np.float32)
    with pytest.raises(TypeError):
        CJ.chunked_xent(jnp.asarray(h), jnp.zeros((8, 4)), jnp.zeros((1, 50), jnp.int32),
                        None, chunk=16)
    with pytest.raises(RuntimeError):
        CT.chunked_xent(torch.from_numpy(h), torch.zeros(8, 4),
                        torch.zeros((1, 50), dtype=torch.long), None, chunk=16)


# --------------------------------------------------------------------------- #
# loss_fn and the remat policies
# --------------------------------------------------------------------------- #

def _f32(tree):
    return jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), tree)


@pytest.fixture(scope="module", params=LOSS_ARCHS)
def loss_case(request):
    cj, ct = _cfgs(request.param, n_layers=2 * len(reduced(ARCHS[request.param]).pattern),
                   n_superblocks=2)
    pj = _f32(MJ.init_params(KEY, cj))
    pt = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct, device="cpu")
    tok, lab = _tokens(cj.vocab_size)
    return cj, ct, pj, pt, tok, lab


def _torch_grads(pt, tok, lab, ct, remat):
    tc = ST.TrainConfig(remat=remat, q_chunk=16)
    return ST._value_and_grad(pt, torch.from_numpy(tok), torch.from_numpy(lab), None, ct, tc)


def test_loss_fn_and_gradients_match_reference(loss_case):
    cj, ct, pj, pt, tok, lab = loss_case
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: MJ.loss_fn(p, jnp.asarray(tok), jnp.asarray(lab), cj, q_chunk=16,
                             remat="none"), has_aux=True))(pj)
    lt, mt, gt = _torch_grads(pt, tok, lab, ct, "none")
    _close(lt.item(), lj, TOL)
    _close(mt["xent"].item(), mj["xent"], TOL)
    assert mt["aux"].item() == float(mj["aux"]) == 0.0
    assert mt["tokens"].item() == float(mj["tokens"]) == tok.size
    flat_j = jax.tree_util.tree_leaves(gj)
    assert len(flat_j) == len(tree_leaves(gt))
    for a, b in zip(tree_leaves(gt), flat_j):
        assert tuple(a.shape) == b.shape
        _close(a, b, TOL)


def test_remat_policies_are_bitwise_equal(loss_case):
    _, ct, _, pt, tok, lab = loss_case
    l0, _, g0 = _torch_grads(pt, tok, lab, ct, "none")
    for remat in ("dots", "full"):
        lr, _, gr = _torch_grads(pt, tok, lab, ct, remat)
        assert torch.equal(lr, l0), remat
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(gr), tree_leaves(g0))), remat
    with pytest.raises(ValueError, match="remat"):
        _torch_grads(pt, tok, lab, ct, "everything")


def test_loss_fn_refuses_conditioning_input():
    """A conditioning input must be (batch, cond_len, d_model) embeddings:
    another width or batch is refused by name (a well-formed one is held
    against the reference in tests/test_torch_models.py)."""
    _, ct = _cfgs("stablelm-3b")
    pt = MT.init_params(0, ct, device="cpu")
    tok = torch.zeros((1, 8), dtype=torch.long)
    for bad in (torch.zeros((1, 2, ct.d_model + 1)), torch.zeros((2, 2, ct.d_model))):
        with pytest.raises(ValueError, match="cond"):
            MT.loss_fn(pt, tok, tok, ct, cond=bad)


# --------------------------------------------------------------------------- #
# train_step against the reference's, from one TrainState
# --------------------------------------------------------------------------- #

CASES = {
    "n_micro1": dict(n_micro=1),
    "n_micro2": dict(n_micro=2),
    "compress": dict(n_micro=1, compress=(0.25, 4, 256)),
    "bf16": dict(n_micro=1, bf16=True),
}
# bfloat16 parameters: both packages round every activation and gradient to
# bfloat16 (2⁻⁸ relative), in another order, through two superblocks, so the
# gradients — and with them m and v — agree to about 1–2% in norm (held at
# 8 bfloat16 steps, 2⁻⁵, in norm); Adam's first step moves each master
# weight by about lr·sign(g), and a weight whose gradient is near 0 may move
# the other way, so the masters and parameters are held in norm at one
# bfloat16 step, and the loss and gradient norm at one step
BF16_STATE_TOL = 8 * BF16_STEP


def _close_norm(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference(case, monkeypatch):
    spec = CASES[case]
    cj, ct = _cfgs("stablelm-3b", n_layers=2, n_superblocks=2)
    comp = spec.get("compress")
    opt = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    tcj = SJ.TrainConfig(optimizer=AdamJ(**opt), n_micro=spec["n_micro"], remat="full",
                         q_chunk=16, compress=CompJ(*comp) if comp else None)
    tct = ST.TrainConfig(optimizer=AdamWConfig(**opt), n_micro=spec["n_micro"], remat="full",
                         q_chunk=16, compress=CompressConfig(*comp) if comp else None)
    pj = MJ.init_params(KEY, cj)
    if not spec.get("bf16"):
        pj = _f32(pj)
    sj = SJ.init_train_state(pj, tcj)
    st = interop.train_state_from_numpy(jax.tree_util.tree_map(np.asarray, sj), ct,
                                        device="cpu")
    if comp:
        def carried(seed, step, i, p, cfg, device):
            sk = make_sketch_j(jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(seed), step), i), p, max(int(p * cfg.ratio), 1), cfg.m)
            return interop.sketch_from_numpy(sk.indices, sk.signs, sk.probs, p, device=device)
        monkeypatch.setattr(COMP_T, "leaf_sketch", carried)
    tok, lab = global_batch_j(DataJ(cj.vocab_size, 32, 4), 3)
    sj2, mj = jax.jit(lambda s, t, lb, i: SJ.train_step(s, t, lb, i, cj, tcj))(
        sj, jnp.asarray(tok), jnp.asarray(lab), jnp.int32(3))
    st2, mt = ST.train_step(st, torch.from_numpy(tok).long(), torch.from_numpy(lab).long(), 3,
                            ct, tct)
    bf16 = spec.get("bf16")
    tol = BF16_STEP if bf16 else TOL
    _close(mt["loss"].item(), mj["loss"], tol)
    _close(mt["grad_norm"].item(), mj["grad_norm"], tol)
    assert int(st2.opt.step) == int(sj2.opt.step) == 1
    for name in ("m", "v", "master"):
        for a, b in zip(tree_leaves(getattr(st2.opt, name)),
                        jax.tree_util.tree_leaves(getattr(sj2.opt, name))):
            if not bf16:
                _close(a, b, TOL)
            else:
                _close_norm(a, b, BF16_STEP if name == "master" else BF16_STATE_TOL)
    for a, b, w in zip(tree_leaves(st2.params), jax.tree_util.tree_leaves(sj2.params),
                       tree_leaves(st2.opt.master)):
        assert a.dtype == torch.bfloat16 and str(b.dtype) == "bfloat16"
        assert torch.equal(a, w.to(torch.bfloat16))
        want = np.asarray(b, np.float32)
        if not bf16:
            _close(a.float(), want, BF16_STEP)
        else:
            _close_norm(a.float(), want, BF16_STEP)
    if comp:
        assert mt["compress_ratio"] == pytest.approx(float(mj["compress_ratio"]), rel=1e-6)
        efj = [e for e in jax.tree_util.tree_leaves(sj2.ef)]
        eft = [e for e in tree_leaves(st2.ef) if e is not None]
        assert len(eft) == len(efj) == 2             # embed and lm_head
        for a, b in zip(eft, efj):
            _close(a, b, TOL)
    else:
        assert st2.ef is None and sj2.ef is None


# --------------------------------------------------------------------------- #
# the loop: trains, resumes, resumes bitwise
# --------------------------------------------------------------------------- #

def _loop_setup(compress=None):
    cfg = reduced_t(ARCHS_T["qwen2-vl-2b"]).scaled(frontend=None, cond_len=0)
    tc = ST.TrainConfig(optimizer=AdamWConfig(lr_peak=5e-3, warmup_steps=2, total_steps=40),
                        compress=compress)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    return cfg, tc, dc, lambda: ST.init_train_state(MT.init_params(0, cfg, device="cpu"), tc)


def test_loop_trains_and_resumes(tmp_path):
    cfg, tc, dc, mk = _loop_setup()
    lc = LT.LoopConfig(total_steps=8, ckpt_dir=str(tmp_path), ckpt_every=4, log_every=100)
    rep = LT.run(cfg, tc, dc, lc, init_params_fn=mk, log=lambda *a: None)
    assert rep.final_loss < rep.losses[0] and rep.resumed_from is None
    lc2 = LT.LoopConfig(total_steps=10, ckpt_dir=str(tmp_path), ckpt_every=4, log_every=100)
    rep2 = LT.run(cfg, tc, dc, lc2, init_params_fn=mk, log=lambda *a: None)
    assert rep2.resumed_from == 8 and rep2.steps_run == 2
    assert not torch.are_deterministic_algorithms_enabled()


def test_resumed_run_is_bitwise_the_uninterrupted_run(tmp_path):
    """With compression on: 8 steps in one run against 4 steps, a checkpoint
    and a fresh run resumed to step 8 — the losses of steps 4–7 and the final
    parameters, AdamW state and error feedback bit for bit."""
    cfg, tc, dc, mk = _loop_setup(CompressConfig(ratio=0.25, m=4, min_rows=256))
    finals = {}

    def capture(key):
        def fn(s, t, lb, i):
            s, m = ST.train_step(s, t, lb, i, cfg, tc)
            finals[key] = s
            return s, m
        return fn
    quiet = dict(log=lambda *a: None)
    whole = LT.run(cfg, tc, dc, LT.LoopConfig(total_steps=8, log_every=100),
                   init_params_fn=mk, step_fn=capture("whole"), **quiet)
    d = str(tmp_path / "ck")
    LT.run(cfg, tc, dc, LT.LoopConfig(total_steps=4, ckpt_dir=d, ckpt_every=100, keep=1,
                                      log_every=100), init_params_fn=mk, **quiet)
    resumed = LT.run(cfg, tc, dc, LT.LoopConfig(total_steps=8, ckpt_dir=d, ckpt_every=100,
                                                keep=1, log_every=100),
                     init_params_fn=mk, step_fn=capture("resumed"), **quiet)
    assert resumed.resumed_from == 4 and resumed.losses == whole.losses[4:]
    a, b = tree_leaves(finals["whole"]), tree_leaves(finals["resumed"])
    assert len(a) == len(b) and sum(x is None for x in a) > 0
    assert all(x is None and y is None or torch.equal(x, y) for x, y in zip(a, b))


# --------------------------------------------------------------------------- #
# the launcher and its error paths
# --------------------------------------------------------------------------- #

def test_launcher_runs_reduced_on_the_cpu(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    args = ["--arch", "stablelm-3b", "--reduced", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq", "16", "--compress", "--ckpt-dir", str(tmp_path)]
    assert launch_train.main(args) == 0
    out = capsys.readouterr().out
    assert "ran 4 steps (resumed_from=None)" in out and "ranks=1" in out
    assert launch_train.main([*args[:6], "6", *args[7:]]) == 0
    assert "ran 2 steps (resumed_from=4)" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_launcher_production_meshes_raise_naming_the_roadmap_item(mesh):
    # one process has too few ranks for the production mesh: the message
    # names the count, as the reference's names the devices it found
    need = "512" if mesh == "multipod" else "256"
    with pytest.raises(RuntimeError, match=f"needs {need} ranks, found 1"):
        launch_train.main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                           "--mesh", mesh])
    assert not torch.distributed.is_initialized()


def test_debug_mesh_with_a_model_axis_raises():
    # a model axis of 2 needs two ranks of an initialised process group
    from repro_torch.launch.mesh import make_debug_mesh

    with pytest.raises(RuntimeError, match=r"mesh \(1, 2\) needs 2 ranks, found 1"):
        make_debug_mesh(1, 2, device="cpu")
