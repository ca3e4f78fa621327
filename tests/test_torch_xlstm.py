"""Port parity for the xLSTM blocks (``models/xlstm.py``) and xlstm-125m
around them: the chunkwise mLSTM against the sequential recurrence and the
reference's, the sLSTM ``autograd.Function`` against autograd through the
token loop and ``jax.grad`` of the reference's ``custom_vjp``, decode
against forward, and the model through ``tests/torch_family_parity.py``
(forward, prefill, cache, decode, loss gradients, one ``train_step``).

The reference's draw is widened to float32 and carried across.  Tolerances
are the reference's own: 2e-4 for chunkwise against sequential
(tests/test_perf_equivalence.py), 5e-3 relative for their gradients, 1e-4
relative for the sLSTM backward (tests/test_perf_equivalence.py:59-80), and
2e-4 through the model (tests/torch_family_parity.py)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.models import model as MJ  # noqa: E402
from repro.models import xlstm as XJ  # noqa: E402
from repro.optim.adamw import AdamWConfig as AdamJ  # noqa: E402
from repro.train import step as SJ  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch._util import tree_leaves  # noqa: E402
from repro_torch.configs import ARCHS as ARCHS_T  # noqa: E402
from repro_torch.configs import reduced as reduced_t  # noqa: E402
from repro_torch.models import model as MT  # noqa: E402
from repro_torch.models import xlstm as XT  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.resilience import faults  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.train import step as ST  # noqa: E402

KEY = jax.random.PRNGKey(0)
ARCH = "xlstm-125m"
TOL = 2e-4
GRAD_TOL = 5e-3
SLSTM_TOL = 1e-4


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), tree)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def blocks():
    """The reduced config and one mLSTM and one sLSTM block, float32."""
    cj, ct = reduced(ARCHS[ARCH]), reduced_t(ARCHS_T[ARCH])
    pm, ps = _f32(XJ.init_mlstm(KEY, cj)), _f32(XJ.init_slstm(KEY, cj))
    return cj, ct, pm, ps, _t(pm), _t(ps)


@pytest.mark.parametrize("init, kind", [("init_mlstm", "m"), ("init_slstm", "s")])
def test_init_layout_matches_reference(init, kind):
    cj, ct = reduced(ARCHS[ARCH]), reduced_t(ARCHS_T[ARCH])
    pj = getattr(XJ, init)(KEY, cj)
    pt = getattr(XT, init)(torch.Generator().manual_seed(0), ct)
    assert pt.keys() == pj.keys()
    for k, v in pt.items():
        assert tuple(v.shape) == pj[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(pj[k].dtype), k
    for k in ("f_bias", "norm"):
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))


@pytest.mark.parametrize("L, chunk", [(8, 16), (64, 16), (96, 32)])
def test_mlstm_chunkwise_matches_sequential_and_reference(blocks, L, chunk):
    cj, ct, pm, _, tm, _ = blocks
    x = _x((2, L, cj.d_model))
    yt = XT.mlstm_forward(tm, torch.from_numpy(x), ct, chunk=chunk)
    _close(yt.numpy(), XT._mlstm_forward_seq(tm, torch.from_numpy(x), ct).numpy(), TOL)
    _close(yt.numpy(), XJ.mlstm_forward(pm, jnp.asarray(x), cj, chunk=chunk), TOL)
    _close(yt.numpy(), XJ._mlstm_forward_seq(pm, jnp.asarray(x), cj), TOL)


def test_mlstm_chunkwise_gradients_match_sequential(blocks):
    _, ct, _, _, tm, _ = blocks
    x = _x((2, 64, ct.d_model))
    w = torch.from_numpy(_x((2, 64, ct.d_model), seed=2))

    def grads(fn):
        p = {k: v.clone().requires_grad_() for k, v in tm.items()}
        xt = torch.from_numpy(x).requires_grad_()
        (fn(p, xt) * w).sum().backward()
        return [xt.grad] + [p[k].grad for k in sorted(p) if p[k].grad is not None]

    chunked = grads(lambda p, xt: XT.mlstm_forward(p, xt, ct, chunk=16))
    seq = grads(lambda p, xt: XT._mlstm_forward_seq(p, xt, ct))
    assert len(chunked) == len(seq) == 1 + 8       # every weight but norm
    for a, b in zip(chunked, seq):
        assert _rel(a, b) < GRAD_TOL


def _slstm_inputs(cj, ps, L=16, B=2, seed=3):
    rng = np.random.default_rng(seed)
    HD = cj.n_heads * cj.head_dim
    xs = [rng.standard_normal((L, B, HD)).astype(np.float32) for _ in range(4)]
    R = [np.asarray(ps[k]) for k in ("rz", "ri", "rf", "rog")]
    g = rng.standard_normal((L, B, cj.n_heads, cj.head_dim)).astype(np.float32)
    return R, np.asarray(ps["f_bias"]), xs, g


def _torch_grads(fn, R, fb, xs, g):
    Rt = [torch.from_numpy(r.copy()).requires_grad_() for r in R]
    fbt = torch.from_numpy(fb.copy()).requires_grad_()
    xt = [torch.from_numpy(x).requires_grad_() for x in xs]
    hs = fn(Rt, fbt, *xt)
    (hs * torch.from_numpy(g)).sum().backward()
    return hs.detach(), [r.grad for r in Rt] + [fbt.grad] + [x.grad for x in xt]


def test_slstm_function_matches_autograd_and_reference(blocks):
    """The backward loop emitting pre-activation gradients, dR as one
    product after it, against autograd through the plain token loop and
    against jax.grad of the reference's custom_vjp."""
    cj, _, _, ps, _, _ = blocks
    R, fb, xs, g = _slstm_inputs(cj, ps)
    hs_f, g_f = _torch_grads(XT.slstm_scan, R, fb, xs, g)
    hs_p, g_p = _torch_grads(XT.slstm_scan_plain, R, fb, xs, g)
    hs_j = XJ._slstm_scan(tuple(R), fb, *xs)
    gj = jax.grad(lambda R, fb, *xs: jnp.sum(XJ._slstm_scan(tuple(R), fb, *xs) * g),
                  argnums=tuple(range(6)))(R, fb, *xs)
    g_j = list(gj[0]) + list(gj[1:])
    _close(hs_f.numpy(), hs_p.numpy(), SLSTM_TOL)
    _close(hs_f.numpy(), hs_j, SLSTM_TOL)
    assert len(g_f) == len(g_p) == len(g_j) == 9
    for a, b, c in zip(g_f, g_p, g_j):
        assert _rel(a, b) < SLSTM_TOL and _rel(a, c) < SLSTM_TOL


def test_slstm_function_passes_gradcheck():
    """float64 at L = 4, B = 2, H = 2, Dh = 3."""
    L, B, H, Dh = 4, 2, 2, 3
    g = torch.Generator().manual_seed(0)
    R = (0.5 * torch.randn((H, Dh, 4 * Dh), generator=g, dtype=torch.float64)
         ).requires_grad_()
    X = torch.randn((L, H, B, 4 * Dh), generator=g, dtype=torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(XT.SLSTMScan.apply, (R, X))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_forward_matches_decode(blocks, kind):
    """Forward from the zero state against the per-token decode, and the
    token-scan prefill's state against the decode's."""
    cj, ct, _, _, tm, ts = blocks
    p = tm if kind == "mlstm" else ts
    x = torch.from_numpy(_x((2, 24, ct.d_model)))
    init = getattr(XT, f"init_{kind}_state")
    decode = getattr(XT, f"{kind}_decode")
    y = getattr(XT, f"{kind}_forward")(p, x, ct)
    st = init(ct, 2, device="cpu")
    steps = []
    for t in range(x.shape[1]):
        yt, st = decode(p, x[:, t:t + 1], st, ct)
        steps.append(yt)
    _close(torch.cat(steps, dim=1).numpy(), y.numpy(), TOL)
    yp, sp = getattr(XT, f"{kind}_prefill")(p, x, init(ct, 2, device="cpu"), ct)
    _close(yp.numpy(), y.numpy(), TOL)
    for a, b in zip(sp, st):
        assert a.shape == b.shape and a.dtype == torch.float32
        _close(a.numpy(), b.numpy(), TOL)


def test_decode_states_match_reference(blocks):
    cj, ct, pm, ps, tm, ts = blocks
    x = _x((2, 6, cj.d_model))
    for p_j, p_t, kind in ((pm, tm, "mlstm"), (ps, ts, "slstm")):
        sj = getattr(XJ, f"init_{kind}_state")(cj, 2)
        st = getattr(XT, f"init_{kind}_state")(ct, 2, device="cpu")
        for t in range(x.shape[1]):
            yj, sj = getattr(XJ, f"{kind}_decode")(p_j, jnp.asarray(x[:, t:t + 1]), sj, cj)
            yt, st = getattr(XT, f"{kind}_decode")(p_t, torch.from_numpy(x[:, t:t + 1]), st, ct)
            _close(yt.numpy(), yj, TOL)
        carried = interop.cache_from_numpy(jax.tree_util.tree_map(np.asarray, sj),
                                           device="cpu")
        assert type(carried) is type(st)
        for a, b in zip(st, carried):
            _close(a.numpy(), b.numpy(), TOL)


# --------------------------------------------------------------------------- #
# the model: reduced xlstm-125m at two superblocks
# --------------------------------------------------------------------------- #

def test_model_forward_and_prefill_match_reference():
    from torch_family_parity import check_forward_and_prefill
    check_forward_and_prefill(ARCH)


@pytest.mark.parametrize("use_sketch", [False, True])
def test_model_prefill_with_cache_and_decode_match_reference(use_sketch):
    from torch_family_parity import check_cache_and_decode
    check_cache_and_decode(ARCH, use_sketch)


def test_model_loss_and_gradients_match_reference():
    from torch_family_parity import check_loss_and_gradients
    check_loss_and_gradients(ARCH)


def test_model_decode_matches_forward_at_the_recurrent_tolerance():
    from torch_family_parity import check_decode_matches_forward
    check_decode_matches_forward(ARCH)


def test_train_step_matches_reference():
    """One train_step from the same TrainState, remat="full" (the sLSTM
    Function recomputed in the backward), at 2e-4 as the dense models."""
    kw = dict(n_layers=4, n_superblocks=2)
    cj = dataclasses.replace(reduced(ARCHS[ARCH]), **kw)
    ct = dataclasses.replace(reduced_t(ARCHS_T[ARCH]), **kw)
    opt = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    tcj = SJ.TrainConfig(optimizer=AdamJ(**opt), remat="full", q_chunk=16)
    tct = ST.TrainConfig(optimizer=AdamWConfig(**opt), remat="full", q_chunk=16)
    sj = SJ.init_train_state(_f32(MJ.init_params(KEY, cj)), tcj)
    st = interop.train_state_from_numpy(jax.tree_util.tree_map(np.asarray, sj), ct,
                                        device="cpu")
    rng = np.random.default_rng(4)
    tok = rng.integers(0, cj.vocab_size, (4, 33)).astype(np.int32)
    sj2, mj = jax.jit(lambda s, t, lb: SJ.train_step(s, t, lb, jnp.int32(3), cj, tcj))(
        sj, jnp.asarray(tok[:, :-1]), jnp.asarray(tok[:, 1:]))
    st2, mt = ST.train_step(st, torch.from_numpy(tok[:, :-1]).long(),
                            torch.from_numpy(tok[:, 1:]).long(), 3, ct, tct)
    _close(mt["loss"].item(), mj["loss"], TOL)
    _close(mt["grad_norm"].item(), mj["grad_norm"], TOL)
    for name in ("m", "v", "master"):
        for a, b in zip(tree_leaves(getattr(st2.opt, name)),
                        jax.tree_util.tree_leaves(getattr(sj2.opt, name))):
            _close(a, b, TOL)


@pytest.fixture(scope="module")
def model():
    from torch_family_parity import build
    return build(ARCH)


def test_sketched_engine_gives_the_exact_tokens(model):
    """No attention layer: use_sketch=True is accepted (as by the
    reference's engine) and changes no bit of the tokens."""
    _, ct, _, pt = model
    prompts = np.random.default_rng(5).integers(0, ct.vocab_size, (2, 12)).astype(np.int32)
    out = [Engine(ct, pt, ServeConfig(max_len=24, use_sketch=s, temperature=0.7, seed=1)
                  ).generate(prompts, 8)[0] for s in (False, True)]
    np.testing.assert_array_equal(out[0], out[1])


def test_engine_kill_and_resume_on_reduced_xlstm(model, tmp_path, monkeypatch):
    _, ct, _, pt = model
    prompts = np.random.default_rng(6).integers(0, ct.vocab_size, (2, 10)).astype(np.int32)
    kw = dict(max_len=32, temperature=0.7, seed=2, ckpt_every=3)
    ref, _ = Engine(ct, pt, ServeConfig(**kw)).generate(prompts, 10)
    monkeypatch.setenv(faults.ENV_PLAN, '{"decode.step": {"action": "kill", "at": 2}}')
    faults.reset()
    with pytest.raises(faults.DeviceLost):
        Engine(ct, pt, ServeConfig(ckpt_dir=str(tmp_path), **kw)).generate(
            prompts, 10, request_id="r")
    monkeypatch.delenv(faults.ENV_PLAN)
    faults.reset()
    eng = Engine(ct, pt, ServeConfig(ckpt_dir=str(tmp_path), **kw))
    toks, _ = eng.generate(prompts, 10, request_id="r")
    np.testing.assert_array_equal(toks, ref)
    assert eng.health.count("ckpt.resume") == 1
