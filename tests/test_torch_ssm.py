"""Port parity for the Mamba-2 mixer (``models/ssm.py``) and the hybrid
zamba2 model around it: ``init_mamba2``'s layout, ``mamba2_forward`` (the
chunked SSD) and ``mamba2_decode`` step by step against the reference's,
the token-scan prefill against the sequential decode, and the state's round
trips (``interop.cache_from_numpy``, ``ckpt.save``/``restore`` of a hybrid
``DecodeCache`` bitwise, the engine's kill-and-resume on reduced zamba2).

The reference's draw is widened to float32 and carried across.  Module
values at 1e-5 relative to the largest entry (float32, sum order only);
through the model at 2e-4 (tests/torch_family_parity.py)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.models import model as MJ  # noqa: E402
from repro.models import ssm as SJ  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch._util import tree_leaves  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import ARCHS as ARCHS_T  # noqa: E402
from repro_torch.configs import reduced as reduced_t  # noqa: E402
from repro_torch.models import model as MT  # noqa: E402
from repro_torch.models import ssm as ST  # noqa: E402
from repro_torch.resilience import faults  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

KEY = jax.random.PRNGKey(0)
TOL = 1e-5
ARCH = "zamba2-7b"


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), tree)


@pytest.fixture(scope="module")
def mixer():
    """The reduced config and one Mamba-2 block's parameters, float32."""
    cj, ct = reduced(ARCHS[ARCH]), reduced_t(ARCHS_T[ARCH])
    pj = _f32(SJ.init_mamba2(KEY, cj))
    pt = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), pj)
    return cj, ct, pj, pt


@pytest.fixture(scope="module")
def hybrid():
    """Reduced zamba2 (mamba2, mamba2, attn_shared) at two superblocks."""
    cj = dataclasses.replace(reduced(ARCHS[ARCH]), n_layers=6, n_superblocks=2)
    ct = dataclasses.replace(reduced_t(ARCHS_T[ARCH]), n_layers=6, n_superblocks=2)
    pj = _f32(MJ.init_params(KEY, cj))
    pt = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct, device="cpu")
    return cj, ct, pj, pt


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_init_mamba2_layout_matches_reference(mixer):
    cj, ct, _, _ = mixer
    pj = SJ.init_mamba2(KEY, cj)
    pt = ST.init_mamba2(torch.Generator().manual_seed(0), ct)
    assert pt.keys() == pj.keys()
    for k, v in pt.items():
        assert tuple(v.shape) == pj[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(pj[k].dtype), k
    for k in ("A_log", "D", "dt_bias", "conv_b"):
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))
    assert ST._dims(ct) == SJ._dims(cj)


@pytest.mark.parametrize("L", [8, 32])
def test_mamba2_forward_matches_reference(mixer, L):
    """One chunk (L = Q) and four chunks (the inter-chunk scan)."""
    cj, ct, pj, pt = mixer
    x = _x((2, L, cj.d_model))
    _close(ST.mamba2_forward(pt, torch.from_numpy(x), ct).numpy(),
           SJ.mamba2_forward(pj, jnp.asarray(x), cj), TOL)


def test_mamba2_forward_refuses_a_length_the_chunk_does_not_divide(mixer):
    _, ct, _, pt = mixer
    with pytest.raises(ValueError, match="multiple of the chunk length"):
        ST.mamba2_forward(pt, torch.zeros((1, 12, ct.d_model)), ct)


def test_mamba2_decode_step_by_step_matches_reference(mixer):
    """Outputs and both state tensors after every one of 12 steps, from a
    bfloat16 conv window (the cache dtype) as in serving."""
    cj, ct, pj, pt = mixer
    x = _x((2, 12, cj.d_model), seed=2)
    sj = SJ.init_ssm_state(cj, 2, jnp.bfloat16)
    stt = ST.init_ssm_state(ct, 2, torch.bfloat16, device="cpu")
    for t in range(x.shape[1]):
        yj, sj = SJ.mamba2_decode(pj, jnp.asarray(x[:, t:t + 1]), sj, cj)
        yt, stt = ST.mamba2_decode(pt, torch.from_numpy(x[:, t:t + 1]), stt, ct)
        _close(yt.numpy(), yj, TOL)
        _close(stt.ssm.numpy(), sj.ssm, TOL)
        _close(stt.conv.float().numpy(), np.asarray(sj.conv, np.float32), TOL)
        assert stt.conv.dtype == torch.bfloat16 and stt.ssm.dtype == torch.float32


def test_token_scan_prefill_is_the_sequential_decode(mixer):
    """``mamba2_prefill`` (the state-independent parts for all tokens at
    once, the recurrence token by token) from a non-zero state gives the
    outputs and the state of 10 ``mamba2_decode`` steps, and the reference's
    token scan."""
    cj, ct, pj, pt = mixer
    x = _x((2, 10, cj.d_model), seed=3)
    st0 = ST.init_ssm_state(ct, 2, torch.float32, device="cpu")
    st0 = ST.SSMState(torch.from_numpy(_x(tuple(st0.conv.shape), 4)),
                      torch.from_numpy(_x(tuple(st0.ssm.shape), 5)))
    y_p, st_p = ST.mamba2_prefill(pt, torch.from_numpy(x), st0, ct)
    st, ys = st0, []
    for t in range(x.shape[1]):
        y, st = ST.mamba2_decode(pt, torch.from_numpy(x[:, t:t + 1]), st, ct)
        ys.append(y)
    _close(y_p.numpy(), torch.cat(ys, dim=1).numpy(), TOL)
    _close(st_p.ssm.numpy(), st.ssm.numpy(), TOL)
    # the window holds in_proj's rows: one product over 10 tokens against 10
    # one-token products, float32 sum order
    _close(st_p.conv.numpy(), st.conv.numpy(), TOL)
    sj = SJ.SSMState(jnp.asarray(st0.conv.numpy()), jnp.asarray(st0.ssm.numpy()))

    def tok(s, x_t):
        y, s = SJ.mamba2_decode(pj, x_t[:, None], s, cj)
        return s, y[:, 0]

    sj, yj = jax.lax.scan(tok, sj, jnp.asarray(x).swapaxes(0, 1))
    _close(y_p.numpy(), np.asarray(yj).swapaxes(0, 1), TOL)
    _close(st_p.ssm.numpy(), sj.ssm, TOL)


def test_mamba2_forward_and_decode_agree(mixer):
    """The chunked SSD and the recurrence are one function: the forward's
    outputs against the token scan's (float32, 1e-5)."""
    _, ct, _, pt = mixer
    x = torch.from_numpy(_x((2, 16, ct.d_model), seed=6))
    y_p, _ = ST.mamba2_prefill(pt, x, ST.init_ssm_state(ct, 2, torch.float32, device="cpu"),
                               ct)
    _close(ST.mamba2_forward(pt, x, ct).numpy(), y_p.numpy(), TOL)


# --------------------------------------------------------------------------- #
# the state's round trips
# --------------------------------------------------------------------------- #

def test_cache_from_numpy_carries_an_ssm_state(mixer):
    cj, _, _, _ = mixer
    sj = SJ.init_ssm_state(cj, 2, jnp.bfloat16)
    sj = SJ.SSMState(sj.conv + jnp.bfloat16(0.5), sj.ssm + 0.25)
    got = interop.cache_from_numpy(jax.tree_util.tree_map(np.asarray, sj), device="cpu")
    assert isinstance(got, ST.SSMState)
    assert got.conv.dtype == torch.bfloat16 and got.ssm.dtype == torch.float32
    np.testing.assert_array_equal(got.conv.float().numpy(), np.asarray(sj.conv, np.float32))
    np.testing.assert_array_equal(got.ssm.numpy(), np.asarray(sj.ssm))


@pytest.mark.parametrize("use_sketch", [False, True])
def test_checkpoint_round_trip_of_a_hybrid_cache_is_bitwise(hybrid, tmp_path, monkeypatch,
                                                            use_sketch):
    """A prefilled zamba2 cache (bfloat16 conv windows, float32 SSM states,
    exact or sketched attention caches) saved and restored bit for bit."""
    _, ct, _, pt = hybrid
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    eng = Engine(ct, pt, ServeConfig(max_len=64, use_sketch=use_sketch))
    prompts = np.random.default_rng(7).integers(0, ct.vocab_size, (2, 12))
    cache, _ = eng.prefill_tokens(eng.new_cache(2), prompts)
    kinds = {type(st).__name__ for states in cache.blocks.values() for st in states}
    assert "SSMState" in kinds
    ckpt.save(str(tmp_path), {"cache": cache}, step=1)
    back, _ = ckpt.restore(str(tmp_path), {"cache": eng.new_cache(2)})
    a, b = tree_leaves(back["cache"]), tree_leaves(cache)
    assert len(a) == len(b)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    assert isinstance(back["cache"].blocks["pos0"][1], ST.SSMState)


def test_engine_kill_and_resume_on_reduced_zamba2(hybrid, tmp_path, monkeypatch):
    """A sketched generate killed at its 2nd decode chunk and resumed by a
    fresh engine emits the uninterrupted tokens bitwise (temperature
    sampling and shared slots: every draw and every state matters)."""
    _, ct, _, pt = hybrid
    kw = dict(max_len=64, use_sketch=True, temperature=0.7, seed=3, ckpt_every=2)
    prompts = np.random.default_rng(8).integers(0, ct.vocab_size, (2, 8)).astype(np.int32)
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    ref, _ = Engine(ct, pt, ServeConfig(**kw)).generate(prompts, 6)
    monkeypatch.setenv(faults.ENV_PLAN, '{"decode.step": {"action": "kill", "at": 2}}')
    faults.reset()
    with pytest.raises(faults.DeviceLost):
        Engine(ct, pt, ServeConfig(ckpt_dir=str(tmp_path), **kw)).generate(
            prompts, 6, request_id="r")
    monkeypatch.delenv(faults.ENV_PLAN)
    faults.reset()
    eng = Engine(ct, pt, ServeConfig(ckpt_dir=str(tmp_path), **kw))
    toks, _ = eng.generate(prompts, 6, request_id="r")
    np.testing.assert_array_equal(toks, ref)
    assert eng.health.count("ckpt.resume") == 1


def test_engine_screens_the_ssm_state_and_rebuilds_a_hybrid(hybrid, monkeypatch):
    """A non-finite SSM state is caught by the health screen; the exact
    rebuild re-prefills the hybrid (token scan included), and with identity
    slots (max_len ≤ d_slots) the tokens are the clean run's."""
    _, ct, _, pt = hybrid
    prompts = np.random.default_rng(9).integers(0, ct.vocab_size, (2, 6)).astype(np.int32)
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    eng = Engine(ct, pt, ServeConfig(max_len=16, use_sketch=True, ckpt_every=2))
    clean, cache = eng.generate(prompts, 6)
    assert eng._cache_bad(cache, True) == ""
    pos0 = cache.blocks["pos0"]
    pos0[0] = ST.SSMState(pos0[0].conv, pos0[0].ssm.clone().fill_(float("nan")))
    assert "non-finite" in eng._cache_bad(cache, True)
    monkeypatch.setenv(faults.ENV_PLAN, '{"decode.step": {"action": "nan", "at": 2}}')
    faults.reset()
    eng = Engine(ct, pt, ServeConfig(max_len=16, use_sketch=True, ckpt_every=2))
    toks, _ = eng.generate(prompts, 6)
    faults.reset()
    np.testing.assert_array_equal(toks, clean)
    assert eng.stats()["health"] == {"decode.cache: sketched->exact-rebuild": 1}


# --------------------------------------------------------------------------- #
# the hybrid model: reduced zamba2-7b (mamba2, mamba2, attn_shared) × 2
# --------------------------------------------------------------------------- #

def test_hybrid_forward_and_prefill_match_reference():
    from torch_family_parity import check_forward_and_prefill

    check_forward_and_prefill(ARCH)


@pytest.mark.parametrize("use_sketch", [False, True])
def test_hybrid_prefill_with_cache_and_decode_match_reference(use_sketch):
    """The token-scan prefill of the Mamba-2 layers and the exact or
    sketched cache of the shared attention, then the decode loop."""
    from torch_family_parity import check_cache_and_decode

    check_cache_and_decode(ARCH, use_sketch)


def test_hybrid_loss_and_gradients_match_reference():
    from torch_family_parity import check_loss_and_gradients

    check_loss_and_gradients(ARCH)


def test_hybrid_decode_matches_forward_at_the_recurrent_tolerance():
    from torch_family_parity import check_decode_matches_forward

    check_decode_matches_forward(ARCH)


def test_hybrid_sketched_decode_stays_finite_and_matches_reference():
    """The reference's test_sketched_decode_runs on zamba2 (slots [0, 1],
    four steps of token 0), held against the reference's logits."""
    from torch_family_parity import TOL as PTOL
    from torch_family_parity import build, close

    cj, ct, pj, pt = build(ARCH)
    cache_j = MJ.init_cache(cj, 2, 64, jnp.float32, use_sketch=True)
    cache_t = MT.init_cache(ct, 2, 64, torch.float32, use_sketch=True, device="cpu")
    slots = np.asarray([0, 1], np.int32)
    for t in range(4):
        lj, cache_j = MJ.decode_step(pj, cache_j, jnp.zeros((2,), jnp.int32), jnp.int32(t), cj,
                                     slots=jnp.asarray(slots), use_sketch=True)
        lt, cache_t = MT.decode_step(pt, cache_t, torch.zeros((2,), dtype=torch.long), t, ct,
                                     slots=slots, use_sketch=True)
        assert lt.isfinite().all()
        close(lt.numpy(), lj, PTOL)
