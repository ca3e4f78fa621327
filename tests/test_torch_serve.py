"""Port parity and guarantees of the serving engine and its checkpoints, on
``reduced(minitron-8b)`` with two KV heads (GQA, G = 2).  The reference's
weights are widened to float32 and carried across; caches are float32.

Greedy tokens are held equal to the reference engine's in exact mode and in
identity-slot sketched mode (max_len ≤ d_slots, where sketched decode is
exact attention).  The port's own guarantees are held bitwise: the batched
prefill against the sequential one's cache, and a generate() killed by the
fault plan and resumed from its checkpoint against the uninterrupted one."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.models.model import init_params as init_params_j  # noqa: E402
from repro.serve.engine import Engine as EngineJ  # noqa: E402
from repro.serve.engine import ServeConfig as ServeConfigJ  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch._util import tree_leaves  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import ARCHS as ARCHS_T  # noqa: E402
from repro_torch.configs import reduced as reduced_t  # noqa: E402
from repro_torch.models.model import init_cache  # noqa: E402
from repro_torch.resilience import faults  # noqa: E402
from repro_torch.resilience.degrade import global_health  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

KEY = jax.random.PRNGKey(0)
B, L, N_NEW = 2, 8, 6


@pytest.fixture(scope="module")
def built():
    cj = dataclasses.replace(reduced(ARCHS["minitron-8b"]), n_kv_heads=2)
    ct = dataclasses.replace(reduced_t(ARCHS_T["minitron-8b"]), n_kv_heads=2)
    pj = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), init_params_j(KEY, cj))
    pt = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct, device="cpu")
    return cj, ct, pj, pt


def _prompts(vocab, seed=1, b=B, n=L):
    return np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(np.int32)


def _engine(built, **kw):
    _, ct, _, pt = built
    return Engine(ct, pt, ServeConfig(cache_dtype=torch.float32, **kw))


def _arm(monkeypatch, plan: str):
    monkeypatch.setenv(faults.ENV_PLAN, plan)
    faults.reset()


@pytest.mark.parametrize("use_sketch", [False, True])
def test_greedy_generate_matches_reference_engine(built, use_sketch):
    """max_len = d_slots = 16: the sketched engines take the identity slot
    draw in both packages, so every cache path is exact attention."""
    cj, _, pj, _ = built
    prompts = _prompts(cj.vocab_size)
    want, _ = EngineJ(cj, pj, ServeConfigJ(max_len=16, use_sketch=use_sketch,
                                           cache_dtype=jnp.float32)).generate(prompts, N_NEW)
    got, _ = _engine(built, max_len=16, use_sketch=use_sketch).generate(prompts, N_NEW)
    assert got.shape == (B, N_NEW) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_identity_slot_sketched_equals_exact_and_batched_prefill(built):
    """Sketched ≡ exact token for token at max_len ≤ d_slots, and the batched
    prefill's sketched cache is bitwise the sequential one's."""
    cfg = built[1]
    prompts = _prompts(cfg.vocab_size, seed=4)
    outs = [_engine(built, max_len=16, use_sketch=s).generate(prompts, N_NEW)[0]
            for s in (False, True)]
    np.testing.assert_array_equal(outs[0], outs[1])
    eng = _engine(built, max_len=64, use_sketch=True)       # 64 > 16: shared slots
    prompts = _prompts(cfg.vocab_size, seed=5, n=40)
    cb, lb = eng.prefill_tokens(eng.new_cache(B), prompts)
    cs, ls = eng.prefill_tokens_sequential(eng.new_cache(B), prompts)
    for a, b in zip(tree_leaves(cb), tree_leaves(cs)):
        assert torch.equal(a, b)
    torch.testing.assert_close(lb, ls, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_new,expect", [(5, 4), (1, 0)])
def test_generate_runs_exactly_n_minus_1_decode_steps(built, monkeypatch, n_new, expect):
    calls = {"n": 0}
    real = engine_mod.decode_step

    def spy(*args, **kw):
        calls["n"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(engine_mod, "decode_step", spy)
    out, _ = _engine(built, max_len=32, use_sketch=True).generate(
        _prompts(built[1].vocab_size, b=1), n_new)
    assert out.shape == (1, n_new) and calls["n"] == expect


def test_cache_bytes_flat_in_context(built):
    """Sketched cache bytes do not depend on max_len; exact ones grow with
    it; mass stays float32 in a bfloat16 sketched cache."""
    cfg = built[1]

    def nbytes(ml, sk):
        c = init_cache(cfg, 1, ml, torch.bfloat16, use_sketch=sk, device="cpu")
        return sum(x.numel() * x.element_size() for x in tree_leaves(c))

    assert nbytes(1024, True) == nbytes(256, True)
    assert nbytes(1024, False) == 4 * nbytes(256, False)
    st = init_cache(cfg, 1, 8, torch.bfloat16, use_sketch=True, device="cpu").blocks["pos0"][0]
    assert st.k_sum.dtype == torch.bfloat16 and st.mass.dtype == torch.float32


def test_kill_and_resume_bitwise(built, tmp_path, monkeypatch):
    """Kill the 2nd decode chunk, resume with a fresh engine from the
    surviving checkpoint: bitwise-identical tokens (temperature sampling and
    shared slots, so every draw matters)."""
    kw = dict(max_len=64, use_sketch=True, temperature=0.7, seed=3, ckpt_every=2)
    prompts = _prompts(built[1].vocab_size)
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    ref, _ = _engine(built, **kw).generate(prompts, N_NEW)
    chunked, _ = _engine(built, ckpt_dir=str(tmp_path / "a"), **kw).generate(
        prompts, N_NEW, request_id="r")
    np.testing.assert_array_equal(ref, chunked)
    _arm(monkeypatch, '{"decode.step": {"action": "kill", "at": 2}}')
    with pytest.raises(faults.DeviceLost):
        _engine(built, ckpt_dir=str(tmp_path), **kw).generate(prompts, N_NEW, request_id="r")
    monkeypatch.delenv(faults.ENV_PLAN)
    faults.reset()
    eng = _engine(built, ckpt_dir=str(tmp_path), **kw)
    toks, _ = eng.generate(prompts, N_NEW, request_id="r")
    np.testing.assert_array_equal(ref, toks)
    assert eng.health.count("ckpt.resume") == 1
    with pytest.raises(ValueError, match="refusing to resume"):
        eng.generate((prompts + 1) % built[1].vocab_size, N_NEW, request_id="r")


def test_nan_poison_degrades_to_exact_with_correct_tokens(built, monkeypatch):
    """decode.step nan → the health screen catches the poisoned sketched
    cache, rebuilds exact attention and records it; with identity slots the
    clean sketched run is exact attention, so the tokens must equal it."""
    prompts = _prompts(built[1].vocab_size)
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    clean, _ = _engine(built, max_len=16, use_sketch=True, ckpt_every=2).generate(
        prompts, N_NEW)
    _arm(monkeypatch, '{"decode.step": {"action": "nan", "at": 2}}')
    eng = _engine(built, max_len=16, use_sketch=True, ckpt_every=2)
    toks, _ = eng.generate(prompts, N_NEW)
    faults.reset()
    np.testing.assert_array_equal(toks, clean)
    assert eng.stats()["health"] == {"decode.cache: sketched->exact-rebuild": 1}


def test_checkpoint_round_trip_and_corrupt_latest_fallback(tmp_path, monkeypatch):
    """bfloat16 tensors, float32 tensors and numpy leaves inside NamedTuples,
    dicts and lists come back as they went; a corrupted latest step falls
    back to the prior one (recorded); a kill mid-write leaves the prior step
    loadable and a stale tmp dir that the sweep removes; retention."""
    from repro_torch.core.sketched_attention import SketchCache

    g = torch.Generator().manual_seed(0)
    tree = {"cache": [SketchCache(torch.randn(2, 3, generator=g).bfloat16(),
                                  torch.randn(2, 3, generator=g), torch.rand(2, generator=g))],
            "toks": np.arange(6, dtype=np.int32).reshape(2, 3)}
    like = {"cache": [SketchCache(torch.zeros(2, 3, dtype=torch.bfloat16), torch.zeros(2, 3),
                                  torch.zeros(2))], "toks": np.zeros((2, 3), np.int32)}
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    ckpt.save(str(tmp_path), tree, step=1, extra={"n": 1})
    back, step = ckpt.restore(str(tmp_path), like)
    assert step == 1 and isinstance(back["cache"][0], SketchCache)
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else np.array_equal(a, b) and a.dtype == b.dtype)
    _arm(monkeypatch, '{"ckpt.write": {"action": "corrupt", "at": 1}}')
    ckpt.save(str(tmp_path), tree, step=2)
    before = global_health().count("ckpt.restore")
    _, step = ckpt.restore(str(tmp_path), like)
    assert step == 1 and global_health().count("ckpt.restore") == before + 1
    _arm(monkeypatch, '{"ckpt.write": {"action": "kill", "at": 1}}')
    with pytest.raises(faults.DeviceLost):
        ckpt.save(str(tmp_path), tree, step=3)
    monkeypatch.delenv(faults.ENV_PLAN)
    faults.reset()
    assert ckpt.sweep_stale(str(tmp_path)) == ["step_00000003.tmp"]
    assert ckpt.latest_step(str(tmp_path)) == 2
    for s in (4, 5, 6):
        ckpt.save(str(tmp_path), tree, step=s, keep_last=2)
    assert ckpt.committed_steps(str(tmp_path)) == [6, 5]
    assert ckpt.read_meta(str(tmp_path), 6)["step"] == 6
