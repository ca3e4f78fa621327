"""Port parity for ``core/sketched_attention.py``: landmark pooling and
Newton–Schulz, the streaming cache's update and prefill folds with the
reference's slot table fed across, the prefill and decode attends, and the
port's own slot draws.  Inputs are made with numpy and given to both.

Tolerances: the caches are held bitwise against the reference where both
fold the same float32 (or bfloat16) values in the same (token, pick) order;
pooling, Newton–Schulz and the attends at the reference's own 1e-5
(tests/test_serve.py:87, tests/test_amm_and_attention.py), float32 sum order
only."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import sketched_attention as SJ  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import sketched_attention as ST  # noqa: E402

KEY = jax.random.PRNGKey(0)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _randn(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _cache_pair(B, Hkv, d_slots, Dh, dtype):
    jd, td = DTYPES[dtype]
    return (SJ.init_sketch_cache(B, Hkv, d_slots, Dh, jd),
            ST.init_sketch_cache(B, Hkv, d_slots, Dh, td, device="cpu"))


def _assert_caches_equal(cj, ct):
    for a, b in zip(cj, ct):
        np.testing.assert_array_equal(_np(b), _np(a))


@pytest.mark.parametrize("normalize", [False, True])
def test_landmark_pool_and_newton_schulz_match(normalize):
    x, = _randn(1, (2, 3, 64, 8))
    skj = SJ.make_seq_sketch(KEY, 64, 16, 4)
    sk = interop.sketch_from_numpy(np.asarray(skj.indices), np.asarray(skj.signs),
                                   np.asarray(skj.probs), 64, device="cpu")
    want = SJ.landmark_pool(jnp.asarray(x), skj, normalize=normalize)
    got = ST.landmark_pool(torch.from_numpy(x), sk, normalize=normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    W = jax.nn.softmax(jnp.asarray(_randn(2, (3, 16, 16))[0]), axis=-1)
    Zj = SJ._newton_schulz_pinv(W, 6)
    Zt = ST._newton_schulz_pinv(torch.from_numpy(np.array(W)), 6)
    np.testing.assert_allclose(Zt.numpy(), np.asarray(Zj), rtol=1e-4, atol=1e-4)


def test_make_seq_sketch_with_the_reference_centers():
    """Fed the reference's centers (its explicit draw), make_seq_sketch
    builds the reference's aligned windows and coefficients."""
    S, d, m = 100, 12, 4
    skj = SJ.make_seq_sketch(KEY, S, d, m)
    centers = np.array(jax.random.randint(KEY, (d,), 0, S))
    sk = ST.make_seq_sketch(None, S, d, m, centers=torch.from_numpy(centers), device="cpu")
    np.testing.assert_array_equal(sk.indices.numpy(), np.asarray(skj.indices))
    np.testing.assert_allclose(sk.coef.numpy(), np.asarray(skj.coef), rtol=1e-6)


@pytest.mark.parametrize("scheme", ["uniform", "poisson"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_and_prefill_caches_match_reference(scheme, dtype):
    """The reference's slot table fed to both folds: the sequential updates
    and the one-call prefill equal the reference's caches bitwise."""
    B, Hkv, d_slots, m_r, Dh, L = 2, 2, 16, 2, 8, 40
    table = np.asarray(SJ.decode_slot_table(KEY, L, d_slots, m_r, scheme=scheme,
                                            max_len=999))
    jd, td = DTYPES[dtype]
    k, v = _randn(3, (B, Hkv, L, Dh), (B, Hkv, L, Dh))
    kj, vj = jnp.asarray(k, jd), jnp.asarray(v, jd)
    kt, vt = torch.from_numpy(k).to(td), torch.from_numpy(v).to(td)
    cj, ct = _cache_pair(B, Hkv, d_slots, Dh, dtype)
    _assert_caches_equal(SJ.prefill_sketch_cache(cj, kj, vj, jnp.asarray(table)),
                         ST.prefill_sketch_cache(ct, kt, vt, table))
    for t in range(L):
        cj = SJ.update_sketch_cache(cj, kj[:, :, t], vj[:, :, t], jnp.asarray(table[t]))
        ct = ST.update_sketch_cache(ct, kt[:, :, t], vt[:, :, t], table[t])
    _assert_caches_equal(cj, ct)


@pytest.mark.parametrize("scheme", ["uniform", "poisson"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_prefill_bitwise_equals_sequential_fold(scheme, dtype):
    """The port's own draws: the prefill cache is bitwise the token-by-token
    fold (the reference's pinned guarantee, tests/test_serve.py:59)."""
    B, Hkv, d_slots, m_r, Dh, L = 2, 2, 16, 3, 8, 50
    table = ST.decode_slot_table(5, L, d_slots, m_r, scheme=scheme)
    td = DTYPES[dtype][1]
    k, v = (torch.from_numpy(x).to(td) for x in _randn(4, (B, Hkv, L, Dh), (B, Hkv, L, Dh)))
    seq = ST.init_sketch_cache(B, Hkv, d_slots, Dh, td, device="cpu")
    bat = ST.prefill_sketch_cache(seq, k, v, table)
    for t in range(L):
        seq = ST.update_sketch_cache(seq, k[:, :, t], v[:, :, t], table[t])
    for a, b in zip(bat, seq):
        assert torch.equal(a, b)
    assert bat.mass.dtype == torch.float32


def test_prefill_attend_matches_reference():
    """Chunked evolving-cache attention (with a ragged last chunk) and its
    returned cache against the reference on its slot table, GQA G = 2."""
    B, H, Hkv, d_slots, m_r, Dh, L = 2, 4, 2, 16, 2, 8, 45
    table = np.asarray(SJ.decode_slot_table(KEY, L, d_slots, m_r, max_len=999))
    q, k, v = _randn(6, (B, H, L, Dh), (B, Hkv, L, Dh), (B, Hkv, L, Dh))
    cj, ct = _cache_pair(B, Hkv, d_slots, Dh, "float32")
    oj, cj = SJ.sketch_prefill_attend(*map(jnp.asarray, (q, k, v)), cj, jnp.asarray(table),
                                      chunk=16)
    ot, ct = ST.sketch_prefill_attend(*map(torch.from_numpy, (q, k, v)), ct, table,
                                      chunk=16)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5, atol=1e-5)
    _assert_caches_equal(cj, ct)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_attend_matches_reference(use_kernel):
    """One-token attention over a cache with empty slots (mass 0 → −1e30
    bias), through the einsum route and the kernel entry point's plain
    version."""
    B, H, Hkv, d_slots, Dh = 2, 4, 2, 12, 8
    q, ks, vs = _randn(7, (B, H, Dh), (B, Hkv, d_slots, Dh), (B, Hkv, d_slots, Dh))
    mass = np.abs(_randn(8, (B, Hkv, d_slots))[0]) + 0.5
    mass[:, :, 3] = 0.0
    cache_j = SJ.SketchCache(*map(jnp.asarray, (ks, vs, mass)))
    want = SJ.sketch_decode_attend(jnp.asarray(q), cache_j, use_kernel=False)
    cache = ST.SketchCache(*map(torch.from_numpy, (ks, vs, mass)))
    got = ST.sketch_decode_attend(torch.from_numpy(q), cache, use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_slot_draws_identity_padding_and_bad_scheme():
    """max_len ≤ d_slots gives the identity draw for every scheme; Poisson
    rows hold at most m_r distinct real slots and pad with d_slots; draws
    are a pure function of (seed, position); a bad scheme raises."""
    for scheme in ("uniform", "poisson"):
        s = ST.decode_slots(0, 5, 16, 3, scheme=scheme, max_len=16)
        assert s.tolist() == [5, 5, 5] and s.dtype == torch.int32
    d_slots, m_r = 16, 4
    saw_pad = saw_real = False
    for step in range(64):
        s = ST.decode_slots(3, step, d_slots, m_r, scheme="poisson").numpy()
        assert s.shape == (m_r,) and ((s >= 0) & (s <= d_slots)).all()
        real = s[s < d_slots]
        assert len(np.unique(real)) == len(real)
        saw_pad |= bool((s == d_slots).any())
        saw_real |= len(real) > 0
        assert torch.equal(ST.decode_slots(3, step, d_slots, m_r, scheme="poisson"),
                           torch.from_numpy(s))
    assert saw_pad and saw_real
    table = ST.decode_slot_table(3, 10, d_slots, m_r, scheme="poisson", offset=20)
    assert torch.equal(table[4], ST.decode_slots(3, 24, d_slots, m_r, scheme="poisson"))
    assert not torch.equal(ST.decode_slot_table(3, 10, 64, 2), ST.decode_slot_table(4, 10, 64, 2))
    with pytest.raises(ValueError, match="unknown decode slot scheme"):
        ST.decode_slots(0, 0, 16, 3, scheme="bogus")


def test_poisson_slots_from_the_reference_uniforms():
    """Fed the reference's inclusion uniforms (its explicit draw), the
    Poisson selection gives the reference's slots, padding included."""
    d_slots, m_r = 16, 4
    for step in range(32):
        u = np.array(jax.random.uniform(jax.random.fold_in(KEY, step), (d_slots,)))
        want = np.asarray(SJ.decode_slots(KEY, step, d_slots, m_r, scheme="poisson"))
        got = ST.decode_slots(0, step, d_slots, m_r, scheme="poisson",
                              draw=torch.from_numpy(u))
        np.testing.assert_array_equal(got.numpy(), want)


def test_softmax_scale_is_the_float32_tensor_scale_at_every_configured_head_dim():
    """The host float32 1/√Dh scales float32 logits to the same bits as the
    float32 tensor the attention code used before, for every config."""
    from repro_torch.configs import ARCHS, reduced

    dims = {c.head_dim for cfg in ARCHS.values() for c in (cfg, reduced(cfg))}
    x = torch.randn(257, generator=torch.Generator().manual_seed(0))
    for Dh in sorted(dims):
        t = 1.0 / torch.sqrt(torch.tensor(Dh, dtype=torch.float32))
        assert ST.softmax_scale(Dh) == t.item(), Dh
        assert torch.equal(x * ST.softmax_scale(Dh), x * t), Dh
