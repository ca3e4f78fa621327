"""Port parity for the dense-attention LM substrate (models/common, ffn,
attention, model) on ``reduced(minitron-8b)`` with two KV heads, so that GQA
with G = 2 survives the reduction.  The reference's bfloat16 ``init_params``
draw is widened to float32 in both packages and carried across with
``interop.params_from_numpy``; the reference's slot draws are fed across.

Tolerances: rmsnorm/rope/ffn at 1e-5 (float32, sum order only); hidden
states and logits through the whole model at 2e-4 relative to the largest
logit — the float32 sums of two packages drift through four projections and
two attentions per layer, and logits are of order 0.1."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.core.sketched_attention import decode_slot_table  # noqa: E402
from repro.models import attention as AJ  # noqa: E402
from repro.models import common as CJ  # noqa: E402
from repro.models import ffn as FJ  # noqa: E402
from repro.models import model as MJ  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import ARCHS as ARCHS_T  # noqa: E402
from repro_torch.configs import reduced as reduced_t  # noqa: E402
from repro_torch.models import common as CT  # noqa: E402
from repro_torch.models import ffn as FT  # noqa: E402
from repro_torch.models import model as MT  # noqa: E402

KEY = jax.random.PRNGKey(0)


def _cfgs(**kw):
    cj = dataclasses.replace(reduced(ARCHS["minitron-8b"]), n_kv_heads=2, **kw)
    ct = dataclasses.replace(reduced_t(ARCHS_T["minitron-8b"]), n_kv_heads=2, **kw)
    return cj, ct


@pytest.fixture(scope="module")
def built():
    cj, ct = _cfgs(n_layers=2, n_superblocks=2)
    pj = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), MJ.init_params(KEY, cj))
    pt = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct, device="cpu")
    return cj, ct, pj, pt


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def test_configs_are_the_reference_values():
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(ARCHS_T[name]) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(reduced_t(ARCHS_T["minitron-8b"])) == dataclasses.asdict(
        reduced(ARCHS["minitron-8b"]))


def test_init_params_layout_matches_reference(built):
    """The port's own draw has the reference's names, shapes, stacking and
    dtypes (bfloat16 weights, float32 norms)."""
    cj, ct, _, _ = built
    pj = MJ.init_params(KEY, cj)
    pt = MT.init_params(0, ct, device="cpu")
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(pj)[0]}

    def walk(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}['{k}']")
            else:
                yield f"{prefix}['{k}']", v
    flat_t = dict(walk(pt))
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_t.items():
        assert tuple(v.shape) == flat_j[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(flat_j[k].dtype), k
    assert MT.param_count(pt) == MJ.param_count(pj)
    # the same distribution (N(0, 1) cut at ±3, over √fan_in), not the same bits
    for name in ("wq", "wo"):
        sd_t = pt["blocks"]["pos0"]["attn"][name].float().std().item()
        sd_j = float(jnp.std(pj["blocks"]["pos0"]["attn"][name].astype(jnp.float32)))
        assert abs(sd_t / sd_j - 1) < 0.05, name


def test_rmsnorm_rope_ffn_match(built):
    _, _, pj, pt = built
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    _close(CT.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
           CJ.rmsnorm(jnp.asarray(x), jnp.asarray(w)), 1e-5)
    pos = np.arange(7, 12)
    sj, cj_ = CJ.rope_table(jnp.asarray(pos), 16, 10000.0)
    st, ct_ = CT.rope_table(torch.from_numpy(pos), 16, 10000.0)
    _close(st.numpy(), sj, 1e-5)
    _close(ct_.numpy(), cj_, 1e-5)
    xr = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    _close(CT.apply_rope(torch.from_numpy(xr), st, ct_).numpy(),
           CJ.apply_rope(jnp.asarray(xr), sj, cj_), 1e-5)
    fj = jax.tree_util.tree_map(lambda a: a[0], pj["blocks"]["pos0"]["ffn"])
    ft = {k: v[0] for k, v in pt["blocks"]["pos0"]["ffn"].items()}
    _close(FT.ffn_forward(ft, torch.from_numpy(x)).numpy(), FJ.ffn_forward(fj, jnp.asarray(x)),
           1e-5)


def test_forward_and_prefill_logits_match(built):
    cj, ct, pj, pt = built
    tokens = np.random.default_rng(1).integers(0, cj.vocab_size, (2, 32))
    hj, _ = MJ.forward(pj, jnp.asarray(tokens), cj, q_chunk=16, remat="none")
    ht, aux = MT.forward(pt, torch.from_numpy(tokens), ct, q_chunk=16)
    _close(ht.numpy(), hj, 2e-4)
    assert aux.item() == 0.0
    _close(MT.prefill(pt, torch.from_numpy(tokens), ct).numpy(),
           MJ.prefill(pj, jnp.asarray(tokens), cj), 2e-4)


def test_forward_on_a_ragged_length_matches_one_chunk(built):
    """S = 37 with q_chunk = 16: the reference cannot reshape 37 positions
    into equal chunks (ROADMAP queue 3); the port's ragged last chunk gives
    the reference's one-chunk result."""
    cj, ct, pj, pt = built
    tokens = np.random.default_rng(3).integers(0, cj.vocab_size, (2, 37))
    hj, _ = MJ.forward(pj, jnp.asarray(tokens), cj, q_chunk=512, remat="none")
    ht, _ = MT.forward(pt, torch.from_numpy(tokens), ct, q_chunk=16)
    _close(ht.numpy(), hj, 2e-4)


@pytest.mark.parametrize("use_sketch", [False, True])
def test_prefill_with_cache_and_decode_loop_match(built, use_sketch):
    """Prefill 20 tokens into an exact or sketched (d_slots 16 < 28
    positions: slots really are shared) cache, then 8 teacher-forced decode
    steps, with the reference's slot draws fed across."""
    cj, ct, pj, pt = built
    B, L, n = 2, 20, 8
    tokens = np.random.default_rng(2).integers(0, cj.vocab_size, (B, L + n))
    d_slots, m_r = cj.sketch_attn.d_slots, cj.sketch_attn.m_r
    table = np.asarray(decode_slot_table(KEY, L + n, d_slots, m_r, max_len=999))
    cache_j = MJ.init_cache(cj, B, L + n, jnp.float32, use_sketch=use_sketch)
    cache_t = MT.init_cache(ct, B, L + n, torch.float32, use_sketch=use_sketch, device="cpu")
    lj, cache_j = MJ.prefill_with_cache(pj, jnp.asarray(tokens[:, :L]), cj, cache_j,
                                        slot_table=jnp.asarray(table[:L]))
    lt, cache_t = MT.prefill_with_cache(pt, torch.from_numpy(tokens[:, :L]), ct, cache_t,
                                        slot_table=table[:L])
    _close(lt.numpy(), lj, 2e-4)
    for pos in range(L, L + n):
        lj, cache_j = MJ.decode_step(pj, cache_j, jnp.asarray(tokens[:, pos]), jnp.int32(pos),
                                     cj, slots=jnp.asarray(table[pos]), use_sketch=use_sketch)
        lt, cache_t = MT.decode_step(pt, cache_t, torch.from_numpy(tokens[:, pos]), pos, ct,
                                     slots=table[pos], use_sketch=use_sketch)
        _close(lt.numpy(), lj, 2e-4)
    # the caches too: layer i of the port is slice i of the reference's stack
    for fj, ft in zip(jax.tree_util.tree_leaves(cache_j.blocks["pos0"]),
                      zip(*[tuple(st) for st in cache_t.blocks["pos0"]])):
        _close(torch.stack(ft).numpy(), fj, 2e-4)


def test_cache_from_numpy_round_trip(built):
    cj, _, _, _ = built
    skc = AJ.init_attn_sketch_cache(cj, 2, jnp.bfloat16)
    got = interop.cache_from_numpy(jax.tree_util.tree_map(np.asarray, skc), device="cpu")
    assert got.k_sum.dtype == torch.bfloat16 and got.mass.dtype == torch.float32
    assert tuple(got.k_sum.shape) == skc.k_sum.shape
    kv = interop.cache_from_numpy(AJ.init_kv_cache(cj, 2, 8, jnp.float32), device="cpu")
    assert tuple(kv.k.shape) == (2, 8, 2, 16)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "zamba2-7b", "xlstm-125m",
                                  "qwen2-vl-2b"])
def test_unported_blocks_raise_naming_the_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="item 13"):
        MT.init_params(0, reduced_t(ARCHS_T[arch]), device="cpu")
