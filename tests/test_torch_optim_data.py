"""Port parity for the optimizer, the gradient compression, the data stream
and the asynchronous checkpoint writer (``repro_torch.optim``, ``.data``,
``.checkpoint``), and the reference's substrate tests
(tests/test_substrate.py) mirrored in torch.

Tolerances: AdamW and the schedule against the reference at 1e-6 (the same
float32 arithmetic, sums in another order); the compression of one block on
the reference's draw at 1e-5 (the reference's sketch tests' tolerance); the
error-feedback invariant at 1e-3, as the reference holds it.  The token
stream is not threefry, so its statistics are held instead of its bits."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.sketch import make_accum_sketch as make_sketch_j  # noqa: E402
from repro.data import pipeline as PJ  # noqa: E402
from repro.optim import adamw as OJ  # noqa: E402
from repro.optim import compress as CJ  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch._util import DATA_STREAM, position_generator, tree_leaves, tree_map  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.data import pipeline as PT  # noqa: E402
from repro_torch.optim import adamw as OT  # noqa: E402
from repro_torch.optim import compress as CT  # noqa: E402

KEY = jax.random.PRNGKey(0)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


# --------------------------------------------------------------------------- #
# AdamW: the reference's substrate tests in torch, and parity
# --------------------------------------------------------------------------- #

def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    state = OT.init_adamw(params)
    cfg = OT.AdamWConfig(lr_peak=0.1, warmup_steps=0, total_steps=200, weight_decay=0.0)
    p = params
    for _ in range(150):
        p, state, _ = OT.adamw_update({"w": 2 * p["w"]}, state, cfg,
                                      param_dtype=torch.float32)
    assert p["w"].abs().max().item() < 0.15


def test_schedule_warmup_and_decay():
    cfg = OT.AdamWConfig(lr_peak=1e-3, lr_min=1e-5, warmup_steps=10, total_steps=100)
    assert float(OT.schedule(cfg, 5)) == pytest.approx(5e-4)
    assert float(OT.schedule(cfg, 10)) == pytest.approx(1e-3, rel=0.1)
    assert float(OT.schedule(cfg, 100)) == pytest.approx(1e-5, rel=0.1)
    cj = OJ.AdamWConfig(lr_peak=1e-3, lr_min=1e-5, warmup_steps=10, total_steps=100)
    for s in (0, 1, 5, 10, 11, 40, 99, 100, 150):
        assert float(OT.schedule(cfg, s)) == pytest.approx(
            float(OJ.schedule(cj, jnp.int32(s))), rel=1e-6), s


def test_grad_clip_bounds_update_norm():
    state = OT.init_adamw({"w": torch.zeros(4)})
    cfg = OT.AdamWConfig(lr_peak=1.0, warmup_steps=0, clip_norm=1.0, weight_decay=0.0)
    _, state2, mets = OT.adamw_update({"w": torch.full((4,), 100.0)}, state, cfg,
                                      param_dtype=torch.float32)
    assert mets["grad_norm"].item() == pytest.approx(200.0)
    assert OT.global_norm(state2.m).item() < 0.2


def test_adamw_matches_reference_over_three_steps():
    """Decay on 2-D weights only (not on norms, biases or 1-D leaves, by the
    same path names), clipping active, master weights and the bfloat16 cast
    of every leaf: three steps against the reference at 1e-6."""
    rng = np.random.default_rng(0)
    shapes = {"blocks": {"pos0": {"attn": {"norm": (2, 8), "wq": (2, 8, 8), "bq": (2, 8)}}},
              "embed": (16, 8), "final_norm": (8,), "head_bias": (3, 8)}

    def draw(tree, scale):
        return {k: draw(v, scale) if isinstance(v, dict) else
                (scale * rng.standard_normal(v)).astype(np.float32) for k, v in tree.items()}
    w0 = draw(shapes, 1.0)
    cfg_t = OT.AdamWConfig(lr_peak=1e-2, warmup_steps=1, total_steps=10, clip_norm=1.0)
    cfg_j = OJ.AdamWConfig(lr_peak=1e-2, warmup_steps=1, total_steps=10, clip_norm=1.0)
    st_t = OT.init_adamw(tree_map(torch.from_numpy, w0))
    st_j = OJ.init_adamw(jax.tree_util.tree_map(jnp.asarray, w0))
    for _ in range(3):
        g = draw(shapes, 0.5)
        pt, st_t, mt = OT.adamw_update(tree_map(torch.from_numpy, g), st_t, cfg_t)
        pj, st_j, mj = OJ.adamw_update(jax.tree_util.tree_map(jnp.asarray, g), st_j, cfg_j)
        _close(mt["grad_norm"], mj["grad_norm"], 1e-6)
        _close(mt["lr"], mj["lr"], 1e-6)
    assert int(st_t.step) == int(st_j.step) == 3
    for name in ("m", "v", "master"):
        for a, b in zip(tree_leaves(getattr(st_t, name)),
                        jax.tree_util.tree_leaves(getattr(st_j, name))):
            _close(a, b, 1e-6)
    for a, b, w in zip(tree_leaves(pt), jax.tree_util.tree_leaves(pj),
                       tree_leaves(st_t.master)):
        assert a.dtype == torch.bfloat16 and str(b.dtype) == "bfloat16"
        assert torch.equal(a, w.to(torch.bfloat16))
        _close(a.float(), np.asarray(b, np.float32), 2.0 ** -8)


def test_adamw_decay_mask_follows_path_names():
    x2, x1 = torch.zeros(2, 2), torch.zeros(2)
    assert OT._decay_mask("blocks/pos0/attn/wq", x2)
    assert OT._decay_mask("blocks/pos0/attn/bq", x2)          # a stacked bias named bq
    assert not OT._decay_mask("blocks/pos0/attn/norm", x2)
    assert not OT._decay_mask("head/Bias", x2)
    assert not OT._decay_mask("embed", x1)
    names = [n for n, _ in OT._named_leaves({"b": {"y": x1, "x": x1}, "a": x1})]
    assert names == ["a", "b/x", "b/y"]


# --------------------------------------------------------------------------- #
# gradient compression
# --------------------------------------------------------------------------- #

def test_compression_error_feedback_preserves_signal():
    """The sum of the applied (compressed) gradients plus the residual is the
    sum of the true gradients: nothing is lost, only delayed."""
    cfg = CT.CompressConfig(ratio=0.25, m=4, min_rows=8)
    gen = torch.Generator().manual_seed(0)
    ef = CT.init_error_feedback({"w": torch.zeros(64, 16)}, cfg)
    applied = torch.zeros(64, 16)
    true = torch.zeros(64, 16)
    for step in range(5):
        gs = {"w": torch.randn((64, 16), generator=gen)}
        out, ef, mets = CT.compress_grads(gs, ef, step, 0, cfg)
        applied += out["w"]
        true += gs["w"]
        assert mets["compress_ratio"] < 1.0
    torch.testing.assert_close(applied + ef["w"], true, rtol=1e-3, atol=1e-3)


def test_compression_skips_small_blocks():
    cfg = CT.CompressConfig(ratio=0.25, m=2, min_rows=1000)
    g = {"small": torch.ones(4, 4)}
    ef = CT.init_error_feedback(g, cfg)
    assert ef == {"small": None}
    out, ef2, mets = CT.compress_grads(g, ef, 0, 0, cfg)
    assert torch.equal(out["small"], g["small"]) and ef2 == {"small": None}
    assert mets["compress_ratio"] == 1.0


def test_compress_leaf_matches_reference_on_its_draw():
    """Two steps of compress_grads in the reference against compress_leaf on
    the reference's draw (fold_in(fold_in(key, step), leaf)), carried across
    with interop.sketch_from_numpy: the projected block, the error feedback
    and compress_ratio at 1e-5."""
    cfg_j = CJ.CompressConfig(ratio=0.25, m=4, min_rows=32)
    cfg_t = CT.CompressConfig(ratio=0.25, m=4, min_rows=32)
    rng = np.random.default_rng(1)
    shapes = {"a": (48, 6), "b": (8, 3), "c": (40, 2, 3)}
    zeros = {k: jnp.zeros(v) for k, v in shapes.items()}
    ef_j = CJ.init_error_feedback(zeros, cfg_j)
    ef_t = CT.init_error_feedback({k: torch.zeros(v) for k, v in shapes.items()}, cfg_t)
    for step in range(2):
        g = {k: rng.standard_normal(v).astype(np.float32) for k, v in shapes.items()}
        out_j, ef_j, mj = CJ.compress_grads({k: jnp.asarray(v) for k, v in g.items()}, ef_j,
                                            jnp.int32(step), KEY, cfg_j)
        for i, k in enumerate(sorted(shapes)):
            if ef_t[k] is None:
                continue
            p = shapes[k][0]
            sk = make_sketch_j(jax.random.fold_in(jax.random.fold_in(KEY, step), i), p,
                               int(p * 0.25), 4)
            skt = interop.sketch_from_numpy(sk.indices, sk.signs, sk.probs, p, device="cpu")
            o, ef_t[k] = CT.compress_leaf(skt, torch.from_numpy(g[k]), ef_t[k])
            _close(o, out_j[k], 1e-5)
            _close(ef_t[k], ef_j[k], 1e-5)
        _, _, mt = CT.compress_grads({k: torch.from_numpy(v) for k, v in g.items()},
                                     CT.init_error_feedback(
                                         {k: torch.zeros(v) for k, v in shapes.items()},
                                         cfg_t), step, 0, cfg_t)
        assert mt["compress_ratio"] == pytest.approx(float(mj["compress_ratio"]), rel=1e-6)
    assert ef_t["b"] is None and ef_j["b"] is None


def test_compression_draw_is_a_pure_function_of_seed_step_leaf():
    cfg = CT.CompressConfig(ratio=0.25, m=2, min_rows=8)
    a = CT.leaf_sketch(3, 7, 1, 64, cfg, "cpu")
    b = CT.leaf_sketch(3, 7, 1, 64, cfg, "cpu")
    assert torch.equal(a.indices, b.indices) and torch.equal(a.signs, b.signs)
    for other in (CT.leaf_sketch(3, 8, 1, 64, cfg, "cpu"),
                  CT.leaf_sketch(3, 7, 2, 64, cfg, "cpu"),
                  CT.leaf_sketch(4, 7, 1, 64, cfg, "cpu")):
        assert not torch.equal(a.indices, other.indices)
    assert (a.m, a.d, a.n) == (2, 16, 64)


# --------------------------------------------------------------------------- #
# data stream
# --------------------------------------------------------------------------- #

def test_data_deterministic_and_restart_safe():
    dc = PT.DataConfig(vocab_size=100, seq_len=16, global_batch=8)
    a1, b1 = PT.global_batch(dc, 7, device="cpu")
    a2, b2 = PT.global_batch(dc, 7, device="cpu")
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    a3, _ = PT.global_batch(dc, 8, device="cpu")
    assert not torch.equal(a1, a3)
    full = torch.cat([a1[:, :1], b1], dim=1)
    assert torch.equal(full[:, 1:], b1) and torch.equal(full[:, 1:-1], a1[:, 1:])
    assert a1.dtype == torch.int64 and tuple(a1.shape) == (8, 16)
    assert 0 <= int(a1.min()) and int(a1.max()) < 100


def test_data_host_sharding_partitions():
    parts = [PT.host_batch(PT.DataConfig(100, 8, 8, 0, 4, h), 3, device="cpu")[0]
             for h in range(4)]
    assert all(tuple(p.shape) == (2, 8) for p in parts)
    assert not torch.equal(parts[0], parts[1])
    whole, _ = PT.global_batch(PT.DataConfig(100, 8, 8, 0, 4), 3, device="cpu")
    assert torch.equal(whole, torch.cat(parts))
    with pytest.raises(ValueError, match="does not split"):
        PT.host_batch(PT.DataConfig(100, 8, 6, 0, 4), 0, device="cpu")


def _successor_share(block: np.ndarray, prev: np.ndarray, V: int) -> float:
    return float(np.mean(block[:, 1:] == (prev[:, :-1] * 31 + 7) % V))


def test_stream_statistics_match_reference():
    """64 × 1025 tokens at V = 512 from each package: the Markov successor
    (31·base[t−1] + 7) mod V is taken at half the positions; the share of
    positions whose token is the successor of the previous token (about a
    quarter: half of those follow a position that kept its base token)
    and the share of the 10 most frequent tokens agree within 0.02."""
    V, shape = 512, (64, 1025)
    dc_t = PT.DataConfig(vocab_size=V, seq_len=shape[1] - 1, global_batch=shape[0])
    dc_j = PJ.DataConfig(vocab_size=V, seq_len=shape[1] - 1, global_batch=shape[0])
    g = position_generator(0, DATA_STREAM, 0, 0)
    base_t, mix_t = (x.numpy() for x in PT._token_parts(g, dc_t, shape))
    tok_t = PT._token_block(position_generator(0, DATA_STREAM, 0, 0), dc_t,
                            shape).numpy()
    # the reference's own draw, split as _token_block splits its key
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 0), 0)
    tok_j = np.asarray(PJ._token_block(key, dc_j, shape))
    k1, _ = jax.random.split(key)
    u = jax.random.uniform(k1, shape, minval=1e-6, maxval=1.0)
    base_j = np.asarray((V * (u ** 2.5)).astype(jnp.int32) % V)
    for tok, base in ((tok_t, base_t), (tok_j, base_j)):
        assert _successor_share(tok, base, V) == pytest.approx(0.5, abs=0.02)
    assert mix_t.mean() == pytest.approx(0.5, abs=0.02)
    s_t, s_j = _successor_share(tok_t, tok_t, V), _successor_share(tok_j, tok_j, V)
    assert s_t == pytest.approx(s_j, abs=0.02) and 0.2 < s_t < 0.35

    def top10(tok):
        return np.sort(np.bincount(tok.ravel(), minlength=V))[-10:].sum() / tok.size
    assert top10(tok_t) == pytest.approx(top10(tok_j), abs=0.02)
    # the labels are the tokens shifted by one in both packages
    t, lab = PT.host_batch(dc_t, 0, device="cpu")
    tj, lj = PJ.host_batch(dc_j, 0)
    assert torch.equal(t[:, 1:], lab[:, :-1]) and np.array_equal(tj[:, 1:], lj[:, :-1])


# --------------------------------------------------------------------------- #
# the asynchronous checkpoint writer
# --------------------------------------------------------------------------- #

def _tree(v):
    return {"w": torch.full((3,), float(v)), "ef": None,
            "s": torch.tensor(v, dtype=torch.int32)}


def test_async_checkpointer_roundtrip_snapshots_and_none_leaves(tmp_path):
    tree = _tree(1)
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    ac.save(tree, step=1)
    tree["w"].add_(5.0)                     # an in-place update after save()
    ac.close()
    out, step = ckpt.restore(str(tmp_path), tree)
    assert step == 1 and out["ef"] is None
    assert torch.equal(out["w"], torch.full((3,), 1.0))
    assert out["s"].dtype == torch.int32 and int(out["s"]) == 1


def test_async_writer_failure_reraised(tmp_path):
    """A writer-thread death surfaces on the next close() or save()."""
    parent = tmp_path / "plainfile"
    parent.write_text("not a directory")
    ac = ckpt.AsyncCheckpointer(str(parent / "sub"), keep=2)
    ac.save(_tree(1), step=1)
    with pytest.raises(OSError):
        ac.close()
    ac.save(_tree(2), step=2)
    with pytest.raises(OSError):
        ac.save(_tree(3), step=3)


def test_async_writer_clean_path_still_works(tmp_path):
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    ac.save(_tree(1), step=1)
    ac.save(_tree(2), step=2)
    ac.close()
    assert ckpt.committed_steps(str(tmp_path)) == [2, 1]
    assert sorted(os.listdir(tmp_path)) == ["step_00000001", "step_00000002"]
