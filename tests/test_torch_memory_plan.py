"""The reference's memory plan for training, in the port: the loss chunk's
one-buffer backward (``models.common._XentChunk``) and the recomputing
attention chunk (``models.attention._CausalChunk``).

- Values and gradients against ``jax.value_and_grad`` of the reference's
  functions on the same numpy-seeded float32 inputs, at the training
  parity tests' 2e-4 of the largest entry (tests/test_torch_train.py):
  ``chunked_xent`` with a conditioning prefix masked out (labels padded
  with zeros, as ``loss_fn`` does) in one and in four chunks, and
  ``attn_forward`` (GQA, G = 2) causal over three chunks, with a sliding
  window, and on a ragged length (the reference's own chunked path fails
  there, so it runs as one chunk, as in tests/test_torch_models.py).
- Peak memory, on fake tensors under the rank recorder
  (``analysis.trace.record_rank``, every live storage counted, autograd's
  saved tensors too): the loss and its gradient hold at most two (B, c, V)
  float32 chunk buffers plus the float32 head, its gradient twice (the
  accumulated and the new) and h-sized gradients, at 2, 8 and 16 chunks
  alike; the ``torch.utils.checkpoint`` route it replaced holds about five
  chunk buffers.  The attention block's forward and backward hold at most
  three of its largest chunk's float32 scores plus the activations, where
  keeping every chunk's scores grows with the square of the length.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.models import attention as AJ  # noqa: E402
from repro.models import common as CJ  # noqa: E402
from repro_torch.analysis.trace import record_rank  # noqa: E402
from repro_torch.configs import ARCHS as ARCHS_T  # noqa: E402
from repro_torch.configs import reduced as reduced_t  # noqa: E402
from repro_torch.models import attention as AT  # noqa: E402
from repro_torch.models import common as CT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


# --------------------------------------------------------------------------- #
# values and gradients against the reference
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("chunk", [48, 12], ids=["one-chunk", "four-chunks"])
def test_chunked_xent_with_a_masked_cond_prefix_matches_jax_grad(chunk):
    rng = np.random.default_rng(3)
    B, Sc, S, D, V = 2, 8, 40, 16, 56
    h = rng.standard_normal((B, Sc + S, D)).astype(np.float32)
    emb = rng.standard_normal((V, D)).astype(np.float32)
    labels = np.concatenate([np.zeros((B, Sc), np.int64), rng.integers(0, V, (B, S))], 1)
    mask = np.concatenate([np.zeros((B, Sc), np.float32), np.ones((B, S), np.float32)], 1)

    def fj(hh, ee):
        return CJ.chunked_xent(hh, ee, jnp.asarray(labels), jnp.asarray(mask), chunk=chunk)

    (lj, cj), (ghj, gej) = jax.value_and_grad(fj, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(emb))
    ht = torch.from_numpy(h).requires_grad_()
    et = torch.from_numpy(emb).requires_grad_()
    lt, ct = CT.chunked_xent(ht, et, torch.from_numpy(labels), torch.from_numpy(mask),
                             chunk=chunk)
    lt.backward()
    _close(lt.item(), lj)
    assert ct.item() == float(cj) == B * S
    _close(ht.grad, ghj)
    assert not ht.grad[:, :Sc].any()
    _close(et.grad, gej)


ATTN_CASES = {"causal": dict(S=48, q_chunk=16, window=None),
              "window": dict(S=48, q_chunk=16, window=12),
              "ragged": dict(S=37, q_chunk=16, window=None)}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attn_forward_values_and_gradients_match_jax_grad(case):
    S, q_chunk, window = (ATTN_CASES[case][k] for k in ("S", "q_chunk", "window"))
    cj = dataclasses.replace(reduced(ARCHS["minitron-8b"]), n_kv_heads=2)
    ct = dataclasses.replace(reduced_t(ARCHS_T["minitron-8b"]), n_kv_heads=2)
    pj = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                AJ.init_attn(jax.random.PRNGKey(0), cj))
    rng = np.random.default_rng(5)
    B = 2
    h = rng.standard_normal((B, S, cj.d_model)).astype(np.float32)
    r = rng.standard_normal((B, S, cj.d_model)).astype(np.float32)
    pos = np.arange(S)
    sj, cosj = CJ.rope_table(jnp.asarray(pos), cj.head_dim, cj.rope_theta)
    st, cost = CT.rope_table(torch.from_numpy(pos), ct.head_dim, ct.rope_theta)
    # the reference's chunked path fails on a ragged length: one chunk there
    ref_chunk = S if S % q_chunk else q_chunk

    def fj(p, hh):
        out = AJ.attn_forward(p, hh, cj, sj, cosj, window=window, q_chunk=ref_chunk)
        return jnp.sum(out * r), out

    (_, oj), (gpj, ghj) = jax.value_and_grad(fj, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, pj), jnp.asarray(h))
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in pj.items()}
    ht = torch.from_numpy(h).requires_grad_()
    ot = AT.attn_forward(pt, ht, ct, st, cost, window=window, q_chunk=q_chunk)
    ot.backward(torch.from_numpy(r))
    _close(ot.detach(), oj)
    _close(ht.grad, ghj)
    for name in ("wq", "wk", "wv", "wo"):
        _close(pt[name].grad, gpj[name])


# --------------------------------------------------------------------------- #
# peak memory, on fake tensors
# --------------------------------------------------------------------------- #

def _xent_chunk_plain():
    """The chunk's plain ops, the route the one-buffer backward replaced
    (under ``torch.utils.checkpoint``): chip_smoke.py's (u1) yardstick."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.xent_chunk_plain


def _checkpointed_xent(h, emb, labels, mask, chunk):
    from torch.utils.checkpoint import checkpoint

    B, S, D = h.shape
    n = S // chunk
    hc, lc, mc = h.reshape(B, n, chunk, D), labels.reshape(B, n, chunk), mask.reshape(B, n, chunk)
    W = emb.float()
    chunk_plain = _xent_chunk_plain()
    loss = count = 0
    for i in range(n):
        ls, ct = checkpoint(chunk_plain, hc[:, i], lc[:, i], mc[:, i], W,
                            use_reentrant=False)
        loss, count = loss + ls, count + ct
    return loss / count, count


def _loss_peak(xent, B: int, S: int, D: int, V: int, chunk: int) -> int:
    """The bytes held at the peak of a loss and its gradients (h and the
    head), on fake tensors: nothing is held before the call."""
    fm = FakeTensorMode()
    with fm:
        h = torch.empty(B, S, D).requires_grad_()
        emb = torch.empty(V, D).requires_grad_()
        labels = torch.zeros(B, S, dtype=torch.long)
        mask = torch.ones(B, S)

    def step():
        loss, _ = xent(h, emb, labels, mask, chunk)
        return torch.autograd.grad(loss, [h, emb])

    return record_rank(step, fake_mode=fm, device="cpu").peak_bytes


def test_loss_backward_holds_one_chunk_buffer_at_any_chunk_count():
    B, D, V, c = 2, 64, 32768, 256
    buf, head = B * c * V * 4, V * D * 4
    peaks = {}
    for S in (512, 2048, 4096):
        hbytes = B * S * D * 4
        peaks[S] = _loss_peak(lambda *a: CT.chunked_xent(*a[:4], chunk=a[4]), B, S, D, V, c)
        assert peaks[S] <= 2 * buf + 3 * head + 4 * hbytes, (S, peaks[S] / buf)
        old = _loss_peak(_checkpointed_xent, B, S, D, V, c)
        assert old > 4 * buf, (S, old / buf)
    # flat in the number of chunks: only h-sized gradients grow with S
    assert peaks[4096] - peaks[512] <= 4 * B * (4096 - 512) * D * 4, peaks


@pytest.mark.parametrize("S", [2048, 4096])
def test_attention_backward_holds_a_few_chunks_of_scores(S):
    cfg = dataclasses.replace(reduced_t(ARCHS_T["minitron-8b"]), n_kv_heads=2)
    B, q_chunk = 1, 256
    fm = FakeTensorMode()
    with fm:
        p = {k: v.requires_grad_() for k, v in
             AT.init_attn(torch.Generator(), cfg, dtype=torch.float32).items()}
        h = torch.empty(B, S, cfg.d_model).requires_grad_()
        sin, cos = CT.rope_table(torch.arange(S), cfg.head_dim, cfg.rope_theta)

    def step():
        out = AT.attn_forward(p, h, cfg, sin, cos, q_chunk=q_chunk)
        return torch.autograd.grad(out.sum(), [h, p["wq"], p["wk"], p["wv"], p["wo"]])

    peak = record_rank(step, fake_mode=fm, device="cpu").peak_bytes
    scores = B * cfg.n_heads * q_chunk * S * 4          # the largest chunk's, float32
    acts = B * S * max(cfg.d_model, cfg.n_heads * cfg.head_dim) * 4
    every_chunk = B * cfg.n_heads * S * (S + q_chunk) // 2 * 4
    assert peak <= 3 * scores + 16 * acts < every_chunk, (peak, scores, acts)
