"""Shared model-level parity checks of the port against the reference for the
families beyond dense attention (MoE, the Mamba-2 hybrid, the conditioning
input), on ``reduced`` configs at two superblocks.  Used by
tests/test_torch_moe.py, tests/test_torch_ssm.py and
tests/test_torch_models.py; not a test module itself.

The reference's ``init_params`` draw is carried across with
``interop.params_from_numpy`` (widened to float32 unless a check says
otherwise), and the reference's slot draws and conditioning embeddings are
fed to both packages.  Tolerances are the model tests': 2e-4 relative to the
largest entry through the model (tests/test_torch_models.py) and for the
loss and its gradients (tests/test_torch_train.py); decode against forward
at the reference's own 0.05 (recurrent mixers) and 1e-3 (attention only),
tests/test_archs_smoke.py:67."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS, reduced
from repro.core.sketched_attention import decode_slot_table
from repro.models import model as MJ
from repro_torch import interop
from repro_torch._util import tree_leaves
from repro_torch.configs import ARCHS as ARCHS_T
from repro_torch.configs import reduced as reduced_t
from repro_torch.models import model as MT
from repro_torch.train import step as ST

KEY = jax.random.PRNGKey(0)
TOL = 2e-4
RECURRENT = ("mamba2", "mlstm", "slstm")
# the reference's decode step compiled once a config (its eager loop
# dispatches every op of every step)
DECODE_J = jax.jit(MJ.decode_step, static_argnames=("cfg", "use_sketch"))


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@functools.lru_cache(maxsize=None)
def build(arch: str, f32: bool = True):
    """(cfg_j, cfg_t, params_j, params_t) of ``reduced(arch)`` at two
    superblocks, the reference's draw in float32 (or its bfloat16)."""
    kw = dict(n_layers=2 * len(ARCHS[arch].pattern), n_superblocks=2)
    cj = dataclasses.replace(reduced(ARCHS[arch]), **kw)
    ct = dataclasses.replace(reduced_t(ARCHS_T[arch]), **kw)
    pj = MJ.init_params(KEY, cj)
    if f32:
        pj = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), pj)
    pt = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct, device="cpu")
    return cj, ct, pj, pt


def inputs(cfg, B=2, S=32, seed=1):
    """(tokens, labels, cond or None) as numpy: next-token pairs, and float32
    conditioning embeddings (B, cond_len, d_model) where the config has a
    frontend."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1))
    cond = (rng.standard_normal((B, cfg.cond_len, cfg.d_model)).astype(np.float32)
            if cfg.frontend else None)
    return tok[:, :-1], tok[:, 1:], cond


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def check_forward_and_prefill(arch: str) -> None:
    """forward's hidden states and aux loss, and prefill's last-position
    logits, with ``cond`` where the config has a frontend."""
    cj, ct, pj, pt = build(arch)
    tok, _, cond = inputs(cj)
    hj, aj = MJ.forward(pj, jnp.asarray(tok), cj, cond=_j(cond), q_chunk=16, remat="none")
    ht, at = MT.forward(pt, torch.from_numpy(tok), ct, cond=_t(cond), q_chunk=16,
                        remat="none")
    S_tot = tok.shape[1] + (cj.cond_len if cj.frontend else 0)
    assert tuple(ht.shape) == hj.shape == (tok.shape[0], S_tot, cj.d_model)
    close(ht.numpy(), hj, TOL)
    close(at.item(), aj, TOL)
    assert (at.item() > 0) == (cj.moe is not None)
    close(MT.prefill(pt, torch.from_numpy(tok), ct, cond=_t(cond), q_chunk=16).numpy(),
          MJ.prefill(pj, jnp.asarray(tok), cj, cond=_j(cond), q_chunk=16), TOL)


def check_cache_and_decode(arch: str, use_sketch: bool, L: int = 16, n: int = 8) -> None:
    """prefill_with_cache of L tokens into an exact or sketched cache (d_slots
    16 < L + n positions: slots really are shared), then n teacher-forced
    decode steps, logits at every step and every layer's state at the end."""
    cj, ct, pj, pt = build(arch)
    B = 2
    tokens = np.random.default_rng(2).integers(0, cj.vocab_size, (B, L + n))
    sa = cj.sketch_attn
    table = np.asarray(decode_slot_table(KEY, L + n, sa.d_slots, sa.m_r, max_len=999))
    cache_j = MJ.init_cache(cj, B, L + n, jnp.float32, use_sketch=use_sketch)
    cache_t = MT.init_cache(ct, B, L + n, torch.float32, use_sketch=use_sketch, device="cpu")
    lj, cache_j = MJ.prefill_with_cache(pj, jnp.asarray(tokens[:, :L]), cj, cache_j,
                                        slot_table=jnp.asarray(table[:L]), q_chunk=16)
    lt, cache_t = MT.prefill_with_cache(pt, torch.from_numpy(tokens[:, :L]), ct, cache_t,
                                        slot_table=table[:L], q_chunk=16)
    close(lt.numpy(), lj, TOL)
    for pos in range(L, L + n):
        lj, cache_j = DECODE_J(pj, cache_j, jnp.asarray(tokens[:, pos]), jnp.int32(pos), cj,
                               slots=jnp.asarray(table[pos]), use_sketch=use_sketch)
        lt, cache_t = MT.decode_step(pt, cache_t, torch.from_numpy(tokens[:, pos]), pos, ct,
                                     slots=table[pos], use_sketch=use_sketch)
        assert lt.isfinite().all()
        close(lt.numpy(), lj, TOL)
    # every layer's state: superblock i of the port is slice i of the reference's stack
    for key in cache_j.blocks:
        fields_t = zip(*[tuple(st) for st in cache_t.blocks[key]])
        for fj, ft in zip(jax.tree_util.tree_leaves(cache_j.blocks[key]), fields_t):
            close(torch.stack(ft).float().numpy(), np.asarray(fj, np.float32), TOL)


def check_loss_and_gradients(arch: str) -> None:
    """loss_fn (cross-entropy on the token positions only where ``cond`` is
    given, plus the weighted MoE aux loss) and every gradient."""
    cj, ct, pj, pt = build(arch)
    tok, lab, cond = inputs(cj)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: MJ.loss_fn(p, jnp.asarray(tok), jnp.asarray(lab), cj, cond=_j(cond),
                             q_chunk=16, remat="none"), has_aux=True)(pj)
    tc = ST.TrainConfig(remat="none", q_chunk=16)
    lt, mt, gt = ST._value_and_grad(pt, torch.from_numpy(tok), torch.from_numpy(lab), _t(cond),
                                    ct, tc)
    close(lt.item(), lj, TOL)
    close(mt["xent"].item(), mj["xent"], TOL)
    close(mt["aux"].item(), mj["aux"], TOL)
    assert mt["tokens"].item() == float(mj["tokens"]) == tok.size
    flat_j = jax.tree_util.tree_leaves(gj)
    assert len(flat_j) == len(tree_leaves(gt))
    for a, b in zip(tree_leaves(gt), flat_j):
        assert tuple(a.shape) == b.shape
        close(a, b, TOL)


def check_decode_matches_forward(arch: str) -> float:
    """On the reference's bfloat16 draw and its own test's tokens
    (tests/test_archs_smoke.py::test_decode_matches_forward): the port's
    decode loop against its forward's logits, at 0.05 with a recurrent
    mixer and 1e-3 otherwise, and the reference's gap on the same input
    below the same bound.  (An MoE forward over 32 tokens may drop entries
    that decode, at C = 4 for 2 tokens, keeps: both packages then differ
    from their own forward by the same ~0.5, so other draws are no test of
    the port.)  Returns the port's worst gap."""
    cj, ct, pj, pt = build(arch, f32=False)
    B, S = 2, 16
    toks_j = jax.random.randint(KEY, (B, S), 0, cj.vocab_size)
    toks = torch.from_numpy(np.array(toks_j)).long()
    h, _ = MT.forward(pt, toks, ct, remat="none")
    ref = h.float() @ MT.output_embedding(pt).float().T
    hj, _ = MJ.forward(pj, toks_j, cj, remat="none")
    ref_j = hj.astype(jnp.float32) @ MJ.output_embedding(pj).T.astype(jnp.float32)
    cache, cache_j = MT.init_cache(ct, B, S, device="cpu"), MJ.init_cache(cj, B, S)
    worst = worst_j = 0.0
    for t in range(S):
        lg, cache = MT.decode_step(pt, cache, toks[:, t], t, ct)
        worst = max(worst, (lg - ref[:, t]).abs().max().item())
        lj, cache_j = DECODE_J(pj, cache_j, toks_j[:, t], jnp.int32(t), cj)
        worst_j = max(worst_j, float(jnp.max(jnp.abs(lj - ref_j[:, t]))))
    tol = 0.05 if any(k in RECURRENT for k in ct.pattern) else 1e-3
    assert worst < tol and worst_j < tol, (arch, worst, worst_j)
    return worst
