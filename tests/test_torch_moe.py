"""Port parity for the MoE FFN (``models/moe.py``): ``init_moe``'s layout,
``moe_forward_local`` (outputs, aux loss, dropped fraction) and its
gradients against the reference's, the capacity with drops, and the
combine's determinism (no scatter-add, no float atomics on the card).

The reference's draw is widened to float32 and carried across; activations
are float32 too.  The router is float32 in both packages, and on float32
activations no routing decision sits within rounding of a tie at these
seeds, so the experts each token picks (``tope``) are asserted equal before
any value is compared: a bfloat16 rounding could flip a choice near a tie,
which no tolerance should be widened to cover.  Values at 1e-5 relative to
the largest entry (the reference's own MoE equivalence tolerance,
tests/test_perf_equivalence.py), gradients at 2e-4 (one backward pass, as
tests/test_torch_train.py)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.configs.base import MoECfg as MoECfgJ  # noqa: E402
from repro.models import moe as MJ  # noqa: E402
from repro_torch.configs.base import MoECfg  # noqa: E402
from repro_torch.models import moe as MT  # noqa: E402

KEY = jax.random.PRNGKey(0)
TOL, GRAD_TOL = 1e-5, 2e-4
CASES = {
    "moonshot": lambda: reduced(ARCHS["moonshot-v1-16b-a3b"]).moe,
    "arctic": lambda: reduced(ARCHS["arctic-480b"]).moe,
    # test_moe_capacity_drops_reported's configuration: C = T·K/E exactly
    "drops": lambda: MoECfgJ(n_experts=4, top_k=2, d_ff_expert=16, capacity_factor=1.0),
}


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _moe_t(moe_j) -> MoECfg:
    return MoECfg(**dataclasses.asdict(moe_j))


def _case(name, d_model=64, shape=(2, 16), seed=3):
    moe_j = CASES[name]()
    pj = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                MJ.init_moe(KEY, d_model, moe_j))
    pt = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), pj)
    x = np.random.default_rng(seed).standard_normal((*shape, d_model)).astype(np.float32)
    return moe_j, _moe_t(moe_j), pj, pt, x


@pytest.mark.parametrize("dense_residual", [False, True])
def test_init_moe_layout_matches_reference(dense_residual):
    moe_j = dataclasses.replace(CASES["arctic"](), dense_residual=dense_residual,
                                d_ff_dense=64 if dense_residual else 0)
    pj = MJ.init_moe(KEY, 64, moe_j)
    pt = MT.init_moe(torch.Generator().manual_seed(0), 64, _moe_t(moe_j))
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(pj)[0]}
    flat_t = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(pt)[0]}
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_t.items():
        assert tuple(v.shape) == flat_j[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(flat_j[k].dtype), k
    assert pt["router"].dtype == torch.float32 and pt["wi_gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("n_tokens", [1, 4, 64, 1000, 4096])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "arctic-480b"])
def test_capacity_matches_reference(arch, n_tokens):
    """Including decode's floor: moonshot at batch 4, ⌊4·6·1.25/64⌋ = 0, so
    C = 4."""
    moe_j = ARCHS[arch].moe
    assert MT.capacity(n_tokens, _moe_t(moe_j)) == MJ.capacity(n_tokens, moe_j)
    if arch.startswith("moonshot") and n_tokens == 4:
        assert MT.capacity(n_tokens, _moe_t(moe_j)) == 4


@pytest.mark.parametrize("name", list(CASES))
def test_moe_forward_local_matches_reference(name):
    """Equal expert choices first, then the outputs, the aux loss and the
    dropped fraction; the "drops" case drops entries (capacity factor 1)."""
    moe_j, moe_t, pj, pt, x = _case(name, shape=(2, 16) if name != "drops" else (4, 16))
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    T, D = x.shape[0] * x.shape[1], x.shape[2]
    C = MT.capacity(T, moe_t)
    _, info = MJ._dispatch(xj.reshape(T, D), pj["router"], moe_j, C)
    _, route = MT._dispatch(xt.reshape(T, D), pt["router"], moe_t, C)
    np.testing.assert_array_equal(route.tope.numpy(), np.asarray(info[4]))
    np.testing.assert_array_equal(route.keep.numpy(), np.asarray(info[2]))
    oj, mj = MJ.moe_forward_local(pj, xj, moe_j)
    ot, mt = MT.moe_forward(pt, xt, moe_t)
    assert ot.shape == xt.shape and ot.dtype == torch.float32
    _close(ot.numpy(), oj, TOL)
    _close(mt.aux_loss.item(), mj.aux_loss, TOL)
    assert mt.dropped_fraction.item() == pytest.approx(float(mj.dropped_fraction), abs=1e-7)
    if name == "drops":
        assert 0.0 < mt.dropped_fraction.item() < 1.0
        assert mt.aux_loss.item() > 0.5        # ≈1 for balanced routing


@pytest.mark.parametrize("name", ["moonshot", "arctic"])
def test_moe_gradients_match_reference(name):
    """d/dθ and d/dx of Σ out·w + aux_loss, through the gather dispatch and
    combine (their backward sums the K routes of each token)."""
    moe_j, moe_t, pj, pt, x = _case(name)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def loss_j(p, h):
        o, m = MJ.moe_forward_local(p, h, moe_j)
        return jnp.sum(o * w) + m.aux_loss

    gpj, gxj = jax.grad(loss_j, argnums=(0, 1))(pj, jnp.asarray(x))
    leaves = [t.clone().requires_grad_() for t in jax.tree_util.tree_leaves(pt)]
    it = iter(leaves)
    live = jax.tree_util.tree_map(lambda _: next(it), pt)
    xt = torch.from_numpy(x).requires_grad_()
    o, m = MT.moe_forward(live, xt, moe_t)
    (torch.sum(o * torch.from_numpy(w)) + m.aux_loss).backward()
    _close(xt.grad.numpy(), gxj, GRAD_TOL)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(gpj)):
        # the norm is the block's, applied outside moe_forward: no gradient
        g = a.grad if a.grad is not None else torch.zeros_like(a)
        _close(g.numpy(), b, GRAD_TOL)


def test_dispatch_and_combine_use_no_scatter_add():
    """Every aten op the forward runs, recorded: no index_add, scatter_add,
    accumulating index_put or scatter_reduce (each of which sums through
    float atomics on the card, in whatever order they land), no read back
    to the host (``_local_scalar_dense``: a synchronization a layer on the
    card), and two calls give the same bits."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            accumulate = func.__name__.startswith("index_put") and (
                kwargs.get("accumulate") or (len(args) > 3 and args[3]))
            self.ops.append((func.__name__, bool(accumulate)))
            return func(*args, **kwargs)

    _, moe_t, _, pt, x = _case("drops", shape=(4, 16))
    pt = {k: (v.bfloat16() if k.startswith("w") else v) for k, v in pt.items()}
    xt = torch.from_numpy(x).bfloat16()
    with Record() as rec:
        out, _ = MT.moe_forward(pt, xt, moe_t)
    names = {n for n, _ in rec.ops}
    assert not any(n.startswith(("index_add", "scatter_add", "scatter_reduce"))
                   for n in names), names
    assert not any(acc for _, acc in rec.ops)
    assert not any(n.startswith("_local_scalar_dense") for n in names), names
    assert any(n.startswith("bmm") for n in names)
    assert torch.equal(MT.moe_forward(pt, xt, moe_t)[0], out)


# --------------------------------------------------------------------------- #
# the MoE models: reduced moonshot-v1-16b-a3b and arctic-480b (dense residual)
# --------------------------------------------------------------------------- #

MOE_ARCHS = ["moonshot-v1-16b-a3b", "arctic-480b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_forward_and_prefill_match_reference(arch):
    from torch_family_parity import check_forward_and_prefill

    check_forward_and_prefill(arch)


@pytest.mark.parametrize("use_sketch", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_prefill_with_cache_and_decode_match_reference(arch, use_sketch):
    from torch_family_parity import check_cache_and_decode

    check_cache_and_decode(arch, use_sketch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_loss_and_gradients_match_reference(arch):
    from torch_family_parity import check_loss_and_gradients

    check_loss_and_gradients(arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_decode_matches_forward(arch):
    from torch_family_parity import check_decode_matches_forward

    check_decode_matches_forward(arch)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "arctic-480b", "zamba2-7b"])
def test_params_from_numpy_keeps_every_leaf_and_dtype(arch):
    """The reference's own bfloat16 draw carried across bit for bit: the
    (n_sb, E, ·, ·) expert stacks in bfloat16, the router and the Mamba-2
    constants (A_log, D, dt_bias) in float32; a stack over the wrong number
    of superblocks is refused."""
    from repro.models import model as MJm
    from repro_torch import interop

    from torch_family_parity import build

    cj, ct, pj, pt = build(arch, f32=False)
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(pj)[0]}
    flat_t = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(pt)[0]}
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_t.items():
        assert str(v.dtype).split(".")[-1] == str(flat_j[k].dtype), k
        np.testing.assert_array_equal(v.float().numpy(), np.asarray(flat_j[k], np.float32))
    blocks = pt["blocks"]["pos0"]
    if "ffn" in blocks:
        assert blocks["ffn"]["wi_gate"].ndim == 4 and blocks["ffn"]["router"].dtype == torch.float32
    else:
        assert all(blocks["mixer"][k].dtype == torch.float32 for k in ("A_log", "D", "dt_bias"))
    wrong = dataclasses.replace(ct, n_superblocks=3, n_layers=3 * len(ct.pattern))
    with pytest.raises(ValueError, match="stacked"):
        interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), wrong, device="cpu")
    assert MJm.param_count(pj) == sum(v.numel() for v in flat_t.values())


def test_active_param_count_matches_reference():
    from repro.models import model as MJm
    from torch_family_parity import build

    from repro_torch.models import model as MTm

    for arch in MOE_ARCHS + ["zamba2-7b"]:
        cj, ct, pj, pt = build(arch)
        assert MTm.active_param_count(ct, pt) == MJm.active_param_count(cj, pj), arch
    cj, ct, pj, pt = build("moonshot-v1-16b-a3b")
    assert MTm.active_param_count(ct, pt) < MTm.param_count(pt)
