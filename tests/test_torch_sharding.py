"""Port parity for the sharding rules (``repro_torch.sharding``): no ranks.

The reference's rules read only ``mesh.shape``, so a stand-in mesh with a
``shape`` dict serves both packages (``cache_shardings``, which wraps its
specs in ``NamedSharding``s, gets an ``AbstractMesh`` of the same shape).  Every leaf of every config in
``configs/`` at full size — its path and shape from ``jax.eval_shape`` of
the reference's ``init_params`` — gets the same spec from both
``param_spec``s on the production meshes (16 × 16 and 2 × 16 × 16) under
both policies; the port's own ``init_params`` gives the reference's paths
and shapes (at ``reduced`` size), so the pairs are the port's too.  The
same for ``batch_spec``, ``cache_shardings``' specs and ``_fit``; the spec
→ placement map; ``constrain`` is the identity outside a mesh; and a
mirror of tests/test_sharding_and_analysis.py's rule tests.  Specs are
compared with the reference's ``PartitionSpec`` directly (a tuple equals
it entry for entry).
"""
from __future__ import annotations

import functools
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import sharding as RS  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro_torch import sharding as TS  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402

from hypothesis_compat import given, settings, st  # noqa: E402


class _Mesh:
    """A mesh as the rules see it: axis name → size, in order."""

    def __init__(self, **shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"16x16": _Mesh(data=16, model=16),
          "2x16x16": _Mesh(pod=2, data=16, model=16)}
POLICIES = ("default", "dp_only")
NAMES = sorted(ARCHS)


@functools.lru_cache(maxsize=None)
def _ref_leaves(name: str, small: bool) -> tuple:
    """((path, shape), ...) of the reference's parameters of config
    ``name`` (full size, or ``reduced``) from ``jax.eval_shape``."""
    from repro.models.model import init_params

    cfg = REF_ARCHS[name]
    cfg = ref_reduced(cfg) if small else cfg
    tree = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return tuple((RS._path_str(p), tuple(x.shape)) for p, x in leaves)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("policy", POLICIES)
def test_param_spec_equals_the_reference_on_every_leaf(name, mesh, policy):
    m = MESHES[mesh]
    leaves = _ref_leaves(name, False)
    assert leaves
    for path, shape in leaves:
        want = RS.param_spec(m, path, shape, policy)
        got = TS.param_spec(m, path, shape, policy)
        assert isinstance(got, tuple) and got == want, (path, shape, got, want)
        assert len(got) == len(shape)


def _port_leaves(params: dict, prefix: str = "") -> list:
    out = []
    for k in sorted(params):
        path = f"{prefix}/{k}" if prefix else k
        v = params[k]
        out += _port_leaves(v, path) if isinstance(v, dict) else [(path, tuple(v.shape))]
    return out


@pytest.mark.parametrize("name", NAMES)
def test_port_params_have_the_reference_paths_and_shapes(name):
    from repro_torch.models.model import init_params

    got = _port_leaves(init_params(0, reduced(ARCHS[name]), device="cpu"))
    assert sorted(got) == sorted(_ref_leaves(name, True))


def test_params_shardings_follow_param_spec():
    from repro_torch.models.model import init_params

    params = init_params(0, reduced(ARCHS["moonshot-v1-16b-a3b"]), device="cpu")
    m = _Mesh(data=2, model=2)
    specs = TS.params_shardings(m, params)
    assert set(specs) == set(params)
    assert specs["embed"] == TS.param_spec(m, "embed", tuple(params["embed"].shape))
    wg = params["blocks"]["pos0"]["ffn"]["wi_gate"]
    assert specs["blocks"]["pos0"]["ffn"]["wi_gate"] == P(None, "model", "data", None)
    assert specs["blocks"]["pos0"]["ffn"]["wi_gate"] == TS.param_spec(
        m, "blocks/pos0/ffn/wi_gate", tuple(wg.shape))
    opt = TS.opt_shardings(m, None, specs)
    assert opt.step == P() and opt.m is specs and opt.v is specs and opt.master is specs


@pytest.mark.parametrize("mesh", list(MESHES) + ["1x1", "2x2", "4x1"])
@pytest.mark.parametrize("policy", POLICIES)
def test_batch_spec_equals_the_reference(mesh, policy):
    m = MESHES.get(mesh) or _Mesh(**dict(zip(("data", "model"),
                                             map(int, mesh.split("x")))))
    for batch, extra in itertools.product((1, 2, 3, 4, 8, 16, 32, 48, 256, 512, 1000),
                                          (0, 1, 2)):
        assert TS.batch_spec(m, batch, extra_dims=extra, policy=policy) == RS.batch_spec(
            m, batch, extra_dims=extra, policy=policy), (batch, extra)


@pytest.mark.parametrize("name", ["minitron-8b", "zamba2-7b", "xlstm-125m",
                                  "moonshot-v1-16b-a3b", "gemma3-12b"])
@pytest.mark.parametrize("use_sketch", [False, True])
def test_cache_shardings_equal_the_reference(name, use_sketch):
    # the reference's NamedShardings on an AbstractMesh of the same shape
    from jax.sharding import AbstractMesh

    from repro.models.model import init_cache

    cfg = ref_reduced(REF_ARCHS[name])
    cache = jax.eval_shape(lambda: init_cache(cfg, 4, 64, use_sketch=use_sketch))
    leaves = jax.tree_util.tree_leaves(cache)
    for m in [*MESHES.values(), _Mesh(data=2, model=2), _Mesh(data=1, model=4)]:
        am = AbstractMesh(tuple(m.shape.values()), tuple(m.shape))
        for batch in (4, 3):
            for policy in POLICIES:
                want = [s.spec for s in jax.tree_util.tree_leaves(
                    RS.cache_shardings(am, cache, batch, policy))]
                assert TS.cache_shardings(m, list(leaves), batch, policy) == want


def test_cache_shardings_equal_the_reference_through_named_shardings():
    # on the reference's own 1 × 1 debug mesh, its NamedShardings' specs
    from repro.launch.mesh import make_debug_mesh
    from repro.models.model import init_cache

    cfg = ref_reduced(REF_ARCHS["minitron-8b"])
    cache = jax.eval_shape(lambda: init_cache(cfg, 4, 64))
    leaves = jax.tree_util.tree_leaves(cache)
    mesh = make_debug_mesh(1, 1)
    want = [s.spec for s in jax.tree_util.tree_leaves(RS.cache_shardings(mesh, cache, 4))]
    assert TS.cache_shardings(_Mesh(data=1, model=1), list(leaves), 4) == want


AXES = [("data",), ("pod", "data"), ("pod", "data", "model"), ("data", "model"), "model",
        None]


@pytest.mark.parametrize("axes", AXES, ids=str)
def test_fit_equals_the_reference_on_a_grid(axes):
    for pod, data, model in itertools.product((1, 2, 3), (1, 2, 4, 16), (1, 2, 8, 16)):
        m = _Mesh(pod=pod, data=data, model=model)
        for dim in (*range(1, 70), 96, 128, 255, 256, 512, 1000, 1024, 4096):
            assert TS._fit(m, dim, axes) == RS._fit(m, dim, axes), (m.shape, dim, axes)


@settings(max_examples=200, deadline=None)
@given(pod=st.integers(1, 4), data=st.integers(1, 32), model=st.integers(1, 32),
       dim=st.integers(1, 1 << 20), which=st.integers(0, len(AXES) - 1))
def test_fit_equals_the_reference_property(pod, data, model, dim, which):
    m = _Mesh(pod=pod, data=data, model=model)
    assert TS._fit(m, dim, AXES[which]) == RS._fit(m, dim, AXES[which])


def test_data_axes_and_axis_size_equal_the_reference():
    for m in [*MESHES.values(), _Mesh(data=2, model=2), _Mesh(model=4)]:
        for policy in POLICIES:
            assert TS.data_axes(m, policy) == RS.data_axes(m, policy)
        for axes in AXES:
            if axes is None or all(a in m.shape for a in
                                   ((axes,) if isinstance(axes, str) else axes)):
                assert TS._axis_size(m, axes) == RS._axis_size(m, axes)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    m = _Mesh(pod=2, data=4, model=2)
    assert TS.placements(m, (None, None)) == [Replicate()] * 3
    assert TS.placements(m, (("pod", "data"), "model")) == [Shard(0), Shard(0), Shard(1)]
    assert TS.placements(m, (None, ("pod", "data", "model"))) == [Shard(1)] * 3
    assert TS.placements(m, ("model", None, "data")) == [Replicate(), Shard(2), Shard(0)]
    with pytest.raises(ValueError, match="axis order"):
        TS.placements(m, (("data", "pod"), None))
    with pytest.raises(ValueError, match="shards two dims"):
        TS.placements(m, ("data", "data"))


@pytest.mark.parametrize("entries", [("dp", None, None), ("dp", None, "tp!", None),
                                     (None, "tp"), ("sp",), ()])
def test_constrain_is_the_identity_outside_a_mesh(entries):
    x = torch.randn(4, 8, 6, 2)
    assert TS.current_mesh() is None
    assert TS.constrain(x, *entries) is x
    assert TS.constrain(x, *entries, policy="dp_only") is x


def test_constrain_entries_equal_the_reference_rules():
    # the spec constrain redistributes to, against the reference's rules
    for m in [*MESHES.values(), _Mesh(data=2, model=2), _Mesh(data=2, model=3)]:
        for shape, entries in [((8, 64, 96), ("dp", None, None)),
                               ((8, 64, 6, 16), ("dp", None, "tp!", None)),
                               ((3, 64, 5, 16), ("dp", None, "tp!", None)),
                               ((8, 512), ("dp", "sp")), ((8, 1), ("dp", "sp")),
                               ((48, 96), ("tp", "dp"))]:
            for policy in POLICIES:
                fsdp = RS.data_axes(m, policy)
                tp = "model" if "model" in m.shape and policy != "dp_only" else None
                want = []
                for dim, e in zip(shape, entries):
                    if e == "dp":
                        want.append(RS._fit(m, dim, fsdp))
                    elif e in ("tp", "sp"):
                        want.append(RS._fit(m, dim, tp))
                    elif e == "tp!":
                        want.append(tp if tp is not None and m.shape.get("model", 1) > 1
                                    else None)
                    else:
                        want.append(None)
                assert TS._entries_spec(m, shape, entries, policy) == tuple(want)


def test_mesh_context_sets_and_restores_the_current_mesh():
    class _DM:
        class mesh:
            shape = (2, 2)

    m = TS.Mesh(_DM, ("data", "model"), torch.device("cpu"))
    assert m.shape == {"data": 2, "model": 2} and m.size == 4
    assert TS.current_mesh() is None
    with m:
        assert TS.current_mesh() is m and TS._current_mesh() is m
        with m:
            assert TS.current_mesh() is m
        assert TS.current_mesh() is m
    assert TS.current_mesh() is None


# --------------------------------------------------------------------------- #
# a mirror of tests/test_sharding_and_analysis.py's rule tests (one device)
# --------------------------------------------------------------------------- #

def test_param_spec_rules():
    mesh = _Mesh(data=1, model=1)
    # embed: vocab→tp, d→fsdp; 1-device mesh → everything falls back to None
    assert TS.param_spec(mesh, "embed", (512, 64)) == P(None, None)


def test_divisibility_fallback_never_errors():
    mesh = _Mesh(data=1, model=1)
    for shape in [(7, 13), (3, 5, 7), (1,), (127, 255, 3)]:
        spec = TS.param_spec(mesh, "blocks/pos0/attn/wq", shape)
        assert len(spec) == len(shape)


def test_params_shardings_cover_tree():
    mesh = _Mesh(data=1, model=1)
    tree = {"embed": torch.zeros((8, 4)),
            "blocks": {"pos0": {"attn": {"wq": torch.zeros((4, 4))}}}}
    sh = TS.params_shardings(mesh, tree)
    assert set(sh) == set(tree) and set(sh["blocks"]["pos0"]["attn"]) == {"wq"}
    assert sh["blocks"]["pos0"]["attn"]["wq"] == P(None, None)


def test_batch_spec():
    mesh = _Mesh(data=1, model=1)
    assert TS.batch_spec(mesh, 8) == P(None, None)
