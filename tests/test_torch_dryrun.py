"""The dry run in the port (``repro_torch.launch.specs``, ``.dryrun``, the
rank recorder and ``landmark_attention``'s stand-in) against the
reference's ``repro.launch``, on the CPU.

- Every one of the 40 (architecture × shape) cells: the abstract inputs
  (parameters, optimizer state, cache, tokens, cond, slots, step and
  position) equal the reference's ``input_specs`` leaf by leaf in shape and
  dtype (the port's decode cache holds one state a superblock, the
  reference's stacks them: compared stacked), and each leaf's spec on the
  16 × 16 and 2 × 16 × 16 mesh shapes equals the reference's
  ``NamedSharding`` spec on a JAX ``AbstractMesh`` of the same shape.
- ``_active_params`` and ``main(["--list"])`` equal the reference's.  The
  reference's ``launch.dryrun`` forces 512 host devices when it is
  imported, so it runs in a subprocess, with four forced devices, beside
  its compiled reduced cells on a (2, 2) mesh of ``AxisType.Auto`` axes
  (jax 0.9's ``make_mesh`` makes ``Explicit`` axes, which the reference's
  ``with_sharding_constraint`` refuses).
- Reduced stablelm-3b and moonshot-v1-16b-a3b cells on a (2, 2) ``"fake"``
  group: the per-rank FLOPs of prefill and the exact decode equal the
  reference's per-partition FLOPs exactly.  Those of a training step and of
  a sketched decode step equal the reference's plus a gap counted from the
  cell (``_counted_gap``): in training, the loss chunks' forward logits
  (the compiled reference merges them with their recompute in the
  backward; the eager port computes both) less one QKᵀ product a chunk of
  every attention block (the reference's chunk body is a ``jax.checkpoint``
  and recomputes it in the backward; the port's keeps its scores); in the
  sketched decode, the attention's two products on the whole cache, which
  every rank computes after the gather, less the reference's share (the
  batch over data, the slots over model).
- On one rank the dry run is the real program: a reduced float32 training
  step and a sketched decode step recorded for real (``trace.record``)
  and as a dry run on a one-rank ``"fake"`` group give the same non-view
  ops in the same order and the same FLOPs.
- ``landmark_attend`` on fake CUDA tensors counts one dispatch, launches
  nothing and gives the plain version's shape and dtype, charged the
  kernel's two products; a CPU tensor still takes the plain version.
- ``init_params`` digests are the ones the parameters had before the init
  was made traceable, and every config's parameters come up under
  ``FakeTensorMode``.
Each test that starts the fake group destroys it.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402

from repro.launch import specs as RS  # noqa: E402
from repro_torch._util import tree_leaves  # noqa: E402
from repro_torch.analysis.trace import record, record_rank  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, reduced  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.launch.analysis import analyze  # noqa: E402
from repro_torch.models.model import DecodeCache  # noqa: E402
from repro_torch.train.step import TrainConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a in ARCHS for s in SHAPES]
MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# reduced cells compared with the reference on a (2, 2) mesh: a training
# batch whose microbatches split over the data axis, prefill, the exact
# decode and the sketched one (long_500k's name selects the sketch cache)
REDUCED = {"train": ShapeSpec("train_4k", 64, 8, "train"),
           "prefill": ShapeSpec("prefill_32k", 64, 4, "prefill"),
           "decode": ShapeSpec("decode_32k", 64, 4, "decode"),
           "sketched": ShapeSpec("long_500k", 64, 4, "decode")}
REDUCED_ARCHS = ("stablelm-3b", "moonshot-v1-16b-a3b")


@contextlib.contextmanager
def fake_group(n: int):
    TD.start_fake_group(n)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def _port_leaves(args) -> list:
    """(shape, dtype) of every tensor of a port cell's arguments, the decode
    cache's per-superblock states stacked as the reference stacks them."""
    out = []
    for a in args:
        if isinstance(a, DecodeCache):
            for pos in sorted(a.blocks):
                states = a.blocks[pos]
                out += [((len(states), *tuple(x.shape)), _dtype_name(x.dtype))
                        for x in states[0]]
        else:
            out += [(tuple(x.shape), _dtype_name(x.dtype)) for x in tree_leaves(a)
                    if x is not None]
    return out


def _port_specs(shardings) -> list:
    """Every spec of a port cell's ``in_shardings``, the decode cache's
    with the reference's leading (unsharded) superblock entry."""
    out = []
    for s in shardings:
        if isinstance(s, DecodeCache):
            for pos in sorted(s.blocks):
                out += [(None, *spec) for spec in s.blocks[pos][0]]
        else:
            out += [spec for spec in TS._spec_leaves(s) if spec is not None]
    return out


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_specs_equal_the_reference(arch, shape):
    want = [(tuple(x.shape), _dtype_name(x.dtype))
            for x in jax.tree_util.tree_leaves(RS.input_specs(arch, shape))]
    got = TS.input_specs(arch, shape, device="cpu")
    assert _port_leaves(got) == want
    fakes = [x for x in tree_leaves(got) if isinstance(x, torch.Tensor) and x.ndim > 1]
    assert fakes and all(type(x).__name__ == "FakeTensor" for x in fakes)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_in_shardings_equal_the_reference(arch, mesh):
    am = JaxAbstractMesh(tuple(MESHES[mesh].values()), tuple(MESHES[mesh]))
    for shape in SHAPES:
        ref = RS.make_cell(arch, shape, am)
        want = [s.spec for s in jax.tree_util.tree_leaves(ref.in_shardings)]
        cell = TS.make_cell(arch, shape, TS.AbstractMesh(MESHES[mesh]), device="cpu")
        assert _port_specs(cell.in_shardings) == want, shape
        assert _port_leaves(cell.args) == [
            (tuple(x.shape), _dtype_name(x.dtype)) for x in jax.tree_util.tree_leaves(ref.args)]


_REFERENCE = r'''
import contextlib, io, json, os, sys
import repro.launch.dryrun as RD          # forces 512 host devices when imported
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"  # before jax starts
import jax
from jax.sharding import AxisType
from repro.configs import ARCHS, reduced
from repro.configs.base import ShapeSpec
from repro.launch import specs as RS
from repro.launch.analysis import analyze
from repro.train.step import TrainConfig

out = {"active": {a: RD._active_params(a) for a in ARCHS}, "cells": {}}
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    RD.main(["--list"])
out["list"] = buf.getvalue().splitlines()
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:4])
for name in json.loads(sys.argv[1]):
    cfg = reduced(ARCHS[name])
    for key, spec in json.loads(sys.argv[2]).items():
        shape = ShapeSpec(*spec)
        if shape.kind == "train":
            cell = RS.train_cell(cfg, shape, mesh, TrainConfig(n_micro=4))
        elif shape.kind == "prefill":
            cell = RS.prefill_cell(cfg, shape, mesh)
        else:
            cell = RS.decode_cell(cfg, shape, mesh)
        with mesh:
            compiled = jax.jit(cell.fn, in_shardings=cell.in_shardings).lower(
                *cell.args).compile()
        out["cells"][f"{name}/{key}"] = analyze(compiled).flops
print("RESULT " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference():
    """The reference's ``_active_params``, ``--list`` lines and reduced
    cells' per-partition FLOPs, from a subprocess."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    shapes = {k: (s.name, s.seq_len, s.global_batch, s.kind) for k, s in REDUCED.items()}
    p = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(REDUCED_ARCHS),
                        json.dumps(shapes)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_active_params_equal_the_reference(arch, reference):
    assert TD._active_params(arch) == reference["active"][arch]


def test_list_prints_the_reference_lines(reference):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert TD.main(["--list"]) == 0
    assert buf.getvalue().splitlines() == reference["list"]
    assert len(reference["list"]) == 40


def _reduced_cell(name: str, key: str, mesh):
    cfg, shape = reduced(ARCHS[name]), REDUCED[key]
    if shape.kind == "train":
        return TS.train_cell(cfg, shape, mesh, TrainConfig(n_micro=4), device="cpu")
    if shape.kind == "prefill":
        return TS.prefill_cell(cfg, shape, mesh, device="cpu")
    return TS.decode_cell(cfg, shape, mesh, device="cpu")


def _counted_gap(rec, cfg, key: str, dp: int, M: int) -> float:
    """The port's per-rank FLOPs less the reference's per-partition FLOPs,
    counted from the reduced cell ``key`` on a (dp, M) mesh (see the module
    docstring).  Zero for prefill and the exact decode."""
    shape = REDUCED[key]
    B, S, H, Dh = shape.global_batch, shape.seq_len, cfg.n_heads, cfg.head_dim
    n_attn = cfg.n_superblocks * sum(k.startswith("attn") for k in cfg.pattern)
    if key == "train":
        # each loss chunk's logits twice (the forward, its recompute), the
        # head's (…, V) products; one QKᵀ a chunk and block, S·S a row and head
        logits = sum(ev.flops for ev in rec.ops
                     if ev.name == "mm" and ev.result.endswith(f",{cfg.vocab_size}]"))
        return logits / 2 - 2 * (B // dp) * (H // M) * S * S * Dh * n_attn
    if key == "sketched":
        whole = 2 * (2 * B * H * cfg.sketch_attn.d_slots * Dh) * n_attn
        return whole - whole / (dp * M)
    return 0.0


def test_reduced_cells_per_rank_flops_match_the_reference(reference):
    from repro_torch.sharding import make_mesh

    got = {}
    with fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        for name in REDUCED_ARCHS:
            for key in REDUCED:
                cell = _reduced_cell(name, key, mesh)
                with mesh:
                    rec = record_rank(cell.fn, *cell.args, fake_mode=cell.fake_mode,
                                      device="cpu")
                got[f"{name}/{key}"] = (analyze(rec).flops,
                                        _counted_gap(rec, reduced(ARCHS[name]), key, 2, 2))
    assert set(got) == set(reference["cells"])
    for cell, want in reference["cells"].items():
        flops, gap = got[cell]
        assert flops == want + gap, (cell, flops, want, gap)
        assert (gap > 0) == cell.endswith(("/train", "/sketched")), (cell, gap)


def _non_view(rec) -> list:
    return [ev.name for ev in rec.ops if not ev.view]


def test_one_rank_dry_run_is_the_real_program():
    import dataclasses

    from repro_torch.core.sketched_attention import decode_slot_table
    from repro_torch.models.model import init_cache, init_params, prefill_with_cache
    from repro_torch.sharding import make_mesh
    from repro_torch.train.step import init_train_state

    cfg = dataclasses.replace(reduced(ARCHS["stablelm-3b"]), n_layers=2, n_superblocks=2)
    tc = TrainConfig(n_micro=1, remat="full")
    B, S, L = 2, 32, 24
    f32 = torch.float32
    params = init_params(0, cfg, device="cpu", dtype=f32)
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)
    lab = torch.randint(0, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)
    sa = cfg.sketch_attn
    cache = init_cache(cfg, 1, L + 1, use_sketch=True, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (1, L), generator=g, dtype=torch.int32)
    _, cache = prefill_with_cache(params, prompt, cfg, cache,
                                  slot_table=decode_slot_table(0, L, sa.d_slots, sa.m_r))
    with fake_group(1):
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        train = TS.train_cell(cfg, ShapeSpec("train", S, B, "train"), mesh, tc,
                              device="cpu", dtype=f32)
        decode = TS.decode_cell(cfg, ShapeSpec("decode", L + 1, 1, "decode"), mesh,
                                sketch=True, device="cpu", dtype=f32)
        with mesh:
            dry = [record_rank(c.fn, *c.args, fake_mode=c.fake_mode, device="cpu")
                   for c in (train, decode)]
    real = [record(train.fn, init_train_state(params, tc), tok, lab, train.args[3]),
            record(decode.fn, params, cache, torch.tensor([5], dtype=torch.int32),
                   *decode.args[3:])]
    for r, d in zip(real, dry):
        assert _non_view(d) == _non_view(r)
        assert d.flops == r.flops > 0
        assert d.routes == r.routes
    assert dry[1].routes == ["landmark_attend"] * cfg.n_layers


def test_landmark_attend_on_fake_cuda_tensors():
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from repro_torch.kernels.landmark_attention import kernel as K
    from repro_torch.kernels.landmark_attention import ops, ref

    P, S, L, Dh = 8, 4, 1024, 64
    fm = FakeTensorMode()
    with fm:
        q = torch.empty(P, S, Dh, device="cuda")
        kt = torch.empty(P, L, Dh, device="cuda")
        M = torch.empty(P, L, Dh, device="cuda")
        bias = torch.empty(P, L, device="cuda")
    launches = K.landmark_attention.launches
    rec = record_rank(ops.landmark_attend, q, kt, M, bias, fake_mode=fm, device="cuda")
    out = rec.result
    assert isinstance(out, FakeTensor) and out.device.type == "cuda"
    assert (tuple(out.shape), out.dtype) == ((P, S, Dh), torch.float32)
    assert rec.routes == ["landmark_attend"]
    assert K.landmark_attention.launches == launches
    (ev,) = rec.ops
    assert (ev.namespace, ev.name) == ("repro_torch", "landmark_attention")
    assert ev.flops == 2 * P * S * L * Dh + 2 * P * S * L * Dh
    assert ev.nbytes == 4 * (2 * P * S * Dh + 2 * P * L * Dh + P * L)   # q, out, kt, M, bias
    # a real CPU tensor still takes the plain version
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(s, generator=g) for s in ((P, S, Dh), (P, L, Dh), (P, L, Dh), (P, L))]
    assert torch.equal(ops.landmark_attend(*args), ref.landmark_attention_ref(*args))


# the digests of init_params(0, reduced(cfg), device="cpu") from before the
# init was made traceable (the same bits)
DIGESTS = {
    "stablelm-3b": "d8917eab66067651c479b4ca7a174894d8f719f980ad31ac879ce3918ae4dc45",
    "moonshot-v1-16b-a3b": "5345d70a093e8aaa226f9549e83ae2a771b1bb966d8aecd14a6d3622e062a9af",
    "zamba2-7b": "f4b804dd4f992e44d3f38e92caf1983d09d6553c241157e84f12e47f08fb2ac6",
    "xlstm-125m": "49f052b02eeb2e1c9d7864ce774ec705f18ec1e72c494d1887cef7c8cf1a863b",
}


@pytest.mark.parametrize("arch", list(DIGESTS))
def test_init_params_bits_are_unchanged(arch):
    from repro_torch.models.model import init_params

    h = hashlib.sha256()
    for t in tree_leaves(init_params(0, reduced(ARCHS[arch]), device="cpu")):
        h.update(str((tuple(t.shape), t.dtype)).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == DIGESTS[arch]


def test_fan_in_std_is_pytorchs_float32_root():
    from repro_torch.models.common import _fan_in_std

    for n in (1, 64, 267, 999, 2560, 4096, 14336, 262144):
        assert _fan_in_std(n) == 1.0 / torch.sqrt(torch.tensor(n, dtype=torch.float32)).item()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_abstract_traces_at_full_size(arch):
    from torch._subclasses.fake_tensor import FakeTensor

    from repro_torch.models.model import param_count

    p = TS.params_abstract(ARCHS[arch], device="cpu")
    leaves = tree_leaves(p)
    assert leaves and all(isinstance(x, FakeTensor) for x in leaves)
    assert param_count(p) >= TD._active_params(arch) > 0


def test_main_runs_a_cell_on_both_meshes(tmp_path):
    out = tmp_path / "dry.jsonl"
    assert TD.main(["--arch", "xlstm-125m", "--shape", "decode_32k", "--mesh", "both",
                    "--device", "cpu", "--out", str(out)]) == 0
    assert not torch.distributed.is_initialized()
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    keys = {"arch", "shape", "mesh", "ok", "lower_s", "compile_s", "model_flops_per_chip",
            "useful_fraction", "flops", "hbm_bytes", "coll_bytes", "coll_detail",
            "peak_mem_bytes", "xla_flops", "xla_bytes", "t_compute", "t_memory",
            "t_collective", "dominant", "roofline_fraction", "hardware",
            "hbm_capacity_bytes", "fits_hbm"}
    for r in recs:
        assert keys <= set(r) and r["ok"] and r["fits_hbm"]
        assert r["hardware"] == "NVIDIA H100 80GB HBM3, 700.00 W"
        assert 0 < r["peak_mem_bytes"] <= r["hbm_capacity_bytes"] == 80e9
        assert r["flops"] > 0 and r["hbm_bytes"] > 0
    # the 2 × 16 × 16 mesh halves the data shard: fewer bytes a rank
    assert recs[1]["peak_mem_bytes"] < recs[0]["peak_mem_bytes"]
