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
  reference's per-partition FLOPs exactly, and so do those of a sketched
  decode step (each rank attends over its own slots and batch rows, the
  partials combined by their log-sum-exps).  Those of a training step equal
  the reference's plus the loss chunks' forward logits (``_counted_gap``:
  the compiled reference merges them with their recompute in the backward;
  the eager port computes both); the attention chunks recompute their
  scores in the backward, as the reference's ``jax.checkpoint`` does.  So
  do those of a reduced xlstm-125m training step, whose "dp_only" policy
  splits the batch over both axes: each rank's loss covers its own rows,
  in one microbatch and in four (each placed as the batch).  Reduced
  zamba2-7b's exact decode equals the reference's, its training step the
  reference's plus the logits and less four reductions of broadcast
  products in the SSD's backward that the compiled reference counts as
  dots (``_counted_gap``).
- None of those cells, nor the slot-split prefill, runs a DTensor op that
  DTensor of torch 2.11 refuses (``Recording.refused``).
- A sketched prefill into a cache split on its slots over both axes: the
  per-rank FLOPs equal the reference's compiled per-partition FLOPs, a
  quarter of the slot-wide products a rank.
- A default-policy training step in four microbatches at two depths: at
  the peak the float32 storages are parameter shards, no whole stacked
  gradient is held and the gathered weight gradients are at most one
  superblock's; the peak grows a superblock by at most one carry and the
  rank's shard of its state and gradients.
- A training step at gemma3-12b's vocabulary on the (2, 2) group holds,
  above its arguments, less than one chunk's float32 logits for the whole
  microbatch: the loss backward works on the rank's share.
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
import dataclasses
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
# decode and the sketched one (long_500k's name selects the sketch cache);
# "train-micro" is 16 rows in four microbatches under any policy
REDUCED = {"train": ShapeSpec("train_4k", 64, 8, "train"),
           "prefill": ShapeSpec("prefill_32k", 64, 4, "prefill"),
           "decode": ShapeSpec("decode_32k", 64, 4, "decode"),
           "sketched": ShapeSpec("long_500k", 64, 4, "decode"),
           "train-micro": ShapeSpec("train_4k", 64, 16, "train")}
REDUCED_ARCHS = ("stablelm-3b", "moonshot-v1-16b-a3b")
# every one of those cells but "train-micro", and training steps under
# "dp_only" (xlstm-125m: the batch split over both axes, so each rank's loss
# is its own rows'), in one microbatch as the dry run's cells and in four,
# each microbatch placed as the batch
REDUCED_CELLS = [(a, k) for a in REDUCED_ARCHS for k in REDUCED if k != "train-micro"] + [
    ("xlstm-125m", "train"), ("xlstm-125m", "train-micro"), ("zamba2-7b", "train"),
    ("zamba2-7b", "decode")]
# a sketched prefill of one attention layer into a cache split on its slots
# over both axes: (arch, batch, tokens, chunk)
PREFILL_SLOTS = ("stablelm-3b", 1, 48, 16)


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
shapes = json.loads(sys.argv[2])
for name, key in json.loads(sys.argv[1]):
    cfg = reduced(ARCHS[name])
    shape = ShapeSpec(*shapes[key])
    if shape.kind == "train":
        # one microbatch under "dp_only", as the dry run's cells, but in
        # "train-micro"
        n_micro = 1 if cfg.sharding_policy == "dp_only" and key == "train" else 4
        cell = RS.train_cell(cfg, shape, mesh, TrainConfig(n_micro=n_micro))
    elif shape.kind == "prefill":
        cell = RS.prefill_cell(cfg, shape, mesh)
    else:
        cell = RS.decode_cell(cfg, shape, mesh)
    with mesh:
        compiled = jax.jit(cell.fn, in_shardings=cell.in_shardings).lower(
            *cell.args).compile()
    out["cells"][f"{name}/{key}"] = analyze(compiled).flops
# a sketched prefill (one attention layer) into a cache whose slots are split
# over both axes, and the same on one device
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.sketched_attention import SketchCache, decode_slot_table
from repro.models import attention as RA
from repro.models.common import rope_table
name, B, L, c = json.loads(sys.argv[3])
cfg = reduced(ARCHS[name])
D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
table = decode_slot_table(jax.random.PRNGKey(0), L, cfg.sketch_attn.d_slots, cfg.sketch_attn.m_r)
sin, cos = rope_table(jax.numpy.arange(L), Dh, cfg.rope_theta)
z = np.zeros
p = {"wq": z((D, H * Dh), np.float32), "wk": z((D, Hkv * Dh), np.float32),
     "wv": z((D, Hkv * Dh), np.float32), "wo": z((H * Dh, D), np.float32)}
args = (p, z((B, L, D), np.float32), RA.init_attn_sketch_cache(cfg, B, jax.numpy.float32))


def prefill(p, h, cache):
    return RA.attn_prefill_sketched(p, h, cache, cfg, sin, cos, table, chunk=c)


out["prefill_slots"] = {"one": analyze(jax.jit(prefill).lower(*args).compile()).flops}
rep, slots = NamedSharding(mesh, P()), P(None, None, ("data", "model"))
split = SketchCache(*(NamedSharding(mesh, P(*slots, None)),) * 2, NamedSharding(mesh, slots))
with mesh:
    out["prefill_slots"]["split"] = analyze(jax.jit(prefill, in_shardings=(
        {k: rep for k in p}, rep, split)).lower(*args).compile()).flops
print("RESULT " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference():
    """The reference's ``_active_params``, ``--list`` lines and reduced
    cells' per-partition FLOPs, from a subprocess."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    shapes = {k: (s.name, s.seq_len, s.global_batch, s.kind) for k, s in REDUCED.items()}
    p = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(REDUCED_CELLS),
                        json.dumps(shapes), json.dumps(PREFILL_SLOTS)], env=env,
                       capture_output=True, text=True, timeout=600)
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
        n_micro = 1 if cfg.sharding_policy == "dp_only" and key == "train" else 4
        return TS.train_cell(cfg, shape, mesh, TrainConfig(n_micro=n_micro), device="cpu")
    if shape.kind == "prefill":
        return TS.prefill_cell(cfg, shape, mesh, device="cpu")
    return TS.decode_cell(cfg, shape, mesh, device="cpu")


def _counted_gap(rec, cfg, key: str) -> float:
    """The port's per-rank FLOPs less the reference's per-partition FLOPs,
    counted from the reduced cell ``key`` (see the module docstring): in
    training the loss chunks' forward logits, less, for each Mamba-2 layer
    and microbatch, the reductions of broadcast products in the backward of
    the SSD's three-operand einsums that the compiled reference takes as
    dots at this size and the eager port as multiplies and sums (over P,
    over the rank's heads twice, over N: 2·B·c·Q·H·(P + Q + 2N), B the
    rank's rows, c chunks of Q positions, H the rank's heads); zero
    elsewhere."""
    shape = REDUCED[key]
    if shape.kind != "train":
        return 0.0
    # each loss chunk's logits twice (the forward, its recompute), the
    # head's (…, V) products
    logits = sum(ev.flops for ev in rec.ops
                 if ev.name == "mm" and ev.result.endswith(f",{cfg.vocab_size}]"))
    layers = cfg.pattern.count("mamba2") * cfg.n_superblocks
    if not layers:
        return logits / 2
    s = cfg.ssm
    n_micro = 1 if cfg.sharding_policy == "dp_only" and key == "train" else 4
    B, Q = shape.global_batch // n_micro // 2, min(s.chunk, shape.seq_len)
    H = s.expand * cfg.d_model // s.head_dim // 2
    ssd = 2 * B * (shape.seq_len // Q) * Q * H * (s.head_dim + Q + 2 * s.d_state)
    return logits / 2 - layers * n_micro * ssd


@pytest.fixture(scope="module")
def reduced_recordings() -> dict:
    """Rank 0's recording of every ``REDUCED_CELLS`` cell on the (2, 2)
    group, by "arch/key"."""
    from repro_torch.sharding import make_mesh

    recs = {}
    with fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        for name, key in REDUCED_CELLS:
            cell = _reduced_cell(name, key, mesh)
            with mesh:
                recs[f"{name}/{key}"] = record_rank(cell.fn, *cell.args,
                                                    fake_mode=cell.fake_mode, device="cpu")
    return recs


def test_reduced_cells_per_rank_flops_match_the_reference(reference, reduced_recordings):
    got = {}
    for name, key in REDUCED_CELLS:
        rec = reduced_recordings[f"{name}/{key}"]
        got[f"{name}/{key}"] = (analyze(rec).flops, _counted_gap(rec, reduced(ARCHS[name]), key))
    assert set(got) == set(reference["cells"])
    for cell, want in reference["cells"].items():
        flops, gap = got[cell]
        assert flops == want + gap, (cell, flops, want, gap)
        assert (gap > 0) == (REDUCED[cell.split("/")[1]].kind == "train"), (cell, gap)


def test_reduced_cells_run_no_op_that_torch_2_11_refuses(reduced_recordings):
    """Every reduced cell and the slot-split sketched prefill run no DTensor
    op that DTensor of torch 2.11 refuses (``Recording.refused``), which
    later versions run: a view that flattens a split dimension behind the
    first of the flattened ones (torch 2.11: "RuntimeError: ('Attempted to
    flatten multiple dimensions, with dimension 1 being sharded. ', …)",
    then "Sharding propagation failed for aten.view.default(…)"; torch
    2.13 places the result ``_StridedShard``), an op on such a placement,
    and a ``constant_pad_nd`` of a DTensor (torch 2.11's rule raises
    ``IndexError``).  The exact decode with its positions split on "model"
    and zamba2-7b's Mamba-2 conv and SSD ran such ops before they ran on
    each rank's shards."""
    refused = {cell: [(r.name, r.operands, r.results) for r in rec.refused[:3]]
               for cell, rec in reduced_recordings.items() if rec.refused}
    assert set(reduced_recordings) == {f"{a}/{k}" for a, k in REDUCED_CELLS}
    assert not refused, refused
    rec, _ = _slot_split_prefill()
    assert rec.refused == [], rec.refused[:3]


def test_training_on_a_mesh_holds_a_rank_share_of_the_loss_logits():
    from repro_torch.sharding import make_mesh

    # gemma3-12b's vocabulary (the logits dominate every other buffer)
    cfg = dataclasses.replace(reduced(ARCHS["gemma3-12b"]), vocab_size=262144)
    B, S, n_micro = 8, 512, 2
    with fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        cell = TS.train_cell(cfg, ShapeSpec("train_4k", S, B, "train"), mesh,
                             TrainConfig(n_micro=n_micro), device="cpu")
        with mesh:
            rec = record_rank(cell.fn, *cell.args, fake_mode=cell.fake_mode, device="cpu")
    # one chunk's float32 logits at a data rank's share of a microbatch; the
    # whole microbatch's are twice that
    buf = B // n_micro // 2 * S * cfg.vocab_size * 4
    rise = rec.peak_bytes - rec.arg_bytes
    assert rise < 2 * buf, (rise / buf, rec.peak_by_op)


def test_slot_split_sketched_prefill_computes_a_rank_share_of_the_slot_products(reference):
    """A sketched prefill (``PREFILL_SLOTS``: reduced stablelm-3b's attention,
    float32, 48 tokens in chunks of 16) into a cache whose slots are split
    over ("data", "model") on the (2, 2) group: rank 0's FLOPs equal the
    reference's compiled ``attn_prefill_sketched`` per partition, jitted
    with the cache placed by that spec (its compile does not gather the
    slots), and one process's equal the reference's on one device.  Both
    are one process's less 3/4 of the slot-wide products, each chunk's
    2·B·H·c·(2·d·Dh + 2·c·d) (q·k_sum, A·w, pn·wᵀ and pn·v_sum, d =
    d_slots), counted from the shapes: every rank computes the projections
    and the chunk's (c, c) scores whole, and the slot-wide products on its
    d/4 slots."""
    name, B, L, c = PREFILL_SLOTS
    cfg = reduced(ARCHS[name])
    sa, H, Dh = cfg.sketch_attn, cfg.n_heads, cfg.head_dim
    rec, one = _slot_split_prefill()
    _, new = rec.result
    assert [x.to_local().shape[2] for x in new] == [sa.d_slots // 4] * 3

    def slot_wide(d):
        return sum(2 * B * H * n * (2 * d * Dh + 2 * n * d)
                   for n in (min(c, L - t0) for t0 in range(0, L, c)))

    want = reference["prefill_slots"]
    assert one == want["one"]
    assert rec.flops == want["split"] == one - slot_wide(sa.d_slots) + slot_wide(
        sa.d_slots // 4), (rec.flops, want, slot_wide(sa.d_slots))


def _slot_split_prefill():
    """``PREFILL_SLOTS``' sketched prefill of one attention layer into a
    cache split on its slots over both axes, recorded as rank 0 of the
    (2, 2) group, and one process's FLOPs: (the recording, the FLOPs)."""
    from repro_torch.analysis.trace import record
    from repro_torch.core.sketched_attention import decode_slot_table
    from repro_torch.models import attention as att
    from repro_torch.models.common import rope_table
    from repro_torch.models.model import init_params
    from repro_torch.sharding import make_mesh

    name, B, L, c = PREFILL_SLOTS
    cfg = reduced(ARCHS[name])
    sa, Dh = cfg.sketch_attn, cfg.head_dim
    table = decode_slot_table(0, L, sa.d_slots, sa.m_r)
    f32 = torch.float32

    def prefill(p, h, cache):
        sin, cos = rope_table(torch.arange(L, device=h.device), Dh, cfg.rope_theta)
        return att.attn_prefill_sketched(p, h, cache, cfg, sin, cos, table, chunk=c)

    p = {k: v[0] for k, v in init_params(0, cfg, device="cpu", dtype=f32)["blocks"]["pos0"][
        "attn"].items()}
    h = torch.randn((B, L, cfg.d_model), generator=torch.Generator().manual_seed(0))
    one = record(prefill, p, h, att.init_attn_sketch_cache(cfg, B, f32, device="cpu")).flops
    fm = TS._fake_mode()
    with fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        with fm:
            pf = {k: torch.empty_like(v) for k, v in p.items()}
            hf = torch.empty_like(h)
            cache = att.init_attn_sketch_cache(cfg, B, f32, device="cpu")
        cache = type(cache)(*(TS._place(x, mesh, (None, None, ("data", "model"), None)[:x.ndim],
                                        fm) for x in cache))
        with mesh:
            rec = record_rank(prefill, pf, hf, cache, fake_mode=fm, device="cpu")
    return rec, one


def _train_peak(cfg, n_sb: int):
    """A default-policy training step of ``cfg`` cut to ``n_sb`` superblocks,
    8 rows of 16 tokens in four microbatches, recorded on the (2, 2) group:
    (the recording, the cell's parameters)."""
    from repro_torch.sharding import make_mesh

    cfg = dataclasses.replace(cfg, n_superblocks=n_sb, n_layers=n_sb * len(cfg.pattern))
    with fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        cell = TS.train_cell(cfg, ShapeSpec("train_4k", 16, 8, "train"), mesh,
                             TrainConfig(n_micro=4), device="cpu")
        with mesh:
            rec = record_rank(cell.fn, *cell.args, fake_mode=cell.fake_mode, device="cpu")
    return rec, cell.args[0].params


def test_microbatch_gradients_accumulate_on_the_rank_shards():
    """The microbatches' gradients are summed on each rank's shard of the
    parameters, as the reference's scan keeps its float32 carry, and each
    superblock's gathered (or partial) weight gradients die with its
    backward.  A wide, shallow bfloat16 stablelm-3b (d_model 512, the
    weights dominate) at 2 and 4 superblocks: at the peak no float32
    storage is larger than the largest parameter shard in float32, no
    storage has a stacked parameter's whole shape, and the storages with a
    superblock weight's whole shape hold at most one superblock's weights;
    each added superblock raises the peak by at most one carry (the
    superblock's saved input, a data rank's microbatch rows) and the rank's
    shard of its state (bfloat16 parameters, float32 m, v and master) and
    gradients (the bfloat16 gradient, the float32 sum and its addend)."""
    from repro_torch.sharding import is_dtensor

    cfg = reduced(ARCHS["stablelm-3b"]).scaled(d_model=512, n_heads=8, n_kv_heads=8,
                                              head_dim=64, d_ff=1024)
    peaks = {}
    for n_sb in (2, 4):
        rec, params = _train_peak(cfg, n_sb)
        peaks[n_sb] = rec.peak_bytes
        leaves = tree_leaves(params)
        assert all(is_dtensor(x) for x in leaves)
        shard_f32 = max(x.to_local().numel() for x in leaves) * 4
        split = [x for x in tree_leaves(params["blocks"]) if x.to_local().numel() < x.numel()]
        stacked = {tuple(x.shape) for x in split}
        whole = {tuple(x.shape[1:]) for x in split}
        sb_bytes = sum(x[0].numel() * x.element_size() for x in split)
        f32 = sorted((b, op, sh) for b, op, sh, dt in rec.peak_storages if dt == torch.float32)
        assert f32[-1][0] <= shard_f32, (n_sb, f32[-3:])
        assert not [st for st in rec.peak_storages if st[2] in stacked], n_sb
        gathered = [st for st in rec.peak_storages if st[2] in whole]
        assert sum(st[0] for st in gathered) <= sb_bytes, (n_sb, gathered, sb_bytes)
    # per added superblock: one carry (a data rank's rows of a microbatch,
    # 8 / 4 / 2 of them) and, a parameter of the rank's shard of one
    # superblock, 2 + 12 bytes of state and 2 + 4 + 4 of gradients
    carry = 8 // 4 // 2 * 16 * cfg.d_model * 2
    per_sb = sum(x.to_local().numel() for x in tree_leaves(params["blocks"])) // 4
    assert peaks[4] - peaks[2] <= 2 * (carry + 24 * per_sb), (peaks, carry, per_sb)


def _non_view(rec) -> list:
    return [ev.name for ev in rec.ops if not ev.view]


def test_one_rank_dry_run_is_the_real_program():
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
