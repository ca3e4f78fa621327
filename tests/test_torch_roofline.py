"""The dry run's roofline layer in the port (``repro_torch.launch.analysis``,
``repro_torch.analysis.hlo`` and the rank recorder,
``repro_torch.analysis.trace.record_rank``), on the CPU.

The reference's cases hold on the port's functions (``shape_bytes`` of a
tuple, ``model_flops``, a roofline scored against an overridable profile,
here the H100's); its while-loop case (a dot and an all-reduce, ten trips)
holds on a Python loop, which eager mode runs trip by trip.  On the 16 × 16
``"fake"`` group, the sharded product (256, 4096) × (4096, 8192) is counted
at one rank's share, forward and backward, with its collectives, where a
``TorchDispatchMode`` sees the global shapes.  Each test that starts the
fake group destroys it.
"""
from __future__ import annotations

import contextlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.hardware import H100_SXM, HardwareModel  # noqa: E402
from repro_torch.analysis.hlo import DTYPE_BYTES, shape_bytes, shape_dims, type_str  # noqa: E402
from repro_torch.analysis.trace import record_rank  # noqa: E402
from repro_torch.launch.analysis import (  # noqa: E402
    HBM_BW,
    NVLINK_BW,
    PEAK_FLOPS,
    Roofline,
    analyze,
    compute_op,
    model_flops,
)
from repro_torch.launch.dryrun import start_fake_group  # noqa: E402


@contextlib.contextmanager
def fake_group(n: int):
    start_fake_group(n)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def test_shape_bytes_tuple():
    assert shape_bytes("(s32[], f32[8,8])") == 4 + 256
    assert shape_bytes("bf16[2,3]{1,0}") == 12


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32, torch.int64,
                                   torch.bool, torch.float16, torch.uint8])
def test_type_str_spells_the_reference_syntax(dtype):
    s = type_str((16, 4096), dtype)
    (name, dims), = shape_dims(s)
    assert dims == [16, 4096]
    assert shape_bytes(s) == 16 * 4096 * torch.empty((), dtype=dtype).element_size()
    assert DTYPE_BYTES[name] == torch.empty((), dtype=dtype).element_size()


def test_model_flops():
    assert model_flops(1000, 10, "train") == 6e4
    assert model_flops(1000, 10, "prefill") == 2e4


def test_roofline_uses_overridable_hardware():
    assert (PEAK_FLOPS, HBM_BW, NVLINK_BW) == (
        H100_SXM.peak_flops, H100_SXM.hbm_bw, H100_SXM.nvlink_bw)

    r = Roofline(flops=1e12, hbm_bytes=1e9, coll_bytes=9e8, coll_detail={},
                 peak_mem_bytes=0.0)
    assert r.t_compute == pytest.approx(1e12 / H100_SXM.peak_flops)
    assert r.t_memory == pytest.approx(1e9 / H100_SXM.hbm_bw)
    assert r.t_collective == pytest.approx(9e8 / H100_SXM.nvlink_bw)
    assert r.to_dict()["hardware"] == "NVIDIA H100 80GB HBM3, 700.00 W"

    slow = HardwareModel(name="half-speed", peak_flops=H100_SXM.peak_flops / 2)
    r2 = Roofline(flops=1e12, hbm_bytes=1e9, coll_bytes=0.0, coll_detail={},
                  peak_mem_bytes=0.0, hardware=slow)
    assert r2.t_compute == pytest.approx(2 * r.t_compute)
    assert r2.to_dict()["hardware"] == "half-speed"


def test_loop_trips_and_collective_factor():
    # the reference's while-loop case: a dot of 2·8·8·8 = 1024 FLOPs and an
    # all-reduce of 8·8·4 B = 256 B (ring factor 2), ten trips
    import torch.distributed._functional_collectives as funcol

    with fake_group(2):
        fm = fake_mode()
        with fm:
            x = torch.empty(8, 8)
            w = torch.empty(8, 8)

        def loop(x, w):
            for _ in range(10):
                x = funcol.all_reduce(x @ w, "sum", torch.distributed.group.WORLD)
            return x

        rec = record_rank(loop, x, w, fake_mode=fm, device="cpu")
    roof = analyze(rec)
    assert roof.flops == 1024 * 10
    assert roof.coll_bytes == 256 * 2 * 10
    assert roof.coll_detail["count"]["all-reduce"] == 10
    assert roof.coll_detail["bytes"]["all-reduce"] == 256 * 10


def test_sharded_product_counts_one_ranks_share():
    # (256, 4096) × (4096, 8192) with the rows on "data" and the columns on
    # "model" of the 16 × 16 mesh: each rank multiplies (16, 4096) by
    # (4096, 512), 2·16·4096·512 = 6.7e7 FLOPs, where the global product is
    # 1.72e10; the backward's two products are one rank's share too, and
    # each reduces its partial sums over the other axis
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    share = 2 * 16 * 4096 * 512
    with fake_group(256):
        mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
        fm = fake_mode()
        with fm:
            a = torch.empty(16, 4096, requires_grad=True)
            b = torch.empty(4096, 512, requires_grad=True)
            g = torch.empty(16, 512)
        A = DTensor.from_local(a, mesh, [Shard(0), Replicate()], run_check=False,
                               shape=(256, 4096), stride=(4096, 1))
        B = DTensor.from_local(b, mesh, [Replicate(), Shard(1)], run_check=False,
                               shape=(4096, 8192), stride=(8192, 1))
        G = DTensor.from_local(g, mesh, [Shard(0), Shard(1)], run_check=False,
                               shape=(256, 8192), stride=(8192, 1))

        def step(A, B, G):
            C = A @ B
            C.backward(G)
            return C

        fwd = record_rank(lambda A, B: A @ B, A, B, fake_mode=fm, device="cpu")
        both = record_rank(step, A, B, G, fake_mode=fm, device="cpu")
    assert fwd.flops == share == 67108864
    assert [ev.input_shapes for ev in fwd.ops if ev.flops] == [[(16, 4096), (4096, 512)]]
    assert fwd.result.to_local().shape == (16, 512)
    assert both.flops == 3 * share
    roof = analyze(both)
    # dA = dC Bᵀ: (16, 4096) float32 partial over "model"; dB = Aᵀ dC: (4096,
    # 512) float32 partial over "data"; each all-reduced, ring factor 2
    assert roof.coll_detail["count"] == {"all-reduce": 2}
    assert roof.coll_detail["bytes"]["all-reduce"] == 4 * (16 * 4096 + 4096 * 512)
    assert roof.coll_bytes == 2 * 4 * (16 * 4096 + 4096 * 512)


def test_dtensor_bookkeeping_and_the_programs_ops_are_told_apart(monkeypatch):
    # an op on no fake tensor is DTensor's bookkeeping where torch.distributed's
    # code is nearer on the stack than the program's (left out: here the
    # sharding propagation rebuilding the product's operands as metadata),
    # else the program's (recorded: this file's factory, run on a fake
    # tensor, and its host add); ops on the cell's fakes are recorded as they
    # come.  A change in either rule, or in where DTensor lives, shows here.
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.analysis import trace as TR

    callers, caller = [], TR._caller
    monkeypatch.setattr(TR, "_caller", lambda: callers.append(caller()) or callers[-1])
    with fake_group(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        fm = fake_mode()
        with fm:
            a, b = torch.empty(3, 8), torch.empty(8, 4)
        A = DTensor.from_local(a, mesh, [Shard(0), Replicate()], run_check=False,
                               shape=(5, 8), stride=(8, 1))
        B = DTensor.from_local(b, mesh, [Replicate(), Shard(1)], run_check=False,
                               shape=(8, 8), stride=(8, 1))

        def program(A, B, i):
            c = A.redistribute(mesh, [Replicate(), Replicate()]) @ B
            c = c.redistribute(mesh, [Shard(0), Shard(1)])
            return c.to_local().sum() + torch.zeros(4, 8).sum(), i + 1

        rec = record_rank(program, A, B, torch.tensor(3), fake_mode=fm, device="cpu")
    assert sorted(callers) == ["", ""] + ["torch.distributed.tensor._op_schema"] * 2
    assert [(ev.name, ev.result, ev.host) for ev in rec.ops if not ev.view] == [
        ("all_gather_into_tensor", "f32[6,8]", False),    # rank 0's 3 rows, padded
        ("_wrap_tensor_autograd", "f32[6,8]", False),
        ("mm", "f32[5,4]", False), ("clone", "f32[3,4]", False), ("sum", "f32[]", False),
        ("zeros", "f32[4,8]", False), ("sum", "f32[]", False),
        ("add", "f32[]", True), ("add", "s64[]", True)]
    assert rec.result[1] == 4


def test_peak_counts_live_storages_and_the_arguments():
    # arguments 1 MiB, a 4 MiB temporary freed before a 2 MiB result: the
    # peak is 5 MiB; a view allocates nothing and is no compute op; every
    # storage rounded up to the allocator's 512 bytes
    fm = fake_mode()
    with fm:
        x = torch.empty(256, 1024)            # 1 MiB

    def f(x):
        t = x.repeat(4, 1)                    # 4 MiB, freed below
        s = t.sum()
        del t
        y = x.repeat(2, 1).view(-1) + s       # 2 MiB (the repeat) then 2 MiB (the add)
        return y[:5]

    rec = record_rank(f, x, fake_mode=fm, device="cpu")
    MiB = 1 << 20
    assert rec.arg_bytes == MiB
    assert rec.peak_bytes == MiB + 4 * MiB + 512
    assert rec.peak_by_op == {"arguments": MiB, "repeat": 4 * MiB}
    views = [ev for ev in rec.ops if ev.view]
    assert {ev.name for ev in views} >= {"view", "slice"}
    assert not any(compute_op(ev) for ev in views)
    assert analyze(rec).peak_mem_bytes == rec.peak_bytes


def test_autograd_saved_tensors_stay_live_until_the_backward():
    # exp saves its result for the backward: the 1 MiB result stays live
    # after the caller drops it, until the backward has run
    fm = fake_mode()
    with fm:
        x = torch.empty(256, 1024, requires_grad=True)

    def f(x):
        y = x.exp()                           # 1 MiB, saved
        z = y.sum()
        del y
        z.backward()                          # grad of y (1 MiB) and of x (1 MiB)
        return z

    rec = record_rank(f, x, fake_mode=fm, device="cpu")
    MiB = 1 << 20
    assert rec.peak_bytes >= 3 * MiB
