#!/usr/bin/env python3
"""Which collectives gloo carries for CUDA tensors on this machine.

    python3 scripts/gloo_cuda_probe.py          # CUDA tensors on cuda:0 (CPU without a card)

Path (s2) of ``chip_smoke.py`` runs four gloo ranks that share one card
(NCCL refuses two ranks on one device).  This script starts four gloo ranks
on a ``FileStore`` for each collective in turn, each rank with a time
limit, runs the one collective on tensors on cuda:0 (on the CPU where no
card exists), and prints a line a collective — ``ok`` with rank 0's result,
or the ranks' exit codes (-11: SIGSEGV) — then one JSON object of all of
them.  The collectives: the c10d calls (``all_reduce`` in float32 and
bfloat16, ``broadcast``, ``all_gather`` into a list,
``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``), the functional ones DTensor runs
(``_functional_collectives.all_gather_tensor`` on the world group and on a
subgroup, ``reduce_scatter_tensor``, ``all_to_all_single``,
``all_reduce``), and DTensor's redistributes on a 1-D mesh of 4 and a
(2, 2) mesh.  It exits 0 whatever the collectives do.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from datetime import timedelta

WORLD = 4
LIMIT = 60          # seconds a spawn of four ranks may take
OPS = ("all_reduce", "all_reduce_bf16", "broadcast", "all_gather_list",
       "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
       "fc_all_gather", "fc_all_gather_subgroup", "fc_reduce_scatter", "fc_all_to_all",
       "fc_all_reduce", "dtensor_shard_to_replicate_1d", "dtensor_shard_to_replicate_2d",
       "dtensor_partial_to_shard_2d", "dtensor_partial_to_replicate_2d")


def run_op(op: str, rank: int, dev: str):
    """The result of ``op`` on this rank (a tensor)."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc

    x = torch.full((8,), float(rank + 1), device=dev)

    def done(t):
        return t.wait() if hasattr(t, "wait") else t

    if op == "all_reduce":
        dist.all_reduce(x)
        return x
    if op == "all_reduce_bf16":
        y = x.bfloat16()
        dist.all_reduce(y)
        return y.float()
    if op == "broadcast":
        dist.broadcast(x, 0)
        return x
    if op == "all_gather_list":
        out = [torch.empty_like(x) for _ in range(WORLD)]
        dist.all_gather(out, x)
        return torch.cat(out)
    if op == "all_gather_into_tensor":
        out = torch.empty(8 * WORLD, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out
    if op == "reduce_scatter_tensor":
        out = torch.empty(8 // WORLD, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return out
    if op == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x + torch.arange(8.0, device=dev))
        return out
    if op == "fc_all_gather":
        return done(fc.all_gather_tensor(x, 0, dist.group.WORLD))
    if op == "fc_all_gather_subgroup":
        groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        return done(fc.all_gather_tensor(x, 0, groups[rank // 2]))
    if op == "fc_reduce_scatter":
        return done(fc.reduce_scatter_tensor(x, "sum", 0, dist.group.WORLD))
    if op == "fc_all_to_all":
        return done(fc.all_to_all_single(x + torch.arange(8.0, device=dev), None, None,
                                         dist.group.WORLD))
    if op == "fc_all_reduce":
        return done(fc.all_reduce(x, "sum", dist.group.WORLD))
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dtype = torch.device(dev).type
    if op == "dtensor_shard_to_replicate_1d":
        mesh = DeviceMesh(dtype, torch.arange(WORLD), mesh_dim_names=("data",))
        return DTensor.from_local(x, mesh, [Shard(0)]).redistribute(
            mesh, [Replicate()]).to_local()
    mesh = DeviceMesh(dtype, torch.arange(WORLD).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    if op == "dtensor_shard_to_replicate_2d":
        t = DTensor.from_local(x, mesh, [Shard(0), Shard(0)])
        return t.redistribute(mesh, [Replicate(), Replicate()]).to_local()
    if op == "dtensor_partial_to_shard_2d":
        t = DTensor.from_local(x, mesh, [Partial(), Partial()])
        return t.redistribute(mesh, [Shard(0), Shard(0)]).to_local()
    if op == "dtensor_partial_to_replicate_2d":
        t = DTensor.from_local(x, mesh, [Partial(), Replicate()])
        return t.redistribute(mesh, [Replicate(), Replicate()]).to_local()
    raise ValueError(op)


def rank_main(rank: int, store: str, op: str, dev: str) -> int:
    """One rank: join the gloo group, run ``op``, print its result."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD), rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=30))
    try:
        r = run_op(op, rank, dev)
        if dev.startswith("cuda"):
            torch.cuda.synchronize()
        print("RESULT", json.dumps(r.cpu().tolist()), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def main() -> int:
    """Spawn four ranks for each collective; print one line each and the
    summary."""
    import torch

    dev = "cuda:0" if torch.cuda.is_available() else "cpu"
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; tensors on {dev}", flush=True)
    summary = {}
    for op in OPS:
        with tempfile.TemporaryDirectory() as tmp:
            procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                                       f"{tmp}/store", op, dev], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for r in range(WORLD)]
            logs = []
            for p in procs:
                try:
                    logs.append(p.communicate(timeout=LIMIT)[0])
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                    logs.append(p.communicate()[0])
        codes = [p.returncode for p in procs]
        if all(c == 0 for c in codes):
            result = [ln[7:] for ln in logs[0].splitlines() if ln.startswith("RESULT ")]
            summary[op] = "ok"
            print(f"{op}: ok, rank 0 {result[0] if result else '?'}", flush=True)
        else:
            summary[op] = f"exit codes {codes}"
            print(f"{op}: exit codes {codes}", flush=True)
    print(json.dumps({"device": dev, "torch": torch.__version__, "collectives": summary}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]))
    sys.exit(main())
