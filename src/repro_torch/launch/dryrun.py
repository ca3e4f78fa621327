"""Multi-pod dry run in one process: trace every (architecture × input-shape)
cell on the production meshes, one rank's program at a time, and extract
its roofline terms (ported from ``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-110b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out dry.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu   # no card

The reference forces 512 host devices and compiles each cell for them.
The port starts torch.distributed's ``"fake"`` process group (every
collective a no-op) with 256 or 512 ranks in this one process, builds the
production mesh over it (``launch.mesh.make_production_mesh``), and runs
the cell's step once on fake tensors (``launch.specs``: no data, nothing
allocated) as rank 0, recording rank 0's program
(``analysis.trace.record_rank``) for ``launch.analysis.analyze``.  Rank 0
holds the largest shard of every unevenly split dimension, so its peak is
the mesh's.

Success proves the distribution config is coherent: a sharding DTensor
refuses, a collective the group lacks and a data-dependent read (a value
the host would wait for) all fail the cell loudly, as a sharding mismatch
or an unsupported collective fails the reference's compile.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from repro_torch._util import tree_leaves
from repro_torch.analysis.trace import record_rank
from repro_torch.configs import ARCHS
from repro_torch.configs.base import SHAPES
from repro_torch.launch.analysis import analyze, model_flops
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import cut, make_cell, params_abstract
from repro_torch.train.step import TrainConfig


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, tc: TrainConfig | None = None,
             verbose: bool = True, device="cuda", superblocks: int | None = None) -> dict:
    """Trace one cell as rank 0 of the production mesh (the process group
    must hold its 256 or 512 ranks) and return its record; ``superblocks``
    cuts the config's depth (its widths kept)."""
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    t0 = time.perf_counter()
    cell = make_cell(arch, shape_name, mesh, tc=tc, device=device, superblocks=superblocks)
    t_lower = time.perf_counter() - t0
    with mesh:
        recording = record_rank(cell.fn, *cell.args, fake_mode=cell.fake_mode, device=device)
    t_compile = time.perf_counter() - t0 - t_lower

    roof = analyze(recording)
    hw = roof.hw
    shape = SHAPES[shape_name]
    n_active = _active_params(arch, superblocks)
    n_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    n_chips = 512 if multi_pod else 256
    mflops = model_flops(n_active, n_tokens, shape.kind) / n_chips  # per chip
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "ok": True,
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "model_flops_per_chip": mflops,
        "useful_fraction": mflops / max(roof.flops, 1e-30),
        **roof.to_dict(),
        "hbm_capacity_bytes": hw.hbm_bytes,
        "fits_hbm": roof.peak_mem_bytes <= hw.hbm_bytes,
        "ops": len(recording.ops), "kernel_dispatches": len(recording.routes),
        "superblocks": superblocks or ARCHS[arch].n_superblocks,
        "peak_by_op": dict(sorted(recording.peak_by_op.items(), key=lambda kv: -kv[1])[:6]),
    }
    if verbose:
        print(f"[dryrun] {cell.label} mesh={rec['mesh']} device={device} "
              f"superblocks={rec['superblocks']} of {ARCHS[arch].n_superblocks}")
        print(f"  recorded: {rec['ops']} ops, {rec['kernel_dispatches']} kernel dispatches, "
              f"cell {t_lower:.2f} s, step {t_compile:.2f} s")
        print(f"  per rank: flops={roof.flops:.3e} hbm_bytes={roof.hbm_bytes:.3e} "
              f"coll_bytes={roof.coll_bytes:.3e} peak={roof.peak_mem_bytes / 1e9:.2f} GB "
              f"of {hw.hbm_bytes / 1e9:.0f} GB")
        print(f"  roofline ({hw.name}): t_comp={roof.t_compute*1e3:.2f}ms "
              f"t_mem={roof.t_memory*1e3:.2f}ms t_coll={roof.t_collective*1e3:.2f}ms "
              f"dominant={roof.dominant} frac={roof.compute_fraction():.3f} "
              f"useful={rec['useful_fraction']:.3f}")
        print(f"  collectives: {roof.coll_detail['count']}")
        print(f"  at the peak, GB by the op that made each storage: "
              f"{ {k: round(v / 1e9, 3) for k, v in rec['peak_by_op'].items()} }")
    return rec


_ACTIVE_CACHE: dict = {}


def _active_params(arch: str, superblocks: int | None = None) -> int:
    """Parameters a token uses (MoE: top_k of n_experts), from the fake
    parameters (of the config cut to ``superblocks``, where given)."""
    key = (arch, superblocks)
    if key not in _ACTIVE_CACHE:
        cfg = cut(ARCHS[arch], superblocks)
        sds = params_abstract(cfg, device="cpu")
        total = sum(x.numel() for x in tree_leaves(sds))
        _ACTIVE_CACHE[key] = _moe_active(cfg, sds, total)
    return _ACTIVE_CACHE[key]


def _moe_active(cfg, sds, total):
    if cfg.moe is None:
        return total
    inactive = 0
    for pos in sds["blocks"].values():
        ffn = pos.get("ffn", {})
        for n in ("wi_gate", "wi_up", "wo"):
            if n in ffn and ffn[n].ndim == 4:
                inactive += ffn[n].numel() * (1 - cfg.moe.top_k / cfg.moe.n_experts)
    return int(total - inactive)


def skip_reason(arch: str, shape_name: str) -> str | None:
    """Why a cell is skipped, or None: every assigned cell runs (long_500k
    uses the paper's AccumSketch cache on attention archs)."""
    return None


def start_fake_group(world_size: int) -> None:
    """Initialise the default process group as torch.distributed's
    ``"fake"`` backend with ``world_size`` ranks, this process rank 0:
    collectives do nothing, and a mesh of that many ranks comes up in one
    process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0,
                                         world_size=world_size)


def main(argv=None) -> int:
    """The command line: ``--list``, or the cells of ``--arch``/``--shape``
    (``--all``) on ``--mesh``; exit 1 if any cell failed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the device the fake tensors claim (cuda, or cpu without a card)")
    ap.add_argument("--superblocks", type=int, default=None,
                    help="cut each config to its first N superblocks (widths kept)")
    args = ap.parse_args(argv)

    if args.list:
        for a in ARCHS:
            for s in SHAPES:
                print(f"{a} {s}")
        return 0

    cells = []
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    if not (args.all or args.arch):
        ap.error("pass --arch/--shape or --all")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))

    started = not torch.distributed.is_initialized()
    if started:
        start_fake_group(512 if any(meshes) else 256)
    failures = 0
    try:
        for a, s, mp in cells:
            reason = skip_reason(a, s)
            if reason:
                print(f"[dryrun] SKIP {a}/{s}: {reason}")
                continue
            try:
                rec = run_cell(a, s, multi_pod=mp, device=args.device,
                               superblocks=args.superblocks)
            except Exception as e:
                failures += 1
                rec = {
                    "arch": a, "shape": s, "mesh": "2x16x16" if mp else "16x16",
                    "ok": False, "error": f"{type(e).__name__}: {e}",
                }
                print(f"[dryrun] FAIL {a}/{s} mesh={rec['mesh']}: {rec['error']}")
                traceback.print_exc()
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    finally:
        if started:
            torch.distributed.destroy_process_group()
    print(f"[dryrun] done; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
