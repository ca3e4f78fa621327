"""One reduced cell on a (data 2, model 2) ``"fake"`` group, as the dry-run
tests record it: rank 0's FLOPs, HBM and collective bytes, non-view ops,
the peak of its live storages (and the arguments' share), the largest
storages then, and the DTensor ops that torch 2.11 refuses (``refused``:
name, operands and results, each op once, with its count).  A training
step by default; ``--kind`` prefill, decode (the exact cache) or sketched
(the sketched cache) records that step instead.  Fake tensors: nothing is
allocated, no time.

  PYTHONPATH=src python3 scripts/dryrun_reduced.py --arch qwen1.5-110b \\
      --scaled '{"n_heads": 6, "n_kv_heads": 3}' --n-micro 4
  PYTHONPATH=src python3 scripts/dryrun_reduced.py --arch stablelm-3b \\
      --scaled '{"d_model": 512, "n_heads": 8, "n_kv_heads": 8, "head_dim": 64, "d_ff": 1024}' \\
      --superblocks 4 --batch 8 --seq 16
  PYTHONPATH=src python3 scripts/dryrun_reduced.py --arch stablelm-3b --kind decode \\
      --batch 4 --seq 64

Run it with another tree's ``src`` on ``PYTHONPATH`` (an unpacked ``git
archive``) to compare two trees; it prints one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scaled", default="{}", help="JSON: ModelConfig.scaled's widths")
    ap.add_argument("--superblocks", type=int, default=None)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--n-micro", type=int, default=4)
    ap.add_argument("--kind", choices=("train", "prefill", "decode", "sketched"),
                    default="train")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.analysis.trace import record_rank
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.analysis import analyze
    from repro_torch.sharding import make_mesh
    from repro_torch.train.step import TrainConfig

    cfg = reduced(ARCHS[args.arch]).scaled(**json.loads(args.scaled))
    if args.superblocks:
        cfg = dataclasses.replace(cfg, n_superblocks=args.superblocks,
                                  n_layers=args.superblocks * len(cfg.pattern))
    dryrun.start_fake_group(4)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        if args.kind == "train":
            cell = specs.train_cell(cfg, ShapeSpec("train_4k", args.seq, args.batch, "train"),
                                    mesh, TrainConfig(n_micro=args.n_micro), device="cpu")
        elif args.kind == "prefill":
            cell = specs.prefill_cell(cfg, ShapeSpec("prefill_32k", args.seq, args.batch,
                                                     "prefill"), mesh, device="cpu")
        else:
            cell = specs.decode_cell(cfg, ShapeSpec("decode_32k", args.seq, args.batch, "decode"),
                                     mesh, sketch=args.kind == "sketched", device="cpu")
        with mesh:
            rec = record_rank(cell.fn, *cell.args, fake_mode=cell.fake_mode, device="cpu")
    finally:
        torch.distributed.destroy_process_group()
    roof = analyze(rec)
    largest = sorted(getattr(rec, "peak_storages", []), key=lambda s: -s[0])[:6]
    refused: dict = {}
    for r in getattr(rec, "refused", []):
        key = json.dumps([r.name, r.operands, r.results])
        refused[key] = refused.get(key, 0) + 1
    print(json.dumps({
        "arch": args.arch, "kind": args.kind, "superblocks": cfg.n_superblocks,
        "n_micro": args.n_micro,
        "flops": roof.flops, "hbm_bytes": roof.hbm_bytes, "coll_bytes": roof.coll_bytes,
        "non_view_ops": sum(not ev.view for ev in rec.ops),
        "peak_bytes": rec.peak_bytes, "arg_bytes": rec.arg_bytes,
        "peak_storages": [[b, op, list(shape), str(dt).split(".")[-1]]
                          for b, op, shape, dt in largest],
        "refused": [[n, *json.loads(k)] for k, n in refused.items()]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
