"""Training launcher: a fault-tolerant run with weights from a seed and the
synthetic token stream (ported from ``repro.launch.train``).

  python -m repro_torch.launch.train --arch stablelm-3b --steps 200 --ckpt-dir CKPT
  python -m repro_torch.launch.train --arch stablelm-3b --reduced --device cpu --steps 4
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch stablelm-3b ...

Runs on the card unless ``--device cpu`` is given (run with ``src`` on
``PYTHONPATH``).  ``--mesh debug`` is the data mesh: one rank, or the ranks
``torchrun`` starts (each on ``cuda:LOCAL_RANK``), the parameters
replicated.  ``--mesh pod|multipod`` is the production 2-D mesh of 256 (or
512) ranks under ``torchrun`` (``make_production_mesh``): the parameters
drawn whole on each rank and placed by ``sharding.params_shardings``, the
AdamW state sharded as they are, the error feedback replicated, the batch
``batch_spec``-sharded.  Every process group the launcher makes has a
timeout, so a rank that dies fails the others instead of hanging them.  The
loop resumes from the newest checkpoint under ``--ckpt-dir``: running the
same command again after a kill is the restart drill.  The loop is
deterministic, so the launcher sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8``
unless the environment has it.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch import sharding as shlib
from repro_torch._util import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.core.distributed import TIMEOUT
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models.model import init_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compress import CompressConfig
from repro_torch.train.loop import LoopConfig, run
from repro_torch.train.step import TrainConfig, init_train_state


def main(argv=None) -> int:
    """Parse the command line, train, report."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the same-family smoke config (CPU-feasible)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress", action="store_true",
                    help="sketched gradient all-reduce compression (paper technique)")
    ap.add_argument("--mesh", choices=["debug", "pod", "multipod"], default="debug")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # cuBLAS reads this when CUDA starts; the deterministic loop needs it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    own_group = (int(os.environ.get("WORLD_SIZE", "1")) > 1
                 and not torch.distributed.is_initialized())
    if own_group:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
        torch.distributed.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                             timeout=TIMEOUT)
    mesh = None
    try:
        mesh = (make_debug_mesh(device=device) if args.mesh == "debug" else
                make_production_mesh(multi_pod=args.mesh == "multipod", device=device))
        tc = TrainConfig(
            optimizer=AdamWConfig(lr_peak=args.lr, total_steps=args.steps),
            n_micro=args.n_micro,
            compress=CompressConfig() if args.compress else None)
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch)
        lc = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                        ckpt_every=args.ckpt_every)

        def init():
            params = init_params(0, cfg, device=device)
            if isinstance(mesh, shlib.Mesh):
                params = shlib.shard_tree(params, mesh,
                                          shlib.params_shardings(mesh, params))
            return init_train_state(params, tc)

        report = run(cfg, tc, dc, lc, init_params_fn=init, mesh=mesh)
    finally:
        if mesh is not None:
            mesh.close()
        if own_group:
            torch.distributed.destroy_process_group()

    print(f"[train] arch={cfg.name} device={device} ranks={mesh.size}: ran "
          f"{report.steps_run} steps (resumed_from={report.resumed_from}) "
          f"final_loss={report.final_loss:.4f}")
    n = len(report.losses)
    if n >= 20:
        first = float(np.mean(report.losses[: n // 5]))
        last = float(np.mean(report.losses[-n // 5:]))
        print(f"[train] loss first-20%={first:.4f} last-20%={last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
