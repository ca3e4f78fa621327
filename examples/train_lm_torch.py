"""End-to-end driver on the PyTorch port (``repro_torch``), as
``examples/train_lm.py``: train a small LM for a few hundred steps, with a
mid-run preemption and restart to demonstrate the fault-tolerance contract.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--arch gemma3-12b] \\
      [--device cpu] [--seed 0] [--compress]

The model is the same-family reduced config of the chosen architecture; the
data pipeline is the deterministic Markov synthetic stream (stateless in
``step``, so the post-restart token stream is bit-identical to an
uninterrupted run), and the loop runs under deterministic algorithms.  The
paper's technique appears twice: AccumAttention is available inside the
model for long contexts, and the sketched gradient compressor
(accumulation-of-sub-sampling over gradient coordinates) can be enabled
with --compress.
"""
import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from claims_torch import check_claims
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.model import init_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compress import CompressConfig
from repro_torch.train.loop import LoopConfig, run
from repro_torch.train.step import TrainConfig, init_train_state


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-12b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="assert the printed claims (exit non-zero if one fails)")
    args = ap.parse_args()
    # the loop's deterministic cuBLAS needs this before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = torch.device(args.device)

    cfg = reduced(get_config(args.arch))
    tc = TrainConfig(
        optimizer=AdamWConfig(lr_peak=3e-3, warmup_steps=20, total_steps=args.steps),
        compress=CompressConfig() if args.compress else None,
    )
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, seed=args.seed)
    ckpt_dir = tempfile.mkdtemp(prefix="train_lm_ckpt_")
    mid = args.steps // 2

    def init():
        return init_train_state(init_params(args.seed, cfg, device=dev), tc)

    try:
        # --- phase 1: run to the midpoint, checkpointing ------------------- #
        lc1 = LoopConfig(total_steps=mid, ckpt_dir=ckpt_dir, ckpt_every=25,
                         log_every=25)
        r1 = run(cfg, tc, dc, lc1, init_params_fn=init)
        print(f"[phase1] stopped at step {mid} (simulated preemption), "
              f"loss={r1.final_loss:.4f}")

        # --- phase 2: "restart" — fresh state, resumes from the checkpoint - #
        lc2 = LoopConfig(total_steps=args.steps, ckpt_dir=ckpt_dir, ckpt_every=50,
                         log_every=25)
        r2 = run(cfg, tc, dc, lc2, init_params_fn=init)
        assert r2.resumed_from == mid, (r2.resumed_from, mid)
        print(f"[phase2] resumed from {r2.resumed_from}, "
              f"final loss={r2.final_loss:.4f}")

        losses = r1.losses + r2.losses
        first = float(np.mean(losses[: len(losses) // 5]))
        last = float(np.mean(losses[-len(losses) // 5:]))
        print(f"[result] loss {first:.4f} → {last:.4f} "
              f"({'learning ✓' if last < first else 'NOT learning ✗'})")
        check_claims({f"resumed at step {mid}": r2.resumed_from == mid,
                      "the loss falls": last < first}, args.check)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
