"""Serving launcher: batched requests against exact or sketched (AccumSketch,
the paper's technique) caches, with weights drawn from a seed.

  python -m repro_torch.launch.serve --arch minitron-8b --sketch
  python -m repro_torch.launch.serve --arch minitron-8b --reduced --device cpu

Runs on the card unless ``--device cpu`` is given (run with ``src`` on
``PYTHONPATH``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._util import resolve_device, tree_leaves
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import init_params
from repro_torch.serve.engine import Engine, ServeConfig


def main(argv=None) -> int:
    """Parse the command line, serve one batch of random prompts, report."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--sketch", action="store_true",
                    help="AccumSketch-compressed cache (O(d_slots) memory, "
                    "context-length independent)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    params = init_params(args.seed, cfg, device=device)
    sc = ServeConfig(max_len=args.prompt_len + args.new_tokens, use_sketch=args.sketch,
                     temperature=args.temperature, seed=args.seed)
    eng = Engine(cfg, params, sc)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           dtype=np.int32)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out, cache = eng.generate(prompts, args.new_tokens)
    dt = time.perf_counter() - t0
    total = args.batch * args.new_tokens
    print(f"[serve] arch={cfg.name} device={device} sketch={args.sketch} "
          f"generated {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s with prefill)")
    print(f"[serve] sample continuation: {out[0][:16].tolist()}")
    cache_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(cache))
    print(f"[serve] cache bytes: {cache_bytes / 1e6:.2f} MB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
