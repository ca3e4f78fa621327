"""Long-context serving with the AccumSketch-compressed KV cache, on the
PyTorch port (``repro_torch``), as ``examples/long_context_serve.py``.

  PYTHONPATH=src python examples/long_context_serve_torch.py [--device cpu] [--seed 0]

Decodes the same prompts twice — once with the exact KV cache (memory grows
linearly with context) and once with the paper's sketched cache (fixed
d_slots landmark slots; memory independent of context length) — and reports
cache bytes and the agreement of the generated continuations.

This is the mechanism that makes the long_500k production shape feasible for
full-attention architectures: a 500k-token exact cache for qwen1.5-110b would
be ~10 GB/layer-group per request, while the sketched cache is a few MB.

Prefill is one batched pass (``Engine.prefill_tokens``: chunked forward plus
one bulk cache write); the script times it against the token-by-token loop
it replaced (``prefill_tokens_sequential``, kept as the equivalence
oracle): each side's fastest run over rounds of ``PREFILL_RUNS`` batched
runs and one of the loop, at least ``TIMING_ROUNDS`` of them and for at
least ``TIMING_S`` seconds.  On a CUDA device each sketched decode step
attends through the ``landmark_attention`` kernel (one launch a layer).
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from claims_torch import check_claims
from repro_torch._util import tree_leaves
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import SketchAttnCfg
from repro_torch.models.model import init_params
from repro_torch.serve.engine import Engine, ServeConfig

ARCH = "stablelm-3b"
BATCH, PROMPT_LEN, NEW = 2, 48, 16
PREFILL_RUNS = 5  # timed runs of the batched prefill a round
TIMING_ROUNDS, TIMING_S = 3, 2.0  # rounds of both sides: at least 3, for at least 2 s


def cache_mb(cache) -> float:
    return sum(x.numel() * x.element_size() for x in tree_leaves(cache)) / 1e6


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="assert the printed claims (exit non-zero if one fails)")
    args = ap.parse_args()
    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg = reduced(get_config(ARCH))
    params = init_params(args.seed, cfg, device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT_LEN), dtype=np.int32)

    # f32 caches so the d_slots ≥ max_len rows are EXACT (greedy agreement
    # 100%) — with bf16 caches the two paths round identical math differently
    sc = dict(max_len=PROMPT_LEN + NEW, cache_dtype=torch.float32, seed=args.seed)
    eng = Engine(cfg, params, ServeConfig(**sc))
    cache_e = eng.new_cache(BATCH)
    cache_e, logits_exact = eng.prefill_tokens(cache_e, prompts)   # warm-up
    # the batched prefill is a few ms: one stall of the host can outweigh
    # it, and a host whose cores sat idle can run its threaded operations
    # many times slower for about a second; host jitter only adds time, so
    # each side keeps its fastest run, each on a fresh cache, over rounds
    # that span TIMING_S seconds
    def fastest(prefill, runs):
        best = float("inf")
        for _ in range(runs):
            cache = eng.new_cache(BATCH)
            sync()
            t0 = time.perf_counter()
            prefill(cache, prompts)
            sync()
            best = min(best, time.perf_counter() - t0)
        return best

    t_batched = t_seq = float("inf")
    rounds, until = 0, time.perf_counter() + TIMING_S
    while rounds < TIMING_ROUNDS or time.perf_counter() < until:
        t_batched = min(t_batched, fastest(eng.prefill_tokens, PREFILL_RUNS))
        t_seq = min(t_seq, fastest(eng.prefill_tokens_sequential, 1))
        rounds += 1
    print(f"[prefill     ] batched {t_batched * 1e3:7.1f} ms  "
          f"sequential {t_seq * 1e3:7.1f} ms  ({t_seq / t_batched:.0f}x)")
    claims = {"the batched prefill is at least 5× the sequential loop": t_seq >= 5 * t_batched}
    exact, _ = eng.generate(prompts, NEW)
    print(f"[exact       ] cache={cache_mb(cache_e):8.3f} MB  "
          f"tokens[0,:8]={exact[0][:8].tolist()}")

    # projection dimension d_slots is the memory/accuracy knob: cache bytes are
    # O(d_slots) regardless of context length; logit error → 0 as d grows.
    ref = logits_exact.float().cpu().numpy()
    sig = float(np.std(ref))
    for d_slots in [16, 64, 256]:
        c = dataclasses.replace(
            cfg, sketch_attn=SketchAttnCfg(d_slots=d_slots, m=2, m_r=2))
        eng = Engine(c, params, ServeConfig(use_sketch=True, **sc))
        cache_s = eng.new_cache(BATCH)
        cache_s, logits_s = eng.prefill_tokens(cache_s, prompts)
        out, _ = eng.generate(prompts, NEW)
        agree = float(np.mean(exact == out))
        rel = float(np.sqrt(np.mean((logits_s.float().cpu().numpy() - ref) ** 2))) / sig
        print(f"[sketch d={d_slots:4d}] cache={cache_mb(cache_s):8.3f} MB  "
              f"rel-logit-RMSE={rel:6.3f}  greedy agreement={agree:.0%}")
        if d_slots >= sc["max_len"]:
            # every slot a singleton: the sketched decode is exact attention
            claims[f"d={d_slots} ≥ max_len: greedy agreement 100%"] = agree == 1.0
            claims[f"d={d_slots} ≥ max_len: rel-logit-RMSE below 1e-3"] = rel < 1e-3
    check_claims(claims, args.check)


if __name__ == "__main__":
    main()
