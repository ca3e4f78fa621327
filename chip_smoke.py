#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the nvcc version,
   and builds the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` and
   the sector probe ``scripts/sector_probe.cu`` (one nvcc for each source,
   started together).
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and times both beside the kernel's bound:
   CUDA events around a run of back-to-back calls, and the device's own
   time for the same run from ``torch.profiler`` (see ``timed``).  The
   tensor-core attention sweeps also print their TFLOP/s and their share of
   the IEEE-FMA bound and of the 3×TF32 bound (``bound_tc_ms``, ``rate``);
   the decode sweep its share of the byte bound, its TB/s, the device
   operations a call (one launch), float32 and bfloat16, and at zamba2's
   head dim of 112 beside SDPA's time there; matfree_apply its
   share of its byte, FP32 and SFU bounds (the SFU's 16 results a clock an
   SM at ``clocks.max.sm``); the column gathers their share of the byte
   bound and of the sector bound (the distinct 32-byte sectors of the
   sampled columns, at 3.35 TB/s and at the card's rate for random sectors,
   measured first by ``scripts/sector_probe.cu``).
   Each autotuned kernel's candidate geometries (rows a block) are held
   against its static geometry bit for bit and timed, and the measured
   autotune cache chooses one at the row's shape (``geometry``).
3. Runs the three main paths twice, each with every launch count set to 0
   just before it and read just after: pass 1 with ``REPRO_AUTOTUNE=0`` and
   no cache file (the static geometry), pass 2 with the cache on and empty
   (each key's first call measures; the fit of (b) is timed cold and warm).
   Both passes keep every check; their launch counts must agree, and their
   outputs must agree bit for bit.  A third pass runs the paths again on
   pass 2's cache (warm) under ``torch.profiler``, with every kernel
   wrapper's launch in a range of its own (``autotune.PROFILE_RANGES``) and
   the checks' own calls left out, and sums each wrapper's device time on
   each path (``PathTrace``).  Sketched kernel ridge regression, fit and
   predict:
   (a) quickstart §1 (n=2000, d=40): Nyström m=1 and accumulation m=8
       matrix-free fits against exact float64 KRR;
   (b) operator fit and predict at n = 2^21, d=64, m=4;
   (c) dense-K fit at n = 32768 against the operator fit on the same data;
   (d) preconditioned CG on (b)'s data, 30 iterations.
   The progressive engine, with an error target in place of m:
   (e) quickstart §2 (n=2000, d=32): adaptive fits at three targets;
   (f) adaptive KRR on a dense K at n = 32768, doubling and unit schedules;
   (g) the unit schedule on a dense K at n = 8192;
   (h) adaptive KRR on the operator at n = 2^21;
   (i) spectral clustering of planted blobs at n = 32768, fixed m and tol.
   Serving minitron-8b at full width (bfloat16 weights from a seed):
   (j) batch 4, an 8192-token prompt, 64 greedy tokens, with the exact and
       the sketched cache (d_slots 1024, m_r 2): prefill time, decode
       tokens/s, cache bytes, 32 × 63 landmark_attention launches, and the
       decode sweep's device time a step under the profiler;
   (k) the sketched prefill ≡ the sequential fold bitwise (bfloat16 and
       float32 caches), sketched ≡ exact decode with identity slots
       (teacher-forced logits), and a killed generate resumed bitwise;
   (l) accum_attention at B·H = 32, S = 32768, d = 1024, m = 8: the kernel
       route against the plain one, and the kernel route's device time by
       kernel under the profiler.
   Then path (m), the K·S baseline of benchmarks/kernel_bench.py:
   ``sketch_right_kernel`` (accum_apply at the cache's geometry) against
   ``accum_apply_scalar`` (the reference's baseline at bm=256, bd=8: the
   column gather at rows a block from R, csrc ``scalar_rows``) at the
   anchor R=4096, N=8192, d=64, m=4 and on (c)'s dense K at n = 32768 in
   float32 and bfloat16, beside the static geometry, torch.sparse.mm and the
   plain version; and a corrupt cache file, which falls back to the static
   geometry with a health record.  The autotune caches live in a temporary
   directory, so every run starts cold.
   Then path (n), the data mesh (``repro_torch.core.distributed``), once,
   on pass 2's cache, its launch counts from 0:
   (n1) one NCCL rank in this process, under the profiler as pass 3: (b)'s
        sharded (C, W), the three fits and predict, (h)'s adaptive fit, (i)'s
        blobs clustered through a KernelOperator, and the Hutchinson
        estimator at n = 8192, each beside the single-device call on the
        same draw (wall times side by side);
   (n2) two gloo ranks sharing the card (NCCL refuses two ranks on one
        device), ``chip_smoke.py --mesh-rank RANK 2 STORE OUT`` started
        together with ``REPRO_AUTOTUNE=0`` and a time limit, at n = 2²¹ − 1
        (ragged shards): C rows bitwise, draws and θ bitwise across the
        ranks, the float64 fit to 1e-5, the doubling growth's m and passes.
   Float32 θ is held through its residual in the single-device system and
   its fitted values at ``F32_FIT_TOL`` (see there).
   Then path (o), training (``repro_torch.train``, ``train_path``), once,
   its launch counts from 0 (the reference's training reaches no
   ``pallas_call``, so none of the nine kernels may launch):
   (o1) stablelm-3b at full width and depth (2.795 B bfloat16 parameters
        from seed 0, AdamW with float32 masters, ``remat="full"``) on
        4 × 4096 synthetic tokens for 6 steps, compression off and then on:
        losses and gradient norms finite and falling, each step's ms and
        tokens/s, the peak device memory, ``compress_ratio`` against the
        reckoned 0.9194, and one more step under the profiler;
   (o2) one superblock with compression on: 8 steps in one run against 4
        steps, a checkpoint and a fresh run resumed to 8 — the losses of
        steps 4–7 and the final state bit for bit (the loop runs under
        ``torch.use_deterministic_algorithms``, so the script sets
        ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before CUDA starts).
   Then path (p), the model families (``families_path``), once, its launch
   counts from 0 (only landmark_attention may launch: the reference's MoE,
   Mamba-2 and cond code reaches no ``pallas_call``):
   (p1) zamba2-7b at full width and depth (81 layers, 4.65 B bfloat16
        parameters), batch 4, 1024-token prompts, 32 greedy tokens with the
        exact and the sketched cache: prefill ms (the Mamba-2 token scan),
        decode tokens/s, cache bytes, landmark_attention at head dim 112 on
        the 27 shared-attention layers (one profiled sketched step), the
        token scan's device operations a token, ``prefill()`` (chunked SSD)
        against the token scan (bfloat16 printed; float32 held at 0.05 on
        the first 512 tokens), and
        a killed sketched request resumed bitwise;
   (p2) moonshot-v1-16b-a3b at full width (full depth when the reckoned
        peak fits), batch 4, 1024-token prompts, 16 greedy tokens: prefill
        ms, decode tokens/s, a prefill's aux loss and dropped fraction, peak
        memory, and a second run bitwise (the MoE combine is a gather);
   (p3) qwen2-vl-2b prefilled after 1024 cond positions, and
        musicgen-medium trained for two steps after 256 cond positions.
   Then path (q), xLSTM (``xlstm_path``), once, its launch counts from 0
   (the reference's xLSTM reaches no ``pallas_call``, so no kernel may
   launch):
   (q1) xlstm-125m at full width and depth (12 layers alternating mLSTM
        and sLSTM, d_model 768, 4 heads of 192; 77,613,336 bfloat16
        parameters from seed 0), batch 4, 1024-token prompts, 32 greedy
        tokens: prefill ms (the token scan), decode tokens/s (the engine's
        decode loop timed apart), the cache bytes (the recurrent states),
        one decode step's device ms against its wall ms and its aten ops and
        host syncs (``analysis.trace_report``); the sketched engine's
        tokens ≡ the exact engine's, and a killed request resumed bitwise;
   (q2) the sLSTM ``autograd.Function`` against autograd through the token
        loop (L = 64, B = 2, 1e-4 relative) and the chunkwise mLSTM against
        the sequential recurrence (L = 256, 2e-4), float32 at full width;
   (q3) 3 training steps of 4 × 512 tokens at ``remat="full"``, lr 1e-4:
        step ms, tokens/s, peak memory, and the loss of the first batch
        falling.
   Then path (r), the trace contracts (``contracts_path``): every contract
   of ``repro_torch/analysis/contracts.toml`` on the card, one line each
   (each probe warmed up, then recorded under
   ``torch.cuda.set_sync_debug_mode("error")`` where it allows no host
   sync; the launches equal to the dispatches; the device memory's rise
   within the budget), and the RNG sweep.
   Then path (s), the 2-D parameter mesh (``mesh2d_path``: the sharding
   rules of ``repro_torch.sharding``, the models' ``constrain`` calls, the
   expert-parallel MoE, the sharded train step), once, its launch counts
   from 0 (the reference's sharded training reaches no ``pallas_call``, so
   no kernel may launch):
   (s1) one NCCL rank in this process: moonshot-v1-16b-a3b at full width
        (d_model 2048, 16 heads, 64 experts top-6 of d_ff 1408, vocabulary
        163,840) cut to 2 superblocks (1.812 B float32 parameters from seed
        0), 4 × 1024 tokens: the loss and gradients on a 1 × 1 ("data",
        "model") mesh bitwise the same call with no mesh (wall and device
        ms of both, peak memory); the plain version of the a2a path at data
        2 and model 2, and stablelm-3b at full width cut to 2 layers, both
        kept for (s2) as each gradient leaf's norm and 256 sampled entries;
        one bfloat16 AdamW step with no mesh, timed;
   (s2) four gloo ranks sharing the card (NCCL refuses two ranks on one
        device), ``chip_smoke.py --mesh2d-rank RANK 4 STORE OUT`` started
        together with a time limit, on a (data 2, model 2) mesh, the ranks
        on the CPU (the line says "ranks on the CPU") at ``S_CPU_BATCH_SEQ``
        tokens: both models' loss and gradients against (s1)'s
        at ``S_TOL`` (the expert weights' at ``S_EXPERT_TOL``), bitwise equal
        on every rank; moonshot's MoE layers on the a2a path; a
        nothing-dropped MoE layer (capacity factor E/K) against
        ``moe_forward_local``; one bfloat16 AdamW step of moonshot's sharded
        state: its ms, each rank's state shards and peak memory against the
        reckoned quarter of 14 B a parameter, aux and dropped; then four
        reduced checks against rank 0's one process (``mesh2d_reduced``):
        a "dp_only" xlstm-125m step in 4 microbatches, each placed as the
        batch, a sketched prefill into a cache split on its slots over
        both axes (cache bit for bit), an exact decode step over a cache
        whose positions are split on "model" (one model rank holding no
        valid position), and a zamba2-7b training step (its Mamba-2 conv
        and SSD on each rank's shards), each with its seconds.
   Then path (t), the dry run (``dryrun_path``: ``repro_torch.launch.specs``,
   ``.dryrun``, ``.analysis`` and the rank recorder), once, its launch
   counts from 0 (only landmark_attention may launch, in (t1)'s real
   sketched decode):
   (t1) stablelm-3b at full width cut to 2 superblocks, float32 weights:
        one training step on 4 × 1024 tokens (``remat="full"``) and one
        sketched decode step after an 8192-token prompt, each as a dry run
        on a one-rank ``"fake"`` group and for real on the card under
        ``analysis.trace.record``: the same non-view ops in the same order
        (the decode's kernel and the launcher's buffers left out), the same
        FLOPs (plus the kernel's stand-in's), the dispatches equal to the
        launches, and the predicted rise of the allocated bytes within 10%
        of the rise of ``max_memory_allocated`` over the call;
   (t2) ``python -m repro_torch.launch.dryrun`` on the 16 × 16 and
        2 × 16 × 16 meshes of the ``"fake"`` group for an MoE training cell,
        a prefill, an exact decode and a sketched long-context decode (cut
        to 2 superblocks), one subprocess a cell, under one time limit: each
        record printed, any failed cell failing the path.
   Then path (u), the reference's memory plan for training and the example
   twins (``memory_plan_path``), once, its launch counts from 0 (the twins
   count theirs in their own processes):
   (u1) ``chunked_xent`` at gemma3-12b's head (vocabulary 262,144, d_model
        3840) on 16 × 4096 float32 hidden states: the one-buffer backward's
        rise of ``max_memory_allocated`` against ``torch.utils.checkpoint``
        of the chunk's plain ops (the route it replaced), the reckoned rises
        printed first, the loss bit for bit and the gradients at 1e-4;
   (u2) gemma3-12b's global attention block at full width (2 × 4096
        tokens, 16 heads of 256), forward and backward: the recomputing
        chunk against the core that keeps every chunk's scores, rises and
        gradients likewise;
   (u3) (run first, alone on the card) the decode sweep's log-sum-exp
        output against the plain version's at (j)'s and (p)'s shapes and a
        one-split shape (head dim 256), in float32 and bfloat16, the output
        bit for bit the launch's without it, timed beside it;
   (u4) the five example twins (examples/*_torch.py) at their defaults
        with ``--check``, one subprocess each, started together after (u3)
        and beside (u1)–(u2): each exits 0 with its claims holding and prints its wall
        time and the kernels it launched (train_lm none; long_context_serve
        landmark_attention).
4. Prints one ``{"kernels": [...]}`` line (with each kernel's device ms
   summed on the paths of pass 3, (m), (n1) and (p1)), the card line, and as the
   last line ``{"ok": true, "device": {...}}``.  Any failed check exits
   non-zero before the last line is printed.  Without a CUDA device it
   exits 2.

Comparisons use allclose with rtol = tol and atol = tol · max|plain|: the
main path's outputs are of order 10²–10⁵ (coefficients r/sqrt(d·m·p) ≈ 90 at
n = 2^21), so an absolute tolerance alone would measure their magnitude.
"""
from __future__ import annotations

import bisect
import collections
import concurrent.futures
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s,
# float32 operations/s outside the tensor cores, and TF32 operations/s on
# the tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 494.7e12
# bfloat16 operations/s on the tensor cores (dense), the same data sheet
BF16_OPS_PER_S = 989e12
# SFU results (ex2, rsqrt) a clock an SM on Hopper (CUDA C++ Programming
# Guide, throughput of native arithmetic instructions, compute capability 9.0)
SFU_PER_CLOCK_SM = 16

# the main paths' sizes: operator fit (C is 512 MiB), predict rows, dense K,
# the dense K of the unit schedule (the widest K of one accum_step_slab)
N_OP, N_TEST, N_DENSE, N_STEP = 2**21, 65536, 32768, 8192
DEVICE = "cuda"
DRAWS = 8          # sketch draws of each kind in phase (a)
SEED = 0           # the engine's seed in phases (e)-(i)
# error target of the adaptive fits in phases (f), (g) and (h): below what
# d = 64 columns reach on this data, so the growth runs to m_max and every
# batch size of the doubling ladder is driven
TOL_F = TOL_G = TOL_H = 1e-4

# the serving path: minitron-8b's full width, batch, prompt and new tokens;
# the prompt of the identity-slot check (max_len ≤ d_slots) and its tokens;
# accum_attention's sequence length and heads
ARCH, BATCH, PROMPT, NEW = "minitron-8b", 4, 8192, 64
PROMPT_ID, NEW_ID = 512, 32
PROFILED = 4       # decode steps profiled after each serving run of (j)
S_ATT, H_ATT = 32768, 32
# path (m): the K·S microbenchmark's anchor (benchmarks/kernel_bench.py:41)
R_ANCHOR, N_ANCHOR = 4096, 8192
# path (n), the data mesh: the two-rank run's n (shards of 2^20 and 2^20 − 1
# rows), the Hutchinson estimator's n (its K Z is O(n²)), the ranks' limit
N_MESH2, N_HUTCH, MESH_TIMEOUT = 2**21 - 1, 8192, 120
# float32 fitted values of a sharded fit against the single-device one at
# λ = 1e-3: CᵀC summed in another order moves θ along the Woodbury system's
# ill-conditioned directions (the reference's own sharded float32 fit of this
# configuration differs from its single-device fit by 1.5e-3–3.6e-3 in the
# fitted values and 71–120% in θ at n = 4095 and 32767 on the CPU,
# scripts/reference_mesh_spread.py).  θ is held
# through its residual in the single-device system, and the fitted values at
# 1e-5 in float64
F32_FIT_TOL = 1e-2
# path (o), training: stablelm-3b at full width and depth on 4 × 4096 tokens
# (SHAPES["train_4k"]'s sequence, the global batch cut from 256 to 4 for one
# card), 6 steps a run (the script's time limit: a step takes 5.2 s); the
# kill-and-resume check at one superblock, 8 steps, resumed from step 4; the
# optimizer both use (from a random init the full-size loss spikes within
# 10 steps at lr_peak 1e-3, and at 3e-4 with 2 or 10 warmup steps, on the
# H100; 1e-4 falls, PERF.md §6)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "stablelm-3b", 4, 4096, 6
RESUME_STEPS, RESUME_AT = 8, 4
TRAIN_OPT = dict(lr_peak=1e-4, warmup_steps=2)

# path (p), the model families: zamba2-7b served at full width and depth
# (batch 4, 1024-token prompts, cut for the script's time limit: the token
# scan runs 4 prefills, 19–21 s each at 2048 tokens; 32 greedy tokens, exact
# and sketched caches; the kill-and-resume check on one 256-token prompt);
# moonshot-v1-16b-a3b at full width, full depth where the reckoned peak fits
# MOE_PEAK_GB, else MOE_CUT_SB superblocks (batch 4, 1024-token prompts, 16
# greedy tokens, exact cache); the conditioning input: qwen2-vl-2b prefilled
# (batch 2, 1024 tokens after its 1024 cond positions) and musicgen-medium
# trained for 2 steps (2 × 2048 tokens after its 256 cond positions,
# remat="full")
HYB_ARCH, HYB_BATCH, HYB_PROMPT, HYB_NEW, HYB_RESUME = "zamba2-7b", 4, 1024, 32, 256
F32_PROMPT = 512
MOE_ARCH, MOE_BATCH, MOE_PROMPT, MOE_NEW = "moonshot-v1-16b-a3b", 4, 1024, 16
MOE_PEAK_GB, MOE_CUT_SB = 72.0, 24
VLM_ARCH, VLM_BATCH, VLM_TOKENS = "qwen2-vl-2b", 2, 1024
AUD_ARCH, AUD_BATCH, AUD_SEQ, AUD_STEPS = "musicgen-medium", 2, 2048, 2
# the reference's own bound on recurrent logits computed two ways
# (tests/test_archs_smoke.py:67)
RECURRENT_TOL = 0.05
# path (q), xLSTM: xlstm-125m at full width and depth (batch 4, 1024-token
# prompts, 32 greedy tokens; the sketched and the kill-and-resume checks on
# 64-token prompts), its plain-form checks at L = 64 (sLSTM) and 256
# (mLSTM), and 3 training steps of 4 × 512 tokens
XL_ARCH, XL_BATCH, XL_PROMPT, XL_NEW, XL_RESUME = "xlstm-125m", 4, 1024, 32, 64
XL_SLSTM_L, XL_MLSTM_L = 64, 256
XL_TRAIN_BATCH, XL_TRAIN_SEQ, XL_TRAIN_STEPS = 4, 512, 3

# path (s), the 2-D parameter mesh: moonshot-v1-16b-a3b and stablelm-3b at
# full width cut to S_SB superblocks, float32 weights from seed 0, on
# batch × seq tokens; (s2)'s four gloo ranks on a (data 2, model 2) mesh,
# their limit; the entries sampled from each gradient leaf;
# the nothing-dropped MoE check's tokens (batch × seq).  The ranks hold CPU
# tensors: on the H100 (torch 2.11.0+cu128) gloo carries all_reduce,
# all_gather_into_tensor, reduce_scatter_tensor and all_to_all_single for
# CUDA tensors, but DTensor's redistribute from Shard to Replicate (its
# all-gather on the mesh's subgroups) killed all four ranks with SIGSEGV
# (PERF.md §7), so the 2-D mesh on the card waits for several cards; on the
# CPU the batch and length are cut to S_CPU_BATCH_SEQ
S_MOE_ARCH, S_DENSE_ARCH, S_SB, S_BATCH, S_SEQ = "moonshot-v1-16b-a3b", "stablelm-3b", 1, 4, 1024
S_SHAPE, S_TIMEOUT, S_SAMPLES = (2, 2), 300, 256
S_NODROP = (2, 64)
S_CPU_BATCH_SEQ = (2, 256)
# (s2) against one process, both at S_CPU_BATCH_SEQ = 2 × 256 = 512 tokens:
# the loss at 1e-5 relative and each gradient leaf's norm and sampled
# entries at 1e-4 of the leaf's largest sampled entry (float32 sums in
# another order; on the H100 the largest seen were 4.40e-6 for the samples,
# stablelm-3b's, and 1.95e-7 for the norms, PERF.md §6); the expert
# weights' gradients, rounded to bfloat16 where the a2a path reduce-scatters
# them, at one bfloat16 step (2⁻⁸ ≈ 3.9e-3; the largest seen 5.30e-4), since
# a sum that lands on a rounding boundary flips its last bit
S_TOL, S_EXPERT_TOL = 1e-4, 2.0 ** -8
# path (t), the dry run: (t1) stablelm-3b at full width cut to T_SB
# superblocks (2 of its 32 layers), float32 weights from seed 0, one
# training step on T_BATCH × T_SEQ tokens at remat="full" (the sizes of
# (s1)) and one sketched decode step at batch 1 after a T_PROMPT-token
# prompt, each run for real and as a dry run on a one-rank "fake" group;
# the dry run's predicted rise of the allocated bytes held to T_PEAK_TOL of
# the measured one.  (t2) the dry run's command line on both production
# meshes, one subprocess a cell, all started together under one time limit,
# each config cut to T2_SB superblocks (the full depth is the sweep's,
# PERF.md §5): an MoE training cell (the expert-parallel all-to-all), a
# prefill, an exact decode and a sketched long-context decode (the kernel's
# dry-run stand-in)
T_ARCH, T_SB, T_BATCH, T_SEQ, T_PROMPT, T_PEAK_TOL = "stablelm-3b", 2, 4, 1024, 8192, 0.10
T2_CELLS = (("moonshot-v1-16b-a3b", "train_4k"), ("minitron-8b", "prefill_32k"),
            ("qwen1.5-110b", "decode_32k"), ("zamba2-7b", "long_500k"))
T2_SB, T2_TIMEOUT = 2, 300
# path (u), the reference's memory plan and the example twins: (u1) the loss
# at gemma3-12b's head (vocabulary 262,144, d_model 3840) on U_LOSS_BS float32
# hidden states (16 rows of train_4k's 4096 tokens); (u2) gemma3-12b's global
# attention block at full width (16 heads of 256, 8 KV heads) on U_ATTN_BS
# tokens; both routes' gradients held at U_TOL of their largest entry
# (float32 sums in another order); (u3) the decode sweep's log-sum-exp at
# (j)'s, (p)'s and a one-split shape; (u4) the five example twins at their
# defaults, one subprocess each, under U_EX_TIMEOUT: those of U_ALONE (a
# timing ratio among their claims) alone on the card after the others
U_ARCH, U_LOSS_BS, U_ATTN_BS, U_TOL, U_EX_TIMEOUT = "gemma3-12b", (16, 4096), (2, 4096), 1e-4, 300
EXAMPLES = ("quickstart", "krr_m_sweep", "sketched_pca_kmeans", "long_context_serve",
            "train_lm")
U_ALONE = ("long_context_serve",)
# runs one example twin (argv: its path and arguments) and prints, after it,
# every kernel's launches in that process
RUN_EXAMPLE = r"""
import json, os, runpy, sys, time
sys.argv = sys.argv[1:]
sys.path.insert(0, os.path.dirname(sys.argv[0]))   # as `python <script>` does
t0 = time.perf_counter()
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
finally:
    from repro_torch.kernels.accum_apply import kernel as KN
    from repro_torch.kernels.landmark_attention import kernel as LK
    print(f"SECONDS {time.perf_counter() - t0:.1f}")
    print("LAUNCHES " + json.dumps({f.__name__: f.launches for f in KN.KERNELS + LK.KERNELS}))
"""

SRC = "src/repro_torch/kernels/accum_apply/csrc/accum_apply.cu"
LSRC = "src/repro_torch/kernels/landmark_attention/csrc/landmark_attention.cu"
TPU = "src/repro/kernels/accum_apply/kernel.py"
LTPU = "src/repro/kernels/landmark_attention/kernel.py"
PROBE = "scripts/sector_probe.cu"
FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    """Print one check's outcome and remember a failure."""
    print(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        FAILURES.append(what)


def close(out, plain, tol: float):
    """(max abs err, max err / max|plain|, allclose with atol = tol·max|plain|)."""
    out, plain = out.double(), plain.double()
    err = (out - plain).abs()
    scale = max(plain.abs().max().item(), 1e-30)
    ok = bool((err <= tol * scale + tol * plain.abs()).all()) and bool(
        out.isfinite().all())
    return err.max().item(), err.max().item() / scale, ok


def port_launches() -> int:
    """The launches the port's kernel wrappers have counted so far, all
    wrappers together (0 before the port is imported)."""
    total = 0
    for name in ("repro_torch.kernels.accum_apply.kernel",
                 "repro_torch.kernels.landmark_attention.kernel"):
        mod = sys.modules.get(name)
        if mod is not None:
            total += sum(f.launches for f in mod.KERNELS)
    return total


# A profiler session started after a long one on the H100 (torch 2.11) loses
# the device records of its first launches, more the more long sessions ran
# before it (scripts/profiler_drops.py; up to 258 in this script): each
# session therefore opens with PAD launches of torch's empty spin kernel
# (``torch.cuda._sleep(0)``), whose records every reader below leaves out.
PAD = 1024
SPIN = "spin_kernel"
# the most a run's device time a call may exceed its CUDA-event time (timed)
DEVICE_SLACK = 1.05


def pad_profile(torch, pad: int = PAD) -> None:
    """Launch ``pad`` empty spin kernels: the records a session may lose."""
    for _ in range(pad):
        torch.cuda._sleep(0)


def device_records(prof) -> tuple[list[int], int]:
    """(the durations in ns of the device's records (kernels, copies,
    fills) of a finished profiler session, the pad's left out; the pad's
    records it kept), from the raw kineto events."""
    from torch.autograd import DeviceType

    out, pads = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if SPIN in e.name():
                pads += 1
            else:
                out.append(e.end_ns() - e.start_ns())
    return out, pads


def profiled_calls(torch, fn, calls: int, pad: int = PAD) -> tuple[list[int], int]:
    """``device_records`` of ``calls`` back-to-back calls of ``fn`` in a
    profiler session of their own, after ``pad`` spin kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad_profile(torch, pad)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return device_records(prof)


def timed(torch, fn, reps: int = 5, run_ms: float = 20.0,
          max_calls: int = 200) -> tuple[float, float | None]:
    """(ms, device ms) of one call of ``fn``, from runs of back-to-back calls.

    ms: CUDA events around a run of ``calls`` calls, over ``calls``; the
    median of ``reps`` runs, after warm-up.  ``calls`` is sized from one call
    so that a run lasts about ``run_ms``.  Where the host takes longer to
    issue a call than the device to run it, this measures the host.
    device ms: the summed duration of the device's records (kernels, copies,
    fills) in a run under ``torch.profiler``, over ``calls``.  The profiler
    drops records (``PAD``), so a run counts only where it holds all of
    them and no more: ``calls`` times the records of one warm-up call, the
    larger of the port's launch counters around that call and the
    profiler's records of it alone; and only where its device time a call
    is at most ``DEVICE_SLACK`` times ``ms`` (one stream's work cannot take
    the device longer than the run takes; on the H100 a run with its count
    of records read 11% over it).  A run that fails either is tried once
    more, after four times the pad; where that one fails too, the reason is
    printed and the device ms is None, as it is where the profiler saw no
    device activity."""
    def run(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / calls

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    calls = max(1, min(max_calls, round(run_ms / max(run(1), 1e-3))))
    ms = statistics.median(run(calls) for _ in range(reps))
    before = port_launches()
    one, _ = profiled_calls(torch, fn, 1)
    per_call = max(port_launches() - before, len(one))
    for pad in (PAD, 4 * PAD):
        records, pads = profiled_calls(torch, fn, calls, pad)
        dms = sum(records) / 1e6 / calls
        if len(records) == calls * per_call and dms <= DEVICE_SLACK * ms:
            return ms, (dms if dms > 0 else None)
        print(f"  timed: the profiler kept {len(records)} of {calls * per_call} device "
              f"records of a run of {calls} calls ({dms:.5f} device ms a call against "
              f"{ms:.5f} on CUDA events) and {pads} of its {pad} pad records"
              + ("; once more" if pad == PAD else "; device time not read"))
    return ms, None


def profiled(torch, fn) -> tuple[float, float, list, dict]:
    """(wall ms, device ms, the four kernels with the most device time, the
    device ms of every kernel by name) of one ``fn()`` under
    ``torch.profiler``, between device synchronizations.  The profiler's
    own host cost inflates the wall time, not the device's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pad_profile(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and SPIN not in e.name:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by.items(), key=lambda kv: -kv[1])[:4]
    return wall * 1e3, sum(by.values()), [(n[:60], round(t, 3)) for n, t in top], by


def device_ops_per_call(torch, fn, calls: int = 20) -> int:
    """Operations the device ran (kernels, copies, fills) per warm call of
    ``fn``: their count under ``torch.profiler`` over ``calls`` calls, over
    ``calls``, rounded (``profiled_calls``: its session opens with the pad)."""
    fn()
    torch.cuda.synchronize()
    records, _ = profiled_calls(torch, fn, calls)
    return round(len(records) / calls)


class PathTrace:
    """The device time of each kernel wrapper's launches on a main path,
    under ``torch.profiler`` (pass 3); a no-op where ``on`` is false.

    ``begin(path)`` starts one profiler session for the path, with every
    wrapper launching inside a ``launch:<wrapper>`` range
    (``autotune.PROFILE_RANGES``), except the calls made only to check the
    path (``off_path``), which launch outside ranges and so count for no
    wrapper; ``end()`` stops the session and keeps, for the path, each
    wrapper's summed device time and range count (``by_wrapper``) and the
    device ms of every CUDA kernel by name, the checks' included
    (``by_kernel``).  The profiler mirrors each range on the device's
    timeline, spanning the kernels launched inside it; a wrapper's device
    time is the sum of the kernels that lie within its ranges there (on the
    H100 the host-side ranges get no device time of the port's kernels
    linked to them).  The raw kineto events are read rather than
    ``prof.events()``, which builds a Python event, and a tree of them, for
    every host operation of the path.  Each session opens with the pad
    (``PAD``), whose records count for nothing."""

    def __init__(self, torch, autotune, on: bool):
        self.torch, self.at, self.on = torch, autotune, on
        self.path, self.prof = None, None
        self.by_wrapper: dict[str, dict[str, list]] = {}
        self.by_kernel: dict[str, dict[str, float]] = {}
        self.seconds: dict[str, float] = {}

    def begin(self, path: str) -> None:
        from torch.profiler import ProfilerActivity, profile

        if not self.on:
            return
        self.path, self.seconds[path] = path, time.perf_counter()
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        pad_profile(self.torch)
        self.torch.cuda.synchronize()
        self.at.PROFILE_RANGES = True

    def end(self) -> None:
        from torch.autograd import DeviceType

        if self.prof is None:
            return
        self.torch.cuda.synchronize()
        self.at.PROFILE_RANGES = False
        self.prof.stop()
        ranges, ops, kernels = [], [], {}
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            span, name = (e.start_ns(), e.end_ns()), e.name()
            if SPIN in name:
                continue
            if name.startswith("launch:"):
                ranges.append((*span, name.removeprefix("launch:")))
            else:
                ops.append(span)
                kernels[name] = kernels.get(name, 0.0) + (span[1] - span[0]) / 1e6
        ops.sort()
        starts = [a for a, _ in ops]
        wrappers: dict[str, list] = {}
        for a, b, name in ranges:
            i, ns = bisect.bisect_left(starts, a), 0
            while i < len(ops) and ops[i][0] <= b:
                if ops[i][1] <= b:
                    ns += ops[i][1] - ops[i][0]
                i += 1
            acc = wrappers.setdefault(name, [0.0, 0])
            acc[0] += ns / 1e6
            acc[1] += 1
        self.by_wrapper[self.path], self.by_kernel[self.path] = wrappers, kernels
        self.seconds[self.path] = time.perf_counter() - self.seconds[self.path]
        self.prof, self.path = None, None


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    """The least time for the work in ms, and whether bytes or operations set it."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def sm_clock_hz() -> float:
    """The card's highest SM clock, from ``nvidia-smi`` (clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0].split()[0]) * 1e6


def sfu_ms(torch, nops: float) -> float:
    """The least time for ``nops`` SFU operations (ex2, rsqrt): 16 a clock an
    SM at the card's highest SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return nops / (SFU_PER_CLOCK_SM * sms * sm_clock_hz()) * 1e3


def sector_rates(torch, KN, K, samples=(1024, 64), seed: int = 11) -> dict:
    """The card's rate for reads of random 32-byte sectors, from
    ``scripts/sector_probe.cu`` on the row-major float32 K (R, N): every row
    reads S columns drawn uniformly with replacement (as a sketch draws
    them), one warp a row, in four ways: one element a lane as drawn
    ("unsorted") and sorted ascending ("sorted"), and the whole 32-byte
    sector ("sector") or 64-byte segment ("segment64") of each sorted column.
    Returns {S: {way: {ms, units a row, unit bytes, per_s, gb_per_s}}}:
    ms from CUDA events (``timed``), units the distinct sectors (segments) a
    row, per_s the units read a second over all R rows."""
    import ctypes

    lib = ctypes.CDLL(str(KN.build_source(Path(__file__).resolve().parent / PROBE, {})))
    lib.repro_sector_probe.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                                       + [ctypes.c_void_p] * 2)
    lib.repro_sector_probe.restype = ctypes.c_int
    R, N = K.shape
    dev = K.device
    sink = torch.zeros(1, device=dev)
    blocks = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(seed)
    out: dict = {}
    for S in samples:
        drawn = torch.randint(0, N, (S,), generator=g, device=dev, dtype=torch.int32)
        ordered = torch.sort(drawn).values
        out[S] = {}
        for way, cols, nbytes in (("unsorted", drawn, 4), ("sorted", ordered, 4),
                                  ("sector", ordered, 32), ("segment64", ordered, 64)):
            unit = max(nbytes, 32)
            units = int(torch.unique(cols.long() // (unit // 4)).numel())

            def run(cols=cols, nbytes=nbytes):
                err = lib.repro_sector_probe(K.data_ptr(), cols.data_ptr(), R, N, S, nbytes,
                                             blocks, sink.data_ptr(),
                                             torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"sector_probe failed with CUDA error {err}")

            ms, _ = timed(torch, run)
            per_s = R * units / (ms / 1e3)
            out[S][way] = dict(ms=ms, units=units, unit_bytes=unit, per_s=per_s,
                               gb_per_s=per_s * unit / 1e9)
            print(f"  random {unit}-byte units, S={S} a row, {way}: {ms:.4f} ms for "
                  f"{R}×{units} units, {per_s / 1e9:.3f} G units/s, "
                  f"{per_s * unit / 1e9:.1f} GB/s")
    return out


def launch_floor(torch, KN) -> tuple[float, float | None]:
    """The least a kernel launch costs, from ``scripts/sector_probe.cu``'s
    empty kernel (one block of one warp) launched through ctypes as the
    kernel wrappers launch theirs: (ms, device ms) of one launch, ``timed``:
    the wall time a launch takes back to back (the host's issue cost), and
    the device's time for the empty kernel."""
    import ctypes

    lib = ctypes.CDLL(str(KN.build_source(Path(__file__).resolve().parent / PROBE, {})))
    lib.repro_empty_launch.argtypes = [ctypes.c_void_p]
    lib.repro_empty_launch.restype = ctypes.c_int

    def run():
        err = lib.repro_empty_launch(torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the empty kernel failed with CUDA error {err}")

    return timed(torch, run)


def sector_bound(idx, R: int, isz: int, other_bytes: float, rates: dict) -> dict:
    """The column gather's bound in sectors: the distinct 32-byte sectors of
    the sampled columns a row (``isz``-byte elements, rows aligned to 32
    bytes), R times, plus ``other_bytes`` (idx, coef, Cin, outputs), at
    3.35 TB/s (``sector_bound_ms``) and at the sector probe's rate for
    random sectors (``sector_rate_ms``: the faster of ``sector_rates``'
    unsorted and sorted element reads, at the sample count nearest m·d; a
    reference, no floor: the register gather passes it)."""
    import torch

    sectors = int(torch.unique(idx.reshape(-1).long() // (32 // isz)).numel())
    near = min(rates, key=lambda s: abs(math.log(s / idx.numel())))
    per_s = max(rates[near]["unsorted"]["per_s"], rates[near]["sorted"]["per_s"])
    rest = other_bytes / HBM_BYTES_PER_S * 1e3
    return dict(sectors_a_row=sectors,
                sector_bound_ms=R * sectors * 32 / HBM_BYTES_PER_S * 1e3 + rest,
                sector_rate_ms=R * sectors / per_s * 1e3 + rest,
                sector_rate_per_s=per_s, sector_rate_at=near)


def shares(name: str, dms: float | None, bounds: dict) -> dict:
    """Print a row's device time as a share of each of its bounds; return
    {bound name: share}."""
    got = {k: (v / dms if dms else None) for k, v in bounds.items()}
    print(f"  {name}: device {dms} ms; " + ", ".join(
        f"{k} {bounds[k]:.5f} ms ({got[k]:.1%})" if got[k] is not None else f"{k} not measured"
        for k in bounds))
    return got


def rate(name: str, ms: float, flops: float, b_fma: float, b_tc: float) -> dict:
    """Achieved TFLOP/s of a tensor-core sweep and its share of both bounds:
    IEEE float32 FMA, and 3×TF32 (three tensor-core products a product)."""
    tflops = flops / ms / 1e9
    print(f"  {name}: {tflops:.2f} TFLOP/s of float32-accurate work; "
          f"{b_fma / ms:.1%} of the FMA bound ({b_fma:.3f} ms), {b_tc / ms:.1%} of the "
          f"3×TF32 bound ({b_tc:.3f} ms)")
    return dict(bound_tc_ms=b_tc, tflops=tflops, share_of_bound=b_fma / ms,
                share_of_bound_tc=b_tc / ms)


def wall(torch, fn):
    """(fn(), seconds on the host clock between two device synchronizations)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sketch_csr(torch, idx, coef, n: int, *, transposed: bool = False):
    """The sketch S (n, d), or Sᵀ, as one sparse CSR matrix; draws that hit
    one row of a column are summed, as in S."""
    m, d = idx.shape
    cols = torch.arange(d, device=idx.device).repeat(m)
    ij = torch.stack([idx.reshape(-1).long(), cols])
    shape = (n, d)
    if transposed:
        ij, shape = ij.flip(0), (d, n)
    return torch.sparse_coo_tensor(ij, coef.reshape(-1), shape).coalesce().to_sparse_csr()


def pairwise_agreement(torch, truth, labels) -> float:
    """Share of ordered point pairs (i, j) on which two labelings agree about
    being in one cluster, from their contingency table: n² − T − L + 2·S11
    over n², with T, L the same-cluster pair counts of each labeling and S11
    those of both."""
    n = truth.numel()
    k = int(max(truth.max(), labels.max())) + 1
    table = torch.bincount(truth.long() * k + labels.long(),
                           minlength=k * k).reshape(k, k).double()
    s11 = (table ** 2).sum()
    t, l_ = (table.sum(1) ** 2).sum(), (table.sum(0) ** 2).sum()
    return float((n * n - t - l_ + 2 * s11) / (n * n))


def make_regression(torch, dev, n: int, seed: int):
    """(generator, X (n, 3), f, y): the regression data of the KRR paths,
    drawn on ``dev`` from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.rand((n, 3), generator=g, device=dev)
    f = torch.sin(3 * X[:, 0]) + X[:, 1] ** 2 - X[:, 2]
    y = f + 0.3 * torch.randn((n,), generator=g, device=dev)
    return g, X, f, y


def residual(C, W, y, theta, lam: float) -> float:
    """‖Mθ − Cᵀy‖/‖Cᵀy‖ in float64 for the Woodbury system M = CᵀC + nλW of
    the full C: how well θ solves that d×d system."""
    C, W, y, theta = (t.double() for t in (C, W, y, theta))
    rhs = C.T @ y
    return (((C.T @ C + y.shape[0] * lam * W) @ theta - rhs).norm() / rhs.norm()).item()


def digest(t) -> str:
    """A hash of a tensor's bytes (bfloat16 through its 16-bit patterns), to
    compare results across processes and runs."""
    import hashlib

    import torch

    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha1(t.numpy().tobytes()).hexdigest()


def tree_digest(tree) -> str:
    """One hash of every tensor leaf of a tree (None leaves marked), in the
    tree's leaf order."""
    import hashlib

    from repro_torch._util import tree_leaves

    return hashlib.sha1("".join("none" if x is None else digest(x)
                                for x in tree_leaves(tree)).encode()).hexdigest()


def collective_ms(torch, D, mesh, shape) -> tuple[float, float]:
    """(ms of the mesh's first ``all_reduce``, which sets its communicator
    up; median ms of 20 more), of a float32 tensor of ``shape`` on the
    mesh's device, host clock between synchronizations."""
    t = torch.zeros(shape, device=mesh.device)
    _, first = wall(torch, lambda: D.all_reduce(t, mesh))
    return first * 1e3, statistics.median(
        wall(torch, lambda: D.all_reduce(t, mesh))[1] for _ in range(20)) * 1e3


def mesh_rank(rank: int, size: int, store: str, out: str) -> int:
    """One rank of path (n2): ``chip_smoke.py --mesh-rank RANK SIZE STORE
    OUT``.  Joins a gloo group of ``size`` ranks on the FileStore ``store``,
    all on the card, runs (b)'s fit, predict and (h)'s doubling growth at
    n = N_MESH2 (ragged shards) on one device (untimed, to set the process's
    libraries up), on the mesh, and on one device again, on the same draws,
    compares its own rows, and writes what it found to ``out`` (JSON)."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import apply as A
    from repro_torch.core import distributed as D
    from repro_torch.core import KernelOperator, krr_sketched_fit, make_accum_sketch
    from repro_torch.kernels.accum_apply import kernel as KN

    dev = torch.device(DEVICE)
    dist.init_process_group("gloo", store=dist.FileStore(store, size), rank=rank,
                            world_size=size, timeout=timedelta(seconds=60))
    try:
        mesh = D.make_data_mesh(size, device=dev)
        n, d, m, lam, bw = N_MESH2, 64, 4, 1e-3, 0.5
        all_reduce_ms = collective_ms(torch, D, mesh, (m * d, d))
        lo, hi = mesh.rows(n)
        g, X, f, y = make_regression(torch, dev, n, 2)
        sk = make_accum_sketch(g, n, d, m, device=dev)
        op = KernelOperator(X, "gaussian", bw)
        Xt = torch.rand((N_TEST, 3), generator=torch.Generator(device=dev).manual_seed(4),
                        device=dev)

        def run(on):
            """(C, W), the fit, its predictions and the doubling growth, each
            with its host-clock seconds, on the mesh ``on`` (None: one
            device)."""
            both, t_both = wall(torch, lambda: A.sketch_both(op, sk, mesh=on))
            model, t_fit = wall(torch, lambda: krr_sketched_fit(op, y, lam, sk, mesh=on))
            pred, t_pred = wall(torch, lambda: model.predict(Xt, mesh=on))
            grown, t_grow = wall(torch, lambda: A.grow_sketch_both(
                SEED, op, d, m_max=16, tol=TOL_H, mesh=on))
            return both, model, pred, grown, (t_both, t_fit, t_pred, t_grow)

        # the single-device path on the same draws first, untimed: the process's
        # first calls set up its libraries (cuBLAS, cuSOLVER, the kernels' module)
        run(None)
        for f_ in KN.KERNELS:
            f_.launches = 0
        (C, W), model, pred, (skg, _, _, info), ts = run(mesh)
        launches = {f_.__name__: f_.launches for f_ in KN.KERNELS}
        (C1, W1), model1, pred1, (skg1, _, _, info1), ts1 = run(None)
        # float64 (the plain route: the kernel takes float32 and bfloat16)
        op64, y64 = KernelOperator(X.double(), "gaussian", bw), y.double()
        fit64 = krr_sketched_fit(op64, y64, lam, sk, use_kernel=False, mesh=mesh).fitted
        fit64_1 = krr_sketched_fit(op64, y64, lam, sk, use_kernel=False).fitted
        tlo, thi = mesh.rows(N_TEST)

        def sums(a, b):
            a, b = a.double(), b.double()
            return [((a - b) ** 2).sum().item(), (b ** 2).sum().item()]

        res = dict(
            rank=rank, rows=[lo, hi], launches=launches, all_reduce_ms=all_reduce_ms,
            C_rows_bitwise=torch.equal(C, C1[lo:hi]), W_bitwise=torch.equal(W, W1),
            W_rel=((W - W1).norm() / W1.norm()).item(),
            fitted=sums(model.fitted, model1.fitted[lo:hi]),
            fitted64=sums(fit64, fit64_1[lo:hi]),
            pred=sums(pred, pred1[tlo:thi]),
            theta_rel=((model.theta - model1.theta).norm() / model1.theta.norm()).item(),
            theta_residual=residual(C1, W1, y, model.theta, lam),
            theta_residual_single=residual(C1, W1, y, model1.theta, lam),
            theta=digest(model.theta),
            draws=[digest(sk.indices), digest(sk.signs), digest(skg.indices),
                   digest(skg.signs)],
            grow_draws_single=torch.equal(skg.indices, skg1.indices)
            and torch.equal(skg.signs, skg1.signs),
            grow=[info["m"], info["passes"]], grow_single=[info1["m"], info1["passes"]],
            ms={k: [a * 1e3, b * 1e3] for k, a, b in
                zip(("sketch_both", "fit", "predict", "doubling"), ts, ts1)})
    finally:
        dist.destroy_process_group()
    Path(out).write_text(json.dumps(res))
    return 0


def train_step_ops(cfg, batch: int, seq: int, q_chunk: int = 512) -> tuple[float, float]:
    """(bfloat16 GEMM operations, float32 operations) of one training step at
    ``remat="full"``, from the shapes: every product runs four times (the
    forward, its recompute in the backward, and the backward's two); the
    bfloat16 ones are the blocks' projections, the float32 ones the
    attention's two einsums over the keys each query chunk reads and the
    float32 output head."""
    D, H, Hkv, Dh, L = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    tokens = batch * seq
    per_layer = D * (H + 2 * Hkv) * Dh + H * Dh * D + 3 * D * cfg.d_ff
    qc = seq // max(seq // q_chunk, 1)
    pairs = sum(min(qc, seq - s0) * min(seq, s0 + qc) for s0 in range(0, seq, qc))
    attn = 2 * 2 * batch * H * Dh * pairs * L
    head = 2 * tokens * D * cfg.vocab_size
    return 4 * 2 * per_layer * L * tokens, 4 * (attn + head)


def kernel_class(name: str) -> str:
    """A device kernel's class by its name: float32 or bfloat16 GEMM,
    softmax, reduction, indexing or elementwise."""
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "cutlass")):
        return "gemm float32" if "f32f32_f32f32" in low or "sgemm" in low else "gemm bfloat16"
    for key, cls in (("softmax", "softmax"), ("reduce", "reduction"), ("index", "indexing"),
                     ("scatter", "indexing"), ("gather", "indexing"), ("memcpy", "copy"),
                     ("memset", "copy"), ("elementwise", "elementwise"), ("cat", "copy")):
        if key in low:
            return cls
    return "other"


def train_path(torch, dev, trace, smi: str, *, cfg=None, batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, steps=TRAIN_STEPS, resume_steps=RESUME_STEPS,
               resume_at=RESUME_AT) -> None:
    """Path (o), training (``repro_torch.train``) through ``train.loop.run``:
    (o1) ``cfg`` (stablelm-3b at full width and depth) from seed 0 for
    ``steps`` steps on ``global_batch`` (batch × seq), ``remat="full"``,
    compression off and then on, printing each step's loss, gradient norm,
    ms and tokens/s, each run's peak device memory and compress_ratio, and
    one more step under the profiler (``PathTrace`` path "train": the
    device's busy share and its kernels by time); (o2) ``cfg`` at one
    superblock with compression on: ``resume_steps`` steps in one run against
    ``resume_at`` steps, a checkpoint and a fresh run resumed from it — the
    losses after ``resume_at`` and the final state bit for bit."""
    import dataclasses
    import shutil

    from repro_torch._util import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.models.model import init_params, param_count
    from repro_torch.optim.adamw import AdamWConfig, adamw_update
    from repro_torch.optim.compress import CompressConfig
    from repro_torch.train import step as TS
    from repro_torch.train.loop import LoopConfig, deterministic, run

    cfg = cfg or get_config(TRAIN_ARCH)
    cuda = dev.type == "cuda"
    opt = AdamWConfig(total_steps=steps, **TRAIN_OPT)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch)
    t_all = time.perf_counter()

    def phase(fn):
        """(fn(), seconds on the host clock between device synchronizations)."""
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def training(cfg, tc, lc, record):
        """``run`` from seed 0's state; ``record`` gets each step's numbers
        and the last state."""
        def step_fn(state, tok, lab, i):
            t0 = time.perf_counter()
            state, mets = TS.train_step(state, tok, lab, i, cfg, tc)
            loss = mets["loss"].item()                  # ends in a synchronization
            ms = (time.perf_counter() - t0) * 1e3
            record["steps"].append(dict(loss=loss, grad_norm=mets["grad_norm"].item(), ms=ms,
                                        ratio=mets.get("compress_ratio")))
            record["state"] = state
            return state, mets

        record.setdefault("steps", [])
        return run(cfg, tc, dc, lc, step_fn=step_fn, log=lambda *a: None,
                   init_params_fn=lambda: TS.init_train_state(init_params(0, cfg, device=dev),
                                                              tc))

    # (o1) full width and depth, compression off, then on
    n_params = None
    for compress in (None, CompressConfig()):
        tc = TS.TrainConfig(optimizer=opt, remat="full", n_micro=1, compress=compress)
        label = "compressed" if compress else "uncompressed"
        rec: dict = {}
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rep = training(cfg, tc, LoopConfig(total_steps=steps, log_every=10**9), rec)
        secs = time.perf_counter() - t0
        n_params = param_count(rec["state"].params)
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
        for i, r in enumerate(rec["steps"]):
            print(f"  (o1) {label} step {i}: loss {r['loss']:.5f}, grad_norm "
                  f"{r['grad_norm']:.5g}, {r['ms']:.1f} ms, "
                  f"{batch * seq / r['ms'] * 1e3:.1f} tokens/s")
        steady = statistics.median(r["ms"] for r in rec["steps"][2:]) if steps > 2 else None
        ratio = rec["steps"][-1]["ratio"]
        print(f"  (o1) {label}: {cfg.name}, {n_params} parameters, batch {batch} × {seq}, "
              f"{steps} steps in {secs:.1f} s; median step of steps 2–{steps - 1} "
              f"{steady} ms ({batch * seq / steady * 1e3 if steady else 0:.1f} tokens/s); "
              f"peak device memory {peak:.2f} GB (max_memory_allocated); compress_ratio "
              f"{ratio}; stragglers {rep.straggler_steps}; card: {smi}")
        losses = [r["loss"] for r in rec["steps"]]
        check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                  for r in rec["steps"]) and len(losses) == steps,
              f"(o1) {label}: every loss and gradient norm finite")
        check(statistics.mean(losses[-3:]) < losses[0],
              f"(o1) {label}: the mean of the last 3 losses {statistics.mean(losses[-3:]):.5f} "
              f"below the first {losses[0]:.5f}")
        if compress:
            # the leaves of ≥ min_rows rows (embed and lm_head) send d = ratio·p
            # of their p rows
            eligible = [x for x in tree_leaves(rec["state"].params)
                        if x.ndim >= 2 and x.shape[0] >= compress.min_rows]
            want = (n_params - sum(x.numel() for x in eligible) + sum(
                int(x.shape[0] * compress.ratio) * x[0].numel() for x in eligible)) / n_params
            check(abs(ratio - want) <= 1e-3,
                  f"(o1) compress_ratio {ratio:.6f}, reckoned {want:.6f} (tol 1e-3)")
        else:
            # one more step, profiled: where the device time of a step goes
            state = rec.pop("state")
            tok, lab = global_batch(dc, steps, device=dev)
            with deterministic():
                trace.begin("train")
                t0 = time.perf_counter()
                state, mets = TS.train_step(state, tok, lab, steps, cfg, tc)
                mets["loss"].item()
                wall_ms = (time.perf_counter() - t0) * 1e3
                trace.end()
            by = trace.by_kernel.get("train", {})
            busy = sum(by.values())
            top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
            classes: dict[str, float] = {}
            for name, ms in by.items():
                classes[kernel_class(name)] = classes.get(kernel_class(name), 0.0) + ms
            print(f"  (o1) one step under the profiler: {wall_ms:.1f} ms wall, device "
                  f"{busy:.1f} ms ({busy / wall_ms:.1%} busy); by class (ms): "
                  f"{ {k: round(v, 1) for k, v in sorted(classes.items(), key=lambda kv: -kv[1])} }"
                  f"; by kernel (ms): {[(k[:70], round(v, 2)) for k, v in top]}")
            ops16, ops32 = train_step_ops(cfg, batch, seq, tc.q_chunk)
            bound = (ops16 / BF16_OPS_PER_S + ops32 / F32_OPS_PER_S) * 1e3
            print(f"  (o1) a step's operations: {ops16:.4g} bfloat16 (GEMMs), {ops32:.4g} "
                  f"float32 (attention einsums, head); bound {bound:.1f} ms at "
                  f"{BF16_OPS_PER_S / 1e12:.0f} and {F32_OPS_PER_S / 1e12:.0f} TFLOP/s, "
                  f"summed (one stream runs them in turn): the step is at "
                  f"{bound / busy if busy else 0:.1%} of it on device time")
            # one more step in its two phases, host clock between synchronizations
            tok, lab = global_batch(dc, steps + 1, device=dev)
            with deterministic():
                (_, _, grads), t_grad = phase(lambda: TS._grads(
                    state.params, tok, lab, None, cfg, tc))
                out, t_opt = phase(lambda: adamw_update(grads, state.opt, tc.optimizer))
            print(f"  (o1) a step's phases: loss and gradients (forward, recompute, backward) "
                  f"{t_grad * 1e3:.1f} ms; adamw_update {t_opt * 1e3:.1f} ms")
            del state, mets, tok, lab, grads, out
        rec.clear()
    check(n_params is not None and (cfg.name != TRAIN_ARCH or n_params == 2_795_276_800),
          f"(o1) {cfg.name}: {n_params} parameters")

    # (o2) kill and resume at one superblock, compression on
    cfg1 = dataclasses.replace(cfg, n_layers=len(cfg.pattern), n_superblocks=1)
    tc = TS.TrainConfig(optimizer=dataclasses.replace(opt, total_steps=resume_steps),
                        remat="full", compress=CompressConfig())
    t0 = time.perf_counter()
    whole: dict = {}
    rep_w = training(cfg1, tc, LoopConfig(total_steps=resume_steps, log_every=10**9), whole)
    want = {k: tree_digest(getattr(whole["state"], k)) for k in ("params", "opt", "ef")}
    whole.clear()
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        lc = dict(ckpt_dir=ckdir, ckpt_every=10**9, keep=1, log_every=10**9)
        t1 = time.perf_counter()
        training(cfg1, tc, LoopConfig(total_steps=resume_at, **lc), {})
        t2 = time.perf_counter()
        resumed: dict = {}
        rep_r = training(cfg1, tc, LoopConfig(total_steps=resume_steps, **lc), resumed)
        t3 = time.perf_counter()
        got = {k: tree_digest(getattr(resumed["state"], k)) for k in ("params", "opt", "ef")}
        resumed.clear()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    print(f"  (o2) {cfg1.name} at one superblock: {resume_steps} steps uninterrupted "
          f"{t1 - t0:.1f} s; {resume_at} steps and a checkpoint {t2 - t1:.1f} s; resumed to "
          f"{resume_steps} {t3 - t2:.1f} s (each run writes its last step, keep=1)")
    check(rep_r.resumed_from == resume_at and rep_r.losses == rep_w.losses[resume_at:],
          f"(o2) losses of steps {resume_at}–{resume_steps - 1} bitwise equal: "
          f"{rep_r.losses} (resumed from {rep_r.resumed_from})")
    check(got == want, "(o2) the final parameters, AdamW state and error feedback have "
                       "equal digests, resumed and uninterrupted")
    if cuda:
        torch.cuda.empty_cache()
    print(f"  (o) {time.perf_counter() - t_all:.1f} s in all")


def reckoned_params(cfg) -> int:
    """The parameter count of ``cfg`` from its shapes alone (the layout of
    ``init_params``, counted apart from any tensor)."""
    D, V, H, Hkv, Dh = cfg.d_model, cfg.vocab_size, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D + D
    attn += (H * Dh + 2 * Hkv * Dh) if cfg.qkv_bias else 0
    dense = 3 * D * cfg.d_ff + D
    n = V * D * (1 if cfg.tie_embeddings else 2) + D
    if cfg.moe is not None:
        E, F = cfg.moe.n_experts, cfg.moe.d_ff_expert
        ffn = D * E + 3 * E * D * F + D + (
            3 * D * cfg.moe.d_ff_dense + D if cfg.moe.dense_residual else 0)
    else:
        ffn = dense
    for kind in cfg.pattern:
        if kind == "mamba2":
            s = cfg.ssm
            di = s.expand * D
            hs, ch = di // s.head_dim, di + 2 * s.d_state
            n += cfg.n_superblocks * (D * (2 * di + 2 * s.d_state + hs) + s.conv_width * ch
                                      + ch + 3 * hs + di + di * D + D)
        elif kind in ("mlstm", "slstm"):
            HD = H * Dh
            gates = 2 * D * H + H if kind == "mlstm" else 4 * H * Dh * Dh + HD
            n += cfg.n_superblocks * (4 * D * HD + HD * D + D + gates)
        elif kind != "attn_shared":
            n += cfg.n_superblocks * (attn + ffn)
    if "attn_shared" in cfg.pattern:
        n += attn + dense
    return n


def families_path(torch, dev, trace, smi: str, LK, *, hyb_cfg=None, moe_cfg=None,
                  vlm_cfg=None, aud_cfg=None, hyb=(HYB_BATCH, HYB_PROMPT, HYB_NEW),
                  hyb_resume=HYB_RESUME, moe=(MOE_BATCH, MOE_PROMPT, MOE_NEW),
                  vlm=(VLM_BATCH, VLM_TOKENS), aud=(AUD_BATCH, AUD_SEQ, AUD_STEPS),
                  scan_counts=(128, 256)) -> None:
    """Path (p), the model families of ``models/moe.py``, ``models/ssm.py``
    and the conditioning input, once, weights from seed 0:

    (p1) ``hyb_cfg`` (zamba2-7b) served through ``Engine.generate`` with the
    exact and the sketched cache: prefill ms (the Mamba-2 layers' token
    scan), decode tokens/s, cache bytes, the landmark_attention launches of
    the sketched decode, one profiled sketched decode step (``PathTrace``
    path "families": the launches' device ms); the token scan's device
    operations per token (``scan_counts``, by difference); ``prefill()``
    (the chunked SSD) against the engine's prefill logits, in bfloat16
    (printed) and in float32 at full depth (held at ``RECURRENT_TOL``); a
    sketched request killed by the fault plan and resumed, bitwise.
    (p2) ``moe_cfg`` (moonshot-v1-16b-a3b), exact cache: prefill ms, decode
    tokens/s, a prefill's aux loss and dropped fraction (every MoE layer's
    ``MoEMetrics``), peak memory; a second identical run bitwise.
    (p3) ``vlm_cfg`` (qwen2-vl-2b) prefilled after its cond positions, and
    ``aud_cfg`` (musicgen-medium) trained for ``aud[2]`` steps with its cond
    positions: losses finite, the cond positions not counted."""
    import dataclasses

    import numpy as np

    from repro_torch._util import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import model as MT
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.ssm import SSMState
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.resilience import faults
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train import step as TS

    cuda = dev.type == "cuda"
    t_all = time.perf_counter()

    def gb(tree) -> float:
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
                   if isinstance(x, torch.Tensor)) / 1e9

    def prompts_of(cfg, b, n, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randint(0, cfg.vocab_size, (b, n), generator=g).numpy().astype(np.int32)

    def fresh_peak():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")

    # ---- (p1) the hybrid: zamba2-7b serving ---------------------------------
    cfg = hyb_cfg or get_config(HYB_ARCH)
    B, L, new = hyb
    fresh_peak()
    params, t_init = wall(torch, lambda: MT.init_params(0, cfg, device=dev))
    n_params = MT.param_count(params)
    check(n_params == reckoned_params(cfg),
          f"(p1) {cfg.name}: {n_params} parameters, reckoned {reckoned_params(cfg)} "
          f"({gb(params):.2f} GB; drawn in {t_init:.1f} s)")
    n_attn = cfg.n_superblocks * sum(k.startswith("attn") for k in cfg.pattern)
    sa = cfg.sketch_attn
    prompts = prompts_of(cfg, B, L, 21)
    logits_of = {}
    for mode in ("exact", "sketched"):
        eng = Engine(cfg, params, ServeConfig(max_len=L + new, use_sketch=mode == "sketched"))
        eng.prefill_tokens(eng.new_cache(B), prompts[:, :64])     # warm-up, untimed
        (cache, logits), tpre = wall(torch, lambda: eng.prefill_tokens(eng.new_cache(B),
                                                                       prompts))
        logits_of[mode] = logits
        del cache
        fresh_peak()
        before = LK.landmark_attention.launches
        (toks, cache), tgen = wall(torch, lambda: eng.generate(prompts, new))
        la = LK.landmark_attention.launches - before
        ssm = [st for sts in cache.blocks.values() for st in sts if isinstance(st, SSMState)]
        tdec = tgen - tpre
        print(f"  (p1) {cfg.name} {mode:8s}: prefill {B}×{L} tokens {tpre * 1e3:.1f} ms (the "
              f"token scan); generate {new} tokens {tgen * 1e3:.1f} ms, so decode {new - 1} "
              f"steps {tdec * 1e3:.1f} ms = {B * (new - 1) / tdec:.1f} tokens/s; cache "
              f"{gb(cache):.3f} GB ({gb(ssm):.3f} GB of it SSM state); peak "
              f"{peak_gb():.2f} GB; landmark_attention launches {la}; card: {smi}")
        check(toks.shape == (B, new) and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"(p1) {mode}: {B}×{new} tokens in the vocabulary")
        want = n_attn * (new - 1) if mode == "sketched" else 0
        check(la == want, f"(p1) {mode}: landmark_attention launched {la} times, "
                          f"attention layers × (n_new − 1) = {want} expected")
        if mode == "sketched":
            # one more decode step under the profiler: the sweep's launches and
            # their device time on the path (PathTrace path "families")
            pos = L + new - 1
            last = torch.as_tensor(toks[:, -1], device=dev)
            slots = eng._slots(pos)
            before = LK.landmark_attention.launches
            trace.begin("families")
            (lg, _), tstep = wall(torch, lambda: MT.decode_step(params, cache, last, pos, cfg,
                                                                slots=slots))
            trace.end()
            la = LK.landmark_attention.launches - before
            rng = trace.by_wrapper.get("families", {}).get("landmark_attention", [0.0, 0])
            busy = sum(trace.by_kernel.get("families", {}).values())
            print(f"  (p1) one profiled sketched decode step: {tstep * 1e3:.1f} ms wall, "
                  f"device {busy:.2f} ms; landmark_attention {la} launches, {rng[0]:.4f} ms "
                  f"of device time ({rng[0] / max(rng[1], 1) * 1e3:.2f} µs a launch, "
                  f"{rng[1]} ranges on the device's timeline)")
            check(la == n_attn and bool(lg.isfinite().all()) and (
                not trace.on or 0.99 * la <= rng[1] <= la),
                  f"(p1) the profiled step: {la} landmark_attention launches, {n_attn} "
                  f"expected, logits finite")
            del lg
        del cache, eng

    # the token scan: device operations per prompt token, by difference
    if cuda:
        lo, hi = scan_counts
        eng = Engine(cfg, params, ServeConfig(max_len=hi))
        ops = [device_ops_per_call(torch, lambda n=n: eng.prefill_tokens(
            eng.new_cache(B), prompts[:, :n]), calls=1) for n in (lo, hi)]
        per_tok = (ops[1] - ops[0]) / (hi - lo)
        mamba = cfg.n_superblocks * cfg.pattern.count("mamba2")
        print(f"  (p1) the token-scan prefill: {ops[0]} device operations at {lo} tokens, "
              f"{ops[1]} at {hi}: {per_tok:.1f} a token ({per_tok / mamba:.2f} a token and "
              f"Mamba-2 layer, {mamba} layers)")
        del eng
    # prefill() (the chunked SSD) against the token scan's logits
    tok_t = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    lg_chunk, tch = wall(torch, lambda: MT.prefill(params, tok_t, cfg))
    gaps = {m: (lg_chunk - lg).abs().max().item() for m, lg in logits_of.items()}
    print(f"  (p1) prefill() (chunked SSD) {tch * 1e3:.1f} ms; bfloat16 at full depth: max "
          f"|logit gap| to the token scan's {gaps['exact']:.4f} exact, "
          f"{gaps['sketched']:.4f} sketched (max |logit| {lg_chunk.abs().max().item():.3f}); "
          f"the reference's own bfloat16 gap grows with depth "
          f"(scripts/hybrid_prefill_gap.py)")
    check(bool(lg_chunk.isfinite().all()), "(p1) prefill() logits finite")
    del params, lg_chunk, logits_of
    fresh_peak()
    # the same comparison in float32 at full depth, on the prompts' first
    # F32_PROMPT tokens (the token scan's time grows with the length alone)
    n32 = min(L, F32_PROMPT)
    p32 = MT.init_params(0, cfg, device=dev, dtype=torch.float32)
    c32 = MT.init_cache(cfg, B, n32, torch.float32, device=dev)
    (l_scan, _), tscan = wall(torch, lambda: MT.prefill_with_cache(p32, tok_t[:, :n32], cfg,
                                                                    c32))
    l_chunk, tch = wall(torch, lambda: MT.prefill(p32, tok_t[:, :n32], cfg))
    gap = (l_chunk - l_scan).abs().max().item()
    check(gap < RECURRENT_TOL,
          f"(p1) float32 at full depth, {B}×{n32} tokens: prefill() (chunked SSD, "
          f"{tch * 1e3:.1f} ms) against prefill_with_cache (token scan, {tscan * 1e3:.1f} ms): "
          f"max |logit gap| {gap:.3e} (tol {RECURRENT_TOL}, tests/test_archs_smoke.py:67)")
    del p32, c32, l_scan, l_chunk

    # a sketched request killed at its 2nd decode chunk and resumed, bitwise
    params = MT.init_params(0, cfg, device=dev)
    kw = dict(max_len=2 * sa.d_slots, use_sketch=True, temperature=0.7, seed=3, ckpt_every=4)
    pr = prompts[:1, :hyb_resume]
    t0 = time.perf_counter()
    ref_toks, _ = Engine(cfg, params, ServeConfig(**kw)).generate(pr, 12)
    with tempfile.TemporaryDirectory() as ckdir:
        os.environ[faults.ENV_PLAN] = '{"decode.step": {"action": "kill", "at": 2}}'
        faults.reset()
        killed = False
        try:
            Engine(cfg, params, ServeConfig(ckpt_dir=ckdir, **kw)).generate(pr, 12,
                                                                            request_id="r")
        except faults.DeviceLost:
            killed = True
        finally:
            del os.environ[faults.ENV_PLAN]
            faults.reset()
        eng = Engine(cfg, params, ServeConfig(ckpt_dir=ckdir, **kw))
        toks, _ = eng.generate(pr, 12, request_id="r")
    check(killed and (toks == ref_toks).all() and eng.health.count("ckpt.resume") == 1,
          f"(p1) a sketched {hyb_resume}-token request killed by the decode.step plan and "
          f"resumed: the same 12 tokens bitwise ({'killed' if killed else 'NOT killed'}; "
          f"{time.perf_counter() - t0:.1f} s, 3 runs)")
    del params, eng

    # ---- (p2) MoE: moonshot-v1-16b-a3b --------------------------------------
    cfg = moe_cfg or get_config(MOE_ARCH)
    B, L, new = moe
    fresh_peak()
    held = torch.cuda.memory_allocated() / 1e9 if cuda else 0.0
    # the reckoned peak: bfloat16 weights (the router float32), the exact
    # cache, the float32 draw of the largest tensor, and what is held already
    def reckon(c):
        cache = 2 * c.n_layers * B * (L + new) * c.n_kv_heads * c.head_dim * 2
        router = c.n_layers * c.d_model * c.moe.n_experts * 2
        draw = max(c.moe.n_experts * c.d_model * c.moe.d_ff_expert, c.vocab_size * c.d_model)
        return (2 * reckoned_params(c) + router + cache + 4 * draw) / 1e9 + held
    full = reckon(cfg)
    if full > MOE_PEAK_GB:
        cfg = dataclasses.replace(cfg, n_layers=MOE_CUT_SB * len(cfg.pattern),
                                  n_superblocks=MOE_CUT_SB)
    print(f"  (p2) {cfg.name}: reckoned peak at full depth {full:.1f} GB ({held:.2f} GB held "
          f"before (p2)); running {cfg.n_superblocks} of "
          f"{(moe_cfg or get_config(MOE_ARCH)).n_superblocks} superblocks")
    params, t_init = wall(torch, lambda: MT.init_params(0, cfg, device=dev))
    n_params = MT.param_count(params)
    check(n_params == reckoned_params(cfg),
          f"(p2) {cfg.name}: {n_params} parameters ({MT.active_param_count(cfg, params)} "
          f"active a token), reckoned {reckoned_params(cfg)} ({gb(params):.2f} GB; drawn in "
          f"{t_init:.1f} s)")
    prompts = prompts_of(cfg, B, L, 22)
    eng = Engine(cfg, params, ServeConfig(max_len=L + new))
    eng.prefill_tokens(eng.new_cache(B), prompts[:, :64])         # warm-up, untimed
    (cache, _), tpre = wall(torch, lambda: eng.prefill_tokens(eng.new_cache(B), prompts))
    del cache
    runs = []
    for _ in range(2):
        (toks, cache), tgen = wall(torch, lambda: eng.generate(prompts, new))
        runs.append(toks)
        del cache
    tdec = tgen - tpre
    # a prefill's MoEMetrics, every MoE layer's, recorded around moe_forward
    mets = []
    forward_moe = moe_mod.moe_forward

    def recording(p, h, moe_cfg_):
        out, m = forward_moe(p, h, moe_cfg_)
        mets.append(m)
        return out, m

    moe_mod.moe_forward = recording
    try:
        (_, aux), tfwd = wall(torch, lambda: MT.forward(
            params, torch.as_tensor(prompts, dtype=torch.long, device=dev), cfg, remat="none"))
    finally:
        moe_mod.moe_forward = forward_moe
    dropped = torch.stack([m.dropped_fraction for m in mets]).float()
    print(f"  (p2) {cfg.name}: prefill {B}×{L} tokens {tpre * 1e3:.1f} ms; generate {new} "
          f"tokens {tgen * 1e3:.1f} ms, so decode {new - 1} steps {tdec * 1e3:.1f} ms = "
          f"{B * (new - 1) / tdec:.1f} tokens/s; a prefill's aux loss {aux.item():.5f} "
          f"(summed over {len(mets)} MoE layers), dropped fraction {dropped.mean().item():.5f} "
          f"(mean; {dropped.min().item():.5f}–{dropped.max().item():.5f} by layer), forward "
          f"{tfwd * 1e3:.1f} ms; peak device memory {peak_gb():.2f} GB; card: {smi}")
    check(len(mets) == cfg.n_layers and bool(torch.isfinite(aux)) and aux.item() > 0
          and 0.0 <= dropped.min().item() and dropped.max().item() < 1.0,
          f"(p2) aux loss and dropped fraction finite from all {cfg.n_layers} MoE layers")
    check(runs[0].shape == (B, new) and bool((runs[0] == runs[1]).all()),
          f"(p2) two identical generate runs give bitwise the same {B}×{new} tokens "
          f"(the deterministic combine)")
    del params, eng, mets, aux

    # ---- (p3) the conditioning input ----------------------------------------
    cfg = vlm_cfg or get_config(VLM_ARCH)
    B, n = vlm
    fresh_peak()
    params = MT.init_params(0, cfg, device=dev)
    g = torch.Generator().manual_seed(23)
    cond = torch.randn((B, cfg.cond_len, cfg.d_model), generator=g).to(dev)
    tok = torch.as_tensor(prompts_of(cfg, B, n, 24), dtype=torch.long, device=dev)
    logits, tpre = wall(torch, lambda: MT.prefill(params, tok, cfg, cond=cond))
    plain = MT.prefill(params, tok, cfg)
    check(tuple(logits.shape) == (B, cfg.vocab_size) and bool(logits.isfinite().all())
          and not torch.equal(logits, plain),
          f"(p3) {cfg.name} ({MT.param_count(params)} parameters): prefill of {B}×{n} tokens "
          f"after {cfg.cond_len} cond positions {tpre * 1e3:.1f} ms, logits finite and not "
          f"those without cond; peak {peak_gb():.2f} GB")
    del params, cond, tok, logits, plain

    cfg = aud_cfg or get_config(AUD_ARCH)
    B, n, steps = aud
    fresh_peak()
    tc = TS.TrainConfig(optimizer=AdamWConfig(lr_peak=1e-4, warmup_steps=1, total_steps=steps),
                        remat="full")
    state = TS.init_train_state(MT.init_params(0, cfg, device=dev), tc)
    g = torch.Generator().manual_seed(25)
    cond = torch.randn((B, cfg.cond_len, cfg.d_model), generator=g).to(dev)
    out = []
    for i in range(steps):
        tok = torch.as_tensor(prompts_of(cfg, B, n + 1, 26 + i), dtype=torch.long, device=dev)
        (state, mets), tstep = wall(torch, lambda: TS.train_step(
            state, tok[:, :-1], tok[:, 1:], i, cfg, tc, cond=cond))
        out.append((mets["loss"].item(), mets["tokens"].item(), tstep))
    print(f"  (p3) {cfg.name} ({MT.param_count(state.params)} parameters), {B}×{n} tokens "
          f"after {cfg.cond_len} cond positions, remat full: (loss, tokens, s) by step {out}; "
          f"peak {peak_gb():.2f} GB")
    check(all(math.isfinite(lo) and tk == B * n for lo, tk, _ in out),
          f"(p3) {cfg.name}: losses finite, {B * n} tokens counted a step (the cond "
          f"positions not)")
    del state, cond
    fresh_peak()
    print(f"  (p) {time.perf_counter() - t_all:.1f} s in all")


def xlstm_path(torch, dev, smi: str, *, cfg=None, serve=(XL_BATCH, XL_PROMPT, XL_NEW),
               resume=XL_RESUME, train=(XL_TRAIN_BATCH, XL_TRAIN_SEQ, XL_TRAIN_STEPS),
               check_len=(XL_SLSTM_L, XL_MLSTM_L)) -> None:
    """Path (q), the xLSTM blocks (``models/xlstm.py``) in ``cfg``
    (xlstm-125m) at full width and depth, weights from seed 0:

    (q1) served through ``Engine.generate`` (batch × prompt, ``new`` greedy
    tokens): prefill ms (the token scan), decode tokens/s, the cache bytes
    (the recurrent states); one decode step's device ms against its wall ms
    under the profiler, and its aten ops and host syncs from
    ``analysis.trace_report``; the sketched engine's tokens ≡ the exact
    engine's (no attention layer), and a request killed by the fault plan
    and resumed, bitwise.
    (q2) held against the plain forms on the card at full width, float32:
    the sLSTM ``autograd.Function`` against autograd through the token loop
    (L, B = ``check_len[0]``, 2; 1e-4 relative, the reference's bound) and
    the chunkwise mLSTM against the sequential recurrence (L =
    ``check_len[1]``; 2e-4).
    (q3) ``train[2]`` training steps of batch × seq tokens at
    ``remat="full"``, lr 1e-4: step ms, tokens/s, peak memory, the loss
    falling."""
    import dataclasses

    import numpy as np

    from repro_torch._util import tree_leaves
    from repro_torch.analysis import trace_report
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.models import model as MT
    from repro_torch.models import xlstm as XT
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.resilience import faults
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train import step as TS

    cuda = dev.type == "cuda"
    t_all = time.perf_counter()
    cfg = cfg or get_config(XL_ARCH)
    B, L, new = serve

    def nbytes(tree) -> int:
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
                   if isinstance(x, torch.Tensor))

    def fresh_peak():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")

    # ---- (q1) serving ---------------------------------------------------------
    params, t_init = wall(torch, lambda: MT.init_params(0, cfg, device=dev))
    n_params = MT.param_count(params)
    check(n_params == reckoned_params(cfg),
          f"(q1) {cfg.name}: {n_params} parameters, reckoned {reckoned_params(cfg)} "
          f"({nbytes(params) / 1e9:.3f} GB; drawn in {t_init:.1f} s)")
    g = torch.Generator().manual_seed(31)
    prompts = torch.randint(0, cfg.vocab_size, (B, L), generator=g).numpy().astype(np.int32)
    eng = Engine(cfg, params, ServeConfig(max_len=L + new))
    eng.prefill_tokens(eng.new_cache(B), prompts[:, :16])            # warm-up, untimed
    fresh_peak()
    # the engine's two phases timed apart, then the whole request
    (cache, logits), tpre = wall(torch, lambda: eng.prefill_tokens(eng.new_cache(B), prompts))
    tok0 = torch.argmax(logits, dim=-1)
    (dec_toks, cache), tdec = wall(torch, lambda: eng._decode(cache, tok0, L, new - 1))
    (toks, cache), tgen = wall(torch, lambda: eng.generate(prompts, new))
    print(f"  (q1) {cfg.name}: prefill {B}×{L} tokens {tpre * 1e3:.1f} ms (the token scan); "
          f"decode {new - 1} steps {tdec * 1e3:.1f} ms = {B * (new - 1) / tdec:.1f} tokens/s; "
          f"generate {new} tokens {tgen * 1e3:.1f} ms; cache {nbytes(cache) / 1e6:.3f} MB (the "
          f"recurrent states); peak {peak_gb():.2f} GB; card: {smi}")
    check(toks.shape == (B, new) and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
          and bool(logits.isfinite().all()) and (toks[:, 1:] == dec_toks).all(),
          f"(q1) {B}×{new} tokens in the vocabulary, prefill logits finite, generate's "
          "tokens the timed phases' bitwise")
    want = sum(t.numel() * t.element_size() for st in (
        XT.init_mlstm_state(cfg, B, device=dev), XT.init_slstm_state(cfg, B, device=dev))
        for t in st) * cfg.n_superblocks
    check(nbytes(cache) == want, f"(q1) cache {nbytes(cache)} B, reckoned {want} B")
    # one decode step: device ms against wall ms, its aten ops and host syncs
    pos, last = L + new - 1, torch.as_tensor(toks[:, -1], dtype=torch.long, device=dev)
    step = lambda: MT.decode_step(params, cache, last, pos, cfg)     # noqa: E731
    step()
    rep = trace_report(step)
    if cuda:
        wms, dms, top, _ = profiled(torch, step)
        (_, _), tstep = wall(torch, step)
        print(f"  (q1) one decode step: {tstep * 1e3:.2f} ms wall ({wms:.2f} under the "
              f"profiler), device {dms:.3f} ms ({1 - dms / (tstep * 1e3):.1%} idle); "
              f"{rep.eqn_count} aten ops, {len(rep.host_syncs)} host syncs, "
              f"{rep.kernel_dispatches} kernel dispatches, {rep.flops / 1e9:.2f} GFLOP; "
              f"top kernels {top}")
    check(not rep.host_syncs and rep.kernel_dispatches == 0,
          f"(q1) a decode step: host syncs {rep.host_syncs}, kernel dispatches "
          f"{rep.kernel_dispatches} (none expected)")
    del cache
    # the sketched engine: no attention layer, so the exact engine's tokens
    short = prompts[:, :resume]
    kw = dict(max_len=resume + 12, temperature=0.7, seed=3)
    ref_toks, _ = Engine(cfg, params, ServeConfig(**kw)).generate(short, 12)
    sk_toks, _ = Engine(cfg, params, ServeConfig(use_sketch=True, **kw)).generate(short, 12)
    check(bool((ref_toks == sk_toks).all()),
          f"(q1) use_sketch=True gives the exact engine's {B}×12 sampled tokens bitwise")
    with tempfile.TemporaryDirectory() as ckdir:
        os.environ[faults.ENV_PLAN] = '{"decode.step": {"action": "kill", "at": 2}}'
        faults.reset()
        killed = False
        try:
            Engine(cfg, params, ServeConfig(ckpt_dir=ckdir, ckpt_every=4, **kw)).generate(
                short, 12, request_id="r")
        except faults.DeviceLost:
            killed = True
        finally:
            del os.environ[faults.ENV_PLAN]
            faults.reset()
        eng = Engine(cfg, params, ServeConfig(ckpt_dir=ckdir, ckpt_every=4, **kw))
        rtoks, _ = eng.generate(short, 12, request_id="r")
    check(killed and bool((rtoks == ref_toks).all()) and eng.health.count("ckpt.resume") == 1,
          f"(q1) a {resume}-token request killed by the decode.step plan and resumed: the "
          f"same 12 tokens bitwise ({'killed' if killed else 'NOT killed'})")

    # ---- (q2) the plain forms, float32 at full width -------------------------
    f32 = lambda tree: {k: v.float() for k, v in tree.items()}      # noqa: E731
    pm = f32(MT._unstack(params["blocks"]["pos0"], cfg.n_superblocks)[0]["mixer"])
    ps = f32(MT._unstack(params["blocks"]["pos1"], cfg.n_superblocks)[0]["mixer"])
    Ls, Lm = check_len
    gq = torch.Generator().manual_seed(32)
    HD = cfg.n_heads * cfg.head_dim
    xs = [torch.randn((Ls, 2, HD), generator=gq).to(dev) for _ in range(4)]
    gy = torch.randn((Ls, 2, cfg.n_heads, cfg.head_dim), generator=gq).to(dev)
    R = [ps[k] for k in ("rz", "ri", "rf", "rog")]

    def grads(fn):
        Rt = [r.clone().requires_grad_() for r in R]
        fb = ps["f_bias"].clone().requires_grad_()
        xt = [x.clone().requires_grad_() for x in xs]
        hs = fn(Rt, fb, *xt)
        (hs * gy).sum().backward()
        return [hs.detach()] + [t.grad for t in Rt + [fb] + xt]

    (got, tf), (want_g, tp) = (wall(torch, lambda fn=fn: grads(fn))
                               for fn in (XT.slstm_scan, XT.slstm_scan_plain))
    rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(got, want_g))
    check(rel < 1e-4, f"(q2) the sLSTM Function against autograd through the token loop, "
                      f"L={Ls} B=2 H={cfg.n_heads} Dh={cfg.head_dim} float32: outputs and all 9 "
                      f"gradients within {rel:.2e} relative (tol 1e-4); {tf * 1e3:.1f} ms "
                      f"against {tp * 1e3:.1f} ms")
    x = torch.randn((2, Lm, cfg.d_model), generator=gq).to(dev)
    ych, tch = wall(torch, lambda: XT.mlstm_forward(pm, x, cfg))
    ysq, tsq = wall(torch, lambda: XT._mlstm_forward_seq(pm, x, cfg))
    ea, er, ok = close(ych, ysq, 2e-4)
    check(ok, f"(q2) the chunkwise mLSTM (chunk 64) against the sequential recurrence, "
              f"L={Lm} float32: max abs {ea:.3e}, /max|plain| {er:.3e} (tol 2e-4); "
              f"{tch * 1e3:.1f} ms against {tsq * 1e3:.1f} ms")
    del pm, ps, xs, gy, R, got, want_g, x, ych, ysq

    # ---- (q3) training ---------------------------------------------------------
    tb, ts, n_steps = train
    tc = TS.TrainConfig(optimizer=AdamWConfig(lr_peak=1e-4, warmup_steps=0,
                                              total_steps=n_steps), remat="full")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=ts, global_batch=tb)
    del eng
    fresh_peak()
    state = TS.init_train_state(params, tc)
    del params
    losses, ms = [], []
    for i in range(n_steps):
        tok, lab = global_batch(dc, i, device=dev)
        t0 = time.perf_counter()
        state, mets = TS.train_step(state, tok, lab, i, cfg, tc)
        losses.append(mets["loss"].item())            # ends in a synchronization
        ms.append((time.perf_counter() - t0) * 1e3)
    # the first batch again, under the trained parameters: the step losses
    # are of other batches, whose spread hides a few steps' fall
    tok, lab = global_batch(dc, 0, device=dev)
    with torch.no_grad():
        after = MT.loss_fn(state.params, tok, lab, cfg, remat="none")[0].item()
    print(f"  (q3) {cfg.name} training {tb}×{ts} tokens, remat full, lr 1e-4: losses "
          f"{[round(v, 4) for v in losses]}, batch 0 after the steps {after:.4f}; step ms "
          f"{[round(v, 1) for v in ms]} ({tb * ts / (ms[-1] / 1e3):.1f} tokens/s at the last); "
          f"peak {peak_gb():.2f} GB; card: {smi}")
    check(all(np.isfinite(losses)) and after < losses[0],
          f"(q3) the loss of batch 0 falls over {n_steps} steps: {losses[0]:.4f} -> "
          f"{after:.4f}")
    del state
    fresh_peak()
    print(f"  (q) {time.perf_counter() - t_all:.1f} s")


def contracts_path(torch, dev, smi: str) -> list:
    """Path (r), the trace contracts (``repro_torch.analysis``) on the card:
    ``run_check(device="cuda")``, one line a contract.  Each probe runs
    once to warm up, then recorded with autotuning off, under
    ``torch.cuda.set_sync_debug_mode("error")`` where its contract allows
    no host sync; the kernels' launches must equal the dispatches × each
    router's launches, and the device memory's rise stay within the
    budget expression.  The RNG sweep must find every generator site
    registered.  Returns the contracts' results."""
    from repro_torch.analysis import contracts as CT

    t0 = time.perf_counter()
    results, sweep, _ = CT.run_check(device=dev.type)
    for res in results:
        r = res.report
        line = (f"peak {res.measured_peak_bytes} B, dispatches {r.get('kernel_dispatches')}, "
                f"launches {r.get('kernel_launches')}, host syncs {r.get('host_syncs')}, "
                f"aten ops {r.get('eqn_count')}, memory rise {r.get('memory_rise_bytes')} B, "
                f"donation {r.get('donation_verified')}"
                if res.status != "skipped" else r.get("reason", ""))
        check(res.status in ("pass", "skipped"),
              f"(r) {res.name}: {res.status}; {line}; {'; '.join(res.violations)}")
    check(not sweep, f"(r) the RNG sweep: {len(sweep)} unregistered site(s) "
                     f"{[(s.path, s.lineno) for s in sweep]}")
    print(f"  (r) {len(results)} contracts, "
          f"{sum(r.status == 'pass' for r in results)} passed, "
          f"{sum(r.status == 'skipped' for r in results)} skipped; "
          f"{time.perf_counter() - t0:.1f} s; card: {smi}")
    return results


def grad_summary(torch, grads, n_samples: int = S_SAMPLES) -> dict:
    """Each gradient leaf's float64 norm and its entries at ``n_samples``
    fixed flat indices (a CPU generator seeded by the leaf's number), as
    lists.  A sharded leaf (a DTensor) is summed and sampled where its
    shards lie: each rank reads the sampled entries in its own box (the
    first replica of a replicated axis only) and one ``all_reduce`` adds
    them up, so no leaf is gathered whole."""
    import torch.distributed as dist

    from repro_torch import sharding as sh
    from torch.distributed.tensor import Replicate

    norms, samples = [], []
    from torch.distributed.tensor import Partial

    for i, g in enumerate(grads):
        idx = torch.randint(0, g.numel(), (n_samples,),
                            generator=torch.Generator().manual_seed(1000 + i))
        if sh.is_dtensor(g) and any(isinstance(q, Partial) for q in g.placements):
            g = g.redistribute(g.device_mesh, [Replicate() if isinstance(q, Partial) else q
                                               for q in g.placements])
        norms.append(float(sh.full(torch.sum(g.double() ** 2)).sqrt()))
        if not sh.is_dtensor(g):
            samples.append(g.reshape(-1)[idx.to(g.device)].double().cpu().tolist())
            continue
        dm, pls = g.device_mesh, list(g.placements)
        coord = dm.get_coordinate()
        box = sh.local_box(g.shape, dm, pls)
        multi = torch.stack(torch.unravel_index(idx, tuple(g.shape)), dim=1)   # (k, ndim)
        lo = torch.tensor([b[0] for b in box])
        hi = torch.tensor([b[1] for b in box])
        first = all(c == 0 for c, pl in zip(coord, pls) if isinstance(pl, Replicate))
        mine = ((multi >= lo) & (multi < hi)).all(dim=1) & first
        local = g.to_local()
        vals = torch.zeros(n_samples, dtype=torch.float64, device=local.device)
        if bool(mine.any()):
            at = tuple((multi[mine] - lo).T.to(local.device))
            vals[mine.to(local.device)] = local[at].double()
        dist.all_reduce(vals)
        samples.append(vals.cpu().tolist())
    return {"norms": norms, "samples": samples}


def summary_errors(got: dict, want: dict, names: list, expert) -> tuple[float, float, list]:
    """(largest norm error and largest sampled-entry error, each over the
    leaf's largest sampled entry, and the leaves outside their tolerance:
    ``expert(name)`` picks the bfloat16 one)."""
    import numpy as np

    worst_n = worst_s = 0.0
    bad = []
    for i, name in enumerate(names):
        w = np.asarray(want["samples"][i])
        scale = max(float(np.abs(w).max()), 1e-30)
        en = abs(got["norms"][i] - want["norms"][i]) / max(want["norms"][i], 1e-30)
        es = float(np.abs(np.asarray(got["samples"][i]) - w).max()) / scale
        worst_n, worst_s = max(worst_n, en), max(worst_s, es)
        if max(en, es) > (S_EXPERT_TOL if expert(name) else S_TOL):
            bad.append((name, round(en, 9), round(es, 9)))
    return worst_n, worst_s, bad


def leaf_names(tree: dict, prefix: str = "") -> list:
    """Flat "/"-joined names of a parameter dict's leaves in ``tree_leaves``
    order."""
    out = []
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        out += leaf_names(tree[k], path) if isinstance(tree[k], dict) else [path]
    return out


def is_expert(name: str) -> bool:
    """Whether a parameter is an MoE expert stack (its gradient goes through
    the a2a path's bfloat16 gather)."""
    return "/ffn/" in f"/{name}/" and name.rsplit("/", 1)[-1] in ("wi_gate", "wi_up", "wo")


# (s2)'s reduced checks against one process (rank 0's): a "dp_only" step of
# reduced xlstm-125m (float32 state) on 16 × 32 tokens in 4 microbatches,
# each placed as the batch (the loss at 1e-6 relative, the gradient norm at
# 1e-5 relative, AdamW's first moment at 1e-5 of each leaf's largest
# entry), and a sketched prefill of reduced stablelm-3b (float32, 2 × 64
# tokens) into a cache split on its slots over both axes (the logits at
# 1e-5 of their largest entry, the cache bit for bit); an exact prefill of
# the same tokens and one decode step at position 64 over a cache of
# S_EXACT_LEN positions placed by cache_shardings (the batch on data, the
# positions on model: the second model rank's [96, 192) hold no valid
# position; both steps' logits at 1e-5 of their largest entry, the cache at
# 1e-6 of its largest), and a reduced zamba2-7b training step of 4 × 32
# tokens in 2 microbatches (float32 state; loss, gradient norm and first
# moment as the "dp_only" step's)
S_MICRO_ARCH, S_MICRO, S_MICRO_BATCH_SEQ = "xlstm-125m", 4, (16, 32)
S_PREFILL_ARCH, S_PREFILL_BATCH_SEQ = "stablelm-3b", (2, 64)
S_EXACT_LEN = 192
S_SSM_ARCH, S_SSM_MICRO, S_SSM_BATCH_SEQ = "zamba2-7b", 2, (4, 32)


def mesh2d_reduced(torch, mesh, rank: int) -> dict:
    """(s2)'s reduced checks on this rank's share of the (data 2, model 2)
    mesh, with rank 0's one-process results and errors: {"micro_s",
    "prefill_s", "exact_s", "ssm_s", "digest" (the gathered results', equal
    on every rank), and on rank 0 "micro", "prefill", "exact" and "ssm"}."""
    import hashlib

    from repro_torch import sharding as sh
    from repro_torch._util import tree_leaves, tree_map
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.sketched_attention import decode_slot_table
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.models.model import decode_step, init_cache, init_params, prefill_with_cache
    from repro_torch.train import step as TS

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    def batch(cfg, b, n):
        return global_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=n,
                                       global_batch=b), 0, device="cpu")

    res, whole = {}, []

    def step(cfg, tc, tok, lab, mesh_=None):
        state = TS.init_train_state(init_params(0, cfg, device="cpu", dtype=torch.float32), tc)
        if mesh_ is not None:
            state = TS.place_train_state(state, mesh_, cfg.sharding_policy)
        state, mets = TS.train_step(state, tok, lab, 0, cfg, tc, mesh=mesh_)
        return ([sh.full(mets[k]) for k in ("loss", "grad_norm")],
                [sh.full(m) for m in tree_leaves(state.opt.m)])

    def stepped(name, arch, n_micro, batch_seq):
        # a float32 training step on the mesh, and on rank 0 in one process
        cfg = reduced(get_config(arch))
        args = (cfg, TS.TrainConfig(n_micro=n_micro), *batch(cfg, *batch_seq))
        t0 = time.perf_counter()
        got = step(*args, mesh)
        res[f"{name}_s"] = time.perf_counter() - t0
        whole.extend(got[0] + got[1])
        if rank == 0:
            want = step(*args)
            res[name] = dict(loss_rel=rel(got[0][0], want[0][0]),
                             norm_rel=rel(got[0][1], want[0][1]),
                             m_err=max(rel(a, b) for a, b in zip(got[1], want[1])))

    # a "dp_only" step in S_MICRO microbatches
    stepped("micro", S_MICRO_ARCH, S_MICRO, S_MICRO_BATCH_SEQ)
    # a sketched prefill into a cache split on its slots over both axes
    cfg = reduced(get_config(S_PREFILL_ARCH))
    B, L = S_PREFILL_BATCH_SEQ
    sa = cfg.sketch_attn
    table = decode_slot_table(0, L, sa.d_slots, sa.m_r)
    tok, _ = batch(cfg, B, L)
    slots = (None, None, ("data", "model"), None)

    def prefill(mesh_=None):
        params = init_params(0, cfg, device="cpu", dtype=torch.float32)
        cache = init_cache(cfg, B, L, dtype=torch.float32, use_sketch=True, device="cpu")
        t = tok
        if mesh_ is not None:
            params = sh.shard_tree(params, mesh_, sh.params_shardings(mesh_, params))
            cache = tree_map(lambda x: sh.distribute(x, mesh_, slots[:x.ndim]), cache)
            t = sh.distribute(tok, mesh_, sh.batch_spec(mesh_, B))
        with torch.no_grad(), (mesh_ if mesh_ is not None else contextlib.nullcontext()):
            logits, cache = prefill_with_cache(params, t, cfg, cache, slot_table=table)
        return sh.full(logits), [sh.full(x) for x in tree_leaves(cache)]

    t0 = time.perf_counter()
    got = prefill(mesh)
    res["prefill_s"] = time.perf_counter() - t0
    whole += [got[0], *got[1]]
    if rank == 0:
        want = prefill()
        res["prefill"] = dict(logit_err=rel(got[0], want[0]),
                              cache_bitwise=all(torch.equal(a, b)
                                                for a, b in zip(got[1], want[1])))
    # an exact prefill and one decode step over a cache of S_EXACT_LEN
    # positions placed by cache_shardings (positions on "model")
    nxt = tok[:, -1].contiguous()

    def exact(mesh_=None):
        params = init_params(0, cfg, device="cpu", dtype=torch.float32)
        cache = init_cache(cfg, B, S_EXACT_LEN, dtype=torch.float32, device="cpu")
        t, n = tok, nxt
        if mesh_ is not None:
            params = sh.shard_tree(params, mesh_, sh.params_shardings(mesh_, params))
            cache = tree_map(lambda x: sh.distribute(x, mesh_, tuple(sh.cache_shardings(
                mesh_, x[None], B)[1:])), cache)
            t, n = (sh.distribute(x, mesh_, sh.batch_spec(mesh_, B)) for x in (tok, nxt))
        with torch.no_grad(), (mesh_ if mesh_ is not None else contextlib.nullcontext()):
            first, cache = prefill_with_cache(params, t, cfg, cache)
            second, cache = decode_step(params, cache, n, L, cfg)
        return [sh.full(first), sh.full(second)], [sh.full(x) for x in tree_leaves(cache)]

    t0 = time.perf_counter()
    got = exact(mesh)
    res["exact_s"] = time.perf_counter() - t0
    whole += got[0] + got[1]
    if rank == 0:
        want = exact()
        res["exact"] = dict(logit_err=max(rel(a, b) for a, b in zip(got[0], want[0])),
                            cache_err=max(rel(a, b) for a, b in zip(got[1], want[1])))
    # a zamba2-7b step in S_SSM_MICRO microbatches
    stepped("ssm", S_SSM_ARCH, S_SSM_MICRO, S_SSM_BATCH_SEQ)
    res["digest"] = hashlib.sha1(b"".join(x.detach().contiguous().numpy().tobytes()
                                          for x in whole)).hexdigest()
    return res


def mesh2d_configs(batch_seq=None):
    """(moonshot cut to S_SB superblocks, stablelm-3b cut to S_SB layers,
    (batch, seq)): full widths."""
    import dataclasses

    from repro_torch.configs import get_config

    return tuple(dataclasses.replace(get_config(a), n_layers=S_SB, n_superblocks=S_SB)
                 for a in (S_MOE_ARCH, S_DENSE_ARCH)) + (batch_seq or (S_BATCH, S_SEQ),)


def loss_and_grads(torch, params, tok, lab, cfg):
    """(loss, gradients in ``tree_leaves`` order) of ``loss_fn`` at
    ``remat="full"``."""
    from repro_torch._util import tree_leaves, tree_map
    from repro_torch.models.model import loss_fn

    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    it = iter(leaves)
    loss, _ = loss_fn(tree_map(lambda _: next(it), params), tok, lab, cfg, remat="full")
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss.detach(), list(grads)


def mesh2d_rank(rank: int, size: int, store: str, out: str) -> int:
    """One rank of path (s2): ``chip_smoke.py --mesh2d-rank RANK SIZE STORE
    OUT``.  Joins a gloo group of ``size`` ranks on the FileStore ``store``
    with its tensors on the CPU, makes the (data 2, model 2)
    mesh, and for each model draws its float32 weights from seed 0, places
    them by ``params_shardings``, and computes the loss and the gradients of
    the ``batch_spec``-sharded batch, summarised by ``grad_summary``; then
    the nothing-dropped MoE layer against ``moe_forward_local``, and one
    bfloat16 AdamW step of moonshot's sharded state.  Writes what it found
    to ``out`` (JSON)."""
    import hashlib
    import resource
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import sharding as sh
    from repro_torch._util import tree_leaves, tree_map
    from repro_torch.configs.base import MoECfg
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe as MO
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as TS

    dev = torch.device("cpu")
    torch.set_num_threads(max(1, (os.cpu_count() or size) // size))
    dist.init_process_group("gloo", store=dist.FileStore(store, size), rank=rank,
                            world_size=size, timeout=timedelta(seconds=120))
    res: dict = {"rank": rank, "device": str(dev)}

    def peak_gb():
        # the resident set's high-water mark since the rank started
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6

    mets, a2a = [], []
    forward_moe, forward_a2a = MO.moe_forward, MO._moe_forward_a2a

    def recording(p, h, moe_cfg_):
        # each forward MoE call's metrics and whether it took the a2a path
        # (remat="full" runs the layers again in the backward: not recorded)
        n0 = len(a2a)
        o, m = forward_moe(p, h, moe_cfg_)
        mets.append((m, len(a2a) > n0))
        return o, m

    def counting(*args):
        a2a.append(1)
        return forward_a2a(*args)

    # the weights are drawn on the card, the same numbers as (s1)'s, and held
    # on the CPU
    draw_dev = torch.device("cuda", 0) if torch.cuda.is_available() else dev

    def draw(cfg, dtype=torch.float32):
        p = init_params(0, cfg, device=draw_dev, dtype=dtype)
        if draw_dev != dev:
            p = tree_map(lambda t: t.to(dev), p)
            torch.cuda.empty_cache()
        return p

    try:
        mesh = make_debug_mesh(*S_SHAPE, device=dev)
        moe_cfg, dense_cfg, (B, L) = mesh2d_configs(json.loads(os.environ["S_BATCH_SEQ"]))
        for cfg in (moe_cfg, dense_cfg):
            params = draw(cfg)
            if cfg.moe is not None:
                # superblock 0's MoE layer, for the nothing-dropped check
                layer = {k: v[0].clone() for k, v in params["blocks"]["pos0"]["ffn"].items()}
            params = sh.shard_tree(params, mesh, sh.params_shardings(mesh, params))
            tok, lab = global_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=L,
                                               global_batch=B), 0, device=dev)
            tok, lab = (sh.distribute(t, mesh, sh.batch_spec(mesh, B)) for t in (tok, lab))
            mets.clear()
            a2a.clear()
            MO.moe_forward, MO._moe_forward_a2a = recording, counting
            try:
                t0 = time.perf_counter()
                with mesh:
                    loss, grads = loss_and_grads(torch, params, tok, lab, cfg)
                dt = time.perf_counter() - t0
            finally:
                MO.moe_forward, MO._moe_forward_a2a = forward_moe, forward_a2a
            summ = grad_summary(torch, grads)
            res[cfg.name] = dict(
                loss=float(sh.full(loss)), ms=dt * 1e3, peak_gb=peak_gb(),
                digest=hashlib.sha1(json.dumps([float(sh.full(loss)), summ]).encode())
                .hexdigest(), **summ,
                aux=[float(sh.full(m.aux_loss)) for m, _ in mets],
                dropped=[float(sh.full(m.dropped_fraction)) for m, _ in mets],
                a2a=sum(took for _, took in mets))
            del params, grads, loss, tok, lab
        # the nothing-dropped configuration: superblock 0's MoE layer of
        # moonshot's float32 weights, the experts rounded to bfloat16 (the a2a
        # path gathers them so), a capacity that takes every entry
        # (capacity_factor = E / K: C = T)
        E, K = moe_cfg.moe.n_experts, moe_cfg.moe.top_k
        nd = MoECfg(n_experts=E, top_k=K, d_ff_expert=moe_cfg.moe.d_ff_expert,
                    capacity_factor=E / K)
        p = {k: v.bfloat16().float() if k in ("wi_gate", "wi_up", "wo") else v
             for k, v in layer.items()}
        del layer
        Bn, Ln = S_NODROP
        h = 0.5 * torch.randn((Bn, Ln, moe_cfg.d_model), device=dev,
                              generator=torch.Generator(device=dev).manual_seed(5))
        pp = {k: sh.distribute(v, mesh, sh.param_spec(mesh, f"ffn/{k}", tuple(v.shape)))
              for k, v in p.items()}
        hh = sh.distribute(h, mesh, sh.batch_spec(mesh, Bn, extra_dims=2))
        ws = [pp[k].requires_grad_() for k in ("wi_gate", "wi_up", "wo")]
        with mesh:
            o, m = MO.moe_forward(pp, hh, nd)
            ga = torch.autograd.grad(torch.sum(o ** 2) + m.aux_loss, ws)
        o, ga = sh.full(o).detach(), [sh.full(g) for g in ga]
        res["nodrop"] = {"dropped": float(sh.full(m.dropped_fraction))}
        if rank == 0:
            wl = [p[k].requires_grad_() for k in ("wi_gate", "wi_up", "wo")]
            ol, ml = MO.moe_forward_local(p, h, nd)
            gl = torch.autograd.grad(torch.sum(ol ** 2) + ml.aux_loss, wl)
            res["nodrop"].update(
                out_err=float((o - ol).abs().max() / ol.abs().max()),
                grad_err=[float((a - b).abs().max() / b.abs().max()) for a, b in zip(ga, gl)])
        del p, pp, hh, ws, o, ga, h
        # one bfloat16 AdamW step of moonshot's sharded state
        tc = TS.TrainConfig(optimizer=AdamWConfig(**TRAIN_OPT, total_steps=10), remat="full")
        # placed before the optimizer state is made, so that no rank holds the
        # whole float32 state: m, v and master inherit the parameters'
        # placements, which must be opt_shardings'
        params = draw(moe_cfg, torch.bfloat16)
        psh = sh.params_shardings(mesh, params)
        state = TS.init_train_state(sh.shard_tree(params, mesh, psh), tc)
        del params
        osh = sh.opt_shardings(mesh, state.opt, psh)
        res["opt_placed"] = all(
            list(x.placements) == sh.placements(mesh, spec)
            for tree, specs in ((state.opt.m, osh.m), (state.opt.v, osh.v),
                                (state.opt.master, osh.master))
            for x, spec in zip(tree_leaves(tree), sh._spec_leaves(specs)))
        tok, lab = global_batch(DataConfig(vocab_size=moe_cfg.vocab_size, seq_len=L,
                                           global_batch=B), 0, device=dev)
        mets.clear()
        MO.moe_forward = recording
        try:
            t0 = time.perf_counter()
            state, smets = TS.train_step(state, tok, lab, 0, moe_cfg, tc, mesh=mesh)
            dt = time.perf_counter() - t0
        finally:
            MO.moe_forward = forward_moe
        res["step"] = dict(
            ms=dt * 1e3, peak_gb=peak_gb(), loss=float(smets["loss"]),
            grad_norm=float(smets["grad_norm"]),
            local_gb=sum(x.to_local().numel() * x.to_local().element_size() for x in
                         tree_leaves((state.params, state.opt.m, state.opt.v,
                                      state.opt.master))) / 1e9,
            aux=[float(sh.full(m.aux_loss)) for m, _ in mets],
            dropped=[float(sh.full(m.dropped_fraction)) for m, _ in mets],
            digest=digest(sh.full(state.params["embed"]).float().cpu()))
        del state
        res["reduced"] = mesh2d_reduced(torch, mesh, rank)
    finally:
        dist.destroy_process_group()
    Path(out).write_text(json.dumps(res))
    return 0


def mesh2d_path(torch, dev, smi: str, *, batch_seq=S_CPU_BATCH_SEQ,
                timeout: float = S_TIMEOUT) -> None:
    """Path (s), the 2-D parameter mesh (``repro_torch.sharding``, the
    models' ``constrain`` calls, the expert-parallel MoE, the sharded train
    step).

    (s1) One process, NCCL, the card: moonshot-v1-16b-a3b at full width cut
    to S_SB superblocks, float32 weights from seed 0, batch × seq tokens:
    the loss and the gradients on a 1 × 1 ("data", "model") mesh against
    the same call with no mesh, bit for bit; the plain version of the a2a
    path at (s2)'s data 2 and model 2 (``moe_forward`` swapped for
    ``moe_forward_a2a_plain`` where that mesh takes the a2a path), and
    stablelm-3b cut
    to S_SB layers with no mesh, both summarised for (s2)
    (``grad_summary``); one bfloat16 AdamW step with no mesh, timed.  Wall
    and device ms, peak memory.
    (s2) Four gloo ranks sharing the card (``--mesh2d-rank``, started
    together with a time limit; NCCL refuses two ranks on one device), their
    tensors on the CPU, at ``batch_seq`` tokens: both models on the (2, 2)
    mesh against (s1)'s results;
    every replicated output bitwise equal across the ranks; the
    nothing-dropped MoE layer against ``moe_forward_local``; one bfloat16
    AdamW step of moonshot's sharded state, with its ms, each rank's peak
    memory against the reckoned share, aux and dropped."""
    import numpy as np

    from repro_torch import sharding as sh
    from repro_torch.core import distributed as DM
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.models import moe as MO
    from repro_torch.models.model import init_params, param_count
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as TS

    t_all = time.perf_counter()
    moe_cfg, dense_cfg, (B, L) = mesh2d_configs(batch_seq)
    cuda = dev.type == "cuda"

    def fresh_peak():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")

    def batch(cfg, b=B, n=L):
        return global_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=n,
                                       global_batch=b), 0, device=dev)

    def draw(cfg):
        # the ranks draw the same numbers on the card and hold them on the CPU
        return init_params(0, cfg, device=dev, dtype=torch.float32)

    # ---- (s1) one process, NCCL, the card ------------------------------------
    fresh_peak()
    params = draw(moe_cfg)
    n_params = param_count(params)
    check(n_params == reckoned_params(moe_cfg),
          f"(s1) {moe_cfg.name} at full width, {moe_cfg.n_superblocks} superblocks: "
          f"{n_params} float32 parameters, reckoned {reckoned_params(moe_cfg)}")
    tok, lab = batch(moe_cfg, S_BATCH, S_SEQ)
    res0 = {}

    def run0():
        res0["v"] = loss_and_grads(torch, params, tok, lab, moe_cfg)

    w0, d0, _, _ = profiled(torch, run0)
    loss0, g0 = res0.pop("v")
    pk0 = peak_gb()
    dmesh = DM.make_data_mesh(device=dev)          # a one-rank NCCL group
    try:
        mesh = sh.make_mesh((1, 1), ("data", "model"), device=dev)
        pm = sh.shard_tree(params, mesh, sh.params_shardings(mesh, params))
        tm, lm = (sh.distribute(t, mesh, sh.batch_spec(mesh, S_BATCH)) for t in (tok, lab))

        def run1():
            with mesh:
                res0["v"] = loss_and_grads(torch, pm, tm, lm, moe_cfg)

        w1, d1, _, _ = profiled(torch, run1)
        loss1, g1 = res0.pop("v")
        loss1, g1 = sh.full(loss1), [sh.full(g) for g in g1]
        names = leaf_names(params)
        differ = [n for n, a, b in zip(names, g1, g0) if not torch.equal(a, b)]
        worst = max([0.0] + [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                             for a, b in zip(g1, g0)])
        print(f"  (s1) {moe_cfg.name} float32 loss and gradients of {S_BATCH}×{S_SEQ} tokens: "
              f"no mesh "
              f"{w0:.1f} ms wall, {d0:.1f} ms device; on the 1 × 1 (data, model) mesh "
              f"{w1:.1f} ms wall, {d1:.1f} ms device; peak {max(pk0, peak_gb()):.2f} GB; card: "
              f"{smi}")
        check(torch.equal(loss1, loss0) and (not differ or worst <= 1e-6),
              f"(s1) the 1 × 1 mesh's loss {loss1.item():.6f} "
              f"{'bitwise' if torch.equal(loss1, loss0) else 'NOT bitwise'} the no-mesh "
              f"{loss0.item():.6f}; gradients bitwise but {differ} (largest error over the "
              f"leaf's largest entry {worst:.3e}, tol 1e-6)")
        del pm, g1, tm, lm
    finally:
        dmesh.close()
    del g0
    fresh_peak()
    # check 2: the plain version of the a2a path at (s2)'s data 2 and model 2,
    # on (s2)'s batch
    tok, lab = batch(moe_cfg)
    forward = MO.moe_forward

    def plain_a2a(p, h, moe):
        if MO._use_a2a(moe, *h.shape, *S_SHAPE):
            return MO.moe_forward_a2a_plain(p, h, moe, *S_SHAPE)
        return MO.moe_forward_local(p, h, moe)

    MO.moe_forward = plain_a2a
    try:
        (loss2, g2), t2 = wall(torch, lambda: loss_and_grads(torch, params, tok, lab, moe_cfg))
    finally:
        MO.moe_forward = forward
    ref = {moe_cfg.name: dict(loss=loss2.item(), **grad_summary(torch, g2)),
           "names": {moe_cfg.name: leaf_names(params)}}
    print(f"  (s1) the plain a2a path (data {S_SHAPE[0]}, model {S_SHAPE[1]}) on (s2)'s "
          f"{B}×{L} tokens: loss {loss2.item():.6f}; {t2 * 1e3:.1f} ms; peak {peak_gb():.2f} GB")
    del params, g2, tok, lab
    fresh_peak()
    # stablelm-3b's one-process result
    params = draw(dense_cfg)
    tok, lab = batch(dense_cfg)
    (loss3, g3), t3 = wall(torch, lambda: loss_and_grads(torch, params, tok, lab, dense_cfg))
    ref[dense_cfg.name] = dict(loss=loss3.item(), **grad_summary(torch, g3))
    ref["names"][dense_cfg.name] = leaf_names(params)
    print(f"  (s1) {dense_cfg.name} at full width, {dense_cfg.n_layers} layers "
          f"({param_count(params)} float32 parameters), {B}×{L} tokens: loss {loss3.item():.6f}, "
          f"{t3 * 1e3:.1f} ms, peak {peak_gb():.2f} GB")
    del params, g3, tok, lab
    fresh_peak()
    # check 3: one bfloat16 AdamW step with no mesh
    tc = TS.TrainConfig(optimizer=AdamWConfig(**TRAIN_OPT, total_steps=10), remat="full")
    state = TS.init_train_state(init_params(0, moe_cfg, device=dev), tc)
    tok, lab = batch(moe_cfg, S_BATCH, S_SEQ)
    (state, smets), ts = wall(torch, lambda: TS.train_step(state, tok, lab, 0, moe_cfg, tc))
    print(f"  (s1) one bfloat16 AdamW step of {moe_cfg.name} with no mesh: {ts * 1e3:.1f} ms, "
          f"loss {smets['loss'].item():.6f}, peak {peak_gb():.2f} GB")
    check(bool(torch.isfinite(smets["loss"])), "(s1) the bfloat16 step's loss is finite")
    del state, smets, tok, lab
    fresh_peak()

    # ---- (s2) four gloo ranks sharing the card ---------------------------------
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh2d_"))
    env = dict(os.environ, REPRO_AUTOTUNE="0", S_BATCH_SEQ=json.dumps([B, L]))
    size = S_SHAPE[0] * S_SHAPE[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mesh2d-rank",
                               str(r), str(size), str(tmp / "store"), str(tmp / f"r{r}.json")],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(size)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0])
    t2 = time.perf_counter() - t0
    ok2 = all(p.returncode == 0 for p in procs)
    where = "ranks on the CPU"
    check(ok2, f"(s2) four gloo ranks ({where}) ran to their end in {t2:.1f} s (limit "
               f"{timeout} s): exit codes {[p.returncode for p in procs]}")
    if not ok2:
        for r, log in enumerate(logs):
            print(f"  (s2) rank {r} output:\n{log[-3000:]}")
        print(f"  (s) {time.perf_counter() - t_all:.1f} s")
        return
    reps = [json.loads((tmp / f"r{r}.json").read_text()) for r in range(size)]
    print(f"  (s2) {where} (gloo, {reps[0]['device']}), a (data {S_SHAPE[0]}, model "
          f"{S_SHAPE[1]}) mesh, {B}×{L} tokens; {t2:.1f} s in all; card: {smi}")
    for cfg in (moe_cfg, dense_cfg):
        got = [r[cfg.name] for r in reps]
        want = ref[cfg.name]
        en, es, bad = summary_errors(got[0], want, ref["names"][cfg.name], is_expert)
        lerr = abs(got[0]["loss"] - want["loss"]) / abs(want["loss"])
        print(f"  (s2) {cfg.name}: loss {got[0]['loss']:.6f} against one process's "
              f"{want['loss']:.6f} (rel {lerr:.2e}); gradient norms rel {en:.2e}, "
              f"{S_SAMPLES} sampled entries a leaf {es:.2e} of the leaf's largest; loss and "
              f"gradients {[round(g['ms'], 1) for g in got]} ms by rank, peak "
              f"{[round(g['peak_gb'], 2) for g in got]} GB by rank")
        check(lerr <= 1e-5 and not bad,
              f"(s2) {cfg.name} on the mesh against one process: loss rel {lerr:.2e} (tol "
              f"1e-5), leaves outside tolerance {bad} (tol {S_TOL}, experts {S_EXPERT_TOL})")
        check(len({g["digest"] for g in got}) == 1,
              f"(s2) {cfg.name}: loss, gradient norms and samples bitwise equal on the "
              f"{size} ranks")
        if cfg.moe is not None:
            check(len(got[0]["aux"]) == got[0]["a2a"] == cfg.n_layers,
                  f"(s2) {cfg.name}: {got[0]['a2a']} of {cfg.n_layers} MoE layers on the a2a "
                  f"path, aux {[round(a, 5) for a in got[0]['aux']]}, dropped "
                  f"{[round(d, 5) for d in got[0]['dropped']]}")
    nd = reps[0]["nodrop"]
    # the a2a path's expert gradients are bfloat16 (each rank's rounded, then
    # their sum over the data ranks rounded): two bfloat16 steps of the
    # float32 local gradient's largest entry
    check(all(r["nodrop"]["dropped"] == 0.0 for r in reps) and nd["out_err"] <= 1e-5
          and max(nd["grad_err"]) <= 2 * S_EXPERT_TOL,
          f"(s2) nothing dropped (capacity factor E/K, {S_NODROP[0]}×{S_NODROP[1]} tokens): "
          f"the a2a layer against moe_forward_local, output {nd['out_err']:.2e} (tol 1e-5), "
          f"expert gradients {[f'{e:.2e}' for e in nd['grad_err']]} (tol "
          f"{2 * S_EXPERT_TOL}) of the largest entry")
    st = [r["step"] for r in reps]
    share = 14 * reckoned_params(moe_cfg) / size / 1e9
    print(f"  (s2) one bfloat16 AdamW step of {moe_cfg.name}'s sharded state: ms "
          f"{[round(x['ms'], 1) for x in st]} by rank, loss {st[0]['loss']:.6f}, grad norm "
          f"{st[0]['grad_norm']:.4f}; state shards {[round(x['local_gb'], 2) for x in st]} GB "
          f"against the reckoned quarter of 14 B × {reckoned_params(moe_cfg)} = {share:.2f} GB; "
          f"peak {[round(x['peak_gb'], 2) for x in st]} GB"
          f" (host: the resident set's high-water mark since the rank started, which the "
          f"whole float32 draw of the first model sets); aux "
          f"{[round(a, 5) for a in st[0]['aux']]}, dropped "
          f"{[round(d, 5) for d in st[0]['dropped']]}; card: {smi}")
    check(len({x["digest"] for x in st}) == 1 and np.isfinite(st[0]["loss"])
          and all(r["opt_placed"] for r in reps),
          "(s2) the AdamW state placed by opt_shardings; the bfloat16 step's parameters "
          "bitwise equal on the ranks, its loss finite")
    red = [r["reduced"] for r in reps]
    mi, pf, ex, ss = (red[0][k] for k in ("micro", "prefill", "exact", "ssm"))
    print(f"  (s2) reduced checks against one process: a \"dp_only\" {S_MICRO_ARCH} step of "
          f"{S_MICRO_BATCH_SEQ[0]}×{S_MICRO_BATCH_SEQ[1]} tokens in {S_MICRO} microbatches "
          f"{[round(r['micro_s'], 2) for r in red]} s by rank; a sketched {S_PREFILL_ARCH} "
          f"prefill of {S_PREFILL_BATCH_SEQ[0]}×{S_PREFILL_BATCH_SEQ[1]} tokens into a cache "
          f"split on its slots over both axes {[round(r['prefill_s'], 2) for r in red]} s by "
          f"rank")
    print(f"  (s2) reduced checks against one process: an exact {S_PREFILL_ARCH} prefill and "
          f"decode step over {S_EXACT_LEN} positions split on model "
          f"{[round(r['exact_s'], 2) for r in red]} s by rank; a {S_SSM_ARCH} step of "
          f"{S_SSM_BATCH_SEQ[0]}×{S_SSM_BATCH_SEQ[1]} tokens in {S_SSM_MICRO} microbatches "
          f"{[round(r['ssm_s'], 2) for r in red]} s by rank; torch {torch.__version__}")
    for name, what, m in (("micro", f"the \"dp_only\" step in {S_MICRO} microbatches", mi),
                          ("ssm", f"the {S_SSM_ARCH} step in {S_SSM_MICRO} microbatches", ss)):
        check(m["loss_rel"] <= 1e-6 and m["norm_rel"] <= 1e-5 and m["m_err"] <= 1e-5,
              f"(s2) {what} against one process: loss rel {m['loss_rel']:.2e} (tol 1e-6), "
              f"gradient norm rel {m['norm_rel']:.2e} (tol 1e-5), AdamW's first moment "
              f"{m['m_err']:.2e} of a leaf's largest (tol 1e-5)")
    check(ex["logit_err"] <= 1e-5 and ex["cache_err"] <= 1e-6,
          f"(s2) the exact decode with its positions split on model against one process: "
          f"logits {ex['logit_err']:.2e} of their largest (tol 1e-5), cache "
          f"{ex['cache_err']:.2e} of its largest (tol 1e-6)")
    check(pf["logit_err"] <= 1e-5 and pf["cache_bitwise"],
          f"(s2) the slot-split sketched prefill against one process: logits "
          f"{pf['logit_err']:.2e} of their largest (tol 1e-5), cache "
          f"{'bit for bit' if pf['cache_bitwise'] else 'NOT bit for bit'}")
    check(len({r["digest"] for r in red}) == 1,
          "(s2) the reduced checks' results bitwise equal on the ranks")
    print(f"  (s) {time.perf_counter() - t_all:.1f} s")


def dryrun_path(torch, dev, smi: str, *, cfg=None, train=(T_BATCH, T_SEQ), prompt=T_PROMPT,
                cells=T2_CELLS, superblocks=T2_SB, timeout: float = T2_TIMEOUT) -> None:
    """Path (t), the dry run (``repro_torch.launch.specs``, ``.dryrun``,
    ``.analysis`` and the rank recorder ``analysis.trace.record_rank``).

    (t1) The dry run held against a real run on the card.  ``cfg``
    (stablelm-3b at full width cut to T_SB superblocks), float32 weights
    from seed 0: one training step (``train`` tokens, ``remat="full"``) and
    one sketched decode step at batch 1 after a ``prompt``-token prompt
    (``landmark_attention``'s decode sweep on each layer), each built by
    ``launch.specs`` on a one-rank ``"fake"`` group and run twice: as a dry
    run on fake tensors, and for real on the card (its arguments drawn
    alike, a warm-up first) under ``analysis.trace.record``.  The two
    recordings hold the same non-view ops in the same order and the same
    FLOPs; in the decode step the kernel's launch is no aten op, so the dry
    run's stand-in op (charged the kernel's two products) stands for it,
    and the launcher's own buffers (``empty``) are left out of the real
    run's list, as allocations are of the dry run's; the stand-ins, the
    router's dispatches and the kernel's launches agree.  The dry run's
    predicted rise of the allocated bytes over the call (its peak less its
    arguments) within T_PEAK_TOL of the rise of
    ``torch.cuda.max_memory_allocated`` over the real call.
    (t2) The production meshes: ``python -m repro_torch.launch.dryrun`` on
    both meshes for each of ``cells`` (``superblocks`` superblocks), one
    subprocess a cell, started together under one time limit; each
    record printed (ok, seconds, FLOPs, HBM bytes, collective bytes by
    kind, the peak a rank against the card's 80 GB, the dominant term,
    ``useful_fraction``), and any failed cell fails the path."""
    import tempfile as tf

    from repro_torch.analysis.trace import record, record_rank
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import sketched_attention as SA
    from repro_torch.core.sketched_attention import decode_slot_table, decode_slots
    from repro_torch.kernels.landmark_attention import kernel as LK
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import specs as SP
    from repro_torch.launch.analysis import ALLOCATIONS, analyze
    from repro_torch.models.model import init_cache, init_params, prefill_with_cache
    from repro_torch.sharding import make_mesh
    from repro_torch.train.step import TrainConfig, init_train_state

    t_all = time.perf_counter()
    cfg = cfg or SP.cut(get_config(T_ARCH), T_SB)
    (B, S), f32, cuda = train, torch.float32, dev.type == "cuda"
    tc = TrainConfig(n_micro=1, remat="full")
    sa = cfg.sketch_attn
    check(not torch.distributed.is_initialized(),
          "(t) no process group is left from the earlier paths")

    # ---- (t1) the dry runs, on a one-rank fake group ------------------------
    DR.start_fake_group(1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        built = {"train": SP.train_cell(cfg, ShapeSpec("train", S, B, "train"), mesh, tc,
                                        device=dev.type, dtype=f32),
                 "decode": SP.decode_cell(cfg, ShapeSpec("decode", prompt + 1, 1, "decode"),
                                          mesh, sketch=True, device=dev.type, dtype=f32)}
        dry, dry_s = {}, {}
        for name, cell in built.items():
            t0 = time.perf_counter()
            with mesh:
                dry[name] = record_rank(cell.fn, *cell.args, fake_mode=cell.fake_mode,
                                        device=dev)
            dry_s[name] = time.perf_counter() - t0
    finally:
        torch.distributed.destroy_process_group()

    # ---- (t1) the real runs, the same step functions ------------------------
    params = init_params(0, cfg, device=dev, dtype=f32)
    g = torch.Generator(device=dev).manual_seed(0)

    def ints(*shape):
        return torch.randint(0, cfg.vocab_size, shape, device=dev, dtype=torch.int32,
                             generator=g)

    tok, lab, prompt_tok, token = ints(B, S), ints(B, S), ints(1, prompt), ints(1)
    cache = init_cache(cfg, 1, prompt + 1, use_sketch=True, device=dev)
    _, cache = prefill_with_cache(params, prompt_tok, cfg, cache, slot_table=decode_slot_table(
        0, prompt, sa.d_slots, sa.m_r))
    step = built["train"].args[3]
    pos, slots = built["decode"].args[3:]
    # warm-ups (cuBLAS's workspace, the autotune cache's first call; the
    # decode at another position, so that its fold schedule is made anew)
    built["train"].fn(init_train_state(params, tc), tok, lab, step)
    built["decode"].fn(params, cache, token, SP._host_scalar(prompt - 1),
                       decode_slots(0, prompt - 1, sa.d_slots, sa.m_r))
    calls = {"train": lambda: (init_train_state(params, tc), tok, lab, step),
             "decode": lambda: (params, cache, token, pos, slots)}
    real, rise, real_s, launched = {}, {}, {}, {}
    for name, cell in built.items():
        args = calls[name]()
        # the fold's schedule is cached by slot table: an earlier path's
        # sketched decode at this position made it, and the dry run makes
        # its own once; so the real run makes it once too
        SA._fold_rounds.cache_clear()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        n0 = LK.landmark_attention.launches
        t0 = time.perf_counter()
        real[name] = record(cell.fn, *args)
        if cuda:
            torch.cuda.synchronize()
            rise[name] = torch.cuda.max_memory_allocated() - base
        real_s[name] = time.perf_counter() - t0
        launched[name] = LK.landmark_attention.launches - n0
        del args

    loss = real["train"].result[1]["loss"]
    logits = real["decode"].result[0]
    check(bool(torch.isfinite(loss)) and bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (1, cfg.vocab_size),
          f"(t1) the real runs' loss {loss.item():.6f} and decode logits "
          f"{tuple(logits.shape)} finite")
    for name in built:
        d, r = dry[name], real[name]
        stand_in = [ev for ev in d.ops if ev.namespace == "repro_torch"]
        dn = [ev.name for ev in d.ops if not ev.view and ev.namespace != "repro_torch"]
        rn = [ev.name for ev in r.ops if not ev.view]
        if stand_in or launched[name]:
            dn = [n for n in dn if n not in ALLOCATIONS]
            rn = [n for n in rn if n not in ALLOCATIONS]
        charged = sum(ev.flops for ev in stand_in)
        roof = analyze(d)
        print(f"  (t1) {name}: dry run {len(d.ops)} ops ({sum(not e.view for e in d.ops)} "
              f"non-view), {d.flops:.6e} FLOPs ({charged:.6e} of them the kernel's "
              f"stand-ins), {len(d.routes)} dispatches, {dry_s[name]:.2f} s; real run "
              f"{len(r.ops)} ops ({sum(not e.view for e in r.ops)} non-view), "
              f"{r.flops:.6e} FLOPs, {len(r.routes)} dispatches, {launched[name]} kernel "
              f"launches, {real_s[name]:.2f} s (recorded)")
        check(dn == rn, f"(t1) {name}: the dry run's {len(dn)} non-view ops are the real "
                        f"run's {len(rn)}, in order"
                        + (" (allocations and the kernel left out)" if charged else ""))
        if dn != rn:
            import difflib

            for tag, i0, i1, j0, j1 in difflib.SequenceMatcher(None, dn, rn).get_opcodes():
                if tag != "equal":
                    print(f"    {tag} at {i0}/{j0}: dry {dn[i0:i1]} real {rn[j0:j1]}")
        check(d.flops == r.flops + charged and r.flops > 0,
              f"(t1) {name}: dry-run FLOPs {d.flops:.6e} = real {r.flops:.6e} + the "
              f"kernel's {charged:.6e}")
        # on the CPU the router sends the tensors to the plain version
        check(d.routes == r.routes and (not cuda or len(stand_in) == len(d.routes)
                                        == launched[name])
              and (launched[name] > 0) == (name == "decode" and cuda),
              f"(t1) {name}: {len(stand_in)} stand-ins, {len(d.routes)} dry and "
              f"{len(r.routes)} real dispatches, {launched[name]} launches")
        pred = d.peak_bytes - d.arg_bytes
        if cuda:
            err = abs(pred - rise[name]) / max(rise[name], 1)
            check(err <= T_PEAK_TOL,
                  f"(t1) {name}: predicted rise {pred / 1e9:.4f} GB (peak "
                  f"{d.peak_bytes / 1e9:.4f} GB less the arguments' {d.arg_bytes / 1e9:.4f}) "
                  f"against the measured rise of max_memory_allocated "
                  f"{rise[name] / 1e9:.4f} GB: {100 * err:.2f}% (tol "
                  f"{100 * T_PEAK_TOL:.0f}%); card: {smi}")
        print(f"  (t1) {name}: roofline on the profile {roof.hw.name}: t_compute "
              f"{roof.t_compute * 1e3:.3f} ms, t_memory {roof.t_memory * 1e3:.3f} ms "
              f"({roof.hbm_bytes / 1e9:.3f} GB), dominant {roof.dominant}")
    del params, cache, real, tok, lab

    # ---- (t2) the production meshes ------------------------------------------
    out_dir = Path(tf.mkdtemp(prefix="chip_smoke_dryrun_"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parent / "src"), os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    procs = []
    for arch, shape in cells:
        out = out_dir / f"{arch}.{shape}.jsonl"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--mesh", "both", "--superblocks", str(superblocks), "--device",
               dev.type, "--out", str(out)]
        procs.append((arch, shape, out, subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for arch, shape, out, proc in procs:
        try:
            log = proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            log = proc.communicate()[0]
        recs = [json.loads(line) for line in out.read_text().splitlines()] if out.exists() else []
        for rec in recs:
            if not rec["ok"]:
                print(f"  (t2) {arch}/{shape} mesh={rec['mesh']}: {rec['error']}")
                continue
            print(f"  (t2) {arch}/{shape} mesh={rec['mesh']} ({rec['superblocks']} "
                  f"superblocks): ok, cell {rec['lower_s']} s, step {rec['compile_s']} s, "
                  f"{rec['ops']} ops; a rank: {rec['flops']:.4e} FLOPs, "
                  f"{rec['hbm_bytes']:.4e} HBM bytes, collective bytes "
                  f"{rec['coll_detail']['bytes']}, peak {rec['peak_mem_bytes'] / 1e9:.2f} of "
                  f"{rec['hbm_capacity_bytes'] / 1e9:.0f} GB; dominant {rec['dominant']} "
                  f"(t_comp {rec['t_compute'] * 1e3:.2f} ms, t_mem {rec['t_memory'] * 1e3:.2f} "
                  f"ms, t_coll {rec['t_collective'] * 1e3:.2f} ms), useful_fraction "
                  f"{rec['useful_fraction']:.4f}; {rec['hardware']}")
        ok = (proc.returncode == 0 and [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
              and all(r["ok"] for r in recs))
        if not ok:
            print(log[-3000:])
        check(ok, f"(t2) {arch}/{shape} on both production meshes: exit {proc.returncode}, "
                  f"{sum(r['ok'] for r in recs)} of 2 records ok")
    print(f"  (t2) {len(cells)} cells × 2 meshes in {time.perf_counter() - t0:.1f} s "
          f"(limit {timeout:.0f} s)")
    print(f"  (t) {time.perf_counter() - t_all:.1f} s; card: {smi}")


def unchecked_core(q, k, v, window, q_chunk, out_dtype):
    """The attention core as ``models.attention`` had it before the
    recomputing chunk: each chunk's float32 scores kept by autograd for the
    backward.  (u2)'s yardstick."""
    import torch

    from repro_torch.models.attention import NEG_INF, softmax_scale

    S, scale = q.shape[1], softmax_scale(q.shape[-1])
    qc = S // max(S // q_chunk, 1)
    outs = []
    for s0 in range(0, S, qc):
        s1 = min(S, s0 + qc)
        k0 = 0 if window is None else max(0, s0 - window + 1)
        qpos = torch.arange(s0, s1, device=q.device)
        kpos = torch.arange(k0, s1, device=q.device)
        logits = torch.einsum("bqhgd,bshd->bhgqs", q[:, s0:s1].float(),
                              k[:, k0:s1].float()) * scale
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > (qpos[:, None] - window)
        p = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
        outs.append(torch.einsum("bhgqs,bshd->bqhgd", p, v[:, k0:s1].float()).to(out_dtype))
    return torch.cat(outs, dim=1)


def xent_chunk_plain(h, labels, mask, W):
    """One loss chunk's plain ops, (u1)'s yardstick under
    ``torch.utils.checkpoint`` (``models.common`` before the one-buffer
    backward)."""
    import torch

    logits = h.float() @ W.T
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum((lse - lab) * mask), torch.sum(mask)


def memory_plan_path(torch, dev, smi: str, tmp: Path, *, cfg=None, loss_bs=U_LOSS_BS,
                     attn_bs=U_ATTN_BS, lse_shapes=None, examples=EXAMPLES,
                     example_args=None, timeout: float = U_EX_TIMEOUT) -> dict:
    """Path (u): the reference's memory plan for training, the decode
    sweep's log-sum-exp and the example twins.  Returns {"launches": every
    kernel's launches summed over the twins' processes, "lse": (u3)'s row}.

    (u3) runs first, alone on the card, then (u4) in the background beside
    (u1) and (u2): each of ``examples``
    (examples/<name>_torch.py at its defaults and ``--check``) in a
    subprocess of its own (``RUN_EXAMPLE``, an autotune cache file of its
    own under ``tmp``), all under ``timeout``; those of U_ALONE, whose
    claims hold a timing ratio, alone on the card after the rest have
    ended.  Each must exit 0 with every claim it checks holding, and print
    the kernels it launched.
    (u1) ``chunked_xent``'s loss and gradients at ``cfg``'s head (the
    one-buffer backward, ``_XentChunk``) against the same chunks run as
    plain ops under ``torch.utils.checkpoint``, the route it replaced: the
    rise of ``max_memory_allocated`` over each call beside the rise
    reckoned (printed first), the losses bit for bit, the gradients at
    U_TOL.  (u2) ``attn_forward`` of ``cfg``'s global attention block at
    full width, forward and backward, with the recomputing chunk
    (``_CausalChunk``) and with ``unchecked_core``: the rises, the reckoned
    ones first, and the outputs and gradients at U_TOL.  (u3) the decode
    sweep's log-sum-exp (``landmark_attention(..., lse=True)``) against the
    plain version's at each of ``lse_shapes`` (P, G, L, Dh) in float32 and
    bfloat16, its output bit for bit the launch's without it, and its time
    beside that launch's, the plain version's, the byte bound and the
    library's one call that returns the output and its log-sum-exp
    (``torch.ops.aten._scaled_dot_product_efficient_attention`` with
    ``compute_log_sumexp``, the bias as its float mask)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.accum_apply import autotune as AT
    from repro_torch.kernels.landmark_attention import kernel as LK
    from repro_torch.kernels.landmark_attention import ref as LR
    from repro_torch.models import attention as AM
    from repro_torch.models.common import chunked_xent, rope_table
    from torch.utils.checkpoint import checkpoint

    t_all = time.perf_counter()
    cfg = cfg or get_config(U_ARCH)
    cuda = dev.type == "cuda"
    example_args = example_args or {}

    # ---- (u3) the decode sweep's log-sum-exp ----------------------------------
    lse_row = {}
    gl = torch.Generator(device=dev).manual_seed(7)
    # a rehearsal on the CPU takes the plain version in the kernel's place
    kernel = LK.landmark_attention if cuda else LR.landmark_attention_ref
    for P, G, L, Dh in lse_shapes or ((32, 4, 1024, 128), (128, 1, 1024, 112),
                                      (512, 2, 1024, 256)):
        q, kt, M = (torch.randn(shape, generator=gl, device=dev)
                    for shape in ((P, G, Dh), (P, L, Dh), (P, L, Dh)))
        mass = 3 * torch.rand((P, L), generator=gl, device=dev)
        bias = torch.where(mass < 0.3, -1e30, torch.log(mass))
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            qq, kk, MM = q.to(dt), kt.to(dt), M.to(dt)
            out, lse = kernel(qq, kk, MM, bias, lse=True)
            plain, plain_lse = LR.landmark_attention_ref(qq, kk, MM, bias, lse=True)
            e_lse = close(lse, plain_lse, 1e-5)
            e_out = close(out, plain, tol)
            same = torch.equal(out, kernel(qq, kk, MM, bias))
            nsplit, _ = LK.plan(P, G, L, Dh, Dh, dt)
            name = f"P={P} G={G} L={L} Dh={Dh} {str(dt).split('.')[-1]}"
            check(e_lse[2] and e_out[2] and same and lse.shape == (P, G),
                  f"(u3) {name} ({nsplit} splits): lse within {e_lse[1]:.2e} of the plain "
                  f"version's largest (tol 1e-5), the output {e_out[1]:.2e} (tol {tol:g}) and "
                  f"bit for bit the launch's without the lse")
            if cuda:
                ms, dms = timed(torch, lambda: LK.landmark_attention(qq, kk, MM, bias, lse=True))
                ms0, dms0 = timed(torch, lambda: LK.landmark_attention(qq, kk, MM, bias))
                pms, _ = timed(torch, lambda: LR.landmark_attention_ref(qq, kk, MM, bias,
                                                                        lse=True))
                # the library call: memory-efficient SDPA, which takes a bias
                # and returns each row's log-sum-exp, in the inputs' dtype
                qs, ks, vs = qq[:, None], kk[:, None], MM[:, None]
                bs = bias[:, None, None, :].expand(P, 1, G, L).to(dt).contiguous()

                def library():
                    return torch.ops.aten._scaled_dot_product_efficient_attention(
                        qs, ks, vs, bs, True)

                lib_out, lib_lse = library()[:2]
                e_lib = close(lib_lse[:, 0, :G].float(), plain_lse, 1e-5)
                e_lout = close(lib_out[:, 0], plain, tol)
                lms, ldms = timed(torch, library)
                nbytes = (q.numel() + kt.numel() + M.numel() + P * G * Dh) * qq.element_size() \
                    + (bias.numel() + P * G) * 4
                b, by = bound_ms(nbytes, 2 * P * G * L * 2 * Dh)
                share = f"{b / dms:.1%} of it on device time" if dms else "device not measured"
                print(f"  (u3) {name}: with the lse {ms:.4f} ms (device {dms}), without "
                      f"{ms0:.4f} ms (device {dms0}), plain {pms:.4f} ms, the library's "
                      f"_scaled_dot_product_efficient_attention with its lse {lms:.4f} ms "
                      f"(device {ldms}; its lse {e_lib[1]:.2e} and output {e_lout[1]:.2e} of "
                      f"the plain version's largest), bound {b:.5f} ms by {by} ({share})")
                lse_row[name] = dict(max_abs_err=e_lse[0], max_rel_err=e_lse[1], ms=ms,
                                     device_ms=dms, ms_without=ms0, device_ms_without=dms0,
                                     plain_ms=pms, bound_ms=b, bound_by=by, splits=nsplit,
                                     library_ms=lms, library_device_ms=ldms,
                                     library_lse_rel_err=e_lib[1])
                del qs, ks, vs, bs, lib_out, lib_lse
        del q, kt, M, mass, bias, qq, kk, MM

    # ---- (u4) the example twins, in the background beside (u1) and (u2) ------
    root = Path(__file__).resolve().parent

    def start(name):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(root / "src"), os.environ.get("PYTHONPATH", "")]))
        env[AT.ENV_CACHE] = str(tmp / f"example_{name}.json")
        return subprocess.Popen(
            [sys.executable, "-c", RUN_EXAMPLE, str(root / "examples" / f"{name}_torch.py"),
             "--check", "--device", dev.type, *example_args.get(name, [])],
            env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    procs = {name: start(name) for name in examples if name not in U_ALONE}

    def rise(fn):
        """(fn(), the rise of the allocated bytes over the call, seconds)."""
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
            return out, torch.cuda.max_memory_allocated() - base, time.perf_counter() - t0
        return out, float("nan"), time.perf_counter() - t0

    g = torch.Generator(device=dev).manual_seed(0)

    # ---- (u1) the loss at the head --------------------------------------------
    (B, S), D, V, c = loss_bs, cfg.d_model, cfg.vocab_size, 512
    buf, head, hb = B * min(c, S) * V * 4, V * D * 4, B * S * D * 4
    print(f"  (u1) predicted rises: the one-buffer backward {(buf + 2 * head + 2 * hb) / 1e9:.2f}"
          f" GB (a (B, c, V) buffer {buf / 1e9:.2f}, the head's gradient twice, h's twice); "
          f"under torch.utils.checkpoint {(5 * buf + 2 * head + 2 * hb) / 1e9:.2f} GB (five "
          f"buffers)")
    h = (torch.randn((B, S, D), generator=g, device=dev) / math.sqrt(D)).requires_grad_()
    W = (0.02 * torch.randn((V, D), generator=g, device=dev)).requires_grad_()
    labels = torch.randint(0, V, (B, S), generator=g, device=dev)
    mask = torch.ones((B, S), dtype=torch.float32, device=dev)

    def checkpointed():
        n = max(S // c, 1)
        hc, lc, mc = (x.reshape(B, n, S // n, *x.shape[2:]) for x in (h, labels, mask))
        ls = ct = 0
        for i in range(n):
            a, b = checkpoint(xent_chunk_plain, hc[:, i], lc[:, i], mc[:, i], W,
                              use_reentrant=False)
            ls, ct = ls + a, ct + b
        loss = ls / torch.clamp(ct, min=1.0)
        return (loss.detach(), *torch.autograd.grad(loss, [h, W]))

    def one_buffer():
        loss, _ = chunked_xent(h, W, labels, mask)
        return (loss.detach(), *torch.autograd.grad(loss, [h, W]))

    old, old_rise, old_s = rise(checkpointed)
    new, new_rise, new_s = rise(one_buffer)
    print(f"  (u1) loss and gradients at {U_ARCH}'s head, h {tuple(h.shape)} float32, W "
          f"{tuple(W.shape)}: one-buffer backward rise {new_rise / 1e9:.2f} GB, {new_s:.2f} s; "
          f"torch.utils.checkpoint {old_rise / 1e9:.2f} GB, {old_s:.2f} s; card: {smi}")
    errs = [close(a, b, U_TOL) for a, b in zip(new[1:], old[1:])]
    check(torch.equal(new[0], old[0]) and all(e[2] for e in errs),
          f"(u1) loss {new[0].item():.6f} bit for bit; dh, dW within "
          f"{[f'{e[1]:.2e}' for e in errs]} of their largest (tol {U_TOL})")
    if cuda:
        check(new_rise < old_rise and new_rise <= 2 * buf + 3 * head + 4 * hb,
              f"(u1) the one-buffer rise {new_rise / 1e9:.2f} GB at most two buffers plus "
              f"the head's and h's gradients ({(2 * buf + 3 * head + 4 * hb) / 1e9:.2f} GB), "
              f"below checkpoint's {old_rise / 1e9:.2f}")
    del h, W, labels, mask, old, new

    # ---- (u2) the attention block ---------------------------------------------
    (B, S), H, Hkv, Dh = attn_bs, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qc = min(512, S)
    scores, act = B * H * qc * S * 4, B * S * H * Dh * 4
    print(f"  (u2) predicted rises: the recomputing chunk {(3 * scores + 10 * act) / 1e9:.2f} "
          f"GB (three of the last chunk's scores, {scores / 1e9:.3f} GB each, and ten "
          f"activations); every chunk's scores kept "
          f"{(B * H * S * (S + qc) // 2 * 4 + 10 * act) / 1e9:.2f} GB")
    p = {k: v.requires_grad_() for k, v in
         AM.init_attn(torch.Generator(device=dev).manual_seed(1), cfg,
                      dtype=torch.float32).items()}
    x = torch.randn((B, S, cfg.d_model), generator=g, device=dev).requires_grad_()
    r = torch.randn((B, S, cfg.d_model), generator=g, device=dev)
    sin, cos = rope_table(torch.arange(S, device=dev), Dh, cfg.rope_theta)
    leaves = [x, p["wq"], p["wk"], p["wv"], p["wo"]]

    def block():
        out = AM.attn_forward(p, x, cfg, sin, cos, q_chunk=qc)
        return (out.detach(), *torch.autograd.grad(out, leaves, r))

    new, new_rise, new_s = rise(block)
    core, AM._causal_core = AM._causal_core, unchecked_core
    try:
        old, old_rise, old_s = rise(block)
    finally:
        AM._causal_core = core
    print(f"  (u2) {U_ARCH}'s attention block, B={B} S={S} H={H} (KV {Hkv}) Dh={Dh}, forward "
          f"and backward: recomputing chunk rise {new_rise / 1e9:.3f} GB, {new_s:.2f} s; "
          f"every chunk's scores kept {old_rise / 1e9:.3f} GB, {old_s:.2f} s; card: {smi}")
    errs = [close(a, b, U_TOL) for a, b in zip(new, old)]
    check(all(e[2] for e in errs),
          f"(u2) output and gradients (x, wq, wk, wv, wo) within "
          f"{[f'{e[1]:.2e}' for e in errs]} of their largest (tol {U_TOL})")
    if cuda:
        check(new_rise < old_rise, f"(u2) the recomputing chunk's rise {new_rise / 1e9:.3f} GB "
                                   f"below {old_rise / 1e9:.3f}")
    del p, x, r, new, old

    # ---- (u4) the example twins' results --------------------------------------
    launches: dict = {}

    def finish(name, proc, beside):
        try:
            log = proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t_all)))[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            log = proc.communicate()[0]
        lines = log.splitlines()
        # the twin's own seconds (its process's start to its end: imports and
        # the kernels' load included)
        wall_s = float(next((ln[8:] for ln in lines if ln.startswith("SECONDS ")), "nan"))
        got = json.loads(next((ln[9:] for ln in lines if ln.startswith("LAUNCHES ")), "{}"))
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        claims = [ln for ln in lines if ln.startswith("[check]")]
        print(f"  (u4) {name}_torch.py: exit {proc.returncode}, {wall_s:.1f} s wall in its "
              f"process ({beside}); {claims[-1] if claims else 'no [check]'}; "
              f"kernels launched {({k: v for k, v in got.items() if v})}")
        for ln in lines:
            if not ln.startswith(("LAUNCHES ", "SECONDS ", "[loop]", "[check]")):
                print(f"      {ln}")
        n_launched = sum(got.values())
        want = (n_launched == 0 if name == "train_lm" else n_launched > 0) or not cuda
        if name == "long_context_serve" and cuda:
            want = want and got.get("landmark_attention", 0) > 0
        ok = proc.returncode == 0 and len(claims) == 1 and want
        what = "none: training reaches no kernel" if name == "train_lm" else "some"
        check(ok, f"(u4) {name}_torch.py exits 0 with its claims holding and its kernels "
                  f"launched ({what})")

    for name, proc in procs.items():
        finish(name, proc, "started with the others, beside (u1)–(u2)")
    for name in examples:
        if name in U_ALONE:
            finish(name, start(name), "alone on the card")
    print(f"  (u) {time.perf_counter() - t_all:.1f} s; card: {smi}")
    return {"launches": launches, "lse": lse_row}


def main() -> int:
    """Run the checks and the main path; return the exit code."""
    t_start = time.perf_counter()
    # path (o) trains deterministically: cuBLAS reads this when CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import apply as A
    from repro_torch.core import (
        KernelOperator, get_kernel, insample_error, krr_exact_fitted,
        krr_sketched_fit, krr_sketched_fit_adaptive, krr_sketched_fit_matfree,
        krr_sketched_fit_pcg, make_accum_sketch, make_nystrom_sketch,
        spectral_cluster)
    from repro_torch._util import stream_generator, tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.core.sketched_attention import (
        accum_attention, decode_slot_table, decode_slots, init_sketch_cache,
        make_seq_sketch, prefill_sketch_cache, update_sketch_cache)
    from repro_torch.kernels.accum_apply import autotune as AT
    from repro_torch.kernels.accum_apply import kernel as KN
    from repro_torch.kernels.accum_apply import ops as OPS
    from repro_torch.kernels.accum_apply import ref
    from repro_torch.kernels.landmark_attention import kernel as LK
    from repro_torch.kernels.landmark_attention import ops as LO
    from repro_torch.kernels.landmark_attention import ref as LR
    from repro_torch.models.model import decode_step, init_params, param_count
    from repro_torch.resilience import faults
    from repro_torch.resilience.degrade import global_health
    from repro_torch.serve.engine import Engine, ServeConfig

    dev = torch.device(DEVICE)
    # every run starts from empty autotune caches of its own
    tmpdir = tempfile.TemporaryDirectory(prefix="chip_smoke_autotune_")
    tmp = Path(tmpdir.name)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([KN._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {nvcc}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        list(pool.map(lambda build: build(), (
            KN.build, LK.build,
            lambda: KN.build_source(Path(__file__).resolve().parent / PROBE, {}))))
    KN._lib()
    LK._lib()
    print(f"kernel builds: {time.perf_counter() - t0:.1f} s, in parallel")
    for mod in (KN, LK):
        print(f"  nvcc {mod.BUILD_INFO['seconds']:.1f} s -> {mod.BUILD_INFO['path']}")
        for line in mod.BUILD_INFO["ptxas"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    lam, bw = 1e-3, 0.5
    gauss = get_kernel("gaussian", bw)

    def regression(n, seed):
        return make_regression(torch, dev, n, seed)

    # ---- 2. kernels against their plain versions -------------------------- #
    print("\n== kernels vs plain (on the card) ==")
    rows = {}
    # the cache chooses each row's geometry here from a file of its own, so
    # that the main paths below start from an empty one
    os.environ[AT.ENV_GATE] = "1"
    os.environ[AT.ENV_CACHE] = str(tmp / "kernels.json")

    def geometry(name, kind, key, dtype, cands, launch, choose=None):
        """The launch geometry of ``name`` at this row's shape: every
        candidate's outputs held against the static geometry's
        (``cands[0]``) bit for bit, each candidate's ms, and the geometry
        the cache chose — by one entry-point call, ``choose``, that measures
        at this key (None: the kernel takes the table's geometry alone) —
        timed beside the static one.  Returns the fields for the row."""
        static = cands[0]
        want = launch(static)
        same = all(torch.equal(x, y) for c in cands[1:] for x, y in zip(launch(c), want))
        check(same, f"{name}: every candidate geometry {[c[0] for c in cands]} gives "
                    f"the static geometry's bits")
        cand_ms = {c[0]: timed(torch, lambda c=c: launch(c))[0] for c in cands}
        geo = static
        if choose is not None:
            choose()
            src = LK.source_hash() if kind.startswith("landmark") else KN.source_hash()
            geo = AT.lookup(kind, key, dtype, dev, arity=1, source=src) or static
        ms, dms = timed(torch, lambda: launch(geo))
        print(f"  {name} {key}: candidates (rows a block: ms) "
              f"{ {k: round(v, 4) for k, v in cand_ms.items()} }; chosen by the "
              f"{'cache' if choose else 'table'}: {geo[0]}, {ms:.4f} ms (device {dms}) "
              f"against the static {static[0]}'s {cand_ms[static[0]]:.4f} ms")
        return dict(static_geometry=static[0], geometry=geo[0],
                    geometry_by="cache" if choose else "table", geometry_ms=ms,
                    geometry_device_ms=dms, static_geometry_ms=cand_ms[static[0]],
                    candidate_ms=cand_ms)
    nb, d, m = N_OP, 64, 4
    gb, Xb, fb, yb = regression(nb, 2)
    skb = make_accum_sketch(gb, nb, d, m, device=dev)
    Lb = Xb.index_select(0, skb.indices.reshape(-1)).contiguous()
    cf = skb.coef.float().contiguous()

    out = KN.matfree_apply(Xb, Lb, cf, kernel="gaussian", bandwidth=bw)
    plain = ref.landmark_cols_ref(Xb, Lb, cf, gauss)
    ea, er, ok = close(out, plain, 1e-5)
    check(ok, f"matfree_apply gaussian f32 n={nb} d={d} m={m}: max abs "
              f"{ea:.3e}, /max|plain| {er:.3e} (tol 1e-5)")
    ms, dms = timed(torch, lambda: KN.matfree_apply(Xb, Lb, cf, kernel="gaussian",
                                                   bandwidth=bw))
    pms, _ = timed(torch, lambda: ref.landmark_cols_ref(Xb, Lb, cf, gauss))
    nbytes = Xb.numel() * 4 + Lb.numel() * 4 + cf.numel() * 4 + nb * d * 4
    # each of the n·m·d evaluations: at p = 3, an FMUL, 2 FFMA, 2 FADD, the
    # clamp and the FFMA into the sum on the FP32 pipe (10 operations, an FMA
    # counting 2), and one ex2 on the SFU (the Gaussian)
    evals = nb * m * d
    mf_bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "fp32": evals * 10 / F32_OPS_PER_S * 1e3, "sfu": sfu_ms(torch, evals)}
    b = max(mf_bounds.values())
    by = "bytes" if mf_bounds["bytes"] == b else "operations"
    mf_shares = shares(f"matfree_apply gaussian f32 n={nb} m={m} d={d} against its bounds "
                       f"(SFU at {sm_clock_hz() / 1e6:.0f} MHz)", dms, mf_bounds)
    rows["matfree_apply"] = dict(replaces=f"{TPU}:474", max_abs_err=ea,
                                 max_rel_err=er, ms=ms, device_ms=dms,
                                 plain_ms=pms, bound_ms=b, bound_by=by,
                                 bounds_ms=mf_bounds, share_of_bounds=mf_shares,
                                 sm_clock_mhz=sm_clock_hz() / 1e6, library_ms=None)
    del plain
    rows["matfree_apply"].update(geometry(
        "matfree_apply", "matfree_cols", (nb, 3, d, m, "gaussian"), torch.float32,
        OPS._rows_candidates(OPS.MATFREE_ROWS, nb, (KN.matfree_rows(nb),)),
        lambda c: (KN.matfree_apply(Xb, Lb, cf, kernel="gaussian", bandwidth=bw, bm=c[0]),),
        lambda: OPS.matfree_cols_kernel(Xb, Lb, cf, kernel="gaussian", bandwidth=bw)))
    for kern, nu in [("laplacian", 1.5), ("matern", 0.5), ("matern", 1.5),
                     ("matern", 2.5)]:
        out = KN.matfree_apply(Xb, Lb, cf, kernel=kern, bandwidth=bw, nu=nu)
        plain = ref.landmark_cols_ref(Xb.double(), Lb.double(), cf.double(),
                                      get_kernel(kern, bw, nu))
        ea, er, ok = close(out, plain, 5e-3)
        check(ok, f"matfree_apply {kern} nu={nu} f32 vs f64 plain: max abs "
                  f"{ea:.3e}, /max|plain| {er:.3e} (tol 5e-3, self-pair cusp)")
        del plain
    Xh, Lh = Xb.bfloat16(), Lb.bfloat16()
    out = KN.matfree_apply(Xh, Lh, cf, kernel="gaussian", bandwidth=bw)
    ea, er, ok = close(out, ref.landmark_cols_ref(Xh.float(), Lh.float(), cf,
                                                  gauss), 5e-2)
    check(ok, f"matfree_apply gaussian bf16: max abs {ea:.3e}, /max|plain| "
              f"{er:.3e} (tol 5e-2)")

    Cb = KN.matfree_apply(Xb, Lb, cf, kernel="gaussian", bandwidth=bw)
    idx = skb.indices.contiguous()
    out = KN.accum_apply_left(Cb, idx, cf)
    ea, er, ok = close(out, ref.sketch_left_ref(idx, cf, Cb), 1e-5)
    check(ok, f"accum_apply_left f32 M=({nb}, {d}): max abs {ea:.3e}, "
              f"/max|plain| {er:.3e} (tol 1e-5)")
    ms, dms = timed(torch, lambda: KN.accum_apply_left(Cb, idx, cf))
    pms, _ = timed(torch, lambda: ref.sketch_left_ref(idx, cf, Cb))
    St = sketch_csr(torch, idx, cf, nb, transposed=True)
    lib = torch.sparse.mm(St, Cb)
    print(f"  torch.sparse.mm(Sᵀ, C) vs plain: max abs "
          f"{(lib - ref.sketch_left_ref(idx, cf, Cb)).abs().max().item():.3e}")
    lms, ldms = timed(torch, lambda: torch.sparse.mm(St, Cb))
    print(f"  torch.sparse.mm(Sᵀ, C): device {ldms} ms per call")
    b, by = bound_ms(m * d * d * 4 + m * d * 8 + d * d * 4, 2 * m * d * d)
    fms, fdms = launch_floor(torch, KN)
    print(f"  launch floor (scripts/sector_probe.cu's empty kernel through ctypes): one "
          f"launch {fms:.4f} ms wall, back to back; device {fdms} ms; accum_apply_left "
          f"{ms:.4f} ms (device {dms}) against its byte bound {b:.5f} ms")
    # one fixed geometry (one block per output row), not autotuned: the
    # reference does not autotune accum_apply_left either
    rows["accum_apply_left"] = dict(replaces=f"{TPU}:229", max_abs_err=ea,
                                    max_rel_err=er, ms=ms, device_ms=dms,
                                    plain_ms=pms, bound_ms=b, bound_by=by,
                                    library_ms=lms, library_device_ms=ldms,
                                    launch_floor_ms=fms, launch_floor_device_ms=fdms,
                                    geometry_by="fixed")
    out = KN.accum_apply_left(Cb.bfloat16(), idx, cf)
    ea, er, ok = close(out, ref.sketch_left_ref(idx, cf, Cb.bfloat16()), 3e-2)
    check(ok, f"accum_apply_left bf16: max abs {ea:.3e}, /max|plain| {er:.3e} "
              "(tol 3e-2)")
    del Cb, out

    nc = N_DENSE
    gc, Xc, fc, yc = regression(nc, 3)
    skc = make_accum_sketch(gc, nc, d, m, device=dev)
    opc = KernelOperator(Xc, "gaussian", bw)
    Kc = opc.dense()
    idc, cfc = skc.indices.contiguous(), skc.coef.float().contiguous()
    # the gathers' reference rate: the probe's for random 32-byte sectors on this K
    print("  the card's rate for random sectors (scripts/sector_probe.cu) on the "
          f"float32 K ({nc}, {nc}):")
    rates = sector_rates(torch, KN, Kc)

    def gather_bounds(name, dms, b, idx, R, isz, other):
        """The gather row's sector bounds beside its byte bound ``b``, each
        with the device time's share of it (printed)."""
        sb = sector_bound(idx, R, isz, other, rates)
        got = shares(f"{name}: {sb['sectors_a_row']} sectors a row, bounds", dms,
                     {"bytes": b, "sectors": sb["sector_bound_ms"],
                      "sector rate": sb["sector_rate_ms"]})
        return dict(sb, share_of_bounds=got)

    for dt, tol in [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)]:
        Kt = Kc.to(dt)
        C, W = KN.accum_sketch_both(Kt, idc, cfc)
        Cr, Wr = ref.sketch_both_ref(Kt, idc, cfc)
        eC, rC, okC = close(C, Cr, tol)
        eW, rW, okW = close(W, Wr, tol)
        check(okC and okW and C.dtype == dt,
              f"accum_sketch_both {dt} n={nc}: C max abs {eC:.3e} (/max "
              f"{rC:.3e}), W max abs {eW:.3e} (/max {rW:.3e}) (tol {tol})")
        if dt == torch.float32:
            ms, dms = timed(torch, lambda: KN.accum_sketch_both(Kt, idc, cfc))
            pms, _ = timed(torch, lambda: ref.sketch_both_ref(Kt, idc, cfc))
            b, by = bound_ms(nc * m * d * 4 + m * d * 8 + nc * d * 4 + d * d * 4,
                             2 * nc * m * d + 2 * m * d * d)
            rows["accum_sketch_both"] = dict(
                replaces=f"{TPU}:164", max_abs_err=max(eC, eW),
                max_rel_err=max(rC, rW), ms=ms, device_ms=dms, plain_ms=pms,
                bound_ms=b, bound_by=by, library_ms=None,
                **gather_bounds("accum_sketch_both f32", dms, b, idc, nc, 4,
                                m * d * 8 + nc * d * 4 + d * d * 4))
            rows["accum_sketch_both"].update(geometry(
                "accum_sketch_both", "sketch_both", (nc, d, m), dt,
                OPS._gemm_candidates(nc, AT.STATIC_TABLE["sketch_both"]),
                lambda c: KN.accum_sketch_both(Kt, idc, cfc, bm=c[0]),
                lambda: OPS.sketch_both_kernel(Kt, skc)))
        del Kt, C, W, Cr, Wr

    # the engine's kernels: accum_apply (the unit step on a wide K) at m = 1,
    # accum_grow_slabs (every batch on a dense K) at B = 1 and 16
    def distinct(idx):
        return int(torch.unique(idx).numel())

    ska = make_accum_sketch(gc, nc, d, 1, device=dev)
    ida, cfa = ska.indices.contiguous(), ska.coef.float().contiguous()
    for dt, tol in [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]:
        Kt = Kc.to(dt)
        out = KN.accum_apply(Kt, ida, cfa)
        ea, er, ok = close(out, ref.accum_apply_ref(Kt, ida, cfa), tol)
        check(ok and out.dtype == dt, f"accum_apply {dt} R=N={nc} m=1 d={d}: max "
                                      f"abs {ea:.3e}, /max|plain| {er:.3e} (tol {tol})")
        ms, dms = timed(torch, lambda: KN.accum_apply(Kt, ida, cfa))
        pms, _ = timed(torch, lambda: ref.accum_apply_ref(Kt, ida, cfa))
        isz = Kt.element_size()
        b, by = bound_ms(nc * distinct(ida) * isz + nc * d * isz + d * 8, 2 * nc * d)
        print(f"  accum_apply {dt}: {ms:.4f} ms (device {dms}), plain {pms:.4f} ms, "
              f"bound {b:.5f} ms")
        gb_apply = gather_bounds(f"accum_apply {dt}", dms, b, ida, nc, isz,
                                 nc * d * isz + d * 8)
        if dt == torch.float32:
            # K S as (Sᵀ Kᵀ)ᵀ through cuSPARSE, with Sᵀ one CSR (d, N) matrix
            St = sketch_csr(torch, ida, cfa, nc, transposed=True)
            lib = torch.sparse.mm(St, Kt.T)
            print(f"  torch.sparse.mm(Sᵀ, Kᵀ)ᵀ vs plain: max abs "
                  f"{(lib.T - out).abs().max().item():.3e}")
            lms, ldms = timed(torch, lambda: torch.sparse.mm(St, Kt.T))
            print(f"  torch.sparse.mm(Sᵀ, Kᵀ): {lms:.4f} ms (device {ldms})")
            rows["accum_apply"] = dict(replaces=f"{TPU}:84", max_abs_err=ea,
                                       max_rel_err=er, ms=ms, device_ms=dms,
                                       plain_ms=pms, bound_ms=b, bound_by=by,
                                       library_ms=lms, **gb_apply)
            rows["accum_apply"].update(geometry(
                "accum_apply", "accum_apply", (nc, nc, d, 1), dt,
                OPS._gemm_candidates(nc, AT.STATIC_TABLE["accum_apply"]),
                lambda c: (KN.accum_apply(Kt, ida, cfa, bm=c[0]),),
                lambda: OPS.sketch_right_kernel(Kt, ska)))
        del Kt, out

    # accum_step_slab at N = 32768 beside the route the engine takes there
    # (accum_apply, then a·C + G): data for the MAX_COLS question, off path
    Cw = torch.randn((nc, d), generator=gc, device=dev)
    aw = math.sqrt(3 / 4)
    wide = {"accum_step_slab": lambda: KN.accum_step_slab(Kc, ida, cfa, Cw, aw),
            "accum_apply + a·C": lambda: OPS.sketch_step_kernel(Kc, ida[0], cfa[0],
                                                                Cw, aw)}
    ea, _, ok = close(wide["accum_step_slab"](), wide["accum_apply + a·C"](), 1e-5)
    check(ok, f"accum_step_slab at N={nc} vs the accum_apply route: max abs "
              f"{ea:.3e} (tol 1e-5)")
    for name, fn in wide.items():
        ms, dms = timed(torch, fn)
        print(f"  unit step at N={nc} through {name}: {ms:.4f} ms (device {dms})")

    for B in (1, 16):
        skg = make_accum_sketch(gc, nc, d, B, device=dev)
        idg, cfg = skg.indices.contiguous(), skg.coef.float().contiguous()
        for dt, tol in [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)]:
            Kt = Kc.to(dt)
            got = KN.accum_grow_slabs(Kt, idg, cfg, Cw, aw)
            plain = ref.accum_grow_ref(Kt, idg, cfg, Cw, aw)
            errs = [close(x, y, tol) for x, y in zip(got, plain)]
            C2 = Cw.clone()
            again = KN.accum_grow_slabs(Kt, idg, cfg, C2, aw, out=C2)
            same = all(torch.equal(x, y) for x, y in zip(again, got))
            check(all(e[2] for e in errs) and same,
                  f"accum_grow_slabs {dt} n={nc} d={d} B={B}: C_new, TᵀG, TᵀC max "
                  f"abs {', '.join(f'{e[0]:.3e}' for e in errs)} (tol {tol}); "
                  f"written over Cin: {'same bits' if same else 'DIFFERENT'}")
            ms, dms = timed(torch, lambda: KN.accum_grow_slabs(Kt, idg, cfg, Cw, aw))
            pms, _ = timed(torch, lambda: ref.accum_grow_ref(Kt, idg, cfg, Cw, aw))
            isz = Kt.element_size()
            b, by = bound_ms(nc * distinct(idg) * isz + 2 * nc * d * 4 + B * d * 8
                             + 2 * d * d * 4,
                             2 * nc * B * d + 2 * nc * d + 4 * B * d * d)
            print(f"  accum_grow_slabs {dt} B={B}: {ms:.4f} ms (device {dms}), "
                  f"plain {pms:.4f} ms, bound {b:.5f} ms")
            gb_grow = gather_bounds(f"accum_grow_slabs {dt} B={B}", dms, b, idg, nc, isz,
                                    2 * nc * d * 4 + B * d * 8 + 2 * d * d * 4)
            if dt == torch.float32 and B == 16:
                # no one PyTorch call returns C_new with both d×d pieces
                rows["accum_grow_slabs"] = dict(
                    replaces=f"{TPU}:370", max_abs_err=max(e[0] for e in errs),
                    max_rel_err=max(e[1] for e in errs), ms=ms, device_ms=dms,
                    plain_ms=pms, bound_ms=b, bound_by=by, library_ms=None, **gb_grow)
                rows["accum_grow_slabs"].update(geometry(
                    "accum_grow_slabs", "accum_grow", (nc, nc, d, B), dt,
                    OPS._gemm_candidates(nc, AT.STATIC_TABLE["accum_grow"]),
                    lambda c: KN.accum_grow_slabs(Kt, idg, cfg, Cw, aw, bm=c[0]),
                    lambda: OPS.accum_grow_kernel(Kt, idg, cfg, Cw, aw)))
            del Kt, got, plain, again, C2
    del Kc, Cw

    # accum_step_slab at the unit schedule's N = 8192 (phase (g)'s K)
    g8, X8, f8, y8 = regression(N_STEP, 5)
    K8 = KernelOperator(X8, "gaussian", bw).dense()
    sk8 = make_accum_sketch(g8, N_STEP, d, 1, device=dev)
    id8, cf8 = sk8.indices.contiguous(), sk8.coef.float().contiguous()
    C8 = torch.randn((N_STEP, d), generator=g8, device=dev)
    out = KN.accum_step_slab(K8, id8, cf8, C8, aw)
    ea, er, ok = close(out, ref.accum_step_ref(K8, id8, cf8, C8, aw), 1e-5)
    check(ok, f"accum_step_slab f32 N={N_STEP} d={d}: max abs {ea:.3e}, /max|plain| "
              f"{er:.3e} (tol 1e-5)")
    ea16, _, ok = close(KN.accum_step_slab(K8.bfloat16(), id8, cf8, C8, aw),
                        ref.accum_step_ref(K8.bfloat16(), id8, cf8, C8, aw), 1e-5)
    check(ok, f"accum_step_slab bf16 K: max abs {ea16:.3e} (tol 1e-5)")
    ms, dms = timed(torch, lambda: KN.accum_step_slab(K8, id8, cf8, C8, aw))
    pms, _ = timed(torch, lambda: ref.accum_step_ref(K8, id8, cf8, C8, aw))
    S8 = sketch_csr(torch, id8, cf8, N_STEP)
    lib = torch.addmm(C8, K8, S8, beta=aw)
    print(f"  torch.addmm(C, K, S, beta=a) vs kernel: max abs "
          f"{(lib - out).abs().max().item():.3e}")
    lms, ldms = timed(torch, lambda: torch.addmm(C8, K8, S8, beta=aw))
    print(f"  torch.addmm(C, K, S, beta=a): {lms:.4f} ms (device {ldms})")
    b, by = bound_ms(N_STEP * distinct(id8) * 4 + 2 * N_STEP * d * 4 + d * 8,
                     3 * N_STEP * d)
    rows["accum_step_slab"] = dict(replaces=f"{TPU}:277", max_abs_err=ea,
                                   max_rel_err=er, ms=ms, device_ms=dms,
                                   plain_ms=pms, bound_ms=b, bound_by=by,
                                   library_ms=lms,
                                   **gather_bounds(f"accum_step_slab f32 N={N_STEP}", dms, b,
                                                   id8, N_STEP, 4,
                                                   2 * N_STEP * d * 4 + d * 8))
    # the unit step's geometry is the table's alone, as in the reference
    rows["accum_step_slab"].update(geometry(
        "accum_step_slab", "accum_apply", (N_STEP, N_STEP, d, 1), torch.float32,
        OPS._gemm_candidates(N_STEP, AT.STATIC_TABLE["accum_apply"]),
        lambda c: (KN.accum_step_slab(K8, id8, cf8, C8, aw, bm=c[0]),)))
    del out, lib, C8

    # the serving path's kernels: landmark_attention at the decode shape
    # (B·Hkv = 32 problems of G = 4 query rows over d_slots = 1024 slots)
    # and at the F-stage shape of accum_attention, landmark_stats at S = 32768
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gl = torch.Generator(device=dev).manual_seed(7)
    P, G, Lm, Dh = 32, 4, 1024, 128

    def randn(*shape):
        return torch.randn(shape, generator=gl, device=dev)

    qd, ktd, Md = randn(P, G, Dh), randn(P, Lm, Dh), randn(P, Lm, Dh)
    # the bias lane of a decode: log(mass) of the filled slots, −1e30 for
    # the empty ones (about a tenth here)
    mass = 3 * torch.rand((P, Lm), generator=gl, device=dev)
    bias = torch.where(mass < 0.3, -1e30, torch.log(mass))
    out = LK.landmark_attention(qd, ktd, Md, bias)
    ea, er, ok = close(out, LR.landmark_attention_ref(qd, ktd, Md, bias), 1e-5)
    check(ok, f"landmark_attention f32 decode P={P} G={G} L={Lm} Dh={Dh}: max abs "
              f"{ea:.3e}, /max|plain| {er:.3e} (tol 1e-5)")
    check(torch.equal(LK.landmark_attention(qd, ktd, Md, bias), out),
          "landmark_attention decode: a second call gives the same bits")
    ms, dms = timed(torch, lambda: LK.landmark_attention(qd, ktd, Md, bias))
    pms, _ = timed(torch, lambda: LR.landmark_attention_ref(qd, ktd, Md, bias))
    mask = bias[:, None, :]
    print(f"  SDPA(q, k̃, M, attn_mask=bias) vs kernel: max abs "
          f"{(sdpa(qd, ktd, Md, attn_mask=mask) - out).abs().max().item():.3e}")
    lms, ldms = timed(torch, lambda: sdpa(qd, ktd, Md, attn_mask=mask))
    nbytes = (qd.numel() + ktd.numel() + Md.numel() + bias.numel() + out.numel()) * 4
    b, by = bound_ms(nbytes, 2 * P * G * Lm * 2 * Dh)
    per_call = device_ops_per_call(torch, lambda: LK.landmark_attention(qd, ktd, Md, bias))
    nsplit, run = LK.plan(P, G, Lm, Dh, Dh, torch.float32)
    print(f"  landmark_attention decode: {ms:.4f} ms (device {dms}), plain {pms:.4f} ms, "
          f"bound {b:.5f} ms by {by}, SDPA {lms:.4f} ms (device {ldms}); "
          f"{b / (dms or math.nan):.1%} of the byte bound on device time ({b / ms:.1%} on "
          f"CUDA events), {nbytes / (dms or math.nan) / 1e9:.3f} TB/s; {per_call:g} device "
          f"operations a call; "
          f"{nsplit} splits × {LK.DECODE_WARPS} warps × {run} keys")
    qh, kh, Mh = qd.bfloat16(), ktd.bfloat16(), Md.bfloat16()
    outh = LK.landmark_attention(qh, kh, Mh, bias)
    eh, rh, okh = close(outh, LR.landmark_attention_ref(qh, kh, Mh, bias), 2e-2)
    check(okh and outh.dtype == torch.bfloat16,
          f"landmark_attention bf16 decode: max abs {eh:.3e}, /max|plain| {rh:.3e} "
          f"(tol 2e-2)")
    hms, hdms = timed(torch, lambda: LK.landmark_attention(qh, kh, Mh, bias))
    hbytes = (qh.numel() + kh.numel() + Mh.numel() + outh.numel()) * 2 + bias.numel() * 4
    hb, _ = bound_ms(hbytes, 2 * P * G * Lm * 2 * Dh)
    print(f"  landmark_attention bf16 decode: {hms:.4f} ms (device {hdms}), bound "
          f"{hb:.5f} ms, {hb / (hdms or math.nan):.1%} of it on device time")
    rows["landmark_attention"] = dict(replaces=f"{LTPU}:54", max_abs_err=ea,
                                      max_rel_err=er, ms=ms, device_ms=dms,
                                      plain_ms=pms, bound_ms=b, bound_by=by,
                                      library_ms=lms, library_device_ms=ldms,
                                      library="SDPA with the bias as attn_mask",
                                      shape="decode P=32 G=4 L=1024",
                                      share_of_bound=b / (dms or math.nan),
                                      tb_per_s=nbytes / (dms or math.nan) / 1e9,
                                      device_ops_per_call=per_call,
                                      plan=dict(splits=nsplit, warps=LK.DECODE_WARPS,
                                                keys_a_warp=run),
                                      bf16=dict(max_abs_err=eh, ms=hms, device_ms=hdms,
                                                bound_ms=hb),
                                      bound_tc_ms=None)   # the decode sweep: bytes
    rows["landmark_attention"].update(geometry(
        "landmark_attention decode", "landmark_attention", (P, G, Dh, Lm, Dh), torch.float32,
        LO._bq_candidates(G, (LK.static_bq(G),), Dh, torch.float32, torch.float32, dev),
        lambda c: (LK.landmark_attention(qd, ktd, Md, bias, bq=c[0]),),
        lambda: LO.landmark_attend(qd, ktd, Md, bias)))
    # zamba2-7b's sketched decode (path (p)): head dim 112, one row a
    # problem (32 heads, no GQA), B·Hkv = 4·32 problems over d_slots = 1024
    P112, D112 = 4 * 32, 112
    q1, k1, M1 = randn(P112, 1, D112), randn(P112, Lm, D112), randn(P112, Lm, D112)
    mass1 = 3 * torch.rand((P112, Lm), generator=gl, device=dev)
    bias1 = torch.where(mass1 < 0.3, -1e30, torch.log(mass1))
    dh112 = {}
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        qq, kk1, MM = q1.to(dt), k1.to(dt), M1.to(dt)
        out = LK.landmark_attention(qq, kk1, MM, bias1)
        e1, r1, ok1 = close(out, LR.landmark_attention_ref(qq, kk1, MM, bias1), tol)
        check(ok1 and out.dtype == dt and torch.equal(LK.landmark_attention(qq, kk1, MM, bias1),
                                                      out),
              f"landmark_attention {dt} decode at head dim {D112} P={P112} G=1 L={Lm}: "
              f"max abs {e1:.3e}, /max|plain| {r1:.3e} (tol {tol:g}), a second call the "
              f"same bits")
        ms1, dms1 = timed(torch, lambda: LK.landmark_attention(qq, kk1, MM, bias1))
        pms1, _ = timed(torch, lambda: LR.landmark_attention_ref(qq, kk1, MM, bias1))
        # the library call: SDPA with the bias as the mask, in the inputs' dtype
        mask1 = bias1[:, None, :].to(dt)
        lms1, ldms1 = timed(torch, lambda: sdpa(qq, kk1, MM, attn_mask=mask1))
        nb1 = (qq.numel() + kk1.numel() + MM.numel() + out.numel()) * qq.element_size() \
            + bias1.numel() * 4
        b1, _ = bound_ms(nb1, 2 * P112 * Lm * 2 * D112)
        print(f"  landmark_attention {dt} decode, head dim {D112}: {ms1:.4f} ms (device "
              f"{dms1}), plain {pms1:.4f} ms, SDPA {lms1:.4f} ms (device {ldms1}), bound "
              f"{b1:.5f} ms, {b1 / dms1 if dms1 else 0:.1%} of it on device time")
        dh112[str(dt).split(".")[-1]] = dict(max_abs_err=e1, max_rel_err=r1, ms=ms1,
                                             device_ms=dms1, plain_ms=pms1, bound_ms=b1,
                                             library_ms=lms1, library_device_ms=ldms1)
    rows["landmark_attention"]["decode_dh112"] = dict(shape=f"P={P112} G=1 L={Lm} Dh={D112}",
                                                      **dh112)
    del q1, k1, M1, bias1, mass1, qq, kk1, MM
    qf, Mf = randn(P, S_ATT, Dh), randn(P, Lm, Dh)
    out = LK.landmark_attention(qf, ktd, Mf)
    plain = LR.landmark_attention_ref(qf, ktd, Mf)
    ea, er, ok = close(out, plain, 1e-5)
    check(ok, f"landmark_attention f32 F-stage P={P} S={S_ATT} L={Lm}: max abs {ea:.3e}, "
              f"/max|plain| {er:.3e} (tol 1e-5)")
    del plain
    ms, dms = timed(torch, lambda: LK.landmark_attention(qf, ktd, Mf))
    pms, _ = timed(torch, lambda: LR.landmark_attention_ref(qf, ktd, Mf))
    lms, ldms = timed(torch, lambda: sdpa(qf, ktd, Mf))
    flops = 2 * P * S_ATT * Lm * 2 * Dh
    b, by = bound_ms((qf.numel() + ktd.numel() + Mf.numel() + out.numel()) * 4, flops)
    print(f"  landmark_attention F-stage: {ms:.4f} ms (device {dms}), plain {pms:.4f} ms, "
          f"bound {b:.5f} ms by {by}, SDPA {lms:.4f} ms (device {ldms})")
    rows["landmark_attention"]["f_stage"] = dict(
        shape=f"P={P} S={S_ATT} L={Lm}", max_abs_err=ea, ms=ms, device_ms=dms,
        plain_ms=pms, bound_ms=b, bound_by=by, library_ms=lms, library_device_ms=ldms,
        **rate("landmark_attention F-stage", ms, flops, b,
               3 * flops / TF32_OPS_PER_S * 1e3))
    rows["landmark_attention"]["f_stage"].update(geometry(
        "landmark_attention F-stage", "landmark_attention", (P, S_ATT, Dh, Lm, Dh),
        torch.float32,
        LO._bq_candidates(S_ATT, (LK.static_bq(S_ATT),), Dh, torch.float32, torch.float32,
                          dev),
        lambda c: (LK.landmark_attention(qf, ktd, Mf, bq=c[0]),),
        lambda: LO.landmark_attend(qf, ktd, Mf)))
    del qf, Mf, out
    nv, lv = S_ATT - 1000, Lm - 24
    qt, kk, vv = randn(P, Lm, Dh), randn(P, S_ATT, Dh), randn(P, S_ATT, Dh)
    W, BmV = LK.landmark_stats(qt, ktd, kk, vv, n_valid=nv, l_valid=lv)
    Wr, Br = LR.landmark_stats_ref(qt, ktd, kk, vv, n_valid=nv, l_valid=lv)
    eW, rW, okW = close(W, Wr, 1e-5)
    eB, rB, okB = close(BmV, Br, 1e-5)
    check(okW and okB, f"landmark_stats f32 P={P} L={Lm} S={S_ATT} n_valid={nv} "
                       f"l_valid={lv}: W max abs {eW:.3e} (/max {rW:.3e}), BmV max abs "
                       f"{eB:.3e} (/max {rB:.3e}) (tol 1e-5)")
    del Wr, Br
    ms, dms = timed(torch, lambda: LK.landmark_stats(qt, ktd, kk, vv, n_valid=nv,
                                                     l_valid=lv))
    pms, _ = timed(torch, lambda: LR.landmark_stats_ref(qt, ktd, kk, vv, n_valid=nv,
                                                        l_valid=lv))
    kv_, vv_ = kk[:, :nv], vv[:, :nv]
    lms, ldms = timed(torch, lambda: sdpa(qt, kv_, vv_))
    # the BmV sweep on the tensor cores, the W half on IEEE FMA
    flops_b, flops_w = 2 * P * Lm * nv * 2 * Dh, 2 * P * Lm * lv * Dh
    b, by = bound_ms((2 * P * Lm * Dh + 2 * P * nv * Dh + P * Lm * Lm + P * Lm * Dh) * 4,
                     flops_b + flops_w)
    print(f"  landmark_stats: {ms:.4f} ms (device {dms}), plain {pms:.4f} ms, bound "
          f"{b:.5f} ms by {by}; SDPA(q̃, K, V), the BmV half only: {lms:.4f} ms "
          f"(device {ldms})")
    rows["landmark_stats"] = dict(replaces=f"{LTPU}:138", max_abs_err=max(eW, eB),
                                  max_rel_err=max(rW, rB), ms=ms, device_ms=dms,
                                  plain_ms=pms, bound_ms=b, bound_by=by, library_ms=lms,
                                  library_device_ms=ldms,
                                  library="SDPA(q̃, K, V): the BmV half only",
                                  shape=f"P={P} L={Lm} S={S_ATT}",
                                  **rate("landmark_stats", ms, flops_b + flops_w, b,
                                         (3 * flops_b / TF32_OPS_PER_S
                                          + flops_w / F32_OPS_PER_S) * 1e3))
    # the cache chooses at the unmasked shape (its entry point takes no
    # masks); the masked launch is timed at its choice
    rows["landmark_stats"].update(geometry(
        "landmark_stats", "landmark_stats", (P, S_ATT, Dh, Lm, Dh), torch.float32,
        LO._bq_candidates(Lm, AT.STATIC_TABLE["landmark_stats"], Dh, torch.float32,
                          torch.float32, dev),
        lambda c: LK.landmark_stats(qt, ktd, kk, vv, n_valid=nv, l_valid=lv, bs=c[0]),
        lambda: LO.landmark_stats_fused(qt, ktd, kk, vv)))
    del qt, kk, vv, kv_, vv_, W, BmV, qd, ktd, Md
    torch.cuda.synchronize()

    # ---- 3. the main paths, run twice -------------------------------------- #
    ALL = KN.KERNELS + LK.KERNELS

    def reset_counts():
        """Set every launch count to 0 (a path's start: the time so far printed)."""
        print(f"  [{time.perf_counter() - t_start:.1f} s since the script started]")
        for f in ALL:
            f.launches = 0

    def counts():
        return {f.__name__: f.launches for f in ALL}

    @contextlib.contextmanager
    def off_path():
        """Calls made only to check the main path: their launches are undone,
        and under pass 3's profiler they launch outside the wrappers' ranges."""
        saved, ranges = counts(), AT.PROFILE_RANGES
        AT.PROFILE_RANGES = False
        yield
        AT.PROFILE_RANGES = ranges
        for f in ALL:
            f.launches = saved[f.__name__]

    trace = PathTrace(torch, AT, False)

    def run_paths(label):
        """Drive the three main paths (a)–(l), each with the launch counts
        set to 0 just before it; return (launches by path, outputs to hold
        across passes).  The data are drawn anew from the seeds of section 2."""
        print(f"\n== main path ({label}) ==")
        gb, Xb, fb, yb = regression(nb, 2)
        skb = make_accum_sketch(gb, nb, d, m, device=dev)
        gc, Xc, fc, yc = regression(nc, 3)
        skc = make_accum_sketch(gc, nc, d, m, device=dev)
        opc = KernelOperator(Xc, "gaussian", bw)
        g8, X8, f8, y8 = regression(N_STEP, 5)
        K8 = KernelOperator(X8, "gaussian", bw).dense()
        held = {}
        reset_counts()
        trace.begin("krr")
        phase_launches = {}

        # (a) quickstart §1.  One draw does not order the two (the reference's
        # own key-0 draw gives Nyström the lower error), so the claim is held as
        # the median over DRAWS draws of each sketch.
        n, da = 2000, 40
        ga, Xa, _, ya = regression(n, 0)
        fitted_exact = krr_exact_fitted(gauss(Xa.double(), Xa.double()),
                                        ya.double(), lam)
        errs = {"nystrom m=1": [], "accumulation m=8": []}
        for _ in range(DRAWS):
            for name, sk in {
                    "nystrom m=1": make_nystrom_sketch(ga, n, da, device=dev),
                    "accumulation m=8": make_accum_sketch(ga, n, da, m=8,
                                                          device=dev)}.items():
                model = krr_sketched_fit_matfree(Xa, ya, lam, sk, gauss)
                errs[name].append(
                    insample_error(model.fitted.double(), fitted_exact).item())
        med = {k: statistics.median(v) for k, v in errs.items()}
        for name, v in med.items():
            print(f"  (a) {name:17s} median ‖f̂_S − f̂_n‖²_n over {DRAWS} draws = "
                  f"{v:.3e}")
        check(all(math.isfinite(e) for v in errs.values() for e in v)
              and med["accumulation m=8"] < med["nystrom m=1"],
              "(a) accumulation m=8 beats Nyström m=1 against exact KRR (median)")
        phase_launches["a"] = counts()

        # (b) operator fit + predict at n = 2^21
        opb = KernelOperator(Xb, "gaussian", bw)
        model_b, tb = wall(torch, lambda: krr_sketched_fit(opb, yb, lam, skb))
        gt = torch.Generator(device=dev).manual_seed(4)
        Xt = torch.rand((N_TEST, 3), generator=gt, device=dev)
        pred, tp = wall(torch, lambda: model_b.predict(Xt))
        with off_path():
            pred_plain = opb.cross_cols(Xt, skb, use_kernel=False) @ model_b.theta
        rel = ((pred - pred_plain).norm() / pred_plain.norm()).item()
        mse = torch.mean((model_b.fitted - fb) ** 2).item()
        print(f"  (b) fit n={nb} d={d} m={m}: {tb * 1e3:.1f} ms; predict {N_TEST} rows:"
              f" {tp * 1e3:.1f} ms; C {nb * d * 4 / 2**20:.0f} MiB on the card")
        check(bool(model_b.fitted.isfinite().all()) and bool(pred.isfinite().all())
              and tuple(pred.shape) == (N_TEST,),
              f"(b) fitted and predictions finite; MSE to f_true {mse:.3e}")
        check(rel <= 1e-4, f"(b) predict vs plain route: rel {rel:.3e} (tol 1e-4)")
        # the same fit again: with the cache on, the first call measured
        # matfree_apply's candidates (cold) and this one is a cache hit (warm)
        with off_path():
            _, tw = wall(torch, lambda: krr_sketched_fit(opb, yb, lam, skb))
        geo = AT.lookup("matfree_cols", (nb, 3, d, m, "gaussian"), torch.float32, dev,
                        arity=1, source=KN.source_hash())
        print(f"  (b) fit: first call {tb * 1e3:.1f} ms, the same fit again {tw * 1e3:.1f} "
              f"ms; matfree_apply geometry {geo or 'static'} (rows a block)")
        held.update(b=model_b.fitted, b_pred=pred)
        phase_launches["b"] = counts()

        # (c) dense-K fit at n = 32768 vs the operator fit on the same data
        def dense_fit():
            return krr_sketched_fit(opc.dense(), yc, lam, skc)

        model_c, tc = wall(torch, dense_fit)
        with off_path():
            Kc = opc.dense()
            Cd, Wd = A.sketch_both(Kc, skc)
            del Kc
            Co, Wo = opc.sketch_both(skc)
            model_o = krr_sketched_fit(opc, yc, lam, skc)
        rC = ((Cd - Co).norm() / Co.norm()).item()
        rW = ((Wd - Wo).norm() / Wo.norm()).item()
        Mo = Co.T @ Co + nc * lam * Wo
        rhs = Co.T @ yc
        res = ((Mo @ model_c.theta - rhs).norm() / rhs.norm()).item()
        res_own = ((Mo @ model_o.theta - rhs).norm() / rhs.norm()).item()
        rf = ((model_c.fitted - model_o.fitted).norm() / model_o.fitted.norm()).item()
        # the kernels are deterministic, so the C compared here is the timed
        # fit's own: its fitted values are this C times its θ
        rown = ((Cd @ model_c.theta - model_c.fitted).norm()
                / model_c.fitted.norm()).item()
        print(f"  (c) dense-K fit n={nc} (K built on the card): {tc * 1e3:.1f} ms")
        check(rC <= 1e-4 and rW <= 1e-4,
              f"(c) dense ≡ operator: C rel {rC:.3e}, W rel {rW:.3e} (tol 1e-4)")
        check(res <= 1e-4, f"(c) dense θ in the operator's d×d system: relative "
                           f"residual {res:.3e} (operator θ: {res_own:.3e}; tol "
                           f"1e-4); fitted rel diff {rf:.3e}")
        check(bool(model_c.fitted.isfinite().all()) and rown <= 1e-6,
              f"(c) fitted finite and equal to C·θ of the compared C: rel "
              f"{rown:.3e} (tol 1e-6)")
        held["c"] = model_c.fitted
        phase_launches["c"] = counts()

        # (d) PCG on (b)'s data
        model_d, td = wall(torch, lambda: krr_sketched_fit_pcg(opb, yb, lam, skb,
                                                               iters=30))
        rd = ((model_d.fitted - model_b.fitted).norm()
              / model_b.fitted.norm()).item()
        mse_d = torch.mean((model_d.fitted - fb) ** 2).item()
        print(f"  (d) PCG fit n={nb}, 30 iterations: {td * 1e3:.1f} ms")
        check(bool(model_d.fitted.isfinite().all()),
              f"(d) PCG fitted finite; rel diff to the direct solve {rd:.3e}; MSE "
              f"to f_true {mse_d:.3e} (direct {mse:.3e})")
        phase_launches["d"] = counts()
        trace.end()
        launches = {"krr": counts()}
        print(f"  launches after each phase (cumulative): {phase_launches}")
        for name in ("matfree_apply", "accum_apply_left", "accum_sketch_both"):
            cnt = launches["krr"][name]
            check(cnt > 0, f"{name} launched {cnt} times on the KRR path (a)-(d)")
        del model_b, model_c, model_d, model_o, Cd, Co, pred, pred_plain

        # ---- 4. the progressive engine's path ----------------------------------- #
        print("\n== main path: the progressive engine ==")
        reset_counts()
        trace.begin("engine")
        phase_launches = {}

        def rel(x, y):
            return ((x - y).norm() / y.norm()).item()

        # (e) quickstart §2: error targets in place of m on a precomputed K; one
        # seed, so a smaller target walks further along the same trajectory
        de, lam_e = 32, 1e-3
        Ke = get_kernel("gaussian", 0.4)(Xa, Xa)
        exact_e = krr_exact_fitted(Ke.double(), ya.double(), lam_e)
        chosen = []
        for tol in (0.2, 0.05, 0.02):
            model = krr_sketched_fit_adaptive(Ke, ya, lam_e, SEED, de, tol=tol, m_max=32)
            info = model.info
            chosen.append(info["m"])
            err = insample_error(model.fitted.double(), exact_e).item()
            print(f"  (e) tol={tol:5.2f}: m={info['m']:2d} in {info['passes']} passes "
                  f"(est err {info['err']:.3f}), ‖f̂_S − f̂_n‖²_n = {err:.3e}")
            check(math.isfinite(err) and (info["err"] <= tol or info["m"] == 32),
                  f"(e) tol={tol}: the estimate clears the target or m = m_max")
        check(chosen == sorted(chosen), f"(e) chosen m {chosen} does not shrink as tol shrinks")
        del Ke
        phase_launches["e"] = counts()

        # (f) adaptive KRR on a dense K at n = 32768, doubling then unit schedule
        Kf, tk = wall(torch, opc.dense)
        before = KN.accum_grow_slabs.launches
        model_f, tf = wall(torch, lambda: krr_sketched_fit_adaptive(
            Kf, yc, lam, SEED, d, tol=TOL_F, m_max=32))
        info = model_f.info
        grows = KN.accum_grow_slabs.launches - before
        print(f"  (f) doubling fit n={nc} d={d}: {tf * 1e3:.1f} ms (K built in "
              f"{tk * 1e3:.1f} ms): m={info['m']} in {info['passes']} passes, est err "
              f"{info['err']:.4f} (tol {TOL_F}); accum_grow_slabs launches {grows}")
        check(grows == info["passes"] <= 6 and bool(model_f.fitted.isfinite().all()),
              "(f) one accum_grow_slabs launch per executed batch, at most 6")
        _, Cf, Wf, info_g = A.grow_sketch_both(SEED, Kf, d, m_max=32, tol=TOL_F)
        rown = rel(Cf @ model_f.theta, model_f.fitted)
        check(info_g["m"] == info["m"] and rown <= 1e-6,
              f"(f) the fit's fitted values are C·θ of the engine's C: rel {rown:.3e}")
        with off_path():
            st = A.accum_grow(Kf, A.accum_init(stream_generator(SEED), nc, d, 32,
                                               device=dev), info["m"])
        rC, rW = rel(Cf, st.C), rel(Wf, st.W)
        check(rC <= 1e-5 and rW <= 1e-5,
              f"(f) doubling ≡ unit growth (accum_apply route) to m={info['m']}: "
              f"C rel {rC:.3e}, W rel {rW:.3e} (tol 1e-5)")
        del st, Cf, Wf
        model_u, tu = wall(torch, lambda: krr_sketched_fit_adaptive(
            Kf, yc, lam, SEED, d, tol=TOL_F, m_max=32, schedule="unit"))
        print(f"  (f) unit fit: {tu * 1e3:.1f} ms: m={model_u.info['m']} in "
              f"{model_u.info['passes']} passes, est err {model_u.info['err']:.4f}")
        check(bool(model_u.fitted.isfinite().all())
              and (model_u.info["err"] <= TOL_F or model_u.info["m"] == 32),
              "(f) unit fit finite; the estimate clears the target or m = m_max")
        held.update(f=model_f.fitted, f_unit=model_u.fitted)
        del Kf, model_f, model_u
        phase_launches["f"] = counts()

        # (g) the unit schedule at n = 8192, one accum_step_slab per slab
        (skg, Cg, Wg, info), tg = wall(torch, lambda: A.grow_sketch_both(
            SEED, K8, d, m_max=16, tol=TOL_G, schedule="unit"))
        print(f"  (g) unit growth n={N_STEP}: {tg * 1e3:.1f} ms, m={info['m']}, est err "
              f"{info['err']:.4f} (tol {TOL_G})")
        with off_path():
            st = A.accum_grow_batched(K8, A.accum_init(stream_generator(SEED), N_STEP, d,
                                                       16, device=dev), info["m"])
        rC, rW = rel(Cg, st.C), rel(Wg, st.W)
        check(info["passes"] == info["m"] and rC <= 1e-5 and rW <= 1e-5,
              f"(g) unit ≡ batched growth to m={info['m']}: C rel {rC:.3e}, W rel "
              f"{rW:.3e} (tol 1e-5)")
        held.update(g_C=Cg, g_W=Wg)
        del K8, st, Cg, Wg
        phase_launches["g"] = counts()

        # (h) the engine on the operator at n = 2^21: matfree_apply on (B, d) blocks
        model_h, th = wall(torch, lambda: krr_sketched_fit_adaptive(
            opb, yb, lam, SEED, d, tol=TOL_H, m_max=16))
        info = model_h.info
        pred = model_h.predict(Xt)
        with off_path():
            pred_plain = opb.cross_cols(Xt, model_h.sk, use_kernel=False) @ model_h.theta
        rp = rel(pred, pred_plain)
        mse_h = torch.mean((model_h.fitted - fb) ** 2).item()
        print(f"  (h) operator fit n={nb} d={d}: {th * 1e3:.1f} ms, m={info['m']} in "
              f"{info['passes']} passes, est err {info['err']:.4f} (tol {TOL_H}); MSE "
              f"to f_true {mse_h:.3e}")
        check(bool(model_h.fitted.isfinite().all()) and rp <= 1e-4,
              f"(h) predict vs plain route: rel {rp:.3e} (tol 1e-4)")
        held["h"] = model_h.fitted
        del model_h, pred, pred_plain
        phase_launches["h"] = counts()

        # (i) spectral clustering of four planted blobs (examples/
        # sketched_pca_kmeans.py: centres 4·e_j in p = 32, spread 0.5, bandwidth 4)
        gi = torch.Generator(device=dev).manual_seed(6)
        truth = torch.arange(nc, device=dev) % 4
        Xi = 0.5 * torch.randn((nc, 32), generator=gi, device=dev)
        Xi[torch.arange(nc, device=dev), truth] += 4.0
        Ki = get_kernel("gaussian", 4.0)(Xi, Xi)
        res_fix, tfix = wall(torch, lambda: spectral_cluster(SEED, Ki, 4, d=32, m=8))
        res_tol, ttol = wall(torch, lambda: spectral_cluster(SEED, Ki, 4, d=32,
                                                             tol=0.2, m_max=16))
        pa_fix = pairwise_agreement(torch, truth, res_fix.labels)
        pa_tol = pairwise_agreement(torch, truth, res_tol.labels)
        print(f"  (i) spectral n={nc}: fixed m=8 {tfix * 1e3:.1f} ms, agreement "
              f"{pa_fix:.4f}; tol=0.2 {ttol * 1e3:.1f} ms, m={res_tol.info['m']} "
              f"(est err {res_tol.info['err']:.3f}), agreement {pa_tol:.4f}")
        check(pa_tol >= pa_fix, "(i) the tol route agrees with the planted labels at "
                                "least as well as fixed m=8")
        held.update(i_fix=res_fix.labels, i_tol=res_tol.labels)
        del Ki, Xi
        phase_launches["i"] = counts()
        trace.end()
        launches["engine"] = counts()
        print(f"  launches after each phase (cumulative): {phase_launches}")
        for name in ("accum_apply", "accum_step_slab", "accum_grow_slabs"):
            cnt = launches["engine"][name]
            check(cnt > 0, f"{name} launched {cnt} times on the engine path (e)-(i)")
        del opb, Xb, yb, fb, Xt, Xc, yc, opc
        torch.cuda.empty_cache()

        # ---- 5. the serving path: minitron-8b at full width ---------------------- #
        print(f"\n== main path: serving {ARCH} ==")
        reset_counts()
        trace.begin("serve")
        phase_launches = {}
        cfg = get_config(ARCH)
        sa = cfg.sketch_attn
        L_ = cfg.n_layers
        params, tinit = wall(torch, lambda: init_params(SEED, cfg, device=dev))
        print(f"  (j) {ARCH}: {param_count(params) / 1e9:.3f} B parameters, bfloat16, drawn "
              f"from seed {SEED} on the card in {tinit:.1f} s")
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                generator=torch.Generator().manual_seed(SEED)).numpy()
        served = {}
        for mode in ("exact", "sketched"):
            # PROFILED more positions of room: the profiled decode steps below
            eng = Engine(cfg, params, ServeConfig(max_len=PROMPT + NEW + PROFILED,
                                                  use_sketch=mode == "sketched"))
            (cache, logits), tpre = wall(torch, lambda: eng.prefill_tokens(
                eng.new_cache(BATCH), prompts))
            check(bool(logits.isfinite().all()) and logits.dtype == torch.float32
                  and tuple(logits.shape) == (BATCH, cfg.vocab_size),
                  f"(j) {mode} prefill logits finite, float32, ({BATCH}, {cfg.vocab_size})")
            del cache, logits
            torch.cuda.reset_peak_memory_stats()
            before = LK.landmark_attention.launches
            (toks, cache), tgen = wall(torch, lambda: eng.generate(prompts, NEW))
            la = LK.landmark_attention.launches - before
            nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(cache))
            tdec = tgen - tpre
            served[mode] = toks
            held[f"j_{mode}"] = torch.as_tensor(toks)
            print(f"  (j) {mode:8s}: prefill {BATCH}×{PROMPT} tokens {tpre * 1e3:.1f} ms; "
                  f"generate {NEW} tokens {tgen * 1e3:.1f} ms, so decode {NEW - 1} steps "
                  f"{tdec * 1e3:.1f} ms = {BATCH * (NEW - 1) / tdec:.1f} tokens/s; cache "
                  f"{nbytes / 1e9:.3f} GB; peak {torch.cuda.max_memory_allocated() / 1e9:.1f} "
                  f"GB; landmark_attention launches {la}")
            check(toks.shape == (BATCH, NEW) and bool(((toks >= 0) & (toks < cfg.vocab_size))
                                                      .all()),
                  f"(j) {mode}: {BATCH}×{NEW} tokens in the vocabulary")
            want = L_ * (NEW - 1) if mode == "sketched" else 0
            check(la == want, f"(j) {mode}: landmark_attention launched {la} times, "
                              f"n_layers × (n_new − 1) = {want} expected")
            # where a decode step's time goes: PROFILED more steps under the
            # profiler (device time against the unprofiled step time above), and
            # a 1024-token prefill
            last = torch.as_tensor(toks[:, -1], device=dev)

            def steps(cache=cache):
                for i in range(PROFILED):
                    pos = PROMPT + NEW - 1 + i
                    _, cache = decode_step(params, cache, last, pos, cfg, slots=decode_slots(
                        SEED, pos, sa.d_slots, sa.m_r, max_len=eng.sc.max_len))

            if not trace.on:   # pass 3 is under the profiler already
                with off_path():
                    pw, pdev, top, by = profiled(torch, steps)
                    step_ms = tdec * 1e3 / (NEW - 1)
                    attend = sum(t for k, t in by.items() if "attend_decode_kernel" in k)
                    print(f"  (j) {mode}: {PROFILED} profiled decode steps: device "
                          f"{pdev / PROFILED:.2f} ms a step against {step_ms:.2f} ms "
                          f"unprofiled, so the device idles {1 - pdev / PROFILED / step_ms:.2f} "
                          f"of a step; the decode sweep (attend_decode_kernel) "
                          f"{attend / PROFILED:.3f} ms a step; top kernels {top}")
                    pw, pdev, top, _ = profiled(torch, lambda: eng.prefill_tokens(
                        eng.new_cache(BATCH), prompts[:, :1024]))
                    print(f"  (j) {mode}: profiled prefill of {BATCH}×1024 tokens: wall "
                          f"{pw:.1f} ms, device {pdev:.1f} ms; top kernels {top}")
            del cache, eng
        agree = float((served["exact"] == served["sketched"]).mean())
        print(f"  (j) greedy tokens equal in the two modes at {PROMPT} tokens of context: "
              f"{agree:.3f} (the sketched cache holds {sa.d_slots} slots)")
        phase_launches["j"] = counts()

        # (k) the fold at full width: the prefill cache is bitwise the sequential
        # fold; a draw with max_len > d_slots, so slots are shared
        table = decode_slot_table(SEED, 256, sa.d_slots, sa.m_r)
        gk = torch.Generator(device=dev).manual_seed(8)
        for dt in (torch.bfloat16, torch.float32):
            kk = torch.randn((BATCH, cfg.n_kv_heads, 256, cfg.head_dim), generator=gk,
                             device=dev).to(dt)
            vv = torch.randn(kk.shape, generator=gk, device=dev).to(dt)
            seq = init_sketch_cache(BATCH, cfg.n_kv_heads, sa.d_slots, cfg.head_dim, dt,
                                    device=dev)
            bat = prefill_sketch_cache(seq, kk, vv, table)
            for t in range(256):
                seq = update_sketch_cache(seq, kk[:, :, t], vv[:, :, t], table[t])
            same = all(torch.equal(a, b) for a, b in zip(bat, seq))
            check(same, f"(k) {dt} sketched prefill of 256 tokens ≡ the sequential fold "
                        f"bitwise ({BATCH}×{cfg.n_kv_heads}×{sa.d_slots}×{cfg.head_dim})")
            del kk, vv, seq, bat

        # (k) identity slots (max_len ≤ d_slots): sketched decode is exact
        # attention; the same tokens are forced through both caches.  Tolerance:
        # bfloat16 weights — every layer rounds its attention output to bfloat16
        # after float32 sums taken in another order on the two paths, so the
        # logits differ by bfloat16 noise (2⁻⁸ relative) carried through 32 layers
        ml = PROMPT_ID + NEW_ID
        pk = prompts[:, :PROMPT_ID]
        engs = {m: Engine(cfg, params, ServeConfig(max_len=ml, use_sketch=m == "sketched",
                                                   cache_dtype=torch.float32))
                for m in ("exact", "sketched")}
        forced, _ = engs["exact"].generate(pk, NEW_ID)
        forced_t = torch.as_tensor(forced, device=dev)
        logits_by = {}
        for mode, eng in engs.items():
            cache, lg = eng.prefill_tokens(eng.new_cache(BATCH), pk)
            out_l = [lg]
            for i in range(NEW_ID - 1):
                pos = PROMPT_ID + i
                lg, cache = decode_step(params, cache, forced_t[:, i], pos, cfg,
                                        slots=decode_slots(SEED, pos, sa.d_slots, sa.m_r,
                                                           max_len=ml))
                out_l.append(lg)
            logits_by[mode] = torch.stack(out_l, dim=1)
            del cache
        ex, sk_ = logits_by["exact"], logits_by["sketched"]
        dl = ((sk_ - ex).abs().max() / ex.abs().max()).item()
        agree = (sk_.argmax(-1) == ex.argmax(-1)).float().mean().item()
        check(dl <= 5e-2, f"(k) identity slots, {PROMPT_ID}-token prompt, {NEW_ID} forced "
                          f"tokens: sketched vs exact logits max abs diff / max|exact| "
                          f"{dl:.3e} (tol 5e-2); greedy agreement {agree:.4f}")
        del logits_by, ex, sk_, engs

        # (k) a generate killed at its 2nd decode chunk by the fault plan and
        # resumed from its checkpoint emits the same tokens bitwise
        kw = dict(max_len=2 * sa.d_slots, use_sketch=True, temperature=0.7, seed=3,
                  ckpt_every=4)
        pr = prompts[:1, :256]
        ref_toks, _ = Engine(cfg, params, ServeConfig(**kw)).generate(pr, 12)
        with tempfile.TemporaryDirectory() as ckdir:
            os.environ[faults.ENV_PLAN] = '{"decode.step": {"action": "kill", "at": 2}}'
            faults.reset()
            killed = False
            try:
                Engine(cfg, params, ServeConfig(ckpt_dir=ckdir, **kw)).generate(
                    pr, 12, request_id="r")
            except faults.DeviceLost:
                killed = True
            finally:
                del os.environ[faults.ENV_PLAN]
                faults.reset()
            eng = Engine(cfg, params, ServeConfig(ckpt_dir=ckdir, **kw))
            toks, _ = eng.generate(pr, 12, request_id="r")
        check(killed and (toks == ref_toks).all() and eng.health.count("ckpt.resume") == 1,
              f"(k) generate killed by the decode.step plan and resumed: same 12 tokens "
              f"bitwise ({'killed' if killed else 'NOT killed'})")
        del params, eng
        torch.cuda.empty_cache()
        phase_launches["k"] = counts()

        # (l) accum_attention on a make_seq_sketch draw: the kernel route
        # (landmark_stats, Newton–Schulz, landmark_attention) against the plain
        # one.  Tolerance 1e-3 relative: the six Newton–Schulz steps amplify the
        # float32 sum-order noise of W along its small singular directions (each
        # step scales them by up to 13/4)
        d_att, m_att = sa.d_slots, sa.m
        ga = torch.Generator(device=dev).manual_seed(9)
        qa, ka, va = (torch.randn((1, H_ATT, S_ATT, cfg.head_dim), generator=ga, device=dev)
                      for _ in range(3))
        ska = make_seq_sketch(stream_generator(SEED), S_ATT, d_att, m_att, device=dev)
        before = counts()
        out_a, ta = wall(torch, lambda: accum_attention(qa, ka, va, ska))
        n_la = LK.landmark_attention.launches - before["landmark_attention"]
        n_ls = LK.landmark_stats.launches - before["landmark_stats"]
        plain_a, tpa = wall(torch, lambda: accum_attention(qa, ka, va, ska, use_kernel=False))
        ra = ((out_a - plain_a).norm() / plain_a.norm()).item()
        print(f"  (l) accum_attention B·H={H_ATT} S={S_ATT} d={d_att} m={m_att}: kernel route "
              f"{ta * 1e3:.1f} ms ({n_ls} landmark_stats + {n_la} landmark_attention "
              f"launches), plain route {tpa * 1e3:.1f} ms")
        # where the kernel route's time goes, warm: device time by kernel
        if not trace.on:   # pass 3 is under the profiler already
            with off_path():
                wl, dl, top, _ = profiled(torch, lambda: accum_attention(qa, ka, va, ska))
            print(f"  (l) kernel route under the profiler: {wl:.1f} ms wall, {dl:.1f} ms "
                  f"device; top device kernels (ms) {top}")
        check(bool(out_a.isfinite().all()) and ra <= 1e-3 and n_la == n_ls == 1,
              f"(l) kernel route vs plain: rel {ra:.3e} (tol 1e-3)")
        held["l"] = out_a
        del qa, ka, va, out_a, plain_a
        phase_launches["l"] = counts()
        trace.end()
        launches["serve"] = counts()
        print(f"  launches after each phase (cumulative): {phase_launches}")
        for name in ("landmark_attention", "landmark_stats"):
            cnt = launches["serve"][name]
            check(cnt > 0, f"{name} launched {cnt} times on the serving path (j)-(l)")

        return launches, held

    # pass 1: REPRO_AUTOTUNE=0 and no cache file, so every launch takes the
    # static geometry, as before the cache existed.  Pass 2: the cache on and
    # empty, so each key's first call measures its candidates (cold) and
    # every later call is a cache hit (warm).
    os.environ[AT.ENV_GATE] = "0"
    os.environ[AT.ENV_CACHE] = str(tmp / "pass1.json")
    t_pass = time.perf_counter()
    launches_static, held_static = run_paths("pass 1: static geometry, REPRO_AUTOTUNE=0, "
                                             "no cache file")
    print(f"  pass 1: {time.perf_counter() - t_pass:.1f} s")
    check(not (tmp / "pass1.json").exists(), "pass 1 measured nothing and wrote no cache")
    os.environ[AT.ENV_GATE] = "1"
    os.environ[AT.ENV_CACHE] = str(tmp / "pass2.json")
    measured = collections.Counter(AT.MEASURE_LAUNCHES)
    t_pass = time.perf_counter()
    launches, held = run_paths("pass 2: the autotune cache on, from empty")
    print(f"  pass 2: {time.perf_counter() - t_pass:.1f} s")
    measured = AT.MEASURE_LAUNCHES - measured
    print("\n== the two passes ==")
    check(launches == launches_static,
          f"launch counts of the three paths equal in both passes: "
          f"{ {p: {k: v for k, v in c.items() if v} for p, c in launches.items()} }")
    same = {k: torch.equal(held[k], held_static[k]) for k in held}
    check(all(same.values()), f"pass 2's outputs bitwise pass 1's: {same}")
    print(f"  launches made while measuring in pass 2, counted apart: {dict(measured)}")
    print("  the geometry each key's entry holds after pass 2 (rows a block):")
    for k, v in sorted(json.loads((tmp / "pass2.json").read_text()).items()):
        print(f"    {k}: {v}")
    del held
    torch.cuda.empty_cache()

    # pass 3: the paths again on pass 2's cache (warm: nothing is measured),
    # under the profiler, which sums each kernel wrapper's device time on
    # each path (PathTrace); the checks' own calls are left out (off_path)
    trace.on = True
    measured3 = collections.Counter(AT.MEASURE_LAUNCHES)
    # the CUDA kernels the two sources define, by name
    kernel_def = re.compile(r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(")
    PORT_KERNELS = {n for mod in (KN, LK) for n in kernel_def.findall(mod.SOURCE.read_text())}
    t_pass = time.perf_counter()
    launches3, held3 = run_paths("pass 3: pass 2's cache, under the profiler")
    trace.on = False
    print(f"  pass 3: {time.perf_counter() - t_pass:.1f} s")
    print("\n== pass 3: device time of each kernel wrapper on each path ==")
    check(launches3 == launches_static and AT.MEASURE_LAUNCHES == measured3,
          "pass 3: the launch counts of passes 1 and 2, nothing measured")
    same = {k: torch.equal(held3[k], held_static[k]) for k in held3}
    print(f"  pass 3's outputs bitwise pass 1's: {same}")
    for path, sums in trace.by_wrapper.items():
        # the profiler may drop an event now and then: at least 99% of each
        # wrapper's launches must have their range on the device's timeline
        ranges = {k: v[1] for k, v in sums.items()}
        want = {k: v for k, v in launches3[path].items() if v}
        check(set(ranges) == set(want) and all(0.99 * n <= ranges[k] <= n for k, n in want.items()),
              f"pass 3 {path}: the launches' ranges on the device {ranges} (launches {want})")
        print(f"  ({path}) device ms by wrapper: "
              f"{ {k: round(v[0], 4) for k, v in sums.items()} }; profiled and read in "
              f"{trace.seconds[path]:.1f} s")
        top = sorted(trace.by_kernel[path].items(), key=lambda kv: -kv[1])[:8]
        print(f"  ({path}) device ms of the path's kernels by name, the checks' included "
              f"(total {sum(trace.by_kernel[path].values()):.3f}): "
              f"{[(n[:70], round(t, 4)) for n, t in top]}")
        ours = {n.split("::")[1].split("(")[0]: round(t, 4)
                for n, t in trace.by_kernel[path].items()
                if any(f"::{k}<" in n for k in PORT_KERNELS)}
        print(f"  ({path}) the port's CUDA kernels by name, the checks' included: {ours}")
    del held3, held_static
    torch.cuda.empty_cache()

    # ---- 6. path (m): the K·S baseline (benchmarks/kernel_bench.py:52-74) ---- #
    # accum_apply with the cache's geometry against the reference's baseline
    # at bm=256, bd=8 (the column gather at rows a block from R), at the
    # benchmark's anchor and on the engine's dense K
    print("\n== path (m): the K·S baseline, accum_apply against accum_apply_scalar ==")
    reset_counts()
    # the path's device ms by wrapper: each on-path call's shape timed on
    # its own below (the profiler's device time of back-to-back calls)
    ks = {"accum_apply": [0.0, 0], "accum_apply_scalar": [0.0, 0]}
    gm = torch.Generator(device=dev).manual_seed(10)
    Ka = torch.randn((R_ANCHOR, N_ANCHOR), generator=gm, device=dev)
    skm_a = make_accum_sketch(gm, N_ANCHOR, d, 4, device=dev)
    Kd = opc.dense()          # the dense K of (c) and (f), n = 32768, 4.29 GB
    skm_d = make_accum_sketch(gm, nc, d, 4, device=dev)
    bench = json.loads((Path(__file__).resolve().parent / "BENCH_kernels.json").read_text())
    cpu_ratio = bench["results"]["accum_apply_gemm_R4096_N8192_d64_m4_f32"]["speedup_vs_scalar"]
    scalar_rows = {}
    for label, Kb, skm, dt in [("anchor", Ka, skm_a, torch.float32),
                               ("dense", Kd, skm_d, torch.float32),
                               ("dense", Kd, skm_d, torch.bfloat16)]:
        Kt = Kb.to(dt)
        R, N = Kt.shape
        idm, cfm = skm.indices.contiguous(), skm.coef.float().contiguous()
        tol = 1e-5 if dt == torch.float32 else 2e-2
        tuned = OPS.sketch_right_kernel(Kt, skm)
        scalar = OPS.accum_apply_scalar(Kt, idm, cfm, bm=256, bd=8)
        with off_path():
            plain = ref.accum_apply_ref(Kt, idm, cfm)
            et, _, okt = close(tuned, plain, tol)
            es, rs, oks = close(scalar, plain, tol)
            check(okt and oks and scalar.dtype == dt,
                  f"(m) {label} R={R} N={N} d={d} m=4 {dt}: accum_apply max abs {et:.3e}, "
                  f"accum_apply_scalar max abs {es:.3e} against the plain version (tol {tol})")
            geo = (AT.lookup("accum_apply", (R, N, d, 4), dt, dev, arity=1,
                             source=KN.source_hash())
                   or AT.STATIC_TABLE["accum_apply"])
            ms_t, dms_t = timed(torch, lambda: KN.accum_apply(Kt, idm, cfm, bm=geo[0]))
            ms_s, dms_s = timed(torch, lambda: KN.accum_apply(Kt, idm, cfm))
            ms_c, dms_c = timed(torch, lambda: KN.accum_apply_scalar(Kt, idm, cfm, bm=256,
                                                                     bd=8))
            for name, t in (("accum_apply", dms_t), ("accum_apply_scalar", dms_c)):
                ks[name][0] += t if t is not None else math.nan
                ks[name][1] += 1
            pms, _ = timed(torch, lambda: ref.accum_apply_ref(Kt, idm, cfm))
            St = sketch_csr(torch, idm, cfm, N, transposed=True)
            try:
                St = St.to(dt)
                lib = torch.sparse.mm(St, Kt.T).T
                print(f"  (m) torch.sparse.mm(Sᵀ, Kᵀ)ᵀ vs plain: max abs "
                      f"{(lib.float() - plain.float()).abs().max().item():.3e}")
                lms, ldms = timed(torch, lambda: torch.sparse.mm(St, Kt.T))
            except RuntimeError as e:   # the yardstick only: the port never calls it
                print(f"  (m) torch.sparse.mm(Sᵀ, Kᵀ) in {dt}: not run ({e})")
                lms = ldms = None
            isz = Kt.element_size()
            b, by = bound_ms(R * distinct(idm) * isz + R * d * isz + 4 * d * 8, 2 * R * 4 * d)
        print(f"  (m) {label} R={R} N={N} {dt}: accum_apply, cache's geometry {geo[0]} rows "
              f"a block: {ms_t:.4f} ms (device {dms_t}); static 64: {ms_s:.4f} ms (device "
              f"{dms_s}); accum_apply_scalar at {KN.scalar_rows(R, 4, d)} rows a block: "
              f"{ms_c:.4f} ms (device {dms_c}); "
              f"torch.sparse.mm: {lms} ms (device {ldms}); plain {pms:.4f} ms; bound "
              f"{b:.5f} ms by {by}")
        print(f"  (m) scalar / autotuned on the card: {ms_c / ms_t:.2f}× (device "
              f"{(dms_c or 0) / max(dms_t or 1e-9, 1e-9):.2f}×); interpret-mode Pallas on a "
              f"CPU (BENCH_kernels.json, a CPU figure): {cpu_ratio:.2f}×")
        if lms is not None:
            print(f"  (m) accum_apply_scalar / torch.sparse.mm(Sᵀ, Kᵀ): {ms_c / lms:.3f}× "
                  f"(device {(dms_c or math.nan) / (ldms or math.nan):.3f}×)")
        sb = gather_bounds(f"(m) accum_apply_scalar {label} {dt}", dms_c, b, idm, R, isz,
                           R * d * isz + 4 * d * 8)
        scalar_rows[f"{label} {str(dt).removeprefix('torch.')}"] = dict(
            shape=f"R={R} N={N} d={d} m=4", max_abs_err=es, max_rel_err=rs, ms=ms_c,
            device_ms=dms_c, plain_ms=pms, bound_ms=b, bound_by=by, library_ms=lms,
            library_device_ms=ldms, rows_a_block=KN.scalar_rows(R, 4, d),
            accum_apply_geometry=geo[0], accum_apply_ms=ms_t, accum_apply_static_ms=ms_s,
            ratio_scalar_over_autotuned=ms_c / ms_t, **sb)
        del Kt, tuned, scalar, plain
    phase_launches = {"m": counts()}
    launches["ks"] = counts()
    trace.by_wrapper["ks"] = ks
    print(f"  (m) device ms by wrapper: { {k: round(v[0], 4) for k, v in ks.items()} }")
    print(f"  launches on path (m): {phase_launches}")
    for name in ("accum_apply", "accum_apply_scalar"):
        cnt = launches["ks"][name]
        check(cnt == 3, f"{name} launched {cnt} times on path (m), 3 expected")
    anchor = scalar_rows.pop("anchor float32")
    rows["accum_apply_scalar"] = dict(
        replaces=f"{TPU}:529", library="torch.sparse.mm(Sᵀ, Kᵀ)ᵀ",
        geometry_by="a fixed rule on R (csrc scalar_rows)",
        geometry=f"{anchor['rows_a_block']} rows a block", dense=scalar_rows, **anchor)

    # a corrupt cache file: the static table, recorded in the health report
    bad = tmp / "corrupt.json"
    bad.write_text('{"accum_apply|4096|8192|64|4|float32|cuda')   # cut short
    os.environ[AT.ENV_CACHE] = str(bad)
    before = global_health().count("autotune.load")
    with off_path():
        os.environ[AT.ENV_GATE] = "0"
        out = OPS.sketch_right_kernel(Ka, skm_a)
        ea, _, ok = close(out, ref.accum_apply_ref(Ka, skm_a.indices, skm_a.coef.float()),
                          1e-5)
    rec = global_health().count("autotune.load") - before
    check(rec == 1 and ok, f"a corrupt cache file: K·S still right (max abs {ea:.3e}) at "
                           f"the static geometry; health {global_health().summary()}")
    del Ka, Kd, out
    torch.cuda.empty_cache()

    # ---- 7. path (n): the data mesh ------------------------------------------ #
    # (n1) one NCCL rank in this process, on pass 2's cache and under the
    # profiler as pass 3 (PathTrace); each sharded call beside the
    # single-device one on the same draw, which runs first (off path), so
    # that a key the cache has not seen is measured there
    print(f"\n== path (n): the data mesh; card: {smi} ==")
    os.environ[AT.ENV_GATE] = "1"
    os.environ[AT.ENV_CACHE] = str(tmp / "pass2.json")
    from repro_torch._util import HOLDOUT_STREAM
    from repro_torch.core import distributed as DM

    reset_counts()
    trace.on = True
    trace.begin("mesh")
    t_mesh = time.perf_counter()
    mesh = DM.make_data_mesh(device=dev)
    first, steady = collective_ms(torch, DM, mesh, (m * d, d))
    print(f"  (n1) {mesh.size} rank, backend {torch.distributed.get_backend()}, "
          f"rows of n={nb}: {mesh.rows(nb)}; all_reduce of {m * d}×{d} float32: the "
          f"first (the communicator's set-up) {first:.1f} ms, then {steady:.3f} ms (median "
          f"of 20)")

    def pair(name, sharded, single):
        """(sharded result, single-device result), each timed on the host
        clock between synchronizations, printed side by side."""
        with off_path():
            one, t1 = wall(torch, single)
        sh, ts = wall(torch, sharded)
        print(f"  (n1) {name}: sharded {ts * 1e3:.1f} ms, single device {t1 * 1e3:.1f} ms")
        return sh, one

    def rel(x, y):
        return ((x.double() - y.double()).norm() / y.double().norm()).item()

    gb, Xb, fb, yb = regression(nb, 2)
    skb = make_accum_sketch(gb, nb, d, m, device=dev)
    opb = KernelOperator(Xb, "gaussian", bw)
    (Cs, Ws), (C1, W1) = pair(f"sketch_both n={nb} d={d} m={m}",
                              lambda: A.sketch_both(opb, skb, mesh=mesh),
                              lambda: A.sketch_both(opb, skb))
    check(torch.equal(Cs, C1) and torch.equal(Ws, W1),
          "(n1) the mesh's C and W bitwise the single-device ones")
    del Cs
    for name, fit in (("krr_sketched_fit", krr_sketched_fit),
                      ("krr_sketched_fit_matfree", krr_sketched_fit_matfree),
                      ("krr_sketched_fit_pcg", krr_sketched_fit_pcg)):
        sh, one = pair(name, lambda: fit(opb, yb, lam, skb, mesh=mesh),
                       lambda: fit(opb, yb, lam, skb))
        Wsym = W1 if fit is krr_sketched_fit else 0.5 * (W1 + W1.T)
        res, res1 = (residual(C1, Wsym, yb, t, lam) for t in (sh.theta, one.theta))
        rf = rel(sh.fitted, one.fitted)
        print(f"  (n1) {name}: fitted rel {rf:.3e}, θ rel {rel(sh.theta, one.theta):.3e}, "
              f"θ's residual in the single-device system {res:.3e} (single θ {res1:.3e})")
        check(bool(sh.fitted.isfinite().all()) and rf <= F32_FIT_TOL
              and res <= max(1e-5, 2 * res1),
              f"(n1) {name}: θ's residual {res:.3e} (tol the larger of 1e-5 and twice the "
              f"single θ's); fitted rel {rf:.3e} (tol {F32_FIT_TOL}, float32)")
        if fit is krr_sketched_fit:
            model_s, model_1 = sh, one
    Xt = torch.rand((N_TEST, 3), generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev)
    ps, p1 = pair(f"predict {N_TEST} rows", lambda: model_s.predict(Xt, mesh=mesh),
                  lambda: model_1.predict(Xt))
    check(tuple(ps.shape) == (N_TEST,) and rel(ps, p1) <= F32_FIT_TOL,
          f"(n1) predict: rel {rel(ps, p1):.3e} (tol {F32_FIT_TOL}, float32)")
    del C1, W1, model_s, model_1, ps, p1
    # (h)'s adaptive operator fit to m_max 16
    sh, one = pair("krr_sketched_fit_adaptive (h)",
                   lambda: krr_sketched_fit_adaptive(opb, yb, lam, SEED, d, tol=TOL_H,
                                                     m_max=16, mesh=mesh),
                   lambda: krr_sketched_fit_adaptive(opb, yb, lam, SEED, d, tol=TOL_H,
                                                     m_max=16))
    same = [sh.info[k] for k in ("m", "passes")] == [one.info[k] for k in ("m", "passes")]
    check(same and torch.equal(sh.sk.indices, one.sk.indices)
          and rel(sh.fitted, one.fitted) <= F32_FIT_TOL,
          f"(n1) adaptive fit: m={sh.info['m']} in {sh.info['passes']} passes (single "
          f"device m={one.info['m']} in {one.info['passes']}), the same draws, fitted rel "
          f"{rel(sh.fitted, one.fitted):.3e} (tol {F32_FIT_TOL}, float32)")
    del sh, one, opb, Xb, yb, fb
    # (i)'s blobs through a KernelOperator at n = 32768
    gi = torch.Generator(device=dev).manual_seed(6)
    truth = torch.arange(nc, device=dev) % 4
    Xi = 0.5 * torch.randn((nc, 32), generator=gi, device=dev)
    Xi[torch.arange(nc, device=dev), truth] += 4.0
    opi = KernelOperator(Xi, "gaussian", 4.0)
    rs, r1 = pair(f"spectral_cluster n={nc} on the operator",
                  lambda: spectral_cluster(SEED, opi, 4, d=32, m=8, mesh=mesh),
                  lambda: spectral_cluster(SEED, opi, 4, d=32, m=8))
    check(torch.equal(rs.labels, r1.labels),
          f"(n1) spectral labels equal to the single device's; agreement with the "
          f"planted labels {pairwise_agreement(torch, truth, rs.labels):.4f}")
    del opi, Xi, rs, r1
    # the Hutchinson estimator at N_HUTCH (sharded_matvec is O(n²))
    _, X8, _, _ = regression(N_HUTCH, 5)
    op8 = KernelOperator(X8, "gaussian", bw)
    with off_path():
        st8 = A.accum_grow(op8, A.accum_init(stream_generator(SEED), N_HUTCH, d, 4,
                                             device=dev), 4)
    es, e1 = pair(f"Hutchinson estimator n={N_HUTCH}",
                  lambda: A.make_hutchinson_estimator(stream_generator(SEED, HOLDOUT_STREAM),
                                                      op8, mesh=mesh)(st8),
                  lambda: A.make_hutchinson_estimator(stream_generator(SEED, HOLDOUT_STREAM),
                                                      op8)(st8))
    check(math.isclose(es, e1, rel_tol=1e-4, abs_tol=1e-6),
          f"(n1) Hutchinson estimate {es:.6f} against {e1:.6f} (rtol 1e-4)")
    trace.end()
    trace.on = False
    launches["mesh"] = counts()
    mesh.close()
    print(f"  (n1) {time.perf_counter() - t_mesh:.1f} s under the profiler")
    del op8, X8, st8
    torch.cuda.empty_cache()

    # (n2) two gloo ranks sharing the card (NCCL refuses two ranks on one
    # device), with the static geometry: two ranks measuring at once would
    # time each other
    store = tmp / "mesh_store"
    env = dict(os.environ, REPRO_AUTOTUNE="0")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
                               str(r), "2", str(store), str(tmp / f"mesh_rank{r}.json")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=max(1.0, MESH_TIMEOUT - (time.perf_counter()
                                                                        - t0)))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0])
    t2 = time.perf_counter() - t0
    ok2 = all(p.returncode == 0 for p in procs)
    check(ok2, f"(n2) both ranks ran to their end in {t2:.1f} s (limit {MESH_TIMEOUT} s): "
               f"exit codes {[p.returncode for p in procs]}")
    if not ok2:
        for r, log in enumerate(logs):
            print(f"  (n2) rank {r} output:\n{log[-3000:]}")
    else:
        reps = [json.loads((tmp / f"mesh_rank{r}.json").read_text()) for r in range(2)]
        for r in reps:
            print(f"  (n2) rank {r['rank']} rows {r['rows']}: ms (sharded, single device) "
                  f"{ {k: [round(x, 1) for x in v] for k, v in r['ms'].items()} }; gloo "
                  f"all_reduce of {m * d}×{d} float32 on the card: the first "
                  f"{r['all_reduce_ms'][0]:.1f} ms, then {r['all_reduce_ms'][1]:.3f} ms; "
                  f"card: {smi}")

        def grel(key):
            return math.sqrt(sum(r[key][0] for r in reps) / sum(r[key][1] for r in reps))

        check(all(r["C_rows_bitwise"] for r in reps),
              "(n2) each rank's C rows bitwise the single-device rows")
        check(max(r["W_rel"] for r in reps) <= 1e-5 and grel("fitted64") <= 1e-5,
              f"(n2) W rel {max(r['W_rel'] for r in reps):.3e} (bitwise "
              f"{[r['W_bitwise'] for r in reps]}); float64 fit: fitted rel "
              f"{grel('fitted64'):.3e} (tol 1e-5)")
        check(grel("fitted") <= F32_FIT_TOL and grel("pred") <= F32_FIT_TOL,
              f"(n2) float32 fit: fitted rel {grel('fitted'):.3e}, predictions rel "
              f"{grel('pred'):.3e} (tol {F32_FIT_TOL})")
        check(all(r["theta_residual"] <= max(1e-5, 2 * r["theta_residual_single"])
                  for r in reps),
              f"(n2) θ rel {reps[0]['theta_rel']:.3e}; its residual in the single-device "
              f"system {[round(r['theta_residual'], 9) for r in reps]} (single θ "
              f"{reps[0]['theta_residual_single']:.3e})")
        check(reps[0]["draws"] == reps[1]["draws"] and all(r["grow_draws_single"] for r in reps),
              "(n2) the draws bitwise the same on both ranks and as on one device")
        check(reps[0]["theta"] == reps[1]["theta"], "(n2) θ bitwise equal on both ranks")
        check(all(r["grow"] == r["grow_single"] for r in reps),
              f"(n2) doubling growth to m_max 16: m, passes {reps[0]['grow']} on the mesh, "
              f"{reps[0]['grow_single']} on one device")
        launches["mesh2"] = {f.__name__: sum(r["launches"].get(f.__name__, 0) for r in reps)
                             for f in ALL}
    print(f"  (n) launches: one rank {dict((k, v) for k, v in launches['mesh'].items() if v)}; "
          f"two ranks {dict((k, v) for k, v in launches.get('mesh2', {}).items() if v)}; "
          f"(n2) {t2:.1f} s in all")
    ranges = {k: v[1] for k, v in trace.by_wrapper["mesh"].items()}
    want = {k: v for k, v in launches["mesh"].items() if v}
    check(set(ranges) == set(want) and all(0.99 * c <= ranges[k] <= c for k, c in want.items()),
          f"path (n): the launches' ranges on the device {ranges} (launches {want})")
    print(f"  (n1) device ms by wrapper: "
          f"{ {k: round(v[0], 4) for k, v in trace.by_wrapper['mesh'].items()} }")
    check(launches["mesh"]["matfree_apply"] > 0 and launches.get("mesh2", {}).get(
        "matfree_apply", 0) > 0, "matfree_apply launched on path (n), one rank and two")

    # ---- 8. path (o): training ------------------------------------------------ #
    # once, its launch counts from 0: the reference's training reaches no
    # pallas_call, so none of the nine kernels may launch
    print(f"\n== path (o): training {TRAIN_ARCH}; card: {smi} ==")
    torch.cuda.empty_cache()
    print(f"  device memory held before (o): {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    reset_counts()
    trace.on = True
    train_path(torch, dev, trace, smi)
    trace.on = False
    launches["train"] = counts()
    check(not any(launches["train"].values()) and trace.by_wrapper.get("train") == {},
          f"path (o) launched none of the nine kernels: {launches['train']}; launch ranges "
          f"on the device {trace.by_wrapper.get('train')}")

    # ---- 9. path (p): the model families ------------------------------------- #
    # once, its launch counts from 0: the sketched decode of zamba2-7b's shared
    # attention launches landmark_attention (head dim 112); nothing else of
    # the port's kernels is on the path (the reference's MoE, Mamba-2 and cond
    # code reaches no pallas_call)
    print(f"\n== path (p): the model families (MoE, Mamba-2, cond); card: {smi} ==")
    torch.cuda.empty_cache()
    print(f"  device memory held before (p): {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    reset_counts()
    trace.on = True
    families_path(torch, dev, trace, smi, LK)
    trace.on = False
    launches["families"] = counts()
    others = {k: v for k, v in launches["families"].items() if k != "landmark_attention" and v}
    check(launches["families"]["landmark_attention"] > 0 and not others,
          f"path (p) launched landmark_attention {launches['families']['landmark_attention']} "
          f"times and no other kernel ({others})")

    # ---- 10. path (q): xLSTM ---------------------------------------------------- #
    # once, its launch counts from 0: the reference's xLSTM reaches no
    # pallas_call, so none of the nine kernels may launch
    print(f"\n== path (q): xLSTM ({XL_ARCH}); card: {smi} ==")
    torch.cuda.empty_cache()
    print(f"  device memory held before (q): {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    reset_counts()
    xlstm_path(torch, dev, smi)
    launches["xlstm"] = counts()
    check(not any(launches["xlstm"].values()),
          f"path (q) launched none of the nine kernels: {launches['xlstm']}")

    # ---- 11. path (r): the trace contracts ------------------------------------ #
    # once, its launch counts from 0: each probe runs twice (a warm-up, then
    # the recorded run), so every kernel launches twice what its recorded
    # run counted
    print(f"\n== path (r): the trace contracts (repro_torch.analysis); card: {smi} ==")
    reset_counts()
    results = contracts_path(torch, dev, smi)
    launches["contracts"] = counts()
    recorded = sum(r.report.get("kernel_launches", 0) for r in results)
    check(sum(launches["contracts"].values()) == 2 * recorded > 0,
          f"path (r): {sum(launches['contracts'].values())} launches, twice the recorded "
          f"runs' {recorded} ({ {k: v for k, v in launches['contracts'].items() if v} })")

    # ---- 12. path (s): the 2-D parameter mesh -------------------------------- #
    # once, its launch counts from 0: the reference's sharded training reaches
    # no pallas_call, so none of the nine kernels may launch
    print(f"\n== path (s): the 2-D parameter mesh (repro_torch.sharding); card: {smi} ==")
    torch.cuda.empty_cache()
    print(f"  device memory held before (s): {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    reset_counts()
    mesh2d_path(torch, dev, smi)
    launches["mesh2d"] = counts()
    check(not any(launches["mesh2d"].values()),
          f"path (s) launched none of the nine kernels: {launches['mesh2d']}")

    # ---- 13. path (t): the dry run ------------------------------------------ #
    # once, its launch counts from 0: the real sketched decode step of (t1)
    # launches landmark_attention (its warm-up and the recorded step), and
    # nothing else of the port's kernels is on the path
    print(f"\n== path (t): the dry run (repro_torch.launch.dryrun); card: {smi} ==")
    torch.cuda.empty_cache()
    print(f"  device memory held before (t): {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    reset_counts()
    dryrun_path(torch, dev, smi)
    launches["dryrun"] = counts()
    others = {k: v for k, v in launches["dryrun"].items() if k != "landmark_attention" and v}
    check(launches["dryrun"]["landmark_attention"] > 0 and not others,
          f"path (t) launched landmark_attention {launches['dryrun']['landmark_attention']} "
          f"times and no other kernel ({others})")

    # ---- 14. path (u): the memory plan and the example twins ---------------- #
    # once, its launch counts from 0: in this process only (u3)'s checks
    # launch (landmark_attention), and are undone; the path's launches are
    # the twins', each counted in its own process from 0 and added up
    print(f"\n== path (u): the memory plan for training and the example twins; card: {smi} ==")
    torch.cuda.empty_cache()
    print(f"  device memory held before (u): {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    reset_counts()
    plan = memory_plan_path(torch, dev, smi, tmp)
    own = {k: v for k, v in counts().items() if v}
    check(set(own) <= {"landmark_attention"},
          f"path (u): in this process only (u3)'s checks launched ({own})")
    reset_counts()
    launches["examples"] = {f.__name__: plan["launches"].get(f.__name__, 0) for f in ALL}
    check(sum(launches["examples"].values()) > 0,
          f"path (u): the twins launched {launches['examples']}")
    rows["landmark_attention"]["lse"] = plan["lse"]

    # device ms on the paths: pass 3's KRR, engine and serving paths and
    # (n1) summed by wrapper under the profiler, and path (m)'s calls timed
    # one by one ((n2)'s ranks are not profiled)
    def on_paths(name):
        return {p: round(w[name][0], 6) for p, w in trace.by_wrapper.items() if name in w}

    for name, row in rows.items():
        print(f"  {name}: device ms summed on the paths {on_paths(name)}")
        sector = (f", sector bound {row['sector_bound_ms']:.5f} ms, at the measured rate "
                  f"{row['sector_rate_ms']:.5f} ms" if "sector_bound_ms" in row else "")
        print(f"  {name}: {row['ms']:.4f} ms, device {row['device_ms']} ms "
              f"(plain {row['plain_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.5f} ms by {row['bound_by']}{sector}, library "
              f"{row['library_ms']}); geometry {row.get('geometry')} by "
              f"{row['geometry_by']}")
    # launches: the sum over the main paths of pass 2, path (m), path (n)
    # (both parts), (o), (p), (q), (r), (s), (t) and (u), each counted from 0
    kernels = [dict(name=f.__name__, route="cuda", source=SRC if f in KN.KERNELS else LSRC,
                    launches=sum(c[f.__name__] for c in launches.values()),
                    launches_by_path={p: c[f.__name__] for p, c in launches.items()},
                    launches_measuring=measured[f.__name__],
                    device_ms_on_paths=sum(on_paths(f.__name__).values()),
                    device_ms_by_path=on_paths(f.__name__), **rows[f.__name__])
               for f in ALL]
    tmpdir.cleanup()
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    if FAILURES:
        print(f"\nchip_smoke: {len(FAILURES)} check(s) failed:", file=sys.stderr)
        for f in FAILURES:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh2d-rank"]:
        sys.exit(mesh2d_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    sys.exit(main())
