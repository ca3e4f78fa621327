#!/usr/bin/env python3
"""The gap between a hybrid model's two prefills, in both packages, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/hybrid_prefill_gap.py \
        [--d-model 256] [--superblocks 27] [--length 128]

zamba2-7b's pattern (mamba2, mamba2, attn_shared) at a cut width and the
given depth, the reference's ``init_params`` draw carried to the port, one
prompt: ``prefill`` (the chunked SSD) against ``prefill_with_cache`` (the
token scan over ``mamba2_decode``), the max |logit gap| of each package, in
bfloat16 (the serving dtype) and in float32.  The reference's own test holds
this gap at 0.05 at one superblock in bfloat16
(tests/test_archs_smoke.py:67); this script shows how it grows with depth.
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as get_config_j
from repro.models import model as MJ
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import model as MT


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--superblocks", type=int, default=27)
    ap.add_argument("--length", type=int, default=128)
    a = ap.parse_args()
    kw = dict(d_model=a.d_model, n_heads=2, n_kv_heads=2, head_dim=112, d_ff=4 * a.d_model,
              vocab_size=4000, n_layers=3 * a.superblocks, n_superblocks=a.superblocks)
    cj = dataclasses.replace(get_config_j("zamba2-7b"), **kw)
    ct = dataclasses.replace(get_config("zamba2-7b"), **kw)
    tok = np.random.default_rng(0).integers(0, kw["vocab_size"], (1, a.length))
    for name, dj, dt in (("bfloat16", jnp.bfloat16, torch.bfloat16),
                         ("float32", jnp.float32, torch.float32)):
        pj = jax.tree_util.tree_map(lambda x: x.astype(dj) if x.dtype == jnp.bfloat16 else x,
                                    MJ.init_params(jax.random.PRNGKey(0), cj))
        pt = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct,
                                       device="cpu")
        aj = MJ.prefill(pj, jnp.asarray(tok), cj)
        bj, _ = MJ.prefill_with_cache(pj, jnp.asarray(tok), cj,
                                      MJ.init_cache(cj, 1, a.length, dj))
        at = MT.prefill(pt, torch.from_numpy(tok), ct)
        bt, _ = MT.prefill_with_cache(pt, torch.from_numpy(tok), ct,
                                      MT.init_cache(ct, 1, a.length, dt, device="cpu"))
        print(f"{name}: d_model {a.d_model}, {3 * a.superblocks} layers, {a.length} tokens: "
              f"max |logit gap| reference {float(jnp.max(jnp.abs(aj - bj))):.4g}, port "
              f"{(at - bt).abs().max().item():.4g} (max |logit| "
              f"{float(jnp.max(jnp.abs(aj))):.4g})")


if __name__ == "__main__":
    main()
