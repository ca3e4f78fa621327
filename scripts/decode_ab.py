#!/usr/bin/env python3
"""Decode rate of two source trees of the port, in turns, on one card.

    python3 scripts/decode_ab.py PARENT_SRC CHANGE_SRC

Each argument is a directory that holds ``repro_torch`` (a tree's ``src``;
unpack a parent commit with ``git archive REV src | tar -x -C DIR`` into a
directory ``.gitignore`` lists, such as ``build/``).  The trees run one
after another in their own processes, parent, change, change, parent:
minitron-8b at full width (bfloat16 weights from seed 0), batch 4, a
2048-token prompt, then the engine's decode loop of 31 greedy steps timed
three times, with the exact and the sketched cache.  Each process prints
one JSON line: its tree, the card, tokens/s of each timing, and the first
decoded tokens, which must be the same bits in every process.  Times are
host clock between device synchronizations.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ARCH, BATCH, PROMPT, NEW = "minitron-8b", 4, 2048, 32


def one(src: str) -> dict:
    """The decode rates of the tree at ``src`` (run in its own process)."""
    sys.path.insert(0, src)
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = get_config(ARCH)
    params = init_params(0, cfg, device="cuda")
    g = torch.Generator().manual_seed(21)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=g).numpy().astype(np.int32)
    out = {"src": src, "card": torch.cuda.get_device_name(0)}
    for mode in ("exact", "sketched"):
        eng = Engine(cfg, params, ServeConfig(max_len=PROMPT + NEW,
                                              use_sketch=mode == "sketched"))
        cache, logits = eng.prefill_tokens(eng.new_cache(BATCH), prompts)
        tok0 = torch.argmax(logits, dim=-1)
        eng._decode(cache, tok0, PROMPT, 4)                     # warm-up
        rates = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, _ = eng._decode(cache, tok0, PROMPT, NEW - 1)
            torch.cuda.synchronize()
            rates.append(BATCH * (NEW - 1) / (time.perf_counter() - t0))
        out[mode] = [round(r, 2) for r in rates]
        out[mode + "_tokens"] = toks[:, :8].tolist()
        del cache, eng
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])))
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    parent, change = argv
    results = []
    for src in (parent, change, change, parent):
        line = subprocess.run([sys.executable, __file__, "--one", src], check=True,
                              capture_output=True, text=True).stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    same = all(r[m + "_tokens"] == results[0][m + "_tokens"]
               for r in results for m in ("exact", "sketched"))
    print(f"decoded tokens the same bits in every process: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
