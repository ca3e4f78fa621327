"""The example twins (examples/*_torch.py), the port's user-facing entry
points, run end to end on the CPU, each in a subprocess at its smallest
arguments (``--device cpu --check``; train_lm at 8 steps), all five started
together: each exits 0 with every claim it checks holding (the quickstart's
adaptive m growing as the target shrinks and its one-rank sharded fit
agreeing with the single-device one; the m sweep's best mean of m = 8–32
below Nyström's and within 10× of the Gaussian floor; the AMM error falling with m, the
PCA affinities, the engine stopping at m = 1 on blob data; the sketched
decode exact at d_slots ≥ max_len; training resumed at the midpoint with
its loss falling), and prints its reference's lines (examples/*.py): the
same text, numbers masked, in the same order (the loop's ``[loop]`` logs
and the ``[check]`` line aside).  The reference lines were taken from the
reference examples' own output on the CPU."""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ARGS = {"quickstart": [], "krr_m_sweep": [], "sketched_pca_kmeans": [],
        "long_context_serve": [], "train_lm": ["--steps", "8"]}
ADAPTIVE = "tol=# → engine chose m=# in # data passes (est err #), ‖f̂_S − f̂_n‖²_n =#"
REFERENCE_LINES = {
    "quickstart": [
        "nystrom (m=#) ‖f̂_S − f̂_n‖²_n =#", "accumulation m=# ‖f̂_S − f̂_n‖²_n =#",
        "→ accumulation (medium m) ≈ Gaussian-sketch accuracy at Nyström cost.",
        "adaptive accumulation (error target instead of m, d=#):", ADAPTIVE, ADAPTIVE, ADAPTIVE,
        "matrix-free KRR at n=#: dense K would be # GB; the operator held # MB. "
        "predictions: [# # #]",
        # the reference sums its shards with psum, the port with an all-reduce
        "sharded over # device(s): per-device C slab # MB; predictions agree to # relative "
        "(all-reduce order)"],
    "krr_m_sweep": ["n=# d=# λ=# (‖f̂_S − f̂_n‖²_n, avg of #)", *["m=#: #"] * 6,
                    "m=∞ (gaussian): #"],
    "sketched_pca_kmeans": [
        "AMM ‖ÂᵀB − AᵀB‖_F/‖AᵀB‖_F, # heavy rows (high incoherence), d=#:",
        *["m=#: rel err #"] * 3,
        "sketched PCA (n=# p=# top-# subspace affinity vs exact):",
        *["m=#: affinity=# (# of # rows touched)"] * 3,
        "sketched k-means (k=#; best-of-restarts Lloyd inertia=#):",
        *["m=#: inertia=# (centroid updates from # sampled rows/iter)"] * 2,
        "sketched spectral clustering (n=# k=#):",
        "fixed m=# : pairwise agreement=# (# rows touched)",
        "adaptive : engine stopped at m=# (est err #), pairwise agreement=# (# rows touched)"],
    "long_context_serve": [
        "[prefill ] batched # ms sequential # ms (#x)",
        "[exact ] cache=# MB tokens[#:#]=[# # # # # # # #]",
        *["[sketch d=#] cache=# MB rel-logit-RMSE=# greedy agreement=#%"] * 3],
    "train_lm": ["[phase#] stopped at step # (simulated preemption), loss=#",
                 "[phase#] resumed from # final loss=#", "[result] loss # → # (learning ✓)"],
}


def _mask(line: str) -> str:
    """``line`` with every number (digits, grouping commas, a fraction, an
    exponent) as ``#``, no blank between "=" and a number, and runs of
    blanks as one."""
    line = re.sub(r"\d[\d,]*(\.\d+)?(e[-+]?\d+)?", "#", line)
    # a number's padding after "=" (m= 1, m=15) is not text
    return re.sub(r"\s+", " ", re.sub(r"=\s+#", "=#", line)).strip()


@pytest.fixture(scope="module")
def runs():
    """{name: (exit code, stdout, stderr)} of the five twins, started
    together on the CPU."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}_torch.py"), "--device", "cpu",
         "--check", *args], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, args in ARGS.items()}
    out = {}
    for name, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
        out[name] = (p.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("name", list(ARGS))
def test_example_twin_runs_and_its_claims_hold(runs, name):
    rc, stdout, stderr = runs[name]
    assert rc == 0, stderr[-3000:]
    (line,) = [ln for ln in stdout.splitlines() if ln.startswith("[check]")]
    n, of = re.fullmatch(r"\[check\] (\d+) of (\d+) claims hold", line).groups()
    assert n == of and int(n) > 0, line


@pytest.mark.parametrize("name", list(ARGS))
def test_example_twin_prints_its_references_lines(runs, name):
    _, stdout, _ = runs[name]
    lines = [_mask(ln) for ln in stdout.splitlines()]
    lines = [ln for ln in lines if ln and not ln.startswith(("[loop]", "[check]"))]
    assert lines == REFERENCE_LINES[name]
