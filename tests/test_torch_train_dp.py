"""Data-parallel training in the port: two gloo ranks against one process.

This file is also the worker: the test spawns it as two gloo ranks on a
``FileStore`` under pytest's tmp dir, each with a time limit, as
tests/test_torch_distributed.py does.  Each rank trains
``reduced(stablelm-3b)`` with float32 parameters drawn from seed 0 (the
same on both ranks and in the test process) on its half of the batch.

- Without compression, one step on the halves, the gradients averaged by
  ``all_reduce``, gives the one-process step on the whole batch: m and v
  (the averaged gradient and its square) at 1e-6 relative to the largest
  entry (float32 sums in another order); the masters at 1e-6 in norm, since
  Adam's first step divides each gradient by its own magnitude, so a
  gradient near 0 turns sum-order noise into a visible move of its one
  weight; the bfloat16 parameters, the masters rounded, at one bfloat16
  step (2⁻⁸) in norm.
- With compression, two steps: both ranks' parameters are bitwise equal, and
  each rank's error feedback after step 1 is its own g + e − S·mean(Sᵀ(g + e))
  (the mean over the ranks), computed here from each rank's g + e, at 1e-6.
- The launcher on the two ranks as ``torchrun`` starts it (RANK, WORLD_SIZE
  and MASTER_ADDR/PORT in the environment, ``--mesh debug``,
  ``--compress``) makes the group, trains, checkpoints under ``rank<r>``,
  resumes, and destroys the group.

The steps and the launcher run in two spawns of their own (two fixtures),
so that a hang fails the tests of one and not of both.  The launcher's two
runs rendezvous on 127.0.0.1 (no name lookup) at two ports of their own: a
rank that starts the second run before its peer has torn the first group
down would otherwise join the old store and wait there.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch._util import tree_leaves  # noqa: E402
from repro_torch.checkpoint.ckpt import committed_steps  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core.apply import sketch_left, unsketch_mat  # noqa: E402
from repro_torch.data.pipeline import DataConfig, global_batch  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.optim import compress as C  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train import step as ST  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
# a guard against a hung rank, not a speed bound: the ranks are single-threaded
# and starve beside the suite's other workers (the two training ranks take 13
# s alone and did not finish in 180 s beside six CPU-bound processes)
SPAWN_TIMEOUT = 600
CFG = reduced(ARCHS["stablelm-3b"])
COMPRESS = C.CompressConfig(ratio=0.25, m=4, min_rows=256)     # embed and lm_head
DC = DataConfig(vocab_size=CFG.vocab_size, seq_len=32, global_batch=4)


def _tc(compress):
    return ST.TrainConfig(optimizer=AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=10),
                          q_chunk=16, compress=compress)


def _state(tc):
    return ST.init_train_state(init_params(0, CFG, device="cpu", dtype=torch.float32), tc)


def _half(t, rank):
    mb = t.shape[0] // WORLD
    return t[rank * mb:(rank + 1) * mb]


def _arrays(state) -> dict:
    out = {}
    for name, tree in (("params", state.params), ("m", state.opt.m), ("v", state.opt.v),
                       ("master", state.opt.master)):
        for i, x in enumerate(tree_leaves(tree)):
            out[f"{name}_{i}"] = x.float().numpy()
    return out


# --------------------------------------------------------------------------- #
# the worker
# --------------------------------------------------------------------------- #

def _worker(mode: str, rank: str, store: str, base: str, *ports: str) -> int:
    rank, base = int(rank), Path(base)
    torch.set_num_threads(1)
    if mode == "launch":
        return _launch_worker(rank, base, ports)
    from repro_torch.core.distributed import make_data_mesh

    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.FileStore(store, WORLD), rank=rank,
        world_size=WORLD, timeout=timedelta(seconds=60))
    report = {}
    try:
        mesh = make_data_mesh(WORLD, device="cpu")
        # one plain step on this rank's half of step 0's batch
        tok, lab = global_batch(DC, 0, device="cpu")
        st, mets = ST.train_step(_state(_tc(None)), _half(tok, rank), _half(lab, rank), 0, CFG,
                                 _tc(None), mesh=mesh)
        np.savez(base / f"plain{rank}.npz", loss=mets["loss"].numpy(), **_arrays(st))
        # two compressed steps; before step 1, this rank's g + e of each leaf
        tc = _tc(COMPRESS)
        st = _state(tc)
        for step in range(2):
            tok, lab = global_batch(DC, step, device="cpu")
            tok, lab = _half(tok, rank), _half(lab, rank)
            if step == 1:
                _, _, g = ST._grads(st.params, tok, lab, None, CFG, tc)
                np.savez(base / f"gf{rank}.npz", **{
                    str(i): (gi.float() + e).numpy() for i, (gi, e) in
                    enumerate(zip(tree_leaves(g), tree_leaves(st.ef))) if e is not None})
            st, mets = ST.train_step(st, tok, lab, step, CFG, tc, mesh=mesh)
        np.savez(base / f"comp{rank}.npz", **{
            str(i): e.numpy() for i, e in enumerate(tree_leaves(st.ef)) if e is not None})
        report["params_digest"] = [hashlib.sha1(x.float().numpy().tobytes()).hexdigest()
                                   for x in tree_leaves(st.params)]
    finally:
        torch.distributed.destroy_process_group()
    (base / f"report{rank}.json").write_text(json.dumps(report))
    return 0


def _launch_worker(rank: int, base: Path, ports) -> int:
    """The launcher as torchrun starts it: the process group from the
    environment (env://), made and destroyed by the launcher; then resumed,
    each run at a port of its own."""
    from repro_torch.launch import train as launch_train

    report = {}
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="127.0.0.1")
    ck = base / "launch_ckpt"
    args = ["--arch", "stablelm-3b", "--reduced", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--compress", "--ckpt-dir", str(ck), "--steps"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        for port, steps in zip(ports, ("2", "3")):
            os.environ["MASTER_PORT"] = port
            launch_train.main([*args, steps])
    report["launch_out"] = out.getvalue()
    report["launch_steps"] = committed_steps(str(ck / f"rank{rank}"))
    report["group_left"] = torch.distributed.is_initialized()
    report["imports_jax"] = any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
    (base / f"launch{rank}.json").write_text(json.dumps(report))
    return 0


# --------------------------------------------------------------------------- #
# the test process
# --------------------------------------------------------------------------- #

def _spawn(base: Path, mode: str, *extra: str, report: str) -> list:
    """Run the worker as WORLD gloo ranks in ``mode``, each with a time
    limit; return each rank's JSON report ``{report}{rank}.json``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1",
        CUBLAS_WORKSPACE_CONFIG=":4096:8")
    procs = [subprocess.Popen([sys.executable, __file__, mode, str(r),
                               str(base / f"store_{mode}"), str(base), *extra], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    reports = []
    for r, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=SPAWN_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log = p.communicate()[0]
        assert p.returncode == 0, f"{mode} rank {r} exit {p.returncode}:\n{log[-4000:]}"
        reports.append(json.loads((base / f"{report}{r}.json").read_text()))
    return reports


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    base = tmp_path_factory.mktemp("train_dp")
    return base, _spawn(base, "steps", report="report")


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    base = tmp_path_factory.mktemp("train_dp_launch")
    socks = [socket.socket() for _ in range(2)]     # two free ports, held together
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        ports = [str(sock.getsockname()[1]) for sock in socks]
    finally:
        for sock in socks:
            sock.close()
    return _spawn(base, "launch", *ports, report="launch")


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def test_halves_average_to_the_whole_batch_step(ranks):
    base, _ = ranks
    tok, lab = global_batch(DC, 0, device="cpu")
    st, mets = ST.train_step(_state(_tc(None)), tok, lab, 0, CFG, _tc(None))
    want = _arrays(st)
    for r in range(WORLD):
        got = np.load(base / f"plain{r}.npz")
        _close(got["loss"], mets["loss"].numpy(), 1e-6)
        for k, w in want.items():
            if k.startswith(("m_", "v_")):
                _close(got[k], w, 1e-6)
            else:
                tol = 2.0 ** -8 if k.startswith("params") else 1e-6
                diff = np.asarray(got[k], np.float64) - w
                assert np.linalg.norm(diff) <= tol * np.linalg.norm(w), k


def test_compressed_ranks_agree_and_keep_their_own_error_feedback(ranks):
    base, reports = ranks
    assert reports[0]["params_digest"] == reports[1]["params_digest"]
    gf = [np.load(base / f"gf{r}.npz") for r in range(WORLD)]
    ef = [np.load(base / f"comp{r}.npz") for r in range(WORLD)]
    assert sorted(gf[0].files) == sorted(ef[0].files) and len(gf[0].files) == 2
    for key in gf[0].files:
        g = [torch.from_numpy(x[key]) for x in gf]
        sk = C.leaf_sketch(0, 1, int(key), g[0].shape[0], COMPRESS, "cpu")
        mean = sum(sketch_left(sk, gi.reshape(gi.shape[0], -1)) for gi in g) / WORLD
        for r in range(WORLD):
            want = g[r] - unsketch_mat(sk, mean).reshape(g[r].shape)
            _close(ef[r][key], want.numpy(), 1e-6)
        assert not np.array_equal(ef[0][key], ef[1][key])


def test_launcher_trains_and_resumes_on_two_ranks(launched):
    for r in launched:
        assert r["launch_steps"] == [3, 2]
        assert "ranks=2: ran 2 steps (resumed_from=None)" in r["launch_out"]
        assert "ranks=2: ran 1 steps (resumed_from=2)" in r["launch_out"]
        assert not r["imports_jax"] and not r["group_left"]


if __name__ == "__main__":
    sys.exit(_worker(*sys.argv[1:]))
