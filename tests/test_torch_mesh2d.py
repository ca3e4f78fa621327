"""The 2-D parameter mesh in the port: four gloo ranks on a (data 2, model 2)
mesh against the reference's expert-parallel MoE and against one process.

This file is also the worker: the test spawns it as four gloo ranks on a
``FileStore`` under pytest's tmp dir (``python tests/test_torch_mesh2d.py
RANK STORE DIR``), each group with a timeout and each rank with a time
limit, and beside them the reference in a subprocess with four forced host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
tests/test_perf_equivalence.py runs its a2a test).  The ranks import no JAX.
They write whole (gathered) results and digests; this process compares.

- The expert-parallel MoE (``_moe_forward_a2a``) with and without capacity
  drops against the reference's a2a under a (2, 2) mesh: outputs, aux and
  dropped at 1e-5, gradients at 1e-3 (the reference's own a2a tolerances,
  tests/test_perf_equivalence.py).  The port's plain version
  (``moe_forward_a2a_plain``) against the same reference in one process, at
  the same tolerances; with nothing dropped the a2a path equals
  ``moe_forward_local`` (outputs 1e-5, expert gradients 1e-3).
- Reduced stablelm-3b and moonshot-v1-16b-a3b (float32): loss and gradients
  on the mesh against one process (moonshot's with ``moe_forward`` swapped
  for the plain version where the mesh takes the a2a path): the
  loss at 1e-6 relative; each gradient leaf at 1e-5 of its largest entry
  (float32 sums in another order; the expert weights' gradients, rounded to
  bfloat16 where the a2a path reduces them, at one bfloat16 step, 2⁻⁸).
- Serving on the mesh (reduced stablelm-3b, its 3-KV-head variant and
  moonshot-v1-16b-a3b, float32, exact and sketched caches): a
  ``prefill_with_cache`` of the batch and one ``decode_step``, the cache
  placed by ``cache_shardings`` (the batch on data, the positions or the
  slots on model), against one process: both steps' logits at 1e-5 of
  their largest magnitude, each cache leaf at 1e-6 of its largest entry
  (measured: logits within 7e-7, caches bit for bit); the cache leaves keep
  their placements.
- A wide, shallow stablelm-3b (d_model 512) on a batch of 2 × 4 tokens:
  DTensor moves the activations rather than gather the FSDP weights, so
  the products before the aligned reshapes are partial sums over "data";
  loss at 1e-6 relative and gradients at 1e-5 of their largest against one
  process.
- Every replicated output (loss, gathered gradients, the loop's state, the
  serving logits and gathered caches) is bitwise equal across the four
  ranks.
- A sharded training loop (reduced stablelm-3b, bfloat16 parameters,
  compression on): 4 steps in one run against 2 steps, a checkpoint of each
  rank's shards and 2 resumed steps — the last two losses and the final
  state bit for bit.  The shards refuse to restore into whole tensors (a
  data-mesh state), and a checkpoint of whole tensors into the (2, 2) state.
- ``make_production_mesh`` refuses four ranks, naming the count.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.configs.base import MoECfg  # noqa: E402
from repro_torch.models import moe as MO  # noqa: E402
from repro_torch.models.model import init_params, loss_fn  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD, SHAPE = 4, (2, 2)
# a guard against a hung rank, not a speed bound: the ranks are single-threaded
# and starve beside the suite's other workers; each group also gives up on a
# dead peer after 60 s
SPAWN_TIMEOUT = 600
# the MoE cases: the reference's a2a test's configuration (nothing dropped,
# a dense residual) and a tight capacity that drops
MOE = {"nodrop": (MoECfg(n_experts=8, top_k=2, d_ff_expert=16, capacity_factor=64.0,
                         dense_residual=True, d_ff_dense=16), (4, 8, 12)),
       "drops": (MoECfg(n_experts=8, top_k=2, d_ff_expert=16, capacity_factor=1.0),
                 (4, 16, 12))}
# the reduced models; "stablelm-3b-3kv" has 3 KV heads, which the model axis
# of 2 splits unevenly (the reference's "tp!"); xlstm-125m is "dp_only" (its
# weights gathered whole a block, the sLSTM scan on each rank's batch rows)
MODELS = {"stablelm-3b": reduced(ARCHS["stablelm-3b"]),
          "moonshot-v1-16b-a3b": reduced(ARCHS["moonshot-v1-16b-a3b"]),
          "stablelm-3b-3kv": reduced(ARCHS["stablelm-3b"]).scaled(n_heads=6, n_kv_heads=3),
          "xlstm-125m": reduced(ARCHS["xlstm-125m"])}
ARCH_NAMES = tuple(MODELS)
BATCH, SEQ = 4, 16
# serving: the prompt is SEQ tokens, the exact cache holds SERVE_LEN positions
# (split over the model axis), and one token is decoded at position SEQ
SERVE_ARCHS = ("stablelm-3b", "stablelm-3b-3kv", "moonshot-v1-16b-a3b")
SERVE_CACHES = ("exact", "sketched")
SERVE_LEN = 32
# wide weights and a tiny batch, so that DTensor moves activations, not weights
WIDE = reduced(ARCHS["stablelm-3b"]).scaled(d_model=512, n_heads=8, n_kv_heads=8,
                                            head_dim=64, d_ff=1024)
WIDE_BATCH_SEQ = (2, 4)
EXPERT_NAMES = ("wi_gate", "wi_up", "wo")


def _moe_inputs(case: str) -> dict:
    """The case's float32 MoE parameters and input h from a numpy seed."""
    cfg, (B, S, D) = MOE[case]
    rng = np.random.default_rng(7 if case == "drops" else 3)
    E, F = cfg.n_experts, cfg.d_ff_expert

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    arrays = {"router": w(D, E), "wi_gate": w(E, D, F), "wi_up": w(E, D, F),
              "wo": w(E, F, D), "norm": np.zeros(D, np.float32),
              "h": (0.1 * rng.standard_normal((B, S, D))).astype(np.float32)}
    if cfg.dense_residual:
        Fd = cfg.d_ff_dense
        arrays.update({"dense/wi_gate": w(D, Fd), "dense/wi_up": w(D, Fd),
                       "dense/wo": w(Fd, D), "dense/norm": np.zeros(D, np.float32)})
    return arrays


def _moe_tree(arrays: dict) -> tuple[dict, np.ndarray]:
    """(the nested parameter dict, h) of a case's flat arrays."""
    p: dict = {}
    for k, v in arrays.items():
        if k == "h":
            continue
        if k.startswith("dense/"):
            p.setdefault("dense", {})[k[6:]] = v
        else:
            p[k] = v
    return p, arrays["h"]


def _grad_names(p: dict, prefix: str = "") -> list[str]:
    """Flat names of a parameter dict's leaves in ``tree_leaves`` order."""
    out = []
    for k in sorted(p):
        if isinstance(p[k], dict):
            out += _grad_names(p[k], f"{prefix}{k}/")
        else:
            out.append(prefix + k)
    return out


def _batch(cfg, batch: int = BATCH, seq: int = SEQ):
    from repro_torch.data.pipeline import DataConfig, global_batch

    return global_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=batch), 0, device="cpu")


def _model_loss_and_grads(params, tokens, labels, cfg):
    from repro_torch._util import tree_leaves, tree_map

    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    it = iter(leaves)
    loss, _ = loss_fn(tree_map(lambda _: next(it), params), tokens, labels, cfg, q_chunk=8,
                      remat="full")
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss, list(grads)


@contextlib.contextmanager
def _plain_a2a(dp_size: int, M: int):
    """Inside the block the model's MoE computes, on plain tensors, what a
    mesh of ``dp_size`` data and ``M`` model ranks computes: the plain
    version of the a2a path where that mesh takes it, the local path
    elsewhere.  The swap is the module's, so the recompute of a
    checkpointed block on autograd's worker thread sees it too."""
    forward = MO.moe_forward

    def plain(p, h, moe):
        if MO._use_a2a(moe, *h.shape, dp_size, M):
            return MO.moe_forward_a2a_plain(p, h, moe, dp_size, M)
        return MO.moe_forward_local(p, h, moe)

    MO.moe_forward = plain
    try:
        yield
    finally:
        MO.moe_forward = forward


def _serve(params, cfg, tokens, nxt, cache_kind: str, place=lambda c: c) -> dict:
    """A ``prefill_with_cache`` of ``tokens`` (B, SEQ) into a float32 cache
    (``place``d) and one ``decode_step`` of ``nxt`` (B,) at position SEQ:
    {"prefill": logits, "decode": logits, "cache<i>": each cache leaf}."""
    from repro_torch._util import tree_leaves
    from repro_torch.core.sketched_attention import decode_slot_table, decode_slots
    from repro_torch.models.model import decode_step, init_cache, prefill_with_cache

    sketch = cache_kind == "sketched"
    sa = cfg.sketch_attn
    cache = place(init_cache(cfg, BATCH, SERVE_LEN, dtype=torch.float32, use_sketch=sketch,
                             device="cpu"))
    table = decode_slot_table(0, SEQ, sa.d_slots, sa.m_r) if sketch else None
    slots = decode_slots(0, SEQ, sa.d_slots, sa.m_r) if sketch else None
    with torch.no_grad():
        first, cache = prefill_with_cache(params, tokens, cfg, cache, slot_table=table,
                                          q_chunk=8)
        second, cache = decode_step(params, cache, nxt, SEQ, cfg, slots=slots)
    return {"prefill": first, "decode": second,
            **{f"cache{i}": x for i, x in enumerate(tree_leaves(cache))}}


def _digest(t) -> str:
    return hashlib.sha1(t.detach().float().contiguous().numpy().tobytes()).hexdigest()


# --------------------------------------------------------------------------- #
# the worker
# --------------------------------------------------------------------------- #

def _worker(rank: str, store: str, base: str) -> int:
    from repro_torch import sharding as sh
    from repro_torch._util import tree_leaves, tree_map
    from repro_torch.checkpoint.ckpt import committed_steps, restore, save
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compress import CompressConfig
    from repro_torch.train import step as ST
    from repro_torch.train.loop import LoopConfig, run

    rank, base = int(rank), Path(base)
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.FileStore(store, WORLD), rank=rank,
        world_size=WORLD, timeout=timedelta(seconds=60))
    report: dict = {"digests": {}}
    out: dict = {}
    try:
        mesh = make_debug_mesh(*SHAPE, device="cpu")
        report["mesh"] = {k: int(v) for k, v in mesh.shape.items()}
        # the expert-parallel MoE
        for case, (cfg, _) in MOE.items():
            p, h = _moe_tree(_moe_inputs(case))

            def place(path, a):
                t = torch.from_numpy(a)
                return sh.distribute(t, mesh, sh.param_spec(mesh, "ffn/" + "/".join(path),
                                                            tuple(t.shape)))

            pp = sh._with_paths(place, p)
            hh = sh.distribute(torch.from_numpy(h), mesh, sh.batch_spec(mesh, h.shape[0],
                                                                        extra_dims=2))
            leaves = [x.requires_grad_() for x in tree_leaves(pp)] + [hh.requires_grad_()]
            with mesh:
                o, mets = MO.moe_forward(pp, hh, cfg)
                loss = torch.sum(o ** 2) + mets.aux_loss
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            vals = {"out": o, "aux": mets.aux_loss, "dropped": mets.dropped_fraction,
                    **{f"g_{n}": g for n, g in zip(_grad_names(p) + ["h"], grads)}}
            for k, v in vals.items():
                whole = sh.full(v).detach()
                out[f"{case}_{k}"] = whole.numpy()
                report["digests"][f"{case}_{k}"] = _digest(whole)
            report[f"{case}_placements"] = [str(x.placements) for x in (hh, o)]
        # the reduced models, float32
        for arch in ARCH_NAMES:
            cfg = MODELS[arch]
            params = init_params(0, cfg, device="cpu", dtype=torch.float32)
            if cfg.moe is None:
                # as the reference's numpy parameters come across
                from repro_torch import interop

                params = interop.params_from_numpy(tree_map(lambda t: t.numpy(), params),
                                                   cfg, device="cpu", mesh=mesh)
            else:
                params = sh.shard_tree(params, mesh, sh.params_shardings(mesh, params))
            report[f"{arch}_placements"] = [str(x.placements) for x in tree_leaves(params)]
            tok, lab = _batch(cfg)
            tok, lab = (sh.distribute(t, mesh, sh.batch_spec(mesh, BATCH)) for t in (tok, lab))
            with mesh:
                loss, grads = _model_loss_and_grads(params, tok, lab, cfg)
            out[f"{arch}_loss"] = sh.full(loss).detach().numpy()
            report["digests"][f"{arch}_loss"] = _digest(sh.full(loss))
            for i, g in enumerate(grads):
                whole = sh.full(g)
                out[f"{arch}_g{i}"] = whole.numpy()
                report["digests"][f"{arch}_g{i}"] = _digest(whole)
        # the wide model on the tiny batch
        params = init_params(0, WIDE, device="cpu", dtype=torch.float32)
        params = sh.shard_tree(params, mesh, sh.params_shardings(mesh, params))
        tok, lab = (sh.distribute(t, mesh, sh.batch_spec(mesh, WIDE_BATCH_SEQ[0]))
                    for t in _batch(WIDE, *WIDE_BATCH_SEQ))
        with mesh:
            loss, grads = _model_loss_and_grads(params, tok, lab, WIDE)
        for k, v in {"loss": loss, **{f"g{i}": g for i, g in enumerate(grads)}}.items():
            whole = sh.full(v).detach()
            out[f"wide_{k}"] = whole.numpy()
            report["digests"][f"wide_{k}"] = _digest(whole)
        # serving: prefill with a cache placed by cache_shardings, one decode step
        for arch in SERVE_ARCHS:
            cfg = MODELS[arch]
            params = init_params(0, cfg, device="cpu", dtype=torch.float32)
            params = sh.shard_tree(params, mesh, sh.params_shardings(mesh, params))
            tok, lab = _batch(cfg)
            tok, nxt = (sh.distribute(t, mesh, sh.batch_spec(mesh, BATCH))
                        for t in (tok, lab[:, -1].contiguous()))

            def place(cache):
                def one(x):
                    stacked = torch.empty((cfg.n_superblocks, *x.shape), device="meta")
                    return sh.distribute(x, mesh, tuple(sh.cache_shardings(
                        mesh, stacked, BATCH, cfg.sharding_policy)[1:]))

                return tree_map(one, cache)

            for kind in SERVE_CACHES:
                with mesh:
                    vals = _serve(params, cfg, tok, nxt, kind, place)
                cache_pl = [str(v.placements) for k, v in vals.items() if k.startswith("cache")]
                report[f"{arch}_{kind}_placements"] = cache_pl
                for k, v in vals.items():
                    whole = sh.full(v).detach()
                    out[f"{arch}_{kind}_{k}"] = whole.numpy()
                    report["digests"][f"{arch}_{kind}_{k}"] = _digest(whole)
        # a sharded loop: 4 steps against 2, a checkpoint and 2 resumed
        cfg = reduced(ARCHS["stablelm-3b"])
        tc = ST.TrainConfig(optimizer=AdamWConfig(lr_peak=1e-3, warmup_steps=2,
                                                  total_steps=4), q_chunk=8,
                            compress=CompressConfig(ratio=0.25, m=4, min_rows=256))
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH)

        def init():
            return ST.place_train_state(ST.init_train_state(
                init_params(0, cfg, device="cpu"), tc), mesh)

        logs: list = []
        runs = {}
        for name, steps, ck in (("whole", 4, ""), ("first", 2, base / "ckpt"),
                                ("resumed", 4, base / "ckpt")):
            holder = {}

            def init_keep():
                holder["state"] = init()
                return holder["state"]

            def step_fn(s, t, lb, i):
                s, m = ST.train_step(s, t, lb, i, cfg, tc, mesh=mesh)
                holder["state"] = s
                return s, m

            rep = run(cfg, tc, dc, LoopConfig(total_steps=steps, ckpt_dir=str(ck),
                                              ckpt_every=2), init_params_fn=init_keep,
                      step_fn=step_fn, log=logs.append, mesh=mesh)
            st = holder["state"]
            runs[name] = {"losses": rep.losses, "resumed_from": rep.resumed_from,
                          "state": [_digest(sh.full(x)) for x in tree_leaves(
                              (st.params, st.opt.m, st.opt.v, st.opt.master))],
                          "ef": [_digest(e) for e in tree_leaves(st.ef) if e is not None],
                          "placements": sorted({str(x.placements) for x in
                                                tree_leaves(st.params)})}
        report["loop"] = runs
        report["ckpt_steps"] = committed_steps(str(base / "ckpt" / f"rank{rank}"))
        # a state restores only on the mesh and placements it was saved with:
        # this rank's (2, 2) shards into whole tensors (a data-mesh state), and
        # whole tensors (a data-mesh checkpoint) into the (2, 2) state
        whole = tree_map(sh.full, st)
        save(str(base / "whole" / f"rank{rank}"), whole, step=4)
        for direction, path, like in (
                ("shards_into_whole", base / "ckpt" / f"rank{rank}", whole),
                ("whole_into_shards", base / "whole" / f"rank{rank}", st)):
            try:
                restore(str(path), like)
                report[direction] = "restored"
            except ValueError as e:
                report[direction] = str(e)
        try:
            make_production_mesh(device="cpu")
            report["production"] = "made"
        except RuntimeError as e:
            report["production"] = str(e)
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0:
        np.savez(base / "ranks.npz", **out)
    report["imports_jax"] = any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
    (base / f"report{rank}.json").write_text(json.dumps(report))
    return 0


# --------------------------------------------------------------------------- #
# the reference, in a subprocess with four host devices
# --------------------------------------------------------------------------- #

_JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import MoECfg
from repro.models import moe as moem
base = sys.argv[1]
cases = {CASES}
out = {}
for case, kw in cases.items():
    cfg = MoECfg(**kw)
    z = np.load(os.path.join(base, f"moe_{case}.npz"))
    p = {k: jnp.asarray(z[k]) for k in z.files if k != "h" and not k.startswith("dense/")}
    if cfg.dense_residual:
        p["dense"] = {k[6:]: jnp.asarray(z[k]) for k in z.files if k.startswith("dense/")}
    h = jnp.asarray(z["h"])

    def loss(p, h):
        o, m = moem.moe_forward(p, h, cfg)
        return jnp.sum(o ** 2) + m.aux_loss, (o, m.aux_loss, m.dropped_fraction)

    mesh = jax.make_mesh((2, 2), ("data", "model"))
    with mesh:
        (_, (o, aux, dropped)), (gp, gh) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, h)
    out[f"{case}_out"], out[f"{case}_aux"] = np.asarray(o), np.asarray(aux)
    out[f"{case}_dropped"], out[f"{case}_g_h"] = np.asarray(dropped), np.asarray(gh)
    for k, v in gp.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                out[f"{case}_g_{k}/{k2}"] = np.asarray(v2)
        else:
            out[f"{case}_g_{k}"] = np.asarray(v)
np.savez(os.path.join(base, "jax.npz"), **out)
print("OK")
"""


def _jax_script() -> str:
    import dataclasses

    cases = {c: dataclasses.asdict(cfg) for c, (cfg, _) in MOE.items()}
    return _JAX_SCRIPT.replace("{CASES}", repr(cases))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(base dir, [each rank's report], the ranks' arrays, the reference's
    arrays): four gloo ranks and the reference's subprocess, all started
    together, each with its time limit."""
    base = tmp_path_factory.mktemp("mesh2d")
    for case in MOE:
        np.savez(base / f"moe_{case}.npz", **_moe_inputs(case))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(base / "store"),
                               str(base)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    ref = subprocess.Popen([sys.executable, "-c", _jax_script(), str(base)],
                           env=dict(env, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    logs = []
    for p in [*procs, ref]:
        try:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in [*procs, ref]:
                q.kill()
            logs.append(p.communicate()[0])
    for r, (p, log) in enumerate(zip([*procs, ref], logs)):
        who = "the reference" if p is ref else f"rank {r}"
        assert p.returncode == 0, f"{who} exit {p.returncode}:\n{log[-4000:]}"
    reports = [json.loads((base / f"report{r}.json").read_text()) for r in range(WORLD)]
    return base, reports, dict(np.load(base / "ranks.npz")), dict(np.load(base / "jax.npz"))


def _max_err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))))


def _moe_keys(case: str) -> list[str]:
    p, _ = _moe_tree(_moe_inputs(case))
    return ["out", "aux", "dropped"] + [f"g_{n}" for n in _grad_names(p) if
                                        not n.endswith("norm")] + ["g_h"]


def _hold_moe(got: dict, ref: dict, case: str) -> None:
    for k in _moe_keys(case):
        tol = 1e-3 if k.startswith("g_") else 1e-5
        err = _max_err(got[k], ref[f"{case}_{k}"])
        assert err <= tol, (case, k, err)


@pytest.mark.parametrize("case", list(MOE))
def test_a2a_matches_the_reference_a2a(ranks, case):
    _, _, got, ref = ranks
    _hold_moe({k[len(case) + 1:]: v for k, v in got.items() if k.startswith(case + "_")},
              ref, case)
    if case == "drops":
        assert float(ref["drops_dropped"]) > 0.0


@pytest.mark.parametrize("case", list(MOE))
def test_plain_a2a_matches_the_reference_a2a(ranks, case):
    _, _, _, ref = ranks
    cfg, _ = MOE[case]
    p, h = _moe_tree(_moe_inputs(case))
    from repro_torch._util import tree_leaves, tree_map

    pt = tree_map(lambda a: torch.from_numpy(a).requires_grad_(), p)
    ht = torch.from_numpy(h).requires_grad_()
    o, mets = MO.moe_forward_a2a_plain(pt, ht, cfg, 2, 2)
    loss = torch.sum(o ** 2) + mets.aux_loss
    grads = torch.autograd.grad(loss, tree_leaves(pt) + [ht], allow_unused=True,
                                materialize_grads=True)
    got = {"out": o.detach().numpy(), "aux": mets.aux_loss.detach().numpy(),
           "dropped": mets.dropped_fraction.numpy(),
           **{f"g_{n}": g.numpy() for n, g in zip(_grad_names(p) + ["h"], grads)}}
    _hold_moe(got, ref, case)


def test_a2a_equals_local_when_nothing_is_dropped(ranks):
    # the a2a path gathers the float32 expert weights in bfloat16 (the data
    # axis is 2), so the local path gets them rounded so too
    _, _, got, _ = ranks
    cfg, _ = MOE["nodrop"]
    p, h = _moe_tree(_moe_inputs("nodrop"))
    from repro_torch._util import tree_map

    p = {k: (v.astype(np.float32) if k not in EXPERT_NAMES else
             torch.from_numpy(v).bfloat16().float().numpy()) if not isinstance(v, dict)
         else v for k, v in p.items()}
    pt = tree_map(lambda a: torch.from_numpy(a).requires_grad_(), p)
    o, mets = MO.moe_forward_local(pt, torch.from_numpy(h), cfg)
    loss = torch.sum(o ** 2) + mets.aux_loss
    assert float(got["nodrop_dropped"]) == 0.0
    assert _max_err(got["nodrop_out"], o.detach().numpy()) <= 1e-5
    for n, g in zip(EXPERT_NAMES, torch.autograd.grad(loss, [pt[n] for n in EXPERT_NAMES])):
        assert _max_err(got[f"nodrop_g_{n}"], g.numpy()) <= 1e-3, n


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_on_the_mesh_equals_one_process(ranks, arch):
    _, _, got, _ = ranks
    cfg = MODELS[arch]
    params = init_params(0, cfg, device="cpu", dtype=torch.float32)
    tok, lab = _batch(cfg)
    if cfg.moe is not None:
        with _plain_a2a(*SHAPE):
            loss, grads = _model_loss_and_grads(params, tok, lab, cfg)
    else:
        loss, grads = _model_loss_and_grads(params, tok, lab, cfg)
    names = _leaf_names(params)
    loss = float(loss.detach())
    assert abs(float(got[f"{arch}_loss"]) - loss) <= 1e-6 * abs(loss)
    for i, (name, g) in enumerate(zip(names, grads)):
        want = g.numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        tol = 2.0 ** -8 if cfg.moe is not None and name.split("/")[-1] in EXPERT_NAMES \
            and "/ffn/" in f"/{name}/" else 1e-5
        assert _max_err(got[f"{arch}_g{i}"], want) <= tol * scale, (name,)


def test_partial_products_before_a_reshape_train_on_the_mesh(ranks):
    _, _, got, _ = ranks
    params = init_params(0, WIDE, device="cpu", dtype=torch.float32)
    loss, grads = _model_loss_and_grads(params, *_batch(WIDE, *WIDE_BATCH_SEQ), WIDE)
    loss = float(loss.detach())
    assert abs(float(got["wide_loss"]) - loss) <= 1e-6 * abs(loss)
    for i, (name, g) in enumerate(zip(_leaf_names(params), grads)):
        scale = max(float(np.abs(g.numpy()).max()), 1e-30)
        assert _max_err(got[f"wide_g{i}"], g.numpy()) <= 1e-5 * scale, (name,)


@pytest.mark.parametrize("kind", SERVE_CACHES)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serving_on_the_mesh_equals_one_process(ranks, arch, kind):
    _, reports, got, _ = ranks
    cfg = MODELS[arch]
    params = init_params(0, cfg, device="cpu", dtype=torch.float32)
    tok, lab = _batch(cfg)
    with _plain_a2a(*SHAPE):
        want = _serve(params, cfg, tok, lab[:, -1].contiguous(), kind)
    assert len([k for k in got if k.startswith(f"{arch}_{kind}_")]) == len(want)
    for k, w in want.items():
        w = w.numpy()
        tol = 1e-6 if k.startswith("cache") else 1e-5
        scale = max(float(np.abs(w).max()), 1e-30)
        assert _max_err(got[f"{arch}_{kind}_{k}"], w) <= tol * scale, (k,)
    # every rank keeps its own shard of the cache, placed as cache_shardings
    # placed it: the batch on data, the positions (exact) or slots on model
    split = "(Shard(dim=0), Shard(dim=1))" if kind == "exact" else "(Shard(dim=0), Shard(dim=2))"
    for r in reports:
        assert r[f"{arch}_{kind}_placements"] == [split] * (2 if kind == "exact" else 3)


def _leaf_names(tree: dict, prefix: str = "") -> list[str]:
    out = []
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        out += _leaf_names(tree[k], path) if isinstance(tree[k], dict) else [path]
    return out


def test_replicated_outputs_are_bitwise_equal_across_ranks(ranks):
    _, reports, _, _ = ranks
    for r in reports[1:]:
        assert r["digests"] == reports[0]["digests"]
        assert r["loop"] == reports[0]["loop"]
    assert all(not r["imports_jax"] for r in reports)
    assert reports[0]["mesh"] == {"data": 2, "model": 2}
    # the MoE input is batch-sharded on data and replicated on model
    assert reports[0]["drops_placements"][0] == "(Shard(dim=0), Replicate())"


def test_sharded_loop_resumes_bitwise(ranks):
    _, reports, _, _ = ranks
    for r in reports:
        loop = r["loop"]
        assert loop["first"]["resumed_from"] is None and loop["resumed"]["resumed_from"] == 2
        assert loop["resumed"]["losses"] == loop["whole"]["losses"][2:]
        assert loop["resumed"]["state"] == loop["whole"]["state"]
        assert loop["resumed"]["ef"] == loop["whole"]["ef"] and len(loop["whole"]["ef"]) == 2
        assert all(np.isfinite(loop["whole"]["losses"]))
        assert r["ckpt_steps"] == [4, 2]
        # the parameters are sharded: some leaves over data, some over model
        pls = " ".join(loop["whole"]["placements"])
        assert "Shard(dim=0), Shard(dim=1)" in pls or "Shard(dim=1), Shard(dim=0)" in pls


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_parameters_are_placed_by_param_spec(ranks, arch):
    from repro_torch import sharding as sh

    _, reports, _, _ = ranks
    cfg = MODELS[arch]
    params = init_params(0, cfg, device="cpu", dtype=torch.float32)
    from repro_torch._util import tree_leaves

    m = type("M", (), {"shape": {"data": 2, "model": 2}, "axis_names": ("data", "model")})
    want = [str(tuple(sh.placements(m, s))) for s in sh._spec_leaves(
        sh.params_shardings(m, params))]
    assert len(want) == len(tree_leaves(params))
    assert reports[0][f"{arch}_placements"] == want


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_one_rank_mesh_is_bitwise_no_mesh(arch):
    # a 1 × 1 ("data", "model") mesh places everything whole: the loss and
    # every gradient bit for bit the call without a mesh
    from repro_torch import sharding as sh
    from repro_torch.core.distributed import make_data_mesh

    cfg = MODELS[arch]
    params = init_params(0, cfg, device="cpu", dtype=torch.float32)
    tok, lab = _batch(cfg)
    loss0, g0 = _model_loss_and_grads(params, tok, lab, cfg)
    group = make_data_mesh(device="cpu")            # a one-rank gloo group
    try:
        mesh = sh.make_mesh((1, 1), ("data", "model"), device="cpu")
        pm = sh.shard_tree(params, mesh, sh.params_shardings(mesh, params))
        tm, lm = (sh.distribute(t, mesh, sh.batch_spec(mesh, BATCH)) for t in (tok, lab))
        with mesh:
            loss1, g1 = _model_loss_and_grads(pm, tm, lm, cfg)
        assert sh.is_dtensor(loss1) and all(sh.is_dtensor(g) for g in g1)
        assert torch.equal(sh.full(loss1), loss0)
        assert all(torch.equal(sh.full(a), b) for a, b in zip(g1, g0))
    finally:
        group.close()
    assert not torch.distributed.is_initialized()


def _grad_on_a_thread(loss, leaves):
    """``torch.autograd.grad`` on another thread, as the autograd engine runs
    a card's backward (and a checkpointed block's recompute) on a worker
    thread of its own.  The engine carries the caller's C++ thread-local
    state there (DTensor's implicit replication with it), and so does this
    thread; Python's context variables it does not carry."""
    import threading

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import sharding as sh

    def run():
        with implicit_replication() if sh.current_mesh() is not None else \
                contextlib.nullcontext():
            out["g"] = torch.autograd.grad(loss, leaves, allow_unused=True,
                                           materialize_grads=True)

    out = {}
    t = threading.Thread(target=run)
    t.start()
    t.join()
    return out["g"]


def test_the_recompute_on_another_thread_takes_the_forward_path():
    from repro_torch import sharding as sh
    from repro_torch._util import tree_leaves, tree_map
    from repro_torch.core.distributed import make_data_mesh

    cfg = reduced(ARCHS["moonshot-v1-16b-a3b"])
    params = init_params(0, cfg, device="cpu", dtype=torch.float32)
    tok, lab = _batch(cfg)

    def loss_of(p, t, lb):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
        it = iter(leaves)
        loss, _ = loss_fn(tree_map(lambda _: next(it), p), t, lb, cfg, q_chunk=8,
                          remat="full")
        return loss, leaves

    with _plain_a2a(*SHAPE):
        loss, leaves = loss_of(params, tok, lab)
        g_thread = _grad_on_a_thread(loss, leaves)
        loss, leaves = loss_of(params, tok, lab)
        g_here = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    assert all(torch.equal(a, b) for a, b in zip(g_thread, g_here))
    group = make_data_mesh(device="cpu")
    try:
        mesh = sh.make_mesh((1, 1), ("data", "model"), device="cpu")
        pm = sh.shard_tree(params, mesh, sh.params_shardings(mesh, params))
        tm, lm = (sh.distribute(t, mesh, sh.batch_spec(mesh, BATCH)) for t in (tok, lab))
        with mesh:
            loss, leaves = loss_of(pm, tm, lm)
            g_mesh = _grad_on_a_thread(loss, leaves)
    finally:
        group.close()
    _, g0 = _model_loss_and_grads(params, tok, lab, cfg)
    assert all(torch.equal(sh.full(a), b) for a, b in zip(g_mesh, g0))


_MESH22 = "{'mesh': [['data', 2], ['model', 2]]"
# each direction's (what the checkpoint holds, what the target is) in the error
_REFUSALS = {"shards_into_whole": (f"saved as {_MESH22}", "into a whole tensor"),
             "whole_into_shards": ("saved as a whole tensor", f"into {_MESH22}")}


@pytest.mark.parametrize("direction", list(_REFUSALS))
def test_a_checkpoint_restores_only_on_its_own_mesh(ranks, direction):
    _, reports, _, _ = ranks
    saved, target = _REFUSALS[direction]
    for r in reports:
        assert saved in r[direction] and target in r[direction], r[direction]


def test_production_mesh_refuses_four_ranks(ranks):
    _, reports, _, _ = ranks
    for r in reports:
        assert "needs 256 ranks, found 4" in r["production"]


if __name__ == "__main__":
    sys.exit(_worker(*sys.argv[1:]))
