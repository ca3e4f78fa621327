"""The port's trace-contract analyzer (``repro_torch.analysis``): every
detector proven on a planted fault, mirroring tests/test_analysis.py where
its test has a meaning in PyTorch eager.

  * the recorder: a quadratic buffer trips the budget, loop trips multiply
    the dispatch count and the FLOPs, a planted ``.item()`` is a host sync,
    ``donate=False`` fails the donation check, the dtype census, and ops
    under ``no_grad`` and inside ``torch.utils.checkpoint`` are seen;
  * RNG lineage: a shared stream and a generator re-seeded in a loop are
    flagged, tagged streams and position folds are accepted, and recording
    changes no drawn bit; the sweep is clean and catches an unregistered
    site; the registry pins the tag values (the four shared ones equal the
    reference's);
  * contracts: ``eval_budget`` agrees with the reference's on all 14
    expressions, the manifest round-trips, the ratchet only descends, a
    wrong dispatch count fails, the full manifest passes on the CPU, the
    result is JSON-ready, and the manifest keeps the reference's names,
    budgets and probes;
  * the hardware model's override."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import contracts as CJ  # noqa: E402
from repro.analysis import streams as SJ  # noqa: E402
from repro_torch import _util  # noqa: E402
from repro_torch.analysis import contracts as C  # noqa: E402
from repro_torch.analysis import hardware as H  # noqa: E402
from repro_torch.analysis import rng as R  # noqa: E402
from repro_torch.analysis import streams as S  # noqa: E402
from repro_torch.analysis import trace as T  # noqa: E402
from repro_torch.core import apply as A  # noqa: E402
from repro_torch.core import make_accum_sketch  # noqa: E402
from repro_torch.kernels.accum_apply import ops  # noqa: E402


def _K(n=64, seed=0):
    X = torch.rand((n, 3), generator=torch.Generator().manual_seed(seed))
    return torch.exp(-torch.cdist(X, X) ** 2)


# --------------------------------------------------------------------------- #
# the recorder
# --------------------------------------------------------------------------- #

def test_peak_bytes_trips_on_quadratic_buffer():
    """An n×n outer product is seen at full size and trips a budget of
    O(n); the streamed row sums of the same quantity stay O(n)."""
    n = 512
    x = torch.ones(n)
    quad = T.trace_report(lambda x: (x[:, None] * x[None, :]).sum(), x)
    assert quad.peak_bytes == n * n * 4 and quad.peak_shape == (n, n)

    def streamed(x):
        acc = torch.zeros(())
        for xi in x[:16]:
            acc = acc + (xi * x).sum()
        return acc

    lean = T.trace_report(streamed, x)
    assert lean.peak_bytes <= n * 4
    entry = {"budget": "4*n + 1*KiB", "probe_n": n}
    assert C.eval_budget(entry["budget"], {"n": n}) < quad.peak_bytes


@pytest.mark.parametrize("loop", ["for", "while"])
def test_loop_trips_multiply_dispatches_and_flops(loop):
    """A router called on every trip of a loop counts every trip, and so do
    the FLOPs (the reference multiplies by scan lengths and while-loop
    bounds; eager runs the trips)."""
    trips, d = 5, 16
    sk = make_accum_sketch(torch.Generator().manual_seed(1), 64, 8, 2, device="cpu")
    M = torch.ones((d, d))

    def trip(K, x):
        ops.sketch_right_kernel(K, sk)
        return x @ M

    def run(K, x):
        if loop == "for":
            for _ in range(trips):
                x = trip(K, x)
        else:
            i = 0
            while i < trips:
                x, i = trip(K, x), i + 1
        return x

    one = T.trace_report(trip, _K(), torch.ones((d, d)))
    rep = T.trace_report(run, _K(), torch.ones((d, d)))
    assert one.kernel_dispatches == 1 and one.flops >= 2 * d ** 3
    assert rep.kernel_dispatches == trips
    assert rep.kernel_routes == {"sketch_right_kernel": trips}
    assert rep.flops == pytest.approx(trips * one.flops)


def test_planted_item_is_a_host_sync():
    def synced(x):
        return x * float(x.sum())

    rep = T.trace_report(synced, torch.ones(4))
    assert rep.host_syncs == ["_local_scalar_dense"]
    assert T.trace_report(lambda x: x * 2, torch.ones(4)).host_syncs == []
    assert T.trace_report(lambda x: torch.nonzero(x), torch.ones(4)).host_syncs == ["nonzero"]


def test_donation_check_catches_donate_false():
    """donate=True writes the new C over the state's (on the CPU too: the
    router's plain version copies into ``out``); donate=False does not, and
    the check says so."""
    K = _K()
    for donate in (True, False):
        st = A.accum_init(torch.Generator().manual_seed(2), 64, 8, 4, device="cpu")
        out = A.accum_grow_batched(K, st, 2, use_kernel=True, donate=donate)
        assert T.verify_donation(out.C, st.C) is donate
    entry = dict(C.load_manifest()["accum_grow_batched"])
    res = C.evaluate_contract("accum_grow_batched", entry, device="cpu")
    assert res.status == "pass" and res.report["donation_verified"] is True
    planted = C.ENTRY_POINTS["accum_grow_batched"]

    def no_donation(probe, dev):
        t = planted(probe, dev)
        return C.Target(lambda K, s: A.accum_grow_batched(K, s, probe["B"], use_kernel=True,
                                                          donate=False), t.args, t.donated)

    C.ENTRY_POINTS["accum_grow_batched"] = no_donation
    try:
        res = C.evaluate_contract("accum_grow_batched", entry, device="cpu")
    finally:
        C.ENTRY_POINTS["accum_grow_batched"] = planted
    assert res.status == "fail" and any("donation" in v for v in res.violations)


def test_dtype_census_and_compat_helpers():
    def f(x):
        y = x.to(torch.bfloat16)
        return (y @ y).float()

    rec = T.record(f, torch.ones((8, 8)))
    rep = T.report_from_jaxpr(rec)
    assert rep.dtype_census["bfloat16"]["buffers"] == 2
    assert rep.dtype_census["float32"] == {"buffers": 1, "bytes": 256}
    assert T.max_intermediate_elems(rec) == 64
    assert T.peak_intermediate_bytes(rec) == 256
    assert T.count_pallas_calls(rec) == 0
    assert (8, 8) in T.all_shapes(rec)


def test_ops_under_no_grad_and_checkpoint_are_seen():
    from torch.utils.checkpoint import checkpoint

    w = torch.ones((4, 4), requires_grad=True)

    def f(x):
        with torch.no_grad():
            a = x @ x
        return checkpoint(lambda y: torch.tanh(y @ w), a, use_reentrant=False).sum()

    rep = T.trace_report(f, torch.ones((4, 4)))
    assert rep.primitives["mm"] == 2 and rep.primitives["tanh"] == 1


# --------------------------------------------------------------------------- #
# RNG lineage
# --------------------------------------------------------------------------- #

def test_rng_checker_flags_a_shared_stream():
    """The correlated-streams bug: slot draws and sampling from one (seed,
    pos)."""
    def shared(pos):
        g1 = _util.position_generator(0, S.SLOT_STREAM, pos)
        g2 = _util.position_generator(0, S.SLOT_STREAM, pos)
        return torch.randint(0, 16, (4,), generator=g1), torch.rand(4, generator=g2)

    rep = R.rng_report(shared, 3)
    assert not rep.ok and [i.kind for i in rep.issues] == ["reused-key"]


def test_rng_checker_accepts_tagged_streams_and_positions():
    def fixed(pos):
        out = []
        for p in range(pos, pos + 3):
            out.append(torch.rand(4, generator=_util.position_generator(0, S.SLOT_STREAM, p)))
            out.append(torch.rand(4, generator=_util.position_generator(0, S.SAMPLE_STREAM,
                                                                        p)))
        return out

    rep = R.rng_report(fixed, 3)
    assert rep.ok and rep.consumptions == 6 and rep.keys_seen == 6


def test_rng_checker_flags_a_generator_reseeded_in_a_loop():
    def bad():
        return [torch.rand(2, generator=_util.stream_generator(5, S.HOLDOUT_STREAM))
                for _ in range(3)]

    assert [i.kind for i in R.rng_report(bad).issues] == ["loop-reuse"]

    def good():
        return [torch.rand(2, generator=_util.position_generator(5, S.HOLDOUT_STREAM, i))
                for i in range(3)]

    assert R.rng_report(good).ok


def test_recording_changes_no_drawn_bit():
    def draws():
        return torch.rand(8, generator=_util.position_generator(7, S.DATA_STREAM, 3, 1))

    plain = draws()
    out, rep = R.record(draws)
    assert torch.equal(out, plain) and rep.consumptions == 1


def test_rng_sweep_is_clean_and_detects_unregistered(tmp_path):
    assert R.check_fold_in_sites() == []
    (tmp_path / "mod.py").write_text(
        "from repro_torch._util import stream_generator, position_generator\n"
        "def f(seed, step):\n"
        "    return position_generator(seed, 0x1234, step)\n"
        "def g(seed):\n"
        "    return stream_generator(seed)\n")
    (tmp_path / "raw.py").write_text(
        "import torch\n"
        "g = torch.Generator().manual_seed(0)\n")
    bad = R.sweep_fold_in_sites(tmp_path)
    assert len(bad) == 4 and not any(s.ok for s in bad)
    assert sorted(s.via for s in bad) == ["raw", "raw", "unregistered", "unregistered"]
    (tmp_path / "ok.py").write_text(
        "from repro_torch._util import stream_generator, position_generator\n"
        "from repro_torch._util import REFINE_STREAM\n"
        "def f(seed, step, i):\n"
        "    a = position_generator(seed, 0x510C, step)\n"
        "    b = stream_generator(seed, REFINE_STREAM + i)\n"
        "    # rng-stream: slabs\n"
        "    c = stream_generator(seed)\n"
        "    return a, b, c\n")
    ok = [s for s in R.sweep_fold_in_sites(tmp_path) if s.path == "ok.py"]
    assert len(ok) == 3 and all(s.ok for s in ok)
    assert [s.via for s in ok] == ["tag", "tag", "marker"]


def test_stream_registry_pins_tag_values():
    """Tag values are the seed contract; the four the reference has are its
    values, and _util takes the same objects."""
    pins = {"SLOT_STREAM": 0x510C, "SAMPLE_STREAM": 0x5A3E, "HOLDOUT_STREAM": 0x5E1D,
            "REFINE_STREAM": 0x11E7, "KMEANS_STREAM": 0x4B3A, "DATA_STREAM": 0xDA7A,
            "COMPRESS_STREAM": 0xC0DE}
    for name, value in pins.items():
        assert getattr(S, name) == getattr(_util, name) == value
    for name in ("SLOT_STREAM", "SAMPLE_STREAM", "HOLDOUT_STREAM", "REFINE_STREAM"):
        assert getattr(S, name) == getattr(SJ, name)
    assert S.stream_for_tag(0x510C).name == "serve-slots"
    assert len(S.TAG_VALUES) == 7
    for name in ("slot-position", "sample-position", "slabs", "init-params", "probe-data"):
        assert S.REGISTRY[name].tag is None


# --------------------------------------------------------------------------- #
# contracts
# --------------------------------------------------------------------------- #

def test_budget_expressions_agree_with_the_reference_and_reject_unknown_names():
    ref = CJ.load_manifest()
    mine = C.load_manifest()
    for name, entry in ref.items():
        probe = C._probe_vars(entry)
        assert C.eval_budget(mine[name]["budget"], probe) == CJ.eval_budget(
            entry["budget"], probe), name
    with pytest.raises(ValueError):
        C.eval_budget("__import__('os')", {})
    with pytest.raises(ValueError):
        C.eval_budget("n + q", {"n": 1})
    with pytest.raises(ValueError):
        C.eval_budget("n.real", {"n": 1})


def test_manifest_keeps_the_reference_names_budgets_and_probes():
    ref, mine = CJ.load_manifest(), C.load_manifest()
    assert mine.keys() == ref.keys() == C.ENTRY_POINTS.keys()
    for name, entry in ref.items():
        kept = {k: v for k, v in entry.items()
                if k.startswith("probe_") or k in ("budget", "donation", "rng", "devices")}
        assert {k: mine[name][k] for k in kept} == kept, name
        assert "pallas_calls" not in mine[name]


def test_manifest_round_trip(tmp_path):
    manifest = {"thing": {"budget": "4*n*n + 1*MiB", "kernel_dispatches": 1,
                          "donation": True, "probe_n": 256, "probe_d": 8,
                          "measured_peak_bytes": 262144, "forbid": ["nonzero"]}}
    import tomllib

    path = tmp_path / "contracts.toml"
    C.dump_manifest(manifest, path)
    assert C.load_manifest(path) == manifest == tomllib.loads(path.read_text())
    assert C.load_manifest() == tomllib.loads(C.CONTRACTS_PATH.read_text())


def test_check_update_ratchet_only_descends(tmp_path):
    """check → --update → check clean; a ratchet planted below the measured
    peak fails and --update keeps it; a planted budget violation fails."""
    path = tmp_path / "contracts.toml"
    C.dump_manifest({"sketch_both": {"budget": "4*n*n + 1*MiB", "kernel_dispatches": 1,
                                     "probe_n": 64, "probe_d": 8, "probe_m": 2}}, path)
    results, _, manifest = C.run_check(path=path, update=True, only="sketch_both",
                                       device="cpu")
    assert results[0].status == "pass"
    measured = manifest["sketch_both"]["measured_peak_bytes"]
    assert measured == results[0].measured_peak_bytes > 0
    assert C.run_check(path=path, only="sketch_both", device="cpu")[0][0].status == "pass"

    tight = C.load_manifest(path)
    tight["sketch_both"]["measured_peak_bytes"] = measured // 2
    results, _, after = C.run_check(manifest=tight, path=path, only="sketch_both",
                                    update=True, device="cpu")
    assert results[0].status == "fail" and any("ratchet" in v for v in results[0].violations)
    assert after["sketch_both"]["measured_peak_bytes"] == measured // 2
    assert C.load_manifest(path)["sketch_both"]["measured_peak_bytes"] == measured // 2

    broke = C.load_manifest(path)
    broke["sketch_both"].update(budget="n", measured_peak_bytes=measured)
    results, _, _ = C.run_check(manifest=broke, path=path, only="sketch_both", device="cpu")
    assert results[0].status == "fail"
    assert any("exceeds budget" in v for v in results[0].violations)


@pytest.mark.parametrize("key, value, says", [("kernel_dispatches", 3, "kernel dispatch"),
                                              ("host_syncs", 1, "host syncs")])
def test_contract_count_violation(key, value, says):
    entry = {"budget": "4*n*n + 1*MiB", "kernel_dispatches": 1, "probe_n": 64,
             "probe_d": 8, "probe_m": 2, key: value}
    res = C.evaluate_contract("sketch_both", entry, device="cpu")
    assert res.status == "fail" and any(says in v for v in res.violations)


def test_full_manifest_passes_on_the_cpu():
    """The shipped manifest holds here (the sharded contracts skip with one
    rank); the CLI exits 0 on it."""
    from repro_torch.analysis.__main__ import main

    results, sweep, _ = C.run_check(device="cpu")
    assert sweep == []
    assert not [(r.name, r.violations) for r in results if r.status == "fail"]
    assert sorted(r.name for r in results if r.status == "skipped") == [
        "sharded_grow_sketch_both", "sharded_sketch_both"]
    assert main(["check", "--device", "cpu", "--only", "sketch_both"]) == 0


def test_contract_result_json_ready(tmp_path):
    res = C.evaluate_contract("sketch_both", {"budget": "4*n*n + 1*MiB", "probe_n": 64,
                                              "probe_d": 8, "probe_m": 2}, device="cpu")
    blob = json.dumps(res.to_dict())
    assert "sketch_both" in blob and res.report["kernel_routes"] == {"sketch_both_kernel": 1}


# --------------------------------------------------------------------------- #
# hardware
# --------------------------------------------------------------------------- #

def test_hardware_override():
    hw = H.get_default_hardware()
    assert hw is H.H100_SXM and hw.name == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert (hw.hbm_bw, hw.peak_flops_f32, hw.peak_flops_tf32, hw.hbm_bytes) == (
        3.35e12, 67e12, 494.7e12, 80e9)
    slow = H.HardwareModel(name="half-power", peak_flops=hw.peak_flops / 2)
    prev = H.set_default_hardware(slow)
    try:
        assert H.get_default_hardware().peak_flops == hw.peak_flops / 2
    finally:
        assert H.set_default_hardware(prev) is slow
    assert H.get_default_hardware() is hw
