"""The port's measured autotune cache held against the reference module:
the same file contents give the same ``lookup`` answers, a corrupt or
unreadable file degrades to the static table with the same health record,
measuring persists its winner, launches made while measuring are counted
apart, an exception in a timed launch propagates, and the CPU route never
measures.  The CUDA side (every candidate against the static geometry) is in
test_torch_cuda_kernels.py."""
import json
import time

import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.accum_apply import autotune as AJ  # noqa: E402
from repro.resilience import degrade as DJ  # noqa: E402
from repro.resilience import faults as FJ  # noqa: E402
from repro_torch.core import make_accum_sketch  # noqa: E402
from repro_torch.kernels.accum_apply import autotune as AT  # noqa: E402
from repro_torch.kernels.accum_apply import kernel as KT  # noqa: E402
from repro_torch.kernels.accum_apply import ops as OT  # noqa: E402
from repro_torch.kernels.landmark_attention import kernel as LK  # noqa: E402
from repro_torch.kernels.landmark_attention import ops as LO  # noqa: E402
from repro_torch.resilience import degrade as DT  # noqa: E402
from repro_torch.resilience import faults as FT  # noqa: E402

SHAPE = (4096, 8192, 64, 4)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_memory(monkeypatch):
    """Each test reads its files anew (the modules mirror files in memory)."""
    monkeypatch.setattr(AJ, "_MEM", {})
    monkeypatch.setattr(AT, "_MEM", {})


def _ref_key():
    return AJ._key("accum_apply", SHAPE, jnp.float32, True)


def _port_key():
    return AT._key("accum_apply", SHAPE, torch.float32, CPU)


def _lookup_both(tmp_path, monkeypatch, content, arity):
    """Write ``content(key)`` for each module's own key, point the module at
    its file, and return (reference lookup, port lookup)."""
    got = []
    for name, mod, key, lookup in (
            ("ref", AJ, _ref_key(), lambda: AJ.lookup("accum_apply", SHAPE, jnp.float32,
                                                      True, arity=arity)),
            ("port", AT, _port_key(), lambda: AT.lookup("accum_apply", SHAPE,
                                                        torch.float32, CPU, arity=arity))):
        path = tmp_path / f"{name}.json"
        text = content(key)
        if text is not None:
            path.write_bytes(text)
        monkeypatch.setenv(mod.ENV_CACHE, str(path))
        got.append(lookup())
    return got


CASES = {
    "valid": (lambda k: json.dumps({k: [256, 64]}).encode(), 2, (256, 64)),
    "wrong_arity": (lambda k: json.dumps({k: [256]}).encode(), 2, None),
    "non_int": (lambda k: json.dumps({k: [256, "64"]}).encode(), 2, None),
    "non_positive": (lambda k: json.dumps({k: [256, 0]}).encode(), 2, None),
    "float": (lambda k: json.dumps({k: [256.0, 64]}).encode(), 2, None),
    "non_dict": (lambda k: json.dumps([[k, [256, 64]]]).encode(), 2, None),
    "truncated": (lambda k: json.dumps({k: [256, 64]}).encode()[:-7], 2, None),
    "missing": (lambda k: None, 2, None),
    "other_key": (lambda k: json.dumps({k + "x": [256, 64]}).encode(), 2, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_lookup_agrees_with_reference(tmp_path, monkeypatch, case):
    content, arity, want = CASES[case]
    before = (DJ.global_health().count("autotune.load"),
              DT.global_health().count("autotune.load"))
    ref, port = _lookup_both(tmp_path, monkeypatch, content, arity)
    assert ref == port == want
    # a truncated file is recorded by both; every other case by neither
    after = (DJ.global_health().count("autotune.load"),
             DT.global_health().count("autotune.load"))
    grew = 1 if case == "truncated" else 0
    assert after == (before[0] + grew, before[1] + grew)


def test_files_pass_each_others_validation(tmp_path, monkeypatch):
    """An entry either package wrote survives the other's validation."""
    path = tmp_path / "shared.json"
    monkeypatch.setenv(AT.ENV_CACHE, str(path))
    AT.record("sketch_both", (512, 16, 4), torch.float32, CPU, (256,))
    AJ.record("sketch_both", (512, 16, 4), jnp.float32, True, (128, 512))
    monkeypatch.setattr(AJ, "_MEM", {})
    monkeypatch.setattr(AT, "_MEM", {})
    raw = json.loads(path.read_text())
    assert AJ._load(path) == raw == AT._load(path)
    assert AT.lookup("sketch_both", (512, 16, 4), torch.float32, CPU) == (256,)
    assert AJ.lookup("sketch_both", (512, 16, 4), jnp.float32, True) == (128, 512)


def test_key_names_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    AT._backend.cache_clear()
    try:
        key = AT._key("accum_apply", (1, 2, 3, 4), torch.bfloat16, torch.device("cuda", 0))
    finally:
        AT._backend.cache_clear()
    assert key == "accum_apply|1|2|3|4|bfloat16|cuda:NVIDIA H100 80GB HBM3"
    assert AT._key("accum_apply", (1, 2, 3, 4), torch.float32, CPU) == \
        "accum_apply|1|2|3|4|float32|cpu"


def test_default_file_and_gate(monkeypatch):
    monkeypatch.delenv(AT.ENV_CACHE)
    assert AT.cache_path().parts[-3:] == (".cache", "repro_torch", "autotune.json")
    monkeypatch.delenv(AT.ENV_GATE, raising=False)
    assert AT.measure_enabled(torch.device("cuda")) is True
    assert AT.measure_enabled(CPU) is False
    monkeypatch.setenv(AT.ENV_GATE, "0")
    assert AT.measure_enabled(torch.device("cuda")) is False
    monkeypatch.setenv(AT.ENV_GATE, "1")
    assert AT.measure_enabled(CPU) is True


def _bench(calls, slow=(), sleep=0.003):
    def fn(c):
        calls.append(c)
        if c in slow:
            time.sleep(sleep)
    return fn


def test_winner_persists_and_is_served_untimed(tmp_path, monkeypatch):
    path = tmp_path / "at.json"
    monkeypatch.setenv(AT.ENV_CACHE, str(path))
    monkeypatch.setenv(AT.ENV_GATE, "1")
    calls = []
    cands = [(64,), (16,), (256,)]
    got = AT.measured_blocks("accum_apply", SHAPE, torch.float32, CPU, cands,
                             _bench(calls, slow={(64,), (256,)}), (64,), concrete=True)
    assert got == (16,)
    assert set(calls) == set(cands)
    assert json.loads(path.read_text()) == {_port_key(): [16]}
    calls.clear()
    monkeypatch.setattr(AT, "_MEM", {})   # a later process: the file alone
    again = AT.measured_blocks("accum_apply", SHAPE, torch.float32, CPU, cands,
                               _bench(calls), (64,), concrete=True)
    assert again == (16,) and calls == []


def test_jitter_in_one_round_does_not_decide(monkeypatch):
    """Each candidate keeps its fastest of ``ROUNDS`` interleaved rounds: a
    stall in one round of the fastest candidate does not rank it last."""
    monkeypatch.setenv(AT.ENV_GATE, "1")
    calls = {}

    def bench(c):
        calls[c] = calls.get(c, 0) + 1
        if c == (64,):
            time.sleep(0.002)
        elif calls[c] == 3:        # (16,)'s first timed call: one stall
            time.sleep(0.5)

    got = AT.measured_blocks("accum_apply", SHAPE, torch.float32, CPU, [(64,), (16,)],
                             bench, (64,), concrete=True)
    assert got == (16,) and AT.ROUNDS > 1


@pytest.mark.parametrize("gate,concrete,cands", [("0", True, [(16,), (256,)]),
                                                 ("1", False, [(16,), (256,)]),
                                                 ("1", True, [])])
def test_no_measurement_returns_the_fallback(tmp_path, monkeypatch, gate, concrete, cands):
    monkeypatch.setenv(AT.ENV_GATE, gate)
    calls = []
    assert AT.measured_blocks("accum_apply", SHAPE, torch.float32, CPU, cands,
                              _bench(calls), (64,), concrete=concrete) == (64,)
    assert calls == [] and not (tmp_path / "autotune.json").exists()


def test_single_candidate_is_not_timed(monkeypatch):
    monkeypatch.setenv(AT.ENV_GATE, "1")
    calls = []
    assert AT.measured_blocks("landmark_attention", (32, 4, 128, 1024, 128),
                              torch.float32, CPU, [(8,)], _bench(calls), (8,),
                              concrete=True) == (8,)
    assert calls == []


@pytest.mark.parametrize("kind,key,stale", [
    ("accum_apply", SHAPE, 8),
    ("landmark_attention", (32, 32768, 128, 1024, 128), 8)])
def test_stale_hit_outside_the_candidates_is_a_miss(tmp_path, monkeypatch, kind, key,
                                                    stale):
    """An entry that is not among the caller's candidates (written when the
    kernel took other geometries) is never returned: with the gate off the
    call takes the fallback; with it on, it measures the candidates and
    records the winner in the entry's place."""
    path = tmp_path / "at.json"
    path.write_text(json.dumps({AT._key(kind, key, torch.float32, CPU): [stale]}))
    monkeypatch.setenv(AT.ENV_CACHE, str(path))
    monkeypatch.setenv(AT.ENV_GATE, "0")
    calls = []
    cands = [(64,), (128,)]
    assert AT.measured_blocks(kind, key, torch.float32, CPU, cands, _bench(calls), (64,),
                              concrete=True) == (64,)
    assert calls == []
    monkeypatch.setenv(AT.ENV_GATE, "1")
    got = AT.measured_blocks(kind, key, torch.float32, CPU, cands,
                             _bench(calls, slow={(64,)}), (64,), concrete=True)
    assert got == (128,) and set(calls) == set(cands)
    assert json.loads(path.read_text()) == {AT._key(kind, key, torch.float32, CPU): [128]}


def test_corrupt_file_falls_back_with_health_record(tmp_path, monkeypatch):
    path = tmp_path / "at.json"
    path.write_text("{not json at all")
    monkeypatch.setenv(AT.ENV_CACHE, str(path))
    monkeypatch.setenv(AT.ENV_GATE, "0")
    before = DT.global_health().count("autotune.load")
    assert AT.measured_blocks("accum_apply", SHAPE, torch.float32, CPU, [(16,)],
                              _bench([]), (64,), concrete=True) == (64,)
    events = [e for e in DT.global_health().events if e.site == "autotune.load"]
    assert len(events) == before + 1
    assert (events[-1].rung_from, events[-1].rung_to) == ("measured-cache", "static-table")
    assert "autotune.load: measured-cache->static-table" in DT.global_health().summary()


@pytest.mark.parametrize("action,lost", [("error", False), ("kill", True),
                                         ("device_loss", True)])
def test_fault_plan_degrades_or_propagates(tmp_path, monkeypatch, action, lost):
    """An injected error at ``autotune.load`` degrades to the static table,
    recorded; an injected device loss propagates — in both packages."""
    plan = json.dumps({"autotune.load": {"action": action, "at": 1}})
    monkeypatch.setenv(FT.ENV_PLAN, plan)
    monkeypatch.setenv(AT.ENV_CACHE, str(tmp_path / "at.json"))
    (tmp_path / "at.json").write_text(json.dumps({_port_key(): [16]}))
    for faults, health, lookup in (
            (FT, DT, lambda: AT.lookup("accum_apply", SHAPE, torch.float32, CPU)),
            (FJ, DJ, lambda: AJ.lookup("accum_apply", SHAPE, jnp.float32, True))):
        faults.reset()
        before = health.global_health().count("autotune.load")
        try:
            if lost:
                with pytest.raises(faults.DeviceLost):
                    lookup()
                assert health.global_health().count("autotune.load") == before
            else:
                assert lookup() is None
                assert health.global_health().count("autotune.load") == before + 1
        finally:
            faults.reset()


def test_unwritable_directory_is_harmless(tmp_path, monkeypatch):
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    monkeypatch.setenv(AT.ENV_CACHE, str(blocker / "sub" / "at.json"))
    monkeypatch.setenv(AT.ENV_GATE, "1")
    got = AT.measured_blocks("accum_apply", SHAPE, torch.float32, CPU, [(64,), (16,)],
                             _bench([], slow={(64,)}), (64,), concrete=True)
    assert got == (16,)
    # the decision is kept for this process, though nothing was written
    assert AT.lookup("accum_apply", SHAPE, torch.float32, CPU) == (16,)
    assert not (blocker / "sub").exists()


def test_measuring_counts_launches_apart(monkeypatch):
    monkeypatch.setenv(AT.ENV_GATE, "1")

    def fake_kernel():
        AT.count_launch(fake_kernel)

    fake_kernel.launches = 0
    before = AT.MEASURE_LAUNCHES["fake_kernel"]
    AT.measured_blocks("accum_apply", SHAPE, torch.float32, CPU, [(64,), (16,)],
                       lambda c: fake_kernel(), (64,), concrete=True)
    assert fake_kernel.launches == 0
    assert AT.MEASURE_LAUNCHES["fake_kernel"] > before
    fake_kernel()
    assert fake_kernel.launches == 1 and not AT._measuring


def test_exception_in_a_timed_launch_propagates(tmp_path, monkeypatch):
    monkeypatch.setenv(AT.ENV_GATE, "1")

    def bench(c):
        if c == (16,):
            raise RuntimeError("launch failed")

    with pytest.raises(RuntimeError, match="launch failed"):
        AT.measured_blocks("accum_apply", SHAPE, torch.float32, CPU, [(64,), (16,)],
                           bench, (64,), concrete=True)
    assert not AT._measuring
    assert AT.lookup("accum_apply", SHAPE, torch.float32, CPU) is None


def test_gate_off_and_empty_cache_give_the_static_geometry(monkeypatch):
    """REPRO_AUTOTUNE=0 with no cache file: every kind resolves to
    STATIC_TABLE, which holds the fixed geometry the gathers launched with
    before the cache (64 rows a block) and the tensor-core attention
    sweep's 128 rows a block (8 query rows where S ≤ 8)."""
    monkeypatch.setenv(AT.ENV_GATE, "0")
    assert set(AT.STATIC_TABLE) == {"matfree_cols", "accum_apply", "sketch_both",
                                    "accum_grow", "landmark_attention", "landmark_stats"}
    for kind, static in AT.STATIC_TABLE.items():
        assert static == ((128,) if kind.startswith("landmark") else (64,))
        assert AT.measured_blocks(kind, (1, 2, 3), torch.float32, CPU, [(16,), (128,)],
                                  _bench([]), static, concrete=True) == static
    assert OT.autotune_blocks(*SHAPE, torch.float32, CPU) == (64,)
    assert OT.autotune_both_blocks(4096, CPU, 64, 4) == (64,)
    for kind in ("matfree_cols", "accum_apply", "sketch_both", "accum_grow"):
        assert KT._rows(None, kind) == 64
    assert LK.static_bq(4) == 8 and LK.static_bq(9) == 128
    assert LK.static_bq(1024, "landmark_stats") == 128
    # the key tile of each sweep: 32 keys on the decode sweep (S ≤ 8), 64 on
    # the tensor-core sweep, 32 there for a float32 head dim above 192
    f32, bf16 = torch.float32, torch.bfloat16
    assert LK.key_tile(4, 128, f32) == 32 and LK.key_tile(9, 128, f32) == 64
    assert LK.key_tile(9, 192, f32) == 64 and LK.key_tile(9, 193, f32) == 32
    assert LK.key_tile(9, 256, bf16) == 64
    assert LK.block_rows(8) == (8,) and LK.block_rows(9) == (64, 128)
    # the key splits of the decode, F-stage and landmark_stats shapes:
    # flash-decoding over 512 blocks in 32-key tiles; one split of 16
    # 64-key tiles; three splits of 171, 171 and 170 64-key tiles
    assert LK.plan(32, 4, 1024, 128, 128, f32) == (16, 2)
    assert LK.plan(32, 32768, 1024, 128, 128, f32) == (1, 16)
    assert LK.plan(32, 1024, 32768, 128, 128, f32, min_split=2) == (3, 171)


def test_cpu_route_never_measures(tmp_path, monkeypatch):
    """With the gate forced on, every wrapper on CPU tensors takes its plain
    version and neither times, records nor counts anything."""
    path = tmp_path / "at.json"
    monkeypatch.setenv(AT.ENV_CACHE, str(path))
    monkeypatch.setenv(AT.ENV_GATE, "1")

    def no_timing(*a):
        raise AssertionError("the CPU route timed a candidate")

    monkeypatch.setattr(AT, "_time", no_timing)
    g = torch.Generator().manual_seed(0)
    n, d, m = 96, 8, 3
    X = torch.rand((n, 3), generator=g)
    K = X @ X.T
    sk = make_accum_sketch(g, n, d, m, device="cpu")
    C = torch.randn((n, d), generator=g)
    measured = sum(AT.MEASURE_LAUNCHES.values())
    OT.matfree_cols_kernel(X, X.index_select(0, sk.indices.reshape(-1)), sk.coef,
                           kernel="gaussian")
    OT.sketch_both_kernel(K, sk)
    OT.sketch_right_kernel(K, sk)
    OT.sketch_step_kernel(K, sk.indices[0], sk.coef[0], C, 0.5)
    OT.accum_grow_kernel(K, sk.indices, sk.coef, C, 0.5, out=C.clone())
    OT.accum_apply_scalar(K, sk.indices, sk.coef, bm=32, bd=8)
    q = torch.randn((2, 20, 16), generator=g)
    LO.landmark_attend(q, q[:, :12], q[:, :12])
    LO.landmark_stats_fused(q[:, :12], q[:, :12], q, q)
    assert not path.exists() and AT._MEM.get(str(path)) is None
    assert sum(AT.MEASURE_LAUNCHES.values()) == measured
    assert all(f.launches == 0 for f in KT.KERNELS + LK.KERNELS)
