"""The traffic generator: a seed gives the same jobs every time, and each job
a seed of its own."""
from __future__ import annotations

import itertools

from portbench import harness
from portbench.yardstick import traffic


def _first(mix, seed, n):
    return list(itertools.islice(traffic.jobs(mix, {}, seed), n))


def _mix(name):
    return harness.load_json(harness.find("mixes", name))


def test_same_seed_same_jobs():
    for name in ("closed_cluster", "closed_fit_pcg"):
        mix = _mix(name)
        a = _first(mix, 2**33 + 7, 200)
        assert a == _first(mix, 2**33 + 7, 200)
        assert a != _first(mix, 2**33 + 8, 200)


def test_job_seeds_differ_and_fit_in_64_bits():
    jobs = _first(_mix("closed_cluster"), 2**31 + 5, 1000)
    seeds = [j["seed"] for j in jobs]
    assert len(set(seeds)) == len(seeds)
    assert all(0 <= s < 2**64 for s in seeds)
    assert [j["job"] for j in jobs] == list(range(1000))


def test_a_kind_may_bring_its_own_jobs():
    class Kind:
        @staticmethod
        def jobs(mix, cfg, seed):
            yield {"rows": mix["rows"]}

    assert list(harness.jobs_of(Kind, {"rows": 7}, {}, 1)) == [{"rows": 7}]
    assert next(harness.jobs_of(object(), {}, {}, 1)) == {"job": 0,
                                                          "seed": traffic.job_seed(1, 0)}
