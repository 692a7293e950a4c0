"""The traffic generators repeat for a seed, and every seed gets the
same work in another order."""
from __future__ import annotations

import itertools
from collections import Counter

import pytest

from _tiny import ROOT, common

SERVE = common.driver("serve_closed")
MIX = common.load_json(common.traffic_file("sweep-closed16"))


def first(seed, k):
    return list(itertools.islice(SERVE.jobs(MIX, seed), k))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 33 - 1])
def test_jobs_repeat_for_a_seed(seed):
    assert first(seed, 600) == first(seed, 600)


def test_every_seed_draws_the_same_pool_in_another_order():
    p = MIX["pool"]
    a = [(s, nu) for _, s, nu, _ in first(3, p)]
    b = [(s, nu) for _, s, nu, _ in first(2 ** 31 + 11, p)]
    assert Counter(a) == Counter(b) and a != b
    # the second pass is the pool again
    c = [(s, nu) for _, s, nu, _ in first(3, 2 * p)[p:]]
    assert Counter(c) == Counter(a)


def test_pool_lengths_and_scales():
    steps = sorted(s for _, s, _, _ in first(5, MIX["pool"]))
    assert steps[0] >= MIX["steps_min"] and steps[-1] <= MIX["steps_max"]
    # log-uniform: the median near the geometric mean of the bounds
    mid = steps[len(steps) // 2]
    assert abs(mid - (MIX["steps_min"] * MIX["steps_max"]) ** 0.5) < 10
    scales = Counter(nu for _, _, nu, _ in first(5, MIX["pool"]))
    assert set(scales) == set(MIX["nu_scales"])
    assert len(set(scales.values())) == 1


def test_job_seeds_fit_int32_and_differ():
    seeds = [s for _, _, _, s in first(2 ** 31 + 1, 2000)]
    assert all(0 <= s < 2 ** 31 for s in seeds)
    assert len(set(seeds)) == len(seeds)


def test_every_drive_rate_stays_in_the_poisson_branch():
    from bench.reference.dpsnn import drive_rate
    cfg = common.load_json(ROOT / "bench" / "configs" / "dpsnn-24x24.json")
    rates = [drive_rate(cfg, nu) for nu in MIX["nu_scales"]]
    assert max(rates) <= 2.43 + 1e-6 and min(rates) > 0


@pytest.mark.parametrize("name", ["sim-static", "sim-plastic"])
def test_segment_mixes(name):
    m = common.load_json(common.traffic_file(name))
    assert m["driver"] == "segments"
    assert m["segment_steps"] == 1000 and m["warmup_steps"] == 100
    assert m["stdp"] == (name == "sim-plastic")


def test_sample_takes_the_longest_and_repeats():
    outputs = {"results": {f"job{i}": {"status": "ok"} for i in range(20)},
               "meta": {f"job{i}": (10 + i % 7, 1.0, i) for i in range(20)}}
    a = SERVE.sample(outputs, 5, 4)
    assert a == SERVE.sample(outputs, 5, 4)
    assert a[0] == "job6" and len(set(a)) == 4
