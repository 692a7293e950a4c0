"""The work counts against hand counts at small shapes."""
from __future__ import annotations

import pytest

from _tiny import common

FUSED = common.counts("fused_step")
DENSE = common.counts("stdp_dense_update")
STEP = common.counts("step")


def test_fused_step_one_tenant_by_hand():
    # C=2 columns of N=3, K=4 slots, a table of 6, 5 spiking rows
    b, f = FUSED.work(columns=2, n=3, k=4, table=6, tenants=1,
                      spiking_rows=5, stdp=False, own_weights=False)
    rows = 5 * 3 * 4
    ell = 2 * 2 * 3 * 4 * 4
    per = 2 * 2 * 3 * 4 + 2 * 6 * 4 + 7 * 2 * 3 * 4
    assert b == rows + ell + per
    assert f == 2 * 5 * 3 + 2 * 2 * 3 * 4 + 14 * 2 * 3


def test_fused_step_tenants_share_the_ell_unless_they_own_weights():
    kw = dict(columns=2, n=3, k=4, table=6, spiking_rows=8, stdp=False)
    one = FUSED.work(tenants=1, own_weights=False, **kw)[0]
    four = FUSED.work(tenants=4, own_weights=False, **kw)[0]
    own = FUSED.work(tenants=4, own_weights=True, **kw)[0]
    ell = 2 * 2 * 3 * 4 * 4
    per = 2 * 2 * 3 * 4 + 2 * 6 * 4 + 7 * 2 * 3 * 4
    assert four - one == 3 * per
    assert own - four == 3 * ell


def test_fused_step_stdp_epilogue_adds_the_traces():
    kw = dict(columns=2, n=3, k=4, table=6, tenants=1, spiking_rows=0,
              own_weights=False)
    assert (FUSED.work(stdp=True, **kw)[0] - FUSED.work(stdp=False, **kw)[0]
            == 4 * 2 * 3 * 4)


def test_stdp_dense_update_by_hand():
    assert DENSE.work(columns=2, n=3) == (2 * 2 * 9 * 4 + 4 * 2 * 3 * 4,
                                          7 * 2 * 9)


def test_step_static_by_hand():
    b, f, i = STEP.work(columns=2, n=3, k_total=4, tenants=1, spikes=5,
                        stdp=False, lam=1.5, ops_per_threefry=80)
    assert b == 5 * (3 * 4 + 4 * 8) + 6 * 28
    assert f == 2 * 5 * (3 + 4) + 14 * 6
    assert i == pytest.approx(6 * 2.5 * 80)


def test_step_plastic_adds_the_rules():
    kw = dict(columns=2, n=3, k_total=4, tenants=2, spikes=5, lam=1.0,
              ops_per_threefry=80)
    b0, f0, _ = STEP.work(stdp=False, **kw)
    b1, f1, _ = STEP.work(stdp=True, **kw)
    neurons = 2 * 3 * 2
    assert b1 - b0 == neurons * 16 + 2 * 5 * 3 * 8 + neurons * 4 * 12
    assert f1 - f0 == 7 * (2 * 5 * 3 + neurons * 4)


def test_grid_24_fused_step_bytes_near_the_recorded_bound():
    """At GRID_24 the kernel's count, with no source spiking, is the ELL
    (1.477 GB with the table and state) that the kernel tables record."""
    from bench.harness import shapes
    cfg = common.load_json(common.ROOT / "bench/configs/dpsnn-24x24.json")
    s = shapes.sizes(cfg)
    b, _ = FUSED.work(columns=s["columns"], n=s["n"], k=s["k"],
                      table=s["table"], tenants=1, spiking_rows=0,
                      stdp=False, own_weights=False)
    assert 1.45e9 < b < 1.55e9
    b, _ = DENSE.work(columns=s["columns"], n=s["n"])
    assert abs(b - 7.097e9) < 0.01e9
