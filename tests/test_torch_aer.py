"""The port's AER wire and per-ring ``auto`` selection against the
reference: the capacity, the event-list codec (``aer_encode`` /
``aer_decode`` / ``aer_gather_values`` / ``aer_scatter_values``) as int
arrays against ``repro.core.exchange``'s, the stacked encode against one
encode per shard, every function of the byte accounting against
``repro.runtime.compression``'s, AER and ``auto`` runs on an in-process
mesh bitwise against the dense one and the port's single shard, and
saturating runs, flat and pipelined, against JAX's
``make_distributed_run`` on a forced 2x2 mesh (one subprocess): spikes
and per-step ``aer_saturated`` to the bit."""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _subproc import run_multidevice

from repro.configs import dpsnn as jdpsnn
from repro.core import exchange as jex
from repro.core import partition as jpart
from repro.runtime import compression as jcomp
from repro_torch import convert
from repro_torch.configs import dpsnn
from repro_torch.configs.base import (ConnectivityConfig, DPSNNConfig,
                                      ExchangeConfig)
from repro_torch.core import exchange as ex
from repro_torch.core import partition as part
from repro_torch.core import simulation as sim
from repro_torch.runtime import compression as comp
from repro_torch.runtime.transport import LocalMesh

STEPS = 40


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("units", [1, 7, 64, 1000, 1240, 29760])
@pytest.mark.parametrize("rate", [0.1, 1.0, 7.5, 12.0, 500.0])
@pytest.mark.parametrize("factor", [1.0, 2.0, 4.0])
def test_aer_capacity_equals_reference(units, rate, factor):
    for dt in (0.1, 1.0):
        assert ex.aer_capacity(units, rate, factor, dt) == \
            jex.aer_capacity(units, rate, factor, dt)


def _frames(seed, shape, p):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < p).astype(np.float32)


@pytest.mark.parametrize("p", [0.0, 0.05, 0.3, 1.0])
@pytest.mark.parametrize("cap", [1, 5, 40, 200])
def test_codec_equals_reference(p, cap):
    """Event lists equal JAX's as int arrays (sentinel fill, truncation
    at overflow), as do the overflow flag, the decoded frame and the
    side payload gathered at and scattered from the addresses."""
    x = _frames(int(p * 100) + cap, (4, 5, 6), p)
    vals = np.random.default_rng(cap).random(x.shape).astype(np.float32)
    events, over = ex.aer_encode(torch.from_numpy(x), cap)
    jevents, jover = jex.aer_encode(jnp.asarray(x), cap)
    assert events.dtype == torch.int32 and events.shape == (1 + cap,)
    np.testing.assert_array_equal(events.numpy(), np.asarray(jevents))
    assert bool(over) == bool(jover) == (x.sum() > cap)
    np.testing.assert_array_equal(
        ex.aer_decode(events, x.shape).numpy(),
        np.asarray(jex.aer_decode(jevents, x.shape)))
    got = ex.aer_gather_values(torch.from_numpy(vals), events)
    want = jex.aer_gather_values(jnp.asarray(vals), jevents)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ex.aer_scatter_values(events, got, x.shape).numpy(),
        np.asarray(jex.aer_scatter_values(jevents, want, x.shape)))


def test_zero_filled_list_decodes_to_silence():
    """What the open sheet edge delivers: count 0, addresses 0."""
    silent = torch.zeros(9, dtype=torch.int32)
    assert not ex.aer_decode(silent, (2, 2, 3)).any()
    assert not ex.aer_scatter_values(silent, torch.ones(8), (2, 2, 3)).any()
    np.testing.assert_array_equal(
        ex.aer_decode(silent, (2, 2, 3)).numpy(),
        np.asarray(jex.aer_decode(jnp.zeros(9, jnp.int32), (2, 2, 3))))


@pytest.mark.parametrize("cap", [1, 9, 300])
def test_stacked_codec_equals_one_list_per_shard(cap):
    x = torch.from_numpy(_frames(cap, (6, 3, 4, 10), 0.08))
    x[2] = 1.0                                   # one shard overflows
    vals = torch.rand(x.shape, generator=torch.Generator().manual_seed(1))
    events, over = ex.aer_encode_stack(x, cap)
    assert events.shape == (6, 1 + cap) and over.shape == (6,)
    back = ex.aer_decode_stack(events, x.shape[1:])
    side = ex.aer_gather_values(vals, events)
    for s in range(6):
        e, o = ex.aer_encode(x[s], cap)
        assert torch.equal(events[s], e) and bool(over[s]) == bool(o)
        assert torch.equal(back[s], ex.aer_decode(e, x.shape[1:]))
        assert torch.equal(side[s], ex.aer_gather_values(vals[s], e))
    assert torch.equal(ex.aer_scatter_values(events, side, x.shape[1:]),
                       torch.where(back > 0, vals, 0.0))


GEOMETRIES = [(8, 8, 2, 2), (24, 24, 12, 12), (24, 24, 24, 24), (6, 6, 3, 3),
              (24, 24, 1, 1), (24, 24, 2, 2), (24, 24, 4, 4), (24, 24, 8, 3),
              (12, 6, 6, 6), (6, 12, 1, 12)]


@pytest.mark.parametrize("gh,gw,ry,rx", GEOMETRIES)
@pytest.mark.parametrize("compress", [True, False])
def test_byte_accounting_equals_reference(gh, gw, ry, rx, compress):
    """Every function of the accounting returns the reference's value
    exactly, for the three modes at three rate bounds, static and
    plastic (the STDP trace strips counted), and for every node grouping
    of the process grid that ``make_node_spec`` accepts."""
    mine = dpsnn.reduced_family("exp", gh, gw, 1240, radius=3)
    theirs = jdpsnn.reduced_family("exp", gh, gw, 1240, radius=3)
    spec = part.make_tile_spec(mine, ry, rx)
    jspec = jpart.make_tile_spec(theirs, ry, rx)
    assert comp.aer_crossover_rate_hz(mine, spec) == \
        jcomp.aer_crossover_rate_hz(theirs, jspec)
    for stdp in (False, True):
        assert comp.aer_crossover_rate_hz(mine, spec, stdp=stdp) == \
            jcomp.aer_crossover_rate_hz(theirs, jspec, stdp=stdp)
        assert comp.aer_crossover_rate_hz(
            dataclasses.replace(mine, stdp=stdp), spec) == \
            jcomp.aer_crossover_rate_hz(
                dataclasses.replace(theirs, stdp=stdp), jspec)
    nodes = [(part.make_node_spec(ry, rx, g), jpart.make_node_spec(ry, rx, g))
             for g in range(1, ry * rx + 1) if (ry * rx) % g == 0
             and (g <= rx and rx % g == 0 or g % rx == 0 and ry % (g // rx)
                  == 0)]
    assert nodes
    for mode, stdp in itertools.product(
            ("dense_packed", "aer_sparse", "auto"), (False, True)):
        for rate in (None, 1.0, 500.0):
            kw = dict(mode=mode, rate_bound_hz=rate, compress=compress,
                      stdp=stdp)
            assert comp.halo_payload_bytes(mine, spec, **kw) == \
                jcomp.halo_payload_bytes(theirs, jspec, **kw)
            assert comp.ring_mode_table(mine, spec, rate_bound_hz=rate,
                                        compress=compress) == \
                jcomp.ring_mode_table(theirs, jspec, rate_bound_hz=rate,
                                      compress=compress)
            for node, jnode in nodes:
                assert comp.ring_send_entries(spec, node) == \
                    jcomp.ring_send_entries(jspec, jnode)
                assert comp.hier_payload_bytes(mine, spec, node, **kw) == \
                    jcomp.hier_payload_bytes(theirs, jspec, jnode, **kw)
                for hier in (False, True):
                    assert comp.internode_totals(
                        mine, spec, node, hierarchical=hier, **kw) == \
                        jcomp.internode_totals(theirs, jspec, jnode,
                                               hierarchical=hier, **kw)


# the reference's two static AER geometries (tests/test_aer_exchange.py)
def _reference_geometry(name):
    grid, neurons, radius, profile, seed = {
        "exp_r2": (8, 32, 2, "exponential", 3),
        "gauss_exp_r3": (4, 40, 3, "gauss_exp", 0)}[name]
    conn = ConnectivityConfig(lateral_profile=profile, amp_exp=0.03,
                              lambda_steps=2.0, radius=radius,
                              aer_rate_bound_hz=200.0,
                              aer_capacity_factor=2.0)
    return DPSNNConfig(grid_h=grid, grid_w=grid, neurons_per_column=neurons,
                       seed=seed, conn=conn)


# the rate bound of the auto runs: the gauss_exp_r3 tables mix dense and
# AER rings there (test_auto_table_mixes_formats), and no list overflows
AUTO_HZ = 20.0


def _wire(cfg, mode):
    """``cfg`` under ``mode``: a uniform wire format, or ``auto`` at
    ``AUTO_HZ``."""
    if mode == "auto":
        return dataclasses.replace(
            cfg, conn=dataclasses.replace(cfg.conn,
                                          aer_rate_bound_hz=AUTO_HZ),
            exchange=ExchangeConfig(exchange_mode="auto"))
    return dataclasses.replace(cfg, conn=dataclasses.replace(
        cfg.conn, exchange_mode=mode))


@pytest.fixture(scope="module")
def runs():
    """``run(geometry, shape, mode)``: (result, numpy state), once each;
    ``single(geometry)``: the port's single-shard run."""
    done = {}

    def run(geometry, shape, mode):
        if (geometry, shape, mode) not in done:
            cfg = _wire(_reference_geometry(geometry), mode)
            r, spec = ex.make_distributed_run(cfg, LocalMesh(*shape, "cpu"),
                                              n_steps=STEPS, impl="ref",
                                              with_state=True)
            res, st = r()
            done[geometry, shape, mode] = (res, st, spec)
        return done[geometry, shape, mode]

    def single(geometry):
        if geometry not in done:
            cfg = _reference_geometry(geometry)
            params, state = sim.build(cfg, device="cpu")
            done[geometry] = sim.run(cfg, params, state, STEPS, impl="ref")
        return done[geometry]
    return run, single


@pytest.mark.parametrize("geometry", ["exp_r2", "gauss_exp_r3"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("mode", ["aer_sparse", "auto"])
def test_wire_equals_dense_and_single_shard(runs, geometry, shape, mode):
    """Spikes, events, the rate trace and every leaf of the final state
    equal the dense run's to the bit, with no saturated step; the dense
    run's spikes, rate trace and v equal the single shard's."""
    run, single = runs
    res, st, spec = run(geometry, shape, mode)
    dres, dst, _ = run(geometry, shape, "dense_packed")
    one = single(geometry)
    assert res.aer_saturated.shape == (STEPS,)
    assert int(res.aer_saturated.sum()) == 0
    assert float(res.spikes) == float(dres.spikes) == float(one.spikes) > 0
    assert float(res.events) == float(dres.events) == float(one.events)
    assert torch.equal(res.rate_trace, one.rate_trace)
    assert torch.equal(dres.rate_trace, one.rate_trace)
    want = convert.dist_state_to_numpy(dst)
    for k, v in convert.dist_state_to_numpy(st).items():
        np.testing.assert_array_equal(v, want[k], k)
    assert torch.equal(part.columns_to_global(st.lif.v, spec),
                       one.state.lif.v)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_auto_table_mixes_formats(shape):
    """At ``AUTO_HZ`` the gauss_exp_r3 auto table sends some rings dense
    and some as AER on every mesh above, so those auto runs mix the two
    formats in one step; it is the reference's table."""
    cfg = _wire(_reference_geometry("gauss_exp_r3"), "auto")
    spec = part.make_tile_spec(cfg, *shape)
    modes = ex.resolve_ring_modes(cfg, spec)
    assert set(modes.values()) == {"dense_packed", "aer_sparse"}
    jcfg = jdpsnn.reduced_family("gauss_exp", 4, 4, 40, radius=3)
    jcfg = dataclasses.replace(jcfg, conn=dataclasses.replace(
        jcfg.conn, aer_rate_bound_hz=AUTO_HZ))
    jspec = jpart.make_tile_spec(jcfg, *shape)
    assert jspec.radius == spec.radius == 3
    assert modes == {(e["phase"], e["ring"]): e["mode"]
                     for e in jcomp.ring_mode_table(jcfg, jspec)}


SATURATING = """
import jax, numpy as np
from repro.configs.base import DPSNNConfig, ConnectivityConfig, ExchangeConfig
from repro.core import exchange
conn = ConnectivityConfig(exchange_mode='aer_sparse',
                          aer_rate_bound_hz=0.1, aer_capacity_factor=1.0)
mesh = jax.make_mesh((2, 2), ('data', 'model'))
for name, pipelined in (('sat', False), ('sat_pipelined', True)):
    cfg = DPSNNConfig(grid_h=4, grid_w=4, neurons_per_column=32, seed=0,
                      conn=conn, exchange=ExchangeConfig(pipelined=pipelined))
    run, _ = exchange.make_distributed_run(cfg, mesh, n_steps=%d,
                                           with_state=True)
    res, st = run()
    extra = {{}} if st.ext_pending is None else dict(
        ext_pending=np.asarray(st.ext_pending))
    np.savez('{out}/%%s.npz' %% name, spikes=np.asarray(res.spikes),
             events=np.asarray(res.events),
             aer_saturated=np.asarray(res.aer_saturated),
             hist_ext=np.asarray(st.hist_ext),
             pending=np.asarray(st.pending), aer_sat=np.asarray(st.aer_sat),
             v=np.asarray(st.lif.v), **extra)
print('OK')
""" % STEPS


@pytest.fixture(scope="module")
def jax_saturating(tmp_path_factory):
    """JAX's saturating 2x2 runs, flat and pipelined, from one forced
    4-device subprocess."""
    out = tmp_path_factory.mktemp("jax_sat")
    assert "OK" in run_multidevice(SATURATING.format(out=out), timeout=300)
    return {name: dict(np.load(out / f"{name}.npz"))
            for name in ("sat", "sat_pipelined")}


def _assert_saturating_run_equals_jax(want, pipelined):
    conn = ConnectivityConfig(exchange_mode="aer_sparse",
                              aer_rate_bound_hz=0.1, aer_capacity_factor=1.0)
    cfg = DPSNNConfig(grid_h=4, grid_w=4, neurons_per_column=32, seed=0,
                      conn=conn, exchange=ExchangeConfig(pipelined=pipelined))
    run, _ = ex.make_distributed_run(cfg, LocalMesh(2, 2, "cpu"),
                                     n_steps=STEPS, impl="ref",
                                     with_state=True)
    res, st = run()
    sat = res.aer_saturated.numpy()
    assert sat.dtype == np.int32 and STEPS // 2 < sat.sum() <= STEPS
    np.testing.assert_array_equal(sat, want["aer_saturated"])
    assert float(res.spikes) == float(want["spikes"])
    assert float(res.events) == float(want["events"])
    leaves = ("hist_ext", "pending", "aer_sat") + (
        ("ext_pending",) if pipelined else ())
    assert ("ext_pending" in want) == pipelined
    for leaf in leaves:
        np.testing.assert_array_equal(getattr(st, leaf).numpy(), want[leaf],
                                      leaf)
    np.testing.assert_allclose(st.lif.v.numpy(), want["v"], rtol=0,
                               atol=2e-4)


def test_saturating_run_equals_jax(jax_saturating):
    """4x4x32 at a 0.1 Hz bound and factor 1 on a 2x2 mesh: the lists
    overflow on most steps; spikes, events, the per-step flags, the last
    step's per-shard flags, the ring and the pending frame equal JAX's
    to the bit (the same events are truncated), v within the parity bar
    (atol 2e-4)."""
    _assert_saturating_run_equals_jax(jax_saturating["sat"], False)


def test_saturating_pipelined_run_equals_jax(jax_saturating):
    """The same saturating run under the pipelined schedule: the
    truncated frames are carried a step in ``ext_pending`` before they
    reach the ring, and flags, spikes, events, the ring, the pending and
    in-flight frames equal JAX's to the bit, v within the bar."""
    _assert_saturating_run_equals_jax(jax_saturating["sat_pipelined"], True)
