"""The port's hierarchical two-level halo exchange against the
reference: ``make_node_spec`` and its error texts, the node-level
exchange on an in-process mesh against each shard's window of the
zero-padded global frame (dense, AER and mixed rings, packed or not),
hierarchical runs bitwise against the flat ones (both wire formats,
``auto`` and pipelined; the reference's 8x8x32 gauss_exp geometry at
radius 6, ``tests/test_hier_exchange.py``), and against JAX's own
hierarchical ``(2, 1, 1, 2)`` mesh on four forced host devices (one
subprocess)."""
import dataclasses

import numpy as np
import pytest
import torch
from _subproc import run_multidevice

from repro.core import partition as jpart
from repro_torch import convert
from repro_torch.configs.base import DPSNNConfig, ExchangeConfig
from repro_torch.configs.dpsnn import with_family
from repro_torch.core import exchange as ex
from repro_torch.core import partition as part
from repro_torch.runtime.transport import LocalMesh

STEPS = 40


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("ry,rx", [(1, 1), (1, 4), (2, 2), (2, 3), (4, 4),
                                   (3, 6), (8, 3), (24, 24)])
@pytest.mark.parametrize("g", [0, 1, 2, 3, 4, 6, 8, 12])
def test_make_node_spec_equals_reference(ry, rx, g):
    """The same NodeSpec, or the same ValueError text."""
    try:
        want = tuple(jpart.make_node_spec(ry, rx, g))
    except ValueError as err:
        with pytest.raises(ValueError) as mine:
            part.make_node_spec(ry, rx, g)
        assert str(mine.value) == str(err)
        return
    node = part.make_node_spec(ry, rx, g)
    assert tuple(node) == want
    assert node.ranks_per_node == g and node.n_nodes * g == ry * rx


def _padded_window(g, spec, r):
    """Each shard's (th+2r, tw+2r) window of the zero-padded global frame:
    what the exchange must deliver."""
    gh, gw, n = g.shape
    pad = torch.zeros((gh + 2 * r, gw + 2 * r, n))
    pad[r:r + gh, r:r + gw] = g
    return torch.stack([
        pad[ty * spec.tile_h:ty * spec.tile_h + spec.tile_h + 2 * r,
            tx * spec.tile_w:tx * spec.tile_w + spec.tile_w + 2 * r]
        for ty, tx in (part.shard_tile_coords(spec, s)
                       for s in range(spec.tiles_y * spec.tiles_x))])


@pytest.mark.parametrize("mesh,grid,g", [((2, 2), (8, 8), 2),
                                         ((2, 2), (8, 8), 4),
                                         ((4, 4), (8, 8), 2),
                                         ((4, 4), (8, 8), 8),
                                         ((3, 2), (6, 4), 2),
                                         ((2, 4), (4, 8), 4)])
@pytest.mark.parametrize("radius", [1, 3])
@pytest.mark.parametrize("wire", ["dense", "packed", "aer", "mixed"])
def test_hier_exchange_is_the_padded_global_window(mesh, grid, g, radius,
                                                   wire):
    """Every shard's window of the extended node frame equals its window
    of the zero-padded global frame, node rings chained past one node
    (radius 3 over nodes 2 tiles wide) included. ``mixed`` sends the
    first ring of each phase as AER and the rest dense; the bound is
    high enough that no list overflows."""
    ry, rx = mesh
    gh, gw = grid
    n = 37
    spec = part.TileSpec(ry, rx, gh // ry, gw // rx, radius)
    node = part.make_node_spec(ry, rx, g)
    frames = (torch.from_numpy(np.random.default_rng(radius + g).random(
        (ry * rx, spec.tile_h, spec.tile_w, n))) < 0.3).to(torch.float32)
    lm = LocalMesh(ry, rx, "cpu", compress=wire == "packed", node=node)
    modes = None
    if wire == "mixed":
        modes = {(p, k): "aer_sparse" if k == 1 else "dense_packed"
                 for p in "hv" for k in range(1, radius + 1)}
    ext, sat = ex.exchange_halo_hier(
        frames, spec, lm, modes=modes,
        mode="aer_sparse" if wire == "aer" else "dense_packed",
        rate_bound_hz=1000.0, capacity_factor=1.0, dt_ms=1.0)
    want = _padded_window(part.tiles_to_global(frames, spec), spec, radius)
    assert torch.equal(ext, want)
    if wire in ("aer", "mixed"):
        assert sat.shape == (ry * rx,) and not bool(sat.any())
    else:
        assert sat is None


def test_hier_overflow_flags_every_lane_of_the_node():
    """A node frame whose list overflows raises the flag of each of its
    lanes, and of no lane of a silent node."""
    spec = part.TileSpec(2, 2, 2, 2, 1)
    node = part.make_node_spec(2, 2, 2)             # nodes of 1x2
    frames = torch.zeros(4, 2, 2, 5)
    frames[:2] = 1.0                                # node 0 fires
    _, sat = ex.exchange_halo_hier(
        frames, spec, LocalMesh(2, 2, "cpu", node=node), mode="aer_sparse",
        rate_bound_hz=1.0, capacity_factor=1.0, dt_ms=1.0)
    assert sat.tolist() == [True, True, False, False]


def _cfg(exchange_mode="dense_packed", policy="inherit", pipelined=False):
    """The reference's hierarchical parity geometry."""
    base = with_family(DPSNNConfig(grid_h=8, grid_w=8, neurons_per_column=32,
                                   seed=3), "gauss_exp")
    conn = dataclasses.replace(base.conn, radius=6,
                               exchange_mode=exchange_mode,
                               aer_rate_bound_hz=100.0)
    return dataclasses.replace(base, conn=conn, exchange=ExchangeConfig(
        pipelined=pipelined, exchange_mode=policy))


CASES = {"dense": _cfg(), "aer": _cfg("aer_sparse"),
         "auto": _cfg(policy="auto"), "pipelined": _cfg(pipelined=True),
         "auto_pipelined": _cfg(policy="auto", pipelined=True)}


@pytest.fixture(scope="module")
def runs():
    """``run(case, g)``: (result, numpy state) on the 2x2 mesh, flat
    (``g`` 0) or in nodes of ``g``, once each."""
    done = {}

    def run(case, g):
        if (case, g) not in done:
            node = part.make_node_spec(2, 2, g) if g else None
            r, _ = ex.make_distributed_run(
                CASES[case], LocalMesh(2, 2, "cpu", node=node),
                n_steps=STEPS, impl="ref", with_state=True)
            res, st = r()
            done[case, g] = (res, convert.dist_state_to_numpy(st))
        return done[case, g]
    return run


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("g", [2, 4])
def test_hier_run_equals_flat(runs, case, g):
    """Spikes, events, the rate trace, the saturation flags and every leaf
    of the final state: the hierarchical run is the flat one to the bit
    (nodes of 1x2, and one node of the whole 2x2 grid); and every wire
    and schedule gives the dense flat run's totals, trace and v (the
    pipelined ring lags a step behind it)."""
    res, st = runs(case, g)
    flat_res, flat_st = runs(case, 0)
    assert st.keys() == flat_st.keys()
    for k, v in st.items():
        np.testing.assert_array_equal(v, flat_st[k], k)
    for want in (flat_res, runs("dense", 0)[0]):
        assert float(res.spikes) == float(want.spikes) > 0
        assert float(res.events) == float(want.events)
        assert torch.equal(res.rate_trace, want.rate_trace)
        assert torch.equal(res.aer_saturated, want.aer_saturated)
    assert int(res.aer_saturated.sum()) == 0
    np.testing.assert_array_equal(st["v"], runs("dense", 0)[1]["v"])


JAX_HIER = """
import dataclasses, numpy as np, jax
from repro.configs.base import DPSNNConfig, ExchangeConfig
from repro.configs.dpsnn import with_family
from repro.core import exchange
base = with_family(DPSNNConfig(grid_h=8, grid_w=8, neurons_per_column=32,
                               seed=3), "gauss_exp")
mesh = jax.make_mesh((2, 1, 1, 2), ("ndata", "data", "nmodel", "model"))
for name, mode, policy in (("aer", "aer_sparse", "inherit"),
                           ("auto", "dense_packed", "auto")):
    conn = dataclasses.replace(base.conn, radius=6, exchange_mode=mode,
                               aer_rate_bound_hz=100.0)
    cfg = dataclasses.replace(base, conn=conn,
                              exchange=ExchangeConfig(exchange_mode=policy))
    run, _ = exchange.make_distributed_run(cfg, mesh, n_steps=%d,
                                           with_state=True)
    res, st = run()
    leaves = dict(v=st.lif.v, c=st.lif.c, refrac=st.lif.refrac,
                  hist_ext=st.hist_ext, pending=st.pending, t=st.t,
                  spike_count=st.spike_count, event_count=st.event_count,
                  aer_sat=st.aer_sat, last_spike_t=st.last_spike_t,
                  isi_sum=st.isi_sum, isi_sumsq=st.isi_sumsq,
                  isi_count=st.isi_count)
    np.savez('{out}/%%s.npz' %% name, res_spikes=np.asarray(res.spikes),
             res_events=np.asarray(res.events),
             res_sat=np.asarray(res.aer_saturated),
             **{{k: np.asarray(x) for k, x in leaves.items()}})
print('OK')
""" % STEPS


@pytest.fixture(scope="module")
def jax_hier(tmp_path_factory):
    """JAX's hierarchical (2, 1, 1, 2) runs, AER and auto, 40 steps."""
    out = tmp_path_factory.mktemp("jax_hier")
    assert "OK" in run_multidevice(JAX_HIER.format(out=out), timeout=300)
    return {name: dict(np.load(out / f"{name}.npz"))
            for name in ("aer", "auto")}


@pytest.mark.parametrize("case", ["aer", "auto"])
def test_hier_run_equals_jax_hier_mesh(runs, jax_hier, case):
    """The port's nodes of 1x2 against JAX's (2, 1, 1, 2) mesh: spikes,
    events and the per-step saturation flags exact; ring, pending frame,
    spike times, ISI sums and counters bitwise; v and c within the parity
    bar of tests/test_simulator.py (atol 2e-4)."""
    res, st = runs(case, 2)
    want = jax_hier[case]
    assert float(res.spikes) == float(want["res_spikes"])
    assert float(res.events) == float(want["res_events"])
    np.testing.assert_array_equal(res.aer_saturated.numpy(), want["res_sat"])
    for leaf in ("hist_ext", "pending", "t", "spike_count", "event_count",
                 "last_spike_t", "isi_sum", "isi_sumsq", "isi_count",
                 "refrac", "aer_sat"):
        np.testing.assert_array_equal(st[leaf], want[leaf], leaf)
    np.testing.assert_allclose(st["v"], want["v"], rtol=0, atol=2e-4)
    np.testing.assert_allclose(st["c"], want["c"], rtol=0, atol=2e-4)
