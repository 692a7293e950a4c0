"""The port's multi-rank STDP on an in-process mesh: the plastic step
(live weights and traces as ``PlasticState``, the pre-trace halo on
every wire, one STDP update over the stacked shards) bitwise against
the port's own single-shard plastic ``simulation.run`` on 2x2, 1x4 and
4x1 meshes under the three impls on the packed dense wire (on the CPU
``cuda`` and ``cuda_fused`` take their kernels' plain versions), and on
2x2 on every wire: float32 strips, AER, ``auto``, hierarchical and
pipelined; a resume that continues exactly; and JAX's plastic
``make_distributed_run`` on a forced 2x2 mesh (dense and AER, on the
reference's two AER geometries), on its hierarchical ``(2, 1, 1, 2)``
mesh, and on a saturating AER run (one subprocess for all of them):
weights, traces and ``trace_ext`` to the bit. Those runs take the
reference's own network (its float32 truncated-normal draws may differ
from the port's in the last bits, ``test_torch_prng.py``), cut into the
mesh's shards.

The geometry and rule are the reference's (tests/test_stdp_distributed.py):
8x8 columns of 32 neurons, seed 3, ``a_plus=0.05``, ``a_minus=0.055``,
60 steps, strong enough that plasticity changes the spike count."""
import dataclasses

import numpy as np
import pytest
import torch
from _subproc import run_multidevice

from repro_torch import convert
from repro_torch.configs.base import (ConnectivityConfig, DPSNNConfig,
                                      ExchangeConfig, STDPConfig)
from repro_torch.configs.dpsnn import with_family
from repro_torch.core import exchange as ex
from repro_torch.core import partition as part
from repro_torch.core import simulation as sim
from repro_torch.core.network import IMPLS, NetworkParams
from repro_torch.runtime.transport import LocalMesh


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


STEPS = 60
RULE = STDPConfig(a_plus=0.05, a_minus=0.055)
CFG = DPSNNConfig(grid_h=8, grid_w=8, neurons_per_column=32, seed=3,
                  stdp=True, stdp_cfg=RULE)
# every (strip's) list holds all the spikes of these runs at this bound
AER_HZ = 50.0


def _conn(cfg, **kw):
    return dataclasses.replace(cfg, conn=dataclasses.replace(cfg.conn, **kw))


def _wire(name):
    """CFG under a wire of the 2x2 cross: ``(cfg, node group size,
    compress)``. ``auto`` keeps ``conn.exchange_mode == "aer_sparse"``, so
    its ``trace_ext`` is refreshed from the dense trace halo; on 4x4 tiles
    of 32 neurons at 20 Hz its table sends every ring dense."""
    aer = _conn(CFG, exchange_mode="aer_sparse", aer_rate_bound_hz=AER_HZ)
    auto = dataclasses.replace(
        _conn(CFG, exchange_mode="aer_sparse", aer_rate_bound_hz=20.0),
        exchange=ExchangeConfig(exchange_mode="auto"))
    pipelined = ExchangeConfig(pipelined=True)
    return {
        "dense": (CFG, 0, False),
        "aer": (aer, 0, False),
        "auto": (auto, 0, False),
        "hier_nodes_of_2": (CFG, 2, True),
        "hier_nodes_of_4_aer": (aer, 4, False),
        "pipelined": (dataclasses.replace(CFG, exchange=pipelined), 0, True),
        "pipelined_auto": (dataclasses.replace(auto, exchange=ExchangeConfig(
            pipelined=True, exchange_mode="auto")), 0, False),
    }[name]


@pytest.fixture(scope="module")
def single():
    """The port's single-shard plastic run of CFG under ``ref``, the
    oracle of every mesh below: the three impls' plain versions give
    the same bits (test_torch_plasticity.py holds each to JAX's)."""
    params, state = sim.build(CFG, device="cpu")
    return sim.run(CFG, params, state, STEPS, impl="ref")


def _mesh_run(cfg, mesh, impl, steps=STEPS, params=None):
    run, spec = ex.make_distributed_run(cfg, mesh, n_steps=steps, impl=impl,
                                        with_state=True, params=params)
    return (*run(), spec)


def _assert_equals_single(res, st, spec, one):
    """Spikes, events, per-step spikes, v, the live weights and both
    traces to the bit, in global column order."""
    assert float(res.spikes) == float(one.spikes)
    assert float(res.events) == float(one.events)
    assert torch.equal(res.rate_trace, one.rate_trace)
    assert int(res.aer_saturated.sum()) == 0
    for name, got, want in (
            ("v", st.lif.v, one.state.lif.v),
            ("w_local", st.plastic.w_local, one.params.w_local),
            ("rem_w", st.plastic.rem_w, one.params.rem_w),
            ("x_pre", st.plastic.traces.x_pre, one.state.stdp.x_pre),
            ("x_post", st.plastic.traces.x_post, one.state.stdp.x_post)):
        assert torch.equal(part.columns_to_global(got, spec), want), name


def test_plasticity_changes_the_spike_count(single):
    """As the reference asserts: the rule is strong enough that the
    weights feed back into spiking within the run."""
    static = dataclasses.replace(CFG, stdp=False)
    params, state = sim.build(static, device="cpu")
    assert float(sim.run(static, params, state, STEPS,
                         impl="ref").spikes) != float(single.spikes)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("impl", IMPLS)
def test_packed_mesh_equals_single_shard(single, shape, impl):
    """The packed dense wire: spikes cross as 32-bit words, the traces
    raw beside them (a packed trace would round to 0/1)."""
    res, st, spec = _mesh_run(CFG, LocalMesh(*shape, "cpu", compress=True),
                              impl)
    assert st.plastic.trace_ext is None
    _assert_equals_single(res, st, spec, single)


WIRES = ["dense", "aer", "auto", "hier_nodes_of_2", "hier_nodes_of_4_aer",
         "pipelined", "pipelined_auto"]


@pytest.fixture(scope="module")
def wire_runs():
    """``run(wire, impl)`` on the 2x2 mesh, once each."""
    done = {}

    def run(wire, impl):
        if (wire, impl) not in done:
            cfg, g, compress = _wire(wire)
            node = part.make_node_spec(2, 2, g) if g else None
            done[wire, impl] = _mesh_run(
                cfg, LocalMesh(2, 2, "cpu", compress=compress, node=node),
                impl)
        return done[wire, impl]
    return run


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("impl", ["ref", "cuda_fused"])
def test_every_wire_equals_single_shard(single, wire_runs, wire, impl):
    """Every wire on 2x2 gives the single shard's bits, with no list
    overflowing; under ``aer_sparse`` the halo-extended trace frame the
    flat AER wire rebuilds from sparse values and decay equals the one
    the hierarchical and ``auto`` wires carry dense."""
    res, st, spec = wire_runs(wire, impl)
    _assert_equals_single(res, st, spec, single)
    cfg = _wire(wire)[0]
    if cfg.conn.exchange_mode == "aer_sparse":
        _, aer, _ = wire_runs("aer", impl)
        assert torch.equal(st.plastic.trace_ext, aer.plastic.trace_ext)
    else:
        assert st.plastic.trace_ext is None


@pytest.mark.parametrize("wire", ["dense", "aer"])
def test_resume_continues_exactly(wire):
    """60 plastic steps straight == 30 steps + a resume of 30 from the
    stacked state (through numpy and back, weights and ``trace_ext``
    included); the resumed-from state is left as it was."""
    cfg = _wire(wire)[0]
    mesh = LocalMesh(2, 2, "cpu")
    ref, ref_st, _ = _mesh_run(cfg, mesh, "ref")
    _, st, _ = _mesh_run(cfg, mesh, "ref", steps=30)
    saved = convert.dist_state_to_numpy(st)
    assert {"w_local", "rem_w", "x_pre", "x_post"} <= saved.keys()
    assert ("trace_ext" in saved) == (wire == "aer")
    st = convert.dist_state_from_numpy(saved, device="cpu")
    resume, _ = ex.make_distributed_run(cfg, mesh, n_steps=30, impl="ref",
                                        with_state=True)
    res, st2 = resume(st)
    for k, v in convert.dist_state_to_numpy(st).items():
        np.testing.assert_array_equal(v, saved[k], k)
    assert float(res.spikes) == float(ref.spikes)
    assert float(res.events) == float(ref.events)
    want = convert.dist_state_to_numpy(ref_st)
    got = convert.dist_state_to_numpy(st2)
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], k)


# ---------------------------------------------------------------------------
# Against JAX's plastic make_distributed_run (one subprocess)
# ---------------------------------------------------------------------------

def _aer_geometry(name, mode):
    """The reference's two plastic AER geometries
    (tests/test_aer_exchange.py::test_aer_mesh_equivalence_bitwise)."""
    grid, neurons, radius, profile = {
        "exp_r2": (8, 32, 2, "exponential"),
        "gauss_exp_r3": (4, 40, 3, "gauss_exp")}[name]
    conn = ConnectivityConfig(lateral_profile=profile, amp_exp=0.03,
                              lambda_steps=2.0, radius=radius,
                              aer_rate_bound_hz=200.0,
                              aer_capacity_factor=2.0, exchange_mode=mode)
    return DPSNNConfig(grid_h=grid, grid_w=grid, neurons_per_column=neurons,
                       seed=3, conn=conn, stdp=True, stdp_cfg=RULE)


def _hier_cfg():
    """The reference's hierarchical parity geometry
    (tests/test_hier_exchange.py), plastic, on the AER wire at 100 Hz."""
    base = with_family(DPSNNConfig(grid_h=8, grid_w=8, neurons_per_column=32,
                                   seed=3, stdp=True, stdp_cfg=RULE),
                       "gauss_exp")
    return _conn(base, radius=6, exchange_mode="aer_sparse",
                 aer_rate_bound_hz=100.0)


SATURATING = DPSNNConfig(
    grid_h=4, grid_w=4, neurons_per_column=32, seed=0, stdp=True,
    stdp_cfg=RULE, conn=ConnectivityConfig(
        exchange_mode="aer_sparse", aer_rate_bound_hz=0.1,
        aer_capacity_factor=1.0))
HIER_STEPS = SAT_STEPS = 40

JAX_RUNS = """
import dataclasses, numpy as np, jax
from repro.configs.base import (ConnectivityConfig, DPSNNConfig,
                                STDPConfig)
from repro.configs.dpsnn import with_family
from repro.core import exchange, simulation as sim

rule = STDPConfig(a_plus=0.05, a_minus=0.055)
flat = jax.make_mesh((2, 2), ('data', 'model'))
hier = jax.make_mesh((2, 1, 1, 2), ('ndata', 'data', 'nmodel', 'model'))
cases = {}
for name, (grid, neurons, radius, profile) in (
        ('exp_r2', (8, 32, 2, 'exponential')),
        ('gauss_exp_r3', (4, 40, 3, 'gauss_exp'))):
    for mode in ('dense_packed', 'aer_sparse'):
        conn = ConnectivityConfig(lateral_profile=profile, amp_exp=0.03,
                                  lambda_steps=2.0, radius=radius,
                                  aer_rate_bound_hz=200.0,
                                  aer_capacity_factor=2.0,
                                  exchange_mode=mode)
        cases[name + '-' + mode] = (DPSNNConfig(
            grid_h=grid, grid_w=grid, neurons_per_column=neurons, seed=3,
            conn=conn, stdp=True, stdp_cfg=rule), flat, STEPS)
base = with_family(DPSNNConfig(grid_h=8, grid_w=8, neurons_per_column=32,
                               seed=3, stdp=True, stdp_cfg=rule), 'gauss_exp')
cases['hier'] = (dataclasses.replace(base, conn=dataclasses.replace(
    base.conn, radius=6, exchange_mode='aer_sparse',
    aer_rate_bound_hz=100.0)), hier, HIER_STEPS)
cases['saturating'] = (DPSNNConfig(
    grid_h=4, grid_w=4, neurons_per_column=32, seed=0, stdp=True,
    stdp_cfg=rule, conn=ConnectivityConfig(
        exchange_mode='aer_sparse', aer_rate_bound_hz=0.1,
        aer_capacity_factor=1.0)), flat, SAT_STEPS)
for name, (cfg, mesh, steps) in cases.items():
    run, _ = exchange.make_distributed_run(cfg, mesh, n_steps=steps,
                                           with_state=True)
    res, st = run()
    pl = st.plastic
    leaves = dict(v=st.lif.v, hist_ext=st.hist_ext, pending=st.pending,
                  aer_sat=st.aer_sat, w_local=pl.w_local, rem_w=pl.rem_w,
                  x_pre=pl.traces.x_pre, x_post=pl.traces.x_post)
    if pl.trace_ext is not None:
        leaves['trace_ext'] = pl.trace_ext
    params, _ = sim.build(cfg)
    leaves.update({'net_' + k: getattr(params, k) for k in params._fields})
    np.savez('OUT/' + name + '.npz', res_spikes=np.asarray(res.spikes),
             res_events=np.asarray(res.events),
             res_sat=np.asarray(res.aer_saturated),
             **{k: np.asarray(x) for k, x in leaves.items()})
print('OK')
""".replace("HIER_STEPS", str(HIER_STEPS)).replace(
    "SAT_STEPS", str(SAT_STEPS)).replace("STEPS", str(STEPS))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's plastic runs: the two AER geometries on the flat 2x2 mesh
    under both wires, the hierarchical (2, 1, 1, 2) mesh and a saturating
    AER run, from one forced 4-device subprocess."""
    out = tmp_path_factory.mktemp("jax_stdp")
    assert "OK" in run_multidevice(JAX_RUNS.replace("OUT", str(out)),
                                   timeout=600)
    return lambda name: dict(np.load(out / f"{name}.npz"))


def _jax_run(cfg, mesh, want, steps, impl="ref"):
    """The port's run of ``cfg`` on the reference's network (``want``'s
    ``net_`` leaves, in global column order), cut into ``mesh``'s
    shards."""
    spec = part.make_tile_spec(cfg, *mesh.shape)
    ids = ex.shard_col_ids(cfg, spec, mesh).long()
    params = NetworkParams(*(torch.from_numpy(want["net_" + k])[ids]
                             for k in NetworkParams._fields))
    return _mesh_run(cfg, mesh, impl, steps, params)


def _assert_matches_jax(res, st, want):
    """Spikes, events and the per-step saturation flags exact; the ring,
    pending frame, flags, live weights, traces and ``trace_ext`` bitwise;
    v within the parity bar of tests/test_simulator.py (atol 2e-4)."""
    assert float(res.spikes) == float(want["res_spikes"])
    assert float(res.events) == float(want["res_events"])
    np.testing.assert_array_equal(res.aer_saturated.numpy(), want["res_sat"])
    got = convert.dist_state_to_numpy(st)
    assert ("trace_ext" in got) == ("trace_ext" in want)
    for leaf in ("hist_ext", "pending", "aer_sat", "w_local", "rem_w",
                 "x_pre", "x_post", "trace_ext"):
        if leaf in want:
            np.testing.assert_array_equal(got[leaf], want[leaf], leaf)
    np.testing.assert_allclose(got["v"], want["v"], rtol=0, atol=2e-4)


@pytest.mark.parametrize("geometry", ["exp_r2", "gauss_exp_r3"])
@pytest.mark.parametrize("mode", ["dense_packed", "aer_sparse"])
@pytest.mark.parametrize("impl", ["ref", "cuda_fused"])
def test_flat_run_equals_jax(jax_runs, geometry, mode, impl):
    want = jax_runs(f"{geometry}-{mode}")
    res, st, _ = _jax_run(_aer_geometry(geometry, mode),
                          LocalMesh(2, 2, "cpu"), want, STEPS, impl)
    assert int(res.aer_saturated.sum()) == 0
    _assert_matches_jax(res, st, want)


def test_hier_run_equals_jax_hier_mesh(jax_runs):
    """Nodes of 1x2 against JAX's (2, 1, 1, 2) mesh on the AER wire: the
    trace halo rides the node frame dense, and ``trace_ext`` is refreshed
    from it."""
    want = jax_runs("hier")
    mesh = LocalMesh(2, 2, "cpu", node=part.make_node_spec(2, 2, 2))
    res, st, _ = _jax_run(_hier_cfg(), mesh, want, HIER_STEPS)
    assert int(res.aer_saturated.sum()) == 0
    _assert_matches_jax(res, st, want)


def test_saturating_run_equals_jax(jax_runs):
    """4x4x32 at a 0.1 Hz bound and factor 1: the lists overflow on most
    steps, truncated spikes take the decayed branch of the trace
    rebuild, and flags, weights, traces and ``trace_ext`` still equal
    JAX's to the bit."""
    want = jax_runs("saturating")
    res, st, _ = _jax_run(SATURATING, LocalMesh(2, 2, "cpu"), want,
                          SAT_STEPS)
    assert int(res.aer_saturated.sum()) > SAT_STEPS // 2
    _assert_matches_jax(res, st, want)
