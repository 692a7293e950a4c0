"""The port's multi-rank batched service
(``exchange.make_batched_distributed_run``): B tenants in lockstep over a
shard mesh, held to the JAX reference's ``make_batched_distributed_run``
(one forced 4-device subprocess for the module) on the 2x2 spatial mesh
and on ``service_mesh(2, 2, 1)``, under every wire (dense, AER, a
saturating AER bound, per-ring ``auto``), pipelined and with a stimulus
per tenant; each tenant also to the port's dedicated single-shard run
(plastic weights and traces included); the tenant axis over gloo ranks
to the reference's batch-sharded mesh; and the reference's refusals and
mesh helpers with their texts. On the CPU the ``cuda`` and
``cuda_fused`` impls take the kernels' plain versions."""
import dataclasses
import types

import numpy as np
import pytest
import torch
from _subproc import run_multidevice

from repro_torch import convert
from repro_torch.configs import dpsnn
from repro_torch.configs.base import ExchangeConfig
from repro_torch.core import exchange as ex
from repro_torch.core import network as net
from repro_torch.core import partition as part
from repro_torch.core import simulation as sim
from repro_torch.launch import launch_distributed as ld
from repro_torch.runtime import sharding
from repro_torch.runtime.multiprocess import load_states, tenant_state_dir
from repro_torch.runtime.transport import LocalMesh

STEPS = 12
SEED = 42
# name -> (conn fields, ExchangeConfig fields, mesh, batch, nu_scale); the
# JAX side builds each case from the same table
CASES = {
    "dense": ({}, {}, "spatial", 3, None),
    "service": ({}, {}, "service", 2, None),
    "aer": ({"exchange_mode": "aer_sparse"}, {}, "spatial", 2, None),
    "aer_saturating": ({"exchange_mode": "aer_sparse",
                        "aer_rate_bound_hz": 0.5}, {}, "spatial", 2, None),
    "auto": ({}, {"exchange_mode": "auto"}, "spatial", 2, None),
    "pipelined": ({}, {"pipelined": True}, "spatial", 2, None),
    "stimulus": ({}, {}, "spatial", 3, [1.0, 0.8, 1.5]),
}
# the state leaves compared to the bit (v and c within the parity bar)
EXACT_LEAVES = ("hist_ext", "pending", "t", "spike_count", "event_count",
                "aer_sat", "ext_pending", "last_spike_t", "isi_sum",
                "isi_sumsq", "isi_count", "refrac")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The steps' tensors are small: one intra-op thread runs them about
    as fast as eight, and does not crowd the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def case_cfg(name):
    conn, exch, _mesh, _b, _nu = CASES[name]
    base = dpsnn.reduced(4, 4, 16, seed=SEED)
    return dataclasses.replace(
        base, conn=dataclasses.replace(base.conn, **conn),
        exchange=ExchangeConfig(**exch))


JAX_RUN = """
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import dpsnn
from repro.configs.base import ExchangeConfig
from repro.core import exchange
from repro.runtime.sharding import service_mesh
for name, (conn, exch, kind, batch, nu) in {cases!r}.items():
    base = dpsnn.reduced(4, 4, 16, seed={seed})
    cfg = dataclasses.replace(
        base, conn=dataclasses.replace(base.conn, **conn),
        exchange=ExchangeConfig(**exch))
    mesh = (jax.make_mesh((2, 2), ('data', 'model')) if kind == 'spatial'
            else service_mesh(2, 2, 1))
    run, _ = exchange.make_batched_distributed_run(
        cfg, mesh, n_steps={steps}, batch=batch,
        with_stimulus=nu is not None, with_state=True)
    seeds = cfg.seed + jnp.arange(batch, dtype=jnp.int32)
    res, st = (run(seeds) if nu is None
               else run(seeds, jnp.asarray(nu, jnp.float32)))
    leaves = dict(v=st.lif.v, c=st.lif.c, refrac=st.lif.refrac,
                  hist_ext=st.hist_ext, pending=st.pending, t=st.t,
                  spike_count=st.spike_count, event_count=st.event_count,
                  aer_sat=st.aer_sat, last_spike_t=st.last_spike_t,
                  isi_sum=st.isi_sum, isi_sumsq=st.isi_sumsq,
                  isi_count=st.isi_count)
    if st.ext_pending is not None:
        leaves['ext_pending'] = st.ext_pending
    np.savez('{out}/' + name + '.npz', res_spikes=np.asarray(res.spikes),
             res_events=np.asarray(res.events),
             res_sat=np.asarray(res.aer_saturated),
             **{{k: np.asarray(x) for k, x in leaves.items()}})
print('OK')
"""


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Every case of ``CASES`` through the reference's batched runner on a
    forced 4-device CPU mesh, one subprocess: per-tenant totals, the
    per-step saturation flags and the (n_shards, b_local, ...) state."""
    out = tmp_path_factory.mktemp("jax_batched_mesh")
    assert "OK" in run_multidevice(JAX_RUN.format(
        cases=CASES, seed=SEED, steps=STEPS, out=out), timeout=600)
    return {name: dict(np.load(out / f"{name}.npz")) for name in CASES}


def port_run(name, impl="ref", mesh=None):
    """The case on the port's in-process mesh: the spatial 2x2 grid, or,
    for the reference's service mesh, its 2x1 spatial grid holding both
    batch shards' tenants."""
    _conn, _exch, kind, batch, nu = CASES[name]
    cfg = case_cfg(name)
    mesh = mesh or LocalMesh(*((2, 2) if kind == "spatial" else (2, 1)),
                             "cpu")
    run, spec = ex.make_batched_distributed_run(
        cfg, mesh, n_steps=STEPS, batch=batch, impl=impl,
        with_stimulus=nu is not None, with_state=True)
    seeds = [SEED + i for i in range(batch)]
    res, st = run(seeds) if nu is None else run(seeds, nu)
    return cfg, spec, res, st


def jax_layout(name, want):
    """The reference's state leaves in the port's in-process layout: its
    service mesh's batch shards folded into one (S, B, ...) stack."""
    leaves = {k: v for k, v in want.items() if not k.startswith("res_")}
    if CASES[name][2] == "service":
        leaves = convert.merge_batch_shards(leaves, 2)
    return leaves


def assert_matches_jax(name, res, st, want):
    """Per-tenant spikes, events and the per-step saturation flags to the
    bit; the ring, pending frame, counters and ISI statistics bitwise;
    v and c within the parity bar of ``test_torch_distributed.py``."""
    np.testing.assert_array_equal(res.spikes.numpy(), want["res_spikes"])
    np.testing.assert_array_equal(res.events.numpy(), want["res_events"])
    np.testing.assert_array_equal(res.aer_saturated.numpy(),
                                  want["res_sat"])
    got = convert.dist_state_to_numpy(st)
    theirs = jax_layout(name, want)
    assert set(got) == set(theirs)
    for leaf in EXACT_LEAVES:
        if leaf in got:
            np.testing.assert_array_equal(got[leaf], theirs[leaf], leaf)
    for leaf in ("v", "c"):
        np.testing.assert_allclose(got[leaf], theirs[leaf], rtol=0,
                                   atol=2e-4, err_msg=leaf)


def dedicated(cfg, seed, impl="ref", nu_scale=None):
    """Tenant ``seed``'s dedicated single-shard run on the network of
    ``cfg.seed``."""
    cfg = dataclasses.replace(cfg, exchange=ExchangeConfig())
    params, _ = sim.build(cfg, device="cpu")
    state = net.init_state(cfg, net.column_ids(cfg), device="cpu", seed=seed)
    return sim.run(cfg, params, state, STEPS, impl=impl, seed=seed,
                   nu_scale=nu_scale)


def assert_tenants_dedicated(cfg, spec, res, st, impl, nu=None):
    """Each tenant equals its dedicated single-shard run to the bit:
    spikes, events, per-step spikes, v, c, refrac, and under STDP the
    live weights and traces."""
    for i in range(res.spikes.shape[0]):
        one = dedicated(cfg, SEED + i, impl, None if nu is None else nu[i])
        assert float(res.spikes[i]) == float(one.spikes)
        assert float(res.events[i]) == float(one.events)
        assert torch.equal(res.rate_trace[i], one.rate_trace)
        pairs = [(getattr(st.lif, k), getattr(one.state.lif, k))
                 for k in ("v", "c", "refrac")]
        if cfg.stdp:
            pl = st.plastic
            pairs += [(pl.w_local, one.params.w_local),
                      (pl.rem_w, one.params.rem_w),
                      (pl.traces.x_pre, one.state.stdp.x_pre),
                      (pl.traces.x_post, one.state.stdp.x_post)]
        for got, want in pairs:
            assert torch.equal(part.columns_to_global(got[:, i], spec), want)


@pytest.mark.parametrize("impl", ["ref", "cuda", "cuda_fused"])
def test_dense_2x2_equals_jax_and_dedicated(jax_runs, impl):
    """3 tenants on the 2x2 spatial mesh: JAX's batched run, and each
    tenant its dedicated single-shard run, under every impl."""
    cfg, spec, res, st = port_run("dense", impl)
    assert st.lif.v.shape[:2] == (4, 3) and st.t.shape == (4, 3)
    assert_matches_jax("dense", res, st, jax_runs["dense"])
    assert_tenants_dedicated(cfg, spec, res, st, impl)


@pytest.mark.parametrize("name", ["service", "aer", "auto", "pipelined",
                                  "stimulus"])
def test_batched_mesh_equals_jax_and_dedicated(jax_runs, name):
    """The reference's service mesh (2 batch shards of a 2x1 grid, here
    one process holding both), the AER and per-ring wires, the pipelined
    schedule and per-tenant stimulus scales."""
    cfg, spec, res, st = port_run(name)
    assert not int(res.aer_saturated.sum())
    assert_matches_jax(name, res, st, jax_runs[name])
    assert_tenants_dedicated(cfg, spec, res, st, "ref", CASES[name][4])


def test_saturating_aer_equals_jax(jax_runs):
    """At a 0.5 Hz bound the per-tenant lists overflow: the flags of every
    step, the truncated rings and the totals still equal JAX's."""
    _cfg, _spec, res, st = port_run("aer_saturating")
    assert int(res.aer_saturated.sum()) > 0
    assert_matches_jax("aer_saturating", res, st,
                       jax_runs["aer_saturating"])


def test_packed_wire_equals_float_strips(jax_runs):
    """``LocalMesh(compress=True)`` packs every tenant's strips into words
    as a process rank does: the same run."""
    _cfg, _spec, res, st = port_run("dense", mesh=LocalMesh(2, 2, "cpu",
                                                            compress=True))
    assert_matches_jax("dense", res, st, jax_runs["dense"])


@pytest.mark.parametrize("wire", ["dense_packed", "aer_sparse"])
def test_plastic_tenants_equal_dedicated(wire):
    """Under STDP each tenant owns its live weights and traces: two
    plastic tenants on the 2x2 mesh equal their dedicated plastic runs to
    the bit, on the dense wire and on AER (the trace values at the event
    addresses)."""
    base = dpsnn.reduced(4, 4, 16, seed=SEED, stdp=True)
    cfg = dataclasses.replace(base, conn=dataclasses.replace(
        base.conn, exchange_mode=wire, aer_rate_bound_hz=500.0))
    run, spec = ex.make_batched_distributed_run(
        cfg, LocalMesh(2, 2, "cpu"), n_steps=STEPS, batch=2,
        impl="cuda_fused", with_state=True)
    res, st = run([SEED, SEED + 1])
    assert st.plastic.w_local.shape[:2] == (4, 2)
    assert not int(res.aer_saturated.sum())
    assert_tenants_dedicated(cfg, spec, res, st, "cuda_fused")


def test_batch_sharded_ranks_equal_jax_service_mesh(jax_runs, tmp_path):
    """The tenant axis over processes: 2 gloo ranks, one batch shard of
    one tenant each, against the reference's service mesh: per-tenant
    spikes and events to the bit, each tenant's v within the parity bar
    (the ranks tile the grid 1x1, the reference 2x1)."""
    args = ld.make_parser().parse_args(
        ["--ranks", "2", "--batch", "2", "--batch-shards", "2",
         "--grid", "4x4", "--neurons", "16", "--steps", str(STEPS),
         "--seed", str(SEED), "--impl", "ref", "--device", "cpu",
         "--timeout", "120", "--state-dir", str(tmp_path)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        row = ld.launch(args)
    want = jax_runs["service"]
    assert row["process_grid"] == [2, 1, 1]
    assert row["per_tenant_spikes"] == want["res_spikes"].tolist()
    assert row["per_tenant_events"] == want["res_events"].tolist()
    cfg = case_cfg("service")
    theirs = jax_layout("service", want)["v"]            # (2, 2, C, N)
    jspec = part.make_tile_spec(cfg, 2, 1)
    for i in range(2):
        v = load_states(tenant_state_dir(str(tmp_path), i), 1)["v"]
        np.testing.assert_allclose(
            v[0], part.columns_to_global(theirs[:, i], jspec), rtol=0,
            atol=2e-4)


def test_batched_batch_indivisible_error_names_both():
    """batch must divide the transport's batch shards; the error names
    both numbers (before any state is built)."""
    fake = types.SimpleNamespace(batch_shards=2, batch_index=0, node=None,
                                 shape=(1, 1))
    with pytest.raises(ValueError, match="batch=3.*2 shards"):
        ex.make_batched_distributed_run(dpsnn.reduced(4, 4, 32), fake,
                                        n_steps=2, batch=3)


def test_hierarchical_mesh_is_refused():
    """The reference's text: tenants run on a flat spatial mesh."""
    node = part.make_node_spec(2, 2, 2)
    with pytest.raises(ValueError, match="does not support the hierarchical"):
        ex.make_batched_distributed_run(
            dpsnn.reduced(4, 4, 16), LocalMesh(2, 2, "cpu", node=node),
            n_steps=2, batch=2)


def test_service_mesh_device_count_error():
    """One process is one rank: a mesh of two batch shards needs more."""
    with pytest.raises(ValueError, match="needs 8 ranks, have 1"):
        sharding.service_mesh(2, 2, 2, device="cpu")


def test_local_tenants_follows_mesh_axes():
    """The port of ``test_tenant_pspec_follows_mesh_axes``: a transport
    without a tenant axis holds every tenant; a batch shard k of K holds
    the k-th block of B / K."""
    mesh = sharding.service_mesh(1, 1, 1, device="cpu")
    assert isinstance(mesh, LocalMesh)
    assert sharding.batch_shards(mesh) == 1
    assert sharding.local_tenants(mesh, 3) == range(3)
    spatial = LocalMesh(2, 2, "cpu")
    assert sharding.batch_shards(spatial) == 1
    assert sharding.local_tenants(spatial, 2) == range(2)
    shard = types.SimpleNamespace(batch_shards=2, batch_index=1)
    assert sharding.batch_shards(shard) == 2
    assert sharding.local_tenants(shard, 4) == range(2, 4)
    with pytest.raises(ValueError, match="batch=3.*2 shards"):
        sharding.local_tenants(shard, 3)


def test_resume_continues_exactly():
    """6 steps and a resume of 6 from the runner's (S, b, ...) state,
    carried through numpy and back, equal 12 straight, and the
    resumed-from state is left as it was."""
    cfg = case_cfg("stimulus")
    nu = CASES["stimulus"][4]
    mesh = LocalMesh(2, 2, "cpu")

    def runner(k):
        return ex.make_batched_distributed_run(
            cfg, mesh, n_steps=k, batch=3, with_stimulus=True,
            with_state=True)[0]
    seeds = [SEED, SEED + 1, SEED + 2]
    full, want = runner(12)(seeds, nu)
    half, st = runner(6)(seeds, nu)
    saved = convert.dist_state_to_numpy(st)
    st = convert.dist_state_from_numpy(saved, device="cpu")
    assert st.t.shape == (4, 3) and st.t.device.type == "cpu"
    res, got = runner(6)(seeds, nu, state=st)
    for k, v in convert.dist_state_to_numpy(st).items():
        np.testing.assert_array_equal(v, saved[k], k)
    assert torch.equal(res.spikes, full.spikes)
    assert torch.equal(res.events, full.events)
    assert torch.equal(torch.cat([half.rate_trace, res.rate_trace], 1),
                       full.rate_trace)
    for k, v in convert.dist_state_to_numpy(got).items():
        np.testing.assert_array_equal(v, convert.dist_state_to_numpy(
            want)[k], k)
