"""The port's multi-rank static step on an in-process mesh: bitwise
against the port's own single-shard ``simulation.run`` on every mesh,
impl, ring count, pipelining and compression below (on the CPU ``cuda``
and ``cuda_fused`` take their kernels' plain versions), a resume that
continues exactly, and the JAX reference's ``make_distributed_run`` on
a forced 4-device 2x2 mesh (run in a subprocess), both from the seed
and continued from the reference's own stacked state
(``convert.dist_state_from_numpy``)."""
import dataclasses

import numpy as np
import pytest
import torch
from _subproc import run_multidevice

from repro_torch import convert
from repro_torch.configs import dpsnn
from repro_torch.configs.base import ExchangeConfig
from repro_torch.core import exchange as ex
from repro_torch.core import partition as part
from repro_torch.core import simulation as sim
from repro_torch.runtime.transport import LocalMesh

STEPS = 80
GAUSS = dpsnn.reduced(8, 8, 64, seed=0)
EXP = dpsnn.reduced_family("exp", 6, 6, 48, radius=3, seed=0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The steps' tensors are small: one intra-op thread runs them about
    as fast as eight, and does not crowd the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def singles():
    """``single(cfg, impl)``: the port's single-shard run, once each."""
    done = {}

    def single(cfg, impl):
        if (cfg.name, impl) not in done:
            params, state = sim.build(cfg, device="cpu")
            done[cfg.name, impl] = sim.run(cfg, params, state, STEPS,
                                           impl=impl)
        return done[cfg.name, impl]
    return single


def _window(hist, spec, r):
    """(D, C, N) single-shard ring -> (S, D, th+2r, tw+2r, N): each
    shard's window of every zero-padded global frame."""
    d, _, n = hist.shape
    gh, gw = spec.tiles_y * spec.tile_h, spec.tiles_x * spec.tile_w
    pad = torch.zeros((d, gh + 2 * r, gw + 2 * r, n))
    pad[:, r:r + gh, r:r + gw] = hist.reshape(d, gh, gw, n)
    return torch.stack([
        pad[:, ty * spec.tile_h:(ty + 1) * spec.tile_h + 2 * r,
            tx * spec.tile_w:(tx + 1) * spec.tile_w + 2 * r]
        for ty, tx in (part.shard_tile_coords(spec, s)
                       for s in range(spec.tiles_y * spec.tiles_x))])


def _assert_matches_single(cfg, spec, res, st, ref):
    """Totals, rate trace, v, pending frame and the ring (interior and
    halo) to the bit. The mesh's ring runs one step behind the single
    shard's (two when pipelined; the frame in flight is ext_pending)."""
    r = spec.radius
    assert float(res.spikes) == float(ref.spikes)
    assert float(res.events) == float(ref.events)
    assert float(res.rate_hz) == float(ref.rate_hz)
    assert torch.equal(res.rate_trace, ref.rate_trace)
    for leaf in ("v", "c", "refrac"):
        assert torch.equal(part.columns_to_global(getattr(st.lif, leaf), spec),
                           getattr(ref.state.lif, leaf)), leaf
    hist = ref.state.hist
    d, t = hist.shape[0], int(ref.state.t)
    want = _window(hist, spec, r)
    assert torch.equal(part.tiles_to_global(st.pending, spec).reshape(-1),
                       hist[(t - 1) % d].reshape(-1))
    lag = [(t - 1) % d]
    if cfg.exchange.pipelined:
        lag.append((t - 2) % d)
        assert torch.equal(st.ext_pending, want[:, (t - 2) % d])
    keep = [k for k in range(d) if k not in lag]
    assert torch.equal(st.hist_ext[:, keep], want[:, keep])
    assert int(st.t[0]) == t


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("impl", ["ref", "cuda", "cuda_fused"])
def test_mesh_equals_single_shard(singles, shape, impl):
    run, spec = ex.make_distributed_run(GAUSS, LocalMesh(*shape, "cpu"),
                                        n_steps=STEPS, impl=impl,
                                        with_state=True)
    res, st = run()
    _assert_matches_single(GAUSS, spec, res, st, singles(GAUSS, impl))


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("compress", [True, False])
def test_two_ring_exp_family_equals_single_shard(singles, pipelined,
                                                 compress):
    """The radius-3 exp family on 2x2 tiles: two chained rings per
    direction, over slices and over the packed wire."""
    cfg = dataclasses.replace(EXP, exchange=ExchangeConfig(
        pipelined=pipelined))
    mesh = LocalMesh(3, 3, "cpu", compress=compress)
    run, spec = ex.make_distributed_run(cfg, mesh, n_steps=STEPS,
                                        impl="ref", with_state=True)
    assert (spec.rings_y, spec.rings_x) == (2, 2)
    res, st = run()
    _assert_matches_single(cfg, spec, res, st, singles(EXP, "ref"))


@pytest.mark.parametrize("pipelined", [False, True])
def test_resume_continues_exactly(pipelined):
    """60 steps straight == 30 steps + a resume of 30 from the stacked
    state (through numpy and back); the resumed-from state is left as
    it was."""
    cfg = dataclasses.replace(dpsnn.reduced(8, 8, 48, seed=2),
                              exchange=ExchangeConfig(pipelined=pipelined))
    mesh = LocalMesh(2, 2, "cpu")
    full, spec = ex.make_distributed_run(cfg, mesh, n_steps=60, impl="ref",
                                         with_state=True)
    ref, ref_st = full()
    half, _ = ex.make_distributed_run(cfg, mesh, n_steps=30, impl="ref",
                                      with_state=True)
    _, st = half()
    saved = convert.dist_state_to_numpy(st)
    st = convert.dist_state_from_numpy(saved, device="cpu")
    resume, _ = ex.make_distributed_run(cfg, mesh, n_steps=30, impl="ref",
                                        with_state=True)
    res, st2 = resume(st)
    for k, v in convert.dist_state_to_numpy(st).items():
        np.testing.assert_array_equal(v, saved[k], k)
    assert float(res.spikes) == float(ref.spikes)
    assert float(res.events) == float(ref.events)
    for k, v in convert.dist_state_to_numpy(st2).items():
        np.testing.assert_array_equal(v, convert.dist_state_to_numpy(
            ref_st)[k], k)


JAX_RUN = """
import jax, numpy as np
from repro.configs import dpsnn
from repro.core import exchange
cfg = dpsnn.reduced(8, 8, 48, seed=2)
mesh = jax.make_mesh((2, 2), ('data', 'model'))
for n in (30, 60):
    run, _ = exchange.make_distributed_run(cfg, mesh, n_steps=n,
                                           with_state=True)
    res, st = run()
    leaves = dict(v=st.lif.v, c=st.lif.c, refrac=st.lif.refrac,
                  hist_ext=st.hist_ext, pending=st.pending, t=st.t,
                  spike_count=st.spike_count, event_count=st.event_count,
                  aer_sat=st.aer_sat, last_spike_t=st.last_spike_t,
                  isi_sum=st.isi_sum, isi_sumsq=st.isi_sumsq,
                  isi_count=st.isi_count)
    np.savez('{out}/jax%d.npz' % n, res_spikes=np.asarray(res.spikes),
             res_events=np.asarray(res.events),
             **{{k: np.asarray(x) for k, x in leaves.items()}})
print('OK')
"""


@pytest.fixture(scope="module")
def jax_states(tmp_path_factory):
    """The reference's stacked 2x2 states after 30 and 60 steps of the
    8x8x48 grid (seed 2), from a forced 4-device subprocess."""
    out = tmp_path_factory.mktemp("jax_dist")
    assert "OK" in run_multidevice(JAX_RUN.format(out=out), timeout=300)
    return {n: dict(np.load(out / f"jax{n}.npz")) for n in (30, 60)}


def _assert_matches_jax(res, st, want):
    """Spikes and events exact; ring, pending, last spike times, ISI sums
    and counters bitwise; v within the parity bar of
    tests/test_simulator.py::test_pallas_matches_ref (atol 2e-4)."""
    assert float(res.spikes) == float(want["res_spikes"])
    assert float(res.events) == float(want["res_events"])
    got = convert.dist_state_to_numpy(st)
    for leaf in ("hist_ext", "pending", "t", "spike_count", "event_count",
                 "last_spike_t", "isi_sum", "isi_sumsq", "isi_count",
                 "refrac", "aer_sat"):
        np.testing.assert_array_equal(got[leaf], want[leaf], leaf)
    np.testing.assert_allclose(got["v"], want["v"], rtol=0, atol=2e-4)
    np.testing.assert_allclose(got["c"], want["c"], rtol=0, atol=2e-4)


@pytest.mark.parametrize("impl", ["ref", "cuda_fused"])
def test_mesh_matches_jax_make_distributed_run(jax_states, impl):
    cfg = dpsnn.reduced(8, 8, 48, seed=2)
    run, _ = ex.make_distributed_run(cfg, LocalMesh(2, 2, "cpu"),
                                     n_steps=60, impl=impl, with_state=True)
    res, st = run()
    _assert_matches_jax(res, st, jax_states[60])


def test_port_continues_the_jax_state(jax_states):
    """The reference's stacked state after 30 steps, carried across,
    continues 30 steps in the port to the reference's 60 straight."""
    cfg = dpsnn.reduced(8, 8, 48, seed=2)
    st30 = convert.dist_state_from_numpy(
        {k: v for k, v in jax_states[30].items()
         if k in convert.DIST_LEAVES}, device="cpu")
    assert st30.t.device.type == "cpu" and st30.t.dtype == torch.int32
    resume, _ = ex.make_distributed_run(cfg, LocalMesh(2, 2, "cpu"),
                                        n_steps=30, impl="ref",
                                        with_state=True)
    res, st = resume(st30)
    _assert_matches_jax(res, st, jax_states[60])


def test_cli_mesh_equals_cli_single_shard(capsys):
    """``launch/sim.py --mesh 2x2 --pipelined`` on the CPU: the same timed
    steps, per-step rates and totals as the single-shard CLI."""
    from repro_torch.launch import sim as cli
    argv = ["--grid", "8x8", "--neurons", "48", "--steps", "30",
            "--impl", "ref", "--device", "cpu", "--seed", "5"]
    single = cli.main(argv)
    mesh = cli.main(argv + ["--mesh", "2x2", "--pipelined"])
    out = capsys.readouterr().out
    assert "mesh 2x2 shards of 4x4 columns" in out and "pipelined" in out
    assert torch.equal(mesh.rate_trace, single.rate_trace)
    assert float(mesh.spikes) == float(single.spikes)
    assert float(mesh.events) == float(single.events)
