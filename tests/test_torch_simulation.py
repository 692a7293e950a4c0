"""The port's single-shard simulation against the JAX reference.

Two ways in. The trajectory tests take the network and initial state
from the reference's ``sim.build``, carried across with
``repro_torch.convert``, and feed both sides the reference's own Poisson
drive counts. The seeded tests build the port's network and state from
the seed and let it draw its own drive (``core/prng.py``): no
``convert.py`` and no injected counts. The bar is the reference's own
between its impls (tests/test_simulator.py::test_pallas_matches_ref and
tests/test_fused_step.py). On the CPU the port's three impls all run
plain PyTorch (the kernel wrappers' CPU path)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dpsnn as jdpsnn
from repro.configs.base import DPSNNConfig as JCfg
from repro.core import metrics as JM
from repro.core import network as jnet
from repro.core import simulation as jsim
from repro_torch import convert
from repro_torch.configs import dpsnn
from repro_torch.configs.base import DPSNNConfig
from repro_torch.core import metrics as M
from repro_torch.core import network as net
from repro_torch.core import simulation as sim


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_drive(cfg, n_steps, t0=0):
    col_ids = jnp.arange(cfg.n_columns, dtype=jnp.int32)
    draw = jax.jit(lambda t: jnet.external_drive(cfg, t, col_ids)[1])
    return np.stack([np.asarray(draw(jnp.int32(t)))
                     for t in range(t0, t0 + n_steps)])


def _leaves(tree):
    return (None if tree is None else
            {k: np.asarray(getattr(tree, k)) for k in tree._fields})


def _carry(jparams, jstate):
    """The reference's params and state as the port's, on the CPU, with
    the STDP traces and guard leaves when the state has them."""
    params = convert.params_from_numpy(
        **{k: np.asarray(getattr(jparams, k)) for k in convert.PARAM_LEAVES},
        device="cpu")
    state = convert.state_from_numpy(
        v=np.asarray(jstate.lif.v), c=np.asarray(jstate.lif.c),
        refrac=np.asarray(jstate.lif.refrac), hist=np.asarray(jstate.hist),
        t=np.asarray(jstate.t), spike_count=np.asarray(jstate.spike_count),
        event_count=np.asarray(jstate.event_count),
        stdp=_leaves(jstate.stdp), guard=_leaves(jstate.guard),
        device="cpu")
    return params, state


def _pair(**kw):
    return JCfg(**kw), DPSNNConfig(**kw)


@pytest.fixture(scope="module")
def small():
    jcfg, cfg = _pair(grid_h=4, grid_w=4, neurons_per_column=64, seed=0)
    jparams, jstate = jsim.build(jcfg)
    jres = jsim.run(jcfg, jparams, jstate, 60, impl="ref")
    return jcfg, cfg, jparams, jstate, jres, _jax_drive(jcfg, 60)


@pytest.mark.parametrize("impl", ["ref", "cuda", "cuda_fused"])
def test_small_run_matches_reference(small, impl):
    """4x4 columns of 64 neurons, 60 steps: equal spike totals, events
    and per-step rate trace; v allclose at 2e-4; equal bytes/synapse."""
    jcfg, cfg, jparams, jstate, jres, counts = small
    params, state = _carry(jparams, jstate)
    res = sim.run(cfg, params, state, 60, impl=impl,
                  ext_counts=torch.from_numpy(counts))
    assert float(res.spikes) == float(jres.spikes) > 0
    assert float(res.events) == float(jres.events)
    np.testing.assert_array_equal(res.rate_trace.numpy(),
                                  np.asarray(jres.rate_trace))
    assert float(res.rate_hz) == float(jres.rate_hz)
    np.testing.assert_allclose(res.state.lif.v.numpy(),
                               np.asarray(jres.state.lif.v),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(res.state.hist.numpy(),
                                  np.asarray(jres.state.hist))
    assert int(res.state.t) == int(jres.state.t) == 60
    assert M.bytes_per_synapse(cfg, params, res.state) == \
        JM.bytes_per_synapse(jcfg, jparams, jres.state)
    np.testing.assert_allclose(float(M.synchrony_index(res.rate_trace)),
                               float(JM.synchrony_index(jres.rate_trace)),
                               rtol=1e-5)


def test_multiblock_run_allclose():
    """3x3 columns of 200 neurons (two source blocks), 30 steps: the bar
    of tests/test_fused_step.py::test_fused_multiblock_allclose."""
    jcfg, cfg = _pair(grid_h=3, grid_w=3, neurons_per_column=200, seed=1)
    jparams, jstate = jsim.build(jcfg)
    jres = jsim.run(jcfg, jparams, jstate, 30, impl="ref")
    params, state = _carry(jparams, jstate)
    res = sim.run(cfg, params, state, 30, impl="cuda_fused",
                  ext_counts=torch.from_numpy(_jax_drive(jcfg, 30)))
    np.testing.assert_allclose(res.state.lif.v.numpy(),
                               np.asarray(jres.state.lif.v),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(res.rate_hz), float(jres.rate_hz),
                               rtol=2e-2)


def test_full_column_width():
    """2x2 columns at the paper's 1240 neurons: one step from a state
    the reference ran to step 15 agrees at 1e-5; over 20 steps from the
    start the spike totals agree within 1 %."""
    jcfg, cfg = _pair(grid_h=2, grid_w=2, neurons_per_column=1240, seed=2)
    jparams, jstate = jsim.build(jcfg)
    mid = jsim.run(jcfg, jparams, jstate, 15, impl="ref").state
    jone = jsim.run(jcfg, jparams, mid, 1, impl="ref")
    params, state = _carry(jparams, mid)
    one = sim.run(cfg, params, state, 1, impl="cuda_fused",
                  ext_counts=torch.from_numpy(_jax_drive(jcfg, 1, t0=15)))
    np.testing.assert_allclose(one.state.lif.v.numpy(),
                               np.asarray(jone.state.lif.v),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(one.state.lif.refrac.numpy(),
                                  np.asarray(jone.state.lif.refrac))

    j20 = jsim.run(jcfg, jparams, jstate, 20, impl="ref")
    params, state = _carry(jparams, jstate)
    r20 = sim.run(cfg, params, state, 20, impl="cuda_fused",
                  ext_counts=torch.from_numpy(_jax_drive(jcfg, 20)))
    assert float(j20.spikes) > 0
    assert abs(float(r20.spikes) - float(j20.spikes)) <= \
        0.01 * float(j20.spikes)


# the Gaussian grid of the parity bar, a radius-3 family and a
# non-square grid: (name, config maker) with the maker taking the
# package's configs module
SEEDED = {
    "gauss-4x4x64": lambda m: m.reduced(4, 4, 64, seed=0),
    "exp-r3-6x6x48": lambda m: m.reduced_family("exp", 6, 6, 48, radius=3,
                                                seed=5),
    "gauss-3x5x40": lambda m: m.reduced(3, 5, 40, seed=1),
}
# the weights' bound: the truncated-normal jitter within 4 ulp
# (tests/test_torch_prng.py), so each weight within 1e-6 of its value
W_RTOL = 1e-6


@pytest.fixture(scope="module")
def seeded():
    """Per SEEDED config: the reference's build and its 60-step ``ref``
    run, and the port's own build from the same seed, on the CPU."""
    out = {}

    def get(name):
        if name not in out:
            jcfg, cfg = SEEDED[name](jdpsnn), SEEDED[name](dpsnn)
            jparams, jstate = jsim.build(jcfg)
            jres = jsim.run(jcfg, jparams, jstate, 60, impl="ref")
            out[name] = (cfg, jparams, jstate, jres,
                         *sim.build(cfg, device="cpu"))
        return out[name]
    return get


@pytest.mark.parametrize("name", SEEDED)
def test_seeded_network_matches_reference(seeded, name):
    """The port's keyed build against the reference's: the local mask,
    the ELL indices and the initial state to the bit, the weights within
    the truncated-normal bound."""
    cfg, jparams, jstate, _jres, params, state = seeded(name)
    jw = np.asarray(jparams.w_local)
    np.testing.assert_array_equal(params.w_local.numpy() != 0, jw != 0)
    np.testing.assert_array_equal(params.rem_flat.numpy(),
                                  np.asarray(jparams.rem_flat))
    np.testing.assert_array_equal(params.local_outdeg.numpy(),
                                  np.asarray(jparams.local_outdeg))
    for leaf in ("w_local", "rem_w"):
        np.testing.assert_allclose(getattr(params, leaf).numpy(),
                                   np.asarray(getattr(jparams, leaf)),
                                   rtol=W_RTOL, atol=0)
    for leaf in ("v", "c", "refrac"):
        np.testing.assert_array_equal(getattr(state.lif, leaf).numpy(),
                                      np.asarray(getattr(jstate.lif, leaf)))
    assert state.hist.shape == jstate.hist.shape


@pytest.mark.parametrize("impl", ["ref", "cuda", "cuda_fused"])
@pytest.mark.parametrize("name", SEEDED)
def test_seeded_run_matches_reference(seeded, name, impl):
    """The queue-1 gate: the port built from the seed, drawing its own
    drive, against the reference run from the same seed over 60 steps:
    equal spikes and events, ``v`` allclose at 2e-4."""
    cfg, _jparams, _jstate, jres, params, state = seeded(name)
    res = sim.run(cfg, params, state, 60, impl=impl)
    assert float(res.spikes) == float(jres.spikes) > 0
    assert float(res.events) == float(jres.events)
    np.testing.assert_allclose(res.state.lif.v.numpy(),
                               np.asarray(jres.state.lif.v),
                               rtol=2e-4, atol=2e-4)


def test_convert_round_trip(small):
    _jcfg, _cfg, jparams, jstate, _jres, _counts = small
    params, state = _carry(jparams, jstate)
    back = convert.params_to_numpy(params)
    for k in convert.PARAM_LEAVES:
        ref = np.asarray(getattr(jparams, k))
        assert back[k].dtype == ref.dtype and np.array_equal(back[k], ref), k
    sback = convert.state_to_numpy(state)
    assert np.array_equal(sback["v"], np.asarray(jstate.lif.v))
    assert np.array_equal(sback["hist"], np.asarray(jstate.hist))
    assert sback["t"].dtype == np.int32 and state.t.device.type == "cpu"


def test_port_builds_its_own_network():
    """The port's own generator and drive: a rate in the reference's
    healthy band (tests/test_simulator.py), deterministic runs, and
    three impls that agree."""
    cfg = DPSNNConfig(grid_h=4, grid_w=4, neurons_per_column=64, seed=0)
    params, state = sim.build(cfg, device="cpu")
    res = sim.run(cfg, params, state, 300, impl="ref")
    assert 0.5 < float(res.rate_hz) < 60.0
    assert bool(torch.isfinite(res.state.lif.v).all())
    again = sim.run(cfg, params, state, 100, impl="ref")
    fused = sim.run(cfg, params, state, 100, impl="cuda_fused")
    staged = sim.run(cfg, params, state, 100, impl="cuda")
    for other in (fused, staged):
        assert float(other.spikes) == float(again.spikes)
        assert float(other.events) == float(again.events)
        assert torch.equal(other.state.lif.v, again.state.lif.v)
    assert M.bytes_per_synapse(cfg, params, state) < 25.9
    counter = torch.zeros(1, dtype=torch.int64)
    sim.run(cfg, params, state, 10, impl="cuda_fused", silent_blocks=counter)
    assert 0 < int(counter) <= 10 * cfg.n_columns


def test_event_accounting_consistent():
    cfg = DPSNNConfig(grid_h=4, grid_w=4, neurons_per_column=64, seed=0)
    params, state = sim.build(cfg, device="cpu")
    res = sim.run(cfg, params, state, 200, impl="ref")
    k_tot = params.rem_w.shape[-1]
    recurrent = float(res.spikes) * (float(params.local_outdeg.mean()) + k_tot)
    ext_expect = cfg.n_neurons * cfg.c_ext * cfg.nu_ext_hz * 1e-3 * 200
    total = recurrent + ext_expect
    assert abs(float(res.events) - total) / total < 0.1
    assert sim.events_per_simulated_second(cfg, 5.0) > 0


@pytest.mark.parametrize("change,match", [
    (dict(weight_dtype="bfloat16"), "bf16"),
])
def test_off_path_options_raise(change, match):
    cfg = dataclasses.replace(
        DPSNNConfig(grid_h=2, grid_w=2, neurons_per_column=16), **change)
    params, state = sim.build(
        DPSNNConfig(grid_h=2, grid_w=2, neurons_per_column=16), device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        sim.run(cfg, params, state, 1, impl="ref")
    with pytest.raises(NotImplementedError, match=match):
        net.make_step_fn(cfg, impl="cuda_fused")


def test_pipelined_and_unknown_impl_raise():
    from repro_torch.configs.base import ExchangeConfig
    cfg = DPSNNConfig(grid_h=2, grid_w=2, neurons_per_column=16,
                      exchange=ExchangeConfig(pipelined=True))
    with pytest.raises(NotImplementedError, match="multi-rank"):
        net.check_supported(cfg, "ref")
    with pytest.raises(ValueError, match="unknown impl"):
        net.check_supported(DPSNNConfig(), "pallas")


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the raise is for a host without one")
    with pytest.raises(RuntimeError, match="cuda"):
        sim.build(DPSNNConfig(grid_h=2, grid_w=2, neurons_per_column=16))
