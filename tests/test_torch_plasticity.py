"""The port's STDP against the JAX reference: the dense update's plain
version against ``repro.kernels.ref.stdp_dense_update_ref`` (jitted, as
the reference's step runs it) and against the Pallas kernel in interpret
mode; the fused step's STDP-trace and guard-flag epilogues against the
Pallas ``fused_step``; the pre-trace table and one ``stdp_update``; and
the plastic run under the three impls against the reference's ``ref``
run. Inputs come from a numpy seed or from the reference's ``sim.build``
(carried across with ``repro_torch.convert``), and both sides get the
reference's Poisson counts.

Weights and traces are held to the bit: the port groups every
multiply-add as XLA groups the reference's jitted step on the CPU
(``kernels/ref.py::_fma``). The membrane potential is held to 1e-5, the
bar of tests/test_fused_step.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import TOL, _fused_inputs, _t
from test_torch_simulation import _carry, _jax_drive

from repro.configs.base import DPSNNConfig as JCfg
from repro.configs.base import GuardConfig as JGuard
from repro.configs.base import NeuronConfig as JNeuronConfig
from repro.configs.base import STDPConfig as JSTDP
from repro.core import metrics as JM
from repro.core import plasticity as jplast
from repro.core import simulation as jsim
from repro.core.connectivity import build_stencil as jbuild_stencil
from repro.core.connectivity import neuron_types as jneuron_types
from repro.core.network import NetworkParams as JParams
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.configs.base import (DPSNNConfig, GuardConfig,
                                      NeuronConfig, STDPConfig)
from repro_torch.core import metrics as M
from repro_torch.core import plasticity as plast
from repro_torch.core import simulation as sim
from repro_torch.core.connectivity import build_stencil, neuron_types
from repro_torch.kernels import ops, ref


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


STDP_KW = dict(a_plus=0.05, a_minus=0.055)


def _pair(**kw):
    return (JCfg(stdp_cfg=JSTDP(**STDP_KW), **kw),
            DPSNNConfig(stdp_cfg=STDPConfig(**STDP_KW), **kw))


def _equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _dense_inputs(rng, c, n):
    """w (absent and inhibitory synapses too), x_pre_exc, spk_exc,
    spikes, x_post; the last fifth of the sources inhibitory."""
    w = rng.uniform(-0.5, 1.2, (c, n, n)).astype(np.float32)
    w[np.abs(w) < 0.1] = 0.0
    exc = (np.arange(n) < 0.8 * n).astype(np.float32)
    x_pre = rng.uniform(0, 5, (c, n)).astype(np.float32)
    x_post = rng.uniform(0, 5, (c, n)).astype(np.float32)
    spikes = (rng.random((c, n)) < 0.2).astype(np.float32)
    return w, x_pre * exc, spikes * exc, spikes, x_post


@pytest.mark.parametrize("lr", [1.0, 0.7])
@pytest.mark.parametrize("c,n", [(1, 32), (3, 150), (4, 257)])
def test_stdp_dense_update_bitwise(c, n, lr):
    rng = np.random.default_rng(c * 100 + n)
    args = _dense_inputs(rng, c, n)
    kw = dict(STDP_KW, lr=lr, w_max=0.84)
    got = ops.stdp_dense_update(*(_t(x) for x in args), **kw)
    jargs = [jnp.asarray(x) for x in args]
    jitted = jax.jit(functools.partial(jref.stdp_dense_update_ref, **kw))
    _equal(got, jitted(*jargs))
    _equal(got, jops.stdp_dense_update(*jargs, **kw))
    assert int((got != _t(args[0])).sum()) > 0


def test_stdp_dense_update_all_silent_clips_only():
    """Silent spikes: the clip alone, to the bit; zeros stay zero and
    negative (inhibitory) weights unchanged."""
    rng = np.random.default_rng(5)
    c, n = 3, 150
    w, x_pre, _s, _t_, x_post = _dense_inputs(rng, c, n)
    w = w * 2.0                                   # many above w_max
    z = np.zeros((c, n), np.float32)
    kw = dict(STDP_KW, lr=1.0, w_max=0.84)
    got = ops.stdp_dense_update(_t(w), _t(x_pre), _t(z), _t(z), _t(x_post),
                                **kw)
    want = np.where(w > 0, np.clip(w, 0.0, 0.84), w)
    np.testing.assert_array_equal(got.numpy(), want)
    _equal(got, jops.stdp_dense_update(
        *(jnp.asarray(x) for x in (w, x_pre, z, z, x_post)), **kw))
    assert (got.numpy()[w == 0] == 0).all()
    assert (got.numpy()[w < 0] == w[w < 0]).all()


def test_stdp_constants_are_the_reference_decays():
    scfg = JSTDP(tau_plus_ms=20.0, tau_minus_ms=15.0)
    k = ref.stdp_constants(STDPConfig(tau_plus_ms=20.0, tau_minus_ms=15.0),
                           1.0)
    dp = jax.jit(lambda: jnp.exp(-1.0 / scfg.tau_plus_ms)
                 .astype(jnp.float32))()
    dm = jax.jit(lambda: jnp.exp(-1.0 / scfg.tau_minus_ms)
                 .astype(jnp.float32))()
    assert (k["dp"], k["dm"]) == (float(dp), float(dm))


def _poison(v, refrac):
    """One NaN v and one v at -1e4, in non-refractory neurons of
    different columns."""
    v, refrac = v.copy(), refrac.copy()
    c = v.shape[0]
    v[0, 5], refrac[0, 5] = np.nan, 0
    v[c - 1, 7], refrac[c - 1, 7] = -1e4, 0
    return v, refrac


@pytest.mark.parametrize("c,n,k,o", [(3, 48, 16, 4), (2, 130, 17, 20)])
def test_fused_step_epilogues_match_reference(c, n, k, o):
    """Traces and guard flags to the bit, the LIF outputs at 1e-5,
    against the Pallas fused_step with scfg and gcfg."""
    rng = np.random.default_rng(c * 13 + n)
    v, cc, r, s_loc, w, tbl, idx, rw, ext = _fused_inputs(rng, c, n, k, o)
    v, r = _poison(v, r)
    x_pre = rng.uniform(0, 4, (c, n)).astype(np.float32)
    x_post = rng.uniform(0, 4, (c, n)).astype(np.float32)
    args = (v, cc, r, s_loc, w, tbl, idx, rw, ext, x_pre, x_post)
    got = ops.fused_step(NeuronConfig(), *(_t(x) for x in args),
                         scfg=STDPConfig(), gcfg=GuardConfig(enabled=True))
    want = jops.fused_step(JNeuronConfig(), *(jnp.asarray(x) for x in args),
                           scfg=JSTDP(), gcfg=JGuard(enabled=True))
    assert len(got) == len(want) == 7
    for g, w_ in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy().astype(np.float32),
                                   np.asarray(w_, np.float32), **TOL)
    for g, w_ in zip(got[4:], want[4:]):
        _equal(g, w_)
    assert got[-1].dtype == torch.int32
    assert got[-1].tolist() == [1] + [0] * (c - 2) + [2]

    # each epilogue alone: the same values, in the same places
    only_stdp = ops.fused_step(NeuronConfig(), *(_t(x) for x in args),
                               scfg=STDPConfig())
    only_guard = ops.fused_step(NeuronConfig(), *(_t(x) for x in args[:9]),
                                gcfg=GuardConfig(enabled=True))
    assert len(only_stdp) == 6 and len(only_guard) == 5
    assert torch.equal(only_stdp[4], got[4])
    assert torch.equal(only_guard[4], got[6])


def _plastic_inputs(jcfg, seed=1):
    rng = np.random.default_rng(seed)
    c, n = jcfg.n_columns, jcfg.neurons_per_column
    x_pre = rng.uniform(0, 3, (c, n)).astype(np.float32)
    x_post = rng.uniform(0, 3, (c, n)).astype(np.float32)
    spikes = (rng.random((c, n)) < 0.3).astype(np.float32)
    return x_pre, x_post, spikes


def test_pre_trace_table_matches_reference():
    jcfg, cfg = _pair(grid_h=4, grid_w=5, neurons_per_column=48, seed=3)
    x_pre, _x, _s = _plastic_inputs(jcfg)
    got = plast.pre_trace_table(_t(x_pre), build_stencil(cfg), (4, 5))
    want = jax.jit(lambda x: jplast.pre_trace_table(
        x, jbuild_stencil(jcfg), (4, 5)))(jnp.asarray(x_pre))
    _equal(got, want)


@pytest.mark.parametrize("lr", [1.0, 0.7])
@pytest.mark.parametrize("with_table", [False, True])
def test_stdp_update_step_matches_reference(with_table, lr):
    """One jitted reference ``stdp_update`` (traces advanced in it, or
    handed in as the fused path does) against the port's: traces, dense
    and remote weights to the bit."""
    kw = dict(grid_h=4, grid_w=4, neurons_per_column=48, seed=3, stdp=True)
    jcfg = JCfg(stdp_cfg=JSTDP(lr=lr, **STDP_KW), **kw)
    cfg = DPSNNConfig(stdp_cfg=STDPConfig(lr=lr, **STDP_KW), **kw)
    jparams, jstate = jsim.build(jcfg)
    params, _state = _carry(jparams, jstate)
    x_pre, x_post, spikes = _plastic_inputs(jcfg)
    st = jplast.STDPState(jnp.asarray(x_pre), jnp.asarray(x_post))
    jstencil, jinh = jbuild_stencil(jcfg), jneuron_types(jcfg)

    @jax.jit
    def jstep(p, st, spk):
        table = (jplast.pre_trace_table(st.x_pre, jstencil, (4, 4))
                 if with_table else None)
        return jplast.stdp_update(jcfg, jcfg.stdp_cfg, p, st, spk, jinh,
                                  pre_trace_table=table,
                                  rem_flat=p.rem_flat, impl="ref")

    jp, jst = jstep(jparams, st, jnp.asarray(spikes))
    tst = plast.STDPState(_t(x_pre), _t(x_post))
    table = (plast.pre_trace_table(tst.x_pre, build_stencil(cfg), (4, 4))
             if with_table else None)
    for impl in ("ref", "cuda", "cuda_fused"):
        p1, st1 = plast.stdp_update(
            cfg, cfg.stdp_cfg, params, tst, _t(spikes), neuron_types(cfg),
            pre_trace_table=table, rem_flat=params.rem_flat, impl=impl)
        _equal(st1.x_pre, jst.x_pre)
        _equal(st1.x_post, jst.x_post)
        _equal(p1.w_local, jp.w_local)
        _equal(p1.rem_w, jp.rem_w)
    assert torch.equal(params.w_local, _t(np.asarray(jparams.w_local)))
    assert torch.equal(p1.rem_w, params.rem_w) != with_table


def _remote_inputs(rng, c, n, k, t, frame, w_max):
    """A (C, T) pre-trace table, indices, weights (a fifth each absent,
    negative, within 1e-3 of w_max and just above 0, the rest in
    between), this step's spikes (``frame``) and post-traces."""
    table = rng.uniform(0, 3, (c, t)).astype(np.float32)
    idx = rng.integers(0, t, (c, n, k)).astype(np.int32)
    u = rng.random((c, n, k)).astype(np.float32)
    w = rng.uniform(0.05, 0.8, (c, n, k)).astype(np.float32)
    w = np.select([u < 0.2, u < 0.4, u < 0.6, u < 0.8],
                  [0.0, -w, np.float32(w_max) - 1e-3 * u, 1e-4 * u], w)
    spikes = {"random": (rng.random((c, n)) < 0.3),
              "silent": np.zeros((c, n)),
              "spiking": np.ones((c, n))}[frame].astype(np.float32)
    x_post = rng.uniform(0, 3, (c, n)).astype(np.float32)
    return table, idx, w.astype(np.float32), spikes, x_post


@pytest.mark.parametrize("frame", ["random", "silent", "spiking"])
@pytest.mark.parametrize("k", [248, 7])
@pytest.mark.parametrize("lr", [1.0, 0.7])
def test_stdp_remote_update_ref_bitwise(lr, k, frame):
    """The remote rule's plain version against the reference's (its
    ``rem_w`` branch of ``stdp_update``, jitted) on the same table,
    indices, spikes and post-traces, to the bit; the clip bites at w_max
    when every neuron spikes and at 0 when none does, and weights <= 0
    stay as they were."""
    kw = dict(grid_h=2, grid_w=2, neurons_per_column=40, seed=1, stdp=True)
    jcfg = JCfg(stdp_cfg=JSTDP(lr=lr, **STDP_KW), **kw)
    scfg = STDPConfig(lr=lr, **STDP_KW)
    c, n = jcfg.n_columns, jcfg.neurons_per_column
    w_max = scfg.w_max_factor * jcfg.conn.j_exc
    rng = np.random.default_rng(k * 10 + len(frame))
    table, idx, w, spikes, x_post = _remote_inputs(rng, c, n, k, 9 * n,
                                                   frame, w_max)
    jparams = JParams(w_local=jnp.zeros((c, n, n), jnp.float32),
                      rem_flat=jnp.asarray(idx), rem_w=jnp.asarray(w),
                      local_outdeg=jnp.zeros((c, n), jnp.float32))
    traces = jplast.STDPState(jnp.zeros((c, n), jnp.float32),
                              jnp.asarray(x_post))
    jinh = jneuron_types(jcfg)

    @jax.jit
    def jrule(p, tbl, spk):
        return jplast.stdp_update(jcfg, jcfg.stdp_cfg, p, traces, spk, jinh,
                                  pre_trace_table=tbl, rem_flat=p.rem_flat,
                                  impl="ref", new_traces=traces)[0].rem_w

    want = jrule(jparams, jnp.asarray(table), jnp.asarray(spikes))
    args = (_t(table), _t(idx), _t(w), _t(spikes), _t(x_post))
    rule = dict(a_plus=scfg.a_plus, a_minus=scfg.a_minus, lr=lr, w_max=w_max)
    got = ref.stdp_remote_update_ref(*args, **rule)
    _equal(got, want)
    _equal(ops.stdp_remote_update(*args, **rule), want)
    pos = w > 0
    assert (got.numpy()[~pos] == w[~pos]).all()
    if frame == "spiking":
        assert (got.numpy()[pos] == np.float32(w_max)).any()
    if frame == "silent":
        assert (got.numpy()[pos] == 0.0).any()


@pytest.mark.parametrize("impl", ["ref", "cuda", "cuda_fused"])
def test_stdp_update_remote_rule_takes_its_wrapper(monkeypatch, impl):
    """Under 'cuda' and 'cuda_fused' the remote rule goes through
    ``ops.stdp_remote_update`` (on the card, its kernel); under 'ref' the
    plain version is called directly."""
    calls = []
    wrapper = ops.stdp_remote_update

    def spy(*args, **kw):
        calls.append(args[1].dtype)
        return wrapper(*args, **kw)
    monkeypatch.setattr(ops, "stdp_remote_update", spy)
    cfg = DPSNNConfig(grid_h=3, grid_w=3, neurons_per_column=24, seed=2,
                      stdp=True, stdp_cfg=STDPConfig(**STDP_KW))
    params, _state = sim.build(cfg, device="cpu")
    x_pre, x_post, spikes = (_t(x) for x in _plastic_inputs(cfg))
    st = plast.STDPState(x_pre, x_post)
    table = plast.pre_trace_table(x_pre, build_stencil(cfg), (3, 3))
    p1, _st1 = plast.stdp_update(cfg, cfg.stdp_cfg, params, st, spikes,
                                 neuron_types(cfg), pre_trace_table=table,
                                 rem_flat=params.rem_flat, impl=impl)
    assert calls == ([] if impl == "ref" else [torch.int32])
    assert not torch.equal(p1.rem_w, params.rem_w)


@pytest.fixture(scope="module")
def plastic():
    """The geometry of tests/test_fused_step.py: 4x4x48, seed 3, 100
    steps, the reference's ``ref`` run."""
    jcfg, cfg = _pair(grid_h=4, grid_w=4, neurons_per_column=48, seed=3,
                      stdp=True)
    jparams, jstate = jsim.build(jcfg)
    jres = jsim.run(jcfg, jparams, jstate, 100, impl="ref")
    return jcfg, cfg, jparams, jstate, jres, _jax_drive(jcfg, 100)


@pytest.mark.parametrize("impl", ["ref", "cuda", "cuda_fused"])
def test_plastic_run_matches_reference(plastic, impl):
    jcfg, cfg, jparams, jstate, jres, counts = plastic
    params, state = _carry(jparams, jstate)
    res = sim.run(cfg, params, state, 100, impl=impl,
                  ext_counts=torch.from_numpy(counts))
    assert float(res.spikes) == float(jres.spikes) > 0
    assert float(res.events) == float(jres.events)
    _equal(res.rate_trace, jres.rate_trace)
    _equal(res.state.hist, jres.state.hist)
    _equal(res.state.lif.c, jres.state.lif.c)
    _equal(res.state.lif.refrac, jres.state.lif.refrac)
    _equal(res.state.stdp.x_pre, jres.state.stdp.x_pre)
    _equal(res.state.stdp.x_post, jres.state.stdp.x_post)
    _equal(res.params.w_local, jres.params.w_local)
    _equal(res.params.rem_w, jres.params.rem_w)
    assert not torch.equal(res.params.w_local, params.w_local)
    np.testing.assert_allclose(res.state.lif.v.numpy(),
                               np.asarray(jres.state.lif.v),
                               rtol=1e-5, atol=1e-5)
    assert M.bytes_per_synapse(cfg, res.params, res.state) == \
        JM.bytes_per_synapse(jcfg, jres.params, jres.state)
    # the run left its inputs as they were
    assert torch.equal(params.w_local, _t(np.asarray(jparams.w_local)))
    assert float(state.stdp.x_pre.abs().sum()) == 0.0


def test_multiblock_plastic_run_allclose():
    """N = 200 spans two source blocks: allclose, the bar of
    tests/test_fused_step.py::test_fused_multiblock_allclose."""
    jcfg, cfg = _pair(grid_h=3, grid_w=3, neurons_per_column=200, seed=1,
                      stdp=True)
    jparams, jstate = jsim.build(jcfg)
    jres = jsim.run(jcfg, jparams, jstate, 30, impl="ref")
    params, state = _carry(jparams, jstate)
    res = sim.run(cfg, params, state, 30, impl="cuda_fused",
                  ext_counts=torch.from_numpy(_jax_drive(jcfg, 30)))
    np.testing.assert_allclose(res.state.lif.v.numpy(),
                               np.asarray(jres.state.lif.v),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res.params.w_local.numpy(),
                               np.asarray(jres.params.w_local),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(res.rate_hz), float(jres.rate_hz),
                               rtol=2e-2)


def test_convert_round_trip_plastic_guarded():
    jcfg = JCfg(grid_h=2, grid_w=2, neurons_per_column=16, stdp=True,
                guard=JGuard(enabled=True))
    jparams, jstate = jsim.build(jcfg)
    _params, state = _carry(jparams, jstate)
    leaves = convert.state_to_numpy(state)
    for k in convert.STDP_LEAVES:
        np.testing.assert_array_equal(leaves["stdp"][k],
                                      np.asarray(getattr(jstate.stdp, k)))
    for k in convert.GUARD_LEAVES:
        got, want = leaves["guard"][k], np.asarray(getattr(jstate.guard, k))
        assert got.dtype == want.dtype and np.array_equal(got, want), k
