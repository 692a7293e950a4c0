"""The port's in-band integrity guard against the JAX reference's
(tests/test_integrity.py): trip codes and the first-trip latch,
bitwise neutrality on healthy runs (guard on against guard off, static
and plastic, plain and fused), a NaN caught within the step it is
injected, the spike ceiling, the guard-off state carrying no guard, the
fused kernel's flags standing in for the check of ``v``, and the port's
GuardState after a run equal to the reference's on the same network and
drive."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_simulation import _carry, _jax_drive

from repro.configs import dpsnn as JD
from repro.configs.base import GuardConfig as JGuard
from repro.core import simulation as jsim
from repro.runtime import integrity as jintegrity
from repro_torch.configs import dpsnn as D
from repro_torch.configs.base import GuardConfig
from repro_torch.core import simulation as sim
from repro_torch.runtime import integrity
from repro_torch.runtime.integrity import (TRIP_AER_SAT, TRIP_BOUNDS,
                                           TRIP_NAN, TRIP_SPIKES,
                                           guard_update, init_guard)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(stdp=False, guard=None, seed=42):
    cfg = D.reduced(4, 4, 32, seed=seed, stdp=stdp)
    if guard is not None:
        cfg = dataclasses.replace(cfg, guard=guard)
    return cfg


def test_trip_codes_are_the_reference_codes():
    for name in ("TRIP_NAN", "TRIP_BOUNDS", "TRIP_SPIKES", "TRIP_AER_SAT",
                 "TRIP_CHECKSUM", "GUARD_EXIT_CODE"):
        assert getattr(integrity, name) == getattr(jintegrity, name), name
    for code in range(32):
        assert integrity.describe_code(code) == \
            jintegrity.describe_code(code)


def _i32(x):
    return torch.tensor(x, dtype=torch.int32)


def test_guard_update_latches_first_trip_and_escalates_aer():
    gcfg = GuardConfig(enabled=True, aer_sat_trip_steps=3)
    gs = init_guard()
    # two saturated steps: flagged run, not tripped
    for t in range(2):
        gs = guard_update(gcfg, gs, step_code=_i32(0), t=t,
                          aer_sat=torch.tensor(True))
    assert not bool(gs.tripped) and int(gs.sat_run) == 2
    # a clean step resets the run
    gs = guard_update(gcfg, gs, step_code=_i32(0), t=2,
                      aer_sat=torch.tensor(False))
    assert int(gs.sat_run) == 0
    # three consecutive: trips, latching code and step
    for t in range(3, 6):
        gs = guard_update(gcfg, gs, step_code=_i32(0), t=t,
                          aer_sat=torch.tensor(True))
    assert bool(gs.tripped)
    assert int(gs.trip_code) == TRIP_AER_SAT and int(gs.trip_step) == 5
    # later verdicts do not overwrite the first-trip latch
    gs = guard_update(gcfg, gs, step_code=_i32(TRIP_NAN), t=6,
                      aer_sat=torch.tensor(False))
    assert int(gs.trip_code) == TRIP_AER_SAT and int(gs.trip_step) == 5
    assert [x.dtype for x in gs] == [torch.bool] + [torch.int32] * 4


def test_step_verdict_kernel_flags_stand_in_for_v():
    gcfg = GuardConfig(enabled=True)
    v = torch.zeros(3, 40)
    v[0, 4], v[2, 9] = float("nan"), -1e4
    spikes = torch.zeros(3, 40)
    flags = torch.tensor([1, 0, 2], dtype=torch.int32)
    want = TRIP_NAN | TRIP_BOUNDS
    assert int(integrity.step_verdict(gcfg, v=v, spikes=spikes)) == want
    assert int(integrity.step_verdict(gcfg, v=torch.zeros(3, 40),
                                      spikes=spikes,
                                      kernel_flags=flags)) == want
    tr = torch.zeros(3, 40)
    tr[1, 1] = float("inf")
    assert int(integrity.step_verdict(gcfg, v=torch.zeros(3, 40),
                                      spikes=spikes, x_pre=tr)) == TRIP_NAN
    assert int(integrity.step_verdict(
        gcfg, v=torch.zeros(3, 40), spikes=torch.ones(3, 40))) == TRIP_SPIKES


@pytest.mark.parametrize("impl", ["ref", "cuda_fused"])
@pytest.mark.parametrize("stdp", [False, True])
def test_guard_on_is_bitwise_neutral(impl, stdp):
    """Healthy run, guard on against off: identical spikes, events,
    history and weights, and no trip."""
    n_steps = 25
    cfg0 = _cfg(stdp=stdp)
    params, state = sim.build(cfg0, device="cpu")
    off = sim.run(cfg0, params, state, n_steps, impl=impl)
    cfg1 = _cfg(stdp=stdp, guard=GuardConfig(enabled=True))
    params1, state1 = sim.build(cfg1, device="cpu")
    on = sim.run(cfg1, params1, state1, n_steps, impl=impl)
    assert float(on.spikes) == float(off.spikes) > 0
    assert float(on.events) == float(off.events)
    assert torch.equal(on.state.hist, off.state.hist)
    assert torch.equal(on.params.w_local, off.params.w_local)
    assert torch.equal(on.params.rem_w, off.params.rem_w)
    g = on.state.guard
    assert not bool(g.tripped)
    assert int(g.trip_step) == -1 and int(g.checksum_fails) == 0
    assert off.state.guard is None


def test_default_config_carries_no_guard_state():
    cfg = _cfg()
    assert not cfg.guard.enabled
    _, state = sim.build(cfg, device="cpu")
    assert state.guard is None and state.stdp is None


@pytest.mark.parametrize("impl", ["ref", "cuda", "cuda_fused"])
@pytest.mark.parametrize("stdp", [False, True])
def test_nan_injection_detected_same_step(impl, stdp):
    cfg = _cfg(stdp=stdp, guard=GuardConfig(enabled=True,
                                            chaos_nan_at_step=7))
    params, state = sim.build(cfg, device="cpu")
    res = sim.run(cfg, params, state, 20, impl=impl)
    g = res.state.guard
    assert bool(g.tripped)
    assert int(g.trip_code) & TRIP_NAN
    assert int(g.trip_step) == 7, \
        "NaN must be detected within the step it occurs"
    assert integrity.guard_report(g)["guard_trip_step"] == 7


def test_spike_ceiling_trips():
    cfg = _cfg(guard=GuardConfig(enabled=True, max_spike_fraction=0.0))
    params, state = sim.build(cfg, device="cpu")
    res = sim.run(cfg, params, state, 30, impl="ref")
    g = res.state.guard
    assert bool(g.tripped) and int(g.trip_code) & TRIP_SPIKES
    assert int(g.trip_step) >= 0


@pytest.mark.parametrize("impl", ["ref", "cuda_fused"])
@pytest.mark.parametrize("chaos", [-1, 7])
def test_guard_state_matches_reference(chaos, impl):
    """The reference's network, state and drive carried across: after 25
    plastic guarded steps the port's GuardState leaves equal the
    reference's, a NaN at step 7 or none."""
    gkw = dict(enabled=True, chaos_nan_at_step=chaos)
    jcfg = dataclasses.replace(JD.reduced(4, 4, 32, seed=42, stdp=True),
                               guard=JGuard(**gkw))
    cfg = _cfg(stdp=True, guard=GuardConfig(**gkw))
    jparams, jstate = jsim.build(jcfg)
    jres = jsim.run(jcfg, jparams, jstate, 25, impl="ref")
    params, state = _carry(jparams, jstate)
    res = sim.run(cfg, params, state, 25, impl=impl,
                  ext_counts=torch.from_numpy(_jax_drive(jcfg, 25)))
    for name in integrity.GuardState._fields:
        got = getattr(res.state.guard, name).numpy()
        want = np.asarray(getattr(jres.state.guard, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert bool(jnp.asarray(jres.state.guard.tripped)) == (chaos == 7)
    if chaos < 0:
        assert float(res.spikes) == float(jres.spikes)
