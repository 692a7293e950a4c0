"""The port's batched multi-tenant engine (``repro_torch.core.batched``)
against the JAX reference's (tests/test_batched_service.py), one case for
each of the reference's single-shard ones: the B = 1 guarantee under the
three impls, static and plastic; ``nu_scale = 1`` neutrality; batch-mate
independence at B = 3; the raster against the counters; and the early
exit and freeze of ``run_chunk``.

Both sides run ``reduced(4, 4, 32)`` on the reference's own network
(carried across with ``repro_torch.convert``; the port's truncated-normal
weights may differ from it in the last bits), each tenant's state and
drive drawn by each side from the tenant's seed. Each reference result is
computed once per module. The bar: spikes, history, counters, refractory
and adaptation state, STDP traces, plastic weights, the raster,
``steps_left`` and ``steps_taken`` to the bit; v within 2e-4 (the bar of
tests/test_torch_simulation.py). Each port slot is also held to the
port's own dedicated run ``simulation.run(seed=, nu_scale=)``, all leaves
to the bit. On the CPU the kernels' wrappers run their plain versions."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dpsnn as JD
from repro.core import batched as jbatched
from repro.core import simulation as jsim
from repro_torch import convert
from repro_torch.configs import dpsnn as D
from repro_torch.configs.base import GuardConfig
from repro_torch.core import batched
from repro_torch.core import network as net
from repro_torch.core import simulation as sim
from repro_torch.core.network import IMPLS


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(stdp=False, seed=42, **kw):
    """The reference's config and the port's, equal field by field."""
    return (JD.reduced(4, 4, 32, seed=seed, stdp=stdp, **kw),
            D.reduced(4, 4, 32, seed=seed, stdp=stdp, **kw))


def _params(jparams):
    """The reference's network as the port's, on the CPU."""
    return convert.params_from_numpy(
        **{k: np.asarray(getattr(jparams, k)) for k in convert.PARAM_LEAVES},
        device="cpu")


def _leaves(state):
    """The state's leaves by name (``v``, ``c``, ``refrac``, ``hist``,
    ``t``, the counters, the traces and the guard's), as numpy."""
    out = dict(v=state.lif.v, c=state.lif.c, refrac=state.lif.refrac,
               hist=state.hist, t=state.t, spike_count=state.spike_count,
               event_count=state.event_count)
    for sub in (state.stdp, state.guard):
        if sub is not None:
            out.update(sub._asdict())
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def assert_slot_matches(got, want, b=None, jb=None):
    """Port state ``got`` (slot ``b`` of a batch, or a single state)
    against the reference's ``want`` (slot ``jb``): every leaf to the bit,
    v within 2e-4."""
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    for name in g:
        x = g[name] if b is None else g[name][b]
        y = w[name] if jb is None else w[name][jb]
        if name == "v":
            np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-4)
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)


def assert_slot_bitwise(got, b, want, wb=None):
    """Slot ``b`` of a port batch against a port single-tenant state (or
    slot ``wb`` of another batch): every leaf to the bit."""
    g, w = _leaves(got), _leaves(want)
    for name in g:
        np.testing.assert_array_equal(
            g[name][b], w[name] if wb is None else w[name][wb],
            err_msg=name)


def dedicated(cfg, params, seed, n_steps, impl, nu_scale=None):
    """The port's single-tenant run of tenant ``seed``: the network of
    ``params``, state and drive from ``seed``."""
    _, state = sim.build(cfg, device="cpu", seed=seed)
    return sim.run(cfg, params, state, n_steps, impl=impl, seed=seed,
                   nu_scale=nu_scale)


B1_STEPS, B3_STEPS, NU_STEPS = 25, 20, 12
B3_SEEDS = (42, 49, -5)        # cfg.seed, cfg.seed + 7 and a negative seed
B3_NU = (1.0, 0.8, 1.5)        # each B3 tenant's stimulus scaling


@pytest.fixture(scope="module")
def reference():
    """The reference's runs, each computed once: ``reference(name,
    stdp)`` for name in ``b1`` (its ``run_batched`` of one slot, seed
    cfg.seed), ``b3`` (B3_SEEDS), ``b3nu`` (B3_SEEDS at ``nu_scale``
    B3_NU, NU_STEPS) and ``chunk`` (``run_chunk`` of two slots with 7
    and 15 steps left, chunk 64)."""
    cache = {}

    def get(name, stdp=False):
        key = (name, stdp)
        if key not in cache:
            jcfg, _ = _pair(stdp=stdp)
            jparams, _ = jsim.build(jcfg)
            if name == "b1":
                seeds = jnp.array([jcfg.seed], jnp.int32)
                out = jbatched.run_batched(
                    jcfg, jbatched.batch_params(jcfg, jparams, 1),
                    jbatched.init_tenants(jcfg, seeds), seeds, B1_STEPS)
            elif name == "b3":
                seeds = jnp.array(B3_SEEDS, jnp.int32)
                out = jbatched.run_batched(
                    jcfg, jbatched.batch_params(jcfg, jparams, 3),
                    jbatched.init_tenants(jcfg, seeds), seeds, B3_STEPS)
            elif name == "b3nu":
                seeds = jnp.array(B3_SEEDS, jnp.int32)
                out = jbatched.run_batched(
                    jcfg, jparams, jbatched.init_tenants(jcfg, seeds), seeds,
                    NU_STEPS, nu_scale=jnp.array(B3_NU, jnp.float32))
            else:
                seeds = jnp.array([jcfg.seed, jcfg.seed + 1], jnp.int32)
                out = jbatched.run_chunk(
                    jcfg, jparams, jbatched.init_tenants(jcfg, seeds), seeds,
                    jnp.array([7, 15], jnp.int32), 64, "ref")
            cache[key] = (jparams, out)
        return cache[key]
    return get


def test_init_tenants_equals_the_reference():
    jcfg, cfg = _pair()
    seeds = [42, 7, -5]
    want = jbatched.init_tenants(jcfg, jnp.array(seeds, jnp.int32))
    got = batched.init_tenants(cfg, seeds, device="cpu")
    g, w = _leaves(got), _leaves(want)
    for name in g:
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    assert got.t.dtype == torch.int32 and got.t.shape == (3,)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("stdp", [False, True])
def test_b1_bitwise_equals_single_tenant(reference, impl, stdp):
    """One slot of seed cfg.seed: the reference's one-slot batch to its
    bar, and the port's own ``simulation.run`` to the bit, plastic
    weights included."""
    jparams, jout = reference("b1", stdp)
    _, cfg = _pair(stdp=stdp)
    params = _params(jparams)
    out = batched.run_batched(cfg, batched.batch_params(cfg, params, 1),
                              batched.init_tenants(cfg, [cfg.seed], "cpu"),
                              [cfg.seed], B1_STEPS, impl)
    assert out.steps_taken == int(jout.steps_taken) == B1_STEPS
    assert_slot_matches(out.state, jout.state)
    np.testing.assert_array_equal(out.raster.numpy(), np.asarray(jout.raster))
    ref = dedicated(cfg, params, cfg.seed, B1_STEPS, impl)
    assert_slot_bitwise(out.state, 0, ref.state)
    if stdp:
        for leaf in ("w_local", "rem_w"):
            got = getattr(out.params, leaf)[0]
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(getattr(jout.params, leaf))[0])
            assert torch.equal(got, getattr(ref.params, leaf))
    else:
        assert out.params is params      # static: the one shared copy


def test_b1_nu_scale_one_is_bitwise_neutral(reference):
    """``nu_scale = 1.0`` multiplies the rate by exactly 1: the same bits
    as no scaling, and as the reference's slot."""
    jparams, jout = reference("b1")
    _, cfg = _pair()
    params = _params(jparams)
    seeds = [cfg.seed]
    runs = [batched.run_batched(cfg, params,
                                batched.init_tenants(cfg, seeds, "cpu"),
                                seeds, B1_STEPS, "cuda_fused", nu_scale=nu)
            for nu in (None, [1.0])]
    assert_slot_bitwise(runs[1].state, 0, runs[0].state, 0)
    assert_slot_matches(runs[1].state, jout.state)


@pytest.mark.parametrize("stdp", [False, True])
def test_tenants_independent_of_batch_mates(reference, stdp):
    """Each slot of a B = 3 batch (a negative seed among them) equals the
    reference's slot, and the port's dedicated run of its tenant to the
    bit, plastic weights included."""
    jparams, jout = reference("b3", stdp)
    _, cfg = _pair(stdp=stdp)
    params = _params(jparams)
    out = batched.run_batched(cfg, batched.batch_params(cfg, params, 3),
                              batched.init_tenants(cfg, B3_SEEDS, "cpu"),
                              B3_SEEDS, B3_STEPS, "cuda_fused")
    np.testing.assert_array_equal(out.raster.numpy(), np.asarray(jout.raster))
    for b, seed in enumerate(B3_SEEDS):
        assert_slot_matches(out.state, jout.state, b, b)
        ref = dedicated(cfg, params, seed, B3_STEPS, "cuda_fused")
        assert_slot_bitwise(out.state, b, ref.state)
        if stdp:
            for leaf in ("w_local", "rem_w"):
                got = getattr(out.params, leaf)[b]
                np.testing.assert_array_equal(
                    got.numpy(), np.asarray(getattr(jout.params, leaf))[b])
                assert torch.equal(got, getattr(ref.params, leaf))


def test_tenants_with_their_own_rates(reference):
    """Per-tenant ``nu_scale`` B3_NU under the three impls: each slot
    equals the reference's slot at that rate (the raster to the bit) and
    its dedicated run at that rate to the bit, the three impls give the
    same bits, and the rates differ."""
    jparams, jout = reference("b3nu")
    _, cfg = _pair()
    params = _params(jparams)
    outs = [batched.run_batched(cfg, params,
                                batched.init_tenants(cfg, B3_SEEDS, "cpu"),
                                B3_SEEDS, NU_STEPS, impl, nu_scale=B3_NU)
            for impl in IMPLS]
    for out in outs:
        np.testing.assert_array_equal(out.raster.numpy(),
                                      np.asarray(jout.raster))
        for b in range(3):
            assert_slot_matches(out.state, jout.state, b, b)
            assert_slot_bitwise(out.state, b, outs[0].state, b)
    for b, (seed, nu) in enumerate(zip(B3_SEEDS, B3_NU)):
        ref = dedicated(cfg, params, seed, NU_STEPS, "ref", nu_scale=nu)
        assert_slot_bitwise(outs[0].state, b, ref.state)
    events = outs[0].state.event_count
    assert float(events[1]) < float(events[0]) < float(events[2])


def test_raster_totals_match_counters(reference):
    _, jout = reference("b3")
    _, cfg = _pair()
    out = batched.run_batched(cfg, _params(reference("b3")[0]),
                              batched.init_tenants(cfg, B3_SEEDS, "cpu"),
                              B3_SEEDS, B3_STEPS, "ref")
    per_raster = out.raster.sum(dim=(0, 2, 3)).to(torch.float32)
    assert torch.equal(per_raster, out.state.spike_count)
    np.testing.assert_array_equal(per_raster.numpy(),
                                  np.asarray(jout.raster).sum(axis=(0, 2, 3)))


@pytest.mark.parametrize("impl", IMPLS)
def test_run_chunk_freezes_finished_slots_and_exits_early(reference, impl):
    """Two slots with 7 and 15 steps left, chunk 64: 15 loop steps, not
    64, both at 0 left, the raster as the reference's, and the slot that
    finished first frozen at its dedicated run's 7-step state."""
    jparams, jout = reference("chunk")
    _, cfg = _pair()
    params = _params(jparams)
    seeds = [cfg.seed, cfg.seed + 1]
    out = batched.run_chunk(cfg, params,
                            batched.init_tenants(cfg, seeds, "cpu"), seeds,
                            [7, 15], 64, impl)
    assert out.steps_taken == int(jout.steps_taken) == 15
    assert out.steps_left.tolist() == np.asarray(jout.steps_left).tolist() \
        == [0, 0]
    np.testing.assert_array_equal(out.raster.numpy(), np.asarray(jout.raster))
    for b, (seed, n_steps) in enumerate(zip(seeds, [7, 15])):
        assert_slot_matches(out.state, jout.state, b, b)
        assert_slot_bitwise(out.state, b,
                            dedicated(cfg, params, seed, n_steps, impl).state)


@pytest.mark.parametrize("guard", [False, True])
def test_run_chunk_host_steps_equal_the_states(guard):
    """Over random ``steps_left`` of four slots, free slots among them,
    and random chunk lengths, unguarded and guarded: ``steps_taken`` and
    ``host_steps_left`` (what the host knows without reading the card
    when unguarded) are the loop's own count and its ``steps_left``."""
    _, cfg = _pair()
    if guard:
        cfg = dataclasses.replace(cfg, guard=GuardConfig(enabled=True))
    params, _ = sim.build(cfg, device="cpu")
    seeds = [cfg.seed, 3, 4, 5]
    bp = batched.batch_params(cfg, params, 4)
    st = batched.init_tenants(cfg, seeds, "cpu")
    gen = torch.Generator().manual_seed(7)
    for _ in range(4):
        left = torch.randint(0, 12, (4,), generator=gen, dtype=torch.int32)
        left[int(torch.randint(0, 4, (1,), generator=gen))] = 0
        chunk = int(torch.randint(1, 10, (1,), generator=gen))
        t0 = st.t.clone()
        out = batched.run_chunk(cfg, bp, st, seeds, left, chunk)
        assert torch.equal(out.host_steps_left, out.steps_left)
        ran = out.state.t - t0
        assert torch.equal(left - ran, out.steps_left), (left, chunk)
        assert out.steps_taken == int(ran.max()), (left, chunk)
        bp, st = out.params, out.state


def test_plastic_freeze_keeps_a_finished_tenants_weights():
    """Under STDP a slot that finishes first keeps its weights and traces,
    bitwise its dedicated run's, through its batch-mate's later steps
    (the STDP kernels' ``active`` pass-through)."""
    _, cfg = _pair(stdp=True)
    params, _ = sim.build(cfg, device="cpu")
    seeds = [cfg.seed, 3]
    for impl in IMPLS:
        out = batched.run_chunk(cfg, batched.batch_params(cfg, params, 2),
                                batched.init_tenants(cfg, seeds, "cpu"),
                                seeds, [5, 12], 16, impl)
        assert out.steps_taken == 12
        for b, (seed, n_steps) in enumerate(zip(seeds, [5, 12])):
            ref = dedicated(cfg, params, seed, n_steps, impl)
            assert_slot_bitwise(out.state, b, ref.state)
            assert torch.equal(out.params.w_local[b], ref.params.w_local)
            assert torch.equal(out.params.rem_w[b], ref.params.rem_w)


def test_insert_tenant_recycles_one_slot():
    """A fresh tenant in slot 1: that row is its ``init_state``, the
    others as they were, the input state untouched; under STDP the slot's
    weights are reset to the fresh network's."""
    _, cfg = _pair(stdp=True)
    params, _ = sim.build(cfg, device="cpu")
    bparams = batched.batch_params(cfg, params, 2)
    out = batched.run_batched(cfg, bparams,
                              batched.init_tenants(cfg, [1, 2], "cpu"),
                              [1, 2], 4, "ref")
    p2, s2 = batched.insert_tenant(cfg, out.params, out.state, 1, 9,
                                   fresh_params=params)
    assert_slot_bitwise(s2, 0, out.state, 0)
    _, fresh = sim.build(cfg, device="cpu", seed=9)
    assert_slot_bitwise(s2, 1, fresh)
    assert int(out.state.t[1]) == 4
    assert torch.equal(p2.w_local[1], params.w_local)
    assert not torch.equal(p2.w_local[0], params.w_local)


def test_convert_carries_the_reference_tenants(reference):
    """The reference's plastic B = 3 batch after 20 steps (per-tenant
    weights, state, traces) across to the port and back, to the bit,
    the step counters on the device; one more step from it under the
    port's engine equals one from the port's own batch of those steps
    in spikes and the ring."""
    jparams, jout = reference("b3", True)
    _, cfg = _pair(stdp=True)
    leaves = _leaves(jout.state)
    state = convert.tenants_state_from_numpy(
        **{k: leaves[k] for k in convert.STATE_LEAVES},
        stdp={k: leaves[k] for k in convert.STDP_LEAVES}, device="cpu")
    params = convert.params_from_numpy(
        **{k: np.asarray(getattr(jout.params, k))
           for k in convert.PARAM_LEAVES}, device="cpu")
    assert state.t.shape == (3,) and params.w_local.shape[0] == 3
    back = convert.state_to_numpy(state)
    for k in convert.STATE_LEAVES:
        np.testing.assert_array_equal(back[k], leaves[k], err_msg=k)
    for k, v in convert.params_to_numpy(params).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jout.params, k)))
    own = batched.run_batched(cfg, batched.batch_params(
        cfg, _params(jparams), 3), batched.init_tenants(cfg, B3_SEEDS, "cpu"),
        B3_SEEDS, B3_STEPS, "cuda_fused")
    got, want = (batched.run_batched(cfg, p, s, B3_SEEDS, 1, "cuda_fused")
                 for p, s in ((params, state), (own.params, own.state)))
    assert torch.equal(got.state.hist, want.state.hist)
    assert torch.equal(got.state.spike_count, want.state.spike_count)


def test_rate_ten_or_more_is_refused():
    """Knuth's branch only: a rate of 10 or more per step is refused,
    never drawn on another branch."""
    _, cfg = _pair()
    lam = net.drive_rate(cfg)
    nu = 10.0 / lam
    with pytest.raises(NotImplementedError, match="Knuth"):
        batched.tenant_rates(cfg, [1.0, nu], 2)
    assert batched.tenant_rates(cfg, [1.0, 0.99 * nu], 2)[1] < 10.0


def test_batched_step_off_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the raise is for a host "
                    "without one")
    _, cfg = _pair()
    with pytest.raises(RuntimeError, match="cuda"):
        batched.init_tenants(cfg, [1, 2])
    with pytest.raises(ValueError, match="unknown impl"):
        batched.make_batched_step(dataclasses.replace(cfg), impl="pallas")
