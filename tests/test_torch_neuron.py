"""The port's LIF+SFA step against the JAX reference's jitted
``lif_sfa_step`` on the same numpy-seeded states: spikes, adaptation and
refractory counters equal, v within 1e-5 and, since the plain version
groups its multiply-adds as XLA does, equal to the bit on these inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import NeuronConfig as JNeuronConfig
from repro.core import neuron as jneuron
from repro_torch.configs.base import NeuronConfig
from repro_torch.core import neuron, prng


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _states(seed, n):
    rng = np.random.default_rng(seed)
    v = rng.uniform(0, 21, n).astype(np.float32)
    c = rng.uniform(0, 3, n).astype(np.float32)
    r = rng.integers(0, 3, n).astype(np.int32)
    cur = (rng.standard_normal(n) * 2).astype(np.float32)
    return v, c, r, cur


@pytest.mark.parametrize("seed,n", [(0, 65_536), (1, 1240), (2, 77)])
def test_lif_sfa_step_matches_reference(seed, n):
    v, c, r, cur = _states(seed, n)
    jstep = jax.jit(lambda s, i: jneuron.lif_sfa_step(JNeuronConfig(), s, i))
    jst, jspk = jstep(jneuron.LIFState(jnp.asarray(v), jnp.asarray(c),
                                       jnp.asarray(r)), jnp.asarray(cur))
    st, spk = neuron.lif_sfa_step(
        NeuronConfig(),
        neuron.LIFState(torch.from_numpy(v), torch.from_numpy(c),
                        torch.from_numpy(r)),
        torch.from_numpy(cur))
    np.testing.assert_array_equal(spk.numpy(), np.asarray(jspk))
    np.testing.assert_array_equal(st.c.numpy(), np.asarray(jst.c))
    np.testing.assert_array_equal(st.refrac.numpy(), np.asarray(jst.refrac))
    np.testing.assert_allclose(st.v.numpy(), np.asarray(jst.v),
                               rtol=0, atol=1e-5)
    # the FMA grouping makes it exact on these inputs
    np.testing.assert_array_equal(st.v.numpy(), np.asarray(jst.v))
    assert st.refrac.dtype == torch.int32 and spk.dtype == torch.float32


def test_lif_trajectory_matches_reference():
    """100 steps fed the same currents: the state stays equal throughout."""
    rng = np.random.default_rng(5)
    v, c, r, _ = _states(5, 4096)
    curs = (rng.standard_normal((100, 4096)) * 3 + 1).astype(np.float32)
    jstep = jax.jit(lambda s, i: jneuron.lif_sfa_step(JNeuronConfig(), s, i))
    js = jneuron.LIFState(jnp.asarray(v), jnp.asarray(c), jnp.asarray(r))
    ts = neuron.LIFState(torch.from_numpy(v), torch.from_numpy(c),
                         torch.from_numpy(r))
    jtot = ttot = 0.0
    for cur in curs:
        js, jspk = jstep(js, jnp.asarray(cur))
        ts, tspk = neuron.lif_sfa_step(NeuronConfig(), ts,
                                       torch.from_numpy(cur))
        jtot += float(jspk.sum())
        ttot += float(tspk.sum())
    assert jtot == ttot > 0
    np.testing.assert_array_equal(ts.c.numpy(), np.asarray(js.c))
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), rtol=0,
                               atol=1e-5)


def test_lif_init():
    """Keyed potentials equal the reference's ``lif_init`` to the bit and
    lie in [rest, 0.95 * threshold), also with a nonzero rest (the draw's
    multiply-add fused as XLA fuses it); a batch of keys stacks one state
    per key; without a key every potential is at rest."""
    for kw in ({}, dict(v_rest=-3.7)):
        cfg = NeuronConfig(**kw)
        st = neuron.lif_init(cfg, (3, 50), key=prng.prng_key(0))
        jst = jneuron.lif_init(JNeuronConfig(**kw), (3, 50), jnp.float32,
                               jax.random.PRNGKey(0))
        np.testing.assert_array_equal(st.v.numpy(), np.asarray(jst.v))
        assert float(st.v.min()) >= cfg.v_rest
        assert float(st.v.max()) < cfg.v_threshold * 0.95
        assert st.refrac.dtype == torch.int32
        assert int(st.refrac.abs().sum()) == 0
    keys = prng.fold_in(prng.prng_key(5), torch.arange(4))
    batch = neuron.lif_init(cfg, (50,), key=keys)
    assert batch.v.shape == batch.c.shape == batch.refrac.shape == (4, 50)
    assert torch.equal(batch.v[2], neuron.lif_init(cfg, (50,),
                                                   key=keys[2]).v)
    flat = neuron.lif_init(cfg, (4,))
    assert bool((flat.v == cfg.v_rest).all())
