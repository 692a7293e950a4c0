"""The Izhikevich neuron option of the port (``core/neuron.py``:
``IzhState``, ``izh_init``, ``izhikevich_step``) against the reference's
``repro.core.neuron`` compiled by XLA on the CPU (``jax.jit``, one
subprocess for the module, started in the background): RS and FS
neurons under random currents, 200 steps at dt = 1, 0.5 and 0.1, every
step's v, u and spikes to the bit (the port writes XLA's fused
multiply-adds with ``kernels/ref.py::_fma``); called op by op, as the
reference's own test calls it, the reference rounds each product apart
and agrees within a stated tolerance. Also the reference's
``test_izhikevich_rs_fs``."""
import numpy as np
import pytest
import torch
from _jax_background import JaxInBackground

from repro_torch.core import neuron as N


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SHAPE, STEPS, SEED = (3, 16, 64), 200, 11
DTS = (1.0, 0.5, 0.1)
EAGER_STEPS = 20

JAX_IZH = """
import jax, jax.numpy as jnp, numpy as np
from repro.core import neuron as N
rng = np.random.default_rng({seed})
inh = rng.random({shape}) < 0.2
cur = (rng.random(({steps},) + {shape}) * 20 - 2).astype(np.float32)
np.savez('{out}/inputs', inh=inh, cur=cur)
for dt in {dts!r}:
    for mode in ('jit', 'eager'):
        f = (jax.jit(N.izhikevich_step, static_argnums=3) if mode == 'jit'
             else N.izhikevich_step)
        n = {steps} if mode == 'jit' else {eager_steps}
        s = N.izh_init({shape}, jnp.asarray(inh))
        out = dict(v0=np.asarray(s.v), u0=np.asarray(s.u), v=[], u=[], spk=[])
        for t in range(n):
            s, spk = f(s, jnp.asarray(cur[t]), jnp.asarray(inh), dt)
            out['v'].append(np.asarray(s.v))
            out['u'].append(np.asarray(s.u))
            out['spk'].append(np.asarray(spk))
        np.savez('{out}/%s_%g' % (mode, dt), **{{k: np.asarray(x)
                                                 for k, x in out.items()}})
print('OK')
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_izh")
    job = JaxInBackground(JAX_IZH.format(seed=SEED, shape=SHAPE, steps=STEPS,
                                         dts=DTS, eager_steps=EAGER_STEPS,
                                         out=out), timeout=600)
    yield out, job
    job.stop()


@pytest.fixture(scope="module")
def jax_izh(jax_started):
    out, job = jax_started
    assert "OK" in job.result()
    runs = {name: dict(np.load(out / f"{name}.npz"))
            for name in [f"{m}_{dt:g}" for m in ("jit", "eager")
                         for dt in DTS]}
    return dict(np.load(out / "inputs.npz")), runs


def port_run(inputs, dt, steps):
    inh = torch.from_numpy(inputs["inh"])
    s = N.izh_init(SHAPE, inh)
    s0 = s
    vs, us, spks = [], [], []
    for t in range(steps):
        s, spk = N.izhikevich_step(s, torch.from_numpy(inputs["cur"][t]), inh,
                                   dt)
        vs.append(s.v)
        us.append(s.u)
        spks.append(spk)
    return s0, torch.stack(vs), torch.stack(us), torch.stack(spks)


@pytest.mark.parametrize("dt", DTS)
def test_izhikevich_equals_the_jitted_reference_bitwise(jax_izh, dt):
    """Every step's v, u and spikes of RS and FS neurons, over a (3, 16,
    64) leading shape, to the bit; the initial state too."""
    inputs, runs = jax_izh
    want = runs[f"jit_{dt:g}"]
    s0, v, u, spk = port_run(inputs, dt, STEPS)
    np.testing.assert_array_equal(s0.v.numpy(), want["v0"])
    np.testing.assert_array_equal(s0.u.numpy(), want["u0"])
    assert spk.sum() > 0 and spk.dtype == torch.float32
    np.testing.assert_array_equal(spk.numpy(), want["spk"])
    np.testing.assert_array_equal(v.numpy(), want["v"])
    np.testing.assert_array_equal(u.numpy(), want["u"])


@pytest.mark.parametrize("dt", DTS)
def test_izhikevich_step_near_the_op_by_op_reference(jax_izh, dt):
    """The reference called op by op rounds ``0.04*v*v + 5*v`` and
    ``b*v - u`` apart, where XLA's compiled step and the port fuse them.
    One port step from each of the op-by-op run's first 20 states equals
    its next state within 1e-4 mV (13 float32 ulps at 65 mV: one rounding
    moved inside the two half-steps and the recovery update), spikes
    equal."""
    inputs, runs = jax_izh
    want = runs[f"eager_{dt:g}"]
    inh = torch.from_numpy(inputs["inh"])
    v = np.concatenate([want["v0"][None], want["v"][:-1]])
    u = np.concatenate([want["u0"][None], want["u"][:-1]])
    for t in range(EAGER_STEPS):
        s, spk = N.izhikevich_step(
            N.IzhState(torch.from_numpy(v[t]), torch.from_numpy(u[t])),
            torch.from_numpy(inputs["cur"][t]), inh, dt)
        np.testing.assert_array_equal(spk.numpy(), want["spk"][t])
        np.testing.assert_allclose(s.v.numpy(), want["v"][t], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(s.u.numpy(), want["u"][t], rtol=0,
                                   atol=1e-4)


def test_izhikevich_rs_fs():
    """The reference's own test: FS (inhibitory) fires faster than RS
    under the same drive."""
    inh = torch.tensor([[False, True]])
    s = N.izh_init((1, 2), inh)
    spikes = torch.zeros(2)
    for _ in range(200):
        s, spk = N.izhikevich_step(s, torch.full((1, 2), 10.0), inh)
        spikes = spikes + spk[0]
    assert float(spikes[1]) > float(spikes[0]) > 0


def test_izhikevich_keeps_its_dtype_and_device():
    """A float64 state stays float64; every leaf lives on the inputs'
    device."""
    inh = torch.tensor([False, True, False])
    s = N.izh_init((3,), inh, dtype=torch.float64)
    s, spk = N.izhikevich_step(s, torch.full((3,), 40.0, dtype=torch.float64),
                               inh)
    assert s.v.dtype == s.u.dtype == spk.dtype == torch.float64
    assert s.v.device == inh.device
