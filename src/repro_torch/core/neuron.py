"""Point-neuron dynamics (the port of ``repro/core/neuron.py``).

* :func:`lif_sfa_step`: Leaky Integrate-and-Fire with spike-frequency
  adaptation via a Ca-dependent AHP current (Gigante, Mattia, Del
  Giudice 2007), the configuration measured in the 2015 scaling paper.
  Exponential-Euler decay, over any leading batch shape. The arithmetic
  is the one of ``kernels/ref.py::lif_step_ref``, shared with the
  kernels' plain versions.
* :func:`izhikevich_step`: RS (excitatory) / FS (inhibitory) Izhikevich
  neurons, the EURETILE-era DPSNN configuration, kept as an option off
  the main path (no network option selects it, and it has no kernel).
  Its multiply-adds are grouped as XLA's CPU backend fuses the
  reference's (``kernels/ref.py::_fma``), so a jitted reference step and
  this one agree to the bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import NeuronConfig
from repro_torch.core import prng
from repro_torch.kernels.ref import _fma, lif_constants, lif_step_ref


class LIFState(NamedTuple):
    """State of LIF+SFA neurons. All leaves share the same shape."""
    v: torch.Tensor          # membrane potential
    c: torch.Tensor          # adaptation (Ca) variable
    refrac: torch.Tensor     # refractory countdown (steps, int32)


def lif_init(cfg: NeuronConfig, shape, dtype=torch.float32, key=None, *,
             device="cpu") -> LIFState:
    """Fresh state; with a ``key`` (``core/prng.py``) potentials start
    ``uniform`` in [rest, 0.95 * threshold), as the reference draws them.
    A batch of keys ``(..., 2)`` draws one state per key, stacked in front
    of ``shape``, on the keys' device."""
    if key is not None:
        if dtype != torch.float32:
            raise NotImplementedError(f"lif_init: keyed draws are float32, "
                                      f"not {dtype}")
        v = prng.uniform(key, shape, cfg.v_rest, cfg.v_threshold * 0.95)
    else:
        v = torch.full(shape, cfg.v_rest, dtype=dtype, device=device)
    return LIFState(
        v=v,
        c=torch.zeros_like(v),
        refrac=torch.zeros(v.shape, dtype=torch.int32, device=v.device),
    )


def lif_sfa_step(cfg: NeuronConfig, state: LIFState, current: torch.Tensor):
    """One dt of LIF+SFA dynamics; returns ``(new_state, spikes)`` with
    float 0/1 spikes in the state dtype."""
    v, c, refrac, spikes = lif_step_ref(
        state.v, state.c, state.refrac, current,
        **lif_constants(cfg, state.v.dtype))
    return LIFState(v=v, c=c, refrac=refrac), spikes


class IzhState(NamedTuple):
    """State of Izhikevich neurons: potential and recovery variable."""
    v: torch.Tensor
    u: torch.Tensor


IZH_RESET = -65.0     # mV: rest, and c of RS and FS neurons alike


def _izh_param(is_inhibitory: torch.Tensor, fs: float, rs: float, dtype):
    """A parameter of FS (inhibitory) and RS (excitatory) neurons."""
    return torch.where(is_inhibitory, fs, rs).to(dtype)


def izh_init(shape, is_inhibitory: torch.Tensor, dtype=torch.float32
             ) -> IzhState:
    """Resting state: v = -65, u = b * v, on ``is_inhibitory``'s
    device."""
    v = torch.full(shape, IZH_RESET, dtype=dtype,
                   device=is_inhibitory.device)
    return IzhState(v=v, u=_izh_param(is_inhibitory, 0.25, 0.2, dtype) * v)


def izhikevich_step(state: IzhState, current: torch.Tensor,
                    is_inhibitory: torch.Tensor, dt: float = 1.0):
    """One dt of RS/FS Izhikevich dynamics, two half-steps of 0.5 * dt for
    the quadratic term as in the original 2003 code; returns
    ``(new_state, spikes)`` with float 0/1 spikes in the state dtype.

    The reference's ``v + 0.5*dt*(0.04*v*v + 5*v + 140 - u + I)`` and
    ``u + dt*a*(b*v - u)`` compiled by XLA on the CPU contract into
    ``fma(v, 5, 0.04*v*v)``, ``fma(X, 0.5*dt, v)``, ``fma(b, v, -u)`` and
    ``fma(a*dt, ., u)``; each is written so here."""
    dtype = state.v.dtype
    a = _izh_param(is_inhibitory, 0.1, 0.02, dtype)
    b = _izh_param(is_inhibitory, 0.25, 0.2, dtype)
    d = _izh_param(is_inhibitory, 2.0, 8.0, dtype)
    half = float(torch.tensor(0.5 * dt, dtype=dtype))  # the state's rounding
    v, u = state.v, state.u
    for _ in range(2):  # two half-steps of 0.5*dt
        quad = _fma(v, 5.0, 0.04 * v * v)
        v = _fma(quad + 140.0 - u + current, half, v)
    u = _fma(a * dt, _fma(b, v, -u), u)
    spikes_b = v >= 30.0
    new_state = IzhState(v=torch.where(spikes_b, IZH_RESET, v),
                         u=torch.where(spikes_b, u + d, u))
    return new_state, spikes_b.to(state.v.dtype)
