"""LIF+SFA point-neuron dynamics (the port of ``repro/core/neuron.py``).

Leaky Integrate-and-Fire with spike-frequency adaptation via a
Ca-dependent AHP current (Gigante, Mattia, Del Giudice 2007): the
configuration measured in the 2015 scaling paper. Exponential-Euler
decay, over any leading batch shape. The arithmetic is the one of
``kernels/ref.py::lif_step_ref``, shared with the kernels' plain
versions. The Izhikevich option waits for a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import NeuronConfig
from repro_torch.core import prng
from repro_torch.kernels.ref import lif_constants, lif_step_ref


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
