"""Carry a network and its state across from the JAX reference.

The reference's ``NetworkParams`` and ``NetworkState`` leaves, as numpy
arrays (``numpy.asarray`` of each), become the port's containers on a
given device with the same dtypes and shapes, so that both sides hold
the same bytes (``metrics.bytes_per_synapse`` agrees). The inverse
functions give the port's leaves back as numpy arrays under the same
names. This module imports neither JAX nor the reference: the caller
hands it arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.network import NetworkParams, NetworkState
from repro_torch.core.neuron import LIFState

PARAM_LEAVES = ("w_local", "rem_flat", "rem_w", "local_outdeg")
STATE_LEAVES = ("v", "c", "refrac", "hist", "t", "spike_count",
                "event_count")


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def params_from_numpy(*, w_local, rem_flat, rem_w, local_outdeg,
                      device="cuda") -> NetworkParams:
    return NetworkParams(
        w_local=_tensor(w_local, device),
        rem_flat=_tensor(rem_flat, device),
        rem_w=_tensor(rem_w, device),
        local_outdeg=_tensor(local_outdeg, device),
    )


def state_from_numpy(*, v, c, refrac, hist, t, spike_count, event_count,
                     device="cuda") -> NetworkState:
    """The step counter ``t`` stays on the host (see core/network.py)."""
    return NetworkState(
        lif=LIFState(v=_tensor(v, device), c=_tensor(c, device),
                     refrac=_tensor(refrac, device)),
        hist=_tensor(hist, device),
        t=_tensor(t, "cpu"),
        spike_count=_tensor(spike_count, device),
        event_count=_tensor(event_count, device),
    )


def params_to_numpy(params: NetworkParams) -> dict:
    return {name: getattr(params, name).cpu().numpy() for name in PARAM_LEAVES}


def state_to_numpy(state: NetworkState) -> dict:
    leaves = dict(v=state.lif.v, c=state.lif.c, refrac=state.lif.refrac,
                  hist=state.hist, t=state.t, spike_count=state.spike_count,
                  event_count=state.event_count)
    return {name: leaves[name].cpu().numpy() for name in STATE_LEAVES}
