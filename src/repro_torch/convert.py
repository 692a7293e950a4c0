"""Carry a network and its state across from the JAX reference.

The reference's ``NetworkParams`` and ``NetworkState`` leaves, as numpy
arrays (``numpy.asarray`` of each), become the port's containers on a
given device with the same dtypes and shapes, so that both sides hold
the same bytes (``metrics.bytes_per_synapse`` agrees). The inverse
functions give the port's leaves back as numpy arrays under the same
names. The STDP traces (``x_pre``, ``x_post``) and the five
``GuardState`` leaves come across when the state has them. The stacked
distributed state (``DistState``, the layout of the reference's
``stacked_state_template``: every leaf with a leading shard axis) comes
across by leaf name too (``DIST_LEAVES``), its ``PlasticState`` under
STDP included (the reference's ``plastic`` leaves ``w_local``, ``rem_w``,
``traces.x_pre``, ``traces.x_post`` and ``trace_ext``, named by their
last part), and under the guard its ``GuardState`` leaves (``tripped``,
``trip_code``, ``trip_step``, ``sat_run``, ``checksum_fails``, one per
shard). A checkpoint's tree, the ``DistState`` of numpy leaves that
``checkpoint.checkpointer.restore`` gives back against
``exchange.stacked_state_template``, goes onto a mesh with
``exchange.stack_from_host``. The batched service's tenants (every
state leaf, and the plastic weights under STDP, with a leading tenant
axis, as the reference's ``init_tenants`` and ``run_chunk`` give them)
come across with the same functions, but for their step counters,
which stay on the device (:func:`tenants_state_from_numpy`). The
batched distributed state
(``exchange.make_batched_distributed_run(..., with_state=True)``) has
the reference's layout, every leaf (n_shards, b_local, ...), and
comes across with the ``DistState`` functions as it is;
:func:`merge_batch_shards` folds the batch shards of a run over several
(the reference's batch-major shard axis) into the (S, B, ...) layout of
one process holding every tenant. This module imports neither JAX nor
the reference: the caller hands it arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.exchange import DistState, PlasticState
from repro_torch.core.network import NetworkParams, NetworkState
from repro_torch.core.neuron import LIFState
from repro_torch.core.plasticity import STDPState
from repro_torch.runtime.integrity import GuardState

PARAM_LEAVES = ("w_local", "rem_flat", "rem_w", "local_outdeg")
STATE_LEAVES = ("v", "c", "refrac", "hist", "t", "spike_count",
                "event_count")
STDP_LEAVES = STDPState._fields
GUARD_LEAVES = GuardState._fields
# DistState's leaves (``v``, ``c``, ``refrac`` are its LIFState's);
# ``ext_pending`` only under ExchangeConfig.pipelined, the PlasticState's
# only under STDP (``x_pre``, ``x_post`` its traces'; ``trace_ext`` under
# aer_sparse)
PLASTIC_LEAVES = ("w_local", "rem_w", "x_pre", "x_post", "trace_ext")
DIST_LEAVES = ("v", "c", "refrac", "hist_ext", "pending", "t",
               "spike_count", "event_count", "aer_sat", "ext_pending",
               "last_spike_t", "isi_sum", "isi_sumsq",
               "isi_count") + PLASTIC_LEAVES + GUARD_LEAVES


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
                     stdp: dict | None = None, guard: dict | None = None,
                     device="cuda") -> NetworkState:
    """The step counter ``t`` stays on the host (see core/network.py).
    ``stdp`` and ``guard`` map the leaves of ``STDP_LEAVES`` and
    ``GUARD_LEAVES`` to arrays, when the state has them."""
    return NetworkState(
        lif=LIFState(v=_tensor(v, device), c=_tensor(c, device),
                     refrac=_tensor(refrac, device)),
        hist=_tensor(hist, device),
        t=_tensor(t, "cpu"),
        spike_count=_tensor(spike_count, device),
        event_count=_tensor(event_count, device),
        stdp=None if stdp is None else STDPState(
            **{k: _tensor(stdp[k], device) for k in STDP_LEAVES}),
        guard=None if guard is None else GuardState(
            **{k: _tensor(guard[k], device) for k in GUARD_LEAVES}),
    )


def tenants_state_from_numpy(*, device="cuda", **leaves) -> NetworkState:
    """B tenants' state (``core/batched.py``) from leaves named as
    :func:`state_from_numpy` takes them, each with a leading tenant axis;
    the (B,) step counters go to ``device``, where the batched engine
    advances them. Their params are :func:`params_from_numpy`'s, with
    (B, ...) plastic weights under STDP; :func:`params_to_numpy` and
    :func:`state_to_numpy` take both back."""
    state = state_from_numpy(device=device, **leaves)
    return state._replace(t=state.t.to(device))


def params_to_numpy(params: NetworkParams) -> dict:
    return {name: getattr(params, name).cpu().numpy() for name in PARAM_LEAVES}


def state_to_numpy(state: NetworkState) -> dict:
    """The leaves of ``STATE_LEAVES``, and ``stdp`` / ``guard`` dicts of
    theirs when the state has them."""
    leaves = dict(v=state.lif.v, c=state.lif.c, refrac=state.lif.refrac,
                  hist=state.hist, t=state.t, spike_count=state.spike_count,
                  event_count=state.event_count)
    out = {name: leaves[name].cpu().numpy() for name in STATE_LEAVES}
    for key, sub in (("stdp", state.stdp), ("guard", state.guard)):
        if sub is not None:
            out[key] = {k: getattr(sub, k).cpu().numpy() for k in sub._fields}
    return out


def dist_state_from_numpy(leaves, device="cuda") -> DistState:
    """The stacked ``DistState`` from its leaves (a mapping with the
    names of ``DIST_LEAVES``, each (S, ...) in process-major shard order,
    e.g. the reference's stacked state as numpy, or (S, b_local, ...),
    the batched runner's layout). ``t`` stays on the host;
    ``ext_pending`` may be absent (unpipelined), and so may the plastic
    leaves (a static state) and the guard's (no guard)."""
    def get(name, dev=device):
        return _tensor(leaves[name], dev) if name in leaves else None

    plastic = None
    if "w_local" in leaves:
        plastic = PlasticState(
            w_local=get("w_local"), rem_w=get("rem_w"),
            traces=STDPState(x_pre=get("x_pre"), x_post=get("x_post")),
            trace_ext=get("trace_ext"))
    return DistState(
        lif=LIFState(v=get("v"), c=get("c"), refrac=get("refrac")),
        hist_ext=get("hist_ext"), pending=get("pending"),
        t=get("t", "cpu"), spike_count=get("spike_count"),
        event_count=get("event_count"), plastic=plastic,
        aer_sat=get("aer_sat"),
        ext_pending=get("ext_pending"), last_spike_t=get("last_spike_t"),
        isi_sum=get("isi_sum"), isi_sumsq=get("isi_sumsq"),
        isi_count=get("isi_count"),
        guard=(GuardState(**{k: get(k) for k in GUARD_LEAVES})
               if "tripped" in leaves else None))


def dist_state_to_numpy(state: DistState) -> dict:
    """The leaves of ``DIST_LEAVES`` that the state has, as numpy, in the
    state's layout ((S, ...), or the batched runner's (S, b_local,
    ...))."""
    leaves = dict(state._asdict(), v=state.lif.v, c=state.lif.c,
                  refrac=state.lif.refrac)
    if state.plastic is not None:
        leaves.update(state.plastic._asdict(),
                      **state.plastic.traces._asdict())
    if state.guard is not None:
        leaves.update(state.guard._asdict())
    return {name: leaves[name].cpu().numpy() for name in DIST_LEAVES
            if leaves.get(name) is not None}


def merge_batch_shards(leaves: dict, batch_shards: int) -> dict:
    """(K*S, b_local, ...) leaves of a batched run over K batch shards
    (the reference's batch-major (n_shards, b_local, ...) state, or the
    ranks' saved states stacked in rank order) -> (S, K*b_local, ...):
    every tenant on each of the S spatial shards, in tenant order, the
    layout of one process holding them all."""
    out = {}
    for name, x in leaves.items():
        s = x.shape[0] // batch_shards
        y = np.moveaxis(x.reshape(batch_shards, s, *x.shape[1:]), 0, 1)
        out[name] = y.reshape(s, batch_shards * x.shape[1], *x.shape[2:])
    return out
