"""STDP (spike-timing dependent plasticity), the port of
``repro/core/plasticity.py``.

Pair-based STDP with exponential pre/post traces on excitatory sources
only; inhibitory weights are left untouched, weights are clipped to
[0, w_max] and absent synapses (exact zeros) stay absent. The dense
local update is the ``stdp_dense_update`` kernel (``impl`` 'cuda' and
'cuda_fused') or its plain version (``impl='ref'``); the remote ELL
update gathers pre-traces through a neighbour pre-trace table (built in
plain PyTorch) with the ``stdp_remote_update`` kernel or, under 'ref',
its plain version (the rule is jnp in the reference, not Pallas). Under
the two CUDA impls nothing in the update makes the host wait.

Every multiply-add is grouped as XLA groups the reference's jitted step
on the CPU (``kernels/ref.py::_fma``), so the port's weights and traces
equal the reference's to the bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import DPSNNConfig, STDPConfig
from repro_torch.core import network as net
from repro_torch.core.connectivity import StencilSpec
from repro_torch.core.network import NetworkParams
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref


class STDPState(NamedTuple):
    x_pre: torch.Tensor    # (C, N) presynaptic traces
    x_post: torch.Tensor   # (C, N) postsynaptic traces


def init_stdp(n_columns: int, n: int, dtype=torch.float32,
              device="cpu") -> STDPState:
    def zeros():
        return torch.zeros((n_columns, n), dtype=dtype, device=device)
    return STDPState(x_pre=zeros(), x_post=zeros())


def pre_trace_table(x_pre: torch.Tensor, stencil: StencilSpec,
                    grid_hw: tuple[int, int]) -> torch.Tensor:
    """(C, N) pre-trace frame -> (C, O*N) neighbour pre-trace table: the
    frame shifted by each stencil offset through ``network.offset_slice``
    (the shift convention of the neighbour-spike table), zero beyond the
    sheet's edge, with a uniform one-step lag (callers pass the previous
    step's traces). B tenants' (B*C, N) frames give their (B*C, O*N)
    tables, each tenant's on its own sheet."""
    gh, gw = grid_hw
    rows, n = x_pre.shape
    if not stencil.offsets:
        return x_pre.new_zeros((rows, 0))
    r = stencil.radius
    g = torch.nn.functional.pad(x_pre.reshape(-1, gh, gw, n),
                                (0, 0, r, r, r, r))
    per_offset = [net.offset_slice(g, dy, dx, r, gh, gw, n)
                  for (dy, dx, _k, _delay, _p) in stencil.offsets]
    return torch.stack(per_offset, dim=3).reshape(
        rows, stencil.n_offsets * n)


def advance_traces(cfg: DPSNNConfig, scfg: STDPConfig, st: STDPState,
                   spikes: torch.Tensor) -> STDPState:
    """The traces one step on: ``x' = x * exp(-dt/tau) + spikes``."""
    k = kref.stdp_constants(scfg, cfg.neuron.dt_ms, st.x_pre.dtype)
    return STDPState(x_pre=kref.stdp_trace_ref(st.x_pre, k["dp"], spikes),
                     x_post=kref.stdp_trace_ref(st.x_post, k["dm"], spikes))


def stdp_update(cfg: DPSNNConfig, scfg: STDPConfig, params: NetworkParams,
                st: STDPState, spikes: torch.Tensor, is_inh: torch.Tensor,
                pre_trace_table: torch.Tensor | None = None,
                rem_flat: torch.Tensor | None = None,
                impl: str = "ref",
                new_traces: STDPState | None = None,
                active: torch.Tensor | None = None):
    """One STDP step given this step's spikes (C, N).

    ``pre_trace_table`` is the (C, O*N) neighbour pre-trace table for the
    remote update (None: local update only). With ``new_traces`` (the
    traces ``fused_step`` already advanced under ``impl='cuda_fused'``)
    the decay and bump are not computed again. Returns ``(new_params,
    new_stdp_state)``; the inputs are left as they were.

    B tenants (the batched service): every argument but ``rem_flat`` has
    B*C rows (the weights each tenant's own, as a (B*C, ...) view), and
    ``active`` ((B,)) keeps an inactive tenant's weights as they were, in
    the kernels (their pass-through) or the plain versions.
    """
    if new_traces is None:
        new_traces = advance_traces(cfg, scfg, st, spikes)
    x_pre, x_post = new_traces
    exc_src = (~is_inh).to(spikes.dtype)            # (N,)
    w_max = scfg.w_max_factor * cfg.conn.j_exc
    x_pre_exc = x_pre * exc_src[None, :]
    spk_exc = spikes * exc_src[None, :]
    kw = dict(a_plus=scfg.a_plus, a_minus=scfg.a_minus, lr=scfg.lr,
              w_max=w_max, active=active)
    if impl in ("cuda", "cuda_fused"):
        dense, remote = ops.stdp_dense_update, ops.stdp_remote_update
    elif impl == "ref":
        dense = kref.stdp_dense_update_ref
        remote = kref.stdp_remote_update_ref
    else:
        raise ValueError(f"unknown stdp impl {impl!r}")
    w_local = dense(params.w_local, x_pre_exc, spk_exc, spikes, x_post, **kw)

    rem_w = params.rem_w
    if pre_trace_table is not None and rem_flat is not None:
        # the remote ELL rule of the reference (plasticity.py:115-133)
        rem_w = remote(pre_trace_table, rem_flat, params.rem_w, spikes,
                       x_post, **kw)
    return (params._replace(w_local=w_local, rem_w=rem_w),
            STDPState(x_pre=x_pre, x_post=x_post))
