"""Simulation loop and summary metrics, single shard (the port of
``repro/core/simulation.py``). The reference's ``lax.scan`` is a Python
loop here; nothing in it waits for the card until the caller reads a
result.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import DPSNNConfig
from repro_torch.core import network as net
from repro_torch.core import plasticity as plast
from repro_torch.core.connectivity import build_stencil, neuron_types
from repro_torch.core.network import NetworkParams, NetworkState
from repro_torch.runtime.spans import span


class SimResult(NamedTuple):
    state: NetworkState
    rate_hz: torch.Tensor      # mean firing rate over the run
    events: torch.Tensor       # total synaptic events (paper metric)
    spikes: torch.Tensor       # total spikes
    rate_trace: torch.Tensor   # (T,) per-step population rate (Hz)
    params: NetworkParams | None = None   # final params (plastic under STDP)


def build(cfg: DPSNNConfig, *, device="cuda", seed: int | None = None):
    """Generate params + fresh state for the full grid on one shard, on
    ``device`` (CUDA by default; raises when there is no card).

    ``seed`` overrides ``cfg.seed`` for the state only (the membrane
    potentials); the network always comes from ``cfg.seed``: the tenants
    of the batched service share one network and differ in state and
    drive."""
    dev = net.resolve_device(device)
    col_ids = net.column_ids(cfg)
    params = net.build_params(cfg, col_ids, dev)
    state = net.init_state(cfg, col_ids, device=dev, seed=seed)
    return params, state


def _recip(x: float) -> float:
    """``1 / x`` in float32. The rates divide by constants as the reference
    does after XLA folds each division into a multiplication by the
    constant's float32 reciprocal, so both give the same bits."""
    return float(1.0 / torch.tensor(x, dtype=torch.float32))


def run(cfg: DPSNNConfig, params: NetworkParams, state: NetworkState,
        n_steps: int, impl: str = "cuda_fused",
        ext_counts: torch.Tensor | None = None,
        silent_blocks: torch.Tensor | None = None,
        seed: int | None = None,
        nu_scale: float | None = None) -> SimResult:
    """Simulate ``n_steps`` of ``cfg.neuron.dt_ms`` each.

    With ``cfg.stdp`` the weights are dynamical state: every step applies
    the pair-based STDP update to the params it was given (local outer
    products, and the remote ELL rule through the previous step's
    pre-trace table), and ``SimResult.params`` holds the final params;
    the caller's params are left as they were.

    ``ext_counts`` (n_steps, C, N), when given, are the Poisson drive
    counts of each step (the tests pass the reference's); else each step
    draws its own (``network.external_drive``, keyed by the step and the
    global column ids, as the reference's). ``silent_blocks`` is
    passed on to every step (``network.step_single``), and so are
    ``seed`` and ``nu_scale``, a tenant's drive: this is the dedicated
    single-tenant run that each slot of the batched service equals.
    """
    net.check_supported(cfg, impl)
    stencil = build_stencil(cfg)
    grid_hw = (cfg.grid_h, cfg.grid_w)
    n_neurons = state.hist.shape[1] * state.hist.shape[2]
    if ext_counts is not None:
        ext_counts = torch.as_tensor(ext_counts, device=state.hist.device)
        if ext_counts.shape[0] < n_steps:
            raise ValueError(f"ext_counts has {ext_counts.shape[0]} steps, "
                             f"the run takes {n_steps}")
    # x / n_neurons / dt: XLA multiplies by the float32 product of the
    # two float32 reciprocals
    f32 = torch.float32
    per_step = float(torch.tensor(_recip(n_neurons), dtype=f32)
                     * torch.tensor(_recip(cfg.neuron.dt_ms * 1e-3),
                                    dtype=f32))
    is_inh = neuron_types(cfg, state.hist.device)
    col_ids = net.column_ids(cfg, state.hist.device)
    rates = []
    final = state
    with span("sim.run", n_steps=n_steps):
        for i in range(n_steps):
            with span("sim.step"):
                s0 = final
                final = net.step_single(
                    cfg, params, s0, stencil=stencil, grid_hw=grid_hw,
                    col_ids=col_ids, impl=impl,
                    ext_counts=None if ext_counts is None else ext_counts[i],
                    silent_blocks=silent_blocks, seed=seed,
                    nu_scale=nu_scale)
                if cfg.stdp:
                    params, final = _plasticity(cfg, params, s0, final,
                                                stencil, grid_hw, is_inh,
                                                impl)
                rates.append((final.spike_count - s0.spike_count) * per_step)
    sim_seconds = n_steps * cfg.neuron.dt_ms * 1e-3
    rate_trace = (torch.stack(rates) if rates else
                  torch.zeros((0,), device=state.hist.device))
    return SimResult(
        state=final,
        rate_hz=final.spike_count * _recip(n_neurons * sim_seconds),
        events=final.event_count,
        spikes=final.spike_count,
        rate_trace=rate_trace,
        params=params,
    )


def _plasticity(cfg: DPSNNConfig, params: NetworkParams, s0: NetworkState,
                s1: NetworkState, stencil, grid_hw, is_inh, impl: str):
    """The STDP update of one step, from its state before (``s0``) and
    after (``s1``): the new params, and ``s1`` with the new traces."""
    with span("plasticity.update"):
        spikes = s1.hist[int(s0.t) % s1.hist.shape[0]]
        table = plast.pre_trace_table(s0.stdp.x_pre, stencil, grid_hw)
        # under cuda_fused the kernel already advanced the traces
        params, traces = plast.stdp_update(
            cfg, cfg.stdp_cfg, params, s0.stdp, spikes, is_inh,
            pre_trace_table=table, rem_flat=params.rem_flat, impl=impl,
            new_traces=s1.stdp if impl == "cuda_fused" else None)
    return params, s1._replace(stdp=traces)


def events_per_simulated_second(cfg: DPSNNConfig, rate_hz: float) -> float:
    """Analytic synaptic-event throughput (paper's normalisation):
    recurrent events = rate * recurrent synapses; external events =
    nu_ext * C_ext * neurons."""
    rec = rate_hz * (cfg.local_fanin + cfg.remote_fanin) * cfg.n_neurons
    ext = cfg.nu_ext_hz * cfg.c_ext * cfg.n_neurons
    return rec + ext
