"""Measurement helpers mirroring the paper's reported quantities (the port
of ``repro/core/metrics.py``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import DPSNNConfig


def pytree_bytes(tree) -> int:
    """Total bytes of the tensors in a (nested) NamedTuple/tuple/list."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (tuple, list)):
        return sum(pytree_bytes(x) for x in tree)
    return 0


def bytes_per_synapse(cfg: DPSNNConfig, params, state) -> float:
    """Paper Fig 4 metric: resident bytes / total equivalent synapses
    (the arrays of the network and its state, not the whole process)."""
    total = pytree_bytes(params) + pytree_bytes(state)
    return total / cfg.total_equivalent_synapses


def time_per_synaptic_event(elapsed_s: float, events: float) -> float:
    """Paper Fig 2/3 strong+weak scaling unit."""
    return elapsed_s / max(events, 1.0)


def realtime_factor(elapsed_s: float, n_steps: int, dt_ms: float) -> float:
    """How many wall seconds per simulated second."""
    return elapsed_s / (n_steps * dt_ms * 1e-3)


def synchrony_index(rate_trace: torch.Tensor) -> torch.Tensor:
    """CV of the population rate: a crude up/down-state marker."""
    m = rate_trace.mean()
    return torch.where(m > 0, rate_trace.std(unbiased=False) / m,
                       torch.zeros_like(m))
