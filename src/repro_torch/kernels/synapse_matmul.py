"""Block-event-driven local synaptic delivery on the card:
``csrc/synapse_matmul.cu``.

Replaces ``repro/kernels/synapse_matmul.py::synapse_matmul``:
``out[c, t] = sum_s spikes[c, s] * w[c, s, t]`` with float32
accumulation. Bound by bytes: a batched vector-matrix product whose
weights are read once. One CTA per (column, 256-target block), one
thread per target (``plan.py``): the CTA lists its column's spiking
sources once, in ascending order, and streams only their weight rows
through a ring in shared memory, so a silent 128-source block's rows are
never read. Each target's sum is one fused multiply-add chain over the
listed sources in ascending order, bitwise ``ref.synapse_matmul_chain_ref``
(and ``fused_step``'s local product); its plain version is
``ref.synapse_matmul_ref``.

Tenant axis (the batched service): (B*C, N) spikes of B tenants over the
(C, N, N) weights they share, in one launch; the CTAs go column by
column, a column's tenants side by side, so the weight rows they both
need come from HBM once.

``silent_blocks``, when given, is a one-element int64 tensor on the
same device to which the call adds the number of (column, 128-source
block) pairs it skipped.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.plan import plan, sm_count
from repro_torch.kernels.ref import (silent_block_count, synapse_matmul_ref,
                                     tenants_of)


def synapse_matmul(spikes: torch.Tensor, w_local: torch.Tensor, *,
                   silent_blocks: torch.Tensor | None = None) -> torch.Tensor:
    """(C, N) x (C, N, N)[src, tgt] -> (C, N); (B*C, N) spikes give
    (B*C, N)."""
    if spikes.device.type == "cpu":
        if silent_blocks is not None:
            silent_blocks += silent_block_count(spikes)
        return synapse_matmul_ref(spikes, w_local)
    rows, n = spikes.shape
    c = w_local.shape[0]
    b = tenants_of(rows, c, "synapse_matmul")
    f32 = torch.float32
    _build.check_args("synapse_matmul", spikes.device,
                      spikes=(spikes, f32, (rows, n)),
                      w_local=(w_local, f32, (c, n, n)),
                      **_counter_arg(silent_blocks))
    out = torch.empty_like(spikes)
    p = plan("synapse_matmul", rows, n, 0, sm_count(spikes.device))
    _build.launch("synapse_matmul", "repro_synapse_matmul", spikes.device,
                  spikes.data_ptr(), w_local.data_ptr(), out.data_ptr(), rows,
                  b, n, _counter_ptr(silent_blocks), p.smem_bytes)
    return out


def _counter_arg(counter: torch.Tensor | None) -> dict:
    if counter is None:
        return {}
    return {"silent_blocks": (counter, torch.int64, (1,))}


def _counter_ptr(counter: torch.Tensor | None):
    return None if counter is None else counter.data_ptr()
