"""Plain PyTorch versions of every kernel in this package.

``synapse_matmul_ref``, ``ell_gather_ref`` and ``lif_step_ref`` are the
counterparts of the oracles of the same names in ``repro/kernels/ref.py``;
``fused_step_ref`` composes them as the reference step does. Each is the
version a kernel wrapper takes for a tensor on the CPU. On the card ``chip_smoke.py`` holds each CUDA kernel
against it. Products that the reference accumulates in float32
(``preferred_element_type=jnp.float32``) accumulate in float32 here.
"""
from __future__ import annotations

import torch

BLK = 128   # source-block width of the block-event skip (csrc/kernels.cuh)


def synapse_matmul_ref(spikes: torch.Tensor, w_local: torch.Tensor
                       ) -> torch.Tensor:
    """Local synaptic delivery: (C,N) x (C,N,N)[src,tgt] -> (C,N)."""
    out = torch.einsum("cs,cst->ct", spikes.float(), w_local.float())
    return out.to(spikes.dtype)


def ell_gather_ref(s_flat: torch.Tensor, idx: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Remote ELL delivery: gather+reduce.

    s_flat (C, T) neighbour-spike table, idx/w (C, N, K) -> (C, N).
    """
    c, n, k = idx.shape
    g = torch.gather(s_flat, 1, idx.reshape(c, n * k).long())
    out = (g.reshape(c, n, k).float() * w.float()).sum(dim=-1)
    return out.to(s_flat.dtype)


def lif_constants(ncfg, dtype=torch.float32) -> dict:
    """The LIF+SFA constants as ``lif_step_ref`` and the kernels take them.

    The decays are ``exp`` evaluated in the state dtype, as
    ``core/neuron.py`` of the reference does (not a double-precision
    ``math.exp``). The exp-Euler gain ``(1 - decay_v) * (tau_m/dt)`` is
    folded once, in the state dtype, as XLA folds it in the reference;
    eager left-to-right evaluation of ``drive * (1 - decay_v) * (tau_m/dt)``
    would be a different product.
    """
    def f(x):
        return torch.tensor(x, dtype=dtype)

    dt = ncfg.dt_ms
    decay_v = torch.exp(f(-dt / ncfg.tau_m_ms))
    decay_c = torch.exp(f(-dt / ncfg.tau_c_ms))
    gain = (f(1.0) - decay_v) * f(ncfg.tau_m_ms / dt)
    return dict(decay_v=float(decay_v), decay_c=float(decay_c),
                gain=float(gain), g_c=float(f(ncfg.g_c)),
                alpha_c=float(f(ncfg.alpha_c)), v_rest=float(f(ncfg.v_rest)),
                v_reset=float(f(ncfg.v_reset)),
                v_threshold=float(f(ncfg.v_threshold)),
                arp_steps=round(ncfg.tau_arp_ms / dt))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to ``a``'s dtype, like a fused
    multiply-add: the float64 product of two float32 values is exact."""
    return (a.double() * b + torch.as_tensor(c).double()).to(a.dtype)


def lif_step_ref(v, c, refrac, current, *, decay_v, decay_c, gain,
                 g_c, alpha_c, v_rest, v_reset, v_threshold, arp_steps):
    """Fused LIF+SFA update (mirrors core/neuron.py lif_sfa_step).

    The multiply-adds are grouped as XLA groups the reference's jitted
    step on the CPU: ``drive = fma(-g_c, c, cur)``,
    ``v1 = v_rest + fma(v - v_rest, decay_v, drive * gain)`` and
    ``c' = fma(c, decay_c, alpha_c * spikes)``; the CUDA kernels write the
    same grouping with ``__fmaf_rn``.
    """
    dtype = v.dtype
    drive = _fma(c, -g_c, current)
    v1 = v_rest + _fma(v - v_rest, decay_v, drive * gain)
    refractory = refrac > 0
    v1 = torch.where(refractory, torch.tensor(v_reset, dtype=dtype), v1)
    spikes_b = (v1 >= v_threshold) & (~refractory)
    spikes = spikes_b.to(dtype)
    v2 = torch.where(spikes_b, torch.tensor(v_reset, dtype=dtype), v1)
    c2 = _fma(c, decay_c, alpha_c * spikes)
    r2 = torch.where(spikes_b, torch.tensor(arp_steps, dtype=refrac.dtype),
                     torch.clamp(refrac - 1, min=0))
    return v2, c2, r2, spikes


def fused_step_ref(ncfg, v, c, refrac, s_loc, w_local, s_flat, rem_flat,
                   rem_w, ext):
    """The static column step: local product, + ELL gather, + external
    drive, then LIF+SFA. Returns ``(v', c', refrac', spikes)``."""
    cur = synapse_matmul_ref(s_loc, w_local)
    cur = cur + ell_gather_ref(s_flat, rem_flat, rem_w)
    cur = cur + ext
    return lif_step_ref(v, c, refrac, cur, **lif_constants(ncfg, v.dtype))


def silent_block_count(spikes: torch.Tensor) -> torch.Tensor:
    """Number of (column, 128-source block) pairs whose spike slice is all
    zero: the blocks whose weight rows the kernels never read."""
    c, n = spikes.shape
    pad = (-n) % BLK
    s = torch.nn.functional.pad(spikes, (0, pad)).reshape(c, -1, BLK)
    return (~(s != 0).any(dim=-1)).sum()
