"""Synapse generation for the 2-D cortical-column grid (the port of
``repro/core/connectivity.py``; paper Sec. 2).

* **Local** (intra-column, p = 0.8): dense per-column weights
  ``w_local[c, src, tgt]``; absent synapses are exact zeros.
* **Remote** (lateral stencil): fixed-fan-in ELL format, every active
  offset's ``K_o = round(p_o * N)`` sources concatenated along one slot
  axis of length ``K_tot``.

Generation is **deterministic per (seed, stream, global column id)**:
each column draws from its own ``torch.Generator``, seeded from those
three numbers, so a column's synapses do not depend on which other
columns are generated with it. The streams are the reference's
(``PRNGKey(seed)``, ``+ 0x9E3779B9``, ``+ 0x51F``, ``+ 0xE57``), but the
numbers are PyTorch's, not JAX's threefry, and differ between the CPU
and the CUDA generator: the tests carry the JAX network across with
``convert.py`` where they need the same one.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import DPSNNConfig

STREAM_LOCAL = 0
STREAM_REMOTE = 0x9E3779B9
STREAM_INIT = 0x51F
STREAM_DRIVE = 0xE57


class StencilSpec(NamedTuple):
    """Static (host-side) description of the active lateral stencil."""
    offsets: tuple            # ((dy, dx, K, delay_steps, p), ...)
    k_total: int              # sum of K over offsets
    slot_offset: np.ndarray   # (k_total,) int32: slot -> offset index
    slot_delay: np.ndarray    # (k_total,) int32: slot -> delay (steps)
    max_delay: int            # includes local delay
    radius: int               # halo radius: max |dy|, |dx| over offsets

    @property
    def n_offsets(self) -> int:
        return len(self.offsets)


def build_stencil(cfg: DPSNNConfig) -> StencilSpec:
    entries = []
    for dy, dx, p in cfg.stencil_offsets():
        k = max(1, round(p * cfg.neurons_per_column))
        delay = cfg.conn.min_delay_steps + int(
            round(cfg.conn.delay_per_step * math.hypot(dy, dx))
        )
        entries.append((dy, dx, k, delay, p))
    slot_offset = np.concatenate(
        [np.full(k, i, np.int32) for i, (_, _, k, _, _) in enumerate(entries)]
    ) if entries else np.zeros((0,), np.int32)
    slot_delay = np.concatenate(
        [np.full(k, d, np.int32) for (_, _, k, d, _) in entries]
    ) if entries else np.zeros((0,), np.int32)
    max_delay = max(
        [cfg.conn.min_delay_steps] + [d for (_, _, _, d, _) in entries]
    )
    return StencilSpec(
        offsets=tuple(entries),
        k_total=int(slot_offset.shape[0]),
        slot_offset=slot_offset,
        slot_delay=slot_delay,
        max_delay=int(max_delay),
        radius=cfg.stencil_radius,
    )


def keyed_generator(seed: int, stream: int, index: int,
                    device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, stream, index) alone,
    through a splitmix64 mix of the three."""
    x = 0
    for part in (seed, stream, index):
        x = (x ^ (int(part) & 0xFFFFFFFFFFFFFFFF)) + 0x9E3779B97F4A7C15
        x &= 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 31
    gen = torch.Generator(device=device)
    gen.manual_seed(x & 0x7FFFFFFFFFFFFFFF)
    return gen


def neuron_types(cfg: DPSNNConfig, device="cpu") -> torch.Tensor:
    """(N,) bool: True where the neuron is inhibitory (last 20 %)."""
    n = cfg.neurons_per_column
    n_exc = round(cfg.conn.exc_fraction * n)
    return torch.arange(n, device=device) >= n_exc


def _truncated_normal(gen: torch.Generator, shape, lower: float,
                      upper: float, device) -> torch.Tensor:
    """Standard normal truncated to [lower, upper], by inverting the CDF
    of a uniform draw between the bounds' CDF values (as jax.random)."""
    a = math.erf(lower / math.sqrt(2.0))
    b = math.erf(upper / math.sqrt(2.0))
    u = torch.rand(shape, generator=gen, device=device) * (b - a) + a
    x = math.sqrt(2.0) * torch.erfinv(u)
    return torch.clamp(x, lower, upper)


def _signed_magnitude(cfg: DPSNNConfig, gen, shape, is_inh_src, device):
    """Synaptic efficacy by source type with multiplicative jitter."""
    cv = cfg.conn.weight_cv
    jitter = 1.0 + cv * _truncated_normal(gen, shape, -2.0, 2.0, device)
    mag = torch.where(is_inh_src, -cfg.conn.g_balance * cfg.conn.j_exc,
                      cfg.conn.j_exc)
    return (mag * jitter).to(getattr(torch, cfg.weight_dtype))


def generate_local_column(cfg: DPSNNConfig, col_id: int,
                          device="cpu") -> torch.Tensor:
    """Dense (N, N) [src, tgt] intra-column weights for one global column."""
    n = cfg.neurons_per_column
    gen = keyed_generator(cfg.seed, STREAM_LOCAL, col_id, device)
    mask = torch.rand((n, n), generator=gen, device=device) < cfg.conn.p_local
    mask &= ~torch.eye(n, dtype=torch.bool, device=device)   # no autapses
    is_inh_src = neuron_types(cfg, device)[:, None]   # sign follows source
    w = _signed_magnitude(cfg, gen, (n, n), is_inh_src, device)
    return torch.where(mask, w, torch.zeros((), dtype=w.dtype, device=device))


def generate_remote_column(cfg: DPSNNConfig, stencil: StencilSpec,
                           col_id: int, device="cpu"):
    """ELL remote synapses for one target column: ``(idx, w)`` of shape
    (N, K_tot); ``idx[n, k]`` is the source neuron (within the source
    column of slot k's offset) of target n's k-th remote synapse."""
    n = cfg.neurons_per_column
    kt = stencil.k_total
    gen = keyed_generator(cfg.seed, STREAM_REMOTE, col_id, device)
    idx = torch.randint(0, n, (n, kt), generator=gen, device=device,
                        dtype=torch.int32)
    is_inh_src = neuron_types(cfg, device)[idx.long()]
    w = _signed_magnitude(cfg, gen, (n, kt), is_inh_src, device)
    return idx, w


def generate_columns(cfg: DPSNNConfig, col_ids, device="cpu"):
    """Generation for a batch of global column ids, one column at a time
    into preallocated outputs. Returns ``(w_local (C,N,N), rem_idx
    (C,N,K), rem_w (C,N,K))``."""
    stencil = build_stencil(cfg)
    ids = [int(c) for c in col_ids]
    n, kt = cfg.neurons_per_column, stencil.k_total
    wdt = getattr(torch, cfg.weight_dtype)
    w_local = torch.empty((len(ids), n, n), dtype=wdt, device=device)
    rem_idx = torch.empty((len(ids), n, kt), dtype=torch.int32, device=device)
    rem_w = torch.empty((len(ids), n, kt), dtype=wdt, device=device)
    for i, cid in enumerate(ids):
        w_local[i] = generate_local_column(cfg, cid, device)
        rem_idx[i], rem_w[i] = generate_remote_column(cfg, stencil, cid,
                                                      device)
    return w_local, rem_idx, rem_w


def local_out_degree(w_local: torch.Tensor) -> torch.Tensor:
    """(C, N) realized intra-column out-degree (for synaptic-event counts)."""
    return (w_local != 0).sum(dim=-1)


def flat_gather_index(stencil: StencilSpec, rem_idx: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Gather indices into the (O*N,) flattened neighbour-spike table:
    ``flat[c, n, k] = slot_offset[k] * N + rem_idx[c, n, k]``."""
    off = torch.as_tensor(stencil.slot_offset, dtype=torch.int32,
                          device=rem_idx.device)
    return off[None, None, :] * n + rem_idx


def expected_syn_per_neuron(cfg: DPSNNConfig) -> float:
    return cfg.local_fanin + cfg.remote_fanin + cfg.c_ext
