"""Synapse generation for the 2-D cortical-column grid (the port of
``repro/core/connectivity.py``; paper Sec. 2).

* **Local** (intra-column, p = 0.8): dense per-column weights
  ``w_local[c, src, tgt]``; absent synapses are exact zeros.
* **Remote** (lateral stencil): fixed-fan-in ELL format, every active
  offset's ``K_o = round(p_o * N)`` sources concatenated along one slot
  axis of length ``K_tot``.

Generation is **deterministic per global column id**, with the
reference's own keys and draws (``core/prng.py``): the local synapses
of column c from ``fold_in(PRNGKey(seed), c)``, the remote ones from
``fold_in(PRNGKey(seed) + uint32(0x9E3779B9), c)`` (the constant added
to both words of the key). The Bernoulli mask and the ELL indices equal
the reference's to the bit; the weights' truncated-normal jitter is
within a few ulp of it (``tests/test_torch_prng.py``). Every function
that takes a column id also takes a 1-D tensor of ids and then returns
one column per id, stacked in front.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import DPSNNConfig
from repro_torch.core import prng

# added to both words of PRNGKey(seed) for the remote synapses' keys
REMOTE_STREAM = 0x9E3779B9
# elements per chunk of columns in generate_columns: bounds each int64
# temporary of the draws to 128 MiB at any grid size
_BUILD_CHUNK = 1 << 24


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


def neuron_types(cfg: DPSNNConfig, device="cpu") -> torch.Tensor:
    """(N,) bool: True where the neuron is inhibitory (last 20 %)."""
    n = cfg.neurons_per_column
    n_exc = round(cfg.conn.exc_fraction * n)
    return torch.arange(n, device=device) >= n_exc


def _signed_magnitude(cfg: DPSNNConfig, key, shape, is_inh_src):
    """Synaptic efficacy by source type with multiplicative jitter."""
    cv = cfg.conn.weight_cv
    jitter = 1.0 + cv * prng.truncated_normal(key, -2.0, 2.0, shape)
    mag = torch.where(is_inh_src, -cfg.conn.g_balance * cfg.conn.j_exc,
                      cfg.conn.j_exc)
    return (mag * jitter).to(getattr(torch, cfg.weight_dtype))


def _column_keys(base: torch.Tensor, col_id) -> torch.Tensor:
    """``fold_in(base, col_id)`` for an int or a 1-D tensor of ids."""
    if isinstance(col_id, torch.Tensor):
        col_id = col_id.to(device=base.device, dtype=torch.int64)
    return prng.fold_in(base, col_id)


def generate_local_column(cfg: DPSNNConfig, col_id,
                          device="cpu") -> torch.Tensor:
    """Dense (N, N) [src, tgt] intra-column weights for one global column."""
    n = cfg.neurons_per_column
    key = _column_keys(prng.prng_key(cfg.seed, device), col_id)
    keys = prng.split(key)
    mask = prng.bernoulli(keys[..., 0, :], cfg.conn.p_local, (n, n))
    mask &= ~torch.eye(n, dtype=torch.bool, device=device)   # no autapses
    is_inh_src = neuron_types(cfg, device)[:, None]   # sign follows source
    w = _signed_magnitude(cfg, keys[..., 1, :], (n, n), is_inh_src)
    return torch.where(mask, w, torch.zeros((), dtype=w.dtype, device=device))


def generate_remote_column(cfg: DPSNNConfig, stencil: StencilSpec,
                           col_id, device="cpu"):
    """ELL remote synapses for one target column: ``(idx, w)`` of shape
    (N, K_tot); ``idx[n, k]`` is the source neuron (within the source
    column of slot k's offset) of target n's k-th remote synapse."""
    n = cfg.neurons_per_column
    base = (prng.prng_key(cfg.seed, device) + REMOTE_STREAM) & prng.MASK
    keys = prng.split(_column_keys(base, col_id))
    idx = prng.randint(keys[..., 0, :], (n, stencil.k_total), 0, n)
    is_inh_src = neuron_types(cfg, device)[idx.long()]
    w = _signed_magnitude(cfg, keys[..., 1, :], (n, stencil.k_total),
                          is_inh_src)
    return idx, w


def generate_columns(cfg: DPSNNConfig, col_ids, device="cpu"):
    """Generation for a batch of global column ids, a chunk of columns at
    a time into preallocated outputs. Returns ``(w_local (C,N,N), rem_idx
    (C,N,K), rem_w (C,N,K))``."""
    stencil = build_stencil(cfg)
    ids = torch.as_tensor(col_ids, dtype=torch.int64).reshape(-1)
    n, kt = cfg.neurons_per_column, stencil.k_total
    wdt = getattr(torch, cfg.weight_dtype)
    c = ids.shape[0]
    w_local = torch.empty((c, n, n), dtype=wdt, device=device)
    rem_idx = torch.empty((c, n, kt), dtype=torch.int32, device=device)
    rem_w = torch.empty((c, n, kt), dtype=wdt, device=device)
    step = max(1, _BUILD_CHUNK // (n * max(n, kt)))
    for c0 in range(0, c, step):
        chunk = ids[c0:c0 + step]
        cs = slice(c0, c0 + chunk.shape[0])
        w_local[cs] = generate_local_column(cfg, chunk, device)
        rem_idx[cs], rem_w[cs] = generate_remote_column(cfg, stencil, chunk,
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
