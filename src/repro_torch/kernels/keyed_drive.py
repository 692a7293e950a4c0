"""The Poisson drive of one step on the card: ``csrc/keyed_drive.cu``.

No Pallas counterpart: replaces ``repro/core/network.py::external_drive``
(plain jnp), ``jax.random.poisson`` of every global column under the
reference's key ``fold_in(fold_in(PRNGKey(seed + 0xE57), t),
col_ids[c])``. One launch per step draws the counts and writes the
currents ``counts * j_ext``; the column keys are derived on the device,
so the host makes no generator and waits for nothing. Bound by
operations: one threefry2x32 per draw, count + 1 draws per neuron.

The kernel gives each column one CTA (a column of more than 2048
neurons is split into equal shares). It draws in rounds of two draws
for each neuron still undone, the neurons packed densely into full
warps from a list in shared memory, while two lanes of its last warp
grow the column's split chain a round ahead.

On CPU tensors the wrapper returns the plain version,
``ref.keyed_poisson_ref``; on CUDA tensors it launches the kernel or
raises. The kernel equals its plain version on the card to the bit.

:func:`keyed_drive_tenants` draws B tenants' drives in one launch (the
batched service), each under its own seed, step and rate, read from (B,)
device tensors by the kernel's tenant instance: the host makes no key
and waits for nothing. Its plain version is
``ref.keyed_poisson_tenants_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (DRIVE_STREAM, keyed_poisson_ref,
                                     keyed_poisson_tenants_ref)

MASK = 0xFFFFFFFF


def keyed_drive(seed: int, t: int, col_ids: torch.Tensor, n: int,
                lam: float, j_ext: float):
    """Step ``t``'s drive of the columns ``col_ids`` ((C,) global ids, on
    the device to draw on), N neurons each, at rate ``lam`` per step.
    Returns ``(currents, counts)``, both (C, N) float32."""
    if not 0.0 <= lam < 10.0:
        raise NotImplementedError(
            f"keyed_drive: lam = {lam}; only Knuth's branch (0 <= lam < 10) "
            f"of jax.random.poisson is ported")
    if not 0 <= t <= MASK:
        raise ValueError(f"keyed_drive: step {t} is not a uint32")
    if col_ids.device.type == "cpu":
        counts = keyed_poisson_ref(seed, t, col_ids, n, lam)
        return counts * j_ext, counts
    c = col_ids.shape[0]
    _build.check_args("keyed_drive", col_ids.device,
                      col_ids=(col_ids, torch.int32, (c,)))
    counts = torch.empty((c, n), dtype=torch.float32, device=col_ids.device)
    cur = torch.empty_like(counts)
    _build.launch("keyed_drive", "repro_keyed_drive", col_ids.device,
                  col_ids.data_ptr(), counts.data_ptr(), cur.data_ptr(), c, n,
                  (seed + DRIVE_STREAM) & MASK, t, lam, j_ext)
    return cur, counts


def keyed_drive_tenants(seeds: torch.Tensor, t: torch.Tensor,
                        col_ids: torch.Tensor, n: int, lam: torch.Tensor,
                        j_ext: float):
    """B tenants' drives of the columns ``col_ids`` ((C,) global ids):
    tenant b's under seed ``seeds[b]`` at step ``t[b]`` and rate
    ``lam[b]`` ((B,) int32, int32 and float32 tensors on ``col_ids``'
    device; every rate in [0, 10), which the caller checks: reading them
    here would make the host wait). Returns ``(currents, counts)``, both
    (B*C, N) float32, tenant after tenant."""
    if col_ids.device.type == "cpu":
        counts = keyed_poisson_tenants_ref(seeds.tolist(), t.tolist(),
                                           col_ids, n, lam.tolist())
        return counts * j_ext, counts
    b, c = seeds.shape[0], col_ids.shape[0]
    _build.check_args("keyed_drive", col_ids.device,
                      col_ids=(col_ids, torch.int32, (c,)),
                      seeds=(seeds, torch.int32, (b,)),
                      t=(t, torch.int32, (b,)),
                      lam=(lam, torch.float32, (b,)))
    counts = torch.empty((b * c, n), dtype=torch.float32,
                         device=col_ids.device)
    cur = torch.empty_like(counts)
    # the kernel adds DRIVE_STREAM to each seed as uint32: the key's word
    _build.launch("keyed_drive", "repro_keyed_drive_tenants", col_ids.device,
                  col_ids.data_ptr(), counts.data_ptr(), cur.data_ptr(), b, c,
                  n, seeds.data_ptr(), DRIVE_STREAM, t.data_ptr(),
                  lam.data_ptr(), j_ext)
    return cur, counts
