"""Public wrappers of the port's kernels.

``impl='cuda'`` in core/network.py takes :func:`synapse_matmul`,
:func:`ell_gather` and :func:`lif_step`; ``impl='cuda_fused'`` takes
:func:`fused_step`; both take :func:`stdp_dense_update` under STDP
(core/plasticity.py), and :func:`stdp_remote_update` for the remote
rule. Every impl draws its Poisson drive with :func:`keyed_drive`, the
batched service's tenants with :func:`keyed_drive_tenants`; the other
kernels take the service's tenant axis in their own arguments. Each
wrapper runs its plain PyTorch version for CPU tensors and launches its
CUDA kernel for CUDA tensors, or raises. ``LAUNCHES`` counts the kernel
launches by name.
"""
from __future__ import annotations

from repro_torch.kernels._build import LAUNCHES, library, reset_launches
from repro_torch.kernels.ell_gather import ell_gather
from repro_torch.kernels.fused_step import fused_step
from repro_torch.kernels.keyed_drive import keyed_drive, keyed_drive_tenants
from repro_torch.kernels.lif_step import lif_step
from repro_torch.kernels.stdp_remote import stdp_remote_update
from repro_torch.kernels.stdp_update import stdp_dense_update
from repro_torch.kernels.synapse_matmul import synapse_matmul

__all__ = ["synapse_matmul", "ell_gather", "lif_step", "fused_step",
           "stdp_dense_update", "stdp_remote_update", "keyed_drive",
           "keyed_drive_tenants",
           "LAUNCHES", "reset_launches", "library"]
