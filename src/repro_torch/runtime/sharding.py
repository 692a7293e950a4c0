"""The batched service's tenant axis over processes (the port of the
service part of ``repro/runtime/sharding.py``).

The reference's service mesh is a ``('batch', 'data', 'model')`` device
mesh: tenants shard over ``'batch'``, and every batch shard runs the
full spatial column mesh. The port has no device mesh. Its transports
are the mesh: a :class:`~repro_torch.runtime.transport.LocalMesh` holds
every shard of the spatial grid in one process, and a
:class:`~repro_torch.runtime.transport.ProcessGroupMesh` with
``batch_shards`` K splits the ranks of the default process group into K
batch shards of ``world / K`` spatial ranks each, batch-major: ranks
``[k*S, (k+1)*S)`` form batch shard k. Tenants never cross a batch
shard; only the per-tenant totals do.

The LM rules of the reference's file wait for the LM zoo (ROADMAP queue
1 item 8). Nothing here initialises a process group or touches a device
at import.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.core.partition import process_grid
from repro_torch.runtime.transport import LocalMesh, ProcessGroupMesh


def service_mesh(batch_shards: int, rows: int, cols: int, device="cuda", *,
                 compress: bool = True):
    """The transport of a batched service run: ``batch_shards`` tenant
    shards, each over a ``rows x cols`` spatial shard grid.

    Without an initialised process group this process is the one rank,
    so only ``batch_shards == 1`` fits: a :class:`LocalMesh` of every
    shard. With one, the world must hold ``batch_shards * rows * cols``
    ranks, one shard each, on the closest-to-square grid
    (``partition.process_grid``): a :class:`ProcessGroupMesh`, its strips
    packed into words unless ``compress`` is False. Raises
    with all three factors named when the rank count does not match, as
    the reference names its device count."""
    ranks = dist.is_initialized()
    have = dist.get_world_size() if ranks else 1
    need = batch_shards * rows * cols
    if batch_shards < 1 or (have != need if ranks else batch_shards != 1):
        raise ValueError(
            f"service mesh {batch_shards}(batch) x {rows}(data) x "
            f"{cols}(model) needs {need} ranks, have {have}")
    if not ranks:
        return LocalMesh(rows, cols, device)
    if process_grid(rows * cols) != (rows, cols):
        raise ValueError(
            f"service mesh {rows}x{cols}: the ranks of a batch shard take "
            f"the process grid {process_grid(rows * cols)}")
    return ProcessGroupMesh(device, compress=compress,
                            batch_shards=batch_shards)


def batch_shards(mesh) -> int:
    """Size of the tenant axis (1 when the transport has none)."""
    return getattr(mesh, "batch_shards", 1)


def local_tenants(mesh, batch: int) -> range:
    """Which of ``batch`` tenants this process holds: the role of the
    reference's ``tenant_pspec`` / ``tenant_shardings``, which place
    (B, ...) leaves over the ``'batch'`` axis. Torch has no
    ``PartitionSpec``: a process holds the contiguous block
    ``[k*b_local, (k+1)*b_local)`` of its batch shard k, with ``b_local
    = batch // batch_shards``, every tenant on a transport without a
    tenant axis. Raises with the reference's text when the shards do
    not divide the batch."""
    b_local = tenants_per_shard(batch, batch_shards(mesh))
    first = getattr(mesh, "batch_index", 0) * b_local
    return range(first, first + b_local)


def tenants_per_shard(batch: int, batch_shards: int) -> int:
    """``batch // batch_shards``, or the reference's error naming both."""
    if batch % batch_shards:
        raise ValueError(
            f"batch={batch} tenants do not divide over the mesh's "
            f"batch axis of {batch_shards} shards — choose batch as a "
            f"multiple of {batch_shards} (each shard runs "
            f"batch/batch_shards tenants in lockstep)")
    return batch // batch_shards
