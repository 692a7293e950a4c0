"""Shape plan of the kernels that keep per-column data in shared memory:
``ell_gather``, ``stdp_remote_update``, ``fused_step`` and
``synapse_matmul``. Which path they take, their grid and their shared
memory.

All four work in (column, target block) items of ``TARGET_BLOCK``
targets (ELL rows), one thread per target or one warp per row.

The ELL kernels: on the **staged** path a CTA copies its column's
neighbour-table row (spikes, or pre-traces for ``stdp_remote_update``)
into shared memory and gathers from there; CTAs are persistent,
``CTAS_PER_SM`` per SM, and reload the row only when the column changes.
A table row too wide for that budget takes the **wide** path: the table
is read from device memory through L2, one CTA per item.

``synapse_matmul`` (always **staged**) streams the weight rows of its
column's spiking sources through a ring of ``RING_STAGES`` stages of
``RING_ROWS`` rows in shared memory, one CTA per item; a column too long
for its list of spiking sources to fit beside the ring is refused.

How the items are shared out (``schedule``): the items of ``ell_gather``
and ``stdp_remote_update`` all cost the same, so each CTA takes a
contiguous, equal share
(:meth:`Plan.item_range`); ``synapse_matmul``'s CTAs take one item each,
the same static schedule with as many CTAs as items. ``fused_step``'s
items do not cost the same (an item's local product reads one weight row
per spiking source of its column, and spikes cluster), so its CTAs claim
chunks in order from a counter, about ``remaining / (2 * ctas)`` items a
claim and at least one (:meth:`Plan.claims` replays the claims one after
another).

The tenant axis of ``ell_gather`` and ``fused_step`` (B > 1 tenants of
C columns, ``n_cols`` = B * C rows) takes the **cluster** path where the
staged path would hold the table: tenant groups of at most
``CLUSTER_MAX`` (``groups`` of ``cluster`` tenants, the last possibly
short) run as thread-block clusters of one CTA per tenant,
``CTAS_PER_SM`` per SM, whose CTAs walk the same group items (column,
group, target block) together, so that each ELL block comes from HBM
once a group (``csrc/kernels.cuh``, ``cluster_claim``). The clusters
claim chunks of group items as ``fused_step``'s CTAs claim items
(:meth:`Plan.claims`, :meth:`Plan.group_item`). Wide tables take the
wide path over (column, tenant, target block) items.

The path is chosen here, from the shapes alone, never on failure; the
wrappers call :func:`plan` and pass its choice down to the C entry point,
which returns an error if asked for more shared memory than the card's
block can hold, or for a cluster it cannot place. ``csrc/kernels.cuh``
mirrors ``TARGET_BLOCK``, the rings and the shared-memory layouts
(``ell_gather_smem``, which ``stdp_remote_update`` shares,
``fused_step_smem``, ``synapse_matmul_smem``, ``ell_gather_cluster_smem``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

TARGET_BLOCK = 256           # threads per CTA, targets per item (repro::TB)
WARPS = TARGET_BLOCK // 32
# Hopper (H100): shared memory per SM, the part the system keeps per CTA,
# and the most one CTA may opt in to
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_CTA = 1_024
SMEM_PER_CTA_MAX = 232_448
CTAS_PER_SM = 2
#: the most a staged CTA may take so that CTAS_PER_SM fit on an SM
STAGED_BUDGET = SMEM_PER_SM // CTAS_PER_SM - SMEM_RESERVED_PER_CTA
#: synapse_matmul's ring (repro::SM_ROWS, repro::SM_STAGES): rows a stage,
#: stages; (RING_STAGES - 1) * RING_ROWS rows in flight
RING_ROWS = 16
RING_STAGES = 4
KERNELS = ("ell_gather", "stdp_remote_update", "fused_step",
           "synapse_matmul")
#: kernels whose items cost the same: equal, contiguous shares
STATIC = ("ell_gather", "stdp_remote_update")
#: the cluster path: the kernels that take it, and the most tenants (CTAs)
#: a cluster (repro::CLUSTER_MAX, the portable cluster size)
CLUSTERED = ("ell_gather", "fused_step")
CLUSTER_MAX = 8


class Plan(NamedTuple):
    kernel: str
    path: str             # "staged", "wide" or "cluster"
    schedule: str         # "static" shares or "claims" from a counter
    ctas: int
    items: int            # (column, target block) items, group items
    smem_bytes: int       # dynamic shared memory per CTA
    # the tenants; on the cluster path also the CTAs (tenants) a cluster
    # and the tenant groups (1 and 1 on the others)
    tenants: int = 1
    cluster: int = 1
    groups: int = 1

    @property
    def staged(self) -> bool:
        """Whether the table row is staged in shared memory."""
        return self.path in ("staged", "cluster")

    @property
    def path_code(self) -> int:
        """The C entry points' ``path``: 0 wide, 1 staged, 2 cluster."""
        return ("wide", "staged", "cluster").index(self.path)

    def group_item(self, item: int, n: int) -> list[tuple[int, int, int]]:
        """The (tenant, row, target block) triples that cluster group
        item ``item`` covers at ``n`` targets a column, one per CTA rank
        that has a tenant (``repro::group_item``)."""
        n_tblk = -(-n // TARGET_BLOCK)
        per_col = self.groups * n_tblk
        col, rest = divmod(item, per_col)
        grp, tblk = divmod(rest, n_tblk)
        n_cols = self.items // per_col
        return [(b, b * n_cols + col, tblk)
                for b in range(grp * self.cluster, (grp + 1) * self.cluster)
                if b < self.tenants]

    def item_range(self, cta: int) -> range:
        """The items of CTA ``cta`` under the static schedule, as
        ``ell_gather_kernel`` splits them."""
        return range(cta * self.items // self.ctas,
                     (cta + 1) * self.items // self.ctas)

    def claims(self) -> list[range]:
        """The chunks of the claim schedule, claimed one after another
        (``fused_step_kernel``'s claims, each from the counter it saw; on
        the cluster path each cluster claims, ``TenantRing::claim``)."""
        out, start = [], 0
        claimers = self.ctas // self.cluster
        while start < self.items:
            size = max(1, (self.items - start) // (2 * claimers))
            out.append(range(start, min(start + size, self.items)))
            start += size
        return out


def _round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def smem_bytes(kernel: str, staged: bool, n: int, t_len: int) -> int:
    """Dynamic shared memory of one CTA: the table row when staged (all
    that ``ell_gather`` and ``stdp_remote_update`` keep); for
    ``fused_step`` also the column's spikes and spiking-source list (n
    each), the ELL sums of two items, per-warp counts and the claimed
    chunk; for ``synapse_matmul`` (``staged`` and ``t_len`` unused) the
    ring, at least as large as the column's spikes staged in it, the
    spiking-source list and its spike values (n each) and per-warp
    counts."""
    if kernel == "synapse_matmul":
        ring = max(RING_STAGES * RING_ROWS * TARGET_BLOCK * 4,
                   _round16(4 * n))
        return ring + 2 * _round16(4 * n) + 4 * WARPS
    table = _round16(4 * t_len) if staged else 0
    if kernel in STATIC:
        return table
    return table + 2 * _round16(4 * n) + 8 * TARGET_BLOCK + 4 * WARPS + 8


def tenant_groups(tenants: int) -> tuple[int, int]:
    """(groups, CTAs a cluster) for ``tenants`` tenants: as few groups of
    at most CLUSTER_MAX as hold them, as even as they can be."""
    groups = -(-tenants // CLUSTER_MAX)
    return groups, -(-tenants // groups)


def plan(kernel: str, n_cols: int, n: int, t_len: int, sm_count: int,
         tenants: int = 1) -> Plan:
    """The path, grid and shared memory of ``kernel`` for ``n_cols``
    columns (``tenants`` * C rows on the tenant axis) of ``n`` targets
    gathering from ``t_len``-wide table rows (unused by
    ``synapse_matmul``), on a card with ``sm_count`` SMs."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r} (expected {KERNELS})")
    if tenants < 1 or n_cols % tenants:
        raise ValueError(f"{kernel}: {n_cols} rows are not a whole number "
                         f"of {tenants} tenants' columns")
    items = n_cols * -(-n // TARGET_BLOCK)
    smem = smem_bytes(kernel, True, n, t_len)
    if kernel == "synapse_matmul":
        if smem > SMEM_PER_CTA_MAX:
            raise ValueError(
                f"{kernel}: {n} neurons per column need {smem} B of shared "
                f"memory per CTA beside the ring, more than the "
                f"{SMEM_PER_CTA_MAX} B a CTA may have")
        return Plan(kernel, "staged", "static", items, items, smem)
    # ell_gather's cluster instance keeps the claimed chunk beside the row
    cluster_smem = smem + (16 if kernel == "ell_gather" else 0)
    if (tenants > 1 and kernel in CLUSTERED
            and cluster_smem <= STAGED_BUDGET):
        groups, cluster = tenant_groups(tenants)
        items = n_cols // tenants * groups * -(-n // TARGET_BLOCK)
        clusters = min(items, CTAS_PER_SM * sm_count // cluster)
        return Plan(kernel, "cluster", "claims", clusters * cluster, items,
                    cluster_smem, tenants, cluster, groups)
    if smem <= STAGED_BUDGET:
        path, ctas = "staged", min(items, CTAS_PER_SM * sm_count)
    else:
        smem = smem_bytes(kernel, False, n, t_len)
        if smem > SMEM_PER_CTA_MAX:
            raise ValueError(
                f"{kernel}: {n} neurons per column need {smem} B of shared "
                f"memory per CTA, more than the {SMEM_PER_CTA_MAX} B a CTA "
                f"may have")
        path, ctas = "wide", items
    schedule = "static" if kernel in STATIC else "claims"
    return Plan(kernel, path, schedule, ctas, items, smem, tenants)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device (cudaDevAttrMultiProcessorCount)."""
    return torch.cuda.get_device_properties(device).multi_processor_count
