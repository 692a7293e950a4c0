"""The shape plan of the port's kernels that keep per-column data in
shared memory (``ell_gather``, ``stdp_remote_update``, ``fused_step``,
``synapse_matmul``):
which path the shapes take, the grid and the shared memory, and that
the CTAs' item shares cover every (column, target block) item exactly
once. No card, no JAX: the plan is computed from the shapes and an SM
count (132 on an H100 SXM)."""
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import plan as P


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


H100_SMS = 132
# the persistent ELL kernels
KERNELS = ("ell_gather", "stdp_remote_update", "fused_step")
ALL = KERNELS + ("synapse_matmul",)
# GRID_24: 1240 neurons per column, 20 stencil offsets, K = 248
N, T24 = 1240, 20 * 1240


def _shares(p):
    """The item ranges of the plan's schedule, in item order."""
    if p.schedule == "static":
        return [p.item_range(cta) for cta in range(p.ctas)]
    return p.claims()


def _covered_once(p):
    seen = [i for r in _shares(p) for i in r]
    return seen == list(range(p.items))


@pytest.mark.parametrize("kernel", KERNELS)
def test_grid24_is_staged_at_two_ctas_per_sm(kernel):
    p = P.plan(kernel, 576, N, T24, H100_SMS)
    assert p.path == "staged" and p.staged
    assert p.ctas == 2 * H100_SMS
    assert p.items == 576 * 5
    assert p.smem_bytes >= 4 * T24                  # the whole row
    assert p.smem_bytes <= P.SMEM_PER_CTA_MAX       # 227 KB
    assert 2 * (p.smem_bytes + P.SMEM_RESERVED_PER_CTA) <= P.SMEM_PER_SM
    # the items of ell_gather and stdp_remote_update cost the same: equal
    # shares of 10 or 11; the fused step's first claims are one column (5
    # items)
    assert max(len(r) for r in _shares(p)) == (5 if kernel == "fused_step"
                                               else 11)
    assert p.schedule == ("claims" if kernel == "fused_step" else "static")


@pytest.mark.parametrize("kernel", KERNELS)
def test_wide_table_takes_the_wide_path(kernel):
    p = P.plan(kernel, 4, N, 180_000, H100_SMS)
    assert p.path == "wide" and not p.staged
    assert p.ctas == p.items == 4 * 5
    assert [len(r) for r in _shares(p)] == [1] * p.items
    assert p.smem_bytes == P.smem_bytes(kernel, False, N, 180_000)
    assert p.smem_bytes < 4 * 180_000               # no row in it


@pytest.mark.parametrize("kernel", KERNELS)
def test_largest_staged_row_and_the_next_straddle_the_budget(kernel):
    lo, hi = 1, 1 << 20                  # staged at lo, wide at hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if P.plan(kernel, 576, N, mid, H100_SMS).staged:
            lo = mid
        else:
            hi = mid
    assert P.smem_bytes(kernel, True, N, lo) <= P.STAGED_BUDGET
    assert P.smem_bytes(kernel, True, N, lo + 1) > P.STAGED_BUDGET
    assert P.plan(kernel, 576, N, lo + 1, H100_SMS).path == "wide"
    assert T24 < lo < 180_000
    # the radius-6 exponential stencil (~145 offsets) is wide
    assert not P.plan(kernel, 576, N, 145 * N, H100_SMS).staged


@pytest.mark.parametrize("c,n,k,o", [(3, 70, 17, 20), (5, 130, 248, 20),
                                     (7, 257, 31, 9)])
@pytest.mark.parametrize("kernel", ALL)
def test_ragged_shapes(kernel, c, n, k, o):
    p = P.plan(kernel, c, n, o * n, H100_SMS)
    assert p.staged
    assert p.items == c * -(-n // P.TARGET_BLOCK)
    assert p.ctas == p.items
    assert _covered_once(p)
    assert [len(r) for r in _shares(p)] == [1] * p.items


@pytest.mark.parametrize("n_cols", [1, 7, 576])
@pytest.mark.parametrize("kernel", ALL)
def test_items_covered_exactly_once(kernel, n_cols):
    p = P.plan(kernel, n_cols, N, T24, H100_SMS)
    assert _covered_once(p)
    sizes = [len(r) for r in _shares(p)]
    assert min(sizes) >= 1
    if p.schedule == "static":          # equal shares
        assert len(sizes) == p.ctas and max(sizes) - min(sizes) <= 1
    else:                               # claims shrink to single items
        assert sizes == sorted(sizes, reverse=True) and sizes[-1] == 1


@pytest.mark.parametrize("c,n,t", [(576, N, T24), (4, N, 180_000),
                                   (5, 130, 20 * 130)])
def test_stdp_remote_update_plans_as_ell_gather(c, n, t):
    """The remote STDP rule stages the same table row as ell_gather, in
    the same grid: staged at GRID_24 (the 99,200-byte pre-trace row), wide
    at T = 180,000, one CTA per item on a ragged grid."""
    p = P.plan("stdp_remote_update", c, n, t, H100_SMS)
    assert p._replace(kernel="ell_gather") == P.plan("ell_gather", c, n, t,
                                                     H100_SMS)
    assert p.path == ("wide" if t == 180_000 else "staged")
    if t == T24:
        assert p.smem_bytes == 4 * T24 == 99_200


def test_grid24_synapse_matmul_one_cta_per_item():
    """One CTA per (column, 256-target block) item, the weight-row ring
    beside the column's spiking-source list and spike values: 32 rows or
    more in flight, and three CTAs to an SM."""
    p = P.plan("synapse_matmul", 576, N, T24, H100_SMS)
    assert p.path == "staged" and p.schedule == "static"
    assert p.ctas == p.items == 576 * 5
    assert [len(r) for r in _shares(p)] == [1] * p.items
    ring = P.RING_STAGES * P.RING_ROWS * P.TARGET_BLOCK * 4
    assert (P.RING_STAGES - 1) * P.RING_ROWS >= 32
    assert p.smem_bytes == ring + 2 * 4 * N + 4 * P.WARPS
    assert 3 * (p.smem_bytes + P.SMEM_RESERVED_PER_CTA) <= P.SMEM_PER_SM
    # the table width is no part of its plan
    assert P.plan("synapse_matmul", 576, N, 180_000, H100_SMS) == p


def test_synapse_matmul_ring_that_does_not_fit_is_refused():
    """The longest column whose list fits beside the ring is planned, the
    next is refused: no slower path stands behind the ring."""
    lo, hi = 1, 1 << 20                  # planned at lo, refused at hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        try:
            P.plan("synapse_matmul", 4, mid, 0, H100_SMS)
            lo = mid
        except ValueError:
            hi = mid
    assert P.smem_bytes("synapse_matmul", True, lo, 0) <= P.SMEM_PER_CTA_MAX
    assert P.smem_bytes("synapse_matmul", True, hi, 0) > P.SMEM_PER_CTA_MAX
    with pytest.raises(ValueError, match="neurons per column"):
        P.plan("synapse_matmul", 4, hi, 0, H100_SMS)
    assert N < lo < 40_000


@pytest.mark.parametrize("b", (1, 2, 4, 8))
def test_grid24_synapse_matmul_takes_one_tenant_a_cta(b):
    """At GRID_24 the B tenants' rows plan as B times the columns: one
    CTA per (tenant, column, target block) item, each CTA the
    single-tenant one (75,488 B, three to an SM), whatever B."""
    p = P.plan("synapse_matmul", b * 576, N, T24, H100_SMS, tenants=b)
    assert (p.path, p.schedule, p.cluster, p.groups) == (
        "staged", "static", 1, 1)
    assert p.ctas == p.items == b * 576 * 5
    assert [len(r) for r in _shares(p)] == [1] * p.items
    one = P.plan("synapse_matmul", 576, N, T24, H100_SMS)
    assert (one.ctas, one.smem_bytes) == (2880, 75_488)
    assert p.smem_bytes == one.smem_bytes
    assert P.SMEM_PER_SM // (p.smem_bytes + P.SMEM_RESERVED_PER_CTA) == 3


@pytest.mark.parametrize("b", (1, 4))
def test_synapse_matmul_refuses_a_column_at_every_width(b):
    """A column whose spiking-source list does not fit beside the ring is
    refused on the tenant axis as it is for one tenant."""
    with pytest.raises(ValueError, match="neurons per column"):
        P.plan("synapse_matmul", b * 2, 20_000, 0, H100_SMS, tenants=b)


def test_plan_refuses_what_no_path_runs():
    with pytest.raises(ValueError, match="unknown kernel"):
        P.plan("lif_step", 4, N, T24, H100_SMS)
    with pytest.raises(ValueError, match="neurons per column"):
        P.plan("fused_step", 4, 40_000, 180_000 * 40, H100_SMS)
    # ell_gather keeps nothing per neuron in shared memory
    assert P.plan("ell_gather", 4, 40_000, 180_000 * 40, H100_SMS).ctas


# what plan() gave a single-tenant launch before the tenant-group path:
# (kernel, C, N, T) -> (path, schedule, ctas, items, smem_bytes)
SINGLE_TENANT = {
    ("ell_gather", 576, N, T24): ("staged", "static", 264, 2880, 99_200),
    ("fused_step", 576, N, T24): ("staged", "claims", 264, 2880, 111_208),
    ("stdp_remote_update", 576, N, T24): ("staged", "static", 264, 2880,
                                          99_200),
    ("synapse_matmul", 576, N, T24): ("staged", "static", 2880, 2880,
                                      75_488),
    ("ell_gather", 4, N, 180_000): ("wide", "static", 20, 20, 0),
    ("fused_step", 4, N, 180_000): ("wide", "claims", 20, 20, 12_008),
    ("fused_step", 7, 257, 9 * 257): ("staged", "claims", 14, 14, 13_432),
}


@pytest.mark.parametrize("key", list(SINGLE_TENANT))
def test_one_tenant_plans_as_before(key):
    """tenants == 1 plans as the single-tenant launch always did, field
    for field; the tenant-group fields keep their defaults."""
    kernel, c, n, t = key
    p = P.plan(kernel, c, n, t, H100_SMS)
    assert p == P.plan(kernel, c, n, t, H100_SMS, tenants=1)
    assert (p.path, p.schedule, p.ctas, p.items,
            p.smem_bytes) == SINGLE_TENANT[key]
    assert (p.tenants, p.cluster, p.groups) == (1, 1, 1)


# tenant widths, and the shapes of one tenant: GRID_24 and a ragged one
TENANT_WIDTHS = (2, 3, 4, 8, 12)
TENANT_SHAPES = ((576, N, T24), (7, 257, 9 * 257))


def _tenant_items(p, n):
    """The (tenant, row, target block) triples of the plan's claims, in
    the order the clusters take them."""
    return [x for r in p.claims() for it in r for x in p.group_item(it, n)]


@pytest.mark.parametrize("c,n,t", TENANT_SHAPES)
@pytest.mark.parametrize("b", TENANT_WIDTHS)
@pytest.mark.parametrize("kernel", P.CLUSTERED)
def test_tenant_groups_cover_every_row_once(kernel, b, c, n, t):
    """The cluster path: groups of at most CLUSTER_MAX tenants (two of six
    at B = 12), clusters of one CTA per tenant of a group, a whole number
    of clusters at two CTAs per SM; the claims over the group items cover
    every (tenant, row, target block) exactly once, each tenant's rows on
    its own CTA rank, a column's target blocks in order."""
    p = P.plan(kernel, b * c, n, t, H100_SMS, tenants=b)
    assert p.path == "cluster" and p.staged and p.schedule == "claims"
    assert p.tenants == b and p.cluster <= P.CLUSTER_MAX
    assert p.groups == -(-b // P.CLUSTER_MAX)
    assert (p.groups, p.cluster) == ((2, 6) if b == 12 else (1, b))
    assert p.ctas % p.cluster == 0
    assert p.ctas <= P.CTAS_PER_SM * H100_SMS
    n_tblk = -(-n // P.TARGET_BLOCK)
    assert p.items == c * p.groups * n_tblk
    seen = _tenant_items(p, n)
    want = [(r // c, r, blk) for r in range(b * c) for blk in range(n_tblk)]
    assert sorted(seen) == want
    for tenant, row, _ in seen:
        assert row == tenant * c + row % c
    # within one (tenant, column) the target blocks come in order
    for r in range(0, b * c, max(1, b * c // 5)):
        assert [blk for _, row, blk in seen if row == r] == list(
            range(n_tblk))


@pytest.mark.parametrize("c,n,t", TENANT_SHAPES)
@pytest.mark.parametrize("b", TENANT_WIDTHS)
@pytest.mark.parametrize("kernel", P.CLUSTERED)
def test_tenant_groups_fit_two_ctas_per_sm(kernel, b, c, n, t):
    """A cluster CTA keeps what a staged CTA keeps (ell_gather also its
    claimed chunk), so two fit on an SM; the wide path stays the wide path
    for every width."""
    p = P.plan(kernel, b * c, n, t, H100_SMS, tenants=b)
    one = P.plan(kernel, c, n, t, H100_SMS)
    assert p.smem_bytes == one.smem_bytes + (16 if kernel == "ell_gather"
                                             else 0)
    assert p.smem_bytes <= P.STAGED_BUDGET
    assert P.CTAS_PER_SM * (p.smem_bytes + P.SMEM_RESERVED_PER_CTA) <= \
        P.SMEM_PER_SM
    wide = P.plan(kernel, b * 4, N, 180_000, H100_SMS, tenants=b)
    assert wide.path == "wide" and wide.tenants == b
    assert wide.ctas == wide.items == b * 4 * 5


def test_other_kernels_ignore_the_tenant_groups():
    """Only ell_gather and fused_step take the cluster path."""
    for kernel in ("stdp_remote_update", "synapse_matmul"):
        p = P.plan(kernel, 4 * 576, N, T24, H100_SMS, tenants=4)
        assert p.path == "staged" and p.cluster == 1
    with pytest.raises(ValueError, match="whole number"):
        P.plan("fused_step", 10, N, T24, H100_SMS, tenants=4)


def test_ptxas_report_reads_registers_and_spills():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z1aILb1EEvv' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _Z1aILb1EEvv",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 72 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, used 0 barriers",
    ])
    assert _build.ptxas_report(log) == {
        "_Z1aILb1EEvv": {"registers": 72, "spill_bytes": 12},
        "_Z1bv": {"registers": 32, "spill_bytes": 0}}
