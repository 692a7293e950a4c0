"""Bytes and float32 operations of one ``fused_step`` launch: the
arithmetic of the kernel checks that time it beside its bound, for B
tenants over one network.

Each byte counted once: the weight rows of the sources that spiked (all
that the local product needs), the ELL indices and weights (shared by
the tenants when the weights are, once per tenant when each trains its
own), each tenant's neighbour table, spikes, drive and state in and out,
and under STDP the two traces in and out. Operations: a multiply-add
(2) per weight row element read and per ELL slot, 14 per neuron for the
currents and LIF+SFA.
"""


def work(*, columns: int, n: int, k: int, table: int, tenants: int,
         spiking_rows: float, stdp: bool, own_weights: bool) -> tuple:
    """``(bytes, flops)`` of one launch. ``spiking_rows``: the sources
    that spiked in this step's local frame, summed over the tenants;
    ``table``: the neighbour table's length a column (offsets x N)."""
    f4, c, b = 4, columns, tenants
    rows = spiking_rows * n * f4
    ell = 2 * c * n * k * f4 * (b if own_weights else 1)
    per_tenant = 2 * c * n * f4 + c * table * f4 + 7 * c * n * f4
    if stdp:
        per_tenant += 4 * c * n * f4
    nbytes = rows + ell + b * per_tenant
    flops = 2 * spiking_rows * n + b * (2 * c * n * k + 14 * c * n)
    return nbytes, flops
