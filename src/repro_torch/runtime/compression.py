"""Exact spike-halo payload accounting (the port of the
``dense_packed`` part of ``repro/runtime/compression.py``).

Bytes per simulation step that one interior rank sends under the
two-phase chained-ring exchange of ``core/exchange.py``: horizontal
rings near-to-far, then vertical rings over the horizontally-extended
strips, in exactly the order the exchange sends them. Integer math,
so the numbers equal the reference's. Open-boundary shards send fewer;
the interior rank is what the network has to sustain. The AER,
per-ring ``auto`` and hierarchical accounting wait for ROADMAP queue 1
item 3.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.exchange import halo_ring_widths
from repro_torch.runtime.transport import packed_width


def halo_send_shapes(spec) -> list:
    """``[(rows, cols), ...]`` per send of one interior rank: horizontal
    rings slice (tile_h, w) strips off the tile, vertical rings (w,
    tile_w + 2r) strips off the horizontally-extended array (corners
    ride along). Multiply by N for units."""
    sends = []
    r = spec.radius
    for w in halo_ring_widths(r, spec.tile_w):      # east + west
        sends += [(spec.tile_h, w)] * 2
    for w in halo_ring_widths(r, spec.tile_h):      # south + north
        sends += [(w, spec.tile_w + 2 * r)] * 2
    return sends


def halo_payload_bytes(cfg, spec, *, mode: Optional[str] = None,
                       compress: bool = True) -> dict:
    """Wire bytes one interior rank sends per step for its spike halo
    under ``dense_packed``: each (a, b, N) strip crosses as
    a*b*ceil(N/32) 32-bit words, or raw a*b*N f32 with ``compress=False``.
    Activity-independent."""
    mode = mode or cfg.conn.exchange_mode
    if mode != "dense_packed":
        raise NotImplementedError(
            f"exchange mode {mode!r}: the AER and per-ring 'auto' "
            f"accounting waits for ROADMAP queue 1 item 3")
    if cfg.stdp:
        raise NotImplementedError(
            "the STDP trace strips' bytes wait for multi-rank STDP "
            "(ROADMAP queue 1 item 4)")
    n = cfg.neurons_per_column
    sends = halo_send_shapes(spec)
    total = 0
    for (a, b) in sends:
        total += a * b * packed_width(n) * 4 if compress else a * b * n * 4
    return {
        "mode": mode,
        "bytes_per_step": total,
        "n_messages": len(sends),
        "units_per_step": sum(a * b for a, b in sends) * n,
        "aer_capacities": [],
    }
