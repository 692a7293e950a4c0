"""Exact spike-halo payload accounting (the port of the halo part of
``repro/runtime/compression.py``; its int8 gradient compression belongs
to the LM zoo).

* :func:`halo_payload_bytes` / :func:`aer_crossover_rate_hz`: bytes per
  simulation step that one interior rank sends for its spike halo under
  each wire format (``dense_packed`` bit-packing, ``aer_sparse`` event
  lists, per-ring ``auto``), and the rate bound below which AER is the
  smaller.
* :func:`ring_send_entries` / :func:`ring_mode_table`: the same per halo
  ring, the table behind ``ExchangeConfig.exchange_mode == "auto"`` and,
  with a ``NodeSpec``, the node-level rings of the hierarchical exchange.
* :func:`hier_payload_bytes` / :func:`internode_totals`: the two-level
  exchange's split into intra-node and inter-node bytes, and the
  sheet-wide bytes crossing node boundaries, flat or hierarchical.

Sends are enumerated for the interior (worst-case) rank or node, in the
exchange's own order (horizontal rings near to far, then vertical rings
over the horizontally-extended strips), so ``(phase, ring)`` keys index
the sends ``core/exchange.py`` makes. Dense strips cross as
``ceil(N/32)`` 32-bit words per column unless ``compress=False``; an AER
list is ``int32[1 + cap]`` with a capacity set by the configured rate
bound, not by the realised activity. Integer math, so every number
equals the reference's. The STDP trace strips' bytes wait for
multi-rank STDP (ROADMAP queue 1 item 4).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.exchange import aer_capacity, halo_ring_widths
from repro_torch.runtime.transport import packed_width


def _static(cfg, stdp) -> None:
    if cfg.stdp if stdp is None else stdp:
        raise NotImplementedError(
            "the STDP trace strips' bytes wait for multi-rank STDP "
            "(ROADMAP queue 1 item 4)")


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
                       rate_bound_hz: Optional[float] = None,
                       stdp: Optional[bool] = None,
                       compress: bool = True) -> dict:
    """Wire bytes one interior rank sends per step for its spike halo
    (keys default to ``cfg``'s own settings). ``dense_packed``: each (a,
    b, N) strip crosses as a*b*ceil(N/32) 32-bit words, or raw a*b*N f32
    with ``compress=False``; activity-independent. ``aer_sparse``: each
    strip is one ``int32[1 + cap]`` event list with ``cap =
    ceil(factor * a*b*N * rate_bound * dt)`` (``exchange.aer_capacity``).
    ``auto`` prices each send at the cheaper of the two (ties go
    dense)."""
    _static(cfg, stdp)
    mode = mode or cfg.conn.exchange_mode
    rate = (cfg.conn.aer_rate_bound_hz if rate_bound_hz is None
            else rate_bound_hz)
    n = cfg.neurons_per_column
    sends = halo_send_shapes(spec)
    total = 0
    caps = []
    for (a, b) in sends:
        dense = (a * b * packed_width(n) * 4 if compress
                 else a * b * n * 4)
        cap = aer_capacity(a * b * n, rate, cfg.conn.aer_capacity_factor,
                           cfg.neuron.dt_ms)
        aer = 4 * (1 + cap)                  # count:int32 + addr:int32[cap]
        if mode == "dense_packed":
            bytes_ = dense
        elif mode == "aer_sparse" or (mode == "auto" and aer < dense):
            caps.append(cap)
            bytes_ = aer
        elif mode == "auto":
            bytes_ = dense
        else:
            raise ValueError(f"unknown exchange mode {mode!r}")
        total += bytes_
    return {
        "mode": mode,
        "bytes_per_step": total,
        "n_messages": len(sends),
        "units_per_step": sum(a * b for a, b in sends) * n,
        "aer_capacities": caps,
    }


def aer_crossover_rate_hz(cfg, spec, *, stdp: Optional[bool] = None
                          ) -> float:
    """The firing-rate bound below which the AER event list is smaller
    on the wire than 32x bit-packing for this tile geometry: equating
    ``4 * factor * nu * dt * M`` with the packed bytes over the summed
    strip units M, less the per-send count words and ceil slack, gives
    ``nu* = (dense_bytes - overhead) / (4 * factor * dt * M)`` (the
    static ``1 / (32 * factor * dt)`` up to that overhead)."""
    _static(cfg, stdp)
    dense = halo_payload_bytes(cfg, spec, mode="dense_packed",
                               stdp=stdp)["bytes_per_step"]
    sends = halo_send_shapes(spec)
    m_units = sum(a * b for a, b in sends) * cfg.neurons_per_column
    overhead = 4 * len(sends) * 2            # count word + ceil slack bound
    dt_s = cfg.neuron.dt_ms * 1e-3
    return max(0.0, (dense - overhead) / (
        4 * cfg.conn.aer_capacity_factor * dt_s * m_units))


def ring_send_entries(spec, node=None) -> list:
    """One entry ``{"phase": "h"|"v", "ring": k, "rows": a, "cols": b}``
    per (phase, ring) of the chained-ring exchange, in its order; each
    strip is sent twice a step (once per direction). With a ``NodeSpec``
    the strips are the node-level sends of the hierarchical exchange,
    over the (group_h*tile_h) x (group_w*tile_w) node frame."""
    gh = node.group_h if node is not None else 1
    gw = node.group_w if node is not None else 1
    rows, cols = gh * spec.tile_h, gw * spec.tile_w
    r = spec.radius
    entries = []
    for k, w in enumerate(halo_ring_widths(r, cols), start=1):
        entries.append({"phase": "h", "ring": k, "rows": rows, "cols": w})
    for k, w in enumerate(halo_ring_widths(r, rows), start=1):
        entries.append({"phase": "v", "ring": k, "rows": w,
                        "cols": cols + 2 * r})
    return entries


def ring_mode_table(cfg, spec, node=None, *,
                    rate_bound_hz: Optional[float] = None,
                    compress: bool = True) -> list:
    """The per-ring wire-format table behind ``exchange_mode == "auto"``:
    each (phase, ring) send's spike bytes in both formats at the rate
    bound, and the smaller (``"mode"``; ties go dense). Geometry decides,
    not distance: AER bytes have a floor (``cap >= 1`` and a count word),
    so a narrow far ring can resolve dense where a wide near ring resolves
    AER."""
    rate = (cfg.conn.aer_rate_bound_hz if rate_bound_hz is None
            else rate_bound_hz)
    n = cfg.neurons_per_column
    table = []
    for e in ring_send_entries(spec, node):
        units = e["rows"] * e["cols"] * n
        dense = (e["rows"] * e["cols"] * packed_width(n) * 4 if compress
                 else units * 4)
        cap = aer_capacity(units, rate, cfg.conn.aer_capacity_factor,
                           cfg.neuron.dt_ms)
        aer = 4 * (1 + cap)
        table.append(dict(e, dense_bytes=dense, aer_bytes=aer,
                          aer_capacity=cap,
                          mode="aer_sparse" if aer < dense
                          else "dense_packed"))
    return table


def _ring_bytes(e, mode: str) -> int:
    """One node-level strip's bytes under ``mode`` (``auto``: the
    table's choice)."""
    ring_mode = e["mode"] if mode == "auto" else mode
    if ring_mode == "dense_packed":
        return e["dense_bytes"]
    if ring_mode == "aer_sparse":
        return e["aer_bytes"]
    raise ValueError(f"unknown exchange mode {mode!r}")


def hier_payload_bytes(cfg, spec, node, *, mode: Optional[str] = None,
                       rate_bound_hz: Optional[float] = None,
                       stdp: Optional[bool] = None,
                       compress: bool = True) -> dict:
    """Per-step byte split of the hierarchical exchange for one interior
    node of ``g`` ranks. Intra-node, per rank: its tile frame to the g-1
    peers of the all-gather, and one broadcast copy of every inter-node
    strip. Inter-node, per node: one message per neighbour node, ring
    and direction, each strip priced by the node-level
    :func:`ring_mode_table` (``auto``) or uniformly. ``bytes_per_step``
    is the per-rank total (inter bytes shared by the g members), the
    counterpart of :func:`halo_payload_bytes`."""
    _static(cfg, stdp)
    mode = mode or cfg.conn.exchange_mode
    n = cfg.neurons_per_column
    g = node.ranks_per_node
    table = ring_mode_table(cfg, spec, node, rate_bound_hz=rate_bound_hz,
                            compress=compress)
    inter = 0
    caps = []
    for e in table:
        inter += 2 * _ring_bytes(e, mode)             # both directions
        if (e["mode"] if mode == "auto" else mode) == "aer_sparse":
            caps.append(e["aer_capacity"])
    frame = spec.tile_h * spec.tile_w * (
        packed_width(n) * 4 if compress else n * 4)
    intra = (g - 1) * frame + inter                   # gather + broadcast rx
    return {
        "mode": mode,
        "ranks_per_node": g,
        "node_grid": [node.nodes_y, node.nodes_x],
        "inter_node_bytes_per_node": inter,
        "inter_node_messages_per_node": 2 * len(table),
        "intra_node_bytes_per_rank": intra,
        "bytes_per_step": intra + inter // g,
        "per_ring": table,
        "aer_capacities": caps,
    }


def internode_totals(cfg, spec, node, *, hierarchical: bool,
                     mode: Optional[str] = None,
                     rate_bound_hz: Optional[float] = None,
                     stdp: Optional[bool] = None,
                     compress: bool = True) -> dict:
    """Sheet-wide bytes and messages crossing a node boundary per step.
    Flat: every rank sends every ring to its ring neighbour, so each of
    the ``tiles_y * (nodes_x - 1)`` vertical node seams carries per-rank
    strips (and transposed for the horizontal seams), the vertical-phase
    strips' corner columns once per rank. Hierarchical: one message per
    neighbour-node pair and node-level ring, the corners once per
    node."""
    _static(cfg, stdp)
    mode = mode or cfg.conn.exchange_mode
    table = ring_mode_table(cfg, spec, node if hierarchical else None,
                            rate_bound_hz=rate_bound_hz, compress=compress)
    if hierarchical:
        links_h = node.nodes_y * (node.nodes_x - 1)
        links_v = node.nodes_x * (node.nodes_y - 1)
    else:
        links_h = spec.tiles_y * (node.nodes_x - 1)
        links_v = spec.tiles_x * (node.nodes_y - 1)
    total = messages = 0
    for e in table:
        links = links_h if e["phase"] == "h" else links_v
        total += 2 * links * _ring_bytes(e, mode)
        messages += 2 * links
    return {"bytes_per_step": total, "messages_per_step": messages,
            "mode": mode, "hierarchical": hierarchical}
