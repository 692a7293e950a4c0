"""Gradient compression and exact spike-halo payload accounting (the
port of ``repro/runtime/compression.py``).

* :func:`compress_grads` / :func:`decompress_grads`: int8 gradient
  quantization with error feedback (the residual is carried to the next
  step, so the compression is unbiased over time), one scale per leaf;
  ``launch/train.py`` runs the round trip when
  ``TrainConfig.grad_compression == "int8_ef"``, the residual in the
  optimizer state's ``"ef"`` slot. The leaves are the reference's,
  stacked (``optim/optimizer.py``), so each scale spans what the
  reference's does.
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
bound, not by the realised activity. Under STDP (``stdp``, default
``cfg.stdp``) the pre-trace strips ride beside the spikes as raw
float32: a dense ``a*b*N*4`` bytes per send, or on the flat AER wire
``4*cap`` bytes of trace values at the list's addresses. Integer math,
so every number equals the reference's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.exchange import aer_capacity, halo_ring_widths
from repro_torch.runtime.transport import packed_width


class EFState(NamedTuple):
    residual: dict      # float32, keyed like the gradients


def ef_init(grads_like: dict) -> EFState:
    return EFState(residual={k: torch.zeros(x.shape, dtype=torch.float32,
                                            device=x.device)
                             for k, x in grads_like.items()})


def _q8(x):
    scale = torch.max(torch.abs(x)) / 127.0
    q = torch.round(x / torch.clamp_min(scale, 1e-12)).to(torch.int8)
    return q, scale


def _dq8(q, scale):
    return q.float() * scale


@torch.no_grad()
def compress_grads(grads: dict, ef: EFState):
    """({leaf: (int8 q, float32 scale)}, the new EF state carrying this
    step's quantization error)."""
    qtree, residual = {}, {}
    for k, g in grads.items():
        x = g.float() + ef.residual[k]
        q, s = _q8(x)
        qtree[k] = (q, s)
        residual[k] = x - _dq8(q, s)
    return qtree, EFState(residual=residual)


@torch.no_grad()
def decompress_grads(qtree: dict, grads_like: dict) -> dict:
    return {k: _dq8(q, s).to(grads_like[k].dtype)
            for k, (q, s) in qtree.items()}


# ---------------------------------------------------------------------------
# Spike-halo payload accounting (dense_packed vs aer_sparse)
# ---------------------------------------------------------------------------

def _plastic(cfg, stdp) -> bool:
    return cfg.stdp if stdp is None else stdp


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
    dense). Under STDP each send adds its trace strip: a*b*N*4 bytes
    (dense and ``auto``, whose choice the trace never sways), or ``4 *
    cap`` (AER: trace values at the list's addresses)."""
    plastic = _plastic(cfg, stdp)
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
        if plastic:
            bytes_ += 4 * cap if mode == "aer_sparse" else a * b * n * 4
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
    ``nu* = (dense_bytes - overhead) / (4 * (1 + stdp) * factor * dt *
    M)`` (the static ``1 / (32 * factor * dt)`` up to that overhead;
    under STDP the dense side carries the float32 trace strips and each
    event its trace value)."""
    plastic = _plastic(cfg, stdp)
    dense = halo_payload_bytes(cfg, spec, mode="dense_packed",
                               stdp=plastic)["bytes_per_step"]
    sends = halo_send_shapes(spec)
    m_units = sum(a * b for a, b in sends) * cfg.neurons_per_column
    overhead = 4 * len(sends) * 2            # count word + ceil slack bound
    per_event = 4 * (2 if plastic else 1)
    dt_s = cfg.neuron.dt_ms * 1e-3
    return max(0.0, (dense - overhead) / (
        per_event * cfg.conn.aer_capacity_factor * dt_s * m_units))


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
    counterpart of :func:`halo_payload_bytes`. Under STDP every strip
    adds its dense float32 trace, and the gathered frame the rank's raw
    trace frame."""
    plastic = _plastic(cfg, stdp)
    mode = mode or cfg.conn.exchange_mode
    n = cfg.neurons_per_column
    g = node.ranks_per_node
    table = ring_mode_table(cfg, spec, node, rate_bound_hz=rate_bound_hz,
                            compress=compress)
    inter = 0
    caps = []
    for e in table:
        bytes_ = _ring_bytes(e, mode)
        if plastic:
            bytes_ += e["rows"] * e["cols"] * n * 4   # dense f32 trace
        inter += 2 * bytes_                           # both directions
        if (e["mode"] if mode == "auto" else mode) == "aer_sparse":
            caps.append(e["aer_capacity"])
    frame = spec.tile_h * spec.tile_w * (
        packed_width(n) * 4 if compress else n * 4)
    if plastic:
        frame += spec.tile_h * spec.tile_w * n * 4
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
    node. Under STDP each strip adds its trace: ``4 * cap`` on the flat
    AER wire, dense float32 otherwise."""
    plastic = _plastic(cfg, stdp)
    mode = mode or cfg.conn.exchange_mode
    n = cfg.neurons_per_column
    table = ring_mode_table(cfg, spec, node if hierarchical else None,
                            rate_bound_hz=rate_bound_hz, compress=compress)

    def strip_bytes(e):
        b = _ring_bytes(e, mode)
        if plastic:
            if mode == "aer_sparse" and not hierarchical:
                b += 4 * e["aer_capacity"]
            else:
                b += e["rows"] * e["cols"] * n * 4
        return b
    if hierarchical:
        links_h = node.nodes_y * (node.nodes_x - 1)
        links_v = node.nodes_x * (node.nodes_y - 1)
    else:
        links_h = spec.tiles_y * (node.nodes_x - 1)
        links_v = spec.tiles_x * (node.nodes_y - 1)
    total = messages = 0
    for e in table:
        links = links_h if e["phase"] == "h" else links_v
        total += 2 * links * strip_bytes(e)
        messages += 2 * links
    return {"bytes_per_step": total, "messages_per_step": messages,
            "mode": mode, "hierarchical": hierarchical}
