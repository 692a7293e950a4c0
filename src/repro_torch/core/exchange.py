"""Distributed DPSNN step: stacked shards and the two-phase halo
exchange (the port of ``repro/core/exchange.py``'s multi-rank step,
static and plastic).

* Columns are tiled 2-D over a shard grid (``core/partition.py``). A
  process holds a stack of shards: every :class:`DistState` leaf carries
  a leading local-shard axis ``(S_local, ...)`` in process-major order,
  the layout of the reference's ``stacked_state_template``. On a
  :class:`~repro_torch.runtime.transport.LocalMesh` ``S_local`` is every
  tile of the grid, on a ``ProcessGroupMesh`` its ``shards_per_rank``
  (1 by default).
* Per step, each shard exchanges only the halo strips of the newly
  emitted spike frame, in two phases (horizontal rings, then vertical
  rings of the horizontally-extended strips, so corners arrive without
  diagonal sends). A stencil of radius R runs ceil(R / tile) chained
  rings per direction.
* Wire formats (``ConnectivityConfig.exchange_mode``): ``dense_packed``
  strips cross in the transport's format (a ``ProcessGroupMesh`` packs
  them into 32-bit words, ``transport.pack_spikes``; a ``LocalMesh``
  moves them as they are); ``aer_sparse`` strips cross as the paper's
  event lists ``(count, addresses[cap])`` (:func:`aer_encode`), encoded
  and decoded on every transport, moved raw. A list truncates at its
  capacity and raises the shard's saturation flag for that step
  (``DistState.aer_sat``, ``DistResult.aer_saturated``); no spike is
  dropped in silence. ``ExchangeConfig.exchange_mode == "auto"`` picks
  the format per ring from the byte accounting
  (:func:`resolve_ring_modes`).
* With a ``NodeSpec`` on the transport the exchange runs two-level
  (:func:`exchange_halo_hier`): the node group's tiles coalesce into one
  node frame, the rings run between nodes, and each shard cuts its
  window out of the extended node frame. Every format and topology is
  bitwise-equal to the flat dense exchange while no list saturates.
* Under ``cfg.stdp`` the live weights and the traces are state
  (:class:`PlasticState`), and each step's exchange carries the shards'
  pre-synaptic traces beside their spikes, raw float32 on every wire
  (never packed): dense strips on the dense, per-ring and hierarchical
  wires, and on the flat AER wire the trace values at the send's own
  event addresses, from which the receiver rebuilds the halo (decaying
  its previous halo frame everywhere else, ``PlasticState.trace_ext``).
  The pre-trace table of the remote rule is cut from the extended trace
  frame as the spike table is from the ring.
* Axonal delays are served from a halo-extended history ring buffer, so
  every delayed read is shard-local; the neighbour table is built from
  it with ``network.offset_slice``.
* The kernels see all local shards' columns at once: one ``fused_step``
  (or ``synapse_matmul`` + ``ell_gather`` + ``lif_step``) launch and one
  ``keyed_drive`` launch per step over ``(S_local * C, ...)``, whatever
  the shard count.
* The batched multi-tenant service over the mesh
  (:func:`make_batched_distributed_run`): b tenants share the network
  and advance in lockstep, every state leaf (b, S_local, ...); the
  kernels take the tenant-major (b * S_local * C, ...) rows against the
  shared network's S_local * C (their tenant axis), the drive is one
  ``keyed_drive_tenants`` launch, and each halo send carries every
  tenant's strip in one message, an AER list per (tenant, shard), and
  under the guard a checksum word per (tenant, shard) strip and a
  verdict per (tenant, shard). With batch shards
  (``runtime/sharding.py``) each process holds its shard's tenants and
  only the per-tenant totals cross the tenant axis.

The step follows the reference's schedule (``dist_step``): the exchange
of step t-1's spikes is issued first and its frame written into the
ring only after the compute (every remote delay >= 2, checked), or,
with ``ExchangeConfig.pipelined``, carried a full step in
``DistState.ext_pending`` and written before the next step's reads;
the trace halo is consumed on arrival under both schedules.

Under ``cfg.guard.enabled`` each step frames every halo message with a
checksum word (``integrity.HaloGuard`` around the transport's moves,
``transport.GuardedWire``: the packed words, the event lists, the trace
strips and the node messages, one frame per shard's message) and folds
the per-shard verdict (the invariants, ``fused_step``'s guard flags over
the stacked rows, the checksums, the AER saturation run) into
``DistState.guard``, (S,) leaves. :func:`stacked_state_template` and
``make_distributed_run(..., replicate_state=True)`` give the host stack
of every shard that a checkpoint holds (``checkpoint/checkpointer.py``).

The ring buffer is the one large leaf (286 MB at 24x24 shards of the
24x24x1240 grid): :func:`dist_step` writes it in place, and the runners
copy the state they are given once, so the caller's state stays as it
was.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import DPSNNConfig
from repro_torch.core import network as net
from repro_torch.core import plasticity as plast
from repro_torch.core.batched import map_leaves, tenant_rates
from repro_torch.core.connectivity import (StencilSpec, build_stencil,
                                           neuron_types)
from repro_torch.core.network import NetworkParams
from repro_torch.core.neuron import LIFState
from repro_torch.core.partition import (TileSpec, make_rank_tile_spec,
                                        make_tile_spec, shard_tile_coords,
                                        tile_column_ids)
from repro_torch.core.plasticity import STDPState
from repro_torch.core.simulation import _recip
from repro_torch.kernels import ops
from repro_torch.kernels.ref import stdp_constants
from repro_torch.runtime import integrity
from repro_torch.runtime.integrity import GuardState
from repro_torch.runtime.sharding import local_tenants
from repro_torch.runtime.transport import GuardedWire, assert_axis_sizes

# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------

def halo_ring_widths(radius: int, tile_dim: int) -> list:
    """Per-ring strip widths for a radius-``radius`` halo over tiles of
    ``tile_dim`` columns/rows: ring k (1-based) contributes
    ``min(tile_dim, radius - (k-1)*tile_dim)`` — ``ceil(radius/tile_dim)``
    rings in total, summing to exactly ``radius``."""
    widths = []
    left = radius
    while left > 0:
        w = min(tile_dim, left)
        widths.append(w)
        left -= w
    return widths


def _collect_rings(f: tuple, axis: int, direction: int, radius: int,
                   send_fn) -> tuple:
    """The radius-deep halo beyond one face of the stacked tiles ``f`` (a
    tuple of ``(*local, h, w, N)`` payloads, or ``(*local, b, h, w, N)``
    with a tenant axis: the spike frame, and the trace frame under STDP)
    along shard-grid ``axis``, by chained rings:
    round k forwards the strips received in round k-1, so ring-k data
    crosses k hops with nearest-neighbour sends only. The payloads slice
    and travel in lockstep (``send_fn`` takes and returns the tuple), so
    a trace can reuse its spikes' event addresses. ``direction=+1``
    collects toward increasing coordinate (each ring contributes its
    leading rows/cols), ``-1`` the mirror. Shards at the open boundary
    receive zeros and forward them on."""
    dim = f[0].dim() - 3 + axis         # the tile axis behind the stack
    parts = []
    cur = f
    for w in halo_ring_widths(radius, f[0].shape[dim]):
        start = 0 if direction > 0 else cur[0].shape[dim] - w
        cur = send_fn(tuple(x.narrow(dim, start, w) for x in cur), axis,
                      direction)
        parts.append(cur)
    if direction < 0:
        parts = parts[::-1]
    return tuple(torch.cat(xs, dim) for xs in zip(*parts))


def _extend_tree(payload: tuple, send_fn, r: int) -> tuple:
    """Two-phase (horizontal rings, then vertical rings of the
    horizontally-extended strips) halo extension of each payload of the
    tuple: each (h, w, N) tile becomes (h+2r, w+2r, N). Corners ride
    the vertical phase."""
    if r == 0:
        return payload
    east = _collect_rings(payload, 1, +1, r, send_fn)
    west = _collect_rings(payload, 1, -1, r, send_fn)
    wide = tuple(torch.cat(xs, -2) for xs in zip(west, payload, east))
    south = _collect_rings(wide, 0, +1, r, send_fn)
    north = _collect_rings(wide, 0, -1, r, send_fn)
    return tuple(torch.cat(xs, -3) for xs in zip(north, wide, south))


def _payload(mesh, frame: torch.Tensor, trace) -> tuple:
    """The stacked ``(spikes,)`` or ``(spikes, traces)`` tiles in the
    transport's layout: (S_local, th, tw, N) frames as (*local, th, tw,
    N); the tenant axis of (b, S_local, th, tw, N) frames behind the mesh
    axes, (*local, b, th, tw, N), so that one message carries every
    tenant's strip."""
    def lay(x):
        if x.dim() == 4:
            return x.reshape(*mesh.local, *x.shape[1:])
        return x.reshape(x.shape[0], *mesh.local, *x.shape[2:]).movedim(0, 2)
    return tuple(lay(x) for x in (frame, trace) if x is not None)


def _unlay(x: torch.Tensor, tenants: bool) -> torch.Tensor:
    """Inverse of :func:`_payload`'s layout for any (*local, ...) tensor
    (frames, or a send's (*local[, b]) flags): (S_local, ...), or with
    ``tenants`` (*local, b, ...) -> (b, S_local, ...)."""
    if not tenants:
        return x.reshape(-1, *x.shape[2:])
    x = x.movedim(2, 0)
    return x.reshape(x.shape[0], -1, *x.shape[3:])


def _unstack(ext: tuple, tenants: bool) -> tuple:
    """Extended payloads -> ``(ext_frame, ext_trace or None)`` in the
    state's layout (:func:`_unlay`)."""
    out = tuple(_unlay(x, tenants) for x in ext)
    return out if len(out) == 2 else (out[0], None)


def exchange_halo(frame: torch.Tensor, spec: TileSpec, mesh,
                  trace: torch.Tensor | None = None):
    """(S_local, th, tw, N) interior spike frames -> (S_local, th+2r,
    tw+2r, N) extended frames, over ``mesh``'s shifts ((b, S_local, ...)
    frames of b tenants in one message per send). Each direction
    runs ``ceil(r / tile_dim)`` chained rounds; with ``r`` inside one
    tile that is 4 shifts per step. With ``trace`` (the (S_local, th,
    tw, N) pre-synaptic traces) its strips take the same rounds after
    the spikes', as the reference sends them, moved raw (``mesh.move``:
    a packing wire would round every trace to 0/1), and the function
    returns ``(ext_frame, ext_trace)``."""
    tenants = frame.dim() == 5

    def extend(x, send):
        ext = _extend_tree(_payload(mesh, x, None), lambda p, axis, d: (
            send(p[0], axis, d),), spec.radius)
        return _unlay(ext[0], tenants)

    ext_frame = extend(frame, mesh.shift)
    return ext_frame if trace is None else (ext_frame,
                                            extend(trace, mesh.move))


# ---------------------------------------------------------------------------
# AER event lists (aer_sparse halo payloads)
# ---------------------------------------------------------------------------
#
# The paper's exchange is event-driven: ranks ship the addresses of the
# axons that spiked. A send carries a fixed-capacity list ``int32[1 +
# cap]`` = ``(count, addresses[cap])``: addresses ascend in the flatten
# order of the strip, unused slots hold the sentinel ``m`` (the strip's
# units), and ``count`` is the TRUE count, which may exceed ``cap``: the
# list then holds the first ``cap`` events and the send has overflowed.
# ``cap`` is a Python int from the config, so no step waits for the
# card to learn a size.


def aer_capacity(n_units: int, rate_bound_hz: float,
                 capacity_factor: float, dt_ms: float) -> int:
    """Static event-list capacity for a send of ``n_units`` binary units:
    ``max(1, ceil(capacity_factor * expected events per step))`` where
    the expectation is taken at the configured firing-rate *bound*."""
    expected = n_units * rate_bound_hz * dt_ms * 1e-3
    return max(1, int(math.ceil(capacity_factor * expected)))


def aer_encode_stack(x: torch.Tensor, cap: int):
    """(S, ...) 0/1 frames -> ((S, 1 + cap) int32 event lists, (S,) bool
    overflowed), one list per frame of the stack: a running count over
    each flattened frame gives every spike its slot, and the addresses
    below ``cap`` are scattered into a list filled with the sentinel."""
    flat = x.reshape(x.shape[0], -1) > 0
    s, m = flat.shape
    slot = torch.cumsum(flat, 1, dtype=torch.int32)      # 1-based slots
    count = slot[:, -1:]
    # spikes past the capacity, and silent units, go to a spare slot
    slot = torch.where(flat & (slot <= cap), slot, cap + 1)
    addr = torch.arange(m, dtype=torch.int32, device=x.device).expand(s, m)
    events = torch.full((s, cap + 2), m, dtype=torch.int32, device=x.device)
    events.scatter_(1, slot.long(), addr)
    events[:, :1] = count
    return events[:, :cap + 1], count[:, 0] > cap


def aer_decode_stack(events: torch.Tensor, shape: tuple,
                     dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`aer_encode_stack`: (S, 1 + cap) lists -> (S,
    *shape) frames. Slots at or after ``count`` go to the sentinel and
    are dropped, so a zero-filled list (what the open sheet edge
    delivers) decodes to silence and an overflowed list to its ``cap``
    surviving events."""
    m = math.prod(shape)
    out = torch.zeros((events.shape[0], m + 1), dtype=dtype,
                      device=events.device)
    out.scatter_(1, _listed(events, m), 1.0)
    return out[:, :m].reshape(-1, *shape)


def _listed(events: torch.Tensor, m: int) -> torch.Tensor:
    """The (..., cap) int64 addresses of (..., 1 + cap) lists, with every
    slot at or after ``count``, and any address outside the frame of
    ``m`` units, sent to the sentinel ``m`` (a scatter's dropped slot)."""
    addr = events[..., 1:]
    keep = ((torch.arange(addr.shape[-1], device=events.device)
             < events[..., :1]) & (addr >= 0) & (addr < m))
    return torch.where(keep, addr, m).long()


def aer_encode(frame: torch.Tensor, cap: int):
    """(...) 0/1 frame -> (``int32[1 + cap]`` event list, overflowed
    bool): :func:`aer_encode_stack` of one frame."""
    events, over = aer_encode_stack(frame.reshape(1, -1), cap)
    return events[0], over[0]


def aer_decode(events: torch.Tensor, shape: tuple, dtype=torch.float32
               ) -> torch.Tensor:
    """Inverse of :func:`aer_encode` (scatter ones at the listed
    addresses)."""
    return aer_decode_stack(events[None], tuple(shape), dtype)[0]


def aer_gather_values(values: torch.Tensor, events: torch.Tensor
                      ) -> torch.Tensor:
    """Gather a side payload (``values``, the frame's shape) at an event
    list's addresses; sentinel slots read a zero pad slot. ``events``
    may carry leading stack axes, ``values`` then the same ones."""
    lead = events.shape[:-1]
    flat = values.reshape(*lead, -1)
    flat = torch.cat([flat, flat.new_zeros(*lead, 1)], -1)
    return torch.gather(flat, -1, events[..., 1:].long())


def aer_scatter_values(events: torch.Tensor, values: torch.Tensor,
                       shape: tuple) -> torch.Tensor:
    """Scatter a gathered side payload back to a dense frame (zeros
    elsewhere), masking slots at or after ``count`` as
    :func:`aer_decode` does."""
    m = math.prod(shape)
    lead = events.shape[:-1]
    out = values.new_zeros(*lead, m + 1)
    out.scatter_(-1, _listed(events, m), values)
    return out[..., :m].reshape(*lead, *shape)


# ---------------------------------------------------------------------------
# Per-ring wire-format selection, AER and the hierarchical exchange
# ---------------------------------------------------------------------------

def resolve_ring_modes(cfg: DPSNNConfig, spec: TileSpec, node=None, *,
                       compress: bool = True):
    """None under the uniform policy (``ExchangeConfig.exchange_mode ==
    "inherit"``: every ring uses ``conn.exchange_mode``), or the
    ``{(phase, ring): mode}`` per-ring selection under ``"auto"``: the
    argmin of the exact byte accounting at the configured rate bound
    (``runtime.compression.ring_mode_table``), priced at ``compress``."""
    policy = getattr(cfg.exchange, "exchange_mode", "inherit")
    if policy not in ("inherit", "auto"):
        raise ValueError(
            f"unknown ExchangeConfig.exchange_mode {policy!r} "
            f"(expected 'inherit' or 'auto')")
    if policy != "auto":
        return None
    from repro_torch.runtime.compression import ring_mode_table

    return {(e["phase"], e["ring"]): e["mode"]
            for e in ring_mode_table(cfg, spec, node, compress=compress)}


def _uniform_modes(mode: str, rows: int, cols: int, r: int) -> dict:
    """Every ring of a ``rows x cols`` frame's radius-``r`` halo in
    ``mode``."""
    modes = {("h", k): mode
             for k in range(1, len(halo_ring_widths(r, cols)) + 1)}
    modes.update({("v", k): mode
                  for k in range(1, len(halo_ring_widths(r, rows)) + 1)})
    return modes


def _make_mode_send(modes: dict, shift, move, *, rate_bound_hz: float,
                    capacity_factor: float, dt_ms: float,
                    sparse_trace: bool = False):
    """A ``send_fn`` for :func:`_collect_rings` that picks the spike
    strip's wire format per (phase, ring) from ``modes``: ``shift``
    moves a dense strip in the transport's format, ``move`` an event
    list raw. A trace strip (the payload's second member) is moved raw
    and dense on every ring, or, with ``sparse_trace`` (the flat AER
    wire), as its values at the send's own event addresses (zeros
    elsewhere on arrival). Axis 1 is the horizontal phase, 0 the
    vertical one. Every strip of the stack (each shard's, and each
    tenant's under a tenant axis: the capacity is per tenant) is its own
    list. Returns ``(send_fn, flags)``, ``flags`` the list of each AER
    send's (*local[, b]) overflow flags."""
    flags = []
    rings: dict = {}

    def send(p, axis, direction):
        x = p[0]
        key = ("h" if axis == 1 else "v", direction)
        k = rings[key] = rings.get(key, 0) + 1
        if modes[(key[0], k)] != "aer_sparse":
            return (shift(x, axis, direction),
                    *(move(y, axis, direction) for y in p[1:]))
        lead, strip = x.shape[:-3], x.shape[-3:]
        cap = aer_capacity(math.prod(strip), rate_bound_hz, capacity_factor,
                           dt_ms)
        events, over = aer_encode_stack(x.reshape(-1, *strip), cap)
        flags.append(over.reshape(lead))
        events = events.reshape(*lead, cap + 1)
        got = move(events, axis, direction)
        out = aer_decode_stack(got.reshape(-1, cap + 1), strip,
                               x.dtype).reshape(x.shape)
        if len(p) == 1:
            return (out,)
        if not sparse_trace:
            return out, move(p[1], axis, direction)
        vals = move(aer_gather_values(p[1], events), axis, direction)
        return out, aer_scatter_values(got, vals, strip)

    return send, flags


def _saturated(flags: list):
    """The OR of a step's AER overflow flags, or None without AER sends."""
    return torch.stack(flags).any(0) if flags else None


def exchange_halo_modes(frame: torch.Tensor, spec: TileSpec, mesh, *,
                        modes: dict, rate_bound_hz: float,
                        capacity_factor: float, dt_ms: float,
                        trace: torch.Tensor | None = None,
                        sparse_trace: bool = False):
    """Flat halo exchange with a per-ring wire format (``modes``, from
    :func:`resolve_ring_modes`): the schedule of :func:`exchange_halo`,
    each (phase, ring) send dense or AER; the ``trace`` frame, when
    given, rides raw f32 on every ring (see :func:`_make_mode_send` for
    ``sparse_trace``). Returns ``(ext_frame, ext_trace or None,
    saturated)``, ``saturated`` the frame's leading (S_local,) or (b,
    S_local) bool flags (None without an AER ring)."""
    tenants = frame.dim() == 5
    send, flags = _make_mode_send(
        modes, mesh.shift, mesh.move, rate_bound_hz=rate_bound_hz,
        capacity_factor=capacity_factor, dt_ms=dt_ms,
        sparse_trace=sparse_trace)
    ext = _extend_tree(_payload(mesh, frame, trace), send, spec.radius)
    sat = _saturated(flags)
    return (*_unstack(ext, tenants),
            None if sat is None else _unlay(sat, tenants))


def exchange_halo_aer(frame: torch.Tensor, spec: TileSpec, mesh, *,
                      rate_bound_hz: float, capacity_factor: float,
                      dt_ms: float, trace: torch.Tensor | None = None):
    """AER halo exchange: the schedule of :func:`exchange_halo`, every
    strip crossing as an ``int32[1 + cap]`` event list, decoded back to a
    dense strip that equals the dense one whenever ``count <= cap``.
    Forwarded rings re-encode the decoded strip. With ``trace`` a
    ``f32[cap]`` side payload rides each send: the trace at the list's
    own addresses, scattered back on arrival (zeros elsewhere; the step
    rebuilds the rest by decay). Returns ``(ext_frame, sparse ext_trace
    or None, saturated)``, ``saturated`` True for a shard any of whose
    sends this step overflowed."""
    modes = _uniform_modes("aer_sparse", spec.tile_h, spec.tile_w,
                           spec.radius)
    return exchange_halo_modes(frame, spec, mesh, modes=modes,
                               rate_bound_hz=rate_bound_hz,
                               capacity_factor=capacity_factor, dt_ms=dt_ms,
                               trace=trace, sparse_trace=True)


def exchange_halo_hier(frame: torch.Tensor, spec: TileSpec, mesh, *,
                       modes: dict | None = None,
                       mode: str = "dense_packed",
                       rate_bound_hz: float = 0.0,
                       capacity_factor: float = 2.0, dt_ms: float = 1.0,
                       trace: torch.Tensor | None = None):
    """Hierarchical two-level halo exchange over ``mesh.node``. Three
    stages, all value-exact: the node group's tiles coalesce into one
    ``(group_h*tile_h, group_w*tile_w, N)`` node frame
    (``mesh.gather_node``); the flat ring schedule runs at node
    granularity (``ceil(r / node_dim)`` rings per direction), each ring
    one message per neighbour-node pair in the per-ring format of
    ``modes`` (or uniformly ``mode``); each shard cuts its ``(tile_h+2r,
    tile_w+2r, N)`` window out of the extended node frame. The extended
    node frame is the global frame's radius-r window of the node, so
    every window is what the flat exchange delivers. Every lane of a
    node encodes the same node frame, so all carry the node's
    saturation flag. The ``trace`` frame, when given, rides the same
    stages raw: gathered unpacked, moved dense on every ring, cut by the
    same window. Returns ``(ext_frame, ext_trace or None,
    saturated)``."""
    r = spec.radius
    s_local, th, tw, n = frame.shape
    node = mesh.node
    if modes is None:
        modes = _uniform_modes(mode, node.group_h * th, node.group_w * tw, r)
    send, flags = _make_mode_send(
        modes, mesh.node_shift, mesh.node_move, rate_bound_hz=rate_bound_hz,
        capacity_factor=capacity_factor, dt_ms=dt_ms)
    tiles = _payload(mesh, frame, trace)
    nodes = (mesh.gather_node(tiles[0]),
             *(mesh.gather_node(x, pack=False) for x in tiles[1:]))
    ext = tuple(mesh.node_window(x, th, tw, r)
                for x in _extend_tree(nodes, send, r))
    sat = _saturated(flags)
    if sat is not None:      # a node's flag on each of its local lanes
        (ly, lx), (ny, nx) = mesh.local, mesh.node_local
        sat = sat.repeat_interleave(ly // ny, 0).repeat_interleave(
            lx // nx, 1).reshape(s_local)
    return (*_unstack(ext, False), sat)


def make_exchange(cfg: DPSNNConfig, spec: TileSpec, mesh):
    """The step's halo exchange, resolved once from the config and the
    mesh: ``exchange(frame, trace=None, wire=None) -> (ext_frame,
    ext_trace or None, saturated or None)``; ``ext_trace`` is sparse (the
    values at the spikes' addresses only) on the flat AER wire
    (:func:`sparse_trace_halo`). ``wire`` stands in for ``mesh``'s
    moves (a ``transport.GuardedWire``, which frames every message).
    Raises the reference's errors for an unknown wire format or
    policy."""
    mode = cfg.conn.exchange_mode
    if mode not in ("dense_packed", "aer_sparse"):
        raise ValueError(
            f"unknown exchange_mode {mode!r} "
            f"(expected 'dense_packed' or 'aer_sparse')")
    ring_modes = resolve_ring_modes(cfg, spec, mesh.node,
                                    compress=mesh.priced_compress)
    aer = dict(rate_bound_hz=cfg.conn.aer_rate_bound_hz,
               capacity_factor=cfg.conn.aer_capacity_factor,
               dt_ms=cfg.neuron.dt_ms)
    if mesh.node is not None:
        return lambda f, trace=None, wire=None: exchange_halo_hier(
            f, spec, wire or mesh, modes=ring_modes, mode=mode, trace=trace,
            **aer)
    if ring_modes is not None:
        return lambda f, trace=None, wire=None: exchange_halo_modes(
            f, spec, wire or mesh, modes=ring_modes, trace=trace, **aer)
    if mode == "aer_sparse":
        return lambda f, trace=None, wire=None: exchange_halo_aer(
            f, spec, wire or mesh, trace=trace, **aer)

    def dense(f, trace=None, wire=None):
        if trace is None:
            return exchange_halo(f, spec, wire or mesh), None, None
        return (*exchange_halo(f, spec, wire or mesh, trace=trace), None)
    return dense


def sparse_trace_halo(cfg: DPSNNConfig, mesh) -> bool:
    """Whether the exchange ships the trace halo sparse (the flat, uniform
    AER wire, :func:`exchange_halo_aer`), so that the step rebuilds it
    from ``PlasticState.trace_ext``; every other wire ships it dense."""
    return (cfg.conn.exchange_mode == "aer_sparse" and mesh.node is None
            and cfg.exchange.exchange_mode != "auto")


# ---------------------------------------------------------------------------
# Distributed state
# ---------------------------------------------------------------------------

class PlasticState(NamedTuple):
    """The stacked shards' synaptic state under ``cfg.stdp``: the live
    weights leave the (regenerable) params and become state, as in the
    reference. ``trace_ext`` is present under ``conn.exchange_mode ==
    "aer_sparse"`` (None otherwise): the halo-extended pre-trace frame,
    ext(x_pre(t-1)) after step t, which the flat AER wire rebuilds from
    the shipped values and its own decay."""
    w_local: torch.Tensor          # (S, C, N, N) live intra-column weights
    rem_w: torch.Tensor            # (S, C, N, K) live remote ELL weights
    traces: STDPState              # x_pre, x_post: (S, C, N) each
    trace_ext: Optional[torch.Tensor] = None   # (S, th+2r, tw+2r, N)


class DistState(NamedTuple):
    """Stacked per-shard state: every leaf has the leading local-shard
    axis S (the reference's ``stacked_state_template`` layout). ``t`` is
    a host (CPU) int32 tensor, as the single shard's is. Inside the
    batched runner (:func:`make_batched_distributed_run`) every leaf
    has the tenant axis in front, (b, S, ...), so the kernels' rows are
    tenant-major; the runner hands its state out as (S, b, ...)."""
    lif: LIFState            # leaves (S, C, N), C = tile columns
    hist_ext: torch.Tensor   # (S, D, th+2r, tw+2r, N) halo-extended ring
    pending: torch.Tensor    # (S, th, tw, N) spikes of step t-1
    t: torch.Tensor          # (S,) int32, on the host
    spike_count: torch.Tensor   # (S,) f32
    event_count: torch.Tensor   # (S,) f32
    plastic: Optional[PlasticState] = None  # present iff cfg.stdp
    aer_sat: Optional[torch.Tensor] = None  # (S,) bool, this step's AER overflow
    # pipelined only: ext of spikes(t-2), written into the ring at step t
    ext_pending: Optional[torch.Tensor] = None  # (S, th+2r, tw+2r, N)
    # inter-spike-interval statistics: time of each neuron's last spike
    # (-1: never) and running integer-valued f32 sums of ISIs in steps
    last_spike_t: Optional[torch.Tensor] = None  # (S, C, N) int32
    isi_sum: Optional[torch.Tensor] = None       # (S,) f32
    isi_sumsq: Optional[torch.Tensor] = None     # (S,) f32
    isi_count: Optional[torch.Tensor] = None     # (S,) f32
    # the integrity guard's verdict per shard, (S,) leaves, under
    # cfg.guard.enabled (None otherwise)
    guard: Optional[GuardState] = None


def shard_col_ids(cfg: DPSNNConfig, spec: TileSpec, mesh,
                  device="cpu") -> torch.Tensor:
    """(S_local * C,) int32 global column ids of the mesh's local shards,
    shard after shard: the row order of every stacked kernel input."""
    return torch.cat([
        tile_column_ids(cfg, spec, *shard_tile_coords(spec, s), device)
        for s in mesh.shards])


def build_shard(cfg: DPSNNConfig, spec: TileSpec, mesh) -> NetworkParams:
    """The local shards' synapses, generated on the mesh's device from
    their global column ids (deterministic per id, so any tiling builds
    the single shard's network), stacked as (S_local * C, ...)."""
    return net.build_params(cfg, shard_col_ids(cfg, spec, mesh), mesh.device)


def init_shard(cfg: DPSNNConfig, spec: TileSpec, stencil: StencilSpec,
               mesh, params: NetworkParams | None = None, *,
               seed: int | None = None) -> DistState:
    """Initial stacked state, deterministic per global column id, so any
    mesh starts where the single shard starts. Under ``cfg.stdp`` the
    live weights start as ``params``' (the mesh's :func:`build_shard`,
    built here when not given), the traces at zero. ``seed`` overrides
    ``cfg.seed`` for the state draw (one tenant of the batched service);
    the network always derives from ``cfg.seed``."""
    dev = mesh.device
    s_local = len(mesh.shards)
    c, n = spec.columns_per_tile, cfg.neurons_per_column
    r = spec.radius
    d = stencil.max_delay + 1
    dtype = getattr(torch, cfg.dtype)
    lif = net.init_state(cfg, shard_col_ids(cfg, spec, mesh), stencil,
                         device=dev, seed=seed).lif
    ext_shape = (s_local, spec.tile_h + 2 * r, spec.tile_w + 2 * r, n)

    def zeros(*shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=dev)

    plastic = None
    if cfg.stdp:
        if params is None:
            params = build_shard(cfg, spec, mesh)
        traces = plast.init_stdp(s_local * c, n, dtype, dev)
        plastic = PlasticState(
            w_local=params.w_local.reshape(s_local, c, n, n),
            rem_w=params.rem_w.reshape(s_local, c, n, -1),
            traces=STDPState(*(x.reshape(s_local, c, n) for x in traces)),
            trace_ext=(zeros(*ext_shape, dt=dtype)
                       if cfg.conn.exchange_mode == "aer_sparse" else None))
    return DistState(
        lif=LIFState(*(x.reshape(s_local, c, n) for x in lif)),
        hist_ext=zeros(s_local, d, *ext_shape[1:], dt=dtype),
        pending=zeros(s_local, spec.tile_h, spec.tile_w, n, dt=dtype),
        t=torch.zeros(s_local, dtype=torch.int32),
        spike_count=zeros(s_local),
        event_count=zeros(s_local),
        plastic=plastic,
        aer_sat=zeros(s_local, dt=torch.bool),
        # a zero in-flight frame is the empty pre-t=0 history, so the
        # pipelined schedule starts bitwise-equal to the unpipelined one
        ext_pending=(zeros(*ext_shape, dt=dtype)
                     if cfg.exchange.pipelined else None),
        last_spike_t=torch.full((s_local, c, n), -1, dtype=torch.int32,
                                device=dev),
        isi_sum=zeros(s_local),
        isi_sumsq=zeros(s_local),
        isi_count=zeros(s_local),
        guard=(integrity.init_guard(dev, (s_local,)) if cfg.guard.enabled
               else None),
    )


def check_delays(stencil: StencilSpec, pipelined: bool) -> None:
    """The reference's two schedule checks, with its text: the exchange
    of step t-1 is consumed after step t's reads (every remote delay
    >= 2), and pipelining defers it into a later ring slot."""
    if any(delay < 2 for (_, _, _, delay, _) in stencil.offsets):
        raise ValueError(
            "comm/compute overlap requires every remote delay >= 2 steps "
            "(distance-proportional delays guarantee this)"
        )
    if pipelined and stencil.max_delay == 0:
        raise ValueError(
            "pipelined halo exchange requires an axonal-delay ring "
            "(stencil.max_delay >= 1): with no delay there is no future "
            "step to defer the exchanged spike table into — disable "
            "ExchangeConfig.pipelined or restore min_delay_steps >= 1"
        )


def dist_step(cfg: DPSNNConfig, params: NetworkParams, state: DistState, *,
              spec: TileSpec, stencil: StencilSpec, mesh,
              col_ids: torch.Tensor, impl: str = "ref",
              exchange=None, seeds: torch.Tensor | None = None,
              lam: torch.Tensor | None = None) -> DistState:
    """One step of every local shard (``col_ids``: :func:`shard_col_ids`
    on the mesh's device; ``exchange``: :func:`make_exchange`, resolved
    here when not given). Writes ``state.hist_ext`` in place; every
    other leaf of the new state is new, ``aer_sat`` this step's
    saturation flags. The mesh must match ``spec`` and the stencil pass
    :func:`check_delays`: :func:`make_distributed_run` checks both once,
    where it binds them. Under ``cfg.stdp`` the step is the reference's
    plastic one: the live weights of ``state.plastic`` replace
    ``params``', the exchange carries the pre-trace halo, and one STDP
    update runs over every local shard's columns. Under
    ``cfg.guard.enabled`` one ``integrity.HaloGuard`` frames every halo
    message of the step, and each shard's verdict (with its chaos, the
    NaN on its first voltage) updates ``state.guard``.

    With ``seeds`` and ``lam`` ((b,) int32 and float32 on the mesh's
    device, :func:`make_batched_distributed_run`) the state carries b
    tenants in lockstep, every leaf (b, S_local, ...): each tenant's
    drive under its own seed and rate in one ``keyed_drive_tenants``
    launch, the kernels over the tenant-major (b * S_local * C) rows
    against the shared network's S_local * C, one halo message per send
    for every tenant, and the counters and the guard's verdict per
    (tenant, shard), each tenant's strip of a message framed apart."""
    r = spec.radius
    th, tw = spec.tile_h, spec.tile_w
    n = cfg.neurons_per_column
    lead = state.pending.shape[:-3]          # (S_local,) or (b, S_local)
    rows = math.prod(lead) * spec.columns_per_tile
    slot_dim = len(lead)                     # the ring's delay axis
    d_slots = state.hist_ext.shape[slot_dim]
    t = int(state.t.reshape(-1)[0])
    pipelined = cfg.exchange.pipelined
    hist_ext = state.hist_ext
    plastic = state.plastic
    pre_frame = traces0 = None
    if plastic is not None:
        params = params._replace(w_local=plastic.w_local.reshape(rows, n, n),
                                 rem_w=plastic.rem_w.reshape(rows, n, -1))
        traces0 = STDPState(*(x.reshape(rows, n) for x in plastic.traces))
        pre_frame = plastic.traces.x_pre.reshape(*lead, th, tw, n)

    def ring(k):
        return hist_ext.select(slot_dim, k % d_slots)

    # (1) the halo exchange of step t-1's spikes (and, under STDP, of the
    # pre-traces x_pre(t-1)), first; under the guard one HaloGuard frames
    # every message of the step with a checksum word
    if exchange is None:
        exchange = make_exchange(cfg, spec, mesh)
    gcfg = cfg.guard
    hguard = wire = None
    if gcfg.enabled:
        hguard = integrity.HaloGuard(gcfg, t, lead[-1], mesh.device,
                                     tenants=lead[0] if seeds is not None
                                     else 0)
        wire = GuardedWire(mesh, hguard)
    ext_frame, pre_ext, aer_sat = exchange(state.pending, pre_frame,
                                           wire=wire)
    if aer_sat is None:
        aer_sat = torch.zeros_like(state.aer_sat)

    # (2) pipelined: the previous step's exchange goes into slot t-2
    # before the reads (delay-2 offsets read that very slot this step)
    new_ext_pending = None
    if pipelined:
        ring(t - 2).copy_(state.ext_pending)
        new_ext_pending = ext_frame

    # (3) the compute: local delivery from the pending frame (delay 1),
    # remote delivery from the extended ring (delays >= 2), the drive of
    # the shards' global columns, the neuron update
    s_loc = state.pending.reshape(rows, n)
    per_offset = [net.offset_slice(ring(t - delay), dy, dx, r, th, tw, n)
                  for (dy, dx, _k, delay, _p) in stencil.offsets]
    s_flat = torch.stack(per_offset, dim=-2).reshape(
        rows, stencil.n_offsets * n)
    if seeds is None:
        ext_drive, ext_counts = net.external_drive(cfg, t, col_ids)
    else:
        steps = torch.full(seeds.shape, t, dtype=torch.int32,
                           device=seeds.device)
        ext_drive, ext_counts = ops.keyed_drive_tenants(
            seeds, steps, col_ids, n, lam, cfg.conn.j_ext)
    lif0 = LIFState(*(x.reshape(rows, n) for x in state.lif))
    new_traces = gflags = None
    if impl == "cuda_fused":
        # under the guard the kernel's epilogue flags each row's v
        lif, spikes, new_traces, gflags = net.fused_stage(
            cfg, params, lif0, traces0, s_loc, s_flat, ext_drive)
    else:
        deliver_local, deliver_remote, lif_update = net._stage_fns(impl)
        currents = deliver_local(s_loc, params.w_local)
        currents = currents + deliver_remote(s_flat, params.rem_flat,
                                             params.rem_w)
        lif, spikes = lif_update(cfg.neuron, lif0, currents + ext_drive)
    # the chaos NaN lands on every shard's first fresh voltage, so the
    # verdict below sees it within the step; the kernel's flags pre-date it
    if gcfg.enabled and gcfg.chaos_nan_at_step >= 0:
        lif = lif._replace(v=integrity.inject_nan(gcfg, t, lif.v,
                                                  shards=math.prod(lead)))
        gflags = None

    # (3b) STDP over every local shard's columns at once: the local rule,
    # and the remote rule through the pre-trace table cut from the
    # extended trace frame (the single shard's one-step-lag table)
    new_plastic = None
    if plastic is not None:
        trace_ext = None
        if sparse_trace_halo(cfg, mesh):
            # x_pre(t-1) = x_pre(t-2)*dp + spikes(t-1) at every neuron:
            # fresh (shipped) values where a spike arrived, the previous
            # halo decayed everywhere else (truncated spikes of a
            # saturated list included, as in the reference), the shard's
            # own traces inside
            dp = stdp_constants(cfg.stdp_cfg, cfg.neuron.dt_ms,
                                pre_frame.dtype)["dp"]
            pre_ext = torch.where(ext_frame > 0, pre_ext,
                                  plastic.trace_ext * dp)
            pre_ext[..., r:r + th, r:r + tw, :] = pre_frame
        if plastic.trace_ext is not None:
            trace_ext = pre_ext
        table = torch.stack([
            net.offset_slice(pre_ext, dy, dx, r, th, tw, n)
            for (dy, dx, _k, _delay, _p) in stencil.offsets], dim=-2).reshape(
                rows, stencil.n_offsets * n)
        new_params, traces = plast.stdp_update(
            cfg, cfg.stdp_cfg, params, traces0, spikes,
            neuron_types(cfg, spikes.device), pre_trace_table=table,
            rem_flat=params.rem_flat, impl=impl,
            # under cuda_fused the kernel advanced the traces
            new_traces=new_traces if impl == "cuda_fused" else None)
        new_plastic = PlasticState(
            w_local=new_params.w_local.reshape(plastic.w_local.shape),
            rem_w=new_params.rem_w.reshape(plastic.rem_w.shape),
            traces=STDPState(*(x.reshape(plastic.traces.x_pre.shape)
                               for x in traces)),
            trace_ext=trace_ext)

    # (4) unpipelined: the exchanged frame t-1 goes into the ring after
    # the compute (first read at t+1)
    if not pipelined:
        ring(t - 1).copy_(ext_frame)

    # (5) events and ISI statistics per (tenant,) shard: integer-valued
    # f32 sums, exact in any order while below 2**24
    def per_shard(x):
        return x.reshape(*lead, -1).sum(-1)

    k_tot = params.rem_w.shape[-1]
    outdeg = params.local_outdeg          # the tenants share it
    events = (per_shard(spikes.reshape(-1, *outdeg.shape) * (outdeg + k_tot))
              + per_shard(ext_counts).to(torch.float32))
    spiked = spikes.reshape(state.last_spike_t.shape) > 0
    contrib = spiked & (state.last_spike_t >= 0)
    isi = (t - state.last_spike_t).to(torch.float32)

    # (6) the guard's verdict per shard: the invariants of the fresh
    # state, the halo checksums and the AER saturation run
    new_guard = None
    if gcfg.enabled:
        tr = new_plastic.traces if new_plastic is not None else None
        code = integrity.step_verdict(
            gcfg, v=lif.v, spikes=spikes,
            x_pre=None if tr is None else tr.x_pre,
            x_post=None if tr is None else tr.x_post,
            kernel_flags=gflags, tenants=math.prod(lead)).reshape(lead)
        chk_fail, chk_count = hguard.verdict()
        new_guard = integrity.guard_update(
            gcfg, state.guard, step_code=code, t=t, aer_sat=aer_sat,
            chk_fail=chk_fail, chk_count=chk_count)
    return DistState(
        lif=LIFState(*(x.reshape(state.lif.v.shape) for x in lif)),
        hist_ext=hist_ext,
        pending=spikes.reshape(state.pending.shape),
        t=state.t + 1,
        spike_count=state.spike_count + per_shard(spikes),
        event_count=state.event_count + events,
        plastic=new_plastic,
        aer_sat=aer_sat,
        ext_pending=new_ext_pending,
        last_spike_t=torch.where(spiked, t, state.last_spike_t),
        isi_sum=state.isi_sum + per_shard(torch.where(contrib, isi, 0.0)),
        isi_sumsq=state.isi_sumsq + per_shard(
            torch.where(contrib, isi * isi, 0.0)),
        isi_count=state.isi_count + per_shard(contrib).to(torch.float32),
        guard=new_guard,
    )


# ---------------------------------------------------------------------------
# Runners
# ---------------------------------------------------------------------------

class DistResult(NamedTuple):
    """Totals over every shard of every process (tensors on the mesh's
    device). ``rate_trace`` is the per-step population rate, as
    the single shard's ``SimResult.rate_trace``; ``aer_saturated`` step
    i is 1 iff a send of any shard of any process overflowed its event
    list at step i (the reference's ``pmax``), all zeros under
    dense_packed and within the rate bound. The batched runner's totals
    are (batch,) per tenant, its ``rate_trace`` (batch, n_steps)."""
    rate_hz: torch.Tensor
    events: torch.Tensor
    spikes: torch.Tensor
    state_checksum: torch.Tensor
    aer_saturated: torch.Tensor    # (n_steps,) int32
    rate_trace: torch.Tensor       # (n_steps,) f32


def _total(mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum over the local shards and then over the processes, in float64:
    integer-valued f32 accumulators add up exactly."""
    return mesh.all_sum(x.to(torch.float64).sum(0)).to(torch.float32)


def stack_from_host(stack: DistState, mesh) -> DistState:
    """The mesh's local shards (``mesh.shards``, process-major) of a
    host stack of every shard, (S, ...) numpy leaves (a checkpoint's, or
    :func:`stack_to_host`'s), as a stacked state on the mesh's device."""
    idx = list(mesh.shards)
    state = map_leaves(lambda x: torch.from_numpy(np.ascontiguousarray(
        np.asarray(x)[idx])).to(mesh.device), stack)
    return state._replace(t=state.t.cpu())


def stack_to_host(state: DistState, mesh) -> DistState:
    """Every shard's leaves, (S, ...) numpy in process-major order, on
    every process (``mesh.gather``): the stack a checkpoint holds."""
    return map_leaves(lambda x: mesh.gather(x).cpu().numpy(), state)


def make_distributed_run(cfg: DPSNNConfig, mesh, *, n_steps: int,
                         impl: str = "cuda_fused", with_state: bool = False,
                         replicate_state: bool = False,
                         params: NetworkParams | None = None):
    """``(run, spec)``. ``run()`` initialises the stacked state and
    simulates ``n_steps``; ``run(state)`` continues from a stacked state
    (the reference's ``make_distributed_resume``), leaving it as it was.
    It returns a :class:`DistResult`, with ``with_state`` followed by
    the final :class:`DistState`. The local shards' synapses are built
    here, once, from the seed (or taken from ``params``, a
    :func:`build_shard` of the same mesh). Under ``cfg.stdp`` a fresh
    run starts its live weights from them; ``run(state)`` takes the
    weights of ``state.plastic``.

    With ``replicate_state`` (the reference's flag of
    ``make_distributed_resume``) the state on both sides is the host
    stack of every shard of the grid, (S, ...) numpy leaves in
    process-major order (:func:`stacked_state_template`'s layout, a
    checkpoint's): ``run(stack)`` runs this process's shards of it, and
    ``run`` returns ``(DistResult, stack)`` with the final stack gathered
    on every process (:func:`stack_to_host`)."""
    net.check_supported(cfg, impl, mesh=True)
    spec = make_tile_spec(cfg, *mesh.shape)
    assert_axis_sizes(spec, mesh)
    stencil = build_stencil(cfg)
    check_delays(stencil, cfg.exchange.pipelined)
    if params is None:
        params = build_shard(cfg, spec, mesh)
    col_ids = shard_col_ids(cfg, spec, mesh, mesh.device)
    exchange = make_exchange(cfg, spec, mesh)
    # x / n_neurons / dt as the single shard's simulation.run computes it
    f32 = torch.float32
    per_step = float(torch.tensor(_recip(cfg.n_neurons), dtype=f32)
                     * torch.tensor(_recip(cfg.neuron.dt_ms * 1e-3),
                                    dtype=f32))
    sim_s = n_steps * cfg.neuron.dt_ms * 1e-3

    def run(state: DistState | None = None):
        if state is None:
            state = init_shard(cfg, spec, stencil, mesh, params)
        elif replicate_state:      # fresh tensors of this process's shards
            state = stack_from_host(state, mesh)
        else:      # the run writes its own copy of the ring
            state = state._replace(hist_ext=state.hist_ext.clone())
        step_spikes, step_sat = [], []
        for _ in range(n_steps):
            state = dist_step(cfg, params, state, spec=spec,
                              stencil=stencil, mesh=mesh, col_ids=col_ids,
                              impl=impl, exchange=exchange)
            step_spikes.append(state.pending.sum())
            step_sat.append(state.aer_sat)
        if n_steps:
            trace = torch.stack(step_spikes)
            sat = torch.stack(step_sat).any(1)
        else:
            trace = torch.zeros((0,), device=mesh.device)
            sat = torch.zeros((0,), dtype=torch.bool, device=mesh.device)
        trace = mesh.all_sum(trace.to(torch.float64)).to(f32)
        spikes = _total(mesh, state.spike_count)
        res = DistResult(
            rate_hz=spikes * _recip(cfg.n_neurons * sim_s),
            events=_total(mesh, state.event_count),
            spikes=spikes,
            state_checksum=_total(mesh, state.lif.v.flatten(1).sum(1)),
            aer_saturated=mesh.all_max(sat.to(torch.int32)),
            rate_trace=trace * per_step,
        )
        if replicate_state:
            return res, stack_to_host(state, mesh)
        return (res, state) if with_state else res

    return run, spec


def _tenant_totals(mesh, x: torch.Tensor, tenants: range, batch: int
                   ) -> torch.Tensor:
    """(batch,) per-tenant totals of the (b_local, S_local) accumulators
    ``x`` of this process's ``tenants``, on every process: each process
    writes its float64 partial sums at its own tenants' indices of a zero
    vector, which is summed over every process. Tenants of different
    batch shards are disjoint and the sums integer-valued, so this is the
    reference's spatial ``psum`` followed by its ``all_gather('batch')``,
    exactly."""
    full = torch.zeros((*x.shape[2:], batch), dtype=torch.float64,
                       device=x.device)
    mine = x.to(torch.float64).sum(1)              # (b_local, ...)
    full[..., tenants.start:tenants.stop] = mine.movedim(0, -1)
    return mesh.all_sum(full).to(torch.float32)


def init_tenants(cfg: DPSNNConfig, spec: TileSpec, stencil: StencilSpec,
                 mesh, seeds, params: NetworkParams | None = None
                 ) -> DistState:
    """The stacked state of one tenant per host int of ``seeds``, every
    leaf (b, S_local, ...): tenant i's is :func:`init_shard` with
    ``seed=seeds[i]``, its own copy of the live weights under
    ``cfg.stdp``."""
    states = [init_shard(cfg, spec, stencil, mesh, params, seed=int(s))
              for s in seeds]
    return map_leaves(lambda *xs: torch.stack(xs), *states)


def make_batched_distributed_run(cfg: DPSNNConfig, mesh, *, n_steps: int,
                                 batch: int, impl: str = "cuda_fused",
                                 with_stimulus: bool = False,
                                 with_state: bool = False,
                                 params: NetworkParams | None = None):
    """Batched multi-tenant distributed runner (the reference's function
    of the same name): ``(run, spec)``.

    ``batch`` tenants share the network (``params``: the local shards'
    :func:`build_shard`, built here once from ``cfg.seed`` when not
    given) and advance in lockstep over ``mesh``'s shards; the process
    holds the tenants of ``sharding.local_tenants`` (all of them without
    batch shards). ``run(seeds)``, or ``run(seeds, nu_scale)`` with
    ``with_stimulus``, takes the (batch,) host seeds (and drive scales):
    tenant i's state and drive draw from ``seeds[i]`` (and its rate is
    scaled by ``nu_scale[i]``), so it equals the dedicated single-shard
    ``simulation.run(seed=, nu_scale=)`` of the same network.
    ``run(seeds, ..., state=)`` continues from a final state of this
    runner's (the same tenants), leaving it as it was. Every step
    is one :func:`dist_step` of all local tenants and shards: one
    ``keyed_drive`` and one ``fused_step`` (or one of each staged kernel)
    launch, and one message per halo send carrying every tenant's strip;
    an AER list's capacity is per tenant.

    Returns a :class:`DistResult` of (batch,) leaves on every process
    (``rate_trace`` (batch, n_steps)); ``aer_saturated`` stays
    (n_steps,), the OR over every rank and tenant. With ``with_state``
    the run also returns the final :class:`DistState` with every leaf
    (S_local, b_local, ...), the reference's (n_shards, b_local, ...)
    layout of one process: under ``cfg.guard.enabled`` its guard leaves
    are (S_local, b_local), a verdict per (shard, tenant). Refuses the
    hierarchical exchange and a batch the batch shards do not divide,
    with the reference's texts."""
    if mesh.node is not None:
        raise ValueError(
            "the batched multi-tenant runner does not support the "
            "hierarchical ('ndata','data','nmodel','model') mesh — run "
            "tenants on a flat spatial mesh, or drop --ranks-per-node")
    tenants = local_tenants(mesh, batch)
    net.check_supported(cfg, impl, mesh=True)
    spec = make_tile_spec(cfg, *mesh.shape)
    assert_axis_sizes(spec, mesh)
    stencil = build_stencil(cfg)
    check_delays(stencil, cfg.exchange.pipelined)
    if params is None:
        params = build_shard(cfg, spec, mesh)
    dev = mesh.device
    col_ids = shard_col_ids(cfg, spec, mesh, dev)
    exchange = make_exchange(cfg, spec, mesh)
    f32 = torch.float32
    per_step = float(torch.tensor(_recip(cfg.n_neurons), dtype=f32)
                     * torch.tensor(_recip(cfg.neuron.dt_ms * 1e-3),
                                    dtype=f32))
    sim_s = n_steps * cfg.neuron.dt_ms * 1e-3

    def run(seeds, nu_scale=None, state: DistState | None = None):
        if (nu_scale is not None) != with_stimulus:
            raise TypeError("run(seeds, nu_scale) takes nu_scale exactly "
                            "when the runner was made with_stimulus")
        seeds = [int(s) for s in seeds]
        if len(seeds) != batch:
            raise ValueError(f"{len(seeds)} seeds for batch={batch}")
        mine = [seeds[i] for i in tenants]
        lam = tenant_rates(cfg, None if nu_scale is None else
                           [float(nu_scale[i]) for i in tenants],
                           len(mine)).to(dev)
        seeds_dev = torch.tensor(mine, dtype=torch.int32, device=dev)
        if state is None:
            state = init_tenants(cfg, spec, stencil, mesh, mine, params)
        else:      # back to (b, S, ...); the run writes its own ring
            state = map_leaves(lambda x: x.transpose(0, 1), state)
            state = state._replace(hist_ext=state.hist_ext.clone())
        step_spikes, step_sat = [], []
        for _ in range(n_steps):
            state = dist_step(cfg, params, state, spec=spec,
                              stencil=stencil, mesh=mesh, col_ids=col_ids,
                              impl=impl, exchange=exchange,
                              seeds=seeds_dev, lam=lam)
            step_spikes.append(state.pending.flatten(1).sum(1))
            step_sat.append(state.aer_sat.any())
        b = len(mine)
        if n_steps:
            trace = torch.stack(step_spikes, 1)          # (b, n_steps)
            sat = torch.stack(step_sat)
        else:
            trace = torch.zeros((b, 0), device=dev)
            sat = torch.zeros((0,), dtype=torch.bool, device=dev)
        # one shard's worth of spikes per tenant: the spatial sum is the
        # all-sum of the zero-padded per-tenant rows
        trace = _tenant_totals(mesh, trace[:, None], tenants, batch)
        spikes = _tenant_totals(mesh, state.spike_count, tenants, batch)
        res = DistResult(
            rate_hz=spikes * _recip(cfg.n_neurons * sim_s),
            events=_tenant_totals(mesh, state.event_count, tenants, batch),
            spikes=spikes,
            state_checksum=_tenant_totals(mesh, state.lif.v.flatten(2).sum(2),
                                          tenants, batch),
            aer_saturated=mesh.all_max(sat.to(torch.int32)),
            rate_trace=trace.T * per_step,
        )
        if not with_state:
            return res
        return res, map_leaves(lambda x: x.transpose(0, 1), state)

    return run, spec


# ---------------------------------------------------------------------------
# The checkpointed stack's template
# ---------------------------------------------------------------------------

def _state_structure(cfg: DPSNNConfig, leaf) -> DistState:
    """A :class:`DistState` with ``leaf(name)`` at each leaf a run of
    ``cfg`` carries (the plastic ones under STDP, ``trace_ext`` under
    AER, ``ext_pending`` pipelined, the guard's under the guard), in the
    reference's order."""
    plastic = None
    if cfg.stdp:
        aer = cfg.conn.exchange_mode == "aer_sparse"
        plastic = PlasticState(
            w_local=leaf("w_local"), rem_w=leaf("rem_w"),
            traces=STDPState(x_pre=leaf("x_pre"), x_post=leaf("x_post")),
            trace_ext=leaf("trace_ext") if aer else None)
    return DistState(
        lif=LIFState(v=leaf("v"), c=leaf("c"), refrac=leaf("refrac")),
        hist_ext=leaf("hist_ext"), pending=leaf("pending"), t=leaf("t"),
        spike_count=leaf("spike_count"), event_count=leaf("event_count"),
        plastic=plastic, aer_sat=leaf("aer_sat"),
        ext_pending=leaf("ext_pending") if cfg.exchange.pipelined else None,
        last_spike_t=leaf("last_spike_t"), isi_sum=leaf("isi_sum"),
        isi_sumsq=leaf("isi_sumsq"), isi_count=leaf("isi_count"),
        guard=(GuardState(**{f: leaf(f) for f in GuardState._fields})
               if cfg.guard.enabled else None))


def stacked_state_shapes(cfg: DPSNNConfig, n_ranks: int):
    """``(shapes, spec, stencil)``: ``shapes`` {leaf name: (the
    shard-stacked global shape (S, ...), numpy dtype)} of every leaf a
    run of ``cfg`` on ``n_ranks`` processes may carry (which ones it
    does carry: :func:`_state_structure`). Allocates nothing: the dry
    run reads a 96x96 grid's shard bytes from it."""
    spec = make_rank_tile_spec(cfg, n_ranks)
    stencil = build_stencil(cfg)
    s = spec.tiles_y * spec.tiles_x
    c, n, r = spec.columns_per_tile, cfg.neurons_per_column, spec.radius
    ext = (s, spec.tile_h + 2 * r, spec.tile_w + 2 * r, n)
    f32, i32 = np.float32, np.int32
    dt, wdt = np.dtype(cfg.dtype), np.dtype(cfg.weight_dtype)
    shapes = dict(
        v=((s, c, n), dt), c=((s, c, n), dt), refrac=((s, c, n), i32),
        hist_ext=((s, stencil.max_delay + 1, *ext[1:]), dt),
        pending=((s, spec.tile_h, spec.tile_w, n), dt),
        t=((s,), i32), spike_count=((s,), f32), event_count=((s,), f32),
        w_local=((s, c, n, n), wdt), rem_w=((s, c, n, stencil.k_total), wdt),
        x_pre=((s, c, n), dt), x_post=((s, c, n), dt), trace_ext=(ext, dt),
        aer_sat=((s,), np.bool_), ext_pending=(ext, dt),
        last_spike_t=((s, c, n), i32), isi_sum=((s,), f32),
        isi_sumsq=((s,), f32), isi_count=((s,), f32),
        tripped=((s,), np.bool_), trip_code=((s,), i32),
        trip_step=((s,), i32), sat_run=((s,), i32),
        checksum_fails=((s,), i32))
    return shapes, spec, stencil


def stacked_state_template(cfg: DPSNNConfig, n_ranks: int):
    """``(template, spec, stencil)`` of a checkpointed run on ``n_ranks``
    processes (the reference's function of the same name):
    ``template`` is a :class:`DistState` of host numpy zeros with the
    shard-stacked global shapes (S, ...) that ``make_distributed_run(...,
    replicate_state=True)`` takes and gives (:func:`stacked_state_shapes`),
    the ``tree_like`` a restore checks a checkpoint against and the
    layout ``checkpointer.reshard`` maps between rank counts. No synapse
    is built."""
    shapes, spec, stencil = stacked_state_shapes(cfg, n_ranks)
    template = _state_structure(cfg, lambda name: np.zeros(*shapes[name]))
    return template, spec, stencil
