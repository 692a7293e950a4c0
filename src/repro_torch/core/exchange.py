"""Distributed DPSNN step: stacked shards and the two-phase halo
exchange (the port of the static path of ``repro/core/exchange.py``).

* Columns are tiled 2-D over a shard grid (``core/partition.py``). A
  process holds a stack of shards: every :class:`DistState` leaf carries
  a leading local-shard axis ``(S_local, ...)`` in process-major order,
  the layout of the reference's ``stacked_state_template``. On a
  :class:`~repro_torch.runtime.transport.LocalMesh` ``S_local`` is every
  tile of the grid, on a ``ProcessGroupMesh`` it is 1.
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
* Axonal delays are served from a halo-extended history ring buffer, so
  every delayed read is shard-local; the neighbour table is built from
  it with ``network.offset_slice``.
* The kernels see all local shards' columns at once: one ``fused_step``
  (or ``synapse_matmul`` + ``ell_gather`` + ``lif_step``) launch and one
  ``keyed_drive`` launch per step over ``(S_local * C, ...)``, whatever
  the shard count.

The step follows the reference's schedule (``dist_step``): the exchange
of step t-1's spikes is issued first and its frame written into the
ring only after the compute (every remote delay >= 2, checked), or,
with ``ExchangeConfig.pipelined``, carried a full step in
``DistState.ext_pending`` and written before the next step's reads.
Multi-rank STDP (ROADMAP queue 1 item 4) and the guard's checksummed
frames (item 6) are refused by ``network.check_supported(...,
mesh=True)``.

The ring buffer is the one large leaf (286 MB at 24x24 shards of the
24x24x1240 grid): :func:`dist_step` writes it in place, and the runners
copy the state they are given once, so the caller's state stays as it
was.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import DPSNNConfig
from repro_torch.core import network as net
from repro_torch.core.connectivity import StencilSpec, build_stencil
from repro_torch.core.network import NetworkParams
from repro_torch.core.neuron import LIFState
from repro_torch.core.partition import (TileSpec, make_tile_spec,
                                        shard_tile_coords, tile_column_ids)
from repro_torch.core.simulation import _recip
from repro_torch.runtime.transport import assert_axis_sizes

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


def _collect_rings(f: torch.Tensor, axis: int, direction: int, radius: int,
                   send_fn) -> torch.Tensor:
    """The radius-deep halo beyond one face of the stacked tiles ``f``
    (``(*local, h, w, N)``) along shard-grid ``axis``, by chained rings:
    round k forwards the strip received in round k-1, so ring-k data
    crosses k hops with nearest-neighbour sends only. ``direction=+1``
    collects toward increasing coordinate (each ring contributes its
    leading rows/cols), ``-1`` the mirror. Shards at the open boundary
    receive zeros and forward them on."""
    dim = 2 + axis                      # the tile axis behind the mesh axes
    parts = []
    cur = f
    for w in halo_ring_widths(radius, f.shape[dim]):
        start = 0 if direction > 0 else cur.shape[dim] - w
        cur = send_fn(cur.narrow(dim, start, w), axis, direction)
        parts.append(cur)
    if direction < 0:
        parts = parts[::-1]
    return torch.cat(parts, dim)


def _extend_tree(payload: torch.Tensor, send_fn, r: int) -> torch.Tensor:
    """Two-phase (horizontal rings, then vertical rings of the
    horizontally-extended strips) halo extension: each (h, w, N) tile
    becomes (h+2r, w+2r, N). Corners ride the vertical phase."""
    if r == 0:
        return payload
    east = _collect_rings(payload, 1, +1, r, send_fn)
    west = _collect_rings(payload, 1, -1, r, send_fn)
    wide = torch.cat([west, payload, east], 3)
    south = _collect_rings(wide, 0, +1, r, send_fn)
    north = _collect_rings(wide, 0, -1, r, send_fn)
    return torch.cat([north, wide, south], 2)


def exchange_halo(frame: torch.Tensor, spec: TileSpec, mesh
                  ) -> torch.Tensor:
    """(S_local, th, tw, N) interior spike frames -> (S_local, th+2r,
    tw+2r, N) extended frames, over ``mesh``'s shifts. Each direction
    runs ``ceil(r / tile_dim)`` chained rounds; with ``r`` inside one
    tile that is 4 shifts per step."""
    r = spec.radius
    s_local, th, tw, n = frame.shape
    ext = _extend_tree(frame.reshape(*mesh.local, th, tw, n), mesh.shift, r)
    return ext.reshape(s_local, th + 2 * r, tw + 2 * r, n)


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
                    capacity_factor: float, dt_ms: float):
    """A ``send_fn`` for :func:`_collect_rings` that picks the wire format
    per (phase, ring) from ``modes``: ``shift`` moves a dense strip in
    the transport's format, ``move`` an event list raw. Axis 1 is the
    horizontal phase, 0 the vertical one. Returns ``(send_fn, flags)``,
    ``flags`` the list of each AER send's (*local,) overflow flags."""
    flags = []
    rings: dict = {}

    def send(x, axis, direction):
        key = ("h" if axis == 1 else "v", direction)
        k = rings[key] = rings.get(key, 0) + 1
        if modes[(key[0], k)] != "aer_sparse":
            return shift(x, axis, direction)
        local, strip = x.shape[:2], x.shape[2:]
        cap = aer_capacity(math.prod(strip), rate_bound_hz, capacity_factor,
                           dt_ms)
        events, over = aer_encode_stack(x.reshape(-1, *strip), cap)
        flags.append(over.reshape(local))
        events = move(events.reshape(*local, cap + 1), axis, direction)
        return aer_decode_stack(events.reshape(-1, cap + 1), strip,
                                x.dtype).reshape(x.shape)

    return send, flags


def _saturated(flags: list):
    """The OR of a step's AER overflow flags, or None without AER sends."""
    return torch.stack(flags).any(0) if flags else None


def exchange_halo_modes(frame: torch.Tensor, spec: TileSpec, mesh, *,
                        modes: dict, rate_bound_hz: float,
                        capacity_factor: float, dt_ms: float):
    """Flat halo exchange with a per-ring wire format (``modes``, from
    :func:`resolve_ring_modes`): the schedule of :func:`exchange_halo`,
    each (phase, ring) send dense or AER. Returns ``(ext_frame,
    saturated)``, ``saturated`` the (S_local,) bool flags (None without
    an AER ring)."""
    r = spec.radius
    s_local, th, tw, n = frame.shape
    send, flags = _make_mode_send(
        modes, mesh.shift, mesh.move, rate_bound_hz=rate_bound_hz,
        capacity_factor=capacity_factor, dt_ms=dt_ms)
    ext = _extend_tree(frame.reshape(*mesh.local, th, tw, n), send, r)
    sat = _saturated(flags)
    return (ext.reshape(s_local, th + 2 * r, tw + 2 * r, n),
            None if sat is None else sat.reshape(s_local))


def exchange_halo_aer(frame: torch.Tensor, spec: TileSpec, mesh, *,
                      rate_bound_hz: float, capacity_factor: float,
                      dt_ms: float):
    """AER halo exchange: the schedule of :func:`exchange_halo`, every
    strip crossing as an ``int32[1 + cap]`` event list, decoded back to a
    dense strip that equals the dense one whenever ``count <= cap``.
    Forwarded rings re-encode the decoded strip. Returns ``(ext_frame,
    saturated)``, ``saturated`` True for a shard any of whose sends this
    step overflowed."""
    modes = _uniform_modes("aer_sparse", spec.tile_h, spec.tile_w,
                           spec.radius)
    return exchange_halo_modes(frame, spec, mesh, modes=modes,
                               rate_bound_hz=rate_bound_hz,
                               capacity_factor=capacity_factor, dt_ms=dt_ms)


def exchange_halo_hier(frame: torch.Tensor, spec: TileSpec, mesh, *,
                       modes: dict | None = None,
                       mode: str = "dense_packed",
                       rate_bound_hz: float = 0.0,
                       capacity_factor: float = 2.0, dt_ms: float = 1.0):
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
    saturation flag. Returns ``(ext_frame, saturated)``."""
    r = spec.radius
    s_local, th, tw, n = frame.shape
    node = mesh.node
    if modes is None:
        modes = _uniform_modes(mode, node.group_h * th, node.group_w * tw, r)
    send, flags = _make_mode_send(
        modes, mesh.node_shift, mesh.node_move, rate_bound_hz=rate_bound_hz,
        capacity_factor=capacity_factor, dt_ms=dt_ms)
    nodes = mesh.gather_node(frame.reshape(*mesh.local, th, tw, n))
    ext = mesh.node_window(_extend_tree(nodes, send, r), th, tw, r)
    sat = _saturated(flags)
    if sat is not None:      # a node's flag on each of its local lanes
        (ly, lx), (ny, nx) = mesh.local, mesh.node_local
        sat = sat.repeat_interleave(ly // ny, 0).repeat_interleave(
            lx // nx, 1).reshape(s_local)
    return ext.reshape(s_local, th + 2 * r, tw + 2 * r, n), sat


def make_exchange(cfg: DPSNNConfig, spec: TileSpec, mesh):
    """The step's halo exchange, resolved once from the config and the
    mesh: ``exchange(frame) -> (ext_frame, saturated or None)``. Raises
    the reference's errors for an unknown wire format or policy."""
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
        return lambda f: exchange_halo_hier(f, spec, mesh, modes=ring_modes,
                                            mode=mode, **aer)
    if ring_modes is not None:
        return lambda f: exchange_halo_modes(f, spec, mesh,
                                             modes=ring_modes, **aer)
    if mode == "aer_sparse":
        return lambda f: exchange_halo_aer(f, spec, mesh, **aer)
    return lambda f: (exchange_halo(f, spec, mesh), None)


# ---------------------------------------------------------------------------
# Distributed state
# ---------------------------------------------------------------------------

class DistState(NamedTuple):
    """Stacked per-shard state: every leaf has the leading local-shard
    axis S (the reference's ``stacked_state_template`` layout). ``t`` is
    a host (CPU) int32 tensor, as the single shard's is."""
    lif: LIFState            # leaves (S, C, N), C = tile columns
    hist_ext: torch.Tensor   # (S, D, th+2r, tw+2r, N) halo-extended ring
    pending: torch.Tensor    # (S, th, tw, N) spikes of step t-1
    t: torch.Tensor          # (S,) int32, on the host
    spike_count: torch.Tensor   # (S,) f32
    event_count: torch.Tensor   # (S,) f32
    plastic: Optional[object] = None        # multi-rank STDP: item 4
    aer_sat: Optional[torch.Tensor] = None  # (S,) bool, this step's AER overflow
    # pipelined only: ext of spikes(t-2), written into the ring at step t
    ext_pending: Optional[torch.Tensor] = None  # (S, th+2r, tw+2r, N)
    # inter-spike-interval statistics: time of each neuron's last spike
    # (-1: never) and running integer-valued f32 sums of ISIs in steps
    last_spike_t: Optional[torch.Tensor] = None  # (S, C, N) int32
    isi_sum: Optional[torch.Tensor] = None       # (S,) f32
    isi_sumsq: Optional[torch.Tensor] = None     # (S,) f32
    isi_count: Optional[torch.Tensor] = None     # (S,) f32
    guard: Optional[object] = None          # multi-rank guard: item 6


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
               mesh) -> DistState:
    """Initial stacked state, deterministic per global column id, so any
    mesh starts where the single shard starts."""
    dev = mesh.device
    s_local = len(mesh.shards)
    c, n = spec.columns_per_tile, cfg.neurons_per_column
    r = spec.radius
    d = stencil.max_delay + 1
    dtype = getattr(torch, cfg.dtype)
    lif = net.init_state(cfg, shard_col_ids(cfg, spec, mesh), stencil,
                         device=dev).lif
    ext_shape = (s_local, spec.tile_h + 2 * r, spec.tile_w + 2 * r, n)

    def zeros(*shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=dev)

    return DistState(
        lif=LIFState(*(x.reshape(s_local, c, n) for x in lif)),
        hist_ext=zeros(s_local, d, *ext_shape[1:], dt=dtype),
        pending=zeros(s_local, spec.tile_h, spec.tile_w, n, dt=dtype),
        t=torch.zeros(s_local, dtype=torch.int32),
        spike_count=zeros(s_local),
        event_count=zeros(s_local),
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
              exchange=None) -> DistState:
    """One step of every local shard (``col_ids``: :func:`shard_col_ids`
    on the mesh's device; ``exchange``: :func:`make_exchange`, resolved
    here when not given). Writes ``state.hist_ext`` in place; every
    other leaf of the new state is new, ``aer_sat`` this step's
    saturation flags. The mesh must match ``spec`` and the stencil pass
    :func:`check_delays`: :func:`make_distributed_run` checks both once,
    where it binds them."""
    r = spec.radius
    n = cfg.neurons_per_column
    s_local = state.pending.shape[0]
    c_all = s_local * spec.columns_per_tile
    d_slots = state.hist_ext.shape[1]
    t = int(state.t[0])
    pipelined = cfg.exchange.pipelined
    hist_ext = state.hist_ext

    # (1) the halo exchange of step t-1's spikes, first
    if exchange is None:
        exchange = make_exchange(cfg, spec, mesh)
    ext_frame, aer_sat = exchange(state.pending)
    if aer_sat is None:
        aer_sat = torch.zeros_like(state.aer_sat)

    # (2) pipelined: the previous step's exchange goes into slot t-2
    # before the reads (delay-2 offsets read that very slot this step)
    new_ext_pending = None
    if pipelined:
        hist_ext[:, (t - 2) % d_slots] = state.ext_pending
        new_ext_pending = ext_frame

    # (3) the compute: local delivery from the pending frame (delay 1),
    # remote delivery from the extended ring (delays >= 2), the drive of
    # the shards' global columns, the neuron update
    s_loc = state.pending.reshape(c_all, n)
    per_offset = [
        net.offset_slice(hist_ext[:, (t - delay) % d_slots], dy, dx, r,
                         spec.tile_h, spec.tile_w, n)
        for (dy, dx, _k, delay, _p) in stencil.offsets]
    s_flat = torch.stack(per_offset, dim=3).reshape(
        c_all, stencil.n_offsets * n)
    ext_drive, ext_counts = net.external_drive(cfg, t, col_ids)
    lif0 = LIFState(*(x.reshape(c_all, n) for x in state.lif))
    if impl == "cuda_fused":
        lif, spikes, _, _ = net.fused_stage(cfg, params, lif0, None, s_loc,
                                            s_flat, ext_drive)
    else:
        deliver_local, deliver_remote, lif_update = net._stage_fns(impl)
        currents = deliver_local(s_loc, params.w_local)
        currents = currents + deliver_remote(s_flat, params.rem_flat,
                                             params.rem_w)
        lif, spikes = lif_update(cfg.neuron, lif0, currents + ext_drive)

    # (4) unpipelined: the exchanged frame t-1 goes into the ring after
    # the compute (first read at t+1)
    if not pipelined:
        hist_ext[:, (t - 1) % d_slots] = ext_frame

    # (5) per-shard events and ISI statistics: integer-valued f32 sums,
    # exact in any order while below 2**24
    def per_shard(x):
        return x.reshape(s_local, -1).sum(1)

    k_tot = params.rem_w.shape[-1]
    events = (per_shard(spikes * (params.local_outdeg + k_tot))
              + per_shard(ext_counts).to(torch.float32))
    spiked = spikes.reshape(state.last_spike_t.shape) > 0
    contrib = spiked & (state.last_spike_t >= 0)
    isi = (t - state.last_spike_t).to(torch.float32)
    return DistState(
        lif=LIFState(*(x.reshape(state.lif.v.shape) for x in lif)),
        hist_ext=hist_ext,
        pending=spikes.reshape(state.pending.shape),
        t=state.t + 1,
        spike_count=state.spike_count + per_shard(spikes),
        event_count=state.event_count + events,
        aer_sat=aer_sat,
        ext_pending=new_ext_pending,
        last_spike_t=torch.where(spiked, t, state.last_spike_t),
        isi_sum=state.isi_sum + per_shard(torch.where(contrib, isi, 0.0)),
        isi_sumsq=state.isi_sumsq + per_shard(
            torch.where(contrib, isi * isi, 0.0)),
        isi_count=state.isi_count + per_shard(contrib).to(torch.float32),
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
    dense_packed and within the rate bound."""
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


def make_distributed_run(cfg: DPSNNConfig, mesh, *, n_steps: int,
                         impl: str = "cuda_fused", with_state: bool = False,
                         params: NetworkParams | None = None):
    """``(run, spec)``. ``run()`` initialises the stacked state and
    simulates ``n_steps``; ``run(state)`` continues from a stacked state
    (the reference's ``make_distributed_resume``), leaving it as it was.
    It returns a :class:`DistResult`, with ``with_state`` followed by
    the final :class:`DistState`. The local shards' synapses are built
    here, once, from the seed (or taken from ``params``, a
    :func:`build_shard` of the same mesh)."""
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
            state = init_shard(cfg, spec, stencil, mesh)
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
        return (res, state) if with_state else res

    return run, spec

