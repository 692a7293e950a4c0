"""Distributed DPSNN step: stacked shards and the two-phase halo
exchange (the port of the flat, dense-packed, static path of
``repro/core/exchange.py``).

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
  rings per direction. The transport sets the wire format: a
  ``ProcessGroupMesh`` packs every strip into 32-bit words
  (``transport.pack_spikes``), a ``LocalMesh`` moves it as it is.
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
AER, per-ring ``auto`` and the hierarchical exchange (ROADMAP queue 1
item 3), multi-rank STDP (item 4) and the guard's checksummed frames
(item 6) are refused by ``network.check_supported(..., mesh=True)``.

The ring buffer is the one large leaf (286 MB at 24x24 shards of the
24x24x1240 grid): :func:`dist_step` writes it in place, and the runners
copy the state they are given once, so the caller's state stays as it
was.
"""
from __future__ import annotations

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
    aer_sat: Optional[torch.Tensor] = None  # (S,) bool, False (dense)
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
              col_ids: torch.Tensor, impl: str = "ref") -> DistState:
    """One step of every local shard (``col_ids``: :func:`shard_col_ids`
    on the mesh's device). Writes ``state.hist_ext`` in place; every
    other leaf of the new state is new. The mesh must match ``spec``
    and the stencil pass :func:`check_delays`: :func:`make_distributed_run`
    checks both once, where it binds them."""
    r = spec.radius
    n = cfg.neurons_per_column
    s_local = state.pending.shape[0]
    c_all = s_local * spec.columns_per_tile
    d_slots = state.hist_ext.shape[1]
    t = int(state.t[0])
    pipelined = cfg.exchange.pipelined
    hist_ext = state.hist_ext

    # (1) the halo exchange of step t-1's spikes, first
    ext_frame = exchange_halo(state.pending, spec, mesh)

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
        aer_sat=state.aer_sat,
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
    the single shard's ``SimResult.rate_trace``; ``aer_saturated`` is
    all zeros under dense_packed."""
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
        step_spikes = []
        for _ in range(n_steps):
            state = dist_step(cfg, params, state, spec=spec,
                              stencil=stencil, mesh=mesh, col_ids=col_ids,
                              impl=impl)
            step_spikes.append(state.pending.sum())
        trace = (torch.stack(step_spikes) if step_spikes else
                 torch.zeros((0,), device=mesh.device))
        trace = mesh.all_sum(trace.to(torch.float64)).to(f32)
        spikes = _total(mesh, state.spike_count)
        res = DistResult(
            rate_hz=spikes * _recip(cfg.n_neurons * sim_s),
            events=_total(mesh, state.event_count),
            spikes=spikes,
            state_checksum=_total(mesh, state.lif.v.flatten(1).sum(1)),
            aer_saturated=torch.zeros(n_steps, dtype=torch.int32,
                                      device=mesh.device),
            rate_trace=trace * per_step,
        )
        return (res, state) if with_state else res

    return run, spec

