"""Batched multi-tenant single-shard engine (the port of
``repro/core/batched.py``; DESIGN.md §Service).

B independent network instances ("tenants") advance in lockstep, each
kernel launched once per loop step for all of them, on (B*C, ...) views
of their rows:

shared (one copy, every tenant reads it):
    * the network: ``rem_flat`` (the ELL indices) and ``local_outdeg``
    * the weights ``w_local`` and ``rem_w`` when plasticity is off

per tenant (a leading tenant axis B on every leaf):
    * membrane, adaptation and refractory state, the spike-history ring,
      the step counter, the spike and event counters, the STDP traces,
      the integrity guard
    * under ``cfg.stdp``: the plastic weights (each tenant trains its own
      copy; ``rem_flat`` stays shared)
    * the Poisson drive (its ``seed``) and its rate (``nu_scale``)

Unlike the reference's ``vmap`` over one step function, the tenants do
not share a step counter: a recycled slot starts at 0 while its
batch-mates are at 50. ``t``, ``steps_left`` and the active mask are
(B,) device tensors advanced on the device, each tenant's ring slots are
picked with a gather and written with a scatter, and the drive kernel
reads each tenant's seed, step and rate from device arrays, so the host
never waits inside a chunk. Unguarded, it does not wait at a chunk's end
either: it knows each slot's steps without reading them back, and the
service copies the raster while the card runs the next chunk
(``launch/serve.py``). Under the guard it reads ``steps_left`` and the
guard once per chunk.

The B = 1 guarantee: one slot with ``seed == cfg.seed`` and no stimulus
scaling runs the kernels of ``simulation.run`` on the same rows, so it
equals the single-tenant run to the bit; a slot of any batch equals the
dedicated run ``simulation.run(seed=, nu_scale=)`` of its tenant to the
bit (the plain versions run once per tenant where a batched reduction
could reorder a float32 sum, ``kernels/ref.py``).

Slot recycling: :func:`run_chunk` advances up to ``chunk`` steps with
finished and quarantined slots frozen (the small leaves by
``torch.where``, the plastic weights by the STDP kernels' ``active``
pass-through), and :func:`insert_tenant` swaps a fresh tenant into a
dead slot between chunks (``launch/serve.py``).

This engine runs the tenants on one shard. Over a shard mesh (in one
process, or over ranks with the tenants sharded over batch shards) they
run in lockstep, one host ``t``, without recycling, through
``exchange.make_batched_distributed_run``, on the same tenant axis of
the kernels.
"""
from __future__ import annotations

import functools
from collections import deque
from typing import NamedTuple

import torch

from repro_torch.configs.base import DPSNNConfig
from repro_torch.core import network as net
from repro_torch.core import plasticity as plast
from repro_torch.core.connectivity import build_stencil, neuron_types
from repro_torch.core.network import NetworkParams, NetworkState
from repro_torch.core.neuron import LIFState
from repro_torch.core.plasticity import STDPState
from repro_torch.kernels import ops
from repro_torch.runtime import integrity
from repro_torch.runtime.spans import span


class BatchedChunkResult(NamedTuple):
    params: NetworkParams      # plastic leaves (B, ...) under cfg.stdp
    state: NetworkState        # every leaf (B, ...), t (B,) on the device
    steps_left: torch.Tensor   # (B,) int32 on the device
    raster: torch.Tensor       # (chunk, B, C, N) bool on the device
    steps_taken: int           # loop steps the reference's loop runs
    host_steps_left: torch.Tensor  # (B,) int32: steps_left on the host


def map_leaves(fn, *trees):
    """``fn`` over the tensor leaves of NamedTuple trees (None passes)."""
    if trees[0] is None:
        return None
    if isinstance(trees[0], tuple):
        return type(trees[0])(*(map_leaves(fn, *sub)
                                for sub in zip(*trees)))
    return fn(*trees)


def init_tenants(cfg: DPSNNConfig, seeds, device="cuda") -> NetworkState:
    """Fresh state of one tenant per entry of ``seeds`` (B host ints) on
    ``device``: tenant i's leaves are ``network.init_state(seed=seeds[i])``
    to the bit, stacked, with the step counters a (B,) device tensor."""
    dev = net.resolve_device(device)
    col_ids = net.column_ids(cfg)
    stencil = build_stencil(cfg)
    states = [net.init_state(cfg, col_ids, stencil, dev, seed=int(s))
              for s in seeds]
    return map_leaves(lambda *xs: torch.stack(xs).to(dev), *states)


def batch_params(cfg: DPSNNConfig, params: NetworkParams,
                 batch: int) -> NetworkParams:
    """Each tenant's own copy of the plastic leaves, (B, ...), under
    ``cfg.stdp``. Static runs return ``params`` itself: one copy of the
    weights serves every tenant."""
    if not cfg.stdp:
        return params

    def rep(x):
        return x.unsqueeze(0).repeat(batch, *(1,) * x.dim())
    return params._replace(w_local=rep(params.w_local),
                           rem_w=rep(params.rem_w))


def params_in_axes(cfg: DPSNNConfig):
    """Which ``NetworkParams`` leaves carry the tenant axis (0) and which
    are shared (None), as the reference's ``vmap`` in_axes: the plastic
    weights under STDP; None (all shared) otherwise."""
    if not cfg.stdp:
        return None
    return NetworkParams(w_local=0, rem_flat=None, rem_w=0,
                         local_outdeg=None)


def tenant_rates(cfg: DPSNNConfig, nu_scale, batch: int) -> torch.Tensor:
    """(B,) float32 drive rates on the host: ``float32(lam) * nu_scale``
    (``network.drive_rate``), or ``float32(lam)`` for every tenant with
    ``nu_scale`` None. Raises ``NotImplementedError`` for a rate of 10 or
    more: the drive ports only the reference's branch below 10 (Knuth's),
    and refuses rather than running on another."""
    if nu_scale is None:
        lam = torch.full((batch,), net.drive_rate(cfg), dtype=torch.float32)
    else:
        lam = net.drive_rate(cfg, torch.as_tensor(nu_scale).cpu())
    bad = ~((lam >= 0) & (lam < 10.0))
    if bool(bad.any()):
        raise NotImplementedError(
            f"drive rate {lam[bad].tolist()} per step: only Knuth's branch "
            f"(0 <= lam < 10) of jax.random.poisson is ported")
    return lam


def neighbour_tables(hist: torch.Tensor, t: torch.Tensor, stencil,
                     grid_hw: tuple[int, int]) -> torch.Tensor:
    """The (B*C, O*N) delayed neighbour-spike tables of B tenants from
    their (B, D, C, N) rings at their own steps ``t`` ((B,) int64 on the
    device): ``network.neighbour_table_single`` of each, the slots picked
    by a gather."""
    b, d, c, n = hist.shape
    gh, gw = grid_hw
    r = stencil.radius
    ar = torch.arange(b, device=hist.device)
    padded = {}                       # one zero-padded frame per delay
    per_offset = []
    for (dy, dx, _k, delay, _p) in stencil.offsets:
        if delay not in padded:
            g = hist.new_zeros((b, gh + 2 * r, gw + 2 * r, n))
            g[:, r:r + gh, r:r + gw] = hist[ar, (t - delay) % d].reshape(
                b, gh, gw, n)
            padded[delay] = g
        per_offset.append(net.offset_slice(padded[delay], dy, dx, r, gh, gw,
                                           n))
    if not per_offset:
        return hist.new_zeros((b * c, 0))
    return torch.stack(per_offset, dim=3).reshape(
        b * c, stencil.n_offsets * n)


def make_batched_step(cfg: DPSNNConfig, *, impl: str = "cuda_fused"):
    """The step of all B tenants, ``(params, bstate, seeds, lam, active,
    chaos_nan=None) -> (params', bstate', frames)``: ``seeds`` (B,) int32,
    ``lam`` (B,) float32 drive rates (:func:`tenant_rates`), ``active``
    (B,) bool, all on the state's device; ``frames`` the (B, C, N) bool
    spikes of this step, zero for an inactive tenant, whose state and
    weights come back as they were. ``chaos_nan`` ((B,) int32, -1 for
    none) is each tenant's NaN-injection step under
    ``cfg.guard.enabled``.

    One launch of each kernel serves every tenant: ``keyed_drive`` (its
    tenant instance), then ``fused_step`` (``cuda_fused``) or
    ``synapse_matmul``, ``ell_gather`` and ``lif_step`` (``cuda``), and
    under STDP ``stdp_dense_update`` and ``stdp_remote_update`` with the
    tenants' ``active`` pass-through; ``ref`` runs the plain versions.
    The reference's tenant step is its ``vmap`` of the single-tenant
    step; this one is the single-tenant step's code on the tenants' rows,
    which is also the one-tenant step at B = 1."""
    net.check_supported(cfg, impl)
    stencil = build_stencil(cfg)
    grid_hw = (cfg.grid_h, cfg.grid_w)
    gcfg = cfg.guard
    f32, i32 = torch.float32, torch.int32
    consts = {}     # per (device, B): tenant indices, column ids, types
    axes = params_in_axes(cfg)

    def step(params, bstate, seeds, lam, active, chaos_nan=None):
        b, d, c, n = bstate.hist.shape
        rows = b * c
        dev = bstate.hist.device
        if (dev, b) not in consts:
            consts[dev, b] = (torch.arange(b, device=dev),
                              net.column_ids(cfg, dev),
                              neuron_types(cfg, dev))
        ar, col_ids, is_inh = consts[dev, b]
        t = bstate.t
        tl = t.long()

        def flat(x):
            return x.reshape(rows, *x.shape[2:])

        p = params           # the kernels' view: each tenant's rows
        if axes is not None:
            p = NetworkParams(*(x if ax is None else flat(x)
                                for x, ax in zip(params, axes)))
        lif0 = LIFState(*map(flat, bstate.lif))
        stdp0 = STDPState(*map(flat, bstate.stdp)) if cfg.stdp else None

        # 1. recurrent delivery from each tenant's delayed history
        s_loc = bstate.hist[ar, (tl - cfg.conn.min_delay_steps) % d].reshape(
            rows, n)
        s_flat = neighbour_tables(bstate.hist, tl, stencil, grid_hw)

        # 2. each tenant's Poisson drive, one launch
        ext, ext_counts = ops.keyed_drive_tenants(seeds, t, col_ids, n, lam,
                                                  cfg.conn.j_ext)

        # 3. delivery + neuron update over the tenants' rows
        new_stdp, gflags = stdp0, None
        if impl == "cuda_fused":
            lif, spikes, new_stdp, gflags = net.fused_stage(
                cfg, p, lif0, stdp0, s_loc, s_flat, ext)
        else:
            deliver_local, deliver_remote, lif_update = net._stage_fns(impl)
            currents = deliver_local(s_loc, p.w_local)
            currents = currents + deliver_remote(s_flat, p.rem_flat, p.rem_w)
            currents = currents + ext
            lif, spikes = lif_update(cfg.neuron, lif0, currents)

        # 3b. each tenant's guard: its poison lands on the fresh state, so
        # the kernel's flags are dropped whenever poison is given
        guard = bstate.guard
        if gcfg.enabled:
            if chaos_nan is not None:
                lif = lif._replace(v=integrity.inject_nan(
                    gcfg, t, lif.v, chaos_step=chaos_nan))
                gflags = None
            tr = new_stdp if cfg.stdp else None
            code = integrity.step_verdict(
                gcfg, v=lif.v, spikes=spikes,
                x_pre=None if tr is None else tr.x_pre,
                x_post=None if tr is None else tr.x_post,
                kernel_flags=gflags, tenants=b)
            guard = integrity.guard_update(gcfg, bstate.guard,
                                           step_code=code, t=t)

        # 3c. STDP, an inactive tenant's weights passed through
        new_params, traces = params, new_stdp
        if cfg.stdp:
            table = plast.pre_trace_table(stdp0.x_pre, stencil, grid_hw)
            p1, traces = plast.stdp_update(
                cfg, cfg.stdp_cfg, p, stdp0, spikes, is_inh,
                pre_trace_table=table,
                rem_flat=p.rem_flat, impl=impl,
                new_traces=new_stdp if impl == "cuda_fused" else None,
                active=active)
            new_params = params._replace(
                w_local=p1.w_local.reshape(params.w_local.shape),
                rem_w=p1.rem_w.reshape(params.rem_w.shape))

        # 4. the ring: this step's spikes into each active tenant's slot
        spk = spikes.reshape(b, c, n)
        keep = active[:, None, None]
        slot = tl % d
        hist = bstate.hist.clone()
        hist[ar, slot] = torch.where(keep, spk, bstate.hist[ar, slot])

        # 5. events per tenant, each summed as the single tenant sums it
        k_tot = params.rem_w.shape[-1]
        per_event = spk * (params.local_outdeg + k_tot)
        counts = ext_counts.reshape(b, c, n)
        events = torch.stack([per_event[i].sum() + counts[i].sum().to(f32)
                              for i in range(b)])

        def freeze(new, old):
            return torch.where(active.reshape(-1, *(1,) * (old.dim() - 1)),
                               new.reshape(old.shape), old)

        state = NetworkState(
            lif=map_leaves(freeze, LIFState(*lif), bstate.lif),
            hist=hist,
            t=t + active.to(i32),
            spike_count=freeze(bstate.spike_count + spk.sum((1, 2)),
                               bstate.spike_count),
            event_count=freeze(bstate.event_count + events,
                               bstate.event_count),
            stdp=(map_leaves(freeze, traces, bstate.stdp) if cfg.stdp
                  else None),
            guard=map_leaves(freeze, guard, bstate.guard) if gcfg.enabled
            else None,
        )
        return new_params, state, (spk != 0) & keep

    return step


@functools.lru_cache(maxsize=16)
def _chunk_step(cfg: DPSNNConfig, impl: str):
    """The batched step of (cfg, impl), built once: every chunk of a
    server reuses its stencil and its per-device constants."""
    return make_batched_step(cfg, impl=impl)


class _Polls:
    """Whether any slot is still active after each loop step, read back
    without waiting: a non-blocking copy into pinned memory and an event
    per step, looked at only once the card has passed it. The loop stops
    at most a few steps after every slot stopped; the steps past that
    are frozen no-ops. On the CPU the flag is read at once."""

    def __init__(self, device: torch.device, chunk: int):
        self.cuda = device.type == "cuda"
        self.flags = torch.ones(chunk, dtype=torch.bool,
                                pin_memory=self.cuda)
        self.pending = deque()

    def post(self, i: int, alive: torch.Tensor) -> None:
        self.flags[i].copy_(alive, non_blocking=self.cuda)
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record()
        self.pending.append((i, event))

    def stopped(self) -> bool:
        while self.pending and (self.pending[0][1] is None
                                or self.pending[0][1].query()):
            i, _ = self.pending.popleft()
            if not bool(self.flags[i]):
                return True
        return False


def run_chunk(cfg: DPSNNConfig, params: NetworkParams, bstate: NetworkState,
              seeds, steps_left, chunk: int, impl: str = "cuda_fused",
              nu_scale=None, chaos_nan=None) -> BatchedChunkResult:
    """Advance the batch up to ``chunk`` steps under the recycling mask.

    ``seeds``, ``steps_left``, ``nu_scale`` and ``chaos_nan`` are B host
    values each (``nu_scale`` None: every tenant at the configured rate;
    ``chaos_nan`` (-1 = healthy) only under ``cfg.guard.enabled``; with
    no slot poisoned, the guard reads ``fused_step``'s flags). A slot
    is active while its ``steps_left`` is positive and, under the guard,
    its guard has not tripped: a tripped tenant freezes the step it trips
    (quarantine) with ``steps_left`` still positive, so the caller tells
    finished from quarantined. Finished and quarantined slots are frozen
    to the bit.

    The loop stops after ``chunk`` steps or once no slot is active, as
    the reference's ``while_loop``: the host knows when the finishing
    slots run out; that every remaining slot tripped, only the card knows,
    and under the guard the loop learns it from :class:`_Polls` without
    waiting. ``steps_taken`` is the reference's count, the most steps
    any slot took. ``raster[i, b]`` is slot b's spikes at its ``i``-th
    step of the chunk (zero once it stopped).

    Unguarded, nothing is read back and nothing waits for the card: each
    active slot runs ``min(steps_left, n_max)`` steps, so the host has
    ``steps_taken`` and ``host_steps_left`` (equal to the device's
    ``steps_left``) before the card has run the chunk. Under the guard
    both come from the device, which waits for the chunk's last step."""
    b, _, c, n = bstate.hist.shape
    dev = bstate.hist.device
    guarded = cfg.guard.enabled
    left0 = torch.as_tensor(steps_left, dtype=torch.int32).cpu()
    lam = tenant_rates(cfg, nu_scale, b).to(dev, non_blocking=True)
    seeds = torch.as_tensor(seeds, dtype=torch.int32).to(dev,
                                                         non_blocking=True)
    chaos = None      # no poison this chunk: the kernel's guard flags hold
    if guarded and chaos_nan is not None:
        cn = torch.as_tensor(chaos_nan, dtype=torch.int32).expand(b)
        if bool((cn >= 0).any()):
            chaos = cn.to(dev)
    alive = left0 > 0
    if guarded:       # one read of the guard, before the chunk's work
        alive &= ~bstate.guard.tripped.cpu()
    n_max = min(chunk, int(left0[alive].max())) if bool(alive.any()) else 0
    step = _chunk_step(cfg, impl)
    raster = torch.zeros((chunk, b, c, n), dtype=torch.bool, device=dev)
    left = left0.to(dev, non_blocking=True)
    polls = _Polls(dev, chunk) if guarded else None
    p, s = params, bstate
    with span("serve.enqueue"):
        for i in range(n_max):
            if polls is not None and polls.stopped():
                break
            active = left > 0
            if guarded:
                active = active & ~s.guard.tripped
            p, s, raster[i] = step(p, s, seeds, lam, active, chaos)
            left = left - active.to(torch.int32)
            if polls is not None:
                polls.post(i, ((left > 0) & ~s.guard.tripped).any())
    if guarded:
        left_host = left.cpu()
        taken = int((left0 - left_host).max()) if b else 0
    else:
        left_host = left0 - left0.clamp(0, n_max)
        taken = n_max
    return BatchedChunkResult(params=p, state=s, steps_left=left,
                              raster=raster, steps_taken=taken,
                              host_steps_left=left_host)


def run_batched(cfg: DPSNNConfig, params: NetworkParams,
                bstate: NetworkState, seeds, n_steps: int,
                impl: str = "cuda_fused", nu_scale=None) -> BatchedChunkResult:
    """Every tenant runs ``n_steps``: one chunk of ``n_steps``."""
    left = [n_steps] * bstate.hist.shape[0]
    return run_chunk(cfg, params, bstate, seeds, left, n_steps, impl,
                     nu_scale)


def insert_tenant(cfg: DPSNNConfig, params: NetworkParams,
                  bstate: NetworkState, slot: int, seed: int,
                  fresh_params: NetworkParams | None = None,
                  ) -> tuple[NetworkParams, NetworkState]:
    """Recycle batch ``slot`` for a new tenant keyed by ``seed``, between
    chunks: a new state whose row ``slot`` is a fresh ``init_state``,
    every other row as it was; under STDP the slot's plastic weights are
    set to ``fresh_params``' (or kept, for a tenant that starts warm),
    written into ``params`` in place (a copy of every tenant's weights
    would cost gigabytes)."""
    dev = bstate.hist.device
    fresh = net.init_state(cfg, net.column_ids(cfg), device=dev, seed=seed)

    def put(rows, row):
        out = rows.clone()
        out[slot] = row
        return out

    bstate = map_leaves(put, bstate, fresh)
    if cfg.stdp and fresh_params is not None:
        params.w_local[slot] = fresh_params.w_local
        params.rem_w[slot] = fresh_params.rem_w
    return params, bstate
