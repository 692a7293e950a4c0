"""Batched multi-tenant DPSNN simulation service (the port of
``repro/launch/serve.py``; DESIGN.md §Service).

The serving front end over the batched engine (``core/batched.py``): a
request queue packs jobs, each with its own seed, duration and stimulus
intensity, into the B slots of one batch, whose every loop step is one
launch of each kernel for all B tenants (``batched.run_chunk``).
Tenants that finish mid-chunk are frozen, and their slot is recycled for
the next queued job between chunks (``batched.insert_tenant``); each
job's spike raster streams back chunk by chunk through its ``on_chunk``
callback.

The chunks run as a pipeline one chunk deep. Each chunk's ``(steps, B,
C, N)`` raster, and the card's ``steps_left``, are copied into pinned
host memory without blocking, behind a CUDA event. Unguarded, the host
knows which slots chunk k frees without reading the card, so it packs
them and enqueues chunk k+1 before it waits for chunk k's copy; the
clients' ``on_chunk`` callbacks and the harvest of chunk k's finished
jobs then run while the card computes chunk k+1. JobResults come out in
the order they would without the pipeline, one chunk's enqueue later.
Where the next pack needs what only the card or the clock after the
chunk can tell, under ``cfg.guard.enabled`` (a trip) or while a slot's
job has a ``deadline_s``, chunk k is delivered before chunk k+1 is
enqueued.

Quickstart (README, "Serving quickstart" of the port)::

    from repro_torch.configs import dpsnn
    from repro_torch.launch.serve import BatchedSimServer, SimJob

    server = BatchedSimServer(dpsnn.reduced(4, 4, 32), slots=4, chunk=16,
                              device="cuda")        # or device="cpu"
    server.submit(SimJob(job_id="a", seed=7, n_steps=100))
    server.submit(SimJob(job_id="b", seed=8, n_steps=40))
    for result in server.drain():          # yields JobResult on completion
        print(result.job_id, result.spikes, result.raster.shape)
    print(server.metrics_row())

or from the command line (a staggered job mix, the metrics row)::

    PYTHONPATH=src python -m repro_torch.launch.serve --grid 4x4 \\
        --neurons 32 --slots 4 --jobs 8 --steps 60 --device cpu --json -

Guarantees (tests/test_torch_serve.py): every job's trajectory is, to the
bit, the dedicated single-tenant run ``simulation.run(seed=, nu_scale=)``
of its seed; slot packing, batch-mates and recycling are invisible to it.
The server runs on one shard. Tenants over a shard mesh, in one process
or over ranks with the tenant axis over batch shards, run through
``exchange.make_batched_distributed_run`` (``launch_distributed --batch
B [--batch-shards K]``), in lockstep and without slot recycling, as in
the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from collections import deque
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs import dpsnn
from repro_torch.configs.base import DPSNNConfig, GuardConfig
from repro_torch.core import batched
from repro_torch.core import network as net
from repro_torch.core import simulation as sim
from repro_torch.core.network import NetworkParams, NetworkState
from repro_torch.runtime import integrity, spans


@dataclasses.dataclass
class SimJob:
    """One tenant's request: an independent network instance to simulate.

    ``seed`` keys the tenant's initial membrane state and Poisson drive
    (the network is shared by every tenant: it comes from the server
    config's seed). ``nu_scale`` scales the tenant's drive rate (1.0 ==
    the configured ``nu_ext_hz``, bitwise neutral). ``on_chunk(job_id,
    t0, frames)`` streams the raster: ``frames`` is a (k, C, N) bool
    array of the tenant's spikes for its steps ``t0 .. t0+k``.

    ``deadline_s`` (wall seconds from slot admission, 0 = none) evicts a
    job that overstays, returning its partial result with
    ``status="deadline"``. ``chaos_nan_at_step`` (requires the server's
    ``cfg.guard.enabled``) poisons THIS tenant's membrane state with NaN
    at that step: the deterministic poison of the quarantine tests.
    """
    job_id: str
    seed: int
    n_steps: int
    nu_scale: float = 1.0
    on_chunk: Optional[Callable[[str, int, np.ndarray], None]] = None
    deadline_s: float = 0.0
    chaos_nan_at_step: int = -1


@dataclasses.dataclass
class JobResult:
    """Completion record: totals from the tenant's own counters and its
    spike raster (None when the server runs ``keep_raster=False``).

    ``status``: "ok" ran to completion; "quarantined" its integrity guard
    tripped, the slot was frozen the same step (batch-mates untouched)
    and evicted; "deadline" evicted past its ``deadline_s``. Non-ok
    results carry the partial totals and raster up to the freeze.
    ``guard`` is the tenant's guard report (None when unguarded)."""
    job_id: str
    seed: int
    n_steps: int
    spikes: float
    events: float
    rate_hz: float
    raster: Optional[np.ndarray]   # (n_steps, C, N) bool
    status: str = "ok"
    guard: Optional[dict] = None


@dataclasses.dataclass
class _Tenant:
    """A job in its slot: the steps it has run, its raster so far (kept
    under ``keep_raster``, allocated at its first frames), and its
    deadline (absolute monotonic time, None for none)."""
    job: SimJob
    deadline: Optional[float]
    done: int = 0
    raster: Optional[np.ndarray] = None


@dataclasses.dataclass
class _Chunk:
    """A chunk in flight: what its delivery needs once the card has run
    it. ``raster`` and ``card_left`` are host tensors (pinned on the
    card's host) whose copies ``event`` follows (None on the CPU)."""
    tenants: list               # each slot's _Tenant at the enqueue
    left_before: np.ndarray
    left: np.ndarray            # steps left after the chunk (the host's)
    state: NetworkState         # the batch after the chunk
    raster: torch.Tensor        # (chunk, B, C, N) bool; its first k rows
    card_left: torch.Tensor     # (B,) int32: the card's steps_left
    tripped: torch.Tensor       # (B,) bool: the guards' trips
    event: Optional[torch.cuda.Event]
    steps_taken: int
    tenant_steps: int
    copy_bytes: int
    copy_start_ns: int          # the copy's enqueue, perf_counter_ns
    start_s: float              # the chunk's enqueue, perf_counter
    span_id: Optional[int]      # its serve.chunk span
    counts: Optional[np.ndarray] = None   # (2, B): spikes, events


class QueueFull(RuntimeError):
    """submit() backpressure: the bounded request queue is at capacity.
    Retry after drain progress (or raise ``max_queue``)."""


class BatchedSimServer:
    """Multi-tenant simulation server over one batch of ``slots`` tenants.

    All B tenants advance in lockstep, one launch of each kernel a step
    serving all of them and, static, one copy of the weights; jobs beyond
    B queue and take over recycled slots as earlier tenants finish. On
    the card (``device``, CUDA by default) unless ``device="cpu"``.

    ``params`` is the network to serve when it is not the one ``cfg.seed``
    builds (None builds that, as the reference's server does): a network
    built once and shared by several servers, trained, or carried from
    the reference with ``repro_torch.convert`` (the port's truncated-
    normal weights differ from the reference's in the last bits). It must
    lie on ``device``."""

    def __init__(self, cfg: DPSNNConfig, *, slots: int = 4,
                 chunk: int = 32, impl: str = "cuda_fused",
                 keep_raster: bool = True, max_queue: int = 0,
                 device="cuda", params: NetworkParams | None = None):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        net.check_supported(cfg, impl)
        self.cfg = cfg
        self.slots = slots
        self.chunk = chunk
        self.impl = impl
        self.keep_raster = keep_raster
        self.max_queue = max_queue    # 0 = unbounded; else submit() rejects
        dev = net.resolve_device(device)
        if params is None:
            params, _ = sim.build(cfg, device=dev)
        where = params.w_local.device
        if where.type != dev.type or dev.index not in (None, where.index):
            raise ValueError(f"params lie on {where}, the server runs on "
                             f"{dev}")
        self.params = params
        self._bparams = batched.batch_params(cfg, self.params, slots)
        # slot tables (host-side; device state lives in self._bstate)
        self._seeds = np.zeros((slots,), np.int32)
        self._nu = np.ones((slots,), np.float32)
        self._left = np.zeros((slots,), np.int32)       # 0 == free slot
        self._tenant: list = [None] * slots     # each slot's _Tenant
        self._chaos = np.full((slots,), -1, np.int32)
        self._bstate = batched.init_tenants(cfg, [0] * slots, where)
        self._queue: deque = deque()      # (job, perf_counter_ns at submit)
        self._used: list = [False] * slots
        self._closed = False
        self._pending: Optional[_Chunk] = None  # enqueued, not delivered
        self._wall_end = 0.0    # perf_counter when a chunk was last waited
        # harvests read counters beside the next chunk's work
        self._side = torch.cuda.Stream(where) if where.type == "cuda" \
            else None
        self.stats = {"jobs_submitted": 0, "jobs_completed": 0,
                      "chunks": 0, "chunks_overlapped": 0, "loop_steps": 0,
                      "tenant_steps": 0, "recycles": 0, "wall_s": 0.0,
                      "quarantined": 0, "deadline_evictions": 0,
                      "rejected_submits": 0}

    @property
    def state(self):
        """The batch's state on the device, every leaf (B, ...): a slot
        whose job finished keeps its final state until it is recycled."""
        return self._bstate

    # ---- request queue -------------------------------------------------

    def submit(self, job: SimJob) -> str:
        if self._closed:
            raise RuntimeError(
                f"server is closed — job {job.job_id!r} rejected")
        if job.n_steps < 1:
            raise ValueError(f"job {job.job_id!r}: n_steps must be >= 1")
        if job.chaos_nan_at_step >= 0 and not self.cfg.guard.enabled:
            raise ValueError(
                f"job {job.job_id!r} requests NaN injection but the "
                f"server config has the integrity guard disabled")
        lam = net.drive_rate(self.cfg, job.nu_scale)
        if not 0.0 <= lam < 10.0:
            raise NotImplementedError(
                f"job {job.job_id!r}: nu_scale {job.nu_scale} makes the "
                f"drive rate {lam} per step; only Knuth's branch "
                f"(0 <= lam < 10) of jax.random.poisson is ported")
        if self.max_queue and len(self._queue) >= self.max_queue:
            self.stats["rejected_submits"] += 1
            raise QueueFull(
                f"request queue at capacity ({self.max_queue}) — job "
                f"{job.job_id!r} rejected; retry after drain progress")
        self._queue.append((job, time.perf_counter_ns()))
        self.stats["jobs_submitted"] += 1
        return job.job_id

    def close(self) -> None:
        """Graceful shutdown: refuse new submits; drain() still finishes
        the queue and every in-flight slot."""
        self._closed = True

    def _pack(self) -> None:
        """Move queued jobs into free slots (fresh per-tenant state)."""
        with spans.span("serve.pack") as sp:
            admitted = 0
            for b in range(self.slots):
                if self._left[b] > 0 or not self._queue:
                    continue
                job, submitted_ns = self._queue.popleft()
                spans.emit("serve.queue", submitted_ns, job_id=job.job_id)
                self._bparams, self._bstate = batched.insert_tenant(
                    self.cfg, self._bparams, self._bstate, b, job.seed,
                    fresh_params=self.params if self.cfg.stdp else None)
                self._seeds[b] = job.seed
                self._nu[b] = job.nu_scale
                self._left[b] = job.n_steps
                self._tenant[b] = _Tenant(
                    job, deadline=(time.monotonic() + job.deadline_s
                                   if job.deadline_s > 0 else None))
                self._chaos[b] = job.chaos_nan_at_step
                if self._used[b]:
                    self.stats["recycles"] += 1
                self._used[b] = True
                admitted += 1
            sp.set(admitted=admitted)

    # ---- the batch -----------------------------------------------------

    def _enqueue(self) -> _Chunk:
        """Enqueue one chunk and the copy of its raster and ``steps_left``
        to the host, behind an event; wait for nothing unless the guard
        must be read (``batched.run_chunk``)."""
        guarded = self.cfg.guard.enabled
        left_before = self._left.copy()
        # the slots' jobs that run in this chunk (a job that finished in
        # the chunk in flight is that chunk's to deliver)
        tenants = [ten if left > 0 else None
                   for ten, left in zip(self._tenant, left_before)]
        with spans.span("serve.chunk") as chunk:
            start = time.perf_counter()
            out = batched.run_chunk(
                self.cfg, self._bparams, self._bstate, self._seeds,
                self._left, self.chunk, self.impl, self._nu,
                self._chaos if guarded else None)
            self._bparams, self._bstate = out.params, out.state
            self._left = out.host_steps_left.numpy().copy()
            copy_start = time.perf_counter_ns()
            raster, card_left, tripped, event = self._copy(out, guarded)
            taken = out.steps_taken
            tenant_steps = int((left_before - self._left).sum())
            chunk.set(steps_taken=taken, tenant_steps=tenant_steps)
        return _Chunk(
            tenants=tenants, left_before=left_before, left=self._left.copy(),
            state=out.state, raster=raster, card_left=card_left,
            tripped=tripped, event=event, steps_taken=taken,
            tenant_steps=tenant_steps,
            copy_bytes=(taken * raster[0].numel() + card_left.nbytes
                        + (tripped.nbytes if guarded else 0)),
            copy_start_ns=copy_start, start_s=start, span_id=chunk.id)

    def _copy(self, out, guarded: bool):
        """The chunk's raster, the card's ``steps_left`` and the guards'
        trips on the host: on the card, non-blocking copies into pinned
        memory (the raster's a whole chunk long, so that the caching host
        allocator reuses its blocks) and the event they finish at; on the
        CPU the tensors themselves."""
        left = out.steps_left
        tripped = (out.state.guard.tripped if guarded
                   else torch.zeros(self.slots, dtype=torch.bool))
        if self._side is None:
            return out.raster, left, tripped, None
        taken = out.steps_taken
        raster = torch.empty(out.raster.shape, dtype=torch.bool,
                             pin_memory=True)
        raster[:taken].copy_(out.raster[:taken], non_blocking=True)
        host_left = torch.empty(left.shape, dtype=left.dtype,
                                pin_memory=True)
        host_left.copy_(left, non_blocking=True)
        if guarded:
            host_tripped = torch.empty(tripped.shape, dtype=torch.bool,
                                       pin_memory=True)
            tripped = host_tripped.copy_(tripped, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return raster, host_left, tripped, event

    def _deliver(self, c: _Chunk, overlapped: bool) -> list:
        """Wait for chunk ``c``'s copy, then hand each slot's frames of it
        to its job's ``on_chunk`` and return the JobResults of the jobs
        that finished or were evicted. ``overlapped``: the next chunk is
        already enqueued, so all of this runs beside the card's work.

        Under ``cfg.guard.enabled`` a tenant whose guard trips is frozen
        in-band the same step, so its NaN never advances and batch-mates
        are untouched; here the host evicts it with
        ``status="quarantined"``. Deadline eviction reclaims slots whose
        job overstayed ``deadline_s``."""
        if c.event is not None:
            c.event.synchronize()
        end = time.perf_counter()
        spans.emit("serve.copy", c.copy_start_ns, parent=c.span_id,
                   bytes=c.copy_bytes)
        self.stats["wall_s"] += end - max(c.start_s, self._wall_end)
        self._wall_end = end
        # the chunk's work is counted once the card has done it
        self.stats["chunks"] += 1
        self.stats["loop_steps"] += c.steps_taken
        self.stats["tenant_steps"] += c.tenant_steps
        if not np.array_equal(c.card_left.numpy(), c.left):
            raise RuntimeError(
                f"the card's steps left {c.card_left.tolist()} differ from "
                f"the host's {c.left.tolist()}")
        self.stats["chunks_overlapped"] += overlapped
        with spans.span("serve.deliver", parent=c.span_id,
                        overlapped=int(overlapped)):
            now = time.monotonic()
            raster = c.raster.numpy()
            tripped = c.tripped.numpy()
            finished = []
            for b, ten in enumerate(c.tenants):
                if ten is None:
                    continue
                took = int(c.left_before[b] - c.left[b])
                if took:
                    frames = raster[:took, b]
                    if ten.job.on_chunk is not None:
                        ten.job.on_chunk(ten.job.job_id, ten.done, frames)
                    if self.keep_raster:
                        # a copy, so the pinned block goes back to the
                        # caching host allocator once the clients let go
                        if ten.raster is None:
                            ten.raster = np.empty(
                                (ten.job.n_steps,) + frames.shape[1:],
                                frames.dtype)
                        ten.raster[ten.done:ten.done + took] = frames
                    ten.done += took
                if tripped[b]:
                    finished.append(self._harvest(c, b, status="quarantined"))
                elif c.left[b] == 0:
                    finished.append(self._harvest(c, b))
                elif ten.deadline is not None and now > ten.deadline:
                    finished.append(self._harvest(c, b, status="deadline"))
            return finished

    def _counts(self, c: _Chunk) -> np.ndarray:
        """Chunk ``c``'s (2, B) spike and event counters on the host. On
        the card they are read on a stream of their own, so the read
        waits for chunk ``c`` (already done) and not for the chunk the
        card runs now; chunk ``c``'s state is its own, which
        ``insert_tenant`` does not write."""
        if c.counts is None:
            st = c.state
            if self._side is None:
                c.counts = torch.stack((st.spike_count,
                                        st.event_count)).numpy()
            else:
                counts = torch.empty((2, self.slots), dtype=torch.float32,
                                     pin_memory=True)
                with torch.cuda.stream(self._side):
                    counts[0].copy_(st.spike_count, non_blocking=True)
                    counts[1].copy_(st.event_count, non_blocking=True)
                self._side.synchronize()
                c.counts = counts.numpy()
        return c.counts

    def _harvest(self, c: _Chunk, b: int, status: str = "ok") -> JobResult:
        ten = c.tenants[b]
        job = ten.job
        counts = self._counts(c)
        spikes = float(counts[0, b])
        events = float(counts[1, b])
        sim_s = job.n_steps * self.cfg.neuron.dt_ms * 1e-3
        rate = spikes / (self.cfg.n_neurons * sim_s)
        raster = ten.raster[:ten.done] if ten.raster is not None else None
        guard = None
        if self.cfg.guard.enabled:
            guard = integrity.guard_report(
                integrity.tenant_guard(c.state.guard, b))
        if status != "ok":
            # eviction: reclaim the slot (a quarantined tenant's state is
            # frozen poison, which insert_tenant overwrites whole, guard
            # leaves included, before the slot runs again)
            self._left[b] = 0
            self._chaos[b] = -1
            key = ("quarantined" if status == "quarantined"
                   else "deadline_evictions")
            self.stats[key] += 1
        if self._tenant[b] is ten:      # not yet taken by the next job
            self._tenant[b] = None
        self.stats["jobs_completed"] += 1
        return JobResult(job_id=job.job_id, seed=job.seed,
                         n_steps=job.n_steps, spikes=spikes,
                         events=events, rate_hz=rate, raster=raster,
                         status=status, guard=guard)

    def _may_run_ahead(self) -> bool:
        """Whether the next pack and chunk need nothing that only the
        delivery of the chunk in flight tells: no guard (a trip is known
        on the card alone) and no slot's job with a deadline (judged on
        the clock after the chunk)."""
        return not self.cfg.guard.enabled and all(
            ten is None or ten.deadline is None for ten in self._tenant)

    def drain(self) -> Iterator[JobResult]:
        """Run until the queue and every slot are empty, yielding each
        JobResult as its tenant completes (slots recycle in between).
        Chunk k is delivered once chunk k+1 is enqueued where
        :meth:`_may_run_ahead`, else before it (module docstring); jobs
        submitted while results are handed out are run too."""
        while True:
            busy = bool(self._queue) or bool((self._left > 0).any())
            if self._pending is not None and not (busy
                                                  and self._may_run_ahead()):
                done, self._pending = self._pending, None
                yield from self._deliver(done, overlapped=False)
                continue
            if not busy:
                return
            self._pack()
            done, self._pending = self._pending, self._enqueue()
            if done is not None:
                yield from self._deliver(done, overlapped=True)

    def run(self) -> list:
        """drain() collected into a list."""
        return list(self.drain())

    # ---- metrics -------------------------------------------------------

    def metrics_row(self) -> dict:
        """The service run so far, with the reference server's keys."""
        wall = max(self.stats["wall_s"], 1e-9)
        return {
            "mode": "serve",
            "source": "measured",
            "batch_size": self.slots,
            "impl": self.impl,
            "grid": f"{self.cfg.grid_h}x{self.cfg.grid_w}",
            "neurons": self.cfg.neurons_per_column,
            "chunk": self.chunk,
            "jobs_submitted": self.stats["jobs_submitted"],
            "jobs_completed": self.stats["jobs_completed"],
            "slot_recycles": self.stats["recycles"],
            "loop_steps": self.stats["loop_steps"],
            "tenant_steps": self.stats["tenant_steps"],
            "occupancy": (self.stats["tenant_steps"]
                          / max(1, self.stats["loop_steps"] * self.slots)),
            "wall_s": self.stats["wall_s"],
            "tenant_steps_per_s": self.stats["tenant_steps"] / wall,
            "guard": self.cfg.guard.enabled,
            "quarantined": self.stats["quarantined"],
            "deadline_evictions": self.stats["deadline_evictions"],
            "rejected_submits": self.stats["rejected_submits"],
        }


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------

def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="batched multi-tenant DPSNN simulation service "
                    "(synthesizes a staggered job mix)")
    ap.add_argument("--grid", default="4x4")
    ap.add_argument("--neurons", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4,
                    help="batch width B (concurrent tenants)")
    ap.add_argument("--chunk", type=int, default=16,
                    help="steps per chunk")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--steps", type=int, default=60,
                    help="base job duration (jobs stagger around it)")
    ap.add_argument("--stagger", type=int, default=7,
                    help="duration increment: job i runs steps + "
                         "(i %% 3) * stagger")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--impl", default="cuda_fused", choices=net.IMPLS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--stdp", action="store_true")
    ap.add_argument("--guard", action="store_true",
                    help="enable the per-tenant integrity guard "
                         "(poison-tenant quarantine; DESIGN.md "
                         "§Integrity)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound the request queue; submit() rejects "
                         "beyond it (0 = unbounded)")
    ap.add_argument("--poison-job", default="", metavar="I:STEP",
                    help="chaos: inject NaN into job I's membrane state "
                         "at its step STEP (requires --guard); the "
                         "tenant is quarantined, batch-mates unaffected")
    ap.add_argument("--json", default="",
                    help="append the metrics row to this file "
                         "('-' prints it to stdout)")
    return ap


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    gh, gw = (int(x) for x in args.grid.split("x"))
    cfg = dpsnn.reduced(gh, gw, args.neurons, seed=args.seed,
                        stdp=args.stdp)
    poison_job, poison_step = -1, -1
    if args.poison_job:
        try:
            poison_job, poison_step = (int(v)
                                       for v in args.poison_job.split(":"))
        except ValueError:
            raise SystemExit("--poison-job wants I:STEP (two integers)")
        if not args.guard:
            raise SystemExit("--poison-job requires --guard")
    if args.guard:
        cfg = dataclasses.replace(cfg, guard=GuardConfig(enabled=True))
    server = BatchedSimServer(cfg, slots=args.slots, chunk=args.chunk,
                              impl=args.impl, max_queue=args.max_queue,
                              device=args.device)
    for i in range(args.jobs):
        server.submit(SimJob(
            job_id=f"job{i}", seed=args.seed + i,
            n_steps=args.steps + (i % 3) * args.stagger,
            chaos_nan_at_step=poison_step if i == poison_job else -1))
    server.close()
    for r in server.drain():
        print(f"{r.job_id}: seed={r.seed} steps={r.n_steps} "
              f"status={r.status} "
              f"spikes={r.spikes:.0f} events={r.events:.0f} "
              f"rate={r.rate_hz:.2f}Hz "
              f"raster={r.raster.shape if r.raster is not None else None}"
              + (f" guard={r.guard['guard_trip_what']}"
                 f"@{r.guard['guard_trip_step']}"
                 if r.guard and r.guard["guard_tripped"] else ""))
    row = server.metrics_row()
    print(f"served {row['jobs_completed']}/{row['jobs_submitted']} jobs "
          f"on {row['batch_size']} slots ({row['slot_recycles']} "
          f"recycles), occupancy={row['occupancy']:.2f}, "
          f"{row['tenant_steps_per_s']:.0f} tenant-steps/s, "
          f"quarantined={row['quarantined']}")
    if args.json == "-":
        print(json.dumps(row, sort_keys=True))
    elif args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(row, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
