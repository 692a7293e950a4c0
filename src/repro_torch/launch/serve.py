"""Batched multi-tenant DPSNN simulation service (the port of
``repro/launch/serve.py``; DESIGN.md §Service).

The serving front end over the batched engine (``core/batched.py``): a
request queue packs jobs, each with its own seed, duration and stimulus
intensity, into the B slots of one batch, whose every loop step is one
launch of each kernel for all B tenants (``batched.run_chunk``).
Tenants that finish mid-chunk are frozen, and their slot is recycled for
the next queued job between chunks (``batched.insert_tenant``); each
job's spike raster streams back chunk by chunk through its ``on_chunk``
callback, one copy of the chunk's ``(steps, B, C, N)`` raster from the
card per chunk.

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

from repro_torch.configs import dpsnn
from repro_torch.configs.base import DPSNNConfig, GuardConfig
from repro_torch.core import batched
from repro_torch.core import network as net
from repro_torch.core import simulation as sim
from repro_torch.core.network import NetworkParams
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
        self._job: list = [None] * slots
        self._done: list = [0] * slots    # steps already run per slot
        self._frames: list = [[] for _ in range(slots)]
        self._chaos = np.full((slots,), -1, np.int32)
        self._deadline: list = [None] * slots   # absolute monotonic time
        self._bstate = batched.init_tenants(cfg, [0] * slots, where)
        self._queue: deque = deque()      # (job, perf_counter_ns at submit)
        self._used: list = [False] * slots
        self._closed = False
        self.stats = {"jobs_submitted": 0, "jobs_completed": 0,
                      "chunks": 0, "loop_steps": 0, "tenant_steps": 0,
                      "recycles": 0, "wall_s": 0.0, "quarantined": 0,
                      "deadline_evictions": 0, "rejected_submits": 0}

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
                self._job[b] = job
                self._done[b] = 0
                self._frames[b] = []
                self._chaos[b] = job.chaos_nan_at_step
                self._deadline[b] = (time.monotonic() + job.deadline_s
                                     if job.deadline_s > 0 else None)
                if self._used[b]:
                    self.stats["recycles"] += 1
                self._used[b] = True
                admitted += 1
            sp.set(admitted=admitted)

    # ---- the batch -----------------------------------------------------

    def _step_chunk(self) -> list:
        """One chunk; returns the JobResults it completed.

        Under ``cfg.guard.enabled`` a tenant whose guard trips is frozen
        in-band the same step, so its NaN never advances and batch-mates
        are untouched; here the host evicts it with
        ``status="quarantined"``. Deadline eviction reclaims slots whose
        job overstayed ``deadline_s``."""
        guarded = self.cfg.guard.enabled
        left_before = self._left.copy()
        with spans.span("serve.chunk") as chunk:
            t0 = time.perf_counter()
            out = batched.run_chunk(
                self.cfg, self._bparams, self._bstate, self._seeds,
                self._left, self.chunk, self.impl, self._nu,
                self._chaos if guarded else None)
            # one copy of the chunk's raster from the device, and the
            # slots' steps left (and their guards) read back
            with spans.span("serve.copy") as copy:
                raster = out.raster[:out.steps_taken].cpu().numpy()
                wall = time.perf_counter() - t0
                self._left = out.steps_left.cpu().numpy().copy()
                tripped = (out.state.guard.tripped.cpu().numpy()
                           if guarded else np.zeros((self.slots,), bool))
                copy.set(bytes=raster.nbytes + self._left.nbytes
                         + (tripped.nbytes if guarded else 0))
            self.stats["wall_s"] += wall
            self._bparams, self._bstate = out.params, out.state
            tenant_steps = int((left_before - self._left).sum())
            self.stats["chunks"] += 1
            self.stats["loop_steps"] += out.steps_taken
            self.stats["tenant_steps"] += tenant_steps
            chunk.set(steps_taken=out.steps_taken, tenant_steps=tenant_steps)
            with spans.span("serve.deliver"):
                return self._deliver(left_before, raster, tripped)

    def _deliver(self, left_before, raster, tripped) -> list:
        """Each slot's frames of the chunk to its job's ``on_chunk``, and
        the JobResults of the jobs that finished or were evicted."""
        now = time.monotonic()
        finished = []
        for b in range(self.slots):
            job = self._job[b]
            if job is None:
                continue
            took = int(left_before[b] - self._left[b])
            if took:
                frames = raster[:took, b]
                if job.on_chunk is not None:
                    job.on_chunk(job.job_id, self._done[b], frames)
                if self.keep_raster:
                    self._frames[b].append(frames)
                self._done[b] += took
            if tripped[b]:
                finished.append(self._harvest(b, status="quarantined"))
            elif self._left[b] == 0:
                finished.append(self._harvest(b))
            elif self._deadline[b] is not None and now > self._deadline[b]:
                finished.append(self._harvest(b, status="deadline"))
        return finished

    def _harvest(self, b: int, status: str = "ok") -> JobResult:
        job = self._job[b]
        spikes = float(self._bstate.spike_count[b])
        events = float(self._bstate.event_count[b])
        sim_s = job.n_steps * self.cfg.neuron.dt_ms * 1e-3
        rate = spikes / (self.cfg.n_neurons * sim_s)
        raster = (np.concatenate(self._frames[b], axis=0)
                  if self.keep_raster and self._frames[b] else None)
        guard = None
        if self.cfg.guard.enabled:
            guard = integrity.guard_report(
                integrity.tenant_guard(self._bstate.guard, b))
        if status != "ok":
            # eviction: reclaim the slot (a quarantined tenant's state is
            # frozen poison, which insert_tenant overwrites whole, guard
            # leaves included, before the slot runs again)
            self._left[b] = 0
            self._chaos[b] = -1
            key = ("quarantined" if status == "quarantined"
                   else "deadline_evictions")
            self.stats[key] += 1
        self._deadline[b] = None
        self._job[b] = None
        self._frames[b] = []
        self.stats["jobs_completed"] += 1
        return JobResult(job_id=job.job_id, seed=job.seed,
                         n_steps=job.n_steps, spikes=spikes,
                         events=events, rate_hz=rate, raster=raster,
                         status=status, guard=guard)

    def drain(self) -> Iterator[JobResult]:
        """Run until the queue and every slot are empty, yielding each
        JobResult as its tenant completes (slots recycle in between)."""
        while self._queue or (self._left > 0).any():
            self._pack()
            yield from self._step_chunk()

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
