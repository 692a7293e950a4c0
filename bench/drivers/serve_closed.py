"""A closed loop of clients on the batched simulation service: the
traffic of the ``serve`` mixes.

Set-up builds a ``BatchedSimServer`` (the network of ``--seed`` on the
card) and drains one job a slot, of the mix's warm-up length, through
it. The window opens with every client submitting a job; each client
submits its next job when its last one returns, until the window's time
is up. Jobs come from one pool of lengths, log-uniform between the mix's
bounds, and drive scales, the same pool for every seed in another order
(:func:`jobs`); a job's seed comes from ``--seed`` and its index. Each
job streams its raster with ``keep_raster=False`` into an ``on_chunk``
that reduces each frame to its spike count, as a sweep's analysis
would. After the window closes the jobs still in flight are drained
(no new ones come), so every job submitted in the window has its time
from ``submit`` to its ``JobResult``.

A traced run profiles the loop steps between the first job that returns
after a third of the window and the first that returns once the mix's
``traced_loop_steps`` have run.

What decides ``correct`` (:func:`judge`): every job must come back
``ok``; a sample of the completed jobs drawn from the seed, the longest
among them, is run again by the reference as its dedicated run (the
network of ``--seed``, the job's seed and drive scale), and each step's
spike count and the job's spike and event totals must equal it to the
bit.
"""
from __future__ import annotations

import math
import random
import time

import numpy as np
import torch

from bench.harness import common
from bench.reference import dpsnn as ref


def job_seed(seed: int, index: int) -> int:
    """Job ``index``'s seed: an int32 drawn from the run's seed."""
    return (seed * 1_000_003 + 7919 * index + 1) % (2 ** 31 - 1)


def jobs(mix: dict, seed: int):
    """The jobs in submission order, an endless iterator of
    ``(index, n_steps, nu_scale, seed)``: the pool of ``pool`` lengths
    at the quantiles of the log-uniform law between ``steps_min`` and
    ``steps_max``, each with a drive scale from the mix's list in turn,
    shuffled by the seed; the pool again, reshuffled, when it runs out."""
    lo, hi, p = mix["steps_min"], mix["steps_max"], mix["pool"]
    scales = mix["nu_scales"]
    pool = [(round(lo * (hi / lo) ** ((i + 0.5) / p)), scales[i % len(scales)])
            for i in range(p)]
    rng = random.Random(seed)
    i = 0
    while True:
        order = pool[:]
        rng.shuffle(order)
        for steps, nu in order:
            yield i, steps, nu, job_seed(seed, i)
            i += 1


class Cell:
    def __init__(self, *, cfg: dict, mix: dict, seed: int, device,
                 tracer=None):
        from repro_torch.launch import serve
        self.serve = serve
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, device
        self.pcfg = common.program_config(cfg, seed, bool(mix["stdp"]))
        self.tracer = tracer
        self.trace = None
        self.counts: dict = {}     # job id -> per-step spike counts
        self.spikes_seen = 0       # spikes of every frame reduced so far

    def _on_chunk(self, job_id, t0, frames):
        c = np.count_nonzero(frames.reshape(frames.shape[0], -1), axis=1)
        self.counts.setdefault(job_id, []).append(c)
        self.spikes_seen += int(c.sum())

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def setup(self) -> None:
        m = self.mix
        self.server = self.serve.BatchedSimServer(
            self.pcfg, slots=m["slots"], chunk=m["chunk"], impl=m["impl"],
            keep_raster=False, device=self.dev)
        for b in range(m["slots"]):
            self.server.submit(self.serve.SimJob(
                job_id=f"warm{b}", seed=job_seed(self.seed, -1 - b),
                n_steps=m["warmup_steps"], nu_scale=m["nu_scales"][b % len(
                    m["nu_scales"])], on_chunk=self._on_chunk))
        for _ in self.server.drain():
            pass
        if self.tracer is not None:          # the profiler's own start-up
            self.tracer.start()
            self.tracer.stop()
        self._sync()
        self.counts.clear()

    def window(self, seconds: float) -> dict:
        m, server = self.mix, self.server
        feed = jobs(m, self.seed)
        self.meta: dict = {}        # job id -> (n_steps, nu_scale, seed)
        submitted, finished, results = {}, {}, {}

        def submit(now):
            i, steps, nu, s = next(feed)
            jid = f"job{i}"
            self.meta[jid] = (steps, nu, s)
            submitted[jid] = now
            server.submit(self.serve.SimJob(job_id=jid, seed=s,
                                            n_steps=steps, nu_scale=nu,
                                            on_chunk=self._on_chunk))

        t0 = time.perf_counter()
        st0 = dict(server.stats)
        for _ in range(m["clients"]):
            submit(t0)
        trace_from = t0 + seconds / 3
        tracing, lsteps0, spikes0 = False, 0, 0
        close = None
        st1 = None

        def stop_trace():
            self.trace = self.tracer.stop(
                steps=server.stats["loop_steps"] - lsteps0,
                spikes=self.spikes_seen - spikes0, tenants=m["slots"],
                stdp=bool(m["stdp"]))

        for res in server.drain():
            now = time.perf_counter()
            finished[res.job_id] = now
            results[res.job_id] = res
            if self.tracer is not None and self.trace is None:
                if not tracing and now >= trace_from:
                    self.tracer.start()
                    tracing = True
                    lsteps0 = server.stats["loop_steps"]
                    spikes0 = self.spikes_seen
                elif tracing and (server.stats["loop_steps"] - lsteps0
                                  >= m["traced_loop_steps"]):
                    stop_trace()
                    tracing = False
            if close is None:
                if now - t0 < seconds:
                    submit(now)
                else:
                    close = now
                    st1 = dict(server.stats)
        if tracing:
            stop_trace()
        if close is None:                   # every job ended in the window
            close = time.perf_counter()
            st1 = dict(server.stats)
        self.results = results
        lat = [finished.get(j, math.inf) - s for j, s in submitted.items()]
        return {"kind": "serve", "wall_s": close - t0,
                "tenant_steps": st1["tenant_steps"] - st0["tenant_steps"],
                "loop_steps": st1["loop_steps"] - st0["loop_steps"],
                "slots": m["slots"], "latencies_s": lat,
                "jobs_submitted": len(submitted)}

    def release(self) -> dict:
        out = {"results": {}, "meta": self.meta}
        for jid, r in self.results.items():
            c = self.counts.get(jid, [])
            out["results"][jid] = dict(
                status=r.status, spikes=r.spikes, events=r.events,
                counts=np.concatenate(c) if c else np.zeros(0, np.int64))
        self.server = self.results = None
        return out


def sample(outputs: dict, seed: int, k: int) -> list:
    """``k`` of the completed jobs drawn from the seed, the longest among
    them."""
    done = sorted(j for j, r in outputs["results"].items()
                  if r["status"] == "ok")
    if not done:
        return []
    longest = max(done, key=lambda j: (outputs["meta"][j][0], j))
    rest = [j for j in done if j != longest]
    rng = random.Random(seed ^ 0x5EED)
    return [longest] + rng.sample(rest, min(k - 1, len(rest)))


def dedicated(cfg: dict, net, seed: int, nu: float, steps: int, device,
              order: str):
    """The reference's dedicated run of one job: per-step spike counts,
    and the spike and event totals."""
    sim = ref.Sim(cfg, net, stdp=False, order=order, seed=seed,
                  nu_scale=nu)
    rs = ref.init_state(cfg, seed, device, False)
    counts = []
    sim.advance(rs, steps, on_step=lambda spikes: counts.append(spikes.sum()))
    return (torch.stack(counts).to(torch.int64).cpu().numpy(),
            float(rs.spike_count), float(rs.event_count))


def judge(cfg: dict, mix: dict, seed: int, outputs: dict, device,
          order: str):
    """``({name: (value, limit)}, failed, detail)``: ``failed`` counts
    the jobs that did not come back ``ok`` and the sampled jobs that
    differ from their dedicated run."""
    res = outputs["results"]
    not_ok = sum(1 for r in res.values() if r["status"] != "ok")
    missing = sum(1 for j in outputs["meta"] if j not in res)
    net = ref.build(cfg, seed, device)
    bad = 0
    detail = {}
    for jid in sample(outputs, seed, mix["checked_jobs"]):
        steps, nu, s = outputs["meta"][jid]
        counts, spikes, events = dedicated(cfg, net, s, nu, steps, device,
                                           order)
        got = res[jid]
        n = (common.mismatches(torch.as_tensor(got["counts"]),
                               torch.as_tensor(counts))
             + int(got["spikes"] != spikes) + int(got["events"] != events))
        detail[jid] = n
        bad += n
    checks = {"jobs_not_ok": (not_ok + missing, 0),
              "job_mismatches": (bad, 0)}
    return checks, not_ok + missing + sum(n > 0 for n in detail.values()), \
        detail


def control_outputs(cfg: dict, mix: dict, seed: int, device, order: str,
                    weight_dtype=torch.bfloat16) -> dict:
    """The control's outputs: the reference in the program's place, its
    weights held in ``weight_dtype``, over the mix's first
    ``checked_jobs`` jobs, each its dedicated run."""
    net = ref.build(cfg, seed, device)
    net.w_local = net.w_local.to(weight_dtype).float()
    net.rem_w = net.rem_w.to(weight_dtype).float()
    out = {"results": {}, "meta": {}}
    feed = jobs(mix, seed)
    for _ in range(mix["checked_jobs"]):
        i, steps, nu, s = next(feed)
        jid = f"job{i}"
        counts, spikes, events = dedicated(cfg, net, s, nu, steps, device,
                                           order)
        out["meta"][jid] = (steps, nu, s)
        out["results"][jid] = dict(status="ok", spikes=spikes,
                                   events=events, counts=counts)
    return out
