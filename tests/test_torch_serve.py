"""The port's batched simulation service (``repro_torch.launch.serve``)
against the JAX reference's ``BatchedSimServer`` on the same jobs, one
case for each of the reference's single-shard service tests
(tests/test_batched_service.py, tests/test_integrity.py): slot recycling
under staggered durations, static and plastic; chunk streaming order;
poison-tenant quarantine with batch-mates untouched, and a clean recycle
of the quarantined slot; backpressure and ``close()``; deadline eviction;
poison without the guard refused; and the port's own refusal of a drive
rate of 10 or more. Then the command line on the CPU.

Both servers serve the reference's network (the port's server is handed
it, carried across with ``repro_torch.convert``) at ``reduced(4, 4,
32)``; each reference server runs once per module. Every JobResult
(status, spikes, events, rate, raster, guard report) and the metrics
row's counts are held to the reference's to the bit, and each port job
to the port's own dedicated run of its seed. On the CPU the kernels'
wrappers run their plain versions."""
import dataclasses
import json

import numpy as np
import pytest
import torch
from test_torch_batched import _pair, _params, dedicated

from repro.configs.base import GuardConfig as JGuard
from repro.core import simulation as jsim
from repro.launch import serve as jserve
from repro_torch.configs.base import GuardConfig
from repro_torch.core import network as net
from repro_torch.core import simulation as sim
from repro_torch.launch import serve
from repro_torch.launch.serve import BatchedSimServer, QueueFull, SimJob


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(stdp=False, guard=False):
    jcfg, cfg = _pair(stdp=stdp)
    if guard:
        jcfg = dataclasses.replace(jcfg, guard=JGuard(enabled=True))
        cfg = dataclasses.replace(cfg, guard=GuardConfig(enabled=True))
    return jcfg, cfg


def _jobs(job_cls, jobs):
    """``jobs`` as ``job_cls`` instances: tuples of (job_id, seed,
    n_steps, extra fields)."""
    return [job_cls(job_id=j, seed=s, n_steps=n, **kw)
            for j, s, n, kw in jobs]


def serve_both(jobs, *, stdp=False, guard=False, close=False, **kw):
    """The reference's server and the port's (on the reference's network,
    on the CPU), each given ``jobs`` and drained: ``(jax server, its
    results by id, port server, its results by id, port params)``."""
    jcfg, cfg = _configs(stdp, guard)
    jsrv = jserve.BatchedSimServer(jcfg, **kw)
    params = _params(jsim.build(jcfg)[0])
    srv = BatchedSimServer(cfg, impl="cuda_fused", device="cpu",
                           params=params, **kw)
    out = []
    for server, cls in ((jsrv, jserve.SimJob), (srv, SimJob)):
        for job in _jobs(cls, jobs):
            server.submit(job)
        if close:
            server.close()
        out += [server, {r.job_id: r for r in server.drain()}]
    return (*out, params)


COUNTS = ("jobs_submitted", "jobs_completed", "slot_recycles", "loop_steps",
          "tenant_steps", "occupancy", "quarantined", "deadline_evictions",
          "rejected_submits", "batch_size", "chunk", "grid", "neurons",
          "guard", "mode", "source")


def assert_results_equal(got, want):
    """Port JobResults against the reference's, every field to the bit."""
    assert set(got) == set(want)
    for jid, r in got.items():
        w = want[jid]
        for f in ("status", "seed", "n_steps", "spikes", "events",
                  "rate_hz", "guard"):
            assert getattr(r, f) == getattr(w, f), (jid, f)
        if w.raster is None:
            assert r.raster is None
        else:
            np.testing.assert_array_equal(r.raster, w.raster, err_msg=jid)


def assert_rows_equal(srv, jsrv):
    row, jrow = srv.metrics_row(), jsrv.metrics_row()
    assert set(row) == set(jrow)
    for key in COUNTS:
        assert row[key] == jrow[key], key


RECYCLE_JOBS = [("a", 42, 10, {}), ("b", 45, 17, {"nu_scale": 1.5}),
                ("c", 47, 6, {}), ("d", 51, 12, {})]


@pytest.mark.parametrize("stdp", [False, True])
def test_server_recycles_slots_under_staggered_durations(stdp):
    """More jobs than slots, staggered durations, one job at 1.5 times
    the drive rate: every result as the reference's, each job's totals
    and raster its dedicated run's, and the slots recycled."""
    jsrv, want, srv, got, params = serve_both(RECYCLE_JOBS, stdp=stdp,
                                              slots=2, chunk=8)
    assert_results_equal(got, want)
    assert_rows_equal(srv, jsrv)
    assert srv.stats["recycles"] >= 2
    cfg = srv.cfg
    for jid, seed, n, kw in RECYCLE_JOBS:
        ref = dedicated(cfg, params, seed, n, "cuda_fused",
                        nu_scale=kw.get("nu_scale"))
        r = got[jid]
        assert r.spikes == float(ref.state.spike_count), jid
        assert r.events == float(ref.state.event_count), jid
        assert r.raster.shape[0] == n and r.raster.sum() == r.spikes


def test_server_streams_chunks_in_order():
    """A 20-step job on the recycling test's server shape (2 slots, chunk
    8) streams its raster as (0, 8), (8, 8), (16, 4), frame for frame the
    reference's, and keeps none."""
    streamed = {"jax": [], "port": []}
    jobs = [("s", 42, 20, {})]
    jcfg, cfg = _configs()
    jsrv = jserve.BatchedSimServer(jcfg, slots=2, chunk=8, keep_raster=False)
    srv = BatchedSimServer(cfg, slots=2, chunk=8, keep_raster=False,
                           device="cpu", params=_params(jsim.build(jcfg)[0]))
    results = {}
    for name, server, cls in (("jax", jsrv, jserve.SimJob),
                              ("port", srv, SimJob)):
        [job] = _jobs(cls, jobs)
        job.on_chunk = lambda jid, t0, fr, name=name: streamed[name].append(
            (t0, fr.copy()))
        server.submit(job)
        [results[name]] = server.run()
    assert results["port"].raster is None      # keep_raster=False streams
    assert [(t0, fr.shape[0]) for t0, fr in streamed["port"]] == \
        [(0, 8), (8, 8), (16, 4)]
    assert len(streamed["jax"]) == 3
    for (t0, fr), (jt0, jfr) in zip(streamed["port"], streamed["jax"]):
        assert t0 == jt0
        np.testing.assert_array_equal(fr, jfr)
    assert results["port"].spikes == results["jax"].spikes


POISON_JOBS = [(f"j{i}", 100 + i, 24, {}) for i in range(4)]


def test_poison_tenant_quarantined_batch_mates_bitwise():
    """B = 4, job 2 poisoned with NaN at its step 9: quarantined the same
    step (guard report, a raster of 10 rows) as in the reference, and its
    batch-mates bitwise what a server without the poison gives."""
    poisoned = list(POISON_JOBS)
    poisoned[2] = ("j2", 102, 24, {"chaos_nan_at_step": 9})
    _, clean, _, clean_port, _ = serve_both(POISON_JOBS, guard=True,
                                            close=True, slots=4, chunk=8)
    jsrv, want, srv, got, _ = serve_both(poisoned, guard=True, close=True,
                                         slots=4, chunk=8)
    assert_results_equal(got, want)
    assert_rows_equal(srv, jsrv)
    assert_results_equal(clean_port, clean)
    bad = got["j2"]
    assert bad.status == "quarantined"
    assert bad.guard["guard_tripped"]
    assert bad.guard["guard_trip_what"] == "nan"
    assert bad.guard["guard_trip_step"] == 9
    assert bad.raster.shape[0] == 10
    assert srv.metrics_row()["quarantined"] == 1
    for jid in ("j0", "j1", "j3"):
        assert got[jid].status == "ok"
        assert got[jid].spikes == clean_port[jid].spikes
        assert got[jid].events == clean_port[jid].events
        np.testing.assert_array_equal(got[jid].raster, clean_port[jid].raster)


def test_quarantined_slot_recycles_clean():
    """A queued job taking over a quarantined slot (the poison test's
    server shape: 4 slots, chunk 8) starts from fresh state: its result
    is the reference's, and the same job's on a server that never saw
    the poison."""
    jobs = [("bad", 7, 30, {"chaos_nan_at_step": 3})] + [
        (f"busy{i}", 20 + i, 30, {}) for i in range(3)] + [
        ("succ", 8, 20, {})]
    jsrv, want, srv, got, params = serve_both(jobs, guard=True, slots=4,
                                              chunk=8)
    assert_results_equal(got, want)
    assert got["bad"].status == "quarantined"
    assert got["succ"].status == "ok"
    assert srv.stats["recycles"] == 1
    ref = BatchedSimServer(srv.cfg, slots=1, chunk=8, device="cpu",
                           params=params)
    ref.submit(SimJob(job_id="succ", seed=8, n_steps=20))
    [alone] = ref.run()
    assert got["succ"].spikes == alone.spikes
    np.testing.assert_array_equal(got["succ"].raster, alone.raster)


def test_submit_backpressure_and_close():
    _, cfg = _configs()
    server = BatchedSimServer(cfg, slots=2, chunk=8, max_queue=2,
                              device="cpu")
    server.submit(SimJob(job_id="a", seed=1, n_steps=5))
    server.submit(SimJob(job_id="b", seed=2, n_steps=5))
    with pytest.raises(QueueFull):
        server.submit(SimJob(job_id="c", seed=3, n_steps=5))
    assert server.metrics_row()["rejected_submits"] == 1
    server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(SimJob(job_id="d", seed=4, n_steps=5))
    # graceful drain: everything accepted before close still completes,
    # as on the reference's server with the same jobs
    results = {r.job_id: r for r in server.drain()}
    _, want, _, got, _ = serve_both([("a", 1, 5, {}), ("b", 2, 5, {})],
                                    close=True, slots=2, chunk=8)
    assert set(results) == {"a", "b"}
    assert all(r.status == "ok" for r in results.values())
    assert_results_equal(got, want)
    for jid in ("a", "b"):
        assert results[jid].spikes == got[jid].spikes


def test_deadline_eviction():
    jobs = [("slow", 1, 10_000, {"deadline_s": 1e-6}), ("fast", 2, 8, {})]
    jsrv, want, srv, got, _ = serve_both(jobs, slots=2, chunk=8)
    assert got["slow"].status == "deadline"
    assert got["fast"].status == "ok"
    assert srv.metrics_row()["deadline_evictions"] == 1
    assert got["slow"].raster.shape[0] == 8     # evicted after one chunk
    assert_results_equal(got, want)
    assert_rows_equal(srv, jsrv)


def test_poison_requires_guard():
    _, cfg = _configs()
    server = BatchedSimServer(cfg, slots=2, chunk=4, device="cpu")
    with pytest.raises(ValueError, match="guard"):
        server.submit(SimJob(job_id="x", seed=1, n_steps=5,
                             chaos_nan_at_step=2))


def test_rate_ten_or_more_is_refused_at_submit():
    """``nu_scale`` that lifts the drive rate to 10 or more per step
    (6.17 at the default 1.62) is refused when submitted, not run on a
    branch the drive does not port."""
    _, cfg = _configs()
    server = BatchedSimServer(cfg, slots=1, chunk=4, device="cpu")
    limit = 10.0 / net.drive_rate(cfg)
    assert 6.1 < limit < 6.2
    with pytest.raises(NotImplementedError, match="Knuth"):
        server.submit(SimJob(job_id="x", seed=1, n_steps=5,
                             nu_scale=6.2))
    server.submit(SimJob(job_id="y", seed=1, n_steps=5, nu_scale=6.1))
    assert server.stats["jobs_submitted"] == 1


def test_server_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the raise is for a host "
                    "without one")
    _, cfg = _configs()
    with pytest.raises(RuntimeError, match="cuda"):
        BatchedSimServer(cfg, slots=1)


def test_server_params_must_lie_on_its_device():
    """A network handed to the server runs where it lies, so one that
    lies elsewhere than ``device`` is refused, not moved."""
    _, cfg = _configs()
    params, _ = sim.build(cfg, device="cpu")
    with pytest.raises(ValueError, match="params lie on cpu"):
        BatchedSimServer(cfg, slots=1, device="meta", params=params)
    assert BatchedSimServer(cfg, slots=1, device="cpu",
                            params=params).params is params


def test_cli_serves_a_staggered_mix_on_the_cpu(capsys):
    """The command line with the reference's flags (its ``--impl``
    choices the port's): a staggered mix on 2 slots, every job ok, the
    metrics row with the reference's keys."""
    rc = serve.main(["--grid", "4x4", "--neurons", "32", "--slots", "2",
                     "--jobs", "3", "--steps", "6", "--chunk", "4",
                     "--device", "cpu", "--impl", "cuda", "--json", "-"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert sum("status=ok" in line for line in out) == 3
    row = json.loads(out[-1])
    assert set(row) == set(jserve.BatchedSimServer(
        _configs()[0], slots=1).metrics_row())
    assert row["jobs_completed"] == 3 and row["impl"] == "cuda"
    with pytest.raises(SystemExit):
        serve.main(["--poison-job", "0:3", "--device", "cpu"])


def _port_server(cfg, **kw):
    """A port server on the CPU over the port's own network."""
    params, _ = sim.build(cfg, device="cpu")
    return BatchedSimServer(cfg, device="cpu", params=params, **kw), params


def assert_dedicated(cfg, params, job, r):
    """JobResult ``r`` against the port's dedicated run of ``job``: its
    totals, and its spikes a step through the run's ``rate_trace``."""
    one = dedicated(cfg, params, job.seed, job.n_steps, "cuda_fused",
                    nu_scale=job.nu_scale)
    assert (r.status, r.spikes, r.events) == (
        "ok", float(one.state.spike_count), float(one.state.event_count))
    f32 = torch.float32
    per_step = (torch.tensor(sim._recip(cfg.n_neurons), dtype=f32)
                * torch.tensor(sim._recip(cfg.neuron.dt_ms * 1e-3),
                               dtype=f32))
    counts = torch.from_numpy(r.raster).sum((1, 2)).to(f32)
    assert torch.equal(counts * per_step, one.rate_trace), job.job_id


def test_pipeline_runs_a_chunk_ahead_and_keeps_every_frame():
    """Unguarded, every job submitted before ``drain``: each chunk but
    the last is delivered once the next is enqueued. A client that keeps
    every ``frames`` array it is handed finds them, after the drain,
    equal to the ``keep_raster`` raster of the same jobs (no buffer was
    reused under them), and each job is its dedicated run."""
    _, cfg = _configs()
    srv, params = _port_server(cfg, slots=2, chunk=8)
    kept = {}
    jobs = _jobs(SimJob, RECYCLE_JOBS)
    for job in jobs:
        job.on_chunk = lambda jid, t0, fr: kept.setdefault(jid, []).append(
            (t0, fr))
        srv.submit(job)
    results = {r.job_id: r for r in srv.drain()}
    assert srv.stats["chunks"] > 2
    assert srv.stats["chunks_overlapped"] == srv.stats["chunks"] - 1
    assert "chunks_overlapped" not in srv.metrics_row()
    for job in jobs:
        r = results[job.job_id]
        starts = [t0 for t0, _ in kept[job.job_id]]
        assert starts == list(range(0, job.n_steps, 8))
        np.testing.assert_array_equal(
            np.concatenate([fr for _, fr in kept[job.job_id]]), r.raster)
        assert_dedicated(cfg, params, job, r)


@pytest.mark.parametrize("case", ["guard", "deadline"])
def test_pipeline_waits_where_the_next_pack_needs_the_chunk(case):
    """Under the guard (a trip is known on the card alone), or with a
    slot's job under a ``deadline_s`` (judged on the clock after the
    chunk), each chunk is delivered before the next is enqueued, and the
    results are those of the unguarded pipeline."""
    _, cfg = _configs(guard=case == "guard")
    srv, _ = _port_server(cfg, slots=2, chunk=8)
    ahead, _ = _port_server(_configs()[1], slots=2, chunk=8)
    extra = {"deadline_s": 1e6} if case == "deadline" else {}
    for server, kw in ((srv, extra), (ahead, {})):
        for job in _jobs(SimJob, [(j, s, n, dict(k, **kw))
                                  for j, s, n, k in RECYCLE_JOBS]):
            server.submit(job)
    got = {r.job_id: r for r in srv.drain()}
    want = {r.job_id: r for r in ahead.drain()}
    assert srv.stats["chunks_overlapped"] == 0
    assert ahead.stats["chunks_overlapped"] == ahead.stats["chunks"] - 1
    for jid, r in want.items():
        g = got[jid]
        assert (g.status, g.spikes, g.events) == (r.status, r.spikes,
                                                  r.events)
        np.testing.assert_array_equal(g.raster, r.raster)


def test_closed_loop_submits_from_the_drain_loop():
    """Clients that submit their next job as each result comes back out
    of ``drain()``, as the benchmark's closed loop does: every job runs,
    those submitted while the last chunk in flight is handed out too
    (the first two jobs end in one chunk, leaving no work queued), the
    pipeline engages, and each job is its dedicated run."""
    _, cfg = _configs()
    srv, params = _port_server(cfg, slots=2, chunk=8)
    feed = iter(_jobs(SimJob, [(f"k{i}", 60 + i, n, {"nu_scale": nu})
                               for i, (n, nu) in enumerate(
                                   [(8, 1.0), (8, 1.5), (9, 0.8), (20, 1.0),
                                    (3, 1.25), (11, 1.0)])]))
    jobs = {}
    for job in (next(feed), next(feed)):
        jobs[job.job_id] = job
        srv.submit(job)
    results = {}
    for r in srv.drain():
        results[r.job_id] = r
        job = next(feed, None)
        if job is not None:
            jobs[job.job_id] = job
            srv.submit(job)
    assert set(results) == set(jobs) and len(jobs) == 6
    assert srv.stats["chunks_overlapped"] > 0
    for jid, job in jobs.items():
        assert_dedicated(cfg, params, job, results[jid])


def test_counters_count_delivered_chunks_and_kept_rasters_own_memory():
    """While the pipeline runs a chunk ahead, ``stats`` count only the
    chunks handed out: at every result out of ``drain()`` the tenant-
    steps counted are the frames the clients got. A ``keep_raster``
    raster is a copy, so it holds no chunk's block alive, and equals the
    frames streamed."""
    _, cfg = _configs()
    srv, _ = _port_server(cfg, slots=2, chunk=8)
    streamed = {}
    for job in _jobs(SimJob, RECYCLE_JOBS):
        job.on_chunk = lambda jid, t0, fr: streamed.setdefault(
            jid, []).append(fr)
        srv.submit(job)
    for r in srv.drain():
        seen = sum(len(fr) for frs in streamed.values() for fr in frs)
        assert srv.stats["tenant_steps"] == seen
        frames = streamed[r.job_id]
        assert not any(np.shares_memory(r.raster, fr) for fr in frames)
        np.testing.assert_array_equal(np.concatenate(frames), r.raster)
    assert srv.stats["chunks_overlapped"] == srv.stats["chunks"] - 1
