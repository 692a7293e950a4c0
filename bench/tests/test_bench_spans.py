"""The readers of the program's spans (``bench/harness/spans.py``) on
hand-made traces, where the device's idle time inside the spans is known;
no reading without a trace, its base time, or spans; and the service's
real spans, recorded under a CPU profile, read back."""
from __future__ import annotations

import json
import sys
from types import SimpleNamespace as Run

import pytest

from _tiny import common, config
from bench.harness import spans as hspans
from bench.harness import trace as tracing

BASE = 1_700_000_000_000_000_000          # the trace's baseTimeNanoseconds
LOOP = ["loop.enqueue_us.sim", "loop.device_wait_us.sim"]
SERVE = ["serve.device_wait_us.serve", "serve.d2h_bytes.serve",
         "serve.queue_wait_ms.serve"]


def read(name, run):
    return common.metric_reader(name).read(run)


def span(name, start_us, end_us, id_=0, parent=None, **attrs):
    """A program span (``repro_torch.runtime.spans.Span``) whose times
    are ``start_us`` and ``end_us`` on the trace's clock."""
    from repro_torch.runtime.spans import Span
    return Span(name, BASE + int(start_us * 1e3), BASE + int(end_us * 1e3),
                id_, parent, attrs)


@pytest.fixture
def program(tmp_path, monkeypatch):
    """Hands the readers ``spans`` as the program's, and a trace file
    with ``BASE``."""
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [],
                                "baseTimeNanoseconds": BASE}))
    monkeypatch.setattr(hspans, "TRACE_FILE", path)
    held = {"spans": []}
    monkeypatch.setattr(hspans, "program_spans", lambda: held["spans"])
    return held


def sim_run(trace, kind="sim"):
    return Run(cfg=config(), mix={}, window={"kind": kind}, trace=trace)


def sim_trace(steps=4):
    """A step every 1,000 us; the device busy from 100 to 700 us of it."""
    ev = [("fused_step_kernel", i * 1000.0 + 100.0, 600.0)
          for i in range(steps)]
    return tracing.Trace(events=ev, window_s=steps * 1e-3,
                         extra={"steps": steps})


def test_loop_readers(program):
    st = [span("sim.step", i * 1000.0, i * 1000.0 + 900.0, 10 + i, 1)
          for i in range(4)]
    program["spans"] = st + [
        span("sim.run", 0.0, 3950.0, 1),
        span("step.kernel", 50.0, 120.0, 20, 10),
        span("serve.copy", 0.0, 4000.0, 30),        # not the loop's
        span("sim.step", -90000.0, -89000.0, 2),    # set-up's profile
    ]
    run = sim_run(sim_trace())
    assert read("loop.enqueue_us.sim", run) == pytest.approx(900.0)
    # gaps [700, 1100] x 3; sim.run covers [700, 1100], [1700, 2100]
    # and [2700, 2100 + 950 - 100]: the union's overlap 400 + 400 + 400
    assert read("loop.device_wait_us.sim", run) == pytest.approx(300.0)
    program["spans"] = st
    # the steps alone: [700, 900] + [1000, 1100] of each gap
    assert read("loop.device_wait_us.sim", run) == pytest.approx(225.0)
    for name in SERVE:
        assert read(name, run) is None


def serve_trace():
    """Three chunks of 4 loop steps, each 10,000 us; the device busy for
    the first 6,000 us of each."""
    ev = [("fused_step_kernel", k * 10000.0, 6000.0) for k in range(3)]
    return tracing.Trace(events=ev, window_s=0.03, extra={"steps": 12})


def test_service_readers(program):
    sp = []
    for k in range(3):
        t = k * 10000.0
        sp += [span("serve.chunk", t, t + 8000.0, 100 + k,
                    steps_taken=4, tenant_steps=10),
               span("serve.enqueue", t, t + 3000.0, 0, 100 + k),
               span("serve.copy", t + 5000.0, t + 7000.0, 0, 100 + k,
                    bytes=100),
               span("serve.deliver", t + 7000.0, t + 8000.0, 0, 100 + k),
               span("serve.pack", t + 9500.0, t + 10500.0, 0,
                    admitted=1)]
    sp += [span("serve.copy", -20000.0, -19000.0, bytes=999),
           span("serve.chunk", -20000.0, -18000.0, tenant_steps=7),
           span("serve.queue", -5000.0, 2000.0, job_id="a"),
           span("serve.queue", 1000.0, 10200.0, job_id="b"),
           span("serve.queue", -9000.0, -1000.0, job_id="early"),
           span("serve.queue", 27000.0, 30000.0, job_id="late")]
    program["spans"] = sp
    run = sim_run(serve_trace(), kind="serve")
    # each of the two gaps [6000, 10000]: copy 1000, deliver 1000, pack 500
    assert read("serve.device_wait_us.serve", run) == pytest.approx(
        2 * 2500.0 / 12)
    assert read("serve.d2h_bytes.serve", run) == pytest.approx(300 / 30)
    assert read("serve.queue_wait_ms.serve", run) == pytest.approx(
        (7.0 + 9.2) / 2)
    for name in LOOP:
        assert read(name, run) is None


def test_idle_inside_spans_is_an_intersection():
    tr = tracing.Trace(events=[("a", 0.0, 10.0), ("b", 5.0, 10.0),
                               ("c", 30.0, 5.0), ("d", 50.0, 10.0)],
                       window_s=1.0)
    # gaps [15, 30] and [35, 50]
    sp = [hspans.Span("x", 10.0, 20.0, 1, None, {}),
          hspans.Span("y", 18.0, 25.0, 2, None, {}),
          hspans.Span("z", 28.0, 60.0, 3, None, {})]
    assert hspans.device_idle_us(tr, sp) == pytest.approx(10.0 + 2.0 + 15.0)
    assert hspans.device_idle_us(tr, []) == 0.0


@pytest.mark.parametrize("name", LOOP + SERVE)
def test_no_reading_without_a_trace_or_spans(program, monkeypatch, name):
    kind = "sim" if name.startswith("loop.") else "serve"
    tr = sim_trace() if kind == "sim" else serve_trace()
    program["spans"] = [span("sim.step", 0.0, 900.0, 1),
                        span("serve.copy", 0.0, 9000.0, 2, bytes=4),
                        span("serve.chunk", 0.0, 9000.0, 3, tenant_steps=1),
                        span("serve.queue", 0.0, 500.0, job_id="j")]
    assert read(name, sim_run(tr, kind)) is not None
    assert read(name, sim_run(None, kind)) is None
    program["spans"] = []                     # a program with no spans
    assert read(name, sim_run(tr, kind)) is None
    program["spans"] = None
    assert read(name, sim_run(tr, kind)) is None


def test_no_reading_from_a_program_without_the_recorder(monkeypatch,
                                                        tmp_path):
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.spans", None)
    assert hspans.program_spans() is None
    monkeypatch.setattr(hspans, "TRACE_FILE", tmp_path / "none.json")
    assert hspans.base_time_ns() is None
    assert hspans.timeline(sim_run(sim_trace())) is None


def test_the_services_own_spans_read_back(tmp_path, monkeypatch):
    """A tiny server's real spans under a CPU profile, read on the
    profile's own clock with one device interval over the whole run:
    the bytes a tenant-step are the raster's and ``steps_left``'s, and
    each admitted job waited."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import BatchedSimServer, SimJob
    from repro_torch.runtime import spans

    cfg = common.program_config(config(), 5, False)
    server = BatchedSimServer(cfg, slots=2, chunk=4, device="cpu")
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i, steps in enumerate([6, 3, 5, 2]):
            server.submit(SimJob(job_id=f"j{i}", seed=i, n_steps=steps))
        list(server.drain())
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    monkeypatch.setattr(hspans, "TRACE_FILE", path)
    base = json.loads(path.read_text())["baseTimeNanoseconds"]
    rec = spans.recorded()
    lo = (min(s.start_ns for s in rec) - base) / 1e3
    hi = (max(s.end_ns for s in rec) - base) / 1e3
    tr = tracing.Trace(events=[("kernel", lo, hi - lo)], window_s=1.0,
                       extra={"steps": server.stats["loop_steps"]})
    run = sim_run(tr, kind="serve")
    b, c, n = 2, cfg.n_columns, cfg.neurons_per_column
    want = (server.stats["loop_steps"] * b * c * n
            + 4 * b * server.stats["chunks"]) / server.stats["tenant_steps"]
    assert read("serve.d2h_bytes.serve", run) == pytest.approx(want)
    assert read("serve.queue_wait_ms.serve", run) > 0
    assert read("serve.device_wait_us.serve", run) == 0.0    # never idle
    spans.clear()
