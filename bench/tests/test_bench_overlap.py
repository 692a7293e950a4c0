"""``serve.overlap.serve``, the share of ``serve.deliver`` spans that ran
with the next chunk already enqueued: 0 on spans without the
``overlapped`` attribute (a program that does not pipeline its chunks),
the share on hand-made spans, and on the real spans of a CPU server
recorded under a profile, every chunk but the last unguarded and none
under the guard."""
from __future__ import annotations

import dataclasses
import json

import pytest
from test_bench_spans import read, serve_trace, sim_run, span

from _tiny import common, config
from bench.harness import spans as hspans
from bench.harness import trace as tracing

NAME = "serve.overlap.serve"


@pytest.fixture
def program(tmp_path, monkeypatch):
    """Hands the reader ``spans`` as the program's, and a trace file
    with the base time of ``test_bench_spans.span``."""
    from test_bench_spans import BASE
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [],
                                "baseTimeNanoseconds": BASE}))
    monkeypatch.setattr(hspans, "TRACE_FILE", path)
    held = {"spans": []}
    monkeypatch.setattr(hspans, "program_spans", lambda: held["spans"])
    return held


def delivers(*overlapped):
    """One ``serve.deliver`` span a chunk of ``serve_trace``, with the
    attribute ``overlapped`` where it is not None."""
    out = []
    for k, o in enumerate(overlapped):
        attrs = {} if o is None else {"overlapped": o}
        out.append(span("serve.deliver", k * 10000.0 + 5000.0,
                        k * 10000.0 + 5500.0, 200 + k, 100 + k, **attrs))
    return out


def test_spans_without_the_attribute_read_zero(program):
    program["spans"] = delivers(None, None, None)
    assert read(NAME, sim_run(serve_trace(), kind="serve")) == 0.0


def test_the_share_of_overlapped_deliveries(program):
    run = sim_run(serve_trace(), kind="serve")
    program["spans"] = delivers(1, 1, 0)
    assert read(NAME, run) == pytest.approx(200.0 / 3)
    program["spans"] = delivers(1, None, 1) + [
        span("serve.deliver", -30000.0, -29000.0, 9, overlapped=0)]
    assert read(NAME, run) == pytest.approx(200.0 / 3)   # outside: not read
    program["spans"] = [span("serve.copy", 0.0, 9000.0, 2, bytes=4)]
    assert read(NAME, run) is None
    assert read(NAME, sim_run(serve_trace(), kind="sim")) is None
    assert read(NAME, sim_run(None, kind="serve")) is None


@pytest.mark.parametrize("guard", [False, True])
def test_a_cpu_servers_own_spans_read_back(tmp_path, monkeypatch, guard):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import GuardConfig
    from repro_torch.launch.serve import BatchedSimServer, SimJob
    from repro_torch.runtime import spans

    cfg = common.program_config(config(), 5, False)
    if guard:
        cfg = dataclasses.replace(cfg, guard=GuardConfig(enabled=True))
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
    chunks = server.stats["chunks"]
    want = 0.0 if guard else 100.0 * (chunks - 1) / chunks
    assert chunks == 3
    assert read(NAME, sim_run(tr, kind="serve")) == pytest.approx(want)
    spans.clear()
