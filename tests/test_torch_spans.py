"""The port's span recorder (``repro_torch.runtime.spans``) on the CPU:
off unless a ``torch.profiler`` session runs; on, nested spans with their
parents and attributes, on the clock of the profiler's Chrome trace; the
spans of the simulation loop and of the batched service, and runs that
are bit-identical with the profiler on and off."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import dpsnn
from repro_torch.core import simulation as sim
from repro_torch.launch.serve import BatchedSimServer, SimJob
from repro_torch.runtime import spans


@pytest.fixture(autouse=True)
def fresh():
    """No spans of another test, and one intra-op thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.clear()
    yield
    spans.clear()
    torch.set_num_threads(before)


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing():
    s = spans.span("a", bytes=3)
    assert s is spans.OFF
    with s as inner:
        inner.set(bytes=4)
    spans.emit("b", 0, job_id="j")
    assert spans.recorded() == []
    assert spans.span("c") is spans.span("d")


def test_on_nests_with_parents_and_attributes():
    with profiled():
        with spans.span("outer", n=2) as o:
            with spans.span("inner", bytes=8):
                pass
            with spans.span("inner2"):
                pass
            o.set(done=1)
        spans.emit("queued", spans._clock() - 1000, job_id="j7")
    by = {s.name: s for s in spans.recorded()}
    assert set(by) == {"outer", "inner", "inner2", "queued"}
    assert by["outer"].parent is None
    assert by["inner"].parent == by["outer"].id
    assert by["inner2"].parent == by["outer"].id
    assert by["outer"].attrs == {"n": 2, "done": 1}
    assert by["inner"].attrs == {"bytes": 8}
    assert by["queued"].attrs == {"job_id": "j7"} and by["queued"].parent \
        is None
    assert by["queued"].end_ns - by["queued"].start_ns >= 1000
    o, i = by["outer"], by["inner"]
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    assert spans.MAX_SPANS == 2 ** 20 == spans._spans.maxlen


def test_spans_share_the_chrome_trace_clock(tmp_path):
    """After mapping through the trace's ``baseTimeNanoseconds``, a span
    lands within 1 ms of a ``record_function`` around the same code."""
    with profiled() as prof:
        with record_function("warm"):
            pass
        for i in range(3):
            with record_function(f"rf{i}"), spans.span(f"s{i}"):
                torch.ones(64).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    base = data["baseTimeNanoseconds"]
    by = {s.name: s for s in spans.recorded()}
    for i in range(3):
        rf = next(e for e in data["traceEvents"]
                  if e.get("name") == f"rf{i}" and e.get("ph") == "X")
        s = by[f"s{i}"]
        assert abs((s.start_ns - base) / 1e3 - rf["ts"]) < 1000
        assert abs((s.end_ns - base) / 1e3 - (rf["ts"] + rf["dur"])) < 1000


def tiny(stdp=False):
    return dpsnn.reduced(4, 4, 48, seed=3, stdp=stdp)


@pytest.mark.parametrize("stdp", [False, True], ids=["static", "plastic"])
def test_simulation_run_spans(stdp):
    cfg = tiny(stdp)
    params, state = sim.build(cfg, device="cpu")
    n = 4
    plain = sim.run(cfg, params, state, n, impl="cuda_fused")
    assert spans.recorded() == []
    with profiled():
        traced = sim.run(cfg, params, state, n, impl="cuda_fused")
    rec = spans.recorded()
    runs = [s for s in rec if s.name == "sim.run"]
    assert len(runs) == 1 and runs[0].attrs == {"n_steps": n}
    steps = [s for s in rec if s.name == "sim.step"]
    assert len(steps) == n and all(s.parent == runs[0].id for s in steps)
    want = ["step.table", "step.drive", "step.kernel", "step.post"]
    if stdp:
        want.append("plasticity.update")
    for st in steps:
        kids = sorted((s for s in rec if s.parent == st.id),
                      key=lambda s: s.start_ns)
        assert [s.name for s in kids] == want
        assert all(st.start_ns <= k.start_ns <= k.end_ns <= st.end_ns
                   for k in kids)
    assert len(rec) == 1 + n * (1 + len(want))
    assert_same(plain, traced)


def assert_same(a, b):
    """Two NamedTuple trees to the bit."""
    if isinstance(a, tuple):
        assert type(a) is type(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif a is None:
        assert b is None
    else:
        assert torch.equal(a, b) and a.dtype == b.dtype


JOBS = [("a", 11, 13), ("b", 12, 5), ("c", 13, 9), ("d", 14, 7),
        ("e", 15, 4)]


def serve_jobs(cfg):
    server = BatchedSimServer(cfg, slots=2, chunk=4, impl="cuda_fused",
                              device="cpu")
    for jid, seed, steps in JOBS:
        server.submit(SimJob(job_id=jid, seed=seed, n_steps=steps))
    return server, {r.job_id: r for r in server.drain()}


def test_service_spans():
    cfg = tiny()
    _, plain = serve_jobs(cfg)
    assert spans.recorded() == []
    with profiled():
        server, traced = serve_jobs(cfg)
    rec = spans.recorded()
    queued = [s for s in rec if s.name == "serve.queue"]
    assert sorted(s.attrs["job_id"] for s in queued) == sorted(
        j for j, _, _ in JOBS)
    packs = [s for s in rec if s.name == "serve.pack"]
    assert sum(s.attrs["admitted"] for s in packs) == len(JOBS)
    chunks = [s for s in rec if s.name == "serve.chunk"]
    assert len(chunks) == server.stats["chunks"]
    assert sum(s.attrs["steps_taken"] for s in chunks) == \
        server.stats["loop_steps"]
    assert sum(s.attrs["tenant_steps"] for s in chunks) == \
        server.stats["tenant_steps"] == sum(n for _, _, n in JOBS)
    b, c, n = server.slots, cfg.n_columns, cfg.neurons_per_column
    ids = {s.id: s for s in chunks}
    for name in ("serve.enqueue", "serve.copy", "serve.deliver"):
        kids = [s for s in rec if s.name == name]
        assert len(kids) == len(chunks)
        assert all(s.parent in ids for s in kids)
    for cp in (s for s in rec if s.name == "serve.copy"):
        taken = ids[cp.parent].attrs["steps_taken"]
        assert cp.attrs["bytes"] == taken * b * c * n + 4 * b
    assert set(plain) == set(traced)
    for jid, r in plain.items():
        t = traced[jid]
        assert (r.status, r.spikes, r.events) == (t.status, t.spikes,
                                                  t.events)
        np.testing.assert_array_equal(r.raster, t.raster)
