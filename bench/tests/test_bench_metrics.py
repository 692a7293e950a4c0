"""The metric readers on hand-made runs: the tail with jobs in flight,
the idle share as a union of intervals, the trace's breakdown, and no
reading where there is nothing to read."""
from __future__ import annotations

import json
import math
from types import SimpleNamespace as Run

import pytest

from _tiny import ROOT, common
from bench.harness import trace as tracing

SP = common.spec(ROOT)
NAMES = [m["name"] for m in SP["end_to_end"] + SP["per_layer"]]
FUSED = "void (anonymous namespace)::fused_step_kernel<true, false, false, false>(float const*)"
DRIVE = "void keyed_drive_kernel<false>(int const*)"
CAT = "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, unsigned int, 3, 64, 64>(float*)"
DENSE = "void (anonymous namespace)::stdp_dense_update_kernel(float const*)"



def cfg24():
    return common.load_json(ROOT / "bench" / "configs" / "dpsnn-24x24.json")


def sim_run(trace=None, **window):
    w = dict(kind="sim", wall_s=10.0, sim_steps=10000, segments=10,
             dt_ms=1.0)
    w.update(window)
    return Run(cfg=cfg24(), mix={"stdp": False}, setup_s=12.5,
               memory_peak_bytes=13_000_000_000, synapses=1_270_632_960,
               window=w, trace=trace, peaks=common.peaks())


def serve_run(latencies, trace=None):
    w = dict(kind="serve", wall_s=50.0, tenant_steps=40000, loop_steps=6000,
             slots=8, latencies_s=latencies, jobs_submitted=len(latencies))
    return Run(cfg=cfg24(), mix={"nu_scales": [0.8, 1.0, 1.25, 1.5]},
               setup_s=15.0, memory_peak_bytes=13_000_000_000,
               synapses=1_270_632_960, window=w, trace=trace,
               peaks=common.peaks())


def read(name, run):
    return common.metric_reader(name).read(run)


@pytest.mark.parametrize("name", NAMES)
def test_every_metric_has_a_reader_that_reads_nothing_from_nothing(name):
    run = sim_run(sim_steps=0) if name != "setup_s" else sim_run()
    run.memory_peak_bytes = 0
    run.window["kind"] = "other"
    value = read(name, run)
    assert value is None or name == "setup_s"


def test_end_to_end_readers():
    run = sim_run()
    assert read("realtime_factor", run) == pytest.approx(1.0)
    assert read("bytes_per_synapse", run) == pytest.approx(
        13e9 / 1_270_632_960)
    assert read("setup_s", run) == 12.5
    assert read("tenant_steps_per_s", run) is None
    s = serve_run([1.0] * 10)
    assert read("tenant_steps_per_s", s) == pytest.approx(800.0)
    assert read("realtime_factor", s) is None


def test_tail_counts_every_job_and_the_slowest():
    lat = [0.5] * 190 + [2.0] * 9 + [30.0]
    assert read("job_p95_s", serve_run(lat)) == 0.5
    lat = [0.5] * 180 + [2.0] * 20
    assert read("job_p95_s", serve_run(lat)) == 2.0
    assert common.percentile([math.inf, 1.0], 95) == math.inf


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert common.percentile(xs, 95) == 95
    assert common.percentile(xs, 100) == 100
    assert common.percentile([3.0], 95) == 3.0


def test_busy_time_is_the_union_of_intervals():
    ev = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 30.0, 5.0),
          ("d", 31.0, 1.0)]
    tr = tracing.Trace(events=ev, window_s=1e-4)
    assert tracing.merged(ev) == [(0.0, 15.0), (30.0, 35.0)]
    assert tr.busy_s() == pytest.approx(20e-6)


def steps_trace(n_steps, step_us=1000.0, fused_us=600.0, drive_us=20.0,
                cat_us=50.0, stdp=False, tenants=1):
    ev = []
    for i in range(n_steps):
        t = i * step_us
        ev.append((DRIVE, t, drive_us))
        ev.append((FUSED, t + drive_us, fused_us))
        ev.append((CAT, t + drive_us + fused_us, cat_us))
        if stdp:
            ev.append((DENSE, t + drive_us + fused_us + cat_us, 100.0))
    return tracing.Trace(events=ev, window_s=n_steps * step_us * 2e-6,
                         extra=dict(steps=n_steps, spikes=3500.0 * n_steps,
                                    tenants=tenants, stdp=stdp))


def test_trace_readers_of_a_sim_cell():
    tr = steps_trace(100)
    run = sim_run(trace=tr, wall_s=10.0 + tr.window_s, sim_steps=10100)
    assert read("step.outside_us.sim", run) == pytest.approx(50.0)
    # busy 670 us a step against the untraced 1 ms a step
    assert read("device.idle.sim", run) == pytest.approx(33.0)
    assert read("step.outside_us.serve", run) is None
    assert read("plasticity.device_ms", run) is None
    roof = read("fused_step_roofline.sim", run)
    assert 0 < roof < 100
    mfu = read("step_mfu.sim", run)
    assert 0 < mfu < roof


def test_roofline_is_the_bound_over_the_time():
    from bench.harness import shapes
    tr = steps_trace(10, fused_us=500.0)
    run = sim_run(trace=tr)
    s = shapes.sizes(run.cfg)
    b, f = common.counts("fused_step").work(
        columns=s["columns"], n=s["n"], k=s["k"], table=s["table"],
        tenants=1, spiking_rows=3500.0, stdp=False, own_weights=False)
    want = 100 * max(b / 3.35e12, f / 67e12) / 500e-6
    assert read("fused_step_roofline.sim", run) == pytest.approx(want)


def test_plastic_readers():
    tr = steps_trace(10, stdp=True)
    run = sim_run(trace=tr)
    assert read("plasticity.device_ms", run) == pytest.approx(0.1)
    assert read("stdp_dense_update_roofline", run) == pytest.approx(
        100 * (2 * 576 * 1240 * 1240 * 4 + 4 * 576 * 1240 * 4) / 3.35e12
        / 100e-6)


def test_serve_readers():
    tr = steps_trace(256, step_us=4000.0, fused_us=2400.0, tenants=8)
    run = serve_run([1.0] * 200, trace=tr)
    assert read("serve.occupancy", run) == pytest.approx(
        100 * 40000 / (6000 * 8))
    assert read("step.outside_us.serve", run) == pytest.approx(50.0)
    assert read("fused_step_roofline.serve", run) > 0
    assert read("step.outside_us.sim", run) is None
    assert read("serve.occupancy", serve_run([1.0])) is None


def test_breakdown_names_ops_and_gaps():
    tr = steps_trace(3)
    b = tracing.breakdown(tr.events)
    names = [n for n, _ in b["device_ops"]]
    assert names[0] == "fused_step_kernel"
    assert set(names) == {"fused_step_kernel", "keyed_drive_kernel",
                          "CatArrayBatchedCopy"}
    gap, secs = b["idle_gaps"][0]
    assert gap == "CatArrayBatchedCopy -> keyed_drive_kernel"
    assert secs == pytest.approx(2 * 330e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_read_chrome_keeps_device_operations(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": FUSED, "ts": 5, "dur": 2},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1, "dur": 9},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1,
         "dur": 1},
        {"ph": "i", "cat": "kernel", "name": "x", "ts": 0}]}))
    assert tracing.read_chrome(p) == [("Memcpy DtoH", 1.0, 1.0),
                                      (FUSED, 5.0, 2.0)]


def test_port_kernel_names():
    rx = tracing.PORT_KERNEL_RE
    assert rx.search(FUSED) and rx.search(DRIVE) and rx.search(DENSE)
    assert rx.search("void fused_step_cluster_kernel<true>(float*)")
    assert not rx.search(CAT)
