"""What decides ``correct``, driven through the harness on tiny cells
on the CPU (past its look for a card): sound runs read every number at
0; the control, the reference in the program's place with its weights
in bfloat16, fails; and so does each fault the cells can have, planted
in the program's step where it is produced:

* a step that returns its state unchanged;
* half of the batch left out (the second half of the rows, columns or
  tenants' columns, keeps its old state);
* an answer altered where it is produced (one spike flipped, every
  15th step).

The cells run on one card, so no exchange between cards can be left
out."""
from __future__ import annotations

import pytest
import torch

import _tiny
from _tiny import common

CELLS = ["g24.static", "g24.plastic", "g24.serve"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_are_correct(workload):
    r = _tiny.run(workload)
    assert r["correct"], r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_another_seed_is_correct(workload):
    assert _tiny.run(workload, seed=12345)["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    """The reference with bfloat16 weights in the program's place."""
    mix = _tiny.mix(workload)
    drv = common.driver(mix["driver"])
    cfg = _tiny.config()
    cpu = torch.device("cpu")
    out = drv.control_outputs(cfg, mix, _tiny.SEED, cpu, "plain")
    checks, failed, _ = drv.judge(cfg, mix, _tiny.SEED, out, cpu, "plain")
    assert failed > 0
    assert any(v > lim for v, lim in checks.values())
    fp32 = drv.control_outputs(cfg, mix, _tiny.SEED, cpu, "plain",
                               weight_dtype=torch.float32)
    checks, failed, _ = drv.judge(cfg, mix, _tiny.SEED, fp32, cpu, "plain")
    assert failed == 0 and all(v == 0 for v, _ in checks.values())


def unchanged(orig):
    def step(ncfg, v, c, refrac, s_loc, *args, scfg=None, **kw):
        out = orig(ncfg, v, c, refrac, s_loc, *args, scfg=scfg, **kw)
        keep = (v, c, refrac, torch.zeros_like(out[3]))
        if scfg is not None:
            keep += (args[5], args[6])
        return keep + tuple(out[len(keep):])
    return step


def half_left_out(orig):
    def step(ncfg, v, c, refrac, s_loc, *args, scfg=None, **kw):
        out = list(orig(ncfg, v, c, refrac, s_loc, *args, scfg=scfg, **kw))
        h = v.shape[0] // 2
        old = [v, c, refrac, torch.zeros_like(out[3])]
        if scfg is not None:
            old += [args[5], args[6]]
        for i, o in enumerate(old):
            out[i] = out[i].clone()
            out[i][h:] = o[h:]
        return tuple(out)
    return step


def one_spike_flipped(orig, every=15):
    calls = [0]

    def step(*a, **kw):
        out = list(orig(*a, **kw))
        calls[0] += 1
        if calls[0] % every == 0:
            out[3] = out[3].clone()
            out[3][0, 0] = 1.0 - out[3][0, 0]
        return tuple(out)
    return step


@pytest.mark.parametrize("fault", [unchanged, half_left_out,
                                   one_spike_flipped],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", CELLS)
def test_each_fault_is_not_correct(workload, fault, monkeypatch):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "fused_step", fault(ops.fused_step))
    r = _tiny.run(workload)
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0


class FakeTracer:
    """Stands in for the profiler on the CPU: each stretch it traces
    reads as one ``fused_step`` and one drive launch a step."""

    def __init__(self, torch, out):
        self.t0 = 0.0

    def start(self):
        import time
        self.t0 = time.perf_counter()

    def stop(self, **extra):
        import time
        from bench.harness import trace as tracing
        n = extra.get("steps", 1)
        ev = [e for i in range(n) for e in (
            ("keyed_drive_kernel", i * 100.0, 10.0),
            ("fused_step_kernel", i * 100.0 + 10.0, 60.0),
            ("stdp_dense_update_kernel", i * 100.0 + 70.0, 20.0))
              if extra.get("stdp") or "stdp" not in e[0]]
        return tracing.Trace(events=ev, window_s=time.perf_counter()
                             - self.t0, extra=extra)


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_run_reports_its_layers(workload, monkeypatch):
    import torch

    from bench import run as bench_run
    from bench.harness import trace as tracing
    monkeypatch.setattr(tracing, "Tracer", FakeTracer)
    mix = dict(_tiny.MIXES[workload], traced_loop_steps=8)
    r = bench_run.run_cell(workload, _tiny.SEED, 1.5, True,
                           device=torch.device("cpu"), config=_tiny.config(),
                           mix_update=mix)
    assert r["correct"], r["checks"]
    sp = common.spec(_tiny.ROOT)
    want = {m["name"] for m in sp["per_layer"] if workload in m["workloads"]}
    assert set(r["metrics"]) == want
    assert r["device"]["busy_s"] > 0 and r["device"]["window_s"] > 0
    assert r["breakdown"]["device_ops"][0][0] == "fused_step_kernel"
