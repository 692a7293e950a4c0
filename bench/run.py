"""Run one cell of the benchmark once, and print its result line.

    python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix and
metrics are found by name: ``BENCHMARK.json`` names the cell's
configuration file and mix (``bench/traffic/<mix>.json``), the mix names
its driver (``bench/drivers/<driver>.py``), and each metric is read by
``bench/metrics/<metric>.py``. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a profiled
stretch of the same window.

A run: set-up (imports, the card, the network built from the seed, the
kernels built or loaded from ``build/``, warm-up), then the measured
window of ``--seconds``, then the check of what the window produced
against the plain reference under ``bench/reference/`` (never counted in
set-up or the window). The last line on standard output is one JSON
object; its last key, ``checks``, gives each number compared with its
limit, which are also the last lines on standard error.

It exits non-zero and prints no result when there is no card (or fewer
than the cell asks for), when a file it needs is missing, or when a
module of JAX or of the JAX package is loaded once the window has
closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the run, at fixed paths in the checkout
CACHES = {"TRITON_CACHE_DIR": "build/cache/triton",
          "TORCH_EXTENSIONS_DIR": "build/cache/torch_extensions",
          "CUDA_CACHE_PATH": "build/cache/cuda"}
TRACE_FILE = ROOT / "build" / "bench" / "trace.json"


def _environment() -> None:
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device,
             config: dict | None = None, mix_update: dict | None = None
             ) -> dict:
    """One run of cell ``name`` on ``device``: set-up, window, metrics,
    check. Returns the result as a dict (``checks`` last). ``config``
    and ``mix_update`` replace the configuration and amend the mix (the
    tests run tiny cells on the CPU)."""
    import torch

    from bench.harness import common, trace as tracing

    sp = common.spec(ROOT)
    wl = common.workload(sp, name)
    cfg = config or common.load_json(common.config_file(sp, wl["config"]))
    mix = common.load_json(common.traffic_file(wl["traffic"]))
    mix.update(mix_update or {})
    drv = common.driver(mix["driver"])
    cuda = device.type == "cuda"
    tracer = tracing.Tracer(torch, TRACE_FILE) if trace else None
    cell = drv.Cell(cfg=cfg, mix=mix, seed=seed, device=device,
                    tracer=tracer)
    cell.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T0
    window = cell.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    # what a metric reader reads
    run = SimpleNamespace(cfg=cfg, mix=mix, setup_s=setup_s,
                          memory_peak_bytes=peak,
                          synapses=common.total_synapses(cfg), window=window,
                          trace=cell.trace, peaks=common.peaks())
    metrics = {}
    for m in sp["per_layer"] if trace else sp["end_to_end"]:
        if name not in m.get("workloads", [name]):
            continue
        value = common.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": wl["chips"], "memory_peak_bytes": int(peak)}
    if trace and cell.trace is not None:
        dev.update(busy_s=cell.trace.busy_s(),
                   window_s=cell.trace.window_s)
    if cuda:
        dev["power_limit"] = _power_limit()
    outputs = cell.release()
    trace_rec = cell.trace
    del cell
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, failed, detail = drv.judge(cfg, mix, seed, outputs, device,
                                       "kernel" if cuda else "plain")
    check_s = time.perf_counter() - t_check
    result = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": (window["segments"] if window["kind"] == "sim"
                      else window["jobs_submitted"]),
        "failed": int(failed),
        "metrics": metrics,
        "device": dev,
    }
    if trace_rec is not None:
        result["breakdown"] = tracing.breakdown(trace_rec.events)
    result["detail"] = detail
    result["check_s"] = check_s
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from bench.harness import common

    missing = [p for p in (ROOT / "BENCHMARK.json", ROOT / "src" /
                           "repro_torch") if not p.exists()]
    if missing:
        print(f"missing: {', '.join(map(str, missing))}", file=sys.stderr)
        return 2
    chips = common.workload(common.spec(ROOT), args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device=torch.device("cuda:0"))
    bad = common.forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
