"""What every part of the benchmark shares: where things are, how a name
in ``BENCHMARK.json`` finds its file, the program's configuration, and
the exact comparisons that decide ``correct``.

Nothing here imports the program at module level; :func:`program_config`
imports its configuration classes when it is called.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# top-level modules that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(sp: dict, name: str) -> dict:
    for w in sp["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(sp: dict, name: str) -> Path:
    for c in sp["configs"]:
        if c["name"] == name:
            return ROOT / c["file"]
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic_file(name: str) -> Path:
    return BENCH / "traffic" / f"{name}.json"


def load_module(path: Path):
    """The Python file at ``path`` as a module (its file name may hold
    dots, as a metric's name does)."""
    name = "bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec_ = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def driver(name: str):
    return load_module(BENCH / "drivers" / f"{name}.py")


def metric_reader(name: str):
    return load_module(BENCH / "metrics" / f"{name}.py")


def counts(name: str):
    return load_module(BENCH / "counts" / f"{name}.py")


def peaks() -> dict:
    return load_json(BENCH / "peaks.json")


def forbidden_modules() -> list[str]:
    """The modules held in this process whose top-level name is one of
    ``FORBIDDEN``, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def program_config(cfg: dict, seed: int, stdp: bool):
    """The program's ``DPSNNConfig`` of a configuration file, with the
    run's seed and plasticity switch."""
    from repro_torch.configs import base
    return base.DPSNNConfig(
        name=cfg["name"], grid_h=cfg["grid_h"], grid_w=cfg["grid_w"],
        neurons_per_column=cfg["neurons_per_column"], c_ext=cfg["c_ext"],
        nu_ext_hz=cfg["nu_ext_hz"],
        neuron=base.NeuronConfig(**cfg["neuron"]),
        conn=base.ConnectivityConfig(**cfg["conn"]),
        exchange=base.ExchangeConfig(**cfg["exchange"]),
        stdp=stdp, stdp_cfg=base.STDPConfig(**cfg["stdp_cfg"]),
        guard=base.GuardConfig(**cfg["guard"]), seed=seed,
        dtype=cfg["dtype"], weight_dtype=cfg["weight_dtype"])


def total_synapses(cfg: dict) -> int:
    """Equivalent synapses of the paper's Table 1: local, remote and
    external, all neurons."""
    from bench.reference.dpsnn import stencil
    n = cfg["neurons_per_column"]
    neurons = cfg["grid_h"] * cfg["grid_w"] * n
    local = round(cfg["conn"]["p_local"] * (n - 1))
    return neurons * (local + stencil(cfg).k_total + cfg["c_ext"])


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of ``got`` that differ from ``want`` (a NaN equals a NaN;
    a shape that differs counts every element)."""
    got = torch.as_tensor(got)
    want = torch.as_tensor(want).to(got.device)
    if got.shape != want.shape or got.dtype != want.dtype:
        return max(got.numel(), want.numel(), 1)
    if got.is_floating_point():
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    else:
        same = got == want
    return int((~same).sum())


_DIGEST_CHUNK = 1 << 26


def digest(t: torch.Tensor) -> int:
    """An exact fingerprint of a tensor's bits: the int64 sum, modulo
    2**64, of (bits + 1) times a hash of the position, in chunks. Integer
    sums do not depend on their order, so two equal tensors give one
    digest on any device."""
    flat = t.detach().reshape(-1)
    if flat.dtype == torch.float32:
        flat = flat.view(torch.int32)
    total = torch.zeros((), dtype=torch.int64, device=flat.device)
    for i in range(0, flat.numel(), _DIGEST_CHUNK):
        part = flat[i:i + _DIGEST_CHUNK].to(torch.int64) + 1
        pos = torch.arange(i, i + part.numel(), dtype=torch.int64,
                           device=flat.device)
        total += (part * ((pos * 2654435761) % 2147483647 + 1)).sum()
    return int(total)


def percentile(values, q: float) -> float:
    """The nearest-rank ``q`` percentile (0 < q <= 100) of ``values``."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]
