"""Tiny cells for the benchmark's CPU tests: the paper's configuration
cut to a 4x4 grid of 48-neuron columns, and short mixes."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.harness import common  # noqa: E402

SEED = 2 ** 31 + 77      # past 32 signed bits, as the driver's seeds are

MIXES = {
    "g24.static": {"warmup_steps": 10, "segment_steps": 20},
    "g24.plastic": {"warmup_steps": 10, "segment_steps": 20},
    "g24.serve": {"steps_min": 4, "steps_max": 24, "chunk": 8, "slots": 3,
                  "clients": 4, "warmup_steps": 8, "checked_jobs": 64,
                  "pool": 16},
}


def config(grid: int = 4, neurons: int = 48) -> dict:
    cfg = common.load_json(ROOT / "bench" / "configs" / "dpsnn-24x24.json")
    cfg.update(grid_h=grid, grid_w=grid, neurons_per_column=neurons)
    return cfg


def mix(workload: str) -> dict:
    sp = common.spec(ROOT)
    m = common.load_json(common.traffic_file(
        common.workload(sp, workload)["traffic"]))
    m.update(MIXES[workload])
    return m


def run(workload: str, seed: int = SEED, seconds: float = 0.3) -> dict:
    """One run of a tiny cell on the CPU through the harness's own path,
    past its look for a card."""
    import torch

    from bench import run as bench_run
    return bench_run.run_cell(workload, seed, seconds, False,
                              device=torch.device("cpu"), config=config(),
                              mix_update=MIXES[workload])
