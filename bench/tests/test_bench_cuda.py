"""One short run of each cell on the card through the command the driver
runs: it has to come out correct and print its metrics. Marked ``cuda``:
it skips, with its reason, where there is no card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from _tiny import ROOT, common

CELLS = [w["name"] for w in common.spec(ROOT)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(workload, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", workload, "--seed",
         str(2 ** 31 + 99), "--seconds", "4", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["metrics"] and r["device"]["platform"] == "gpu"
