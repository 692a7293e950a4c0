#!/usr/bin/env python3
"""Phase 13 of ``chip_smoke.py`` alone on one NVIDIA card: the LM zoo on
a ``DeviceMesh`` (the sharded train step of three reduced configs on a
one-rank NCCL mesh against the unsharded step, to the bit, and three
dry-run cells timed on the host's cores while it runs).

    python3 tools/phase13_alone.py

Phase 13 reads nothing of phases 0-12 and runs no kernel of this repo,
so a change to the sharding rules, the sharded step or the dry run can
be tried on the card without them. It needs the card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("phase13_alone: no card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    sm = cs.Smoke(torch)
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    cs.log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
           f"{torch.cuda.get_device_name(0)}")
    sm.lm_mesh_path()
    print(json.dumps(sm.report["phase13"]))
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
