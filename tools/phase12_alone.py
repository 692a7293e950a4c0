#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py`` alone on one NVIDIA card: the LM zoo's
training path (qwen3-0.6b at its published size, 20 AdamW steps and 2 at
microbatch 2, its float32 checks at 2 layers, and the reduced configs of
the ten archs and three optimizer settings against the CPU).

    python3 tools/phase12_alone.py [--with-10-11]

Phase 12 reads nothing of phases 0-11 and runs no kernel of this repo,
so a change to the training path can be tried on the card without them;
``--with-10-11`` runs phases 10 and 11 first (the LM serving path), as
the script does. It needs the card.
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
        print("phase12_alone: no card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    sm = cs.Smoke(torch)
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    cs.log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
           f"{torch.cuda.get_device_name(0)}")
    if "--with-10-11" in sys.argv[1:]:
        sm.lm_path()
        sm.lm_families_path()
    sm.lm_train_path()
    print(json.dumps({k: v for k, v in sm.report.items()
                      if k.startswith("phase")}))
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
