"""The control of a cell's comparison, on the card at the cell's own size:
the plain reference put in the program's place with its weights held in
bfloat16 (the precision below the configuration's float32), judged by
the same check as the program's runs. Its readings are the upper ends of
the limits that ``PERF.md`` records; the benchmark's own runs never run
it.

    python bench/control.py --workload g24.static --seeds 11 12 13
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from bench.harness import common
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    dev = torch.device("cuda:0")
    sp = common.spec(ROOT)
    wl = common.workload(sp, args.workload)
    cfg = common.load_json(common.config_file(sp, wl["config"]))
    mix = common.load_json(common.traffic_file(wl["traffic"]))
    drv = common.driver(mix["driver"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = drv.control_outputs(cfg, mix, seed, dev, "kernel")
        checks, failed, detail = drv.judge(cfg, mix, seed, out, dev, "kernel")
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "bfloat16 weights", "failed": failed,
                          "checks": {k: v for k, (v, _) in checks.items()},
                          "detail": detail,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
