#!/usr/bin/env python3
"""What the 8-bit AdamW update costs one rank on a mesh, against the
float32 AdamW update: the collective bytes it receives and the peak of
the buffers it makes. Runs on the CPU on meta DTensors over a fake
process group (as ``launch/dryrun.py`` does), so nothing is allocated
and nothing moves; a full-size config is cheap.

    PYTHONPATH=src python3 tools/q8_sharded_cost.py --arch qwen3-0.6b \\
        [--reduced] [--mesh 16x16]

For each optimizer (``adamw``, ``adamw8bit``) it places the state on the
mesh (``launch/train.shard_state``), takes gradients of zeros placed
like the parameters, and runs the optimizer's ``update`` and
``place_opt`` once under a dispatch mode that counts, per rank: the
collective bytes (``launch/cost.py``'s rule, all-reduce doubled) and
its ``temp_bytes``: the peak of the storages made since the update
began and still alive (its transients, the new parameters and the new
state).
Beside them: the optimizer state's bytes on one rank, and the largest
parameter leaf (whole, float32). One JSON line an optimizer.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _local(x):
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def measure(arch: str, reduced: bool, mesh_shape, optimizer: str) -> dict:
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import cost
    from repro_torch.launch import train as TR
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizer import Q8, make_optimizer
    from repro_torch.runtime import sharding as SH

    cfg = reduced_config(arch) if reduced else get_config(arch)
    model = build_model(cfg, device="meta")
    mesh = make_host_mesh(mesh_shape)
    tcfg = TrainConfig(optimizer=optimizer)
    state = TR.shard_state(TR.init_state(model, tcfg), model, mesh)
    leaves = TR.Leaves(state.params)
    params = leaves.params()
    grads = {k: torch.zeros_like(x, dtype=torch.float32)
             for k, x in params.items()}
    _, update = make_optimizer(tcfg)

    def step():
        _, opt, _ = update(grads, state.opt, params, state.step)
        return TR.place_opt(opt, mesh, cfg)
    with SH.use_mesh(mesh):
        opt, c = cost.count(step)
    res = c["collectives"]
    largest = max(math.prod(x.shape) for x in params.values())
    q8 = [z for slot in opt.values() for z in slot.values()
          if isinstance(z, Q8)]
    return {"arch": arch, "reduced": reduced,
            "mesh": "x".join(map(str, mesh_shape)), "optimizer": optimizer,
            "collective_bytes_per_rank": res["total_bytes"],
            "collective_bytes_by_kind": res["bytes"],
            "update_peak_bytes_per_rank": c["temp_bytes"],
            "state_bytes_per_rank": sum(
                _local(x).numel() * _local(x).element_size()
                for x in cost.leaves(opt)),
            "state_bytes_whole": sum(
                math.prod(x.shape) * (1 + 4 / 256) for x in q8)
            if q8 else 8 * sum(math.prod(x.shape) for x in params.values()),
            "largest_leaf_float32_bytes": 4 * largest}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.launch.dryrun import start_fake_group
    shape = tuple(int(d) for d in args.mesh.split("x"))
    start_fake_group(math.prod(shape))
    for optimizer in ("adamw", "adamw8bit"):
        print(json.dumps(measure(args.arch, args.reduced, shape,
                                 optimizer)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
