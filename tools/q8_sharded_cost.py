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
the peak over every op of the summed bytes of the storages made since
the update began and still alive (its transients, the new parameters and
the new state).
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


def _tensors(opt: dict, *trees: dict):
    """The tensors of an optimizer state (a ``Q8``'s codes and scales)
    and of flat dicts of tensors."""
    for slot in opt.values():
        for z in slot.values():
            yield from (z.q, z.scale) if hasattr(z, "q") else (z,)
    for tree in trees:
        yield from tree.values()


def measure(arch: str, reduced: bool, mesh_shape, optimizer: str) -> dict:
    import torch
    from torch.multiprocessing.reductions import StorageWeakRef

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import cost
    from repro_torch.launch import train as TR
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizer import Q8, make_optimizer
    from repro_torch.runtime import sharding as SH

    class Live(cost.Count):
        """cost.Count, and the peak bytes of the live storages that its
        ops return, those in ``before`` (the arguments') left out."""

        def __init__(self, before):
            super().__init__()
            self.before, self.live, self.peak = before, {}, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            from torch._subclasses.fake_tensor import FakeTensor
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or any(
                    issubclass(t, FakeTensor) for t in types):
                return out      # DTensor's desugaring, its shape propagation
            for t in torch.utils._pytree.tree_leaves(out):
                if torch.is_tensor(t) and not isinstance(t, FakeTensor):
                    ref = StorageWeakRef(t.untyped_storage())
                    if ref.cdata in self.before:
                        continue
                    self.live.setdefault(
                        ref.cdata, (ref, t.untyped_storage().nbytes()))
            self.live = {k: v for k, v in self.live.items()
                         if not v[0].expired()}
            self.peak = max(self.peak,
                            sum(n for _, n in self.live.values()))
            return out

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
    before = {StorageWeakRef(_local(x).untyped_storage()).cdata
              for x in _tensors(state.opt, params, grads)}
    with SH.use_mesh(mesh), Live(before) as mode:
        _, opt, _ = update(grads, state.opt, params, state.step)
        opt = TR.place_opt(opt, mesh, cfg)
    res = mode.result()["collectives"]
    largest = max(math.prod(x.shape) for x in params.values())
    q8 = [z for slot in opt.values() for z in slot.values()
          if isinstance(z, Q8)]
    return {"arch": arch, "reduced": reduced,
            "mesh": "x".join(map(str, mesh_shape)), "optimizer": optimizer,
            "collective_bytes_per_rank": res["total_bytes"],
            "collective_bytes_by_kind": res["bytes"],
            "update_peak_bytes_per_rank": mode.peak,
            "state_bytes_per_rank": sum(
                _local(x).numel() * _local(x).element_size()
                for x in _tensors(opt)),
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
