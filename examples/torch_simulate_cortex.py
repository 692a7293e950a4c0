"""Distributed cortical simulation with halo exchange, the paper's core
experiment, on the PyTorch/H100 port: the column grid tiled over a 2x2
grid of shards stacked in one process (``LocalMesh``, the port's stand-in
for a 4-device mesh), each step's halo strips packed into 32-bit words as
a rank sends them, and the run held bitwise to the single shard.

    PYTHONPATH=src python examples/torch_simulate_cortex.py [--device cpu]

On the card (the default) every shard's columns go through one
``fused_step`` launch a step; ``--device cpu`` runs the plain PyTorch
versions. ``--grid``, ``--neurons`` and ``--steps`` shrink the run (the
defaults are the JAX example's: 8x8 columns of 64 neurons, 500 steps);
``--mesh`` picks another shard grid. For shards on separate processes,
see ``python -m repro_torch.launch.launch_distributed``.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs.base import DPSNNConfig  # noqa: E402
from repro_torch.core import exchange  # noqa: E402
from repro_torch.core import network as net  # noqa: E402
from repro_torch.core import simulation as sim  # noqa: E402
from repro_torch.runtime.transport import LocalMesh  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", default="8x8")
    ap.add_argument("--neurons", type=int, default=64)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)
    device = net.resolve_device(args.device)
    gh, gw = (int(x) for x in args.grid.split("x"))
    cfg = DPSNNConfig(grid_h=gh, grid_w=gw, neurons_per_column=args.neurons,
                      seed=args.seed)
    mesh = LocalMesh(*(int(x) for x in args.mesh.split("x")), device,
                     compress=True)
    print(f"distributed: {mesh.shape[0]}x{mesh.shape[1]} shards on "
          f"{device}, halo exchange between them, bit-packed spikes")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run, spec = exchange.make_distributed_run(cfg, mesh, n_steps=args.steps)
    t0 = time.perf_counter()
    res = run()
    sync()
    dt = time.perf_counter() - t0
    print(f"tile {spec.tile_h}x{spec.tile_w} cols/shard | {args.steps} "
          f"steps in {dt:.2f}s | rate {float(res.rate_hz):.2f} Hz | events "
          f"{float(res.events):.3e}")
    # cross-check against the single-shard run (bitwise)
    params, state = sim.build(cfg, device=device)
    ref = sim.run(cfg, params, state, args.steps)
    match = (float(ref.spikes) == float(res.spikes)
             and float(ref.events) == float(res.events)
             and torch.equal(ref.rate_trace, res.rate_trace))
    print(f"single-shard cross-check: spikes {float(res.spikes):.0f} vs "
          f"{float(ref.spikes):.0f}, events and per-step rates -> bitwise "
          f"{'MATCH' if match else 'MISMATCH'}")
    return 0 if match else 1


if __name__ == "__main__":
    sys.exit(main())
