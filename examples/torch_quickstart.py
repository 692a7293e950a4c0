"""Quickstart of the PyTorch/H100 port: simulate a small cortical sheet
(the paper's workload) on the card and report every metric the paper
measures, then the same network with plasticity on.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On the card (the default) the kernels are built from
``src/repro_torch/csrc`` on first use; ``--device cpu`` runs their plain
PyTorch versions. ``--grid``, ``--neurons``, ``--steps`` and
``--stdp-steps`` shrink the run (the defaults are the JAX quickstart's:
an 8x8 grid of 64-neuron columns, 1000 steps and 250 plastic steps).
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs.base import DPSNNConfig  # noqa: E402
from repro_torch.core import metrics as M  # noqa: E402
from repro_torch.core import network as net  # noqa: E402
from repro_torch.core import simulation as sim  # noqa: E402

WARMUP_STEPS = 20


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", default="8x8")
    ap.add_argument("--neurons", type=int, default=64)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--stdp-steps", type=int, default=250)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    device = net.resolve_device(args.device)
    impl = "cuda_fused"     # the plain versions on CPU tensors
    gh, gw = (int(x) for x in args.grid.split("x"))
    # the paper's family (96x96 x 1240, Table 1), laptop-sized
    cfg = DPSNNConfig(grid_h=gh, grid_w=gw, neurons_per_column=args.neurons,
                      seed=args.seed)
    print(f"columns {cfg.n_columns}  neurons {cfg.n_neurons}  "
          f"synapses/neuron {cfg.local_fanin}+{cfg.remote_fanin} recurrent"
          f" + {cfg.c_ext} external  on {device}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    params, state = sim.build(cfg, device=device)
    sim.run(cfg, params, state, WARMUP_STEPS, impl=impl)   # warm-up
    sync()
    t0 = time.perf_counter()
    res = sim.run(cfg, params, state, args.steps, impl=impl)
    sync()
    dt = time.perf_counter() - t0
    events = float(res.events)

    print(f"mean firing rate      : {float(res.rate_hz):6.2f} Hz")
    print(f"synaptic events       : {events:.3e}")
    print(f"time per synaptic evt : "
          f"{M.time_per_synaptic_event(dt, events):.3e} s "
          f"(paper, 1 Xeon core, 0.9G-syn net: 2.75e-7)")
    print(f"realtime factor       : "
          f"{M.realtime_factor(dt, args.steps, cfg.neuron.dt_ms):6.1f}x "
          f"slower than real time")
    print(f"memory per synapse    : "
          f"{M.bytes_per_synapse(cfg, params, res.state):6.2f} B "
          f"(paper: 25.9-34.4)")
    print(f"population synchrony  : "
          f"{float(M.synchrony_index(res.rate_trace)):6.2f} (CV of rate)")

    # the same network with plasticity on (DPSNN-STDP's feature; the 2015
    # paper measures with it off)
    pcfg = dataclasses.replace(cfg, stdp=True)
    pparams, pstate = sim.build(pcfg, device=device)
    pres = sim.run(pcfg, pparams, pstate, args.stdp_steps, impl=impl)
    dw = (pres.params.w_local - pparams.w_local).abs()
    n_syn = (pparams.w_local != 0).sum()
    print(f"STDP ({args.stdp_steps} ms)         : rate "
          f"{float(pres.rate_hz):5.2f} Hz, "
          f"mean |dw| {float(dw.sum() / n_syn):.2e}, "
          f"max {float(dw.max()):.2e} "
          f"(w_max {pcfg.stdp_cfg.w_max_factor * pcfg.conn.j_exc:.2f})")
    return res, pres


if __name__ == "__main__":
    main()
