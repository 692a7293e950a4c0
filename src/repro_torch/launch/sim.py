"""DPSNN simulation entry point on one card (the paper's workload).

    PYTHONPATH=src python -m repro_torch.launch.sim --grid 24x24 \
        --neurons 1240 --steps 200 [--impl cuda_fused|cuda|ref] \
        [--stdp] [--device cuda|cpu] [--seed 42] \
        [--mesh RxC [--pipelined] [--no-compress]]

The network is built on the device from the seed, keyed as the JAX
reference builds it, and the kernels from the sources,
both before the clock starts; ``WARMUP_STEPS`` steps run untimed, and
the timed steps end in ``torch.cuda.synchronize()``. The rate and the
events count the timed steps alone. ``--stdp`` turns plasticity on and
prints the weights' drift over the whole run. ``--mesh RxC`` tiles the
grid over an R x C shard grid in this process, all shards stacked into
each kernel launch, with the halo exchange between them
(``core/exchange.py``; ``--pipelined`` defers each exchanged frame by a
step; with ``--stdp`` the pre-trace halo rides beside the spikes and
the weights' drift is printed as on one shard). The strips move as
slices on the card, packed into 32-bit words as a rank packs them
(``transport.pack_spikes``), or as float32 strips with
``--no-compress``, as the reference's flag of the same name; the halo
bytes it prints are those an interior rank of that grid sends on that
wire (``runtime/compression.py``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import DPSNNConfig, ExchangeConfig
from repro_torch.core import exchange
from repro_torch.core import metrics as M
from repro_torch.core import network as net
from repro_torch.core import simulation as sim
from repro_torch.kernels import ops
from repro_torch.runtime.compression import halo_payload_bytes
from repro_torch.runtime.transport import LocalMesh

# untimed steps before the clock starts: the first steps on a card pay
# for the CUDA context and the library's loading
WARMUP_STEPS = 2


def parse_grid(s: str):
    h, w = s.split("x")
    return int(h), int(w)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", default="8x8")
    ap.add_argument("--neurons", type=int, default=64)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--impl", default="cuda_fused", choices=net.IMPLS)
    ap.add_argument("--stdp", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--mesh", default="",
                    help="e.g. 2x2 (rows x cols of shards); empty = one shard")
    ap.add_argument("--pipelined", action="store_true",
                    help="cross-step pipelined halo exchange (mesh runs)")
    ap.add_argument("--no-compress", action="store_true",
                    help="mesh runs: move float32 strips, not packed words")
    args = ap.parse_args(argv)

    gh, gw = parse_grid(args.grid)
    cfg = DPSNNConfig(grid_h=gh, grid_w=gw, neurons_per_column=args.neurons,
                      stdp=args.stdp, seed=args.seed,
                      exchange=ExchangeConfig(pipelined=args.pipelined))
    net.check_supported(cfg, args.impl, mesh=bool(args.mesh))
    device = net.resolve_device(args.device)
    print(f"grid {gh}x{gw}, {cfg.n_neurons} neurons, "
          f"{cfg.recurrent_synapses/1e6:.1f}M recurrent synapses "
          f"({cfg.local_fanin}+{cfg.remote_fanin}/neuron), "
          f"plasticity {'ON (STDP)' if cfg.stdp else 'off'}, impl "
          f"{args.impl} on {device}")

    if device.type == "cuda":
        ops.library()
    if args.mesh:
        return run_mesh(cfg, args, LocalMesh(*parse_grid(args.mesh), device,
                                             compress=not args.no_compress))
    params0, state = sim.build(cfg, device=device)
    warm = sim.run(cfg, params0, state, WARMUP_STEPS, impl=args.impl)
    params, state = warm.params, warm.state

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    res = sim.run(cfg, params, state, args.steps, impl=args.impl)
    sync()
    dt = time.perf_counter() - t0
    sim_s = args.steps * cfg.neuron.dt_ms * 1e-3
    spikes = float(res.spikes - state.spike_count)
    rate = spikes / (cfg.n_neurons * sim_s)
    events = float(res.events - state.event_count)
    print(f"bytes/synapse: {M.bytes_per_synapse(cfg, params, res.state):.2f}")
    if cfg.stdp:
        print_drift(params0.w_local, res.params.w_local)
    print(f"{args.steps} steps in {dt:.2f}s "
          f"(after {WARMUP_STEPS} warm-up steps) | rate {rate:.2f} Hz | "
          f"{events:.3e} synaptic events | "
          f"{M.time_per_synaptic_event(dt, events):.3e} s/event | "
          f"{dt/sim_s:.1f}x slower than real time")
    return res


def print_drift(w0: torch.Tensor, w: torch.Tensor) -> None:
    """The local weights' drift over the whole run, warm-up included."""
    dw = (w - w0).abs()
    print(f"STDP weight drift: mean |dw| "
          f"{float(dw.sum() / (w0 != 0).sum()):.3e}, "
          f"max {float(dw.max()):.3e}")


def run_mesh(cfg: DPSNNConfig, args, mesh):
    """``--mesh``: the same protocol over the in-process shard grid."""
    dev = mesh.device
    spec = exchange.make_tile_spec(cfg, *mesh.shape)
    params = exchange.build_shard(cfg, spec, mesh)
    kw = dict(impl=args.impl, with_state=True, params=params)
    warm, _ = exchange.make_distributed_run(cfg, mesh,
                                            n_steps=WARMUP_STEPS, **kw)
    timed, _ = exchange.make_distributed_run(cfg, mesh, n_steps=args.steps,
                                             **kw)
    _, state = warm()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    res, final = timed(state)
    sync()
    dt = time.perf_counter() - t0
    sim_s = args.steps * cfg.neuron.dt_ms * 1e-3
    events = float(final.event_count.double().sum()
                   - state.event_count.double().sum())
    spikes = float(final.spike_count.double().sum()
                   - state.spike_count.double().sum())
    rate = spikes / (cfg.n_neurons * sim_s)
    payload = halo_payload_bytes(cfg, spec, compress=mesh.compress)
    print(f"mesh {mesh.shape[0]}x{mesh.shape[1]} shards of "
          f"{spec.tile_h}x{spec.tile_w} columns, {spec.rings_y}+"
          f"{spec.rings_x} rings, {spec.permutes_per_step} shifts and "
          f"{payload['bytes_per_step']} halo bytes per step per interior "
          f"shard, {'packed' if mesh.compress else 'float32'} strips"
          f"{', pipelined' if cfg.exchange.pipelined else ''}")
    if cfg.stdp:
        print_drift(params.w_local,
                    final.plastic.w_local.reshape(params.w_local.shape))
    print(f"{args.steps} steps in {dt:.2f}s "
          f"(after {WARMUP_STEPS} warm-up steps) | rate {rate:.2f} Hz | "
          f"{events:.3e} synaptic events | "
          f"{M.time_per_synaptic_event(dt, events):.3e} s/event | "
          f"{dt/sim_s:.1f}x slower than real time")
    return res


if __name__ == "__main__":
    main()
