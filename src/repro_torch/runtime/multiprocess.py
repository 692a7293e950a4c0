"""Multi-process distributed runtime: the paper's MPI ranks as OS
processes (the port of ``repro/runtime/multiprocess.py``).

* Each **rank** is one OS process (spawned by
  ``launch/launch_distributed.py``, or by any launcher that sets the
  coordinator environment) holding one shard of the column grid.
* :func:`init_worker` joins the rank into a ``torch.distributed``
  process group on gloo (TCP), so every halo shift crosses an OS-process
  boundary as a real message: the analogue of the paper's MPI exchange.
* Placement is process-major on the closest-to-square process grid: rank
  r owns tile ``(r // rx, r % rx)`` (``partition.process_grid``), so a
  shift crosses at most one process hop per ring.
* :func:`worker_run` runs the same ``exchange.dist_step`` as the
  in-process mesh, over a ``ProcessGroupMesh``. Determinism per column
  id makes the trajectory bitwise equal to the single-process one (the
  launcher checks it).

With ``--device cuda`` (the default) every rank runs its shard's kernels
on ``cuda:0``: ranks that share one card time-slice it, so their step
time is no scaling figure. Gloo carries CPU tensors, so the strips are
copied to the host and back. NCCL with one card per rank waits for a
machine with several cards (ROADMAP).

Run one rank by hand (the launcher does this N times):

    PYTHONPATH=src python -m repro_torch.runtime.multiprocess \
        --rank 0 --nranks 4 --coordinator 127.0.0.1:9300 \
        --grid 8x8 --neurons 64 --steps 100 [--device cpu]

Nothing initialises a process group or touches a device at import.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import sys
import time

import numpy as np

RESULT_TAG = "DPSNN-RESULT "  # rank 0 prints this + one JSON object


def init_worker(rank: int, n_ranks: int, coordinator: str,
                timeout_s: float = 900.0) -> None:
    """Join the gloo process group at ``coordinator`` (host:port) as rank
    ``rank`` of ``n_ranks``; a collective that waits longer than
    ``timeout_s`` raises."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", rank=rank,
        world_size=n_ranks, timeout=datetime.timedelta(seconds=timeout_s))


def save_state(state_dir: str, rank: int, state) -> None:
    """Write this rank's final stacked state to ``state_dir/rank<r>.npz``
    (leaves of ``convert.dist_state_to_numpy``)."""
    from repro_torch import convert

    os.makedirs(state_dir, exist_ok=True)
    np.savez(os.path.join(state_dir, f"rank{rank}.npz"),
             **convert.dist_state_to_numpy(state))


def load_states(state_dir: str, n_ranks: int) -> dict:
    """The ranks' saved states stacked in rank (= process-major shard)
    order: the layout of an in-process mesh's state."""
    parts = [np.load(os.path.join(state_dir, f"rank{r}.npz"))
             for r in range(n_ranks)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0].files}


def worker_run(cfg, n_steps: int, *, impl: str = "cuda_fused",
               compress: bool = True, device="cuda",
               state_dir: str = "") -> dict:
    """Build and run this rank's shard on the process grid; return the
    paper's metrics (totals all-reduced, so every rank returns the same).

    Timing: one untimed run warms the card and the connections; then one
    run is timed end to end (every rank waits for the all-reduced
    totals, so the wall time holds every message of every step).
    """
    import torch
    import torch.distributed as dist

    from repro_torch.core import exchange
    from repro_torch.kernels import ops
    from repro_torch.runtime.compression import halo_payload_bytes
    from repro_torch.runtime.transport import ProcessGroupMesh

    mesh = ProcessGroupMesh(device, compress=compress)
    dev = mesh.device
    if dev.type == "cpu":      # the ranks share the host's cores
        torch.set_num_threads(
            max(1, (os.cpu_count() or 1) // dist.get_world_size()))
    build_s = ops.library().build_seconds if dev.type == "cuda" else 0.0
    run, spec = exchange.make_distributed_run(
        cfg, mesh, n_steps=n_steps, impl=impl, with_state=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    run()                            # warm-up, untimed
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    res, final = run()
    sync()
    wall_s = time.perf_counter() - t0
    # the kernel library is built once per checkout: a rank that had to
    # build it raised the maximum
    most = torch.tensor([build_s], dtype=torch.float64)
    dist.all_reduce(most, op=dist.ReduceOp.MAX)
    if state_dir:
        save_state(state_dir, mesh.rank, final)
    events = float(res.events)
    payload = halo_payload_bytes(cfg, spec, compress=compress)
    return {
        "rank_count": dist.get_world_size(),
        "process_grid": list(mesh.shape),
        "grid": f"{cfg.grid_h}x{cfg.grid_w}",
        "neurons": cfg.n_neurons,
        "syn_equiv": cfg.total_equivalent_synapses,
        "tile": f"{spec.tile_h}x{spec.tile_w}",
        "steps": n_steps,
        "wall_s": wall_s,
        "step_ms": wall_s / n_steps * 1e3,
        "spikes": float(res.spikes),
        "events": events,
        "events_per_s": events / max(wall_s, 1e-12),
        "rate_hz": float(res.rate_hz),
        "state_checksum": float(res.state_checksum),
        "impl": impl,
        "compress": compress,
        "guard": cfg.guard.enabled,
        "pipelined": cfg.exchange.pipelined,
        "exchange_mode": cfg.conn.exchange_mode,
        "halo_payload_bytes_per_step": payload["bytes_per_step"],
        "aer_saturated_steps": int(res.aer_saturated.sum()),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "library_build_s_max": float(most),
    }


def build_cfg(args):
    """The workload's config from :func:`add_workload_args`' flags."""
    from repro_torch.configs.base import DPSNNConfig, ExchangeConfig
    from repro_torch.configs.dpsnn import with_family

    gh, gw = (int(v) for v in args.grid.split("x"))
    cfg = DPSNNConfig(grid_h=gh, grid_w=gw,
                      neurons_per_column=args.neurons, seed=args.seed)
    if args.family != "gauss":
        cfg = with_family(cfg, args.family)
    if args.pipelined:
        cfg = dataclasses.replace(cfg,
                                  exchange=ExchangeConfig(pipelined=True))
    return cfg


def add_workload_args(ap: argparse.ArgumentParser) -> None:
    """Workload flags shared by the worker and the launcher CLIs (the
    static flat dense path: STDP, the guard and the other wire formats
    wait for ROADMAP queue 1 items 3, 4 and 6)."""
    from repro_torch.core.network import IMPLS

    ap.add_argument("--grid", default="8x8", help="column grid HxW")
    ap.add_argument("--neurons", type=int, default=64)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--family", default="gauss",
                    choices=["gauss", "exp", "gauss_exp"])
    ap.add_argument("--impl", default="cuda_fused", choices=IMPLS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (every rank on the current card) or cpu "
                         "(the plain versions)")
    ap.add_argument("--pipelined", action="store_true",
                    help="cross-step pipelined halo exchange "
                         "(ExchangeConfig.pipelined)")
    ap.add_argument("--no-compress", dest="compress", action="store_false",
                    help="send float32 strips, not packed words")
    ap.add_argument("--state-dir", default="",
                    help="write each rank's final state to "
                         "STATE_DIR/rank<r>.npz")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="one rank of the multi-process DPSNN runtime")
    ap.add_argument("--rank", type=int,
                    default=int(os.environ.get("DPSNN_RANK", "-1")))
    ap.add_argument("--nranks", type=int,
                    default=int(os.environ.get("DPSNN_NRANKS", "0")))
    ap.add_argument("--coordinator",
                    default=os.environ.get("DPSNN_COORDINATOR", ""))
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a collective may wait before it raises")
    add_workload_args(ap)
    args = ap.parse_args(argv)
    if args.rank < 0 or args.nranks < 1 or not args.coordinator:
        ap.error("--rank/--nranks/--coordinator (or DPSNN_RANK/"
                 "DPSNN_NRANKS/DPSNN_COORDINATOR) are required")

    import torch.distributed as dist

    cfg = build_cfg(args)
    init_worker(args.rank, args.nranks, args.coordinator, args.timeout)
    try:
        out = worker_run(cfg, args.steps, impl=args.impl,
                         compress=args.compress, device=args.device,
                         state_dir=args.state_dir)
    finally:
        dist.destroy_process_group()
    if args.rank == 0:
        print(RESULT_TAG + json.dumps(out, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
