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
* ``--exchange-mode`` picks the halo's wire format (``dense_packed``,
  the paper's ``aer_sparse`` event lists, or ``auto`` per ring), and
  ``--ranks-per-node g`` groups g consecutive ranks into nodes and runs
  the hierarchical two-level exchange (``partition.make_node_spec``):
  the node's ranks all-gather their tiles, the lane-(0,0) corner ranks
  of neighbouring nodes exchange the node strips, and each corner
  broadcasts what it received to its node.

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
               state_dir: str = "", ranks_per_node: int = 0) -> dict:
    """Build and run this rank's shard on the process grid (with
    ``ranks_per_node``, in node groups under the hierarchical exchange);
    return the paper's metrics (totals all-reduced, so every rank returns
    the same), with the byte split of the node level under
    ``ranks_per_node`` (``compression.hier_payload_bytes``).

    Timing: one untimed run warms the card and the connections; then one
    run is timed end to end (every rank waits for the all-reduced
    totals, so the wall time holds every message of every step).
    """
    import torch
    import torch.distributed as dist

    from repro_torch.core import exchange
    from repro_torch.kernels import ops
    from repro_torch.runtime.compression import (halo_payload_bytes,
                                                 hier_payload_bytes)
    from repro_torch.runtime.transport import ProcessGroupMesh

    mesh = ProcessGroupMesh(device, compress=compress,
                            ranks_per_node=ranks_per_node)
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
    policy_auto = cfg.exchange.exchange_mode == "auto"
    acct_mode = "auto" if policy_auto else cfg.conn.exchange_mode
    hier_row = {}
    if mesh.node is not None:
        payload = hier_payload_bytes(cfg, spec, mesh.node, mode=acct_mode,
                                     compress=compress)
        hier_row = {
            "ranks_per_node": mesh.node.ranks_per_node,
            "node_grid": payload["node_grid"],
            "inter_node_bytes_per_node": payload[
                "inter_node_bytes_per_node"],
            "inter_node_messages_per_node": payload[
                "inter_node_messages_per_node"],
            "intra_node_bytes_per_rank": payload[
                "intra_node_bytes_per_rank"],
            "per_ring_modes": [
                {"phase": e["phase"], "ring": e["ring"],
                 "mode": e["mode"] if policy_auto else acct_mode}
                for e in payload["per_ring"]],
        }
    else:
        payload = halo_payload_bytes(cfg, spec, mode=acct_mode,
                                     compress=compress)
    sat = res.aer_saturated.cpu()
    return {
        "rank_count": dist.get_world_size(),
        "process_grid": list(mesh.shape),
        **hier_row,
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
        # "auto" marks the per-ring policy, else the uniform wire format
        "exchange_mode": acct_mode,
        "halo_payload_bytes_per_step": payload["bytes_per_step"],
        # steps on which a send of some rank overflowed its event list
        # (spikes truncated from the wire, flagged); 0 under dense_packed
        "aer_saturated_steps": int(sat.sum()),
        "aer_saturated_per_step": sat.tolist(),
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
    if args.radius:
        cfg = dataclasses.replace(
            cfg, conn=dataclasses.replace(cfg.conn, radius=args.radius))
    # "auto" is a selection policy (ExchangeConfig), not a wire format:
    # conn.exchange_mode keeps its uniform meaning, and the rate bound
    # still sizes the capacities of the rings auto sends as AER
    if args.exchange_mode == "aer_sparse" or args.aer_rate_bound:
        conn_kw = {}
        if args.exchange_mode == "aer_sparse":
            conn_kw["exchange_mode"] = args.exchange_mode
        if args.aer_rate_bound:
            conn_kw["aer_rate_bound_hz"] = args.aer_rate_bound
        if args.aer_capacity_factor:
            conn_kw["aer_capacity_factor"] = args.aer_capacity_factor
        cfg = dataclasses.replace(
            cfg, conn=dataclasses.replace(cfg.conn, **conn_kw))
    if args.pipelined or args.exchange_mode == "auto":
        cfg = dataclasses.replace(cfg, exchange=ExchangeConfig(
            pipelined=args.pipelined,
            exchange_mode=("auto" if args.exchange_mode == "auto"
                           else "inherit")))
    return cfg


def add_workload_args(ap: argparse.ArgumentParser) -> None:
    """Workload flags shared by the worker and the launcher CLIs (the
    static step: STDP and the guard wait for ROADMAP queue 1 items 4 and
    6)."""
    from repro_torch.core.network import IMPLS

    ap.add_argument("--grid", default="8x8", help="column grid HxW")
    ap.add_argument("--neurons", type=int, default=64)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--family", default="gauss",
                    choices=["gauss", "exp", "gauss_exp"])
    ap.add_argument("--radius", type=int, default=0,
                    help="override the family's stencil bound (0 = keep)")
    ap.add_argument("--impl", default="cuda_fused", choices=IMPLS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (every rank on the current card) or cpu "
                         "(the plain versions)")
    ap.add_argument("--pipelined", action="store_true",
                    help="cross-step pipelined halo exchange "
                         "(ExchangeConfig.pipelined)")
    ap.add_argument("--no-compress", dest="compress", action="store_false",
                    help="send float32 strips, not packed words")
    ap.add_argument("--exchange-mode", default="dense_packed",
                    choices=["dense_packed", "aer_sparse", "auto"],
                    help="spike-halo wire format; 'auto' picks per ring "
                         "from the exact byte accounting")
    ap.add_argument("--aer-rate-bound", type=float, default=0.0,
                    help="AER capacity rate bound in Hz "
                         "(0 = config default)")
    ap.add_argument("--aer-capacity-factor", type=float, default=0.0,
                    help="AER capacity safety factor (0 = config default)")
    ap.add_argument("--ranks-per-node", type=int, default=0,
                    help="group this many consecutive ranks into node "
                         "groups and run the hierarchical two-level halo "
                         "exchange (0 = flat)")
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
                         state_dir=args.state_dir,
                         ranks_per_node=args.ranks_per_node)
    finally:
        dist.destroy_process_group()
    if args.rank == 0:
        print(RESULT_TAG + json.dumps(out, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
