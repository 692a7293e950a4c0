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
* ``--stdp`` runs the plastic step: the pre-trace halo rides every wire
  beside the spikes, and with ``--state-dir`` each rank saves its live
  weights and traces with the rest of its state.
* ``--checkpoint-every K --ckpt-dir DIR`` runs supervised
  (:func:`worker_run_supervised`, driven by the launcher's
  ``--supervise``): chunks between checkpoints, heartbeats, a restore
  (resharded when the rank count changed) from the latest checkpoint,
  and the chaos flags that kill a rank (``--chaos-kill-rank``,
  ``--chaos-at-step``) or corrupt the run (``--chaos-flip-bit``,
  ``--chaos-nan-at-step``, with ``--guard``, which frames every halo
  message with a checksum and exits with ``integrity.GUARD_EXIT_CODE``
  when the guard trips).
* ``--batch B`` runs the batched multi-tenant service over the ranks
  (:func:`worker_run_batched`): B tenants of seeds ``seed .. seed+B-1``
  share the network, and ``--batch-shards K`` splits the ranks
  batch-major into K batch shards of B / K tenants each, every shard a
  full spatial grid (:func:`make_batched_process_mesh`). Per-tenant
  totals reach every rank; with ``--state-dir`` each rank saves each of
  its tenants' state apart (:func:`tenant_state_dir`).

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
    (leaves of ``convert.dist_state_to_numpy``, the plastic ones under
    STDP)."""
    from repro_torch import convert

    os.makedirs(state_dir, exist_ok=True)
    np.savez(os.path.join(state_dir, f"rank{rank}.npz"),
             **convert.dist_state_to_numpy(state))


def tenant_state_dir(state_dir: str, tenant: int) -> str:
    """Where a batched run's ranks save tenant ``tenant``'s state: one
    ``rank<s>.npz`` per spatial rank s, as :func:`save_state` writes a
    single-tenant run's, so :func:`load_states` reads it back."""
    return os.path.join(state_dir, f"tenant{tenant}")


def load_states(state_dir: str, n_ranks: int) -> dict:
    """The ranks' saved states stacked in rank (= process-major shard)
    order: the layout of an in-process mesh's state."""
    parts = [np.load(os.path.join(state_dir, f"rank{r}.npz"))
             for r in range(n_ranks)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0].files}


def _share_cores(dev) -> None:
    """On the CPU the ranks share the host's cores: at most a fair share
    of threads each, and at most what the environment allows
    (OMP_NUM_THREADS)."""
    import torch
    import torch.distributed as dist

    if dev.type == "cpu":
        share = (os.cpu_count() or 1) // dist.get_world_size()
        torch.set_num_threads(max(1, min(share, torch.get_num_threads())))


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dir_bytes(path: str) -> int:
    """Bytes of the files directly under ``path`` (0 if it is missing)."""
    try:
        return sum(e.stat().st_size for e in os.scandir(path) if e.is_file())
    except FileNotFoundError:
        return 0


def _write_heartbeat(hb_dir: str, rank: int, step: int, *,
                     step_ewma_s: float | None = None,
                     straggler: bool = False) -> None:
    """Publish this rank's progress atomically (``hb_dir/rank<r>.json``,
    written then renamed, so a kill mid-write never leaves torn JSON):
    the supervisor reads the furthest step for its ``lost_steps``, and
    the watchdog's verdict (``step_ewma_s``, ``straggler``) names a slow
    rank."""
    os.makedirs(hb_dir, exist_ok=True)
    path = os.path.join(hb_dir, f"rank{rank}.json")
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"rank": rank, "step": step, "pid": os.getpid(),
                   "wall": time.time(), "step_ewma_s": step_ewma_s,
                   "straggler": bool(straggler)}, f)
    os.replace(tmp, path)


def worker_run_supervised(cfg, total_steps: int, *, checkpoint_every: int,
                          ckpt_dir: str, impl: str = "cuda_fused",
                          compress: bool = True, device="cuda",
                          chaos_kill_rank: int = -1,
                          chaos_at_step: int = -1) -> dict:
    """Supervised run on the ranks (the reference's function of the same
    name): chunks whose boundaries are the multiples of
    ``checkpoint_every``, ``chaos_at_step`` and ``total_steps`` (the same
    on every rank), with a heartbeat at each boundary.

    Between chunks every rank holds the whole stacked state on the host
    (``make_distributed_run(..., replicate_state=True)``, a gloo
    all-gather), so rank 0 saves it whole in the reference's format and
    any rank set restores it: a checkpoint written by another rank count
    is restored for the writer's tiling and re-tiled through
    ``checkpointer.reshard``. The counters ride the state as exact
    per-shard partial sums, so a resumed (even resized) run's totals are
    the uninterrupted run's.

    ``chaos_kill_rank`` SIGKILLs itself at boundary ``chaos_at_step``,
    after its heartbeat and before any save there. Under the guard a
    tripped verdict (every rank sees the same gathered guard) aborts
    with ``integrity.GUARD_EXIT_CODE`` before the poisoned range is
    saved; each injection step (``chaos_flip_step``,
    ``chaos_nan_at_step``) gets a boundary one step later. A
    ``StragglerWatchdog`` observes each chunk's per-step wall time. The
    row has the reference's keys and no ``step_ms``: its wall time
    includes the checkpoint IO; ``save_s`` times rank 0's saves and
    ``checkpoint_bytes`` is the final checkpoint's size on disk."""
    import signal

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.core import exchange
    from repro_torch.core.partition import make_tile_spec
    from repro_torch.runtime import integrity
    from repro_torch.runtime.fault_tolerance import (CheckpointPolicy,
                                                     StragglerWatchdog)
    from repro_torch.runtime.transport import ProcessGroupMesh

    mesh = ProcessGroupMesh(device, compress=compress)
    _share_cores(mesh.device)
    rank, n_ranks = dist.get_rank(), dist.get_world_size()
    spec = make_tile_spec(cfg, *mesh.shape)
    hb_dir = os.path.join(ckpt_dir, "hb")
    meta = {"mesh": [spec.tiles_y, spec.tiles_x], "n_ranks": n_ranks,
            "grid": [cfg.grid_h, cfg.grid_w], "stdp": cfg.stdp,
            "total_steps": total_steps}
    params = exchange.build_shard(cfg, spec, mesh)

    def runner(n):
        return exchange.make_distributed_run(
            cfg, mesh, n_steps=n, impl=impl, replicate_state=True,
            params=params)[0]

    # ---- restore (across a change of rank count too) ------------------
    start, resumed_from, stacked = 0, -1, None
    saved_step = ckpt.latest_step(ckpt_dir)
    if saved_step is not None:
        man = ckpt.load_manifest(ckpt_dir, saved_step)
        tpl, saved_spec, _ = exchange.stacked_state_template(
            cfg, man["meta"]["n_ranks"])
        if tuple(man["meta"]["mesh"]) == (spec.tiles_y, spec.tiles_x):
            stacked, start = ckpt.restore(
                ckpt_dir, tpl, saved_step,
                expect_mesh=(spec.tiles_y, spec.tiles_x))
        else:
            # restore for the writer's tiling, then re-tile for ours
            stacked, start = ckpt.restore(ckpt_dir, tpl, saved_step)
            stacked = ckpt.reshard(stacked, saved_spec, spec)
        resumed_from = start
    if stacked is None:
        _, stacked = runner(0)()

    # ---- the chunk schedule, the same on every rank --------------------
    bounds = set(range(checkpoint_every, total_steps, checkpoint_every))
    if start < chaos_at_step < total_steps:
        bounds.add(chaos_at_step)
    gcfg = cfg.guard
    if gcfg.enabled:
        # the guard latches at the corrupt step; abort one step later
        for cs in (gcfg.chaos_flip_step, gcfg.chaos_nan_at_step):
            if start <= cs < total_steps:
                bounds.add(cs + 1)
    bounds.add(total_steps)
    bounds = [b for b in sorted(bounds) if b > start]

    runners = {}
    policy = CheckpointPolicy(ckpt_dir, every_steps=checkpoint_every,
                              async_save=False, meta=meta)
    watchdog = StragglerWatchdog()
    save_s = []            # rank 0's seconds per save
    wall0 = time.perf_counter()
    cur = start
    _write_heartbeat(hb_dir, rank, cur)
    for b in bounds:
        t0 = time.perf_counter()
        if b - cur not in runners:
            runners[b - cur] = runner(b - cur)
        _, stacked = runners[b - cur](stacked)
        straggler = watchdog.observe(
            b, (time.perf_counter() - t0) / max(b - cur, 1))
        cur = b
        _write_heartbeat(hb_dir, rank, cur, step_ewma_s=watchdog.ewma,
                         straggler=straggler)
        # the verdict gates the save: some state since the last clean
        # checkpoint is poisoned, so abort and let the supervisor roll
        # back; every rank holds the same gathered guard
        if gcfg.enabled and bool(stacked.guard.tripped.any()):
            if rank == 0:
                rep = integrity.guard_report(stacked.guard)
                print("DPSNN-GUARD " + json.dumps(rep, sort_keys=True),
                      file=sys.stderr, flush=True)
            sys.exit(integrity.GUARD_EXIT_CODE)
        if rank == chaos_kill_rank and cur == chaos_at_step:
            os.kill(os.getpid(), signal.SIGKILL)
        if rank == 0:
            s0 = time.perf_counter()
            saved = policy.maybe_save(cur, stacked)
            if not saved and cur == total_steps:
                os.makedirs(ckpt_dir, exist_ok=True)
                ckpt.save(ckpt_dir, cur, stacked, meta=meta)
                saved = True
            if saved:
                save_s.append(time.perf_counter() - s0)
    wall_s = time.perf_counter() - wall0

    # ---- metrics from the gathered final state -------------------------
    # the counters are per-shard partial sums since t = 0 (they ride the
    # checkpoint), so the totals cover the whole run
    def total(x):
        return float(np.sum(np.asarray(x, np.float64)))

    spikes, events = total(stacked.spike_count), total(stacked.event_count)
    isi_n = total(stacked.isi_count)
    isi_mean = total(stacked.isi_sum) / isi_n if isi_n else 0.0
    isi_var = (max(total(stacked.isi_sumsq) / isi_n - isi_mean ** 2, 0.0)
               if isi_n else 0.0)
    isi_cv = (isi_var ** 0.5) / isi_mean if isi_mean else 0.0
    sim_s = total_steps * cfg.neuron.dt_ms * 1e-3
    guard_row = {"guard": gcfg.enabled,
                 "straggler_steps": watchdog.stragglers,
                 "step_ewma_s": watchdog.ewma or 0.0}
    if gcfg.enabled:
        guard_row.update(integrity.guard_report(stacked.guard))
    return {
        **guard_row,
        "rank_count": n_ranks,
        "process_grid": list(mesh.shape),
        "grid": f"{cfg.grid_h}x{cfg.grid_w}",
        "neurons": cfg.n_neurons,
        "tile": f"{spec.tile_h}x{spec.tile_w}",
        "steps": total_steps,
        "wall_s": wall_s,
        "spikes": spikes,
        "events": events,
        "rate_hz": spikes / (cfg.n_neurons * sim_s),
        "isi_mean_steps": isi_mean,
        "isi_cv": isi_cv,
        "resumed_from_step": resumed_from,
        "checkpoint_every": checkpoint_every,
        # rank 0's saves in this attempt, and the last one's size
        "save_s": save_s,
        "checkpoint_bytes": _dir_bytes(os.path.join(
            ckpt_dir, f"step_{total_steps:09d}")),
        "supervised": True,
        "impl": impl,
        "compress": compress,
        "stdp": cfg.stdp,
        "pipelined": cfg.exchange.pipelined,
        "exchange_mode": cfg.conn.exchange_mode,
        "device": (torch.cuda.get_device_name(mesh.device)
                   if mesh.device.type == "cuda" else "cpu"),
    }


def worker_run(cfg, n_steps: int, *, impl: str = "cuda_fused",
               compress: bool = True, device="cuda",
               state_dir: str = "", ranks_per_node: int = 0) -> dict:
    """Build and run this rank's shard on the process grid (with
    ``ranks_per_node``, in node groups under the hierarchical exchange);
    return the paper's metrics (totals all-reduced, so every rank returns
    the same), with the byte split of the node level under
    ``ranks_per_node`` (``compression.hier_payload_bytes``) and, under
    the guard, every shard's verdict (``integrity.guard_report``).

    Timing: one untimed run warms the card and the connections; then one
    run is timed end to end (every rank waits for the all-reduced
    totals, so the wall time holds every message of every step). The
    row also gives rank 0's kernel launches in the timed run and, on the
    card, its peak memory.
    """
    import torch
    import torch.distributed as dist

    from repro_torch.core import exchange
    from repro_torch.core.batched import map_leaves
    from repro_torch.kernels import ops
    from repro_torch.runtime import integrity
    from repro_torch.runtime.compression import (halo_payload_bytes,
                                                 hier_payload_bytes)
    from repro_torch.runtime.transport import ProcessGroupMesh

    mesh = ProcessGroupMesh(device, compress=compress,
                            ranks_per_node=ranks_per_node)
    dev = mesh.device
    _share_cores(dev)
    build_s = ops.library().build_seconds if dev.type == "cuda" else 0.0
    run, spec = exchange.make_distributed_run(
        cfg, mesh, n_steps=n_steps, impl=impl, with_state=True)
    run()                            # warm-up, untimed
    _sync(dev)
    dist.barrier()
    ops.reset_launches()
    t0 = time.perf_counter()
    res, final = run()
    _sync(dev)
    wall_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
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
    guard_row = {}
    if cfg.guard.enabled:      # every shard's verdict, on every rank
        guard_row = integrity.guard_report(map_leaves(
            lambda x: mesh.gather(x).numpy(), final.guard))
    return {
        "rank_count": dist.get_world_size(),
        "process_grid": list(mesh.shape),
        **hier_row,
        **guard_row,
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
        "stdp": cfg.stdp,
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
        "launches": launches,
        "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if dev.type == "cuda" else None),
        "library_build_s_max": float(most),
    }


def make_batched_process_mesh(batch_shards: int, *, device="cuda",
                              compress: bool = True):
    """The batched service's transport over the default process group:
    the tenant axis shards over ``batch_shards`` process groups, each
    running the spatial process grid of ``world / batch_shards`` ranks
    (a ``ProcessGroupMesh`` with ``batch_shards``). Placement is
    batch-major, process-major: ranks ``[k*S, (k+1)*S)`` form batch
    shard k, so every halo message stays inside a batch shard and the
    tenant axis never appears in a spike message; only the per-tenant
    totals cross it. Raises with the reference's text when the shards do
    not divide the ranks."""
    import torch.distributed as dist

    from repro_torch.core.partition import batch_ranks, process_grid
    from repro_torch.runtime.sharding import service_mesh

    spatial = batch_ranks(dist.get_world_size(), batch_shards)
    return service_mesh(batch_shards, *process_grid(spatial), device,
                        compress=compress)


def worker_run_batched(cfg, n_steps: int, *, batch: int,
                       batch_shards: int = 1, impl: str = "cuda_fused",
                       compress: bool = True, device="cuda",
                       state_dir: str = "") -> dict:
    """Batched multi-tenant run on the ranks
    (``exchange.make_batched_distributed_run``): ``batch`` tenants with
    seeds ``cfg.seed + i`` share one network; the per-tenant totals reach
    every rank, so the launcher can hold each tenant against its
    dedicated single-process run. With ``state_dir`` each rank saves each
    of its tenants' final state under :func:`tenant_state_dir`.

    Timing as :func:`worker_run`: one untimed run, then one timed end to
    end. The row has the reference's per-tenant keys, and rank 0's
    launches in the timed run and, on the card, its peak memory."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import exchange
    from repro_torch.core.batched import map_leaves
    from repro_torch.kernels import ops
    from repro_torch.runtime.compression import halo_payload_bytes
    from repro_torch.runtime.sharding import local_tenants

    mesh = make_batched_process_mesh(batch_shards, device=device,
                                     compress=compress)
    dev = mesh.device
    _share_cores(dev)
    build_s = ops.library().build_seconds if dev.type == "cuda" else 0.0
    run, spec = exchange.make_batched_distributed_run(
        cfg, mesh, n_steps=n_steps, batch=batch, impl=impl, with_state=True)
    seeds = [cfg.seed + i for i in range(batch)]
    run(seeds)                       # warm-up, untimed
    _sync(dev)
    dist.barrier()
    ops.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res, final = run(seeds)
    _sync(dev)
    wall_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    most = torch.tensor([build_s], dtype=torch.float64)
    dist.all_reduce(most, op=dist.ReduceOp.MAX)
    if state_dir:
        for j, i in enumerate(local_tenants(mesh, batch)):
            save_state(tenant_state_dir(state_dir, i), mesh.rank,
                       map_leaves(lambda x, j=j: x[:, j], final))
    per_spikes = [float(x) for x in res.spikes]
    per_events = [float(x) for x in res.events]
    events = sum(per_events)
    acct_mode = ("auto" if cfg.exchange.exchange_mode == "auto"
                 else cfg.conn.exchange_mode)
    payload = halo_payload_bytes(cfg, spec, mode=acct_mode,
                                 compress=compress)
    sat = res.aer_saturated.cpu()
    return {
        "rank_count": dist.get_world_size(),
        "batch_size": batch,
        "batch_shards": batch_shards,
        "process_grid": [batch_shards, *mesh.shape],
        "grid": f"{cfg.grid_h}x{cfg.grid_w}",
        "neurons": cfg.n_neurons,
        "tile": f"{spec.tile_h}x{spec.tile_w}",
        "steps": n_steps,
        "wall_s": wall_s,
        "step_ms": wall_s / n_steps * 1e3,
        "spikes": sum(per_spikes),
        "events": events,
        "events_per_s": events / max(wall_s, 1e-12),
        "events_per_s_per_tenant": events / max(wall_s, 1e-12) / batch,
        "per_tenant_spikes": per_spikes,
        "per_tenant_events": per_events,
        "tenant_seeds": seeds,
        "impl": impl,
        "compress": compress,
        "stdp": cfg.stdp,
        "guard": cfg.guard.enabled,
        "pipelined": cfg.exchange.pipelined,
        "exchange_mode": acct_mode,
        # one tenant's strips; a rank's messages carry b_local of them
        "halo_payload_bytes_per_step": payload["bytes_per_step"],
        "aer_saturated_steps": int(sat.sum()),
        "aer_saturated_per_step": sat.tolist(),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "launches": launches,
        "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if dev.type == "cuda" else None),
        "library_build_s_max": float(most),
    }


def build_cfg(args):
    """The workload's config from :func:`add_workload_args`' flags."""
    from repro_torch.configs.base import (DPSNNConfig, ExchangeConfig,
                                          GuardConfig)
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
    if args.stdp:
        cfg = dataclasses.replace(cfg, stdp=True)
    if args.pipelined or args.exchange_mode == "auto":
        cfg = dataclasses.replace(cfg, exchange=ExchangeConfig(
            pipelined=args.pipelined,
            exchange_mode=("auto" if args.exchange_mode == "auto"
                           else "inherit")))
    if args.guard:
        cfg = dataclasses.replace(cfg, guard=GuardConfig(enabled=True))
    return cfg


def with_chaos(cfg, flip_bit: str = "", nan_at_step: int = -1):
    """``cfg``'s guard with the worker's integrity chaos: ``flip_bit``
    ``"RING:STEP:WORD"`` and ``nan_at_step`` (kept out of
    :func:`build_cfg`, so that the single-process reference is built
    without them). Raises ValueError for a malformed ``flip_bit``."""
    kw = {}
    if flip_bit:
        try:
            ring, fstep, word = (int(v) for v in flip_bit.split(":"))
        except ValueError:
            raise ValueError("--chaos-flip-bit wants RING:STEP:WORD "
                             "(three integers)") from None
        kw.update(chaos_flip_ring=ring, chaos_flip_step=fstep,
                  chaos_flip_word=word)
    if nan_at_step >= 0:
        kw["chaos_nan_at_step"] = nan_at_step
    return dataclasses.replace(cfg, guard=dataclasses.replace(cfg.guard,
                                                              **kw))


def add_workload_args(ap: argparse.ArgumentParser) -> None:
    """Workload flags shared by the worker and the launcher CLIs (static
    or, with ``--stdp``, plastic; with ``--guard``, guarded)."""
    from repro_torch.core.network import IMPLS

    ap.add_argument("--grid", default="8x8", help="column grid HxW")
    ap.add_argument("--neurons", type=int, default=64)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--family", default="gauss",
                    choices=["gauss", "exp", "gauss_exp"])
    ap.add_argument("--radius", type=int, default=0,
                    help="override the family's stencil bound (0 = keep)")
    ap.add_argument("--stdp", action="store_true",
                    help="plasticity on (STDPConfig defaults)")
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
                         "STATE_DIR/rank<r>.npz (with --batch each "
                         "tenant's to STATE_DIR/tenant<i>/rank<s>.npz)")
    ap.add_argument("--batch", type=int, default=0,
                    help="batched service mode: run this many tenants "
                         "with seeds seed..seed+B-1 (0 = single-tenant)")
    ap.add_argument("--batch-shards", type=int, default=1,
                    help="shard the tenant axis over this many process "
                         "groups (must divide --batch and the rank count)")
    ap.add_argument("--guard", action="store_true",
                    help="the in-band integrity guard: invariant monitors "
                         "and checksummed halo frames (bitwise neutral "
                         "on a healthy run)")


def add_chaos_args(ap: argparse.ArgumentParser) -> None:
    """The supervised mode's flags and its chaos (the worker's; the
    launcher adds its own help)."""
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="supervised mode: checkpoint cadence in steps "
                         "(0 = plain unsupervised run)")
    ap.add_argument("--ckpt-dir", default="",
                    help="supervised mode: checkpoint and heartbeat dir")
    ap.add_argument("--chaos-kill-rank", type=int, default=-1,
                    help="fault injection: this rank SIGKILLs itself ...")
    ap.add_argument("--chaos-at-step", type=int, default=-1,
                    help="... at this chunk boundary")
    ap.add_argument("--chaos-flip-bit", default="",
                    metavar="RING:STEP:WORD",
                    help="integrity chaos: XOR one bit into the received "
                         "payload of halo send ordinal RING at step STEP, "
                         "word WORD (requires --guard)")
    ap.add_argument("--chaos-nan-at-step", type=int, default=-1,
                    help="integrity chaos: poison one membrane voltage "
                         "with NaN at this step (requires --guard)")


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
    add_chaos_args(ap)
    args = ap.parse_args(argv)
    if args.rank < 0 or args.nranks < 1 or not args.coordinator:
        ap.error("--rank/--nranks/--coordinator (or DPSNN_RANK/"
                 "DPSNN_NRANKS/DPSNN_COORDINATOR) are required")
    if args.checkpoint_every and not args.ckpt_dir:
        ap.error("--checkpoint-every requires --ckpt-dir")
    if args.ranks_per_node and (args.batch or args.checkpoint_every):
        ap.error("--ranks-per-node applies to the plain distributed run "
                 "only (not --batch / supervised mode)")
    if args.checkpoint_every and args.batch:
        ap.error("supervised mode does not support --batch yet")

    import torch.distributed as dist

    cfg = build_cfg(args)
    if args.chaos_flip_bit or args.chaos_nan_at_step >= 0:
        if not cfg.guard.enabled:
            ap.error("--chaos-flip-bit / --chaos-nan-at-step require "
                     "--guard")
        try:
            cfg = with_chaos(cfg, args.chaos_flip_bit,
                             args.chaos_nan_at_step)
        except ValueError as err:
            ap.error(str(err))
    init_worker(args.rank, args.nranks, args.coordinator, args.timeout)
    try:
        if args.checkpoint_every:
            out = worker_run_supervised(
                cfg, args.steps, checkpoint_every=args.checkpoint_every,
                ckpt_dir=args.ckpt_dir, impl=args.impl,
                compress=args.compress, device=args.device,
                chaos_kill_rank=args.chaos_kill_rank,
                chaos_at_step=args.chaos_at_step)
        elif args.batch:
            out = worker_run_batched(
                cfg, args.steps, batch=args.batch,
                batch_shards=args.batch_shards, impl=args.impl,
                compress=args.compress, device=args.device,
                state_dir=args.state_dir)
        else:
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
