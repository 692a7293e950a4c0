"""Spawn-N-processes launcher for the multi-process DPSNN runtime (the
port of ``repro/launch/launch_distributed.py``).

The single-machine analogue of the paper's ``mpirun -np N``: spawns N
worker processes (``repro_torch.runtime.multiprocess``), wires them to a
fresh gloo rendezvous on a free localhost port, waits for the job, then
re-runs the same workload single-process in this process and asserts
that the totals are bitwise equal (the determinism per column
id that makes every scaling measurement trustworthy).

    PYTHONPATH=src python -m repro_torch.launch.launch_distributed \
        --ranks 4 [--device cpu] [--state-dir DIR] [--stdp] [--guard] \
        [--exchange-mode aer_sparse|auto] [--ranks-per-node 2] \
        [--batch 2 [--batch-shards 2]]

    PYTHONPATH=src python -m repro_torch.launch.launch_distributed \
        --ranks 2 --grid 4x4 --neurons 16 --steps 40 --supervise \
        --checkpoint-every 10 --chaos-kill-rank 1 --chaos-at-step 25 \
        [--restart-ranks 1] [--guard --chaos-flip-bit 0:25:3] \
        [--ckpt-dir DIR] --device cpu

Events compare bitwise while every float32 accumulator holds an exact
integer (a total below 2**24); past that, how the total was split over
shards sets its rounding, and they are held to a relative 1e-6. With
``--state-dir`` the ranks write their final states there and the
membrane potentials are compared bitwise too, and under ``--stdp`` the
live weights and traces (``w_local``, ``rem_w``, ``x_pre``,
``x_post``). With ``--batch B`` the ranks run the batched service (B
tenants of seeds ``seed .. seed+B-1`` on one network, over
``--batch-shards`` batch shards of the ranks), and the check is per
tenant, against B dedicated single-tenant single-process runs: spikes,
events, and with ``--state-dir`` each tenant's final leaves. An AER run
whose event lists overflowed says so first (it is expected to differ).
A node group shape that ``partition.make_node_spec`` rejects, and a
tenant split that does not divide, fail before any rank spawns. The
exit status is non-zero on a worker failure, a timeout or a mismatch.

With ``--supervise`` (:func:`supervise`) the ranks run chunked with a
checkpoint every ``--checkpoint-every`` steps under ``--ckpt-dir`` (the
reference's format) and a heartbeat per chunk. When a rank dies, the
heartbeats stall, or the guard trips (``--guard``; the rank exits with
``integrity.GUARD_EXIT_CODE``), the supervisor sweeps the orphaned
stages, counts the steps lost since the last checkpoint and relaunches
(on ``--restart-ranks`` ranks when given: the checkpoint is resharded),
without the chaos flags, which fire on the first attempt only. The row
gains ``restarts``, ``lost_steps`` and ``supervised_wall_s``, and the
check holds the totals (and, from the final checkpoint, v and the
plastic leaves) to the single process.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

from repro_torch.core.partition import (batch_ranks, columns_to_global,
                                        make_node_spec, make_rank_tile_spec,
                                        process_grid)
from repro_torch.runtime.multiprocess import (RESULT_TAG, add_workload_args,
                                              build_cfg, load_states,
                                              tenant_state_dir)
from repro_torch.runtime.sharding import tenants_per_shard

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
EXACT = 2 ** 24          # float32 holds every integer below this
EVENTS_RTOL = 1e-6
# the final-state leaves the check compares bitwise (with --state-dir),
# the last four under --stdp only
STATE_LEAVES = ("v", "w_local", "rem_w", "x_pre", "x_post")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_argv(args) -> list:
    argv = ["--grid", args.grid, "--neurons", str(args.neurons),
            "--steps", str(args.steps), "--seed", str(args.seed),
            "--family", args.family, "--impl", args.impl,
            "--device", args.device, "--timeout", str(args.timeout),
            "--exchange-mode", args.exchange_mode]
    if args.radius:
        argv += ["--radius", str(args.radius)]
    if args.aer_rate_bound:
        argv += ["--aer-rate-bound", str(args.aer_rate_bound)]
    if args.aer_capacity_factor:
        argv += ["--aer-capacity-factor", str(args.aer_capacity_factor)]
    if args.ranks_per_node:
        argv += ["--ranks-per-node", str(args.ranks_per_node)]
    if args.pipelined:
        argv.append("--pipelined")
    if args.stdp:
        argv.append("--stdp")
    if not args.compress:
        argv.append("--no-compress")
    if args.state_dir:
        argv += ["--state-dir", args.state_dir]
    if args.batch:
        argv += ["--batch", str(args.batch),
                 "--batch-shards", str(args.batch_shards)]
    if args.guard:
        argv.append("--guard")
    return argv


def _hb_last_activity(hb_dir: str) -> float:
    """The newest heartbeat file's mtime under ``hb_dir`` (0.0 if none)."""
    latest = 0.0
    try:
        names = os.listdir(hb_dir)
    except FileNotFoundError:
        return latest
    for name in names:
        if name.startswith("rank") and name.endswith(".json"):
            try:
                latest = max(latest,
                             os.path.getmtime(os.path.join(hb_dir, name)))
            except FileNotFoundError:
                pass
    return latest


def _max_heartbeat_step(hb_dir: str) -> int:
    """The furthest chunk boundary any rank reported (0 if none)."""
    best = 0
    try:
        names = os.listdir(hb_dir)
    except FileNotFoundError:
        return best
    for name in names:
        if name.startswith("rank") and name.endswith(".json"):
            try:
                with open(os.path.join(hb_dir, name)) as f:
                    best = max(best, int(json.load(f).get("step", 0)))
            except (OSError, ValueError):
                pass
    return best


def launch(args, *, ranks=None, extra=None, hb_dir=None,
           hb_timeout=0) -> dict:
    """Spawn ``args.ranks`` workers (``ranks`` when given) and return
    rank 0's metrics row; ``extra`` are more worker flags (the
    supervisor's checkpoint and chaos flags).

    Workers write stdout/stderr to temp files rather than pipes: an
    undrained pipe would block a chatty rank mid-exchange. All ranks are
    polled: the first to exit non-zero is the diagnosis and the rest are
    killed; ranks still running after ``args.timeout`` seconds are
    killed and named in the error. With ``hb_dir`` and ``hb_timeout`` the
    job also fails when no rank has advanced a chunk boundary for
    ``hb_timeout`` seconds (a hung rank, not a dead one).
    """
    n_ranks = ranks or args.ranks
    coordinator = f"127.0.0.1:{args.port or free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    wargv = worker_argv(args) + list(extra or ())
    with tempfile.TemporaryDirectory(prefix="dpsnn-mp-") as tmp:
        procs = []
        first_failed = None   # (rank, returncode) of the first death
        t0 = time.time()
        try:
            for rank in range(n_ranks):
                out_f = open(os.path.join(tmp, f"rank{rank}.out"), "w+")
                err_f = open(os.path.join(tmp, f"rank{rank}.err"), "w+")
                procs.append((subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.runtime.multiprocess",
                     "--rank", str(rank), "--nranks", str(n_ranks),
                     "--coordinator", coordinator, *wargv],
                    stdout=out_f, stderr=err_f, text=True, env=env,
                ), out_f, err_f))
            deadline = time.monotonic() + args.timeout
            pending = set(range(n_ranks))
            while pending:
                for rank in sorted(pending):
                    p = procs[rank][0]
                    if p.poll() is not None:
                        pending.discard(rank)
                        if p.returncode != 0 and first_failed is None:
                            first_failed = (rank, p.returncode)
                if first_failed is not None:
                    break
                if pending and time.monotonic() > deadline:
                    raise RuntimeError(
                        f"ranks {sorted(pending)} of {n_ranks} timed out "
                        f"after {args.timeout}s")
                if pending and hb_dir and hb_timeout:
                    stalled = time.time() - max(_hb_last_activity(hb_dir),
                                                t0)
                    if stalled > hb_timeout:
                        raise RuntimeError(
                            f"heartbeat stalled: no rank advanced a chunk "
                            f"boundary for {stalled:.0f}s "
                            f"(> --heartbeat-timeout {hb_timeout}s)")
                if pending:
                    time.sleep(0.05)
            outs = []
            for p, out_f, err_f in procs:
                if p.poll() is None:   # survivors of a crashed peer
                    p.kill()
                    p.wait()
                out_f.seek(0)
                err_f.seek(0)
                outs.append((out_f.read(), err_f.read()))
        finally:
            for p, out_f, err_f in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                out_f.close()
                err_f.close()
    if first_failed is not None:
        rank, code = first_failed
        out, err = outs[rank]
        raise RuntimeError(
            f"rank {rank}/{n_ranks} exited {code} (remaining ranks "
            f"killed):\n{out}\n{err}")
    for line in outs[0][0].splitlines():
        if line.startswith(RESULT_TAG):
            return json.loads(line[len(RESULT_TAG):])
    raise RuntimeError(
        f"rank 0 produced no {RESULT_TAG!r} line:\n{outs[0][0]}\n"
        f"{outs[0][1]}")


def _dedicated_run(cfg, params, state, steps: int, impl: str,
                   seed: int | None = None) -> dict:
    """One single-shard run's totals and final leaves (``STATE_LEAVES``
    as numpy (C, N...) in global column order)."""
    from repro_torch.core import simulation as sim

    res = sim.run(cfg, params, state, steps, impl=impl, seed=seed)
    out = {"spikes": float(res.spikes), "events": float(res.events),
           "v": res.state.lif.v}
    if cfg.stdp:
        out.update(w_local=res.params.w_local, rem_w=res.params.rem_w,
                   **res.state.stdp._asdict())
    return {k: x.cpu().numpy() if k in STATE_LEAVES else x
            for k, x in out.items()}


def single_process_reference(args) -> dict:
    """The same workload on one shard in this process (the port's own
    ``simulation.run``): totals, and the final potentials ``v`` as numpy
    (C, N) in global column order, under ``--stdp`` with the final
    weights and traces (``STATE_LEAVES``) in the same order. The single
    shard has no halo, so a ``--pipelined`` workload's reference is the
    plain one (the pipelined schedule is bitwise-equal by
    construction).

    With ``--batch B``: B dedicated single-tenant runs on the network of
    ``cfg.seed``, tenant i's state and drive from seed ``cfg.seed + i``
    (each run under ``"tenants"``, their totals as per-tenant lists)."""
    from repro_torch.configs.base import ExchangeConfig
    from repro_torch.core import network as net
    from repro_torch.core import simulation as sim

    cfg = dataclasses.replace(build_cfg(args), exchange=ExchangeConfig())
    params, state = sim.build(cfg, device=args.device)
    if not args.batch:
        return _dedicated_run(cfg, params, state, args.steps, args.impl)
    runs = []
    for i in range(args.batch):
        seed = cfg.seed + i
        state = net.init_state(cfg, net.column_ids(cfg), device=args.device,
                               seed=seed)
        runs.append(_dedicated_run(cfg, params, state, args.steps,
                                   args.impl, seed=seed))
    return {"spikes": sum(r["spikes"] for r in runs),
            "events": sum(r["events"] for r in runs),
            "per_tenant_spikes": [r["spikes"] for r in runs],
            "per_tenant_events": [r["events"] for r in runs],
            "tenants": runs}


def events_agree(multi: float, single: float) -> bool:
    """Bitwise while the totals are exact float32 integers, else within
    ``EVENTS_RTOL`` (see the module docstring)."""
    if single < EXACT:
        return multi == single
    return abs(multi - single) <= EVENTS_RTOL * single


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="spawn N local ranks of the multi-process DPSNN "
                    "runtime (the paper's mpirun analogue)")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--port", type=int, default=0,
                    help="rendezvous port (0 = pick a free one)")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="wall limit of every rank, seconds")
    ap.add_argument("--json", default="",
                    help="append the metrics row to this JSON-lines file "
                         "('-' prints the row to stdout)")
    # the fault-tolerant supervisor (supervise)
    ap.add_argument("--supervise", action="store_true",
                    help="supervised run: periodic checkpoints, heartbeat "
                         "monitoring, automatic restart from the last "
                         "checkpoint on a worker's death or a guard trip")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="checkpoint cadence in steps (required with "
                         "--supervise)")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: a fresh temp "
                         "dir; pass an existing one to resume a run)")
    ap.add_argument("--heartbeat-timeout", type=float, default=120.0,
                    help="restart when no rank advances a chunk boundary "
                         "for this many seconds")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--restart-ranks", type=int, default=0,
                    help="relaunch on this many ranks after a failure "
                         "(0 = same size; the checkpoint is resharded)")
    ap.add_argument("--chaos-kill-rank", type=int, default=-1,
                    help="fault injection: SIGKILL this rank at "
                         "--chaos-at-step on the first attempt")
    ap.add_argument("--chaos-at-step", type=int, default=-1,
                    help="chunk boundary at which the chaos kill fires")
    ap.add_argument("--chaos-flip-bit", default="",
                    metavar="RING:STEP:WORD",
                    help="integrity chaos (requires --guard --supervise): "
                         "flip one bit in a halo payload on the first "
                         "attempt; the guard detects it, refuses the "
                         "checkpoint, and the restart rolls back clean")
    ap.add_argument("--chaos-nan-at-step", type=int, default=-1,
                    help="integrity chaos (requires --guard --supervise): "
                         "poison one membrane voltage with NaN at this "
                         "step on the first attempt")
    add_workload_args(ap)
    return ap


def refuse_before_spawn(args) -> None:
    """Exit with the reference's text for what no rank could run: node
    groups with ``--batch`` or supervised, a bad node shape, a tenant
    split that does not divide, a supervised ``--batch``, and the
    supervisor's own refusals (:func:`check_supervised`)."""
    if args.ranks_per_node and (args.batch or args.checkpoint_every):
        raise SystemExit("--ranks-per-node applies to the plain distributed "
                         "run only (not --batch / supervised mode)")
    if args.checkpoint_every and args.batch:
        raise SystemExit("supervised mode does not support --batch yet")
    if args.supervise:
        check_supervised(args)
    elif (args.checkpoint_every or args.chaos_kill_rank >= 0
          or args.chaos_flip_bit or args.chaos_nan_at_step >= 0):
        raise SystemExit("--checkpoint-every and the chaos flags drive a "
                         "supervised run: add --supervise")
    try:
        if args.ranks_per_node:
            make_node_spec(*process_grid(args.ranks), args.ranks_per_node)
        if args.batch or args.batch_shards != 1:
            batch_ranks(args.ranks, args.batch_shards)
            tenants_per_shard(args.batch, args.batch_shards)
    except ValueError as err:
        raise SystemExit(str(err)) from None
    if args.batch_shards != 1 and not args.batch:
        raise SystemExit("--batch-shards shards the tenants of --batch")


def check_supervised(args) -> None:
    """The reference supervisor's refusals, with its texts, and the
    unsupervised run's ``--state-dir`` (a supervised run's final state
    is its last checkpoint)."""
    if not args.checkpoint_every:
        raise SystemExit("--supervise requires --checkpoint-every N")
    if ((args.chaos_flip_bit or args.chaos_nan_at_step >= 0)
            and not args.guard):
        raise SystemExit(
            "--chaos-flip-bit / --chaos-nan-at-step require --guard "
            "(nothing would detect the corruption)")
    if args.state_dir:
        raise SystemExit("--state-dir saves an unsupervised run's final "
                         "state; a supervised run's is its last checkpoint "
                         "under --ckpt-dir")


def supervise(args) -> dict:
    """Fault-tolerant loop around :func:`launch` (the reference's
    function of the same name): launch; on a worker's death, a stalled
    heartbeat or a guard trip, sweep the orphaned checkpoint stages,
    count the lost steps (furthest heartbeat minus last durable
    checkpoint) and relaunch on the same ranks, or on ``--restart-ranks``
    (the workers reshard the checkpoint). The chaos flags ride the first
    attempt only, so an injected fault fires once: a tripped guard
    (``integrity.GUARD_EXIT_CODE``) rolls back to the last clean
    checkpoint and the run converges to the uncorrupted trajectory. The
    row gains ``restarts``, ``lost_steps`` and ``supervised_wall_s``."""
    from repro_torch.checkpoint import checkpointer as ckpt

    check_supervised(args)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="dpsnn-ckpt-")
    hb_dir = os.path.join(ckpt_dir, "hb")
    restarts, lost_steps = 0, 0
    ranks = args.ranks
    wall0 = time.monotonic()
    while True:
        ckpt.gc_stale_stages(ckpt_dir)   # orphans of a killed save
        extra = ["--checkpoint-every", str(args.checkpoint_every),
                 "--ckpt-dir", ckpt_dir]
        if restarts == 0 and args.chaos_kill_rank >= 0:
            extra += ["--chaos-kill-rank", str(args.chaos_kill_rank),
                      "--chaos-at-step", str(args.chaos_at_step)]
        if restarts == 0 and args.chaos_flip_bit:
            extra += ["--chaos-flip-bit", args.chaos_flip_bit]
        if restarts == 0 and args.chaos_nan_at_step >= 0:
            extra += ["--chaos-nan-at-step", str(args.chaos_nan_at_step)]
        try:
            row = launch(args, ranks=ranks, extra=extra, hb_dir=hb_dir,
                         hb_timeout=args.heartbeat_timeout)
            break
        except RuntimeError as e:
            restarts += 1
            observed = _max_heartbeat_step(hb_dir)
            durable = ckpt.latest_step(ckpt_dir) or 0
            lost_steps += max(0, observed - durable)
            if restarts > args.max_restarts:
                raise RuntimeError(
                    f"supervisor giving up after {args.max_restarts} "
                    f"restarts (step {durable} durable): {e}") from e
            if args.restart_ranks:
                ranks = args.restart_ranks
            print(f"SUPERVISOR restart {restarts}/{args.max_restarts}: "
                  f"resuming from step {durable} on {ranks} ranks "
                  f"({observed - durable} steps lost) — "
                  f"{str(e).splitlines()[0]}", flush=True)
    if args.chaos_kill_rank >= 0 and restarts == 0:
        raise RuntimeError(
            f"chaos kill of rank {args.chaos_kill_rank} at step "
            f"{args.chaos_at_step} was requested but the run finished "
            f"with no restart — the fault never fired")
    if (args.chaos_flip_bit or args.chaos_nan_at_step >= 0) \
            and restarts == 0:
        raise RuntimeError(
            "integrity chaos was requested (--chaos-flip-bit/"
            "--chaos-nan-at-step) but the run finished with no restart — "
            "the corruption was never detected")
    row["restarts"] = restarts
    row["lost_steps"] = lost_steps
    row["supervised_wall_s"] = time.monotonic() - wall0
    row["ckpt_dir"] = ckpt_dir
    return row


def checkpoint_states(cfg, ckpt_dir: str):
    """The final checkpoint under ``ckpt_dir`` as ``({leaf: (S, ...)},
    spec)`` for the rank count that wrote it (``meta["n_ranks"]``), each
    leaf under the last part of its path (``convert.DIST_LEAVES``'s
    names)."""
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.core.exchange import stacked_state_template

    n_ranks = ckpt.load_manifest(ckpt_dir)["meta"]["n_ranks"]
    tpl, spec, _ = stacked_state_template(cfg, n_ranks)
    tree, _ = ckpt.restore(ckpt_dir, tpl)
    paths, leaves = ckpt._flatten_with_paths(tree)
    return {p.rsplit("/", 1)[-1].lstrip("."): x
            for p, x in zip(paths, leaves)}, spec


def check_tenants(args, row: dict, ref: dict, leaves: list) -> bool:
    """Every tenant of a batched run against its dedicated single-tenant
    run: spikes, events (:func:`events_agree`) and, from the saved
    states, ``leaves``."""
    ok = (row["per_tenant_spikes"] == ref["per_tenant_spikes"]
          and all(events_agree(m, s) for m, s in
                  zip(row["per_tenant_events"], ref["per_tenant_events"])))
    if ok and leaves:
        spatial = args.ranks // args.batch_shards
        spec = make_rank_tile_spec(build_cfg(args), spatial)
        for i, want in enumerate(ref["tenants"]):
            states = load_states(tenant_state_dir(args.state_dir, i),
                                 spatial)
            ok = ok and all(np.array_equal(
                columns_to_global(states[k], spec), want[k]) for k in leaves)
    return ok


def report_check(args, row: dict, ref: dict, leaves: list) -> bool:
    """Hold the run to ``ref`` (per tenant with ``--batch``), print the
    verdict in the reference's words and return it. ``leaves`` come from
    the ranks' saved states (``--state-dir``), or from a supervised
    run's final checkpoint (``row["ckpt_dir"]``)."""
    also = "".join(f", {k}" for k in leaves)
    exact = max(ref.get("per_tenant_events", [ref["events"]])) < EXACT
    if args.batch:
        ok = check_tenants(args, row, ref, leaves)
        what = f"{args.batch} single-tenant single-process runs"
        if ok and exact:
            print(f"BITWISE-EQUAL vs {what} (per-tenant spikes="
                  f"{ref['per_tenant_spikes']}, events="
                  f"{ref['per_tenant_events']}{also})")
        elif ok:
            print(f"EQUAL vs {what}: per-tenant spikes="
                  f"{ref['per_tenant_spikes']}{also} bitwise, events "
                  f"{row['per_tenant_events']} vs {ref['per_tenant_events']}"
                  f" within {EVENTS_RTOL:g} (float32 totals past 2**24)")
        else:
            print(f"MISMATCH vs single-tenant runs: multi per-tenant "
                  f"spikes={row['per_tenant_spikes']} events="
                  f"{row['per_tenant_events']} != single "
                  f"{ref['per_tenant_spikes']} events="
                  f"{ref['per_tenant_events']} (or "
                  f"{', '.join(leaves) or 'nothing else'} differs)")
        return ok
    ok = (row["spikes"] == ref["spikes"]
          and events_agree(row["events"], ref["events"]))
    if ok and leaves:
        if args.supervise:
            states, spec = checkpoint_states(build_cfg(args), row["ckpt_dir"])
        else:
            spec = make_rank_tile_spec(build_cfg(args), args.ranks)
            states = load_states(args.state_dir, args.ranks)
        ok = all(np.array_equal(columns_to_global(states[k], spec), ref[k])
                 for k in leaves)
    if ok and exact:
        print(f"BITWISE-EQUAL vs single-process (spikes="
              f"{ref['spikes']:.0f}, events={ref['events']:.0f}{also})")
    elif ok:
        print(f"EQUAL vs single-process: spikes={ref['spikes']:.0f}{also} "
              f"bitwise, events {row['events']:.0f} vs {ref['events']:.0f} "
              f"within {EVENTS_RTOL:g} (float32 totals past 2**24)")
    else:
        print(f"MISMATCH vs single-process: multi "
              f"spikes={row['spikes']} events={row['events']} != "
              f"single spikes={ref['spikes']} events={ref['events']} "
              f"(or {', '.join(leaves) or 'nothing else'} differs)")
    return ok


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    refuse_before_spawn(args)
    if args.supervise:
        row = supervise(args)
        print(f"ranks={row['rank_count']} grid={row['grid']} "
              f"tile={row['tile']} neurons={row['neurons']} "
              f"steps={row['steps']} spikes={row['spikes']:.0f} "
              f"rate={row['rate_hz']:.2f}Hz isi_cv={row['isi_cv']:.3f} "
              f"restarts={row['restarts']} lost_steps={row['lost_steps']} "
              f"resumed_from={row['resumed_from_step']} "
              f"device={row['device']} "
              f"wall={row['supervised_wall_s']:.1f}s"
              + (f" guard={row['guard_trip_what']}" if args.guard else ""))
    else:
        row = launch(args)
        print(f"ranks={row['rank_count']} grid={row['grid']} "
              f"tile={row['tile']} neurons={row['neurons']} "
              f"steps={row['steps']} step_ms={row['step_ms']:.2f} "
              f"events/s={row['events_per_s']:.3e} "
              f"spikes={row['spikes']:.0f} device={row['device']} "
              f"wire={row['exchange_mode']} "
              f"({row['halo_payload_bytes_per_step']} B/step/rank)"
              + (f" node_grid={row['node_grid']}x{row['ranks_per_node']}"
                 if args.ranks_per_node else "")
              + (f" tenants={row['batch_size']} batch_shards="
                 f"{row['batch_shards']}" if args.batch else ""))
        if row["aer_saturated_steps"]:
            # truncated but flagged sends: the run is degraded and the
            # check below is expected to fail; say why first
            print(f"AER-SATURATED on {row['aer_saturated_steps']}/"
                  f"{row['steps']} steps: event lists overflowed the "
                  f"capacity bound (raise --aer-rate-bound)")

    ref = single_process_reference(args)
    one = ref["tenants"][0] if args.batch else ref
    leaves = ([k for k in STATE_LEAVES if k in one]
              if args.state_dir or args.supervise else [])
    ok = report_check(args, row, ref, leaves)
    row["single_process_match"] = ok
    if args.json == "-":
        print(json.dumps(row, sort_keys=True))
    elif args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(row, sort_keys=True) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
