"""Spawn-N-processes launcher for the multi-process DPSNN runtime (the
port of ``repro/launch/launch_distributed.py``).

The single-machine analogue of the paper's ``mpirun -np N``: spawns N
worker processes (``repro_torch.runtime.multiprocess``), wires them to a
fresh gloo rendezvous on a free localhost port, waits for the job, then
re-runs the same workload single-process in this process and asserts
that the totals are bitwise equal (the determinism per column
id that makes every scaling measurement trustworthy).

    PYTHONPATH=src python -m repro_torch.launch.launch_distributed \
        --ranks 4 [--device cpu] [--state-dir DIR] [--stdp] \
        [--exchange-mode aer_sparse|auto] [--ranks-per-node 2] \
        [--batch 2 [--batch-shards 2]]

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
    return argv


def launch(args) -> dict:
    """Spawn ``args.ranks`` workers and return rank 0's metrics row.

    Workers write stdout/stderr to temp files rather than pipes: an
    undrained pipe would block a chatty rank mid-exchange. All ranks are
    polled: the first to exit non-zero is the diagnosis and the rest are
    killed; ranks still running after ``args.timeout`` seconds are
    killed and named in the error.
    """
    n_ranks = args.ranks
    coordinator = f"127.0.0.1:{args.port or free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    wargv = worker_argv(args)
    with tempfile.TemporaryDirectory(prefix="dpsnn-mp-") as tmp:
        procs = []
        first_failed = None   # (rank, returncode) of the first death
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
    # the reference launcher's flags for what this port does not run yet
    ap.add_argument("--supervise", action="store_true",
                    help="refused: supervise and resume from disk wait "
                         "for ROADMAP queue 1 item 6")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="refused, as --supervise")
    add_workload_args(ap)
    return ap


def refuse_before_spawn(args) -> None:
    """Exit with the reference's text for what no rank could run: node
    groups with ``--batch`` or a bad node shape, a tenant split that does
    not divide, and what waits for ROADMAP queue 1 item 6."""
    if args.ranks_per_node and (args.batch or args.checkpoint_every):
        raise SystemExit("--ranks-per-node applies to the plain distributed "
                         "run only (not --batch / supervised mode)")
    if args.supervise or args.checkpoint_every:
        raise SystemExit("--supervise / --checkpoint-every: supervise and "
                         "resume from disk wait for ROADMAP queue 1 item 6")
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
    verdict in the reference's words and return it."""
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
        # truncated but flagged sends: the run is degraded and the check
        # below is expected to fail; say why first
        print(f"AER-SATURATED on {row['aer_saturated_steps']}/"
              f"{row['steps']} steps: event lists overflowed the "
              f"capacity bound (raise --aer-rate-bound)")

    ref = single_process_reference(args)
    one = ref["tenants"][0] if args.batch else ref
    leaves = [k for k in STATE_LEAVES if k in one] if args.state_dir else []
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
