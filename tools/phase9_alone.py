#!/usr/bin/env python3
"""Phase 9 of ``chip_smoke.py`` alone on one NVIDIA card: weak scaling,
several shards per rank, the guarded batched mesh and the Izhikevich
neuron, after the pieces of phases 3 and 7 that phase 9 holds them to.

    python3 tools/phase9_alone.py

It builds ``GRID_24`` from its seed, runs phase 3's ``cuda_fused`` steps
(WARMUP_STEPS, then MAIN_STEPS), phase 7's 2 gloo ranks x 2 tenants
(their rows and the tenants' dedicated runs) and phase 7's unguarded 2x2
batched mesh of 4 tenants, then ``Smoke.completion_path``. It takes
about a quarter of the whole script's time, so a change to phase 9 can
be tried on the card without phases 0-8. It needs the card.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("phase9_alone: no card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    sm = cs.Smoke(torch)
    sm.ops.library()
    cfg = sm.dpsnn.GRID_24
    params, state0 = sm.sim.build(cfg, device=sm.dev)
    warm = sm.sim.run(cfg, params, state0, cs.WARMUP_STEPS,
                      impl="cuda_fused")
    sm.warm_trace = warm.rate_trace
    fused = sm.sim.run(cfg, params, warm.state, cs.MAIN_STEPS,
                       impl="cuda_fused")
    # what phase 9 reads of phase 7: its ranks' rows (and, set by
    # batched_rank_path, the tenants' dedicated runs), its 2x2 run
    sm.report["batched_mesh_path"] = {"ranks": sm.batched_rank_path(cfg)}
    mesh = sm.LocalMesh(2, 2, sm.dev)
    spec = sm.part.make_tile_spec(cfg, 2, 2)
    ids = sm.ex.shard_col_ids(cfg, spec, mesh, sm.dev).long()
    built = sm.net.NetworkParams(*(x[ids] for x in params))
    out = sm.batched_mesh_run(cfg, mesh, built, "cuda_fused",
                              cs.SERVICE_TENANTS)
    sm.unguarded_2x2 = dict(
        ms=out["ms"], spikes=out["res"].spikes, events=out["res"].events,
        trace=torch.cat([out["warm"].rate_trace, out["res"].rate_trace], 1),
        v=out["final"].lif.v)
    del out, built
    print(f"phases 3 and 7's pieces in {time.perf_counter() - t0:.1f} s",
          flush=True)
    sm.completion_path(cfg, params, fused)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
