#!/usr/bin/env python3
"""``synapse_matmul`` on the batched service's tenant axis alone, on one
NVIDIA card, at ``GRID_24`` (576 columns of 1240 neurons).

    python3 tools/synapse_matmul_tenants_alone.py [B ...]

For each width B (default 1, 2, 4 and 8) it runs the static service for
``chip_smoke.WARMUP_STEPS`` loop steps, takes the spikes the next loop
step hands ``synapse_matmul`` (``Smoke.tenant_inputs``) and times, as
``chip_smoke.py`` times its kernels (median of 10 launches after an L2
flush, CUDA events): one launch over the B tenants, one launch per
tenant, and ``torch.bmm`` on the same inputs. The one launch is held to
the one launch per tenant and to ``ref.synapse_matmul_chain_ref``, to
the bit. Beside each: the plan (CTAs, one tenant a CTA, and shared
bytes), the weight rows the tenants read (each tenant's, and their union
over the tenants), and the bound (the union's weight rows, the spikes
and the output once each, over the card's memory rate). One JSON line a
width, then the card's name and power limit. It needs the card.

With ``--probe`` each width's line also carries what sets the time:
the spiking sources of each (tenant, column) row and of each column's
union over the tenants (mean and max), and the launch timed on the
spikes of the busiest column alone (every other column silent) and on
all-silent spikes.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str]) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("synapse_matmul_tenants_alone: no card", file=sys.stderr)
        return 2
    probe = "--probe" in argv
    widths = [int(a) for a in argv if a != "--probe"] or [1, 2, 4, 8]
    sm = cs.Smoke(torch)
    sm.ops.library()
    ops, ref, B = sm.ops, sm.ref, sm.batched
    cfg = sm.dpsnn.GRID_24
    params, _ = sm.sim.build(cfg, device=sm.dev)
    w = params.w_local
    for b in widths:
        seeds = [cfg.seed + i for i in range(b)]
        st = B.run_chunk(cfg, params, B.init_tenants(cfg, seeds, sm.dev),
                         seeds, [cs.WARMUP_STEPS] * b,
                         cs.WARMUP_STEPS).state
        s = sm.tenant_inputs(cfg, params, st)["s_loc"]
        del st
        rows, n = s.shape
        c = rows // b
        got = ops.synapse_matmul(s, w)
        sm.equal(f"B={b} chain", got, ref.synapse_matmul_chain_ref(s, w))
        parts = [s[i * c:(i + 1) * c] for i in range(b)]
        for i, part in enumerate(parts):
            sm.equal(f"B={b} tenant {i}", got[i * c:(i + 1) * c],
                     ops.synapse_matmul(part, w))
        spiking = s.reshape(b, c, n) != 0
        nnz, union = float(spiking.sum()), float(spiking.any(0).sum())
        sb = s.reshape(b, c, n).transpose(0, 1).contiguous()

        def per_tenant():
            for part in parts:
                ops.synapse_matmul(part, w)
        p = sm.plan.plan("synapse_matmul", rows, n, 0,
                         sm.plan.sm_count(sm.dev), tenants=b)
        row = dict(
            tenants=b, ms=sm.time_ms(lambda: ops.synapse_matmul(s, w)),
            ms_one_launch_per_tenant=sm.time_ms(per_tenant),
            library_ms=sm.time_ms(lambda: torch.bmm(sb, w)),
            plan=dict(ctas=p.ctas, smem_bytes=p.smem_bytes),
            **sm.entry(union * n * 4 + 2 * rows * n * 4, 2 * nnz * n,
                       weight_rows=nnz, weight_rows_union=union))
        if probe:
            row["probe"] = probe_spikes(sm, s, w, b)
        print(json.dumps(row), flush=True)
        del s, sb, got, parts
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    return 0


def probe_spikes(sm, s, w, b):
    """Spiking sources per row and per column's union, and the launch
    timed on the busiest-column-only and the all-silent spikes."""
    import torch
    rows, n = s.shape
    c = rows // b
    spiking = s.reshape(b, c, n) != 0
    per_row = spiking.sum(2).float()
    union = spiking.any(0).sum(1).float()
    busiest = int(union.argmax())
    only = torch.zeros_like(s).reshape(b, c, n)
    only[:, busiest] = s.reshape(b, c, n)[:, busiest]
    out = dict(rows_per_row_mean=float(per_row.mean()),
               rows_per_row_max=float(per_row.max()),
               union_per_column_mean=float(union.mean()),
               union_per_column_max=float(union.max()))
    for name, x in (("busiest column", only.reshape(rows, n)),
                    ("silent", torch.zeros_like(s))):
        out[f"ms {name}"] = sm.time_ms(
            lambda x=x: sm.ops.synapse_matmul(x, w))
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
