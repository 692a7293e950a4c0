"""Fused column step on the card: ``csrc/fused_step.cu``.

Replaces ``repro/kernels/fused_step.py::fused_step`` with both of its
epilogues: the STDP trace decay and bump (``scfg``) and the per-column
guard flags (``gcfg``), each a template variant of the kernel, so the
static variant runs the code it ran without them. Per target neuron:
the block-skipped local product, + the ELL gather, + the external
drive, then LIF+SFA, with nothing written to device memory between the
stages. Bound by bytes: the weight rows the spikes need plus the ELL idx
and weights plus the state (and traces). Persistent CTAs claim (column,
256-target block) items from a counter and stage the column's table row
in shared memory, as ``ell_gather`` does, with the same wide path for
tables too wide for it (``plan.py``; launches counted as
``fused_step.wide``); see the source for the design. Its plain version
is ``ref.fused_step_ref``.

``silent_blocks`` counts skipped (column, 128-source block) pairs, as in
``synapse_matmul``.

Tenant axis (the batched service): B tenants in one launch. Every
per-neuron input and output, the table and the guard flags have B*C rows,
tenant after tenant; ``rem_flat`` keeps its C rows, and ``w_local`` and
``rem_w`` have C rows (static runs: every tenant reads the one copy) or
B*C (STDP: each tenant's own). On a staged table the launch takes the
cluster path (``plan.py``): groups of up to 8 tenants as thread-block
clusters, one CTA per tenant, that walk the same (column, target block)
items together, so that HBM serves each ELL block once a group and L2
the group's other CTAs (csrc/fused_step.cu). A cluster launch the card
refuses raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lif_step import _c_lif
from repro_torch.kernels.plan import plan, sm_count
from repro_torch.kernels.ref import (fused_step_ref, lif_constants,
                                     silent_block_count, stdp_constants,
                                     tenants_of)
from repro_torch.kernels.synapse_matmul import _counter_arg, _counter_ptr


def fused_step(ncfg, v, c, refrac, s_loc, w_local, s_flat, rem_flat, rem_w,
               ext, x_pre=None, x_post=None, *, scfg=None, gcfg=None,
               silent_blocks: torch.Tensor | None = None):
    """One step over all columns of a shard.

    ``v, c, refrac, s_loc, ext`` (C, N); ``w_local`` (C, N, N) [src, tgt];
    ``s_flat`` (C, T) neighbour-spike table; ``rem_flat, rem_w`` (C, N, K);
    ``x_pre, x_post`` (C, N) STDP traces, with ``scfg``. Returns
    ``(v', c', refrac', spikes)``, with ``scfg`` followed by ``(x_pre',
    x_post')`` and with ``gcfg`` by the (C,) int32 guard flags of ``v'``
    (bit 0 non-finite, bit 1 outside ``[gcfg.v_floor, gcfg.v_ceil]``).
    With B tenants, C above is B*C but for ``rem_flat`` (and for
    ``w_local`` and ``rem_w`` when shared).
    """
    if v.device.type == "cpu":
        if silent_blocks is not None:
            silent_blocks += silent_block_count(s_loc)
        return fused_step_ref(ncfg, v, c, refrac, s_loc, w_local, s_flat,
                              rem_flat, rem_w, ext, x_pre, x_post,
                              scfg=scfg, gcfg=gcfg)
    nc, n = v.shape
    t = s_flat.shape[1]
    cols, _, k = rem_flat.shape
    b = tenants_of(nc, cols, "fused_step")
    w_rows = cols if w_local.shape[0] == cols else nc
    rw_rows = cols if rem_w.shape[0] == cols else nc
    f32 = torch.float32
    traces = {}
    if scfg is not None:
        traces = dict(x_pre=(x_pre, f32, (nc, n)), x_post=(x_post, f32, (nc, n)))
    _build.check_args("fused_step", v.device,
                      v=(v, f32, (nc, n)), c=(c, f32, (nc, n)),
                      refrac=(refrac, torch.int32, (nc, n)),
                      s_loc=(s_loc, f32, (nc, n)),
                      w_local=(w_local, f32, (w_rows, n, n)),
                      s_flat=(s_flat, f32, (nc, t)),
                      rem_flat=(rem_flat, torch.int32, (cols, n, k)),
                      rem_w=(rem_w, f32, (rw_rows, n, k)),
                      ext=(ext, f32, (nc, n)), **traces,
                      **_counter_arg(silent_blocks))
    v_out, c_out, s_out = (torch.empty_like(v) for _ in range(3))
    r_out = torch.empty_like(refrac)
    out = (v_out, c_out, r_out, s_out)
    stdp_args = (None, None, None, None, 0.0, 0.0)
    if scfg is not None:
        xp_out, xq_out = torch.empty_like(v), torch.empty_like(v)
        decays = stdp_constants(scfg, ncfg.dt_ms, v.dtype)
        stdp_args = (x_pre.data_ptr(), x_post.data_ptr(), xp_out.data_ptr(),
                     xq_out.data_ptr(), decays["dp"], decays["dm"])
        out += (xp_out, xq_out)
    guard_args = (None, 0.0, 0.0)
    if gcfg is not None:
        flags = torch.zeros(nc, dtype=torch.int32, device=v.device)
        guard_args = (flags.data_ptr(), gcfg.v_floor, gcfg.v_ceil)
        out += (flags,)
    p = plan("fused_step", nc, n, t, sm_count(v.device), tenants=b)
    next_item = torch.zeros(1, dtype=torch.int32, device=v.device)
    _build.launch("fused_step" if p.staged else "fused_step.wide",
                  "repro_fused_step", v.device,
                  s_loc.data_ptr(), w_local.data_ptr(), s_flat.data_ptr(),
                  rem_flat.data_ptr(), rem_w.data_ptr(), ext.data_ptr(),
                  v.data_ptr(), c.data_ptr(), refrac.data_ptr(),
                  v_out.data_ptr(), c_out.data_ptr(), r_out.data_ptr(),
                  s_out.data_ptr(), nc, b, w_rows, rw_rows, n, t, k,
                  *_c_lif(lif_constants(ncfg, v.dtype)),
                  _counter_ptr(silent_blocks), *stdp_args, *guard_args,
                  *_build.plan_args(p), next_item.data_ptr())
    return out
