"""Remote ELL STDP update on the card: ``csrc/stdp_remote.cu``.

No Pallas counterpart: replaces the plain-jnp remote rule of
``repro/core/plasticity.py:115-133``::

    pre = table[c, rem_flat[c, n, k]]
    dw  = lr * (a_plus * pre * spikes[c, n] - a_minus * pre * x_post[c, n]
                * 0.5)
    w'  = where(w > 0, clip(w + dw, 0, w_max), w)

Bound by bytes: the int32 index, the weight and the new weight, 12 bytes
per synapse. Persistent CTAs stage their column's pre-trace row in shared
memory and update one ELL row per warp; a table too wide for that takes
the wide path, read through L2 (``plan.py`` chooses from the shapes; its
launches count as ``stdp_remote_update.wide``). Out of place, as the
reference: the caller's weights stay as they were. Its plain version is
``ref.stdp_remote_update_ref``, which the kernel equals to the bit; the
kernel reads the indices as int32 and makes the host wait for nothing.

Tenant axis (the batched service under STDP): B tenants' tables, spikes,
post-traces and weights have B*C rows and gather through the ``rem_flat``
of C rows they share, in one launch; ``active`` ((B,)) makes an inactive
tenant's rows copy its weights through exactly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.plan import plan, sm_count
from repro_torch.kernels.ref import stdp_remote_update_ref, tenants_of
from repro_torch.kernels.stdp_update import _ptr, active_arg


def stdp_remote_update(table: torch.Tensor, rem_flat: torch.Tensor,
                       rem_w: torch.Tensor, spikes: torch.Tensor,
                       x_post: torch.Tensor, *, a_plus: float,
                       a_minus: float, lr: float, w_max: float,
                       active: torch.Tensor | None = None) -> torch.Tensor:
    """(C, T) pre-trace table, (C, N, K) int32 idx / float32 weights, (C, N)
    spikes and post-traces -> new (C, N, K) weights. With B tenants the
    table, spikes, post-traces and result have B*C rows, ``rem_w`` C or
    B*C, and ``active`` is an optional (B,) mask."""
    kw = dict(a_plus=a_plus, a_minus=a_minus, lr=lr, w_max=w_max)
    if table.device.type == "cpu":
        return stdp_remote_update_ref(table, rem_flat, rem_w, spikes,
                                      x_post, **kw, active=active)
    c, n, k = rem_flat.shape
    rows, t = table.shape
    b = tenants_of(rows, c, "stdp_remote_update")
    w_rows = c if rem_w.shape[0] == c else rows
    f32 = torch.float32
    _build.check_args("stdp_remote_update", table.device,
                      table=(table, f32, (rows, t)),
                      rem_flat=(rem_flat, torch.int32, (c, n, k)),
                      rem_w=(rem_w, f32, (w_rows, n, k)),
                      spikes=(spikes, f32, (rows, n)),
                      x_post=(x_post, f32, (rows, n)))
    if active is not None and active.shape[0] != b:
        raise ValueError(f"stdp_remote_update: active has "
                         f"{active.shape[0]} tenants, the rows {b}")
    active, _ = active_arg("stdp_remote_update", active, rows, table.device)
    out = torch.empty((rows, n, k), dtype=f32, device=table.device)
    p = plan("stdp_remote_update", rows, n, t, sm_count(table.device))
    _build.launch("stdp_remote_update" if p.staged
                  else "stdp_remote_update.wide",
                  "repro_stdp_remote_update", table.device,
                  table.data_ptr(), rem_flat.data_ptr(), rem_w.data_ptr(),
                  spikes.data_ptr(), x_post.data_ptr(), out.data_ptr(),
                  rows, b, w_rows, _ptr(active), n, t, k, a_plus, a_minus,
                  lr, w_max, int(p.staged), p.ctas, p.smem_bytes)
    return out
