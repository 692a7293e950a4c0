"""Dense local STDP weight update on the card: ``csrc/stdp_update.cu``.

Replaces ``repro/kernels/stdp_update.py::stdp_dense_update``::

    dw = lr * (a_plus * x_pre_exc[c, s] * spikes[c, t]
               - a_minus * spk_exc[c, s] * x_post[c, t])
    w' = where(w > 0, clip(w + dw, 0, w_max), w)

Bound by bytes: every weight is read and written once (the clip applies
to every weight). One CTA per (column, 128-source block, 128-target
block) tile; a tile whose source and target spike slices are both
silent skips the products. Out of place, as the reference: the caller's
weights stay as they were. Its plain version is
``ref.stdp_dense_update_ref``, which the kernel equals to the bit.

Tenant axis (the batched service under STDP): B tenants' own weights are
a (B*C, N, N) view and need nothing else; ``active`` ((B,) over tenants
of C columns) makes the tiles of an inactive tenant copy its weights
through exactly, the engine's freeze with no second pass.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import stdp_dense_update_ref, tenants_of


def stdp_dense_update(w_local: torch.Tensor, x_pre_exc: torch.Tensor,
                      spk_exc: torch.Tensor, spikes: torch.Tensor,
                      x_post: torch.Tensor, *, a_plus: float, a_minus: float,
                      lr: float, w_max: float,
                      active: torch.Tensor | None = None) -> torch.Tensor:
    """(C, N, N) weights [src, tgt] + four (C, N) vectors -> new (C, N, N);
    ``active``, when given, a (B,) mask over tenants of C / B columns."""
    if w_local.device.type == "cpu":
        return stdp_dense_update_ref(w_local, x_pre_exc, spk_exc, spikes,
                                     x_post, a_plus=a_plus, a_minus=a_minus,
                                     lr=lr, w_max=w_max, active=active)
    c, n = spikes.shape
    f32 = torch.float32
    _build.check_args("stdp_dense_update", w_local.device,
                      w_local=(w_local, f32, (c, n, n)),
                      x_pre_exc=(x_pre_exc, f32, (c, n)),
                      spk_exc=(spk_exc, f32, (c, n)),
                      spikes=(spikes, f32, (c, n)),
                      x_post=(x_post, f32, (c, n)))
    active, per = active_arg("stdp_dense_update", active, c, w_local.device)
    out = torch.empty_like(w_local)
    _build.launch("stdp_dense_update", "repro_stdp_dense_update",
                  w_local.device, w_local.data_ptr(), x_pre_exc.data_ptr(),
                  spk_exc.data_ptr(), spikes.data_ptr(), x_post.data_ptr(),
                  out.data_ptr(), c, n, _ptr(active), per, a_plus, a_minus,
                  lr, w_max)
    return out


def active_arg(kernel: str, active: torch.Tensor | None, rows: int, device):
    """``(active as int32, columns per tenant)`` for a kernel's tenant mask
    over ``rows`` rows (``(None, rows)`` without one)."""
    if active is None:
        return None, rows
    active = active.to(torch.int32)
    per = tenants_of(rows, active.shape[0], kernel)
    _build.check_args(kernel, device, active=(active, torch.int32,
                                              (active.shape[0],)))
    return active, per


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()
