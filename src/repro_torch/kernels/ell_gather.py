"""Remote ELL synaptic delivery on the card: ``csrc/ell_gather.cu``.

Replaces ``repro/kernels/ell_gather.py::ell_gather`` (both its
single-block and its table-tiled Pallas kernel):
``out[c, n] = sum_k tbl[c, idx[c, n, k]] * w[c, n, k]`` in float32.
Bound by bytes: the idx and weight rows, 8 bytes per synapse. Persistent
CTAs stage their column's table row in shared memory and gather from
there; a table too wide for that takes the wide path, read through L2
(``plan.py`` chooses from the shapes; its launches count as
``ell_gather.wide``). Its plain version is ``ref.ell_gather_ref``.

Tenant axis (the batched service): a (B*C, T) table of B tenants gathers
through the (C, N, K) idx they share, and through weights of C rows
(shared) or B*C rows, in one launch. On a staged table it takes the
cluster path (``plan.py``): groups of up to 8 tenants as thread-block
clusters, one CTA per tenant, that walk the same (column, target block)
items together, so that HBM serves each ELL block once a group
(``csrc/ell_gather.cu``). A cluster launch the card refuses raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.plan import plan, sm_count
from repro_torch.kernels.ref import ell_gather_ref, tenants_of


def ell_gather(s_flat: torch.Tensor, idx: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """(C, T) table, (C, N, K) int32 idx / float32 w -> (C, N); a (B*C, T)
    table gives (B*C, N), with w of C or B*C rows."""
    if s_flat.device.type == "cpu":
        return ell_gather_ref(s_flat, idx, w)
    c, n, k = idx.shape
    rows, t = s_flat.shape
    b = tenants_of(rows, c, "ell_gather")
    w_rows = w.shape[0] if w.shape[0] in (c, rows) else c
    _build.check_args("ell_gather", s_flat.device,
                      s_flat=(s_flat, torch.float32, (rows, t)),
                      idx=(idx, torch.int32, (c, n, k)),
                      w=(w, torch.float32, (w_rows, n, k)))
    out = torch.empty((rows, n), dtype=torch.float32, device=s_flat.device)
    p = plan("ell_gather", rows, n, t, sm_count(s_flat.device), tenants=b)
    next_item = torch.zeros(1, dtype=torch.int32, device=s_flat.device)
    _build.launch("ell_gather" if p.staged else "ell_gather.wide",
                  "repro_ell_gather", s_flat.device,
                  s_flat.data_ptr(), idx.data_ptr(), w.data_ptr(),
                  out.data_ptr(), rows, b, w_rows, n, t, k,
                  *_build.plan_args(p), next_item.data_ptr())
    return out
