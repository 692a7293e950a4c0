"""Remote ELL synaptic delivery on the card: ``csrc/ell_gather.cu``.

Replaces ``repro/kernels/ell_gather.py::ell_gather`` (both its
single-block and its table-tiled Pallas kernel):
``out[c, n] = sum_k tbl[c, idx[c, n, k]] * w[c, n, k]`` in float32.
Bound by bytes: the idx and weight rows, 8 bytes per synapse. Persistent
CTAs stage their column's table row in shared memory and gather from
there; a table too wide for that takes the wide path, read through L2
(``plan.py`` chooses from the shapes; its launches count as
``ell_gather.wide``). Its plain version is ``ref.ell_gather_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.plan import plan, sm_count
from repro_torch.kernels.ref import ell_gather_ref


def ell_gather(s_flat: torch.Tensor, idx: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """(C, T) table, (C, N, K) int32 idx / float32 w -> (C, N)."""
    if s_flat.device.type == "cpu":
        return ell_gather_ref(s_flat, idx, w)
    c, n, k = idx.shape
    t = s_flat.shape[1]
    _build.check_args("ell_gather", s_flat.device,
                      s_flat=(s_flat, torch.float32, (c, t)),
                      idx=(idx, torch.int32, (c, n, k)),
                      w=(w, torch.float32, (c, n, k)))
    out = torch.empty((c, n), dtype=torch.float32, device=s_flat.device)
    p = plan("ell_gather", c, n, t, sm_count(s_flat.device))
    _build.launch("ell_gather" if p.staged else "ell_gather.wide",
                  "repro_ell_gather", s_flat.device,
                  s_flat.data_ptr(), idx.data_ptr(), w.data_ptr(),
                  out.data_ptr(), c, n, t, k, int(p.staged), p.ctas,
                  p.smem_bytes)
    return out
