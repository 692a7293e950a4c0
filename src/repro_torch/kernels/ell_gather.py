"""Remote ELL synaptic delivery on the card: ``csrc/ell_gather.cu``.

Replaces ``repro/kernels/ell_gather.py::ell_gather`` (both its
single-block and its table-tiled Pallas kernel):
``out[c, n] = sum_k tbl[c, idx[c, n, k]] * w[c, n, k]`` in float32.
Bound by bytes: the idx and weight rows, 8 bytes per synapse. One warp
per (c, n) row, lanes striding over k, the table gathered from device
memory through L2, so a table of any width runs the same code. Its plain
version is ``ref.ell_gather_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
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
    _build.launch("ell_gather", "repro_ell_gather", s_flat.device,
                  s_flat.data_ptr(), idx.data_ptr(), w.data_ptr(),
                  out.data_ptr(), c, n, t, k)
    return out
