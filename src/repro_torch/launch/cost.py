"""Per-device cost of a traced program: product FLOPs and collective
bytes. The PyTorch port's counterpart of ``repro/launch/hlo_cost.py``
and of the dry run's ``parse_collectives``.

The reference walks XLA's optimised HLO, multiplying loop bodies by
their trip counts, because ``cost_analysis()`` counts a while body once.
Eager PyTorch dispatches every loop iteration, so no trip-count walk is
needed: :func:`count` runs the program once under a
``TorchDispatchMode`` that sees every operation as it runs.

On a ``DeviceMesh`` the mode declines the DTensor-level call (it returns
``NotImplemented``, as ``CommDebugMode`` does), so DTensor first turns
the operation into its local operations and the collectives of its
redistributions, and the mode counts those: the FLOPs and bytes of one
device, as the reference's SPMD-partitioned module gives them. The
operations DTensor runs on fake tensors to propagate shapes are not
counted.

- ``matmul_flops``: the products only (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolutions and attention kernels), by
  ``torch.utils.flop_counter``'s formulas: 2 per multiply-add. The
  reference's ``flops`` also counts one per element of every
  elementwise op and reduction; this field does not.
- ``collectives``: per kind (the reference's names: ``all-gather``,
  ``reduce-scatter``, ``all-reduce``, ``all-to-all``,
  ``collective-permute``), the bytes of each collective's result on one
  device, all-reduce doubled (a ring is a reduce-scatter then an
  all-gather), and the counts, by the reference's rules
  (``dryrun.py:69-98``).
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

# the _c10d_functional operations and the reference's name of each
_FUNCOL = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
}


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


class Count(TorchDispatchMode):
    """The counting mode; :func:`count` runs a program under it."""

    def __init__(self):
        super().__init__()
        self.matmul_flops = 0
        self.bytes = {k: 0 for k in KINDS}
        self.counts = {k: 0 for k in KINDS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # let DTensor desugar first
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out      # DTensor's shape propagation, not device work
        packet = getattr(func, "_overloadpacket", None)
        if packet in flop_registry:
            self.matmul_flops += int(flop_registry[packet](*args, **kwargs,
                                                           out_val=out))
        elif getattr(func, "namespace", "") == "_c10d_functional":
            kind = _FUNCOL.get(packet.__name__)
            if kind is not None:
                nbytes = _nbytes(out)
                self.bytes[kind] += 2 * nbytes if kind == "all-reduce" \
                    else nbytes
                self.counts[kind] += 1
        return out

    def result(self) -> dict:
        return {"matmul_flops": self.matmul_flops,
                "collectives": {
                    "bytes": {k: v for k, v in self.bytes.items() if v},
                    "counts": {k: v for k, v in self.counts.items() if v},
                    "total_bytes": sum(self.bytes.values())}}


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), {"matmul_flops": int, "collectives":
    {"bytes": {kind: int}, "counts": {kind: int}, "total_bytes": int}})``
    of one device, backward passes run inside ``fn`` included."""
    with Count() as mode:
        out = fn(*args, **kwargs)
    return out, mode.result()
