"""Per-device cost of a traced program: FLOPs, HBM bytes, collective
bytes and peak temporaries. The PyTorch port's counterpart of
``repro/launch/hlo_cost.py``, of the dry run's ``parse_collectives`` and
of XLA's ``memory_analysis``.

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
counted. A program may itself run on fake tensors (``FakeTensorMode``,
nothing allocated): :func:`count` is then given that mode, and only
operations on another mode's fake tensors are taken for DTensor's.

- ``matmul_flops``: the products only (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolutions and attention kernels), by
  ``torch.utils.flop_counter``'s formulas: 2 per multiply-add.
- ``flops``: the reference's rule (``hlo_cost.py:14-19``): the products,
  plus 1 per result element of every elementwise operation of the
  reference's ``_ELEMENTWISE`` set and of every reduction and sort
  (:data:`ELEMENTWISE`, :data:`REDUCE`, :data:`SORT`; a copy that
  changes the dtype is its ``convert``). Views, copies, reshapes and
  transposes count nothing, and neither does a fused ATen operation
  outside the set (``_softmax``, ``embedding``) beyond its products.
- ``bytes``: the HBM traffic of an eager program, which fuses nothing:
  for every operation the bytes of its tensor operands and of its
  results (each tensor's distinct elements, so a broadcast operand
  counts once). An operation whose results alias an operand without
  writing it (its schema's alias info: ``view``, ``expand``, ``t``,
  ``slice``, ``as_strided``; and ``_unsafe_view``, whose schema does not
  say so) costs nothing; an in-place one reads and writes the operand it
  mutates; an allocation (``empty``) moves nothing; a collective adds
  its result bytes, as the reference does (``hlo_cost.py:348-349``).
  XLA fuses elementwise chains and counts only each fusion's boundary,
  so this is at least the reference's count of the same program.
- ``collectives``: per kind (the reference's names: ``all-gather``,
  ``reduce-scatter``, ``all-reduce``, ``all-to-all``,
  ``collective-permute``), the bytes of each collective's result on one
  device, all-reduce doubled (a ring is a reduce-scatter then an
  all-gather), and the counts, by the reference's rules
  (``dryrun.py:69-98``): DTensor's ``_c10d_functional`` operations and
  the eager ``torch.distributed`` calls (``c10d``), where a ``send`` /
  ``recv`` pair is the reference's ``collective-permute`` counted at the
  receiving end. A ``c10d`` operation with no reference kind raises.
- ``temp_bytes``: the largest total of live tensor storages beyond those
  live when the program starts (views share their storage's bytes; a
  storage is freed when its last tensor dies, seen by a weakref
  callback on it), and ``output_bytes`` the storages it made that are still
  live when it returns. A storage on a CUDA device counts its caching
  allocator's block, rounded up to 512 bytes; the ``_by_device``
  entries split both by device type. What a kernel allocates inside
  itself (a sort's scratch, a cuBLAS workspace) is not seen.
"""
from __future__ import annotations

import math
import weakref
from functools import partial
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

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

# the c10d operations of torch.distributed's eager calls (dist.isend,
# dist.irecv, dist.all_reduce, dist.all_gather): the reference's name and
# the argument that holds the result (a send's bytes count where they
# are received)
_C10D = {
    "send": ("collective-permute", None),
    "recv_": ("collective-permute", "tensors"),
    "allreduce_": ("all-reduce", "tensors"),
    "allgather_": ("all-gather", "output_tensors"),
}

# hlo_cost.py's _ELEMENTWISE kinds as ATen operators (in place or not)
ELEMENTWISE = frozenset({
    "add", "sub", "rsub",                             # add, subtract
    "mul", "div", "reciprocal",                       # multiply, divide
    "maximum", "clamp_min", "relu", "minimum", "clamp_max",
    "exp", "exp2", "tanh", "neg", "abs",
    "eq", "ne", "lt", "le", "gt", "ge",               # compare
    "where", "masked_fill",                           # select
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "__and__", "__or__", "__xor__",                   # and, or, xor, not
    "pow", "rsqrt", "sqrt", "log", "sigmoid",         # sigmoid: logistic
    "floor", "ceil", "round", "sign", "sgn", "clamp",
    "expm1", "log1p", "atan2",
    "bitwise_left_shift", "bitwise_right_shift", "__lshift__",
    "__rshift__", "remainder", "fmod",
})
# hlo_cost.py's reduce (and reduce-window: the scans) and sort
REDUCE = frozenset({"sum", "mean", "amax", "amin", "max", "min", "prod",
                    "argmax", "argmin", "any", "all", "logsumexp",
                    "cumsum", "cumprod", "var", "std", "linalg_vector_norm"})
SORT = frozenset({"sort", "topk"})
# results that share their operand's storage although the schema does
# not mark them as aliases (wait_tensor returns the tensor it waits on)
_UNMARKED_VIEWS = frozenset({"_unsafe_view", "wait_tensor"})
# allocations: nothing is read or written
_ALLOCATIONS = frozenset({"empty", "empty_like", "empty_strided",
                          "new_empty", "new_empty_strided"})
# torch.tensor's literal: its data is made outside the dispatcher, so the
# storage is new whether the tensor is real or fake
_LITERALS = frozenset({"lift_fresh", "lift_fresh_copy"})
CUDA_BLOCK = 512    # the CUDA caching allocator's rounding (kMinBlockSize)


def _tensors(tree) -> list:
    """The distinct tensors of an operator's arguments or results (nested
    lists, tuples and dicts), in order."""
    out = []
    for x in tree if isinstance(tree, (list, tuple)) else (tree,):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out += _tensors(x)
        elif isinstance(x, dict):
            out += _tensors(list(x.values()))
    if len(out) > 1 and len({id(x) for x in out}) < len(out):
        seen: set = set()
        out = [x for x in out if not (id(x) in seen or seen.add(id(x)))]
    return out


def _nbytes(out) -> int:
    return sum(x.numel() * x.element_size() for x in _tensors(out))


def _span(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` addresses (a broadcast dim,
    stride 0, once)."""
    if t.numel() == 0:
        return 0
    return math.prod(s for s, st in zip(t.shape, t.stride()) if st) \
        * t.element_size()


def allocated(nbytes: int, device_type: str) -> int:
    """The bytes a storage of ``nbytes`` takes on a device of
    ``device_type``: on CUDA the caching allocator's block, rounded up
    to :data:`CUDA_BLOCK`."""
    if device_type == "cuda":
        return -(-nbytes // CUDA_BLOCK) * CUDA_BLOCK
    return nbytes


def leaves(tree) -> list:
    """Every tensor of nested dicts, lists, tuples, NamedTuples,
    dataclasses (the optimizer's ``Q8`` records) and modules (their
    parameters and buffers)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [x for v in vars(tree).values() for x in leaves(v)]
    return []


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``'s tensors, each as
    its device's allocator holds it (:func:`allocated`): what a program
    given ``tree`` finds live at its start."""
    seen: dict = {}
    for t in leaves(tree):
        st = t.untyped_storage()
        seen[id(st)] = (st, allocated(st.nbytes(), t.device.type))
    return sum(nbytes for _, nbytes in seen.values())


class _Op(NamedTuple):
    """What the counting mode reads from an operator's schema, once."""
    namespace: str
    name: str          # without the in-place "_": add_ -> add; __and__
    packet: str        # the overload packet's own name
    names: tuple       # the schema's argument names
    written: tuple     # the arguments the schema marks as written
    view: bool         # every result aliases an operand, none written
    products: bool     # in torch.utils.flop_counter's registry
    counted: bool      # in ELEMENTWISE, REDUCE or SORT


def _op(func) -> _Op:
    packet = func._overloadpacket.__name__
    name = packet[:-1] if packet.endswith("_") and \
        not packet.endswith("__") else packet
    schema = func._schema
    written = tuple(a.name for a in schema.arguments
                    if a.alias_info is not None and a.alias_info.is_write)
    view = not written and (packet in _UNMARKED_VIEWS or (
        bool(schema.returns) and all(r.alias_info is not None
                                     for r in schema.returns)))
    return _Op(getattr(func, "namespace", ""), name, packet,
               tuple(a.name for a in schema.arguments), written, view,
               func._overloadpacket in flop_registry,
               name in ELEMENTWISE or name in REDUCE or name in SORT)


def _bound(op: _Op, args, kwargs) -> dict:
    """The schema's argument names bound to the call's values."""
    return {**dict(zip(op.names, args)), **kwargs}


def _converts(op: _Op, args, kwargs) -> bool:
    """A copy that changes the dtype: the reference's ``convert``."""
    if op.name == "_to_copy":
        dt = kwargs.get("dtype")
        return dt is not None and dt != args[0].dtype
    if op.name == "copy":
        return args[1].dtype != args[0].dtype
    return False


class Count(TorchDispatchMode):
    """The counting mode; :func:`count` runs a program under it.
    ``fake_mode``: the ``FakeTensorMode`` of the program's own fake
    tensors, if it runs on some."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0
        self.matmul_flops = 0
        self.hbm_bytes = 0
        self.coll_bytes = {k: 0 for k in KINDS}
        self.coll_counts = {k: 0 for k in KINDS}
        self._ops: dict = {}
        # storage -> [device type, bytes, weakref] of a storage made in
        # the window, None for one that was live at entry
        self._storages = WeakIdKeyDictionary()
        self._live: dict = {}
        self._peak: dict = {}
        self._total, self._total_peak = 0, 0
        self._out: dict = {}

    # ------------------------------------------------------------ memory
    def _free(self, rec, _ref=None) -> None:
        dev, nbytes = rec[0], rec[1]
        self._live[dev] -= nbytes
        self._total -= nbytes

    def _add(self, rec, nbytes: int) -> None:
        dev = rec[0]
        self._live[dev] = self._live.get(dev, 0) + nbytes
        self._peak[dev] = max(self._peak.get(dev, 0), self._live[dev])
        self._total += nbytes
        self._total_peak = max(self._total_peak, self._total)

    def _entry(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            if st not in self._storages:
                self._storages[st] = None

    def _made(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            nbytes = allocated(st.nbytes(), t.device.type)
            rec = self._storages.get(st, False)
            if rec is False:
                rec = [t.device.type, nbytes]
                rec.append(weakref.ref(st, partial(self._free, rec)))
                self._storages[st] = rec
                self._add(rec, nbytes)
            elif rec is not None and rec[1] != nbytes:     # resized
                grow, rec[1] = nbytes - rec[1], nbytes
                self._add(rec, grow)

    def __exit__(self, *exc):
        self._out = dict(self._live)
        return super().__exit__(*exc)

    # ------------------------------------------------------ the dispatch
    def _collective(self, kind: str, result) -> None:
        nbytes = _nbytes(result)
        self.coll_bytes[kind] += 2 * nbytes if kind == "all-reduce" \
            else nbytes
        self.coll_counts[kind] += 1
        self.hbm_bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # let DTensor desugar first
        kwargs = kwargs or {}
        inputs = _tensors((args, kwargs))
        out = func(*args, **kwargs)
        outputs = _tensors(out)
        if FakeTensor in types or any(isinstance(x, FakeTensor)
                                      for x in outputs):
            if any(isinstance(x, FakeTensor) and x.fake_mode is not
                   self.fake_mode for x in inputs + outputs):
                return out  # DTensor's shape propagation, not device work
        op = self._ops.get(func)
        if op is None:
            op = self._ops[func] = _op(func)
        if op.name not in _LITERALS:
            self._entry(inputs)
        self._made(outputs)
        if op.namespace == "c10d":
            if op.packet not in _C10D:
                raise ValueError(
                    f"launch/cost.py: {func} is a c10d collective with no "
                    f"reference kind ({sorted(_C10D)} are mapped)")
            kind, arg = _C10D[op.packet]
            if arg is not None:
                self._collective(kind, _bound(op, args, kwargs)[arg])
            return out
        if op.namespace == "_c10d_functional" and op.packet in _FUNCOL:
            self._collective(_FUNCOL[op.packet], out)
            return out
        if op.namespace not in ("aten", "_c10d_functional"):
            return out
        written = ()
        if op.written:
            bound = _bound(op, args, kwargs)
            written = _tensors([bound[k] for k in op.written if k in bound])
        results = outputs or written
        if op.products:
            n = int(flop_registry[func._overloadpacket](*args, **kwargs,
                                                        out_val=out))
            self.matmul_flops += n
            self.flops += n
        elif (op.counted or _converts(op, args, kwargs)) and results:
            self.flops += results[0].numel()
        if op.view or op.name in _ALLOCATIONS:
            return out
        self.hbm_bytes += sum(_span(x) for x in inputs) + sum(
            _span(x) for x in results)
        return out

    def result(self) -> dict:
        return {"flops": self.flops, "matmul_flops": self.matmul_flops,
                "bytes": self.hbm_bytes,
                "temp_bytes": self._total_peak,
                "output_bytes": sum(self._out.values()),
                "temp_bytes_by_device": dict(self._peak),
                "output_bytes_by_device": dict(self._out),
                "collectives": {
                    "bytes": {k: v for k, v in self.coll_bytes.items() if v},
                    "counts": {k: v for k, v in self.coll_counts.items()
                               if v},
                    "total_bytes": sum(self.coll_bytes.values())}}


def count(fn, *args, fake_mode=None, **kwargs):
    """``(fn(*args, **kwargs), cost)`` of one device, backward passes
    run inside ``fn`` included: ``cost`` is :meth:`Count.result`'s
    ``{"flops", "matmul_flops", "bytes", "temp_bytes", "output_bytes",
    "temp_bytes_by_device", "output_bytes_by_device", "collectives":
    {"bytes": {kind: int}, "counts": {kind: int}, "total_bytes": int}}``.
    ``fake_mode``: the ``FakeTensorMode`` whose fake tensors are the
    program's own (it need not be active: a fake tensor runs its
    operations in its mode)."""
    with Count(fake_mode) as mode:
        out = fn(*args, **kwargs)
    return out, mode.result()
