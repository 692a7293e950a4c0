"""Mesh-axis policy of the PyTorch port: the LM zoo's rules (data and
FSDP parallelism over ``'data'``, tensor and expert parallelism over
``'model'``, an extra ``'pod'`` data axis) on a
``torch.distributed.device_mesh.DeviceMesh``, and the batched service's
tenant axis over processes. The counterpart of
``repro/runtime/sharding.py``.

**The LM rules.** A spec is a tuple with the reference's
``PartitionSpec`` entries (``None``, an axis name, or a tuple of names
such as ``("pod", "data")``), so it compares equal to the reference's
``tuple(P)``. The rules read a mesh only as an ordered mapping of axis
name to size (the reference's ``AbstractMesh``): a ``DeviceMesh`` with
``mesh_dim_names``, or a plain mapping such as ``{"data": 16, "model":
16}``. :func:`placements` turns a spec into DTensor placements.
:func:`param_spec` is the reference's rule on the reference's path
strings (``"['groups']/[0]/['mlp']/['wo']"``, :func:`jax_path`), its
quirks included: on that form ``name.endswith("wo")`` and
``endswith("wi")`` never fire (ROADMAP queue 3). The port holds one
parameter per layer where the reference stacks them, so a per-layer
parameter takes its stacked leaf's spec with the stack dims dropped
(:func:`unstack_spec`); an axis the reference puts on a stack dim (the
tied largest dims of mamba2's (48, 48) ``a_log``, ``d_skip`` and
``dt_bias`` on 16 x 16) moves to the leaf's largest free dim it divides,
else the leaf is replicated over it. :func:`place_params`,
:func:`place_caches` and :func:`place_batch` make the DTensors.

Model code calls :func:`constrain` at the reference's sites without
threading the mesh through; off a mesh (:func:`use_mesh` not entered)
it returns its input, so the unsharded path is unchanged. Where
DTensor's own propagation cannot follow the model (some PyTorch
versions refuse to fold a sharded dim into the one before it or to turn
a shard into a pending sum; a vocabulary mask lasts one reduction; a
split may not cut a head), the model's mesh-only code uses
:func:`rows`, :func:`pin`, :func:`contiguous_grad`, :func:`foldable`,
:func:`whole_chunks`, :func:`settle` and :func:`logsumexp`, and work
that is independent along its sharded dims (attention, the SSD scan)
runs on each rank's shards (:func:`run_local`).

**The service.** The reference's service mesh is a ``('batch', 'data',
'model')`` device mesh: tenants shard over ``'batch'``, and every batch
shard runs the full spatial column mesh. The port's transports are that
mesh: a :class:`~repro_torch.runtime.transport.LocalMesh` holds every
shard of the spatial grid in one process, and a
:class:`~repro_torch.runtime.transport.ProcessGroupMesh` with
``batch_shards`` K splits the ranks of the default process group into K
batch shards of ``world / K`` spatial ranks each, batch-major: ranks
``[k*S, (k+1)*S)`` form batch shard k. Tenants never cross a batch
shard; only the per-tenant totals do.

Nothing here initialises a process group or touches a device at import.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import sys

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.partition import process_grid
from repro_torch.runtime.transport import LocalMesh, ProcessGroupMesh


def service_mesh(batch_shards: int, rows: int, cols: int, device="cuda", *,
                 compress: bool = True, shards_per_rank: int = 1):
    """The transport of a batched service run: ``batch_shards`` tenant
    shards, each over a ``rows x cols`` spatial shard grid.

    Without an initialised process group this process is the one rank,
    so only ``batch_shards == 1`` fits: a :class:`LocalMesh` of every
    shard. With one, the world must hold ``batch_shards * rows * cols /
    shards_per_rank`` ranks, ``shards_per_rank`` shards each along a row
    of the closest-to-square process grid (``partition.process_grid``):
    a :class:`ProcessGroupMesh`, its strips packed into words unless
    ``compress`` is False. Raises with all three factors named when the
    rank count does not match, as the reference names its device
    count."""
    ranks = dist.is_initialized()
    have = dist.get_world_size() if ranks else 1
    k = shards_per_rank
    need = batch_shards * rows * cols // k if cols % k == 0 else 0
    if batch_shards < 1 or (have != need if ranks else batch_shards != 1):
        raise ValueError(
            f"service mesh {batch_shards}(batch) x {rows}(data) x "
            f"{cols}(model) needs {need} ranks"
            f"{f' of {k} shards' if k != 1 else ''}, have {have}")
    if not ranks:
        return LocalMesh(rows, cols, device)
    grid = process_grid(rows * cols // k)
    if grid != (rows, cols // k):
        raise ValueError(
            f"service mesh {rows}x{cols}: the ranks of a batch shard take "
            f"the process grid {grid}")
    return ProcessGroupMesh(device, compress=compress,
                            batch_shards=batch_shards, shards_per_rank=k)


def batch_shards(mesh) -> int:
    """Size of the tenant axis (1 when the transport has none)."""
    return getattr(mesh, "batch_shards", 1)


def local_tenants(mesh, batch: int) -> range:
    """Which of ``batch`` tenants this process holds: the role of the
    reference's ``tenant_pspec`` / ``tenant_shardings``, which place
    (B, ...) leaves over the ``'batch'`` axis. Torch has no
    ``PartitionSpec``: a process holds the contiguous block
    ``[k*b_local, (k+1)*b_local)`` of its batch shard k, with ``b_local
    = batch // batch_shards``, every tenant on a transport without a
    tenant axis. Raises with the reference's text when the shards do
    not divide the batch."""
    b_local = tenants_per_shard(batch, batch_shards(mesh))
    first = getattr(mesh, "batch_index", 0) * b_local
    return range(first, first + b_local)


def tenants_per_shard(batch: int, batch_shards: int) -> int:
    """``batch // batch_shards``, or the reference's error naming both."""
    if batch % batch_shards:
        raise ValueError(
            f"batch={batch} tenants do not divide over the mesh's "
            f"batch axis of {batch_shards} shards — choose batch as a "
            f"multiple of {batch_shards} (each shard runs "
            f"batch/batch_shards tenants in lockstep)")
    return batch // batch_shards


# ---------------------------------------------------------------------------
# LM rules: specs, the mesh as axis sizes, placements
# ---------------------------------------------------------------------------

def mesh_axes(mesh) -> dict:
    """{axis name: size} in the mesh's order: a ``DeviceMesh``'s
    ``mesh_dim_names`` and ``shape``, or a mapping as it is."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    if isinstance(mesh, dict):
        return dict(mesh)
    raise TypeError(f"a mesh is a DeviceMesh with mesh_dim_names or a "
                    f"mapping of axis sizes, not {type(mesh).__name__}")


def _div(n: int, mesh, axis: str) -> bool:
    axes = mesh_axes(mesh)
    return axis in axes and n % axes[axis] == 0 and n > 0


def _entry_size(entry, axes: dict) -> int:
    size = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        size *= axes[a]
    return size


def jax_path(path: str) -> str:
    """The port's leaf path (``"groups.0.mlp.wo"``) -> the reference's
    path string as its rules build it, ``"/".join(str(k) for k in
    path)`` of JAX's keys: ``"['groups']/[0]/['mlp']/['wo']"`` (a list
    index ``[i]``, a dict key ``['k']``)."""
    return "/".join(f"[{k}]" if k.isdigit() else f"['{k}']"
                    for k in path.split("."))


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(d)``
    on every mesh dim that the spec names for tensor dim d,
    ``Replicate()`` on the others. An entry naming several axes must
    name them in the mesh's order (the outer axis first, as JAX's)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a)
               for a in (entry if isinstance(entry, tuple) else (entry,))]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def fit_spec(dims, shape, mesh) -> tuple:
    """The reference's replicate-fallback of ``constrain``: entries
    naming an axis the mesh lacks, or whose size does not divide the
    dim, become None."""
    axes = mesh_axes(mesh)
    fixed = []
    for i, d in enumerate(dims):
        names = () if d is None else d if isinstance(d, tuple) else (d,)
        if d is None or not all(a in axes for a in names):
            fixed.append(None)
            continue
        fixed.append(d if shape[i] % _entry_size(d, axes) == 0 else None)
    return tuple(fixed)


# ---------------------------------------------------------------------------
# Current-mesh context: model code calls ``constrain(x, *dims)`` without
# threading the mesh through every layer; off a mesh it is a no-op.
# ---------------------------------------------------------------------------

_CURRENT_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the model on ``mesh`` (a ``DeviceMesh``): :func:`constrain`
    places activations, and plain tensors the model makes (positions,
    masks, constants, the same on every rank) mix with DTensors as
    replicated ones (``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    tok = _CURRENT_MESH.set(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _CURRENT_MESH.reset(tok)


def current_mesh():
    return _CURRENT_MESH.get()


def _is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor, without importing DTensor's module
    when nothing has (then nothing can be one): the model's helpers ask
    on every call, off a mesh too."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


@contextlib.contextmanager
def off_mesh():
    """Run model code as off a mesh (its constraint sites no-ops), for a
    function that works on local shards (:func:`run_local`)."""
    tok = _CURRENT_MESH.set(None)
    try:
        yield
    finally:
        _CURRENT_MESH.reset(tok)


def run_local(fn, args, specs, out_spec, **kwargs):
    """``fn(*local args, **kwargs)`` on each rank's shards, the result a
    DTensor of ``out_spec``: each of ``args`` is brought to its spec of
    ``specs`` (a plain tensor, the same on every rank, taken as
    replicated first) and handed over as its local tensor, and ``fn``
    runs off the mesh. For work that is independent along the sharded
    dims (attention per batch row and head): no collective inside, and
    plain tensors for DTensor's view rules and the cost count. Autograd
    goes through (the redistributions, ``to_local`` and ``from_local``
    are differentiable); a replicated argument's gradient is a pending
    sum over the mesh dims the work is split over."""
    from torch.distributed.tensor import DTensor, Partial
    mesh = current_mesh()
    # the mesh dims the work is split over (the result's sharded ones): a
    # replicated argument's gradient there is each rank's part of a sum
    split = {i for i, p in enumerate(placements(out_spec, mesh))
             if p.is_shard()}
    local = []
    for x, spec in zip(args, specs):
        if not isinstance(x, DTensor):
            x = as_replicated(x, mesh)
        places = placements(spec, mesh)
        local.append(x.redistribute(mesh, places).to_local(grad_placements=[
            Partial() if i in split and p.is_replicate() else p
            for i, p in enumerate(places)]))
    with off_mesh():
        # contiguous: the DTensor's strides are taken from it, and later
        # views are decided on them
        out = fn(*local, **kwargs).contiguous()
    return DTensor.from_local(out, mesh, placements(out_spec, mesh),
                              run_check=False)


def rows(x):
    """``x`` with only its leading (batch) dim sharded, over the data
    axes (replicate-fallback; a no-op off a mesh): what a matmul that
    folds (batch, sequence) into one dim needs of a sequence-parallel
    activation (DTensor cannot fold a sharded dim into the one before
    it)."""
    if current_mesh() is None:
        return x
    return constrain(x, dp_axes_spec(), *([None] * (x.ndim - 1)))


def constrain(x, *dims):
    """``x`` redistributed to the spec ``dims`` on the current mesh,
    after the replicate-fallback (:func:`fit_spec`); ``x`` itself off a
    mesh. On a mesh ``x`` must be a DTensor: a plain tensor raises
    ``TypeError`` rather than pass through unplaced."""
    mesh = current_mesh()
    if mesh is None:
        return x
    return _place(x, mesh, dims)


def _place(x, mesh, dims):
    """``x`` redistributed to the spec ``dims`` on ``mesh`` after the
    replicate-fallback; a plain tensor raises ``TypeError``."""
    if not _is_dtensor(x):
        raise TypeError(f"constrain on a mesh needs a DTensor, got a plain "
                        f"{tuple(x.shape)} tensor")
    return x.redistribute(mesh, placements(fit_spec(dims, x.shape, mesh),
                                           mesh))


def settle(x):
    """A DTensor with pending partial sums reduced to replicated (its
    shards kept); anything else as it is."""
    if not _is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    # pinned: the gradient comes back replicated, which the reduction's
    # backward takes to the pending sum (a sharded one it may not)
    return pin(x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements]))


def pin(x):
    """``x`` as it is, its gradient brought back to ``x``'s placements
    (a redistribution to the same placements; anything but a DTensor
    as it is). Put after a reshape that merges dims, so the backward's
    split sees the forward's layout."""
    if not _is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, x.placements)


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor
        if isinstance(grad, DTensor):
            # a DTensor's contiguous() reads its global strides, not the
            # local tensor's
            shape = tuple(grad.shape)
            stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
            return DTensor.from_local(grad.to_local().contiguous(),
                                      grad.device_mesh, grad.placements,
                                      run_check=False, shape=shape,
                                      stride=stride)
        return grad.contiguous()


def contiguous_grad(x):
    """``x`` as it is, its gradient made contiguous on the way back (a
    no-op off a mesh). Put after a reshape that splits dims: its backward
    merges them again with a view, which a DTensor's local tensor of
    another layout than its global strides promise cannot take."""
    if current_mesh() is None:
        return x
    return _ContiguousGrad.apply(x)


def foldable(x, first: int, last: int):
    """``x`` with dims ``first + 1 .. last`` replicated where a mesh dim
    shards them, so that dims ``first .. last`` can fold into one (only
    the leading dim of a fold may stay sharded; some PyTorch versions
    refuse the others). Anything but a DTensor as it is."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    inner = range(first % x.ndim + 1, last % x.ndim + 1)
    places = [Replicate() if p.is_shard() and p.dim in inner else p
              for p in x.placements]
    if places == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, places)


def whole_chunks(x, dim: int, n: int):
    """``x`` with its dim ``dim`` replicated where the mesh dims that
    shard it do not divide ``n``, the number of groups the dim is about
    to be split into (heads, for example): DTensor cannot split a dim
    whose shards cut a group. Anything else as it is."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim %= x.ndim
    places = list(x.placements)
    cut = [i for i, p in enumerate(places) if p.is_shard(dim)]
    if n % math.prod(x.device_mesh.size(i) for i in cut) == 0:
        return x
    for i in cut:
        places[i] = Replicate()
    return x.redistribute(x.device_mesh, places)


def replicated(x):
    """A DTensor redistributed to replicated on every mesh dim, its
    local tensor the full value (pending sums reduced); anything else
    as it is."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh,
                          [Replicate()] * x.device_mesh.ndim).to_local()


def as_replicated(x, mesh):
    """The inverse of :func:`replicated`: ``x``, the same full value on
    every rank, as a replicated DTensor on ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _LogSumExp(torch.autograd.Function):
    """ATen's logsumexp and its backward, op for op, on DTensors."""

    @staticmethod
    def forward(ctx, x, dim):
        m = torch.amax(x, dim=dim, keepdim=True)
        m = torch.where(m.abs() == float("inf"), 0.0, m)
        out = torch.sum(torch.exp(x - m), dim=dim).log() + m.squeeze(dim)
        ctx.save_for_backward(x, out)
        ctx.dim = dim
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return (grad.unsqueeze(ctx.dim)
                * torch.exp(x - out.unsqueeze(ctx.dim))), None


def logsumexp(x, dim: int):
    """``torch.logsumexp(x, dim)``; on a mesh written out as ATen computes
    it (max, exp of the difference, sum, log, plus the max; the backward
    ``grad * exp(x - result)``), so that a dim sharded over the
    vocabulary reduces two small pending results instead of gathering
    ``x``."""
    if current_mesh() is None:
        return torch.logsumexp(x, dim=dim)
    return _LogSumExp.apply(x, dim)


def dp_axes_spec():
    """('pod','data') | 'data' for the current mesh (activation batch dim)."""
    mesh = current_mesh()
    if mesh is None or "pod" not in mesh_axes(mesh):
        return "data"
    return ("pod", "data")


def data_axes(mesh):
    """('pod','data') on multi-pod meshes, else ('data',): the gradient
    all-reduce group."""
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def _dp_size(mesh) -> int:
    axes = mesh_axes(mesh)
    return axes["data"] * axes.get("pod", 1)


def _dpa(mesh):
    dp = data_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def param_spec(path: str, shape: tuple, mesh, cfg: ModelConfig) -> tuple:
    """The spec of one parameter by path and (stacked) shape, the
    reference's rule: one tensor-parallel dim over 'model' chosen by
    role, then FSDP: the largest remaining divisible dim over the data
    axes. Role rules index from the end, so leading stack dims shift
    nothing. ``path`` is taken as given: the reference's own form
    (:func:`jax_path`) never fires the ``endswith("wo")`` /
    ``endswith("wi")`` rules, the plain ``"groups/0/mlp/wo"`` does."""
    axes = mesh_axes(mesh)
    dpa = _dpa(mesh)
    rank = len(shape)
    dims: list = [None] * rank
    name = path.lower()

    def try_model(dim: int) -> bool:
        dim = dim % rank if -rank <= dim < rank else -1
        if dim < 0:
            return False
        if (dims[dim] is None and shape[dim] % axes["model"] == 0
                and shape[dim] > 1):
            dims[dim] = "model"
            return True
        return False

    # ---- the tensor-parallel dim ----
    n_experts = cfg.moe.num_experts if cfg.moe else -1
    is_expert_stack = (
        n_experts > 1 and rank >= 3 and "router" not in name
        and any(s == n_experts for s in shape[:-2]))
    if is_expert_stack:
        # EP: the experts dim (first occurrence left of the matmul dims)
        e_dim = next(i for i, s in enumerate(shape[:-2]) if s == n_experts)
        if shape[e_dim] % axes["model"] == 0:
            dims[e_dim] = "model"
    elif any(k in name for k in ("wq", "wk", "wv")) or (
            "wo" in name and rank >= 3 and shape[-1] <= 512):
        try_model(-2)                # (.., d, H, hd): heads
    elif "wi_gate" in name or "wi_up" in name or name.endswith("wi"):
        try_model(-1)                # (.., d, f): d_ff
    elif name.endswith("wo") or "out_proj" in name:
        try_model(-2)                # (.., f, d): d_ff (contracting)
    elif "table" in name:
        try_model(-2)                # (V, d): vocab
    elif "in_proj" in name or "router" in name:
        try_model(-1)

    # ---- FSDP: the largest remaining divisible dim over the data axes ----
    order = sorted(range(rank), key=lambda i: -shape[i])
    for i in order:
        if dims[i] is None and shape[i] % _dp_size(mesh) == 0 and shape[i] > 1:
            dims[i] = dpa
            break
    return tuple(dims)


def unstack_spec(spec: tuple, n_stack: int, shape: tuple, mesh) -> tuple:
    """The spec of one entry of a stacked leaf: ``spec`` (of the stacked
    ``shape``) without its first ``n_stack`` dims. An axis the stacked
    spec puts on a stack dim moves to the entry's largest dim that is
    free and that it divides (the FSDP rule's order), else the entry is
    replicated over it."""
    axes = mesh_axes(mesh)
    inner = list(spec[n_stack:])
    tail = shape[n_stack:]
    for entry in spec[:n_stack]:
        if entry is None:
            continue
        size = _entry_size(entry, axes)
        for i in sorted(range(len(tail)), key=lambda i: -tail[i]):
            if inner[i] is None and tail[i] % size == 0 and tail[i] > 1:
                inner[i] = entry
                break
    return tuple(inner)


def param_shardings(params, mesh, cfg: ModelConfig) -> dict:
    """{the reference's leaf path: its spec} of a port model's
    parameters, each on its stacked shape (``convert.lm_leaf_entries``)
    and the reference's own path string (:func:`jax_path`)."""
    from repro_torch import convert
    return {path: param_spec(jax_path(path), dims + shape, mesh, cfg)
            for path, (dims, shape, _) in
            convert.lm_leaf_entries(params).items()}


def param_layouts(params, mesh, cfg: ModelConfig) -> dict:
    """{leaf path: (the reference's spec of the stacked leaf, the spec of
    one of its per-layer parameters, :func:`unstack_spec`)}."""
    from repro_torch import convert
    out = {}
    for path, (dims, shape, _) in convert.lm_leaf_entries(params).items():
        ref = param_spec(jax_path(path), dims + shape, mesh, cfg)
        out[path] = (ref, unstack_spec(ref, len(dims), dims + shape, mesh))
    return out


def batch_spec(shape_cfg: ShapeConfig, mesh) -> tuple:
    """Token batches shard rows over the data axes (one axis by its name,
    as ``PartitionSpec`` normalises a tuple of one)."""
    return (_dpa(mesh),)


def _tree_map(fn, tree):
    """``fn`` over the leaves (anything with a ``shape``) of nested
    dicts, lists, tuples and NamedTuples; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def batch_shardings(batch_shape, mesh):
    """The spec of every leaf of a batch: rows over the data axes, ()
    for a scalar."""
    dpa = _dpa(mesh)
    return _tree_map(lambda leaf: () if len(leaf.shape) == 0 else (dpa,),
                     batch_shape)


def activation_spec(shape: tuple, mesh) -> tuple:
    """The reference's residual-stream rule (its
    ``activation_constraint``) on a (B, S, D) shape: the batch over the
    data axes, the sequence over 'model' when S > 1 (sequence
    parallelism)."""
    return (_dpa(mesh), "model" if shape[1] > 1 else None, None)


def activation_constraint(x, mesh):
    """A (B, S, D) DTensor on ``mesh`` placed by :func:`activation_spec`
    after the replicate-fallback (as :func:`constrain`); anything of
    another rank as it is. The model's sequence-parallel sites
    (``transformer._sp``) call it."""
    if x.ndim != 3:
        return x
    return _place(x, mesh, activation_spec(tuple(x.shape), mesh))


def cache_spec(shape: tuple, mesh) -> tuple:
    """The reference's decode-cache rule on one stacked cache leaf: dim
    1 (the batch after one stack dim) over the data axes when they
    divide it, and on a leaf of 5 dims or more dim 2 (the sequence of
    (L, B, S, Hkv, hd)) over 'model' when it divides. The rule reads
    those indices whatever the leaf: zamba2's (G, 6, B, ...) SSM states
    get the data axes on the 6 when they divide it."""
    axes = mesh_axes(mesh)
    dims = [None] * len(shape)
    if len(shape) >= 2:
        dims[1] = _dpa(mesh) if shape[1] % _dp_size(mesh) == 0 else None
    if len(shape) >= 5 and shape[2] % axes["model"] == 0:
        dims[2] = "model"
    return tuple(dims)


def cache_shardings(cache_shape, mesh):
    """The spec of every leaf of a stacked cache tree (the reference's
    layout, ``Model.cache_specs``), by :func:`cache_spec`."""
    return _tree_map(lambda leaf: cache_spec(tuple(leaf.shape), mesh),
                     cache_shape)


# ---------------------------------------------------------------------------
# Placing the port's tensors
# ---------------------------------------------------------------------------

def distribute(x, mesh, spec):
    """``x`` (the same full tensor on every rank, or a meta tensor) as a
    DTensor of ``spec``: each rank keeps its own shard, nothing moves."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements(spec, mesh),
                             src_data_rank=None)


def place_params(params, mesh, cfg: ModelConfig) -> dict:
    """Replace every parameter of a port model by a DTensor of its
    per-layer spec (:func:`param_layouts`), keeping ``requires_grad``.
    Returns the layouts."""
    from repro_torch import convert
    layouts = param_layouts(params, mesh, cfg)
    entries = convert.lm_leaf_entries(params)
    owners = {id(p): (mod, name) for mod in params.modules()
              for name, p in mod.named_parameters(recurse=False)}
    for path, (_, _, ps) in entries.items():
        spec = layouts[path][1]
        for p in ps:
            mod, name = owners[id(p)]
            setattr(mod, name, torch.nn.Parameter(
                distribute(p.detach(), mesh, spec),
                requires_grad=p.requires_grad))
    return layouts


def place_batch(batch: dict, mesh) -> dict:
    """Every leaf of a batch as a DTensor of :func:`batch_shardings`."""
    specs = batch_shardings(batch, mesh)
    return {k: distribute(x, mesh, specs[k]) for k, x in batch.items()}


def cache_stack_dims(cfg: ModelConfig) -> dict:
    """{top-level key of the port's caches: the reference's stack dims}
    (a list of per-layer caches has key None)."""
    from repro_torch.models import transformer as T
    fam = cfg.family
    if fam == "ssm":
        return {None: (cfg.num_layers,)}
    if fam == "hybrid":
        ngroups, tail = T.zamba_layout(cfg)
        return {"groups_ssm": (ngroups, T.ZAMBA_GROUP),
                "groups_kv": (ngroups,), "tail_ssm": (tail,)}
    if fam == "audio":
        return {"self": (cfg.num_decoder_layers,),
                "cross": (cfg.num_decoder_layers,)}
    return {None: (T._group_layout(cfg)[1],)}


def place_caches(cfg: ModelConfig, caches, mesh):
    """The port's decode caches (one per layer, ``Model.cache_init``) as
    DTensors: each leaf takes the reference's rule on its stacked shape
    (:func:`cache_spec`), stack dims dropped (:func:`unstack_spec`)."""
    stacks = cache_stack_dims(cfg)

    def one(lead):
        def place(x):
            full = lead + tuple(x.shape)
            spec = unstack_spec(cache_spec(full, mesh), len(lead), full, mesh)
            return distribute(x, mesh, spec)
        return place

    if None in stacks:
        return _tree_map(one(stacks[None]), caches)
    return {k: _tree_map(one(stacks[k]), v) for k, v in caches.items()}


def constrain_like_params(tree: dict, cfg: ModelConfig):
    """Every leaf of a params-shaped dict ({leaf path: stacked tensor},
    the gradient accumulator) redistributed to the reference's spec of
    its path and shape (:func:`param_spec`); the tree itself off a
    mesh."""
    mesh = current_mesh()
    if mesh is None:
        return tree
    return {path: x.redistribute(mesh, placements(param_spec(
        jax_path(path), tuple(x.shape), mesh, cfg), mesh))
        for path, x in tree.items()}
