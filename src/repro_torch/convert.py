"""Carry a network and its state across from the JAX reference.

The reference's ``NetworkParams`` and ``NetworkState`` leaves, as numpy
arrays (``numpy.asarray`` of each), become the port's containers on a
given device with the same dtypes and shapes, so that both sides hold
the same bytes (``metrics.bytes_per_synapse`` agrees). The inverse
functions give the port's leaves back as numpy arrays under the same
names. The STDP traces (``x_pre``, ``x_post``) and the five
``GuardState`` leaves come across when the state has them. The stacked
distributed state (``DistState``, the layout of the reference's
``stacked_state_template``: every leaf with a leading shard axis) comes
across by leaf name too (``DIST_LEAVES``), its ``PlasticState`` under
STDP included (the reference's ``plastic`` leaves ``w_local``, ``rem_w``,
``traces.x_pre``, ``traces.x_post`` and ``trace_ext``, named by their
last part), and under the guard its ``GuardState`` leaves (``tripped``,
``trip_code``, ``trip_step``, ``sat_run``, ``checksum_fails``, one per
shard). A checkpoint's tree, the ``DistState`` of numpy leaves that
``checkpoint.checkpointer.restore`` gives back against
``exchange.stacked_state_template``, goes onto a mesh with
``exchange.stack_from_host``. The batched service's tenants (every
state leaf, and the plastic weights under STDP, with a leading tenant
axis, as the reference's ``init_tenants`` and ``run_chunk`` give them)
come across with the same functions, but for their step counters,
which stay on the device (:func:`tenants_state_from_numpy`). The
batched distributed state
(``exchange.make_batched_distributed_run(..., with_state=True)``) has
the reference's layout, every leaf (n_shards, b_local, ...), and
comes across with the ``DistState`` functions as it is;
:func:`merge_batch_shards` folds the batch shards of a run over several
(the reference's batch-major shard axis) into the (S, B, ...) layout of
one process holding every tenant. The LM zoo's parameters and decode
caches come across with :func:`lm_params_from_numpy` /
:func:`lm_params_to_numpy` and :func:`lm_cache_from_numpy` /
:func:`lm_cache_to_numpy`, for every family: the reference's stacked
layers (its groups, mamba's blocks, zamba's (G, 6) groups and tail,
whisper's encoder and decoder) are unstacked into the port's one module
or cache per layer and stacked back. A training state comes across by
the reference's leaf paths: :func:`lm_leaf_entries` names the port's
parameters of each reference leaf (the trainer stacks its gradients and
its optimizer's leaves that way), :func:`lm_grads_from_numpy` /
:func:`lm_grads_to_numpy` carry a gradient tree, and
:func:`lm_opt_from_numpy` / :func:`lm_opt_to_numpy` the optimizer state
(AdamW's ``m`` and ``v``, float32 or ``Q8`` as ``{"q", "scale"}``,
adafactor's ``v`` slots ``{"vr", "vc"}`` or ``{"v"}``, and the int8-EF
residual as ``{"ef": {"residual": tree}}``). This module imports
neither JAX nor the reference: the caller hands it arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.exchange import DistState, PlasticState
from repro_torch.core.network import NetworkParams, NetworkState
from repro_torch.core.neuron import LIFState
from repro_torch.core.plasticity import STDPState
from repro_torch.models import attention as A
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model
from repro_torch.optim.optimizer import Q8, leaf_order
from repro_torch.runtime.compression import EFState
from repro_torch.runtime.integrity import GuardState

PARAM_LEAVES = ("w_local", "rem_flat", "rem_w", "local_outdeg")
STATE_LEAVES = ("v", "c", "refrac", "hist", "t", "spike_count",
                "event_count")
STDP_LEAVES = STDPState._fields
GUARD_LEAVES = GuardState._fields
# DistState's leaves (``v``, ``c``, ``refrac`` are its LIFState's);
# ``ext_pending`` only under ExchangeConfig.pipelined, the PlasticState's
# only under STDP (``x_pre``, ``x_post`` its traces'; ``trace_ext`` under
# aer_sparse)
PLASTIC_LEAVES = ("w_local", "rem_w", "x_pre", "x_post", "trace_ext")
DIST_LEAVES = ("v", "c", "refrac", "hist_ext", "pending", "t",
               "spike_count", "event_count", "aer_sat", "ext_pending",
               "last_spike_t", "isi_sum", "isi_sumsq",
               "isi_count") + PLASTIC_LEAVES + GUARD_LEAVES


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def params_from_numpy(*, w_local, rem_flat, rem_w, local_outdeg,
                      device="cuda") -> NetworkParams:
    return NetworkParams(
        w_local=_tensor(w_local, device),
        rem_flat=_tensor(rem_flat, device),
        rem_w=_tensor(rem_w, device),
        local_outdeg=_tensor(local_outdeg, device),
    )


def state_from_numpy(*, v, c, refrac, hist, t, spike_count, event_count,
                     stdp: dict | None = None, guard: dict | None = None,
                     device="cuda") -> NetworkState:
    """The step counter ``t`` stays on the host (see core/network.py).
    ``stdp`` and ``guard`` map the leaves of ``STDP_LEAVES`` and
    ``GUARD_LEAVES`` to arrays, when the state has them."""
    return NetworkState(
        lif=LIFState(v=_tensor(v, device), c=_tensor(c, device),
                     refrac=_tensor(refrac, device)),
        hist=_tensor(hist, device),
        t=_tensor(t, "cpu"),
        spike_count=_tensor(spike_count, device),
        event_count=_tensor(event_count, device),
        stdp=None if stdp is None else STDPState(
            **{k: _tensor(stdp[k], device) for k in STDP_LEAVES}),
        guard=None if guard is None else GuardState(
            **{k: _tensor(guard[k], device) for k in GUARD_LEAVES}),
    )


def tenants_state_from_numpy(*, device="cuda", **leaves) -> NetworkState:
    """B tenants' state (``core/batched.py``) from leaves named as
    :func:`state_from_numpy` takes them, each with a leading tenant axis;
    the (B,) step counters go to ``device``, where the batched engine
    advances them. Their params are :func:`params_from_numpy`'s, with
    (B, ...) plastic weights under STDP; :func:`params_to_numpy` and
    :func:`state_to_numpy` take both back."""
    state = state_from_numpy(device=device, **leaves)
    return state._replace(t=state.t.to(device))


def params_to_numpy(params: NetworkParams) -> dict:
    return {name: getattr(params, name).cpu().numpy() for name in PARAM_LEAVES}


def state_to_numpy(state: NetworkState) -> dict:
    """The leaves of ``STATE_LEAVES``, and ``stdp`` / ``guard`` dicts of
    theirs when the state has them."""
    leaves = dict(v=state.lif.v, c=state.lif.c, refrac=state.lif.refrac,
                  hist=state.hist, t=state.t, spike_count=state.spike_count,
                  event_count=state.event_count)
    out = {name: leaves[name].cpu().numpy() for name in STATE_LEAVES}
    for key, sub in (("stdp", state.stdp), ("guard", state.guard)):
        if sub is not None:
            out[key] = {k: getattr(sub, k).cpu().numpy() for k in sub._fields}
    return out


def dist_state_from_numpy(leaves, device="cuda") -> DistState:
    """The stacked ``DistState`` from its leaves (a mapping with the
    names of ``DIST_LEAVES``, each (S, ...) in process-major shard order,
    e.g. the reference's stacked state as numpy, or (S, b_local, ...),
    the batched runner's layout). ``t`` stays on the host;
    ``ext_pending`` may be absent (unpipelined), and so may the plastic
    leaves (a static state) and the guard's (no guard)."""
    def get(name, dev=device):
        return _tensor(leaves[name], dev) if name in leaves else None

    plastic = None
    if "w_local" in leaves:
        plastic = PlasticState(
            w_local=get("w_local"), rem_w=get("rem_w"),
            traces=STDPState(x_pre=get("x_pre"), x_post=get("x_post")),
            trace_ext=get("trace_ext"))
    return DistState(
        lif=LIFState(v=get("v"), c=get("c"), refrac=get("refrac")),
        hist_ext=get("hist_ext"), pending=get("pending"),
        t=get("t", "cpu"), spike_count=get("spike_count"),
        event_count=get("event_count"), plastic=plastic,
        aer_sat=get("aer_sat"),
        ext_pending=get("ext_pending"), last_spike_t=get("last_spike_t"),
        isi_sum=get("isi_sum"), isi_sumsq=get("isi_sumsq"),
        isi_count=get("isi_count"),
        guard=(GuardState(**{k: get(k) for k in GUARD_LEAVES})
               if "tripped" in leaves else None))


def dist_state_to_numpy(state: DistState) -> dict:
    """The leaves of ``DIST_LEAVES`` that the state has, as numpy, in the
    state's layout ((S, ...), or the batched runner's (S, b_local,
    ...))."""
    leaves = dict(state._asdict(), v=state.lif.v, c=state.lif.c,
                  refrac=state.lif.refrac)
    if state.plastic is not None:
        leaves.update(state.plastic._asdict(),
                      **state.plastic.traces._asdict())
    if state.guard is not None:
        leaves.update(state.guard._asdict())
    return {name: leaves[name].cpu().numpy() for name in DIST_LEAVES
            if leaves.get(name) is not None}


def merge_batch_shards(leaves: dict, batch_shards: int) -> dict:
    """(K*S, b_local, ...) leaves of a batched run over K batch shards
    (the reference's batch-major (n_shards, b_local, ...) state, or the
    ranks' saved states stacked in rank order) -> (S, K*b_local, ...):
    every tenant on each of the S spatial shards, in tenant order, the
    layout of one process holding them all."""
    out = {}
    for name, x in leaves.items():
        s = x.shape[0] // batch_shards
        y = np.moveaxis(x.reshape(batch_shards, s, *x.shape[1:]), 0, 1)
        out[name] = y.reshape(s, batch_shards * x.shape[1], *x.shape[2:])
    return out


# ---------------------------------------------------------------------------
# The LM zoo: parameters and decode caches
# ---------------------------------------------------------------------------

def lm_flatten(tree, prefix="") -> dict:
    """An LM pytree (nested dicts, lists and tuples of arrays) ->
    {"groups.0.attn.wq": array}, the reference's leaf paths; a ``None``
    subtree (zamba's absent tail) has no leaves, as in JAX."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(lm_flatten(sub, f"{prefix}.{key}" if prefix
                              else str(key)))
    return out


def _listed(node):
    """Dicts keyed "0", "1", ... back into lists, all the way down."""
    if not isinstance(node, dict):
        return node
    node = {k: _listed(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def lm_unflatten(flat: dict) -> dict:
    """The inverse of :func:`lm_flatten`, the decoder-only ``groups`` as
    a list of slots."""
    tree: dict = {}
    for path, leaf in flat.items():
        node, keys = tree, path.split(".")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf
    return _listed(tree)


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _lm_tensor(x, device) -> torch.Tensor:
    """A numpy leaf as a tensor; bfloat16 (``ml_dtypes``, as JAX hands
    it) through its 16-bit pattern."""
    x = np.ascontiguousarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(x.copy()).to(device)


def _lm_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy (a DTensor's full value: a collective
    every rank of its mesh takes part in)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _tree_path(cfg, name: str):
    """A port parameter's name -> (the reference's leaf path, its index
    in the reference's stack; () for an unstacked leaf). Decoder-only
    layer ``l`` is slot ``l % gsize`` of group ``l // gsize``; zamba's
    ``groups.g.j`` is (g, j) of its (G, 6) stack."""
    head, _, rest = name.partition(".")
    if head == "layers":
        gsize = T._group_layout(cfg)[0]
        layer, rest = rest.split(".", 1)
        group, slot = divmod(int(layer), gsize)
        return f"groups.{slot}.{rest}", (group,)
    if head == "groups":
        g, j, rest = rest.split(".", 2)
        return f"groups.{rest}", (int(g), int(j))
    if head in ("blocks", "tail", "encoder", "decoder"):
        i, rest = rest.split(".", 1)
        return f"{head}.{rest}", (int(i),)
    return name, ()


def _stacks(params) -> dict:
    """{reference path: (stack dims, port names by index, leaf shape,
    dtype name)} of a port model's parameters."""
    out: dict = {}
    for name, p in params.named_parameters():
        path, index = _tree_path(params.cfg, name)
        dims, names, _, _ = out.setdefault(
            path, [[0] * len(index), {}, tuple(p.shape),
                   _dtype_name(p.dtype)])
        out[path][0] = [max(d, i + 1) for d, i in zip(dims, index)]
        names[index] = name
    return {path: (tuple(dims), names, shape, dtype)
            for path, (dims, names, shape, dtype) in out.items()}


def lm_params_from_numpy(cfg, tree, device="cuda"):
    """The reference's ``build_model(cfg).init(key)`` pytree, as nested
    dicts and lists of numpy arrays, -> the port's params (the family's
    stack of ``transformer.py``) on ``device``: entry ``index`` of a
    stacked leaf becomes the layer's parameter (:func:`_tree_path`).
    Every leaf's dtype and shape is checked; a missing or extra leaf
    raises, naming its path."""
    params = build_model(cfg, device="meta").init()
    stacks = _stacks(params)
    flat = lm_flatten(tree)
    missing = sorted(set(stacks) - set(flat))
    extra = sorted(set(flat) - set(stacks))
    if missing or extra:
        raise KeyError(f"{cfg.name}: leaves missing {missing}, extra {extra}")
    for path, (dims, _, shape, dtype) in stacks.items():
        got = (tuple(flat[path].shape), flat[path].dtype.name)
        if got != (dims + shape, dtype):
            raise ValueError(f"{cfg.name}: leaf {path} is {got[1]} "
                             f"{got[0]}, expected {dtype} {dims + shape}")
    dev = torch.device(device)
    for path, (_, names, _, _) in stacks.items():
        for index, name in names.items():
            owner, _, attr = name.rpartition(".")
            setattr(params.get_submodule(owner), attr, torch.nn.Parameter(
                _lm_tensor(flat[path][index], dev), requires_grad=False))
    return params


def lm_params_to_numpy(params) -> dict:
    """The exact inverse of :func:`lm_params_from_numpy`: the
    reference's pytree of numpy arrays, layers stacked back."""
    got = dict(params.named_parameters())
    flat = {}
    for path, (dims, names, shape, _) in _stacks(params).items():
        leaves = {index: _lm_numpy(got[name])
                  for index, name in names.items()}
        if not dims:
            flat[path] = leaves[()]
            continue
        first = next(iter(leaves.values()))
        out = np.empty(dims + shape, first.dtype)
        for index, leaf in leaves.items():
            out[index] = leaf
        flat[path] = out
    return lm_unflatten(flat)


def _cache_leaves(cfg, cls):
    """(leaf names, their trailing shapes after the batch axis with None
    for the sequence axis, their dtypes) of a ``KVCache`` or
    ``SSMCache``."""
    if cls is A.KVCache:
        tail = (None, cfg.attn.num_kv_heads, cfg.head_dim)
        return {"k": (tail, cfg.dtype), "v": (tail, cfg.dtype)}
    inner, n, heads = S._dims(cfg.ssm, cfg.d_model)
    return {"state": ((heads, n, cfg.ssm.head_dim), "float32"),
            "conv_buf": ((cfg.ssm.d_conv - 1, inner + 2 * n), cfg.dtype)}


def _unstack(cfg, name, cls, arrays, lead, device):
    """The reference's stacked cache ``arrays`` (a ``cls``'s leaves, each
    with the leading stack dims ``lead``) -> nested lists (one level a
    stack dim) of ``cls``, checked leaf by leaf."""
    leaves = _cache_leaves(cfg, cls)
    if len(arrays) != len(leaves):
        raise KeyError(f"{cfg.name}: cache {name} holds {len(arrays)} "
                       f"leaves, expected {tuple(leaves)}")
    for (field, (tail, dtype)), x in zip(leaves.items(), arrays):
        want = lead + (None,) + tail
        if (x.ndim != len(want) or x.dtype.name != dtype
                or any(w is not None and w != g
                       for w, g in zip(want, x.shape))):
            shape = ", ".join("?" if w is None else str(w) for w in want)
            raise ValueError(f"{cfg.name}: cache {name}.{field} is "
                             f"{x.dtype.name} {x.shape}, expected {dtype} "
                             f"({shape})")

    def build(index):
        if len(index) == len(lead):
            return cls(*(_lm_tensor(x[index], device) for x in arrays))
        return [build(index + (i,)) for i in range(lead[len(index)])]
    return build(())


def _stack(caches, depth: int) -> tuple:
    """The inverse of :func:`_unstack`: nested lists of caches -> one
    stacked numpy array per leaf."""
    def flat(node, d):
        return [c for sub in node for c in flat(sub, d - 1)] if d else [node]
    lead, node = [], caches
    for _ in range(depth):
        lead.append(len(node))
        node = node[0] if node else None
    items = flat(caches, depth)
    return tuple(np.stack([_lm_numpy(getattr(c, f)) for c in items]).reshape(
        tuple(lead) + tuple(getattr(items[0], f).shape))
        for f in items[0]._fields)


def lm_cache_from_numpy(cfg, caches, device="cuda"):
    """The reference's decode caches -> the port's, on ``device``:
    - dense, moe, vlm (``lm_cache_init``: one (k, v) pair per slot of the
      layer group, each (n_groups, B, S, Hkv, hd)) -> one ``KVCache``
      per layer;
    - ssm (one (state, conv_buf) pair, each (L, B, ...)) -> one
      ``SSMCache`` per layer;
    - hybrid ({"groups_ssm": (state, conv_buf) (G, 6, B, ...),
      "groups_kv": (k, v) (G, B, ...), "tail_ssm": (tail, B, ...) or
      None}) -> the same keys, G lists of 6 ``SSMCache``, G ``KVCache``,
      a list of ``SSMCache``;
    - audio ({"self": (k, v), "cross": (k, v)}, each (L_dec, B, ...))
      -> a list of ``KVCache`` each."""
    fam = cfg.family
    if fam == "ssm":
        return _unstack(cfg, "blocks", S.SSMCache, caches,
                        (cfg.num_layers,), device)
    if fam == "hybrid":
        ngroups, tail = T.zamba_layout(cfg)
        if set(caches) != {"groups_ssm", "groups_kv", "tail_ssm"}:
            raise KeyError(f"{cfg.name}: cache keys {sorted(caches)}")
        return {
            "groups_ssm": _unstack(cfg, "groups_ssm", S.SSMCache,
                                   caches["groups_ssm"],
                                   (ngroups, T.ZAMBA_GROUP), device),
            "groups_kv": _unstack(cfg, "groups_kv", A.KVCache,
                                  caches["groups_kv"], (ngroups,), device),
            "tail_ssm": (_unstack(cfg, "tail_ssm", S.SSMCache,
                                  caches["tail_ssm"], (tail,), device)
                         if tail else [])}
    if fam == "audio":
        if set(caches) != {"self", "cross"}:
            raise KeyError(f"{cfg.name}: cache keys {sorted(caches)}")
        return {key: _unstack(cfg, key, A.KVCache, caches[key],
                              (cfg.num_decoder_layers,), device)
                for key in ("self", "cross")}
    gsize, ngroups, _ = T._group_layout(cfg)
    if len(caches) != gsize:
        raise KeyError(f"{cfg.name}: {len(caches)} cache slots, expected "
                       f"{gsize}")
    slots = [_unstack(cfg, str(slot), A.KVCache, caches[slot], (ngroups,),
                      device) for slot in range(gsize)]
    return [slots[slot][group] for group, slot in
            (divmod(layer, gsize) for layer in range(cfg.num_layers))]


def lm_cache_to_numpy(cfg, caches):
    """The exact inverse of :func:`lm_cache_from_numpy`: the reference's
    layout of stacked numpy arrays, a tuple of leaves for each
    ``KVCache`` or ``SSMCache`` stack (zamba's empty tail as None)."""
    fam = cfg.family
    if fam == "ssm":
        return _stack(caches, 1)
    if fam == "hybrid":
        return {"groups_ssm": _stack(caches["groups_ssm"], 2),
                "groups_kv": _stack(caches["groups_kv"], 1),
                "tail_ssm": (_stack(caches["tail_ssm"], 1)
                             if caches["tail_ssm"] else None)}
    if fam == "audio":
        return {key: _stack(caches[key], 1) for key in ("self", "cross")}
    gsize, _, _ = T._group_layout(cfg)
    return [_stack(caches[slot::gsize], 1) for slot in range(gsize)]


def lm_leaf_entries(params) -> dict:
    """{the reference's leaf path: (its stack dims, the leaf shape of one
    entry, the port's parameters of its entries in index order)}, in the
    reference's flatten order (``optimizer.leaf_order``); an unstacked
    leaf has dims () and one parameter."""
    got = dict(params.named_parameters())
    out = {}
    for path, (dims, names, shape, _) in sorted(
            _stacks(params).items(), key=lambda kv: leaf_order(kv[0])):
        out[path] = (dims, shape, [got[names[i]] for i in sorted(names)])
    return out


def lm_grads_from_numpy(tree, device="cuda") -> dict:
    """The reference's gradient tree (params-shaped, numpy) -> the
    port's gradients, {leaf path: stacked tensor}."""
    return {path: _lm_tensor(x, device)
            for path, x in lm_flatten(tree).items()}


def lm_grads_to_numpy(grads: dict) -> dict:
    """The inverse of :func:`lm_grads_from_numpy`."""
    return lm_unflatten({path: _lm_numpy(x) for path, x in grads.items()})


def lm_opt_to_numpy(opt: dict) -> dict:
    """The port's optimizer state -> the reference's layout of numpy
    trees (see the module's docstring)."""
    flat = {}
    for slot, leaves in opt.items():
        if isinstance(leaves, EFState):
            slot, leaves = "ef.residual", leaves.residual
        for path, x in leaves.items():
            key = f"{slot}.{path}"
            if isinstance(x, Q8):
                flat[f"{key}.q"] = _lm_numpy(x.q)
                flat[f"{key}.scale"] = _lm_numpy(x.scale)
            elif isinstance(x, dict):
                flat.update({f"{key}.{k}": _lm_numpy(t)
                             for k, t in x.items()})
            else:
                flat[key] = _lm_numpy(x)
    return lm_unflatten(flat)


def lm_opt_from_numpy(tree, shapes: dict, device="cuda") -> dict:
    """The reference's optimizer state (numpy, the layout of
    :func:`lm_opt_to_numpy`) -> the port's, by leaf path; ``shapes`` is
    {leaf path: the leaf's shape} (a ``Q8`` keeps its unpadded shape).
    A key under no known leaf raises, naming it."""
    paths = sorted(shapes, key=len, reverse=True)
    parts: dict = {}
    for key, x in lm_flatten(tree).items():
        slot, _, rest = key.partition(".")
        if slot == "ef":
            field, _, rest = rest.partition(".")
            if field != "residual":
                raise KeyError(f"optimizer leaf {key}: not an EF residual")
        path = next((p for p in paths
                     if rest == p or rest.startswith(p + ".")), None)
        if path is None:
            raise KeyError(f"optimizer leaf {key}: no parameter leaf")
        suffix = rest[len(path) + 1:]
        parts.setdefault(slot, {}).setdefault(path, {})[suffix] = (
            _lm_tensor(x, device))
    out = {}
    for slot, leaves in parts.items():
        got = {}
        for path, sub in leaves.items():
            if set(sub) == {""}:
                got[path] = sub[""]
            elif set(sub) == {"q", "scale"}:
                got[path] = Q8(sub["q"], sub["scale"], tuple(shapes[path]))
            else:
                got[path] = sub
        out[slot] = EFState(residual=got) if slot == "ef" else got
    return out
