"""Checkpoints in the reference's on-disk format, with atomic manifests
and async save (the port of ``repro/checkpoint/checkpointer.py``).

Layout on disk, byte for byte the reference's::

    <dir>/step_000123/
        manifest.json        # step, leaf paths, shapes, dtypes, digest, meta
        arr_00000.npy ...    # one file per leaf (numpy's own format)
    <dir>/LATEST             # atomic pointer (written last)

A tree is NamedTuples, dicts, lists and tuples over leaves (torch
tensors on any device, numpy arrays, Python scalars); ``None`` is no
leaf. Leaves are named by the reference's ``tree_flatten_with_path``
strings (``.lif/.v`` for a NamedTuple field, ``['w']`` for a dict key,
``[0]`` for a list index, joined by ``/``), with dict keys in sorted
order, so each package reads the other's checkpoints. The digest is
sha256 over the first 4096 bytes of each leaf.

Writes are crash-atomic: every save stages into a fresh uniquely named
directory (``_tmp_step_<step>.<pid>.<seq>``), fsyncs arrays and
manifest, then puts it in place with one ``os.replace``, and only then
flips ``LATEST``. A process killed at any instant leaves the previous
checkpoint or the complete new one. Stages orphaned by killed saves are
swept by the next successful save and by :func:`gc_stale_stages`.

:func:`restore` gives back a numpy tree shaped like ``tree_like``
(``convert.dist_state_from_numpy`` puts a stacked state on a device).
:func:`reshard` re-tiles a stacked distributed state (every leaf with a
leading process-major shard axis S, ``exchange.stacked_state_template``)
for another rank count of the same column grid, through the global
coordinates of ``core/partition.py``: bitwise on static nets, and
exactly state-preserving under STDP.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import partition

_STAGE_SEQ = itertools.count()


def _map(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of ``tree`` in the reference's
    flatten order, rebuilding the tree from the results. ``path`` is a
    tuple of ``(kind, key)``: ``"field"`` for a NamedTuple field,
    ``"dict"`` for a dict key, ``"index"`` for a list or tuple index."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, sub, (*path, ("field", f)))
                            for f, sub in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], (*path, ("dict", k)))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, sub, (*path, ("index", i)))
                          for i, sub in enumerate(tree))
    return fn(path, tree)


def _path_str(path) -> str:
    """The reference's key string of a leaf path."""
    fmt = {"field": ".{}", "dict": "[{!r}]", "index": "[{}]"}
    return "/".join(fmt[kind].format(key) for kind, key in path)


def _flatten_with_paths(tree):
    paths, leaves = [], []

    def take(path, leaf):
        paths.append(_path_str(path))
        leaves.append(leaf)
    _map(take, tree)
    return paths, leaves


def _unflatten(tree_like, leaves):
    it = iter(leaves)
    return _map(lambda _path, _leaf: next(it), tree_like)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(torch.empty((), dtype=x.dtype).numpy().dtype)
    return str(np.dtype(x.dtype))


def _head(arr: np.ndarray) -> bytes:
    """The first 4096 bytes of ``arr.tobytes()``, without copying the
    rest of a large array."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    return flat.view(np.uint8)[:4096].tobytes()


def save(ckpt_dir: str, step: int, tree: Any, *, blocking: bool = True,
         meta: Optional[dict] = None):
    """Save a tree. The leaves come to the host here; with
    ``blocking=False`` the file IO runs on a (non-daemon) thread, which
    is returned. ``meta`` (JSON-serialisable) goes into the manifest:
    the run's provenance (the supervisor records the mesh and rank
    count there, :func:`load_manifest` reads it back)."""
    paths, leaves = _flatten_with_paths(tree)
    host_leaves = [_host(x) for x in leaves]

    def _write():
        # a unique stage name: a save killed mid-write leaves an orphan
        # that a retry of the same step never opens
        stage = os.path.join(
            ckpt_dir,
            f"_tmp_step_{step:09d}.{os.getpid()}.{next(_STAGE_SEQ)}")
        final = os.path.join(ckpt_dir, f"step_{step:09d}")
        os.makedirs(stage)
        digest = hashlib.sha256()
        for i, arr in enumerate(host_leaves):
            with open(os.path.join(stage, f"arr_{i:05d}.npy"), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            digest.update(_head(arr))
        manifest = {
            "step": step,
            "paths": paths,
            "shapes": [list(a.shape) for a in host_leaves],
            "dtypes": [str(a.dtype) for a in host_leaves],
            "digest": digest.hexdigest(),
            "meta": meta or {},
        }
        with open(os.path.join(stage, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(stage, final)
        latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(os.path.basename(final))
            f.flush()
            os.fsync(f.fileno())
        os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
        # persist the renames before reporting success
        dfd = os.open(ckpt_dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        gc_stale_stages(ckpt_dir, skip_pid=os.getpid())

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=False)
    t.start()
    return t


def gc_stale_stages(ckpt_dir: str, *, skip_pid: Optional[int] = None) -> int:
    """Remove the ``_tmp_step_*`` stages of saves that were killed
    mid-write; ``skip_pid`` protects that process's own in-flight async
    stages. Returns the number removed; never touches ``step_*``."""
    removed = 0
    try:
        names = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return 0
    for name in names:
        if not name.startswith("_tmp_step_"):
            continue
        parts = name.split(".")
        if (skip_pid is not None and len(parts) >= 2
                and parts[1] == str(skip_pid)):
            continue
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
        removed += 1
    return removed


def latest_step(ckpt_dir: str) -> Optional[int]:
    try:
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            name = f.read().strip()
        return int(name.split("_")[-1])
    except (FileNotFoundError, ValueError):
        return None


def load_manifest(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """A checkpoint's manifest (``meta`` included), without the arrays."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None,
            *, expect_mesh: Optional[tuple] = None):
    """The checkpoint of ``step`` (the latest when None) as a numpy tree
    shaped like ``tree_like``; returns ``(tree, step)``.

    Checks the leaf paths, every shape and dtype of a ``tree_like`` leaf
    that has one (placeholder scalars are skipped; the error names the
    leaf and both shapes) and the digest, in the reference's words.
    ``expect_mesh`` (tiles_y, tiles_x) refuses a checkpoint whose
    ``meta["mesh"]`` differs, naming both: a stacked state is tiled for
    the mesh that wrote it and goes through :func:`reshard` first."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if expect_mesh is not None:
        saved_mesh = manifest.get("meta", {}).get("mesh")
        if saved_mesh is not None and tuple(saved_mesh) != tuple(expect_mesh):
            raise ValueError(
                f"checkpoint mesh mismatch: step {step} was saved on a "
                f"{saved_mesh[0]}x{saved_mesh[1]} tile mesh but this run "
                f"restores onto a {expect_mesh[0]}x{expect_mesh[1]} tile "
                f"mesh — re-tile the stacked state through reshard() "
                f"(DESIGN.md §Elasticity) instead of restoring directly")
    paths, want_leaves = _flatten_with_paths(tree_like)
    if manifest["paths"] != paths:
        raise ValueError(
            "checkpoint tree mismatch:\n saved: %s...\n want: %s..."
            % (manifest["paths"][:3], paths[:3]))
    for path, want, saved_shape, saved_dtype in zip(
            paths, want_leaves, manifest["shapes"], manifest["dtypes"]):
        if not hasattr(want, "shape"):   # placeholder leaf (e.g. int 0)
            continue
        if list(want.shape) != list(saved_shape):
            raise ValueError(
                f"checkpoint shape mismatch at leaf {path!r}: saved "
                f"{tuple(saved_shape)}, want {tuple(want.shape)} "
                f"(step {step} was written for a different geometry)")
        want_dtype = _dtype_name(want)
        if want_dtype != saved_dtype:
            raise ValueError(
                f"checkpoint dtype mismatch at leaf {path!r}: saved "
                f"{saved_dtype}, want {want_dtype}")
    leaves = []
    digest = hashlib.sha256()
    for i in range(len(paths)):
        arr = np.load(os.path.join(d, f"arr_{i:05d}.npy"))
        digest.update(_head(arr))
        leaves.append(arr)
    if digest.hexdigest() != manifest["digest"]:
        raise ValueError(f"checkpoint digest mismatch at step {step}")
    return _unflatten(tree_like, leaves), step


# ---------------------------------------------------------------------------
# Elastic resharding of a stacked distributed state
# ---------------------------------------------------------------------------
#
# Each leaf of a stacked DistState has a leading process-major shard axis
# S and is re-tiled by its field name through the global coordinates:
#
#   column-major  (S, C, ...)          v, c, refrac, w_local, rem_w,
#                                      x_pre, x_post, last_spike_t
#   tile frame    (S, th, tw, N)       pending
#   extended frame (S[, D], th+2r, tw+2r, N)   hist_ext, trace_ext,
#                                      ext_pending: the interiors are
#       assembled globally, zero-padded by r and windowed again for each
#       new tile, so the rebuilt halos are what a run on the new mesh
#       holds (zeros past the sheet's edge)
#   step counter  (S,)                 t: equal on every shard, checked
#   global sums   (S,)                 spike/event counts, ISI moments:
#       the total (integer-valued f32, exact) moves to shard 0
#   per-step flag (S,)                 aer_sat: reset
#   guard         (S,)                 cleared: a run resumes only from
#       a clean checkpoint, so a resharded run starts with a fresh guard

_COLUMN_LEAVES = frozenset(
    {"v", "c", "refrac", "w_local", "rem_w", "x_pre", "x_post",
     "last_spike_t"})
_EXTENDED_LEAVES = frozenset({"trace_ext", "ext_pending"})
_SUM_LEAVES = frozenset(
    {"spike_count", "event_count", "isi_sum", "isi_sumsq", "isi_count"})
_GUARD_ZERO_LEAVES = frozenset(
    {"tripped", "trip_code", "sat_run", "checksum_fails"})


def _reshard_extended(x, from_spec, to_spec):
    """(S, th+2r, tw+2r, *rest) halo-extended frames -> re-tiled."""
    r = from_spec.radius
    interior = x[:, r:r + from_spec.tile_h, r:r + from_spec.tile_w]
    g = partition.tiles_to_global(np.ascontiguousarray(interior), from_spec)
    gp = np.pad(g, [(r, r), (r, r)] + [(0, 0)] * (g.ndim - 2))
    s_new = to_spec.tiles_y * to_spec.tiles_x
    th, tw = to_spec.tile_h, to_spec.tile_w
    out = np.empty((s_new, th + 2 * r, tw + 2 * r, *g.shape[2:]), x.dtype)
    for s in range(s_new):
        ty, tx = partition.shard_tile_coords(to_spec, s)
        out[s] = gp[ty * th:ty * th + th + 2 * r,
                    tx * tw:tx * tw + tw + 2 * r]
    return out


def _reshard_leaf(name: str, x, from_spec, to_spec):
    s_new = to_spec.tiles_y * to_spec.tiles_x
    if name in _COLUMN_LEAVES:
        g = partition.columns_to_global(x, from_spec)
        return partition.global_to_columns(g, to_spec)
    if name == "pending":
        g = partition.tiles_to_global(x, from_spec)
        return partition.global_to_tiles(g, to_spec)
    if name == "hist_ext":
        # (S, D, th+2r, tw+2r, N): each delay slot of the ring
        return np.stack([_reshard_extended(x[:, d], from_spec, to_spec)
                         for d in range(x.shape[1])], axis=1)
    if name in _EXTENDED_LEAVES:
        return _reshard_extended(x, from_spec, to_spec)
    if name == "t":
        if not np.all(x == x.flat[0]):
            raise ValueError(
                f"cannot reshard: step counter 't' disagrees across "
                f"shards ({np.unique(x)}) — the checkpoint is not a "
                f"clean post-step snapshot")
        return np.full((s_new,), x.flat[0], x.dtype)
    if name in _SUM_LEAVES:
        out = np.zeros((s_new,), x.dtype)
        out[0] = x.sum(dtype=np.float64).astype(x.dtype)
        return out
    if name == "aer_sat":
        return np.zeros((s_new,), x.dtype)
    if name in _GUARD_ZERO_LEAVES:
        return np.zeros((s_new,), x.dtype)
    if name == "trip_step":
        return np.full((s_new,), -1, x.dtype)
    raise ValueError(
        f"reshard does not know how to re-tile DistState leaf {name!r} "
        f"of shape {getattr(x, 'shape', None)} — a new DistState field "
        f"needs a mapping rule here (DESIGN.md §Elasticity)")


def reshard(tree: Any, from_spec, to_spec) -> Any:
    """Re-tile a stacked distributed state (numpy leaves, each (S, ...))
    from the mesh that wrote it to another mesh of the same column grid.
    ``from_spec`` / ``to_spec`` are ``core.partition.TileSpec``s
    (``make_rank_tile_spec(cfg, R)`` and ``(cfg, R')``). The result's
    shard axis matches ``to_spec``: feed it to ``make_distributed_run(...,
    replicate_state=True)`` on the new mesh."""
    gh_f = from_spec.tiles_y * from_spec.tile_h
    gw_f = from_spec.tiles_x * from_spec.tile_w
    gh_t = to_spec.tiles_y * to_spec.tile_h
    gw_t = to_spec.tiles_x * to_spec.tile_w
    if (gh_f, gw_f) != (gh_t, gw_t):
        raise ValueError(
            f"reshard requires the same global column grid: from_spec "
            f"covers {gh_f}x{gw_f}, to_spec covers {gh_t}x{gw_t}")
    if from_spec.radius != to_spec.radius:
        raise ValueError(
            f"reshard requires the same stencil radius (same cfg): "
            f"{from_spec.radius} != {to_spec.radius}")
    return _map(lambda path, x: _reshard_leaf(path[-1][1], np.asarray(x),
                                              from_spec, to_spec), tree)
