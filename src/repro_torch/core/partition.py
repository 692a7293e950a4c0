"""Column grid <-> shard grid partitioning (the port of
``repro/core/partition.py``).

The paper distributes columns over MPI ranks; the grid is tiled 2-D over
a shard grid of ``tiles_y x tiles_x`` tiles (surface-minimizing: halo
bytes scale with the tile perimeter). Synapse generation is
deterministic per global column id, so every shard builds its own
tile's synapses from its coordinates and any tiling gives the same
network.

Invariants the exchange builds on:

* **Process-major placement.** Shard ``s`` owns tile
  ``(s // tiles_x, s % tiles_x)``; every stacked array assumes this
  order, and so does the rank of a process (``runtime/transport.py``).
* **Exact tiling.** :func:`make_tile_spec` refuses grids the shard grid
  does not divide, naming the shapes.
* **Radius semantics.** ``TileSpec.radius`` is the ACTIVE stencil radius
  (connectivity cutoff applied); ring counts and the payload accounting
  (``runtime/compression.py``) derive from it.

* **Node groups.** :func:`make_node_spec` factors the process grid into
  node groups of consecutive ranks (:class:`NodeSpec`), the grid the
  hierarchical two-level exchange runs its node-level rings over.

The helpers between stacked tiles and the global frame work on numpy
arrays and on torch tensors alike.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import DPSNNConfig


class TileSpec(NamedTuple):
    tiles_y: int     # number of tiles along grid rows
    tiles_x: int     # number of tiles along grid cols
    tile_h: int      # rows per tile
    tile_w: int      # cols per tile
    radius: int      # halo depth (stencil radius, derived from offsets)

    @property
    def columns_per_tile(self) -> int:
        return self.tile_h * self.tile_w

    @property
    def rings_y(self) -> int:
        """Shift rounds per vertical direction: a radius-R halo reaches
        ceil(R / tile_h) shard rings along the row axis."""
        return -(-self.radius // self.tile_h)

    @property
    def rings_x(self) -> int:
        return -(-self.radius // self.tile_w)

    @property
    def permutes_per_step(self) -> int:
        """Shifts per exchange: 2 directions per ring, both axes (4 per
        step when the halo fits one ring)."""
        return 2 * (self.rings_y + self.rings_x)


def process_grid(n_ranks: int) -> tuple[int, int]:
    """Closest-to-square (ry, rx) factorization of ``n_ranks``, ry <= rx:
    the rank -> 2-D tile-grid placement of the multi-process runtime."""
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be >= 1, got {n_ranks}")
    ry = int(math.isqrt(n_ranks))
    while n_ranks % ry:
        ry -= 1
    return ry, n_ranks // ry


def batch_ranks(n_ranks: int, batch_shards: int) -> int:
    """The spatial ranks of each of ``batch_shards`` batch shards of
    ``n_ranks`` (the batched service's placement, batch-major: ranks
    ``[k*S, (k+1)*S)`` form shard k); raises with the reference's text
    when the shards do not divide the ranks."""
    if batch_shards < 1 or n_ranks % batch_shards:
        raise ValueError(
            f"{n_ranks} ranks do not split over {batch_shards} batch "
            f"shards — pick batch_shards dividing the rank count")
    return n_ranks // batch_shards


def make_tile_spec(cfg: DPSNNConfig, row_shards: int,
                   col_shards: int) -> TileSpec:
    if cfg.grid_h % row_shards or cfg.grid_w % col_shards:
        bad = []
        if cfg.grid_h % row_shards:
            bad.append(f"grid_h={cfg.grid_h} % row_shards={row_shards} = "
                       f"{cfg.grid_h % row_shards}")
        if cfg.grid_w % col_shards:
            bad.append(f"grid_w={cfg.grid_w} % col_shards={col_shards} = "
                       f"{cfg.grid_w % col_shards}")
        raise ValueError(
            f"column grid {cfg.grid_h}x{cfg.grid_w} cannot be tiled over a "
            f"{row_shards}x{col_shards} shard grid "
            f"({row_shards * col_shards} ranks/devices): {'; '.join(bad)}. "
            f"Each shard must own an integer tile — choose a rank count "
            f"whose {row_shards}x{col_shards} factorization divides the "
            f"grid, or resize the grid (configs.dpsnn.with_ranks builds "
            f"divisible weak-scaling grids)."
        )
    th, tw = cfg.grid_h // row_shards, cfg.grid_w // col_shards
    # tiles thinner than the radius are fine: the exchange runs
    # ceil(r / tile) chained rings per direction
    return TileSpec(row_shards, col_shards, th, tw, cfg.stencil_radius)


def make_rank_tile_spec(cfg: DPSNNConfig, n_ranks: int) -> TileSpec:
    """TileSpec for ``n_ranks`` processes on the closest-to-square process
    grid (:func:`process_grid`)."""
    ry, rx = process_grid(n_ranks)
    return make_tile_spec(cfg, ry, rx)


class NodeSpec(NamedTuple):
    """Two-level factoring of the process grid into a grid of node groups.

    The (ry, rx) process grid factors as ry = nodes_y * group_h and
    rx = nodes_x * group_w: node (a, j) owns the group_h x group_w block
    of ranks whose tiles start at row a*group_h, col j*group_w. Because
    placement is process-major and groups are built from consecutive
    ranks (see :func:`make_node_spec`), node membership matches the
    physical `--ranks-per-node` packing of an MPI launcher.
    """
    nodes_y: int     # node-grid rows
    nodes_x: int     # node-grid cols
    group_h: int     # process-grid rows per node
    group_w: int     # process-grid cols per node

    @property
    def ranks_per_node(self) -> int:
        return self.group_h * self.group_w

    @property
    def n_nodes(self) -> int:
        return self.nodes_y * self.nodes_x


def make_node_spec(ry: int, rx: int, ranks_per_node: int) -> NodeSpec:
    """Factor the (ry, rx) process grid into node groups of
    ``ranks_per_node`` *consecutive* process-major ranks.

    Consecutive ranks must form a rectangle, which forces the group
    shape: ``ranks_per_node <= rx`` gives a (1, ranks_per_node) slice of
    one process-grid row; ``ranks_per_node`` a multiple of ``rx`` gives
    a (ranks_per_node/rx, rx) band of whole rows. Anything else cannot
    be contiguous and is rejected with the node-group shape named.
    """
    if ranks_per_node < 1:
        raise ValueError(
            f"ranks_per_node must be >= 1, got {ranks_per_node}")
    if ranks_per_node <= rx:
        if rx % ranks_per_node:
            raise ValueError(
                f"--ranks-per-node {ranks_per_node} groups consecutive "
                f"process-major ranks into 1x{ranks_per_node} node groups, "
                f"but the {ry}x{rx} process grid's rows of {rx} ranks are "
                f"not divisible by {ranks_per_node} "
                f"(rx={rx} % {ranks_per_node} = {rx % ranks_per_node}). "
                f"Choose a ranks-per-node that divides {rx}, or a rank "
                f"count whose process_grid() factorization it divides.")
        return NodeSpec(ry, rx // ranks_per_node, 1, ranks_per_node)
    if ranks_per_node % rx:
        raise ValueError(
            f"--ranks-per-node {ranks_per_node} exceeds the process-grid "
            f"row width rx={rx}, so each node group must span whole rows "
            f"of the {ry}x{rx} process grid — impossible: {ranks_per_node} "
            f"% rx={rx} = {ranks_per_node % rx}, which would make a ragged "
            f"{ranks_per_node / rx:g}x{rx} node group. Use a multiple of "
            f"{rx} (whole rows) or a divisor of {rx} (a row slice).")
    group_h = ranks_per_node // rx
    if ry % group_h:
        raise ValueError(
            f"--ranks-per-node {ranks_per_node} makes {group_h}x{rx} node "
            f"groups ({group_h} whole rows of the {ry}x{rx} process grid), "
            f"but ry={ry} is not divisible by {group_h} "
            f"(ry={ry} % {group_h} = {ry % group_h}). Choose a rank count "
            f"or ranks-per-node whose row-band height divides ry.")
    return NodeSpec(ry // group_h, 1, group_h, rx)


# ---------------------------------------------------------------------------
# Global coordinate system
# ---------------------------------------------------------------------------
#
# Every shard-stacked array carries a leading shard axis in process-major
# order: shard s owns tile (s // tiles_x, s % tiles_x). The helpers below
# map between that per-tile layout and the mesh-free global frame.


def shard_tile_coords(spec: TileSpec, s: int) -> tuple[int, int]:
    """Process-major shard index -> (ty, tx) tile coordinate."""
    return s // spec.tiles_x, s % spec.tiles_x


def tiles_to_global(x, spec: TileSpec):
    """Shard-stacked tile frames -> one global frame.

    ``x``: (S, tile_h, tile_w, *rest), S = tiles_y*tiles_x in
    process-major order. Returns (grid_h, grid_w, *rest).
    """
    s, th, tw = x.shape[0], x.shape[1], x.shape[2]
    if (s, th, tw) != (spec.tiles_y * spec.tiles_x, spec.tile_h,
                       spec.tile_w):
        raise ValueError(
            f"stacked tile array of shape {tuple(x.shape)} does not match "
            f"spec {spec} (want ({spec.tiles_y * spec.tiles_x}, "
            f"{spec.tile_h}, {spec.tile_w}, ...))")
    rest = tuple(x.shape[3:])
    x = x.reshape(spec.tiles_y, spec.tiles_x, th, tw, *rest)
    x = x.swapaxes(1, 2)            # (ty, th, tx, tw, *rest)
    return x.reshape(spec.tiles_y * th, spec.tiles_x * tw, *rest)


def global_to_tiles(g, spec: TileSpec):
    """Inverse of :func:`tiles_to_global`: (grid_h, grid_w, *rest) ->
    (S, tile_h, tile_w, *rest) in process-major shard order."""
    gh, gw = g.shape[0], g.shape[1]
    if (gh, gw) != (spec.tiles_y * spec.tile_h, spec.tiles_x * spec.tile_w):
        raise ValueError(
            f"global array of shape {tuple(g.shape)} does not match spec "
            f"{spec} (want ({spec.tiles_y * spec.tile_h}, "
            f"{spec.tiles_x * spec.tile_w}, ...))")
    rest = tuple(g.shape[2:])
    g = g.reshape(spec.tiles_y, spec.tile_h, spec.tiles_x, spec.tile_w,
                  *rest)
    g = g.swapaxes(1, 2)            # (ty, tx, th, tw, *rest)
    return g.reshape(spec.tiles_y * spec.tiles_x, spec.tile_h, spec.tile_w,
                     *rest)


def columns_to_global(x, spec: TileSpec):
    """Shard-stacked per-column leaves (S, C, *rest), C = tile_h*tile_w in
    row-major tile order -> (grid_h*grid_w, *rest) indexed by the global
    column id."""
    rest = tuple(x.shape[2:])
    tiled = x.reshape(x.shape[0], spec.tile_h, spec.tile_w, *rest)
    g = tiles_to_global(tiled, spec)
    return g.reshape(g.shape[0] * g.shape[1], *rest)


def global_to_columns(g, spec: TileSpec):
    """Inverse of :func:`columns_to_global`: (grid_h*grid_w, *rest) ->
    (S, C, *rest)."""
    gh = spec.tiles_y * spec.tile_h
    gw = spec.tiles_x * spec.tile_w
    rest = tuple(g.shape[1:])
    tiled = global_to_tiles(g.reshape(gh, gw, *rest), spec)
    return tiled.reshape(tiled.shape[0], spec.columns_per_tile, *rest)


def tile_column_ids(cfg: DPSNNConfig, spec: TileSpec, ty: int, tx: int,
                    device="cpu") -> torch.Tensor:
    """Global column ids (tile_h*tile_w,) int32 of the tile at (ty, tx)."""
    rows = ty * spec.tile_h + torch.arange(spec.tile_h, dtype=torch.int32,
                                          device=device)
    cols = tx * spec.tile_w + torch.arange(spec.tile_w, dtype=torch.int32,
                                          device=device)
    return (rows[:, None] * cfg.grid_w + cols[None, :]).reshape(-1)


def unflatten_tile(x, spec: TileSpec):
    """(C, ...) -> (tile_h, tile_w, ...) per-shard reshape."""
    return x.reshape(spec.tile_h, spec.tile_w, *tuple(x.shape[1:]))
