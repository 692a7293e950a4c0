"""The halo exchange's transport: one shift of a stacked spike payload
along a shard-grid axis (the reference's ``ppermute``-based ``_shift``,
``repro/core/exchange.py``), the wire format it crosses in, and the node
level of the hierarchical exchange.

A transport holds ``shape``, the global (rows, cols) shard grid, and
``local``, the (rows, cols) block of it stacked in this process, with
the process-major shard ids of that block in ``shards``. A payload has
the stacked tile axes in front, ``(*local, ...)``; :meth:`move` ships it
as it is: shard (ty, tx) receives the payload of shard (ty, tx) +
``direction`` along ``axis`` (0 = rows, the reference's ``'data'``; 1 =
cols, ``'model'``), and a shard at the open sheet edge receives zeros
(the cortical sheet's edge, paper Sec. 2). :meth:`shift` is the same
move of a spike strip in the transport's wire format: with ``compress``
every strip is packed into 32-bit words (:func:`pack_spikes`, the
``dense_packed`` wire) before the move and unpacked after. AER event
lists and the STDP trace strips are moved raw, never packed.

With a :class:`~repro_torch.core.partition.NodeSpec` (``node``) a
transport also runs the node level of the two-level exchange
(``exchange.exchange_halo_hier``): :meth:`gather_node` coalesces the
tiles of each node group into one node frame, stacked as
``(*node_local, ...)``; :meth:`node_move` / :meth:`node_shift` move a
node payload between neighbouring nodes; :meth:`node_window` cuts each
local shard's halo window out of the extended node frames.

* :class:`LocalMesh` runs every shard of the grid in this process on
  one device: a move is a slice of the stacked tile axis and a block of
  zeros, a node gather a reshape, a node move the same slice over the
  node grid. No byte crosses a wire, so it does not pack by default.
* :class:`ProcessGroupMesh` runs ``shards_per_rank`` k shards per
  process of the default ``torch.distributed`` group (one by default):
  on the (ry, rx) process grid rank ``r`` owns the k consecutive tiles
  of row ``r // rx`` from column ``(r % rx) * k`` of the (ry, rx * k)
  shard grid, stacked as ``local = (1, k)`` (the reference's k local
  devices per process, extending its row). A move rolls the local
  stack and pairs ``isend``/``irecv`` of the strip at its edge with the
  two neighbouring ranks through ``batch_isend_irecv``; gloo carries
  CPU tensors, so CUDA payloads are copied to the host and back. It
  packs by default. With ``ranks_per_node`` each node group gets its own
  process group: the node frame is an all-gather within it, a node move
  a send between the lane-(0,0) corner ranks of neighbouring nodes and
  a broadcast from the corner to its node. The backend is whatever the
  group was initialised with: nothing picks another one.

A payload may carry the batched service's tenant axis behind the mesh
axes, ``(*local, b, ...)``: the moves cut the mesh axes only. A
``ProcessGroupMesh`` may split its world into batch shards, each a
spatial grid of its own (``runtime/sharding.py``).

Both reduce run totals with :meth:`all_sum` and the saturation flags
with :meth:`all_max`, over every process, and :meth:`gather` stacks a
leaf of every shard of the grid, in process-major order, on every
process (the replicated state a checkpoint holds). :class:`GuardedWire`
is a transport whose moves the integrity guard frames
(``runtime/integrity.HaloGuard``). ``priced_compress`` is the
wire the byte accounting prices (``exchange.resolve_ring_modes``): a
``LocalMesh`` stands for the packed rank wire whatever it moves
in-process. Nothing here initialises a process group or touches a
device at import.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.network import resolve_device
from repro_torch.core.partition import (NodeSpec, TileSpec, batch_ranks,
                                        make_node_spec, process_grid)

AXIS_NAMES = ("data", "model")    # rows, cols: the reference's mesh axes


def packed_width(n: int) -> int:
    return (n + 31) // 32


def pack_spikes(x: torch.Tensor) -> torch.Tensor:
    """(..., N) 0/1 floats -> (..., ceil(N/32)) int32 words: bit j of word
    w is neuron 32*w + j, the reference's uint32 bits (bit 31 is the
    sign bit; PyTorch has no shifts on uint32)."""
    n = x.shape[-1]
    bits = (x > 0).to(torch.int32)
    pad = packed_width(n) * 32 - n
    if pad:
        bits = F.pad(bits, (0, pad))
    bits = bits.reshape(*x.shape[:-1], -1, 32)
    weights = torch.ones(32, dtype=torch.int32, device=x.device) << \
        torch.arange(32, dtype=torch.int32, device=x.device)
    # distinct bits: no partial sum leaves int32
    return (bits * weights).sum(dim=-1, dtype=torch.int32)


def unpack_spikes(p: torch.Tensor, n: int,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_spikes` (truncates the padding)."""
    shifts = torch.arange(32, dtype=torch.int32, device=p.device)
    bits = (p[..., None] >> shifts) & 1
    flat = bits.reshape(*p.shape[:-1], p.shape[-1] * 32)
    return flat[..., :n].to(dtype)


def assert_axis_sizes(spec: TileSpec, mesh) -> None:
    """The shard grid the step runs over must match the TileSpec's, or
    the halo exchange would pair wrong neighbours (the reference's check
    of the same name, with its text)."""
    rows, cols = mesh.shape
    if (rows, cols) != (spec.tiles_y, spec.tiles_x):
        raise ValueError(
            f"mesh axes {rows}x{cols} (row_axes={AXIS_NAMES[0]!r}, "
            f"col_axis={AXIS_NAMES[1]!r}) do not match the tile grid "
            f"{spec.tiles_y}x{spec.tiles_x} of {spec} — the halo exchange "
            f"would pair wrong neighbours. Rebuild the spec from the mesh "
            f"(partition.make_tile_spec) or fix the mesh shape."
        )


def check_shards_per_rank(shards_per_rank: int, ranks_per_node: int = 0
                          ) -> None:
    """A rank holds at least one shard, and node groups take one shard
    per rank: the reference's text for its hierarchical mesh of processes
    with more than one local device."""
    if shards_per_rank < 1:
        raise ValueError(f"shards_per_rank must be >= 1, got "
                         f"{shards_per_rank}")
    if ranks_per_node and shards_per_rank != 1:
        raise ValueError(
            f"--ranks-per-node assumes one device per process (the CPU "
            f"rank runtime); got {shards_per_rank} local devices per rank")


def _node_frames(tiles: torch.Tensor, node_local, node: NodeSpec
                 ) -> torch.Tensor:
    """(ny*gy, nx*gx, th, tw, W) stacked tiles -> (ny, nx, gy*th, gx*tw,
    W) node frames, ``(ny, nx) = node_local``."""
    ny, nx = node_local
    gy, gx = node.group_h, node.group_w
    _, _, th, tw, w = tiles.shape
    t = tiles.reshape(ny, gy, nx, gx, th, tw, w).permute(0, 2, 1, 4, 3, 5, 6)
    return t.reshape(ny, nx, gy * th, gx * tw, w)


class _Transport:
    """:meth:`shift` and :meth:`node_shift` are :meth:`move` and
    :meth:`node_move` in the transport's wire format."""
    compress: bool
    node: NodeSpec | None = None
    batch_shards = 1       # the tenant axis: one batch shard, the first
    batch_index = 0

    def _wire(self, move, x, axis, direction):
        if not self.compress:
            return move(x, axis, direction)
        words = move(pack_spikes(x), axis, direction)
        return unpack_spikes(words, x.shape[-1], x.dtype)

    def shift(self, x: torch.Tensor, axis: int, direction: int
              ) -> torch.Tensor:
        return self._wire(self.move, x, axis, direction)

    def node_shift(self, x: torch.Tensor, axis: int, direction: int
                   ) -> torch.Tensor:
        return self._wire(self.node_move, x, axis, direction)

    def gather_node(self, x: torch.Tensor, pack: bool | None = None
                    ) -> torch.Tensor:
        """(*local, th, tw, N) tiles -> (*node_local, gy*th, gx*tw, N)
        node frames, spikes in the wire format (packed when ``pack``,
        which defaults to ``compress``); ``pack=False`` gathers the
        STDP traces raw."""
        pack = self.compress if pack is None else pack
        y = pack_spikes(x) if pack else x
        g = _node_frames(self._lane_tiles(y), self.node_local, self.node)
        return unpack_spikes(g, x.shape[-1], x.dtype) if pack else g


class LocalMesh(_Transport):
    """All ``rows x cols`` shards in this process, stacked on ``device``
    (CUDA by default; raises when there is no card). ``compress`` packs
    every strip as the process transport does, on the same card;
    ``node`` groups the shards into the node grid of a hierarchical
    exchange."""
    priced_compress = True

    def __init__(self, rows: int, cols: int, device="cuda",
                 compress: bool = False, node: NodeSpec | None = None):
        if rows < 1 or cols < 1:
            raise ValueError(f"mesh {rows}x{cols}: both sides must be >= 1")
        if node is not None and (node.nodes_y * node.group_h,
                                 node.nodes_x * node.group_w) != (rows, cols):
            raise ValueError(
                f"{node} does not factor the {rows}x{cols} shard grid")
        self.shape = (rows, cols)
        self.local = (rows, cols)
        self.shards = tuple(range(rows * cols))
        self.device = resolve_device(device)
        self.compress = compress
        self.node = node
        if node is not None:
            self.node_local = (node.nodes_y, node.nodes_x)

    def move(self, x: torch.Tensor, axis: int, direction: int
             ) -> torch.Tensor:
        size = x.shape[axis]
        if size == 1:
            return torch.zeros_like(x)
        edge = torch.zeros_like(x.narrow(axis, 0, 1))
        if direction > 0:      # receive from my +1 neighbour
            return torch.cat([x.narrow(axis, 1, size - 1), edge], axis)
        return torch.cat([edge, x.narrow(axis, 0, size - 1)], axis)

    # the node grid is stacked as the shard grid is
    node_move = move

    def _lane_tiles(self, y: torch.Tensor) -> torch.Tensor:
        return y

    def node_window(self, ext: torch.Tensor, th: int, tw: int, r: int
                    ) -> torch.Tensor:
        """(ny, nx, gy*th+2r, gx*tw+2r, N) -> (rows, cols, th+2r, tw+2r,
        N): every lane's window, one slice each."""
        ny, nx = self.node_local
        win = ext.unfold(2, th + 2 * r, th).unfold(3, tw + 2 * r, tw)
        # (ny, nx, gy, gx, N, th+2r, tw+2r) -> (ny, gy, nx, gx, ...)
        win = win.permute(0, 2, 1, 3, 5, 6, 4)
        return win.reshape(*self.shape, th + 2 * r, tw + 2 * r,
                           ext.shape[-1])

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(S_local, ...) -> (S, ...): every shard is local already."""
        return x


class ProcessGroupMesh(_Transport):
    """``shards_per_rank`` shards per process of the initialised default
    process group, on the closest-to-square process grid
    (``partition.process_grid``), each process's shards extending its
    row of the shard grid.
    Payloads live on ``device`` (CUDA by default; raises when there is
    no card); with ``compress`` (the default) strips cross packed. With
    ``ranks_per_node`` consecutive ranks form node groups
    (``partition.make_node_spec``, whose error names a bad shape) and
    every rank creates every node's process group, in the same order.

    With ``batch_shards`` K (the batched service's tenant axis,
    ``runtime/sharding.py``) the world splits batch-major into K batch
    shards of S = world / K ranks: ranks ``[k*S, (k+1)*S)`` form batch
    shard ``batch_index`` k, each over the process grid of S ranks, so
    every shift stays inside a batch shard. ``rank`` is then the spatial
    rank within the shard; the reductions still run over the world."""

    def __init__(self, device="cuda", compress: bool = True,
                 ranks_per_node: int = 0, batch_shards: int = 1,
                 shards_per_rank: int = 1):
        if not dist.is_initialized():
            raise RuntimeError(
                "ProcessGroupMesh needs an initialised torch.distributed "
                "process group (runtime/multiprocess.py::init_worker)")
        spatial = batch_ranks(dist.get_world_size(), batch_shards)
        if ranks_per_node and batch_shards > 1:
            raise ValueError(
                "the batched multi-tenant runner does not support the "
                "hierarchical ('ndata','data','nmodel','model') mesh — run "
                "tenants on a flat spatial mesh, or drop --ranks-per-node")
        check_shards_per_rank(shards_per_rank, ranks_per_node)
        k = shards_per_rank
        rows, cols = process_grid(spatial)
        self.batch_shards = batch_shards
        self.batch_index, self.rank = divmod(dist.get_rank(), spatial)
        self.base = self.batch_index * spatial   # the shard's first rank
        self.grid = (rows, cols)                 # the process grid
        self.shape = (rows, cols * k)            # the shard grid
        self.local = (1, k)
        self.shards = tuple(range(self.rank * k, (self.rank + 1) * k))
        self.coords = divmod(self.rank, cols)
        self.device = resolve_device(device)
        self.compress = compress
        self.priced_compress = compress
        if ranks_per_node:
            self._join_node(make_node_spec(rows, cols, ranks_per_node))

    def _join_node(self, node: NodeSpec) -> None:
        gy, gx = node.group_h, node.group_w
        ty, tx = self.coords
        self.node = node
        self.node_local = (1, 1)
        self.node_coords = (ty // gy, tx // gx)
        self.lane = (ty % gy, tx % gx)
        for a in range(node.nodes_y):
            for j in range(node.nodes_x):
                ranks = [self._node_corner_rank(a, j) + b * self.grid[1] + l
                         for b in range(gy) for l in range(gx)]  # noqa: E741
                group = dist.new_group(ranks)
                if (a, j) == self.node_coords:
                    self.node_group = group
        self.corner = self._node_corner_rank(*self.node_coords)

    def _node_corner_rank(self, a: int, j: int) -> int:
        """The lane-(0,0) rank of node (a, j)."""
        return a * self.node.group_h * self.grid[1] + j * self.node.group_w

    def _peer(self, axis: int, step: int) -> int | None:
        """Rank of the neighbour ``step`` tiles away along ``axis``, or
        None beyond the sheet's edge."""
        ty, tx = self.coords
        ty, tx = (ty + step, tx) if axis == 0 else (ty, tx + step)
        rows, cols = self.grid
        if 0 <= ty < rows and 0 <= tx < cols:
            return self.base + ty * cols + tx
        return None

    def _node_peer(self, axis: int, step: int) -> int | None:
        """Corner rank of the node ``step`` nodes away along ``axis``, or
        None beyond the sheet's edge."""
        a, j = self.node_coords
        a, j = (a + step, j) if axis == 0 else (a, j + step)
        if 0 <= a < self.node.nodes_y and 0 <= j < self.node.nodes_x:
            return self._node_corner_rank(a, j)
        return None

    @staticmethod
    def _send_recv(x: torch.Tensor, dst: int | None, src: int | None
                   ) -> torch.Tensor:
        """Send ``x`` to ``dst`` and receive the same shape from ``src``
        (either None: no message), through the host."""
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, x.cpu().contiguous(), dst))
        recv = torch.zeros(x.shape, dtype=x.dtype)
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, recv, src))
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        return recv

    def move(self, x: torch.Tensor, axis: int, direction: int
             ) -> torch.Tensor:
        """Shard j of the local stack receives shard j + ``direction``'s
        payload: inside the stack a slice, and at the stack's edge the
        strip of the neighbouring rank's edge shard, one message per
        rank and direction."""
        if self.shape[axis] == 1:
            return torch.zeros_like(x)
        size = x.shape[axis]
        edge = x.narrow(axis, 0 if direction > 0 else size - 1, 1)
        recv = self._send_recv(edge, self._peer(axis, -direction),
                               self._peer(axis, direction)).to(x.device)
        if size == 1:
            return recv
        keep = x.narrow(axis, 1 if direction > 0 else 0, size - 1)
        return torch.cat([keep, recv] if direction > 0 else [recv, keep],
                         axis)

    def node_move(self, x: torch.Tensor, axis: int, direction: int
                  ) -> torch.Tensor:
        """The corner ranks exchange the node payload with the
        neighbouring nodes' corners; each corner then broadcasts what it
        received to its node (every lane holds the same node frame)."""
        if (self.node.nodes_y, self.node.nodes_x)[axis] == 1:
            return torch.zeros_like(x)
        if self.rank == self.corner:
            buf = self._send_recv(x, self._node_peer(axis, -direction),
                                  self._node_peer(axis, direction))
        else:
            buf = torch.zeros(x.shape, dtype=x.dtype)
        dist.broadcast(buf, src=self.corner, group=self.node_group)
        return buf.to(x.device)

    def _lane_tiles(self, y: torch.Tensor) -> torch.Tensor:
        """This node's tiles (gy, gx, ...), all-gathered in lane order."""
        host = y.cpu().contiguous()
        parts = [torch.empty_like(host)
                 for _ in range(self.node.ranks_per_node)]
        dist.all_gather(parts, host, group=self.node_group)
        g = torch.cat(parts).reshape(self.node.group_h, self.node.group_w,
                                     *y.shape[2:])
        return g.to(y.device)

    def node_window(self, ext: torch.Tensor, th: int, tw: int, r: int
                    ) -> torch.Tensor:
        """(1, 1, gy*th+2r, gx*tw+2r, N) -> this lane's (1, 1, th+2r,
        tw+2r, N) window."""
        ly, lx = self.lane
        return ext.narrow(2, ly * th, th + 2 * r).narrow(3, lx * tw,
                                                          tw + 2 * r)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        host = x.cpu().clone()
        dist.all_reduce(host, op=dist.ReduceOp.SUM)
        return host.to(x.device)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        host = x.cpu().clone()
        dist.all_reduce(host, op=dist.ReduceOp.MAX)
        return host.to(x.device)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's (k, ...) leaf -> every rank's, (S, ...) in rank
        (= process-major shard) order, on the host of every rank (gloo
        all-gather; bool leaves cross as bytes)."""
        if self.batch_shards != 1:
            raise ValueError("gather stacks one spatial grid; the batched "
                             "service's batch shards are not gathered")
        host = x.cpu().contiguous()
        wire = host.view(torch.uint8) if host.dtype == torch.bool else host
        parts = [torch.empty_like(wire)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, wire)
        return torch.cat(parts).view(host.dtype)


class GuardedWire:
    """``mesh`` with every halo message framed by ``guard`` (a
    ``runtime.integrity.HaloGuard``): ``move`` and ``node_move`` are the
    guard's framed moves, and ``shift`` / ``node_shift`` pack around them,
    so what is framed is the message on the wire (the packed words of a
    packing transport). A node message's verdict counts on every lane of
    the node, each of which receives it. The node gather is not framed,
    as in the reference. Everything else is ``mesh``'s."""

    def __init__(self, mesh, guard):
        self.mesh = mesh
        self.move = guard.wrap(mesh.move)
        if mesh.node is not None:
            (ly, lx), (ny, nx) = mesh.local, mesh.node_local

            def lanes(count):
                return count.repeat_interleave(ly // ny, 0).repeat_interleave(
                    lx // nx, 1).reshape(-1)
            self.node_move = guard.wrap(mesh.node_move, to_shards=lanes)

    def __getattr__(self, name):
        return getattr(self.mesh, name)

    def shift(self, x: torch.Tensor, axis: int, direction: int
              ) -> torch.Tensor:
        return self.mesh._wire(self.move, x, axis, direction)

    def node_shift(self, x: torch.Tensor, axis: int, direction: int
                   ) -> torch.Tensor:
        return self.mesh._wire(self.node_move, x, axis, direction)
