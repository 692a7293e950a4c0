"""The halo exchange's transport: one shift of a stacked spike payload
along a shard-grid axis (the reference's ``ppermute``-based ``_shift``,
``repro/core/exchange.py``), and the wire format it crosses in.

A transport holds ``shape``, the global (rows, cols) shard grid, and
``local``, the (rows, cols) block of it stacked in this process, with
the process-major shard ids of that block in ``shards``. Its one
exchange method is :meth:`shift`: ``x`` is a payload with the stacked
tile axes in front, ``(*local, ...)``; shard (ty, tx) receives the
payload of shard (ty, tx) + ``direction`` along ``axis`` (0 = rows,
the reference's ``'data'``; 1 = cols, ``'model'``), and a shard at the
open sheet edge receives zeros (the cortical sheet's edge, paper
Sec. 2).

With ``compress`` a transport packs every strip into 32-bit words
(:func:`pack_spikes`, the ``dense_packed`` wire) before it moves it and
unpacks it after; without, the float32 strip moves as it is.

* :class:`LocalMesh` runs every shard of the grid in this process on
  one device: a shift is a slice of the stacked tile axis and a block
  of zeros. No byte crosses a wire, so it does not pack by default.
* :class:`ProcessGroupMesh` runs one shard per process of the default
  ``torch.distributed`` group, rank ``r`` owning tile
  ``(r // cols, r % cols)``. A shift pairs ``isend``/``irecv`` with the
  two neighbours through ``batch_isend_irecv``; gloo carries CPU
  tensors, so CUDA payloads are packed on the card, then copied to the
  host and back. It packs by default. The backend is whatever the
  group was initialised with: nothing picks another one.

Both reduce run totals with :meth:`all_sum`. Nothing here initialises a
process group or touches a device at import.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.network import resolve_device
from repro_torch.core.partition import TileSpec, process_grid

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


class _Transport:
    """:meth:`shift` is the transport's ``_move`` in its wire format."""
    compress: bool

    def shift(self, x: torch.Tensor, axis: int, direction: int
              ) -> torch.Tensor:
        if not self.compress:
            return self._move(x, axis, direction)
        words = self._move(pack_spikes(x), axis, direction)
        return unpack_spikes(words, x.shape[-1], x.dtype)


class LocalMesh(_Transport):
    """All ``rows x cols`` shards in this process, stacked on ``device``
    (CUDA by default; raises when there is no card). ``compress`` packs
    every strip as the process transport does, on the same card."""

    def __init__(self, rows: int, cols: int, device="cuda",
                 compress: bool = False):
        if rows < 1 or cols < 1:
            raise ValueError(f"mesh {rows}x{cols}: both sides must be >= 1")
        self.shape = (rows, cols)
        self.local = (rows, cols)
        self.shards = tuple(range(rows * cols))
        self.device = resolve_device(device)
        self.compress = compress

    def _move(self, x: torch.Tensor, axis: int, direction: int
              ) -> torch.Tensor:
        size = x.shape[axis]
        if size == 1:
            return torch.zeros_like(x)
        edge = torch.zeros_like(x.narrow(axis, 0, 1))
        if direction > 0:      # receive from my +1 neighbour
            return torch.cat([x.narrow(axis, 1, size - 1), edge], axis)
        return torch.cat([edge, x.narrow(axis, 0, size - 1)], axis)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x


class ProcessGroupMesh(_Transport):
    """One shard per process of the initialised default process group, on
    the closest-to-square process grid (``partition.process_grid``).
    Payloads live on ``device`` (CUDA by default; raises when there is
    no card); with ``compress`` (the default) strips cross packed."""

    def __init__(self, device="cuda", compress: bool = True):
        if not dist.is_initialized():
            raise RuntimeError(
                "ProcessGroupMesh needs an initialised torch.distributed "
                "process group (runtime/multiprocess.py::init_worker)")
        rows, cols = process_grid(dist.get_world_size())
        self.rank = dist.get_rank()
        self.shape = (rows, cols)
        self.local = (1, 1)
        self.shards = (self.rank,)
        self.coords = divmod(self.rank, cols)
        self.device = resolve_device(device)
        self.compress = compress

    def _peer(self, axis: int, step: int) -> int | None:
        """Rank of the neighbour ``step`` tiles away along ``axis``, or
        None beyond the sheet's edge."""
        ty, tx = self.coords
        ty, tx = (ty + step, tx) if axis == 0 else (ty, tx + step)
        rows, cols = self.shape
        if 0 <= ty < rows and 0 <= tx < cols:
            return ty * cols + tx
        return None

    def _move(self, x: torch.Tensor, axis: int, direction: int
              ) -> torch.Tensor:
        if self.shape[axis] == 1:
            return torch.zeros_like(x)
        dst, src = self._peer(axis, -direction), self._peer(axis, direction)
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, x.cpu().contiguous(), dst))
        recv = torch.zeros(x.shape, dtype=x.dtype)
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, recv, src))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv.to(x.device)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        host = x.cpu().clone()
        dist.all_reduce(host, op=dist.ReduceOp.SUM)
        return host.to(x.device)
