"""Production and host meshes of the LM zoo, for the PyTorch port: the
counterpart of ``repro/launch/mesh.py``.

Functions, not module constants: importing this module starts no
process group and touches no device. Both build a
``torch.distributed.device_mesh.DeviceMesh`` over the current default
process group, which the caller starts (the dry run starts a fake group
of 256 or 512 ranks in one process, ``launch/dryrun.py``; the sharded
tests start gloo ranks).
"""
from __future__ import annotations

import math

import torch.distributed as dist


def _device_type() -> str:
    """``cuda`` on an NCCL group, ``cpu`` otherwise (gloo, fake)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 ranks, ``("data", "model")``; ``multi_pod`` adds a
    leading ``pod`` axis of 2 (512 ranks). Axis semantics:
    ``runtime/sharding.py``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_host_mesh(shape, axes)


def make_host_mesh(shape=(2, 2), axes=("data", "model")):
    """A mesh of ``shape`` over the first ranks of the process group.
    Raises naming the rank count when the group is too small (the
    reference names its device count and the flag that forces it)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} ranks, have {have} — start a process group of "
            f"{n} ranks first (gloo or NCCL ranks, or the dry run's fake "
            f"group)")
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))
