"""The named device mesh, counterpart of ``make_mesh`` and
``mesh_axis_sizes`` in ``mxnet_tpu/parallel/sharding.py:47-66``.

A mesh is a ``torch.distributed`` DeviceMesh with named dims. Each
process is one rank: a launcher starts the processes and initialises the
process group with its address, rank and world size. A one-rank mesh
needs no launcher: :func:`make_mesh` then initialises a one-rank group
itself from an in-process ``HashStore``, so nothing listens on a port.
Under a launcher (``MXTPU_*`` in the environment) :func:`make_mesh`
joins the launcher's world first
(:func:`~mxnet_tpu_torch.parallel.distributed.init_distributed`), and
an existing group is reused; a one-rank group made here gives way to a
launcher's world joined later.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.distributed as dist

from ..base import DeviceUnavailableError, MXNetError

__all__ = ["make_mesh", "mesh_axis_sizes"]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(axis_sizes: Dict[str, int], device_type: str = "cuda"):
    """A DeviceMesh with named axes, e.g. ``{"sp": 4}``, over the ranks
    of the default process group (their number must equal the mesh's
    size). It runs on the card unless ``device_type="cpu"`` is asked
    for."""
    if device_type not in _BACKENDS:
        raise MXNetError("make_mesh: device_type must be one of %s, got %r"
                         % (sorted(_BACKENDS), device_type))
    if device_type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "make_mesh: a cuda mesh was requested but "
            "torch.cuda.is_available() is False; pass device_type='cpu' "
            "for a CPU mesh")
    names = tuple(axis_sizes)
    sizes = tuple(int(s) for s in axis_sizes.values())
    n = math.prod(sizes)
    if not dist.is_initialized():
        from .distributed import init_distributed

        init_distributed()
    if not dist.is_initialized():
        if n != 1:
            raise MXNetError(
                "make_mesh: a mesh of %d ranks needs torch.distributed "
                "initialised first (init_process_group with the "
                "launcher's address, rank and world size)" % n)
        dist.init_process_group(_BACKENDS[device_type],
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != n:
        raise MXNetError("make_mesh: mesh %s needs %d ranks, the process "
                         "group has %d" % (dict(axis_sizes), n,
                                           dist.get_world_size()))
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, sizes, mesh_dim_names=names)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis_name: size}`` of a mesh, in axis order."""
    return {name: int(mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names)}
