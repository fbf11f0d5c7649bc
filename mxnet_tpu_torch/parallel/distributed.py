"""Several processes over ``torch.distributed``, counterpart of
``mxnet_tpu/parallel/distributed.py``.

Bootstrapping follows ``tools/launch.py``: the launcher exports
``MXTPU_COORDINATOR`` (host:port), ``MXTPU_NUM_WORKERS`` and
``MXTPU_WORKER_RANK``, and each process calls :func:`init_distributed`
(``kvstore.create('dist_sync')`` does). The process group holds both
backends, ``cpu:gloo,cuda:nccl`` where NCCL is available: a collective
over card tensors runs on NCCL, one over CPU tensors on gloo. Barriers
run over a gloo group of their own, since an NCCL barrier picks a card
of its own choosing (and hangs on a rank bound elsewhere).

With no launcher environment, or one worker, nothing is joined and the
process is rank 0 of 1, as in the JAX package.
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..base import MXNetError

__all__ = ["init_distributed", "is_initialized", "rank", "num_workers",
           "barrier", "all_reduce", "broadcast", "all_reduce_np",
           "broadcast_np"]

_TIMEOUT = datetime.timedelta(minutes=10)


class _World:
    """The world this module joined: its gloo group for barriers."""

    joined = False
    barrier_group = None


def _backend_spec() -> str:
    """The process group's backends: gloo for CPU tensors and, where this
    torch has NCCL and a card, NCCL for card tensors."""
    if torch.cuda.is_available() and dist.is_nccl_available():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def _launcher_world(coordinator, num_processes, process_id):
    coordinator = coordinator or os.environ.get("MXTPU_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("MXTPU_NUM_WORKERS", "0") or 0)
    if process_id is None:
        process_id = int(os.environ.get("MXTPU_WORKER_RANK", "0") or 0)
    return coordinator, num_processes, process_id


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join the launcher's world (from the arguments or the launcher's
    environment). True when a world of several processes was joined,
    False for a single process. A one-rank group that
    :func:`~mxnet_tpu_torch.parallel.make_mesh` made is replaced by the
    launcher's world; a group of the world's size is reused."""
    if _World.joined:
        return True
    coordinator, n, r = _launcher_world(coordinator, num_processes,
                                        process_id)
    if not coordinator or n <= 1:
        return False
    if dist.is_initialized():
        size = dist.get_world_size()
        if size == 1:
            dist.destroy_process_group()
        elif size != n or dist.get_rank() != r:
            raise MXNetError(
                "init_distributed: this process is rank %d of a group of "
                "%d, the launcher says rank %d of %d"
                % (dist.get_rank(), size, r, n))
    if not dist.is_initialized():
        dist.init_process_group(_backend_spec(),
                                init_method="tcp://%s" % coordinator,
                                rank=r, world_size=n, timeout=_TIMEOUT)
    _World.barrier_group = dist.new_group(backend="gloo")
    _World.joined = True
    return True


def is_initialized() -> bool:
    return _World.joined


def rank() -> int:
    return dist.get_rank() if _World.joined else 0


def num_workers() -> int:
    return dist.get_world_size() if _World.joined else 1


def barrier(name: str = "mxtpu_barrier"):
    """Wait for every process of the world (over gloo). ``name`` is the
    reference's barrier name; gloo's barrier takes none, so it is
    accepted and not used."""
    if num_workers() > 1:
        dist.barrier(group=_World.barrier_group)


def all_reduce_np(arr: np.ndarray) -> np.ndarray:
    """The sum of a host numpy array over every process (gloo on a host
    tensor); ``arr`` itself in a one-worker world."""
    if num_workers() <= 1:
        return arr
    t = torch.from_numpy(np.array(arr, copy=True))
    dist.all_reduce(t, group=_World.barrier_group)
    return t.numpy()


def broadcast_np(arr: np.ndarray, root: int = 0) -> np.ndarray:
    """Rank ``root``'s host numpy array on every process (gloo; the
    reference's init broadcast, ``kvstore_dist.h:58-76``); ``arr`` itself
    in a one-worker world. Every rank passes an array of the same shape
    and dtype."""
    if num_workers() <= 1:
        return arr
    t = torch.from_numpy(np.array(arr, copy=True))
    dist.broadcast(t, src=root, group=_World.barrier_group)
    return t.numpy()


def all_reduce(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sum each tensor over every process, in place (NCCL for card
    tensors, gloo for CPU ones)."""
    if num_workers() > 1:
        for t in tensors:
            _on_device(t, dist.all_reduce, t)
    return tensors


def broadcast(tensors: List[torch.Tensor], root: int = 0
              ) -> List[torch.Tensor]:
    """Rank ``root``'s value of each tensor on every process, in place
    (the reference's init broadcast, ``kvstore_dist.h:58-76``)."""
    if num_workers() > 1:
        for t in tensors:
            _on_device(t, dist.broadcast, t, src=root)
    return tensors


def _on_device(t, fn, *args, **kwargs):
    # NCCL binds its communicator to the current card: make it the
    # tensor's
    if t.is_cuda:
        with torch.cuda.device(t.device):
            return fn(*args, **kwargs)
    return fn(*args, **kwargs)
