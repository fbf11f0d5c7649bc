"""The named mesh and its sharding rules, counterpart of
``mxnet_tpu/parallel/sharding.py``.

A mesh of several processes is a ``torch.distributed`` DeviceMesh with
named dims. Each process is one rank: a launcher starts the processes
and initialises the process group with its address, rank and world
size. A one-rank mesh needs no launcher: :func:`make_mesh` then
initialises a one-rank group itself from an in-process ``HashStore``,
so nothing listens on a port. Under a launcher (``MXTPU_*`` in the
environment) :func:`make_mesh` joins the launcher's world first
(:func:`~mxnet_tpu_torch.parallel.distributed.init_distributed`), and
an existing group is reused; a one-rank group made here gives way to a
launcher's world joined later.

The executor group's mesh is a :class:`ContextMesh`: the grid of the
contexts of one process, named ``("dp",)`` or ``("dp", "fsdp")`` as the
reference's group names its device grid (``MXNET_TPU_MESH_FSDP``).
:func:`make_mesh` given contexts for ``devices`` builds one too: the
serving grid ``make_mesh({"dp": n // tp, "tp": tp}, devices=contexts)``
(``serving.InferenceServer(tp=)``), on which :func:`tp_shard` gives a
context its shard of a param and :func:`batch_shard_index` the rows of a
batch it serves.

The spec layer is pure functions of a mesh's axis names and sizes, so it
takes either kind of mesh: :func:`batch_spec`, :func:`fsdp_param_spec`
(dim 0 along ``fsdp`` where it divides), :func:`tp_param_spec` (the
largest dividing dim along ``tp``, the earliest on ties),
:func:`make_param_shardings` (the first matching rule whose spec
divides). A :class:`PartitionSpec` is a tuple of an axis name, a tuple
of them or None a dim, so ``tuple(spec)`` compares with JAX's. A
:class:`NamedSharding` carries the DTensor ``placements`` its spec maps
to: ``Shard(d)`` on the mesh dim named at tensor dim ``d``,
``Replicate()`` elsewhere.

:func:`build_sgd_train_step` is the reference's one-function SGD step
over autograd. Over a DeviceMesh the params are DTensors: each is
gathered to a plain tensor before the graph runs (the kernels take
plain tensors), the batch is each rank's local shard, BatchNorm's
statistics are those of the global batch (one autograd-aware all-reduce
of the partial sums a BatchNorm over the data axes), and each gradient
is summed over the data axes onto its param's placements: ``Partial`` to
``Shard`` is a reduce-scatter, ``Partial`` to ``Replicate`` an
all-reduce. A ``tp`` placement there shards the storage of a param and
its gradient; the training step's computation is not split along
``tp`` (ROADMAP.md Queue A, the 10e leftover). Serving splits it: on a
``(dp, tp)`` grid of contexts each card computes its share of every
FullyConnected and Convolution product
(:mod:`mxnet_tpu_torch.parallel.tp_infer`).
"""
from __future__ import annotations

import logging
import math
import re
from collections import namedtuple
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..base import DeviceUnavailableError, MXNetError

__all__ = ["make_mesh", "mesh_axis_sizes", "make_param_shardings",
           "shard_args", "build_sgd_train_step", "ShardingRule",
           "batch_spec", "fsdp_param_spec", "tp_param_spec",
           "batch_shard_extent", "batch_shard_index", "tp_shard",
           "tp_shard_dim", "DATA_AXES", "PartitionSpec", "NamedSharding",
           "ContextMesh"]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

ShardingRule = namedtuple("ShardingRule", ["pattern", "spec"])

#: Mesh axes the batch shards over, in mesh-major order. ``dp`` is pure
#: data parallelism; ``fsdp`` also shards the batch, and shards params
#: and optimizer state. ``tp`` is a model axis, not a data axis.
DATA_AXES = ("dp", "fsdp")


class _Last:
    """The mesh :func:`make_mesh` built last (``axis_name=`` of the
    sequence-parallel attention resolves against it)."""

    mesh = None


class PartitionSpec(tuple):
    """A tuple with one entry a tensor dim: a mesh axis name, a tuple of
    them, or None (not sharded). ``PartitionSpec()`` replicates."""

    def __new__(cls, *parts):
        return tuple.__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


class ContextMesh:
    """The named grid of one process's contexts (the executor group's
    mesh): ``devices`` is the array of contexts in the grid's shape,
    filled in context order, row-major over ``axis_names``."""

    def __init__(self, axis_sizes: Dict[str, int], contexts):
        self.axis_names = tuple(axis_sizes)
        sizes = [int(s) for s in axis_sizes.values()]
        n = math.prod(sizes)
        contexts = list(contexts)
        if len(contexts) < n:
            raise MXNetError("mesh %s needs %d devices, have %d"
                             % (dict(axis_sizes), n, len(contexts)))
        grid = np.empty(n, dtype=object)
        grid[:] = contexts[:n]
        self.devices = grid.reshape(sizes)
        self.shape = dict(zip(self.axis_names, sizes))
        self.size = n

    def groups(self, axis: str) -> List[List[int]]:
        """The flat context indices of each line of the grid along
        ``axis`` (every other axis fixed), in grid order."""
        d = self.axis_names.index(axis)
        idx = np.arange(self.size).reshape(self.devices.shape)
        lines = np.moveaxis(idx, d, -1).reshape(-1, self.shape[axis])
        return [[int(i) for i in line] for line in lines]

    def coords(self, k: int) -> Dict[str, int]:
        """Context ``k``'s index along every axis."""
        at = np.unravel_index(k, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, at)}

    def __repr__(self):
        return "ContextMesh(%s)" % self.shape


class NamedSharding:
    """A spec on a mesh, with the DTensor placements it maps to (one a
    mesh dim)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        self.placements = _placements(mesh, self.spec)

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


def _placements(mesh, spec) -> tuple:
    from torch.distributed.tensor import Replicate, Shard

    at = {}
    for d, axis in enumerate(spec):
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is not None:
                at[a] = d
    return tuple(Shard(at[a]) if a in at else Replicate()
                 for a in mesh_axis_sizes(mesh))


def make_mesh(axis_sizes: Dict[str, int], devices: Optional[Sequence] = None,
              device_type: str = "cuda"):
    """A DeviceMesh with named axes, e.g. ``{"dp": 2, "fsdp": 2}``, over
    ``devices``, the world ranks it spans in grid order (default: the
    ranks of the default process group, whose number must then equal the
    mesh's size). Every rank of the world calls it. It runs on the card
    unless ``device_type="cpu"`` is asked for.

    ``devices`` given as contexts (``mx.gpu(k)``, ``mx.cpu(k)``) gives
    the :class:`ContextMesh` of those contexts instead: one process's
    grid, which needs no process group."""
    from ..context import Context

    if devices is not None and len(devices) \
            and all(isinstance(d, Context) for d in devices):
        return ContextMesh(axis_sizes, devices)
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
    world = dist.get_world_size()
    if devices is None:
        if world != n:
            raise MXNetError("make_mesh: mesh %s needs %d ranks, the "
                             "process group has %d"
                             % (dict(axis_sizes), n, world))
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh(device_type, sizes, mesh_dim_names=names)
    else:
        ranks = [int(r) for r in devices]
        if len(ranks) < n:
            raise MXNetError("mesh needs %d devices, have %d"
                             % (n, len(ranks)))
        bad = [r for r in ranks[:n] if not 0 <= r < world]
        if bad:
            raise MXNetError("make_mesh: ranks %s are not in the world of "
                             "%d" % (bad, world))
        from torch.distributed.device_mesh import DeviceMesh

        mesh = DeviceMesh(device_type,
                          torch.tensor(ranks[:n]).reshape(sizes),
                          mesh_dim_names=names)
    _Last.mesh = mesh
    return mesh


def last_mesh():
    """The mesh :func:`make_mesh` built last in this process, or None."""
    return _Last.mesh


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis_name: size}`` of a mesh (a DeviceMesh, the executor
    group's :class:`ContextMesh`), in axis order."""
    if isinstance(mesh, ContextMesh):
        return {name: int(mesh.shape[name]) for name in mesh.axis_names}
    return {name: int(mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names)}


def batch_spec(mesh, batch_axis: int) -> PartitionSpec:
    """The spec sharding ``batch_axis`` over every data axis the mesh
    carries (``dp``, and ``fsdp`` when present)."""
    sizes = mesh_axis_sizes(mesh)
    axes = tuple(a for a in DATA_AXES if a in sizes)
    spec = [None] * (batch_axis + 1)
    spec[batch_axis] = axes if len(axes) > 1 else axes[0]
    return PartitionSpec(*spec)


def fsdp_param_spec(shape, mesh, axis: str = "fsdp"
                    ) -> Optional[PartitionSpec]:
    """A param's (or optimizer state's) spec under the FSDP recipe: dim 0
    along ``axis`` when it divides evenly, replicated otherwise; None
    when the mesh has no ``axis``."""
    sizes = mesh_axis_sizes(mesh)
    if axis not in sizes:
        return None
    size = sizes[axis]
    if size <= 1 or not shape or shape[0] % size != 0:
        return PartitionSpec()
    return PartitionSpec(*((axis,) + (None,) * (len(shape) - 1)))


def batch_shard_extent(mesh) -> int:
    """How many ways the batch shards on this mesh: the product of the
    data axes present, not the mesh's size; 1 for no mesh."""
    if mesh is None:
        return 1
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for a in DATA_AXES if a in sizes)


def batch_shard_index(mesh, k: int) -> int:
    """Which of the :func:`batch_shard_extent` slices of a batch context
    ``k`` of a :class:`ContextMesh` serves: its index over the data axes
    (row-major). The contexts of one ``tp`` line share it."""
    at = mesh.coords(k)
    index = 0
    for a in DATA_AXES:
        if a in mesh.shape:
            index = index * mesh.shape[a] + at[a]
    return index


def tp_shard_dim(shape, mesh, axis: str = "tp") -> Optional[int]:
    """The dim of a param of ``shape`` that :func:`tp_param_spec` splits
    along ``axis``; None where the param stays whole (no dim divides, a
    ``tp`` of 1, no such axis)."""
    spec = tp_param_spec(tuple(shape), mesh, axis)
    for d, a in enumerate(spec or ()):
        if a == axis:
            return d
    return None


def tp_shard(value, mesh, k: int, axis: str = "tp"):
    """Context ``k``'s local shard of a param (a numpy array or a tensor,
    its whole value) on ``mesh``, a :class:`ContextMesh`: the ``j``-th
    of the ``tp`` equal slices along the dim :func:`tp_param_spec`
    picks, ``j`` the context's ``tp`` coordinate; ``value`` itself where
    the param stays whole. A view, not a copy."""
    d = tp_shard_dim(value.shape, mesh, axis)
    if d is None:
        return value
    size = value.shape[d] // mesh.shape[axis]
    j = mesh.coords(k)[axis]
    index = [slice(None)] * len(value.shape)
    index[d] = slice(j * size, (j + 1) * size)
    return value[tuple(index)]


def tp_param_spec(shape, mesh, axis: str = "tp") -> Optional[PartitionSpec]:
    """A param's spec under the tensor-parallel recipe: the largest dim
    that divides by the ``axis`` size along it (the earliest on ties),
    replicated when none divides; None when the mesh has no ``axis``."""
    sizes = mesh_axis_sizes(mesh)
    if axis not in sizes:
        return None
    size = sizes[axis]
    if size <= 1 or not shape:
        return PartitionSpec()
    best = None
    for d, dim in enumerate(shape):
        if dim % size == 0 and (best is None or dim > shape[best]):
            best = d
    if best is None:
        return PartitionSpec()
    spec = [None] * len(shape)
    spec[best] = axis
    return PartitionSpec(*spec)


def _spec_fits(shape, spec, mesh) -> bool:
    """A spec applies only if every sharded dim divides evenly."""
    sizes = mesh_axis_sizes(mesh)
    for dim, axis in zip(shape, tuple(spec)):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        if dim % math.prod(sizes[a] for a in axes) != 0:
            return False
    return True


def make_param_shardings(mesh, name_to_shape: Dict[str, tuple],
                         rules: Sequence[ShardingRule]
                         ) -> Dict[str, NamedSharding]:
    """name -> NamedSharding from the first rule whose pattern matches
    the name and whose spec divides the shape; the others replicate."""
    out = {}
    for name, shape in name_to_shape.items():
        sharding = NamedSharding(mesh, PartitionSpec())
        for rule in rules:
            if re.match(rule.pattern, name) \
                    and _spec_fits(shape, rule.spec, mesh):
                sharding = NamedSharding(mesh, rule.spec)
                break
        out[name] = sharding
    return out


def shard_args(mesh, arrays: Dict[str, object],
               shardings: Dict[str, NamedSharding]) -> Dict[str, object]:
    """Each named array (numpy or a tensor, the same on every rank) as a
    DTensor on ``mesh`` with its sharding's placements."""
    from torch.distributed.tensor import distribute_tensor

    out = {}
    for name, arr in arrays.items():
        t = arr if isinstance(arr, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(arr))
        out[name] = distribute_tensor(t, mesh, shardings[name].placements)
    return out


class _Quiet(logging.Filter):
    """Drops DTensor's note that a redistribute over two mesh dims runs
    two collectives (a reduce-scatter over ``fsdp`` and an all-reduce
    over ``dp``: the exchange this step means)."""

    def filter(self, record):
        return "sequential" not in record.getMessage()


_REDISTRIBUTE_LOG = "torch.distributed.tensor._redistribute"


def _data_group(mesh):
    """``(process group, shards)`` over this rank's line of the mesh's
    data axes (every other axis fixed), or ``(None, 1)`` when the batch
    is not sharded. Every rank of the mesh calls it, in the same order
    (a new group is collective); the result is kept on the mesh."""
    cached = getattr(mesh, "_mxtpu_data_group", None)
    if cached is not None:
        return cached
    sizes = mesh_axis_sizes(mesh)
    names = list(sizes)
    data = [names.index(a) for a in DATA_AXES if a in sizes]
    shards = math.prod(sizes[names[d]] for d in data)
    if shards == 1:
        out = (None, 1)
    else:
        rest = [d for d in range(len(names)) if d not in data]
        lines = mesh.mesh.permute(*(rest + data)).reshape(-1, shards)
        group, _ = dist.new_subgroups_by_enumeration(lines.tolist())
        out = (group, shards)
    mesh._mxtpu_data_group = out
    return out


def build_sgd_train_step(symbol, data_names: Sequence[str],
                         label_names: Sequence[str], lr: float = 0.01,
                         compute_dtype=None):
    """``(step, param_names)``: ``step(params, data, aux, key) ->
    (outputs, new_params, new_aux)``, forward, backward (autograd over
    ``executor.make_graph_eval``) and SGD in one function, the gradient
    of every output's sum (heads of ones).

    ``params`` and ``data`` are dicts by name, ``aux`` a list in the
    symbol's aux order, ``key`` a ``torch.Generator`` or an int seed for
    the random ops. Plain tensors run on their device. Over a DeviceMesh
    the params are DTensors (:func:`shard_args`) and each rank's batch is
    its local shard (a DTensor's local part, or a plain tensor); the new
    params keep their placements, and ``outputs`` are the local batch's.

    ``compute_dtype`` (``torch.bfloat16``, ``torch.float16`` or their
    names) is mixed precision: params and data are cast on the way in
    (labels never are) and the outputs back to float32; the master
    weights, the update and BatchNorm's statistics stay float32."""
    from ..executor import _cast_graph, make_graph_eval, \
        resolve_compute_dtype

    dtype = resolve_compute_dtype(compute_dtype)
    arg_names = symbol.list_arguments()
    label_set = set(label_names)
    input_names = set(data_names) | label_set
    param_names = [n for n in arg_names if n not in input_names]
    graphs = {}

    def graph(reps):
        key = id(reps)
        if key not in graphs:
            fn, _ = make_graph_eval(symbol, replicas=reps)
            if dtype is not None:
                fn = _cast_graph(fn, arg_names, label_set, dtype, reps)
            graphs[key] = (fn, reps)
        return graphs[key][0]

    def step(params: Dict, data: Dict, aux: List, key):
        from torch.distributed.tensor import DTensor

        missing = [n for n in param_names if n not in params]
        if missing:
            raise MXNetError("build_sgd_train_step: params %s missing"
                             % missing)
        first = params[param_names[0]] if param_names else None
        mesh = first.device_mesh if isinstance(first, DTensor) else None
        full = {}
        for n in param_names:
            p = params[n]
            t = p.full_tensor() if isinstance(p, DTensor) else p
            full[n] = t.detach().requires_grad_(True)
        local = {n: (v.to_local() if isinstance(v, DTensor) else v)
                 for n, v in data.items()}
        dev = (full[param_names[0]] if param_names
               else next(iter(local.values()))).device
        rng = key
        if not isinstance(rng, torch.Generator):
            rng = torch.Generator(device=dev)
            rng.manual_seed(int(key))
        args = [full[n] if n in full else local[n] for n in arg_names]
        aux_in = [a.to_local() if isinstance(a, DTensor) else a for a in aux]
        reps = None
        if mesh is not None:
            group, shards = _data_group(mesh)
            reps = getattr(mesh, "_mxtpu_replicas", None)
            if group is not None and (reps is None
                                      or reps.devices[0] != dev):
                from ..replicas import ProcessReplicas

                reps = mesh._mxtpu_replicas = ProcessReplicas(dev, group,
                                                              shards)
        fn = graph(reps)
        with torch.enable_grad():
            if reps is None:
                outs, new_aux = fn(args, aux_in, rng, True)
            else:
                outs, new_aux = fn([args], [aux_in], [rng], True)
                outs, new_aux = outs[0], new_aux[0]
        ys = [o for o in outs if o.requires_grad]
        heads = [torch.ones_like(o) for o in ys]
        xs = [full[n] for n in param_names]
        grads = (torch.autograd.grad(ys, xs, heads, allow_unused=True)
                 if ys and xs else [None] * len(xs))
        quiet = _Quiet()
        logging.getLogger(_REDISTRIBUTE_LOG).addFilter(quiet)
        try:
            new_params = _update(params, param_names, xs, grads, mesh, lr)
        finally:
            logging.getLogger(_REDISTRIBUTE_LOG).removeFilter(quiet)
        with torch.no_grad():
            new_aux = [a.detach().to(b.dtype) for a, b in zip(new_aux,
                                                             aux_in)]
        return [o.detach() for o in outs], new_params, new_aux

    return step, param_names


@torch.no_grad()
def _update(params, names, xs, grads, mesh, lr):
    """SGD on every param: each gradient (``None``: unused, zero) summed
    over the mesh's data axes onto its param's placements first."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    out = {}
    for n, x, g in zip(names, xs, grads):
        if g is None:
            g = torch.zeros_like(x)
        p = params[n]
        if mesh is None:
            out[n] = p - lr * g
            continue
        partial = [Partial() if a in DATA_AXES else Replicate()
                   for a in mesh.mesh_dim_names]
        gd = DTensor.from_local(g.contiguous(), mesh, partial,
                                run_check=False)
        gd = gd.redistribute(mesh, p.placements)
        out[n] = DTensor.from_local(p.to_local() - lr * gd.to_local(), mesh,
                                    p.placements, run_check=False)
    return out
