"""Executor group, counterpart of ``mxnet_tpu/module/executor_group.py``.

The data and label arrays are the per-batch slots; every other argument
is a parameter whose array the group owns. Parameter and batch writes
copy into the bound arrays in place (a batch through a pinned buffer on
a card, so that a CUDA graph over the bound arrays sees each batch).
Bound for training, each parameter (and, with ``inputs_need_grad``,
each data input) gets a gradient array that ``backward`` fills by
``grad_req``; labels and ``fixed_param_names`` get none.

One context binds one executor over the whole batch. Bound with a
``shared_group``, the group takes that group's arrays (parameters,
gradients, aux states and inputs) wherever the shapes agree: the same
tensors, as the bucketing module's buckets share one set of weights.
Over several contexts the shared group must be bound over the same
contexts: each replica takes the owner's replica's arrays, its flat
gradient buffers (which the exchange sums) and, under fsdp, its
sharded storage.

Several contexts (ROADMAP.md Queue A item 10a) bind one executor a
context, each on an equal slice of the batch along every array's batch
axis (the batch must divide by the number of contexts, as the JAX
package requires), each with its own copy of every parameter, gradient
and aux state, so that the tensors a CUDA graph captured stay fixed.
They run as one :class:`~mxnet_tpu_torch.executor.ReplicatedExecutor`:
a lock-step forward whose BatchNorm statistics and normalized losses
are those of the global batch, and a backward after which every
replica holds the gradients of the global batch. ``executor`` is the
first replica's, from which ``get_params`` reads; ``set_params`` writes
every replica. Outputs come back joined along each output's batch
axis (or time-major rows: each output's layout is derived from the
graph, :mod:`~mxnet_tpu_torch.batch_layout`) on the first context's
device, as the JAX package's global arrays read; the metric scores each
replica against its slice of the labels.
``work_load_list`` is accepted and, as in the JAX package, ignored: the
slices are equal.

The contexts form the group's mesh (:class:`~mxnet_tpu_torch.parallel.
sharding.ContextMesh`), ``("dp",)``, or ``("dp", "fsdp")`` under
``MXNET_TPU_MESH_FSDP=N`` (ROADMAP.md Queue A item 10c), in the
reference's grid order: context ``k`` sits at ``dp = k // N``, ``fsdp =
k % N``. Under the fsdp recipe each parameter with a gradient whose dim
0 divides by N (:meth:`param_sharding`) is kept as one shard of dim 0 a
card (:class:`~mxnet_tpu_torch.replicas.ShardedParams`): the card's
master rows, its rows of the reduced gradient and its optimizer state
have the shard's shape. Every replica's full-width parameter array
stays as the walk's workspace: the shards are all-gathered into it
before each forward, and the gradients are reduce-scattered into the
shards after the backward. ``MXNET_TPU_FSDP_PARAMS=0`` keeps the mesh
and replicates every parameter.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import env as _env
from ..base import MXNetError
from ..context import Context
from ..executor import _UNSET, Executor, ReplicatedExecutor
from ..io import DataDesc
from ..metric import check_label_shapes
from ..ndarray import HostToDevice, NDArray, zeros

__all__ = ["DataParallelExecutorGroup", "check_contexts"]


def check_contexts(contexts) -> List[torch.device]:
    """The torch devices of a context list, which must be all CPU or all
    GPU contexts, each named once; a card that is not there raises
    :class:`~mxnet_tpu_torch.base.DeviceUnavailableError`."""
    contexts = list(contexts)
    if not contexts:
        raise MXNetError("no context given")
    kinds = {c.device_type for c in contexts}
    if len(kinds) > 1:
        raise MXNetError("contexts %s mix CPU and GPU devices; a group runs "
                         "on one kind" % contexts)
    if len(set(contexts)) != len(contexts):
        raise MXNetError("contexts %s name a device twice; each replica "
                         "needs its own" % contexts)
    return [c.torch_device() for c in contexts]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts: Sequence[Context], data_shapes,
                 label_shapes, param_names: List[str], for_training: bool,
                 inputs_need_grad: bool = False, grad_req: str = "write",
                 fixed_param_names=(), shared_group=None,
                 compute_dtype=_UNSET, workload=None):
        self.contexts = list(contexts)
        devices = check_contexts(self.contexts)
        self.symbol = symbol
        self.context = self.contexts[0]
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.workload = workload
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                            for d in data_shapes]
        self.label_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in (label_shapes or [])]
        self.data_names = [d.name for d in self.data_shapes]
        self.label_names = [d.name for d in self.label_shapes]
        self.batch_size = self.data_shapes[0].shape[
            DataDesc.get_batch_axis(self.data_shapes[0].layout)]

        reqs = {}
        for name in self.arg_names:
            if name in self.data_names:
                reqs[name] = "write" if inputs_need_grad else "null"
            elif name in self.label_names or not for_training \
                    or name in fixed_param_names:
                reqs[name] = "null"
            else:
                reqs[name] = grad_req
        self.grad_req = reqs
        self._loaders = None
        self._feeds = None      # a DeviceFeed a replica (several contexts)
        #: the replica set and its executor (several contexts), else None
        self.replicas = None
        self.replicated = None
        #: the named grid of the contexts (several contexts), else None
        self._mesh = None
        self._arg_shape: Dict[str, tuple] = {}
        #: the fsdp storage of the sharded parameters, else None
        self.shards = None
        if len(self.contexts) > 1:
            self._bind_replicas(devices, shared_group, compute_dtype)
            return

        shapes = {d.name: d.shape for d in self.data_shapes + self.label_shapes}
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        ctx = self.context
        shared_args, shared_grads, shared_aux = {}, {}, {}
        if shared_group is not None:
            if shared_group.context != ctx:
                raise MXNetError("shared module on %s, this one on %s"
                                 % (shared_group.context, ctx))
            ex = shared_group.executor
            shared_args, shared_grads = ex.arg_dict, ex.grad_dict
            shared_aux = ex.aux_dict
        inputs = set(self.data_names) | set(self.label_names)
        args, grads = [], {}
        for name, shape in zip(self.arg_names, arg_shapes):
            shared = shared_args.get(name)
            if shared is not None and shared.shape == tuple(shape):
                args.append(shared)
            elif shared is not None and name not in inputs:
                raise MXNetError(
                    "shared param '%s' changes shape across buckets (%s "
                    "vs %s); every bucket's symbol must give a param the "
                    "same shape" % (name, shared.shape, tuple(shape)))
            else:
                args.append(zeros(shape, ctx=ctx))
            if reqs[name] != "null":
                g = shared_grads.get(name)
                grads[name] = (g if g is not None
                               and g.shape == tuple(shape)
                               else zeros(shape, ctx=ctx))
        aux = [shared_aux[n] if n in shared_aux
               and shared_aux[n].shape == tuple(s) else zeros(s, ctx=ctx)
               for n, s in zip(self.aux_names, aux_shapes)]
        self.executor = Executor(symbol, ctx, args, grads, reqs, aux,
                                 label_names=self.label_names,
                                 compute_dtype=compute_dtype)
        self.execs = [self.executor]

    # -- several contexts -----------------------------------------------------
    def _bind_replicas(self, devices, shared_group, compute_dtype):
        from ..replicas import Replicas

        n = len(self.contexts)
        if self.batch_size % n:
            raise MXNetError("batch size %d not divisible by %d devices"
                             % (self.batch_size, n))
        self._mesh = self._make_mesh()
        owner = None
        if shared_group is not None:
            if shared_group.contexts != self.contexts \
                    or shared_group.replicated is None:
                raise MXNetError(
                    "shared module on %s, this one on %s: a module bound "
                    "over several contexts shares its owner's arrays only "
                    "over the same contexts, in the same order"
                    % (shared_group.contexts, self.contexts))
            owner = shared_group
        shapes = {}
        for d in self.data_shapes + self.label_shapes:
            shape = list(d.shape)
            shape[self._batch_axis_of(d.name)] //= n
            shapes[d.name] = tuple(shape)
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**shapes)
        exchange = [name for name in self.param_names
                    if self.grad_req.get(name, "null") != "null"]
        shape_of = dict(zip(self.arg_names, arg_shapes))
        # a parameter's global shape: its bound one (params do not follow
        # the batch)
        self._arg_shape = {name: tuple(shape_of[name])
                           for name in self.param_names}
        sharded = [name for name in exchange
                   if self._sharded_spec(name) is not None]
        replicated = [name for name in exchange if name not in sharded]
        self.replicas = owner.replicas if owner is not None \
            else Replicas(devices)
        if owner is not None:
            flats = self._share(owner, replicated, sharded, shape_of,
                                arg_shapes, aux_shapes, compute_dtype)
        else:
            flats = self._bind_fresh(replicated, sharded, shape_of,
                                     arg_shapes, aux_shapes, compute_dtype)
        self.executor = self.execs[0]
        inputs = {d.name: self._batch_axis_of(d.name)
                  for d in self.data_shapes + self.label_shapes}
        self.replicated = ReplicatedExecutor(
            self.execs, self.replicas, replicated, flats, inputs,
            shards=self.shards)

    def _bind_fresh(self, replicated, sharded, shape_of, arg_shapes,
                    aux_shapes, compute_dtype):
        """An executor a context over arrays of its own: the replicated
        parameters' gradients views of one flat buffer a card, and under
        fsdp the sharded parameters' storage. Returns the flat buffers, a
        list a replica."""
        self.execs, flats, works, sh_grads = [], [], [], []
        for ctx in self.contexts:
            work, work_flat = _flat_arrays(sharded, shape_of, ctx)
            args = [work[name] if name in work else zeros(s, ctx=ctx)
                    for name, s in zip(self.arg_names, arg_shapes)]
            grads, flat = _flat_grads(replicated, shape_of, ctx)
            sh, sh_flat = _flat_arrays(sharded, shape_of, ctx)
            grads.update(sh)
            for name in self.data_names:
                if self.grad_req[name] != "null":
                    grads[name] = zeros(shape_of[name], ctx=ctx)
            aux = [zeros(s, ctx=ctx) for s in aux_shapes]
            self.execs.append(Executor(
                self.symbol, ctx, args, grads, self.grad_req, aux,
                label_names=self.label_names, compute_dtype=compute_dtype))
            flats.append(flat)
            works.append(work_flat)
            sh_grads.append(sh_flat)
        if sharded:
            from ..replicas import ShardedParams

            adds = {name for name in sharded
                    if self.grad_req[name] == "add"}
            self.shards = ShardedParams(
                self.replicas, self._mesh, sharded,
                [shape_of[name] for name in sharded], works, sh_grads,
                self.contexts, adds=adds)
        return flats

    def _share(self, owner, replicated, sharded, shape_of, arg_shapes,
               aux_shapes, compute_dtype):
        """An executor a context over the owner group's arrays (a bucket
        of a BucketingModule): its parameters, their gradients (views of
        the owner's flat buffers, which its exchange sums), its aux
        states and, under fsdp, its sharded storage; inputs whose shapes
        agree are shared too. The parameters with a gradient must be the
        owner's, in the owner's order: the exchange sums whole flat
        buffers. Returns the owner's flat buffers."""
        theirs = owner.replicated._exchange_names + (
            [] if owner.shards is None else owner.shards.names)
        if replicated + sharded != theirs:
            raise MXNetError(
                "shared module: this module's parameters with a gradient "
                "%s are not its owner's %s; every bucket's symbol must "
                "train the same parameters" % (replicated + sharded, theirs))
        inputs = set(self.data_names) | set(self.label_names)
        self.execs = []
        for k, ctx in enumerate(self.contexts):
            ex = owner.execs[k]
            args, grads = [], {}
            for name, shape in zip(self.arg_names, arg_shapes):
                shared = ex.arg_dict.get(name)
                if shared is not None and shared.shape == tuple(shape):
                    args.append(shared)
                elif shared is not None and name not in inputs:
                    raise MXNetError(
                        "shared param '%s' changes shape across buckets "
                        "(%s vs %s); every bucket's symbol must give a "
                        "param the same shape"
                        % (name, shared.shape, tuple(shape)))
                else:
                    args.append(zeros(shape, ctx=ctx))
                if self.grad_req[name] == "null":
                    continue
                g = ex.grad_dict.get(name)
                grads[name] = (g if g is not None and name not in inputs
                               and g.shape == tuple(shape)
                               else zeros(shape, ctx=ctx))
            aux = [ex.aux_dict[a] if a in ex.aux_dict
                   and ex.aux_dict[a].shape == tuple(s) else zeros(s, ctx=ctx)
                   for a, s in zip(self.aux_names, aux_shapes)]
            self.execs.append(Executor(
                self.symbol, ctx, args, grads, self.grad_req, aux,
                label_names=self.label_names, compute_dtype=compute_dtype))
        self.shards = owner.shards
        return owner.replicated.flats

    def _batch_axis_of(self, name: str) -> int:
        for d in self.data_shapes + self.label_shapes:
            if d.name == name:
                return DataDesc.get_batch_axis(d.layout)
        return 0

    def _make_mesh(self):
        """The ``(dp,)`` or, under ``MXNET_TPU_MESH_FSDP=N``, ``(dp,
        fsdp)`` grid of the contexts (the reference's
        ``executor_group.py:86-105``)."""
        from ..parallel.sharding import ContextMesh

        n = len(self.contexts)
        fsdp = int(_env.get("MXNET_TPU_MESH_FSDP") or 0)
        if fsdp > 1:
            if n % fsdp:
                raise MXNetError(
                    "MXNET_TPU_MESH_FSDP=%d does not divide the %d-device"
                    " grid: the (dp, fsdp) mesh needs dp = devices/fsdp "
                    "to be a whole number" % (fsdp, n))
            return ContextMesh({"dp": n // fsdp, "fsdp": fsdp},
                               self.contexts)
        return ContextMesh({"dp": n}, self.contexts)

    def _sharded_spec(self, name: str):
        """The fsdp spec of parameter ``name`` when it is sharded (the
        recipe armed, ``MXNET_TPU_FSDP_PARAMS`` on, dim 0 divides), else
        None."""
        from ..parallel.sharding import fsdp_param_spec

        if self._mesh is None or name not in self.param_names \
                or not _env.get("MXNET_TPU_FSDP_PARAMS"):
            return None
        spec = fsdp_param_spec(self._arg_shape[name], self._mesh)
        return spec if spec else None

    def param_sharding(self, name: str):
        """The NamedSharding of parameter ``name`` (and of its gradient
        and optimizer state) on the group's mesh: dim 0 along ``fsdp``
        where the parameter is sharded, replicated otherwise; None on one
        context."""
        from ..parallel.sharding import NamedSharding, PartitionSpec

        if self._mesh is None:
            return None
        sharded = self.shards is not None and name in self.shards.index
        spec = self._sharded_spec(name) if sharded else None
        return NamedSharding(self._mesh, spec or PartitionSpec())

    def shard_rows(self, name: Optional[str], k: int, shape=None):
        """The rows of dim 0 that context ``k`` keeps of parameter
        ``name`` (or of an optimizer state of its shape, ``shape``):
        a slice, or None where it keeps the whole array."""
        if self.shards is None or name not in self.shards.index:
            return None
        if shape is not None and tuple(shape) != self._arg_shape[name]:
            return None
        return self.shards.rows(name, k)

    def place_param(self, name: str, np_or_nd, dtype=None) -> List[NDArray]:
        """A parameter (or a state of its shape) on every context, one
        NDArray a context in context order: its shard where the
        parameter is sharded, the whole array otherwise."""
        if isinstance(np_or_nd, NDArray):
            src = np_or_nd.handle
        else:
            src = torch.from_numpy(np.ascontiguousarray(
                np.asarray(np_or_nd, dtype=dtype)))
        out = []
        for k, ctx in enumerate(self.contexts):
            rows = self.shard_rows(name, k)
            part = src if rows is None else src[rows]
            out.append(NDArray(part.to(ctx.torch_device(), copy=True), ctx))
        return out

    def place_like_param(self, name: Optional[str], np_or_nd,
                         dtype=None) -> List[NDArray]:
        """As :meth:`place_param` where the array has the parameter's
        shape (the optimizer-state contract), else the whole array on
        every context."""
        shape = self._arg_shape.get(name) if name else None
        arr = np_or_nd.handle if isinstance(np_or_nd, NDArray) \
            else np.asarray(np_or_nd, dtype=dtype)
        if shape is not None and tuple(arr.shape) == shape:
            return self.place_param(name, np_or_nd, dtype=dtype)
        return self.place_param(None, np_or_nd, dtype=dtype)

    def update_arrays(self, k: int):
        """``(name, weight, grad)`` of every parameter with a gradient on
        context ``k``, in ``param_names`` order: the card's shard views
        where the parameter is sharded (what the update and its state
        act on), the bound arrays otherwise."""
        ex = self.execs[k]
        out = []
        for name in self.param_names:
            if name not in ex.grad_dict:
                continue
            if self.shards is not None and name in self.shards.index:
                out.append((name, self.shards.weight(name, k),
                            self.shards.grad(name, k)))
            else:
                out.append((name, ex.arg_dict[name], ex.grad_dict[name]))
        return out

    # -- params -----------------------------------------------------------------
    def write_param(self, name: str, value):
        """Parameter ``name`` (an NDArray, tensor or numpy array of its
        whole shape) into every replica's array and, where it is
        sharded, every card's master shard, in place."""
        src = value.handle if isinstance(value, NDArray) else value
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.ascontiguousarray(np.asarray(src)))
        with torch.no_grad():
            for k, ex in enumerate(self.execs):
                ex.arg_dict[name].handle.copy_(src)
                rows = self.shard_rows(name, k)
                if rows is not None:
                    self.shards.weight(name, k).handle.copy_(src[rows])

    def param_value(self, name: str) -> torch.Tensor:
        """Parameter ``name``'s current value over its whole shape, on
        the first context: the first fsdp group's master shards joined
        where it is sharded (the full-width arrays are the walk's
        workspace, refreshed at the next forward), the first replica's
        array otherwise."""
        if self.shards is not None and name in self.shards.index:
            return self.shards.gather_value(name)
        return self.executor.arg_dict[name].handle

    def set_params(self, arg_params: Dict[str, NDArray],
                   aux_params: Dict[str, NDArray]):
        """Every replica's arrays (and master shards), in place."""
        for name, arr in arg_params.items():
            if name in self.executor.arg_dict:
                self.write_param(name, arr)
        for ex in self.execs:
            for name, arr in (aux_params or {}).items():
                if name in ex.aux_dict:
                    ex.aux_dict[name][:] = arr

    def get_params(self, arg_params: Dict[str, NDArray],
                   aux_params: Dict[str, NDArray]):
        """From the first replica (the replicas are equal), a sharded
        parameter from its shards."""
        for name in self.param_names:
            if name in self.executor.arg_dict:
                arg_params[name][:] = NDArray(self.param_value(name),
                                              self.context)
        for name, arr in zip(self.aux_names, self.executor.aux_arrays):
            if name in aux_params:
                aux_params[name][:] = arr

    def install_monitor(self, mon):
        mon.install(self.replicated or self.executor)

    # -- batches ----------------------------------------------------------------
    def load_data_batch(self, data_batch):
        """Copy a batch's data and labels (NDArrays, tensors or host
        arrays) into the bound arrays, in place, each replica its slice
        along the array's batch axis: host arrays through a pinned buffer
        a replica, on that card's stream; arrays already on a card (a
        staged batch) device to device. A device-feed batch (``aug``:
        uint8 frames whose crop and normalisation are deferred) goes
        through the same ``crop_norm`` kernel the fused step runs in its
        graph: over several contexts each replica's rows of the frames
        cross to its own card and are cropped into its bound data array
        there (:meth:`load_feed`); on one context, or with more than one
        data input, the batch is materialised on the first device."""
        if getattr(data_batch, "aug", None) is not None:
            if self.replicas is not None and len(self.data_names) == 1:
                name = self.data_names[0]
                self._feeds = self.load_feed(data_batch, self._feeds)
                for k, (ex, feed) in enumerate(zip(self.execs,
                                                   self._feeds)):
                    with self.replicas.device(k):
                        feed.crop(out=ex.arg_dict[name].handle)
                self.load_label_batch(data_batch)
                return
            from ..io_cache import materialize_device_feed

            data_batch = materialize_device_feed(data_batch, self.context)
        self._load(self.data_shapes, data_batch.data, 0)
        self.load_label_batch(data_batch)

    def load_feed(self, data_batch, feeds=None):
        """Each replica's rows of a device-feed batch (``k * B/N .. (k +
        1) * B/N``, as its data slice) into a
        :class:`~mxnet_tpu_torch.io_cache.DeviceFeed` on its device, on
        that device's current stream: ``feeds`` (one a replica) where
        they fit, new ones where not. Returns the feeds, one a
        replica."""
        from ..io_cache import load_device_feed

        n = len(self.execs)
        rows = self.batch_size // n
        feeds = feeds or [None] * n
        out = []
        for k, (ex, feed) in enumerate(zip(self.execs, feeds)):
            with self.replicas.device(k):
                out.append(load_device_feed(
                    feed, data_batch, ex._device,
                    slice(k * rows, (k + 1) * rows)))
        return out

    def load_label_batch(self, data_batch):
        """Copy only the batch's labels into the bound label arrays: the
        fused step's device feed writes the data array itself."""
        self._load(self.label_shapes, data_batch.label or [],
                   len(self.data_shapes))

    def _load(self, descs, arrays, first):
        if self._loaders is None:
            self._loaders = [[HostToDevice(ex.arg_dict[d.name].handle)
                              for ex in self.execs]
                             for d in self.data_shapes + self.label_shapes]
        n = len(self.execs)
        for desc, loaders, arr in zip(descs, self._loaders[first:], arrays):
            axis = self._batch_axis_of(desc.name)
            want = list(loaders[0].dst.shape)
            want[axis] *= n
            if tuple(arr.shape) != tuple(want):
                raise MXNetError("batch '%s' has shape %s, bound for %s"
                                 % (desc.name, tuple(arr.shape),
                                    tuple(want)))
            if n == 1:
                loaders[0].copy(arr)
                continue
            src = arr.handle if isinstance(arr, NDArray) else arr
            rows = want[axis] // n
            for k, loader in enumerate(loaders):
                part = _take(src, axis, k * rows, rows)
                with self.replicas.device(k):
                    loader.copy(part)

    def forward(self, data_batch, is_train=None):
        self.load_data_batch(data_batch)
        if is_train is None:
            is_train = self.for_training
        (self.replicated or self.executor).forward(is_train=is_train)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("executor group bound for inference only")
        (self.replicated or self.executor).backward(out_grads)

    def get_outputs(self, merge_multi_context=True) -> List:
        """The outputs over the whole batch (on the first context), or,
        with ``merge_multi_context=False``, a list of the replicas' slices
        an output."""
        if self.replicated is None:
            return self.executor.outputs
        if merge_multi_context:
            return self.replicated.outputs
        per = [ex.outputs for ex in self.execs]
        return [[o[i] for o in per] for i in range(len(per[0]))]

    def get_input_grads(self, merge_multi_context=True) -> List:
        if not self.inputs_need_grad:
            raise MXNetError("bound with inputs_need_grad=False")
        if self.replicated is None:
            return [self.executor.grad_dict[n] for n in self.data_names]
        per = [[ex.grad_dict[n] for ex in self.execs]
               for n in self.data_names]
        if not merge_multi_context:
            return per
        return [self.replicated.merge([g.handle for g in grads],
                                      self._batch_axis_of(n))
                for n, grads in zip(self.data_names, per)]

    def update_metric(self, eval_metric, labels):
        """The metric over the global batch. Over several contexts each
        replica's outputs are scored against its own slice of the labels
        (each label's slice along its batch axis, on the replica's
        device), as the replicas were fed: a metric with a device fold
        folds each replica into its own accumulator, any other updates
        once a replica."""
        if self.replicated is None:
            eval_metric.update(labels, self.get_outputs())
            return
        n = len(self.execs)
        for k, ex in enumerate(self.execs):
            labs = []
            for desc, lab in zip(self.label_shapes, labels):
                src = lab.handle if isinstance(lab, NDArray) else lab
                if not isinstance(src, torch.Tensor):
                    src = torch.from_numpy(np.ascontiguousarray(src))
                axis = self._batch_axis_of(desc.name)
                rows = src.shape[axis] // n
                labs.append(src.narrow(axis, k * rows, rows).to(ex._device))
            preds = ex.outputs
            if eval_metric.has_device_fold:
                check_label_shapes(labs, preds)
                eval_metric.device_fold(labs, [p.handle for p in preds], k)
            else:
                eval_metric.update([NDArray(t, self.contexts[k])
                                    for t in labs], preds)


def _take(src, axis, start, rows):
    """Rows ``start:start + rows`` of ``src`` (numpy or a tensor) along
    ``axis``."""
    index = [slice(None)] * len(src.shape)
    index[axis] = slice(start, start + rows)
    return src[tuple(index)]


def _flat_arrays(names, shape_of, ctx):
    """Arrays for ``names``, views of one flat float32 buffer on ``ctx``
    (in order): ``({name: NDArray}, flat)``."""
    dev = ctx.torch_device()
    sizes = [int(np.prod(shape_of[n])) for n in names]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    arrays = {n: NDArray(v.view(shape_of[n]), ctx)
              for n, v in zip(names, flat.split(sizes))}
    return arrays, flat


def _flat_grads(names, shape_of, ctx):
    """Gradient arrays for ``names``, views of one flat float32 buffer on
    ``ctx`` (in order): ``({name: NDArray}, [flat])``."""
    grads, flat = _flat_arrays(names, shape_of, ctx)
    return grads, [flat]
