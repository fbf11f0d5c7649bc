"""Module: the standard unit over one symbol, counterpart of
``mxnet_tpu/module/module.py``: bind, params, the optimizer, and the
forward/backward/update steps that ``fit`` runs, on one context or over
several (one replica a context; ROADMAP.md Queue A item 10a)."""
from __future__ import annotations

import logging
from typing import Dict, Optional

from .. import env as _env
from ..base import MXNetError
from ..context import Context, cpu, current_context
from ..executor import _UNSET
from ..initializer import Uniform
from ..io import DataDesc
from .. import kvstore as kvs
from .. import ndarray as nd
from .. import optimizer as opt
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup, check_contexts

__all__ = ["Module"]


class Module(BaseModule):
    """``context`` defaults to the current context, ``gpu(0)`` unless a
    ``with mx.cpu():`` scope is open; a CUDA context without a card
    raises :class:`~mxnet_tpu_torch.base.DeviceUnavailableError` here.
    ``compute_dtype`` (default ``MXNET_COMPUTE_DTYPE``, None for
    float32) is the executor's mixed precision: the graph computes in
    bfloat16 or float16, the labels stay as they are, and params,
    gradients and aux states stay float32. Several contexts (all CPU or
    all GPU, each once) bind a replica a context on an equal slice of the
    batch; the optimizer then keeps a state a replica and applies the
    same update on each. ``work_load_list`` is accepted and kept, and,
    as in the JAX package, the slices are equal whatever it says."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 compute_dtype=_UNSET):
        super().__init__(logger=logger)
        self._compute_dtype = compute_dtype
        # one share of the batch a context; the group keeps it and, as
        # the JAX package's, splits the batch equally
        self._work_load_list = work_load_list
        if context is None:
            context = current_context()
        if isinstance(context, Context):
            context = [context]
        check_contexts(context)
        self._context = list(context)
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        input_names = self._data_names + self._label_names
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._arg_params: Optional[Dict[str, nd.NDArray]] = None
        self._aux_params: Optional[Dict[str, nd.NDArray]] = None
        self._shared_owner: Optional["Module"] = None
        self._params_dirty = False
        self._exec_group: Optional[DataParallelExecutorGroup] = None
        self._optimizer = None
        self._kvstore = None
        self._updater = None
        # one updater a replica (the first is _updater): a state a card
        self._updaters = []
        # the update runs on the kvstore (a dist store of several workers)
        self._update_on_kvstore = False
        self._fused_step = None
        self._fused_step_active = False

    @property
    def _params_dirty(self) -> bool:
        """True when the bound arrays are newer than the host copies.
        A module bound with ``shared_module`` reads and writes its owner's
        flag, since both train the same arrays."""
        if self._shared_owner is not None:
            return self._shared_owner._params_dirty
        return self._params_dirty_flag

    @_params_dirty.setter
    def _params_dirty(self, value: bool):
        if self._shared_owner is not None:
            self._shared_owner._params_dirty = value
        else:
            self._params_dirty_flag = bool(value)

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        """``[(output name, shape)]`` at the bound shapes."""
        shapes = {d.name: d.shape for d in self._data_shapes}
        shapes.update({d.name: d.shape for d in self._label_shapes})
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self._output_names, out_shapes))

    # -- bind --------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the executor; ``for_training`` gives every parameter a
        gradient array (by ``grad_req``), ``inputs_need_grad`` the data
        inputs too. With ``shared_module`` (bound, on the same context)
        the parameters, their gradients and the aux states are the
        owner's arrays, the same tensors, and so are the host copies and
        the dirty flag; a parameter whose shape differs raises."""
        if force_rebind:
            self._exec_group = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if shared_module is not None and not shared_module.binded:
            raise MXNetError("shared_module must be bound first")
        self._data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in data_shapes]
        self._label_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                              for d in (label_shapes or [])]
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._data_shapes,
            self._label_shapes, self._param_names, for_training,
            inputs_need_grad, grad_req, self._fixed_param_names,
            compute_dtype=self._compute_dtype,
            shared_group=(shared_module._exec_group
                          if shared_module is not None else None),
            workload=self._work_load_list)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            # the arrays are shared already; the owner's host copies may
            # be older than them, so they are not copied in
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self._shared_owner = (shared_module._shared_owner
                                  or shared_module)
            self.params_initialized = True
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    # -- params ------------------------------------------------------------
    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """Fill the host copies (on the CPU) from ``arg_params`` /
        ``aux_params`` or the initializer, then copy them to the bound
        arrays."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        ex = self._exec_group.executor
        if self._arg_params is None:
            self._arg_params = {n: nd.zeros(ex.arg_dict[n].shape, ctx=cpu())
                                for n in self._param_names}
        if self._aux_params is None:
            self._aux_params = {n: nd.zeros(ex.aux_dict[n].shape, ctx=cpu())
                                for n in self._aux_names}
        for name, arr in self._arg_params.items():
            if arg_params is not None and name in arg_params:
                arr[:] = arg_params[name]
            elif arg_params is not None and not allow_missing:
                raise MXNetError("missing arg_param '%s' (pass "
                                 "allow_missing=True to initialize it)"
                                 % name)
            elif initializer is not None:
                initializer(name, arr)
        for name, arr in self._aux_params.items():
            if aux_params is not None and name in aux_params:
                arr[:] = aux_params[name]
            elif initializer is not None:
                initializer(name, arr)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def get_params(self):
        """The host copies, refreshed from the bound arrays."""
        self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False
        return self._arg_params, self._aux_params

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Create the optimizer (``rescale_grad`` defaults to one over the
        global batch size: this process's batch times the workers under a
        ``dist`` store) and its updater, one a replica, and ``init`` every
        parameter in the kvstore: ``local``, ``device`` / ``tpu_sync`` or
        ``device_sync`` (the executor group exchanges the gradients; the
        store is not pushed to in training), or a ``dist`` store. Under a
        ``dist`` store of several workers the update runs on the store
        (``_update_on_kvstore``: ``update`` pushes the gradients and pulls
        the weights), as in the JAX package; a one-worker ``dist_sync``
        keeps it here, so the fused step stays open to it. The store's
        init broadcasts rank 0's values into the store and leaves this
        module's weights as they are (no pull), as the JAX package's
        does."""
        if not self.binded or not self.params_initialized:
            raise MXNetError("bind and init_params before init_optimizer")
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(kvstore, str):
            kvstore = kvs.create(kvstore) if kvstore else None
        self._kvstore = kvstore
        dist_store = bool(kvstore) and "dist" in kvstore.type
        batch_size = self._exec_group.batch_size
        if dist_store:
            batch_size *= kvstore.num_workers
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", 1.0 / batch_size)
            optimizer = opt.create(
                optimizer, sym=self._symbol,
                param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        self._optimizer = optimizer
        self._updaters = [opt.get_updater(optimizer)
                          for _ in self._exec_group.execs]
        self._updater = self._updaters[0]
        self._update_on_kvstore = (dist_store
                                   and not kvstore.fused_step_compatible)
        if kvstore:
            # a dist_sync store updating on the store keeps its copy where
            # the weights are bound (the first replica's device)
            on_device = (self._update_on_kvstore
                         and isinstance(kvstore, kvs.KVStoreDist))
            src = (self._exec_group.execs[0].arg_dict if on_device
                   else self._arg_params)
            kvstore.init(list(range(len(self._param_names))),
                         [src[name] for name in self._param_names])
            if self._update_on_kvstore:
                kvstore.set_optimizer(self._optimizer)
        self.optimizer_initialized = True

    # -- compute -----------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if not self.binded or not self.params_initialized:
            raise MXNetError("module not initialized")
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._exec_group.backward(out_grads)

    def update(self):
        """Apply the optimizer to the gradients, every parameter in one
        multi-tensor update. Outside a ``dist`` store of several workers
        the store needs no push/pull: the gradients are already the
        reduced ones (the one device's, or, over several contexts, every
        replica's copy of the global batch's after the group's exchange).
        Over several contexts the host half of the step (the update
        counts, the schedule) runs once and the same update is applied on
        every replica; an optimizer without a fusable update updates the
        first replica and its weights are copied to the others.

        Under a ``dist`` store of several workers (``_update_on_kvstore``)
        every gradient is pushed in one call and every weight pulled into
        each replica. Over several contexts each card holds this process's
        summed gradient after the group's exchange, so the first card's
        copy alone is pushed: pushing every card's would count the batch
        once a card."""
        if not self.optimizer_initialized:
            raise MXNetError("init_optimizer before update")
        self._params_dirty = True
        group = self._exec_group
        if self._update_on_kvstore:
            ex = group.execs[0]
            named = [(i, name) for i, name in enumerate(self._param_names)
                     if name in ex.grad_dict]
            keys = [i for i, _ in named]
            self._kvstore.push(keys, [ex.grad_dict[n] for _, n in named])
            self._kvstore.pull(keys, out=[[e.arg_dict[n] for e in group.execs]
                                          for _, n in named])
            return
        items = [[(i, ex.grad_dict[name], ex.arg_dict[name])
                  for i, name in enumerate(self._param_names)
                  if name in ex.grad_dict] for ex in group.execs]
        if len(items) == 1:
            self._updater.update_multi(items[0])
            return
        optimizer = self._optimizer
        if optimizer._fusable() and _env.get("MXNET_TPU_FUSED_UPDATE"):
            optimizer.run_plan_replicas(
                [[(i, w, g, u._state(i, w)) for i, g, w in its]
                 for u, its in zip(self._updaters, items)], group.replicas)
            return
        self._updater.update_multi(items[0])
        for its in items[1:]:
            for (_, _, w), (_, _, w0) in zip(its, items[0]):
                w[:] = w0

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def _bound_states(self):
        """Create the optimizer state of every bound parameter with a
        gradient that has none yet, on every replica (a restore writes
        into them)."""
        for updater, ex in zip(self._updaters, self._exec_group.execs):
            for i, name in enumerate(self._param_names):
                if name in ex.grad_dict:
                    updater._state(i, ex.arg_dict[name])

    # -- checkpoints -------------------------------------------------------
    def save_checkpoint(self, prefix: str, epoch: int,
                        save_optimizer_states: bool = False):
        """``prefix-symbol.json``, ``prefix-NNNN.params`` and, with
        ``save_optimizer_states``, ``prefix-NNNN.states`` (the updater's
        states as a pickle of numpy), each through a temporary file and a
        rename; either package reads them."""
        from ..checkpoint import atomic_write_bytes

        if save_optimizer_states and self._update_on_kvstore:
            raise MXNetError(
                "save_checkpoint: under a dist kvstore of several workers "
                "the optimizer states live on the store, which this file "
                "does not hold yet (ROADMAP.md Queue A item 10b)")
        self._symbol.save("%s-symbol.json" % prefix)
        self.save_params("%s-%04d.params" % (prefix, epoch))
        if save_optimizer_states:
            atomic_write_bytes(
                "%s-%04d.states" % (prefix, epoch),
                self._updater.get_states() if self._updater else b"")

    def load_optimizer_states(self, fname: str):
        """The states of a ``.states`` file into this module's updater,
        in place (after ``init_optimizer``); a torn or foreign file raises
        naming it."""
        if self._updater is None:
            raise MXNetError("init_optimizer before load_optimizer_states")
        with open(fname, "rb") as f:
            blob = f.read()
        try:
            for updater in self._updaters:
                updater.set_states(blob)
            self._bound_states()
        except Exception as e:
            raise MXNetError("invalid optimizer-states file %s: %s "
                             "(partial/torn write?)" % (fname, e)) from e

    @staticmethod
    def load(prefix: str, epoch: int, load_optimizer_states: bool = False,
             **kwargs) -> "Module":
        """A Module over ``prefix-symbol.json`` with the params of
        ``prefix-NNNN.params``, which ``bind`` copies onto its context;
        ``kwargs`` go to the constructor. As in the JAX package,
        ``load_optimizer_states`` is accepted and not acted on: call
        :meth:`load_optimizer_states` with the ``.states`` file after
        ``init_optimizer``."""
        from ..model import load_checkpoint

        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        mod = Module(symbol=symbol, **kwargs)
        mod._arg_params = arg_params
        mod._aux_params = aux_params
        mod.params_initialized = True
        return mod

    def install_monitor(self, mon):
        """Install ``mon`` on the bound executor (its callback sees every
        op output of the classic loop's forward)."""
        if not self.binded:
            raise MXNetError("bind before install_monitor")
        self._exec_group.install_monitor(mon)

    def _fused_train_step(self, eval_metric, monitor=None):
        """The fused train step over this module's bind
        (:func:`~mxnet_tpu_torch.fused_step.make_fused_step`), kept as
        ``_fused_step``; raises naming the reason where the
        configuration cannot fuse."""
        from ..fused_step import make_fused_step

        self._fused_step = make_fused_step(self, eval_metric, monitor)
        return self._fused_step

    def get_outputs(self, merge_multi_context=True):
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._exec_group.get_input_grads(merge_multi_context)
