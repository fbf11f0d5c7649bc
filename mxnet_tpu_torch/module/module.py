"""Module: the standard unit over one symbol, counterpart of
``mxnet_tpu/module/module.py`` (single device): bind, params, the
optimizer, and the forward/backward/update steps that ``fit`` runs."""
from __future__ import annotations

import logging
from typing import Dict, Optional

from ..base import MXNetError
from ..context import Context, cpu, current_context
from ..initializer import Uniform
from ..io import DataDesc
from .. import kvstore as kvs
from .. import ndarray as nd
from .. import optimizer as opt
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    """``context`` defaults to the current context, ``gpu(0)`` unless a
    ``with mx.cpu():`` scope is open; a CUDA context without a card
    raises :class:`~mxnet_tpu_torch.base.DeviceUnavailableError` here."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, fixed_param_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = current_context()
        if isinstance(context, Context):
            context = [context]
        for ctx in context:
            ctx.torch_device()
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
            shared_group=(shared_module._exec_group
                          if shared_module is not None else None))
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
        batch size) and its updater, and ``init`` every parameter in the
        kvstore."""
        if not self.binded or not self.params_initialized:
            raise MXNetError("bind and init_params before init_optimizer")
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(kvstore, str):
            kvstore = kvs.create(kvstore) if kvstore else None
        self._kvstore = kvstore
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault(
                "rescale_grad", 1.0 / self._exec_group.batch_size)
            optimizer = opt.create(
                optimizer, sym=self._symbol,
                param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        if kvstore:
            for i, name in enumerate(self._param_names):
                kvstore.init(i, self._arg_params[name])
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
        multi-tensor update (the local store needs no push/pull: the one
        device's gradients are already the reduced ones)."""
        if not self.optimizer_initialized:
            raise MXNetError("init_optimizer before update")
        self._params_dirty = True
        ex = self._exec_group.executor
        self._updater.update_multi(
            [(i, ex.grad_dict[name], ex.arg_dict[name])
             for i, name in enumerate(self._param_names)
             if name in ex.grad_dict])

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def _bound_states(self):
        """Create the optimizer state of every bound parameter with a
        gradient that has none yet (a restore writes into them)."""
        ex = self._exec_group.executor
        for i, name in enumerate(self._param_names):
            if name in ex.grad_dict:
                self._updater._state(i, ex.arg_dict[name])

    # -- checkpoints -------------------------------------------------------
    def save_checkpoint(self, prefix: str, epoch: int,
                        save_optimizer_states: bool = False):
        """``prefix-symbol.json``, ``prefix-NNNN.params`` and, with
        ``save_optimizer_states``, ``prefix-NNNN.states`` (the updater's
        states as a pickle of numpy), each through a temporary file and a
        rename; either package reads them."""
        from ..checkpoint import atomic_write_bytes

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
            self._updater.set_states(blob)
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
        return self._exec_group.get_outputs()

    def get_input_grads(self, merge_multi_context=True):
        return self._exec_group.get_input_grads()
