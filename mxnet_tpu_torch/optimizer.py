"""Optimizers, counterpart of the SGD half of ``mxnet_tpu/optimizer.py``.

The reference's imperative ``update(index, weight, grad, state)``
interface, per-parameter lr/wd multipliers (symbol attrs
``__lr_mult__``/``__wd_mult__``), ``rescale_grad`` and gradient
clipping, over the bound arrays. SGD's form is the JAX package's
(``optimizer.py:101-112``), not ``torch.optim.SGD``'s::

    g = clip(rescale_grad * grad) + wd * w
    m = momentum * m - lr * g
    w = w + m

Each product is rounded on its own, as the JAX package's elementwise
math is. Weights and momenta are updated in place (the JAX package
donates their buffers instead); ``update_multi`` updates every
parameter with a handful of ``torch._foreach_*`` launches per step
instead of a few kernels per parameter.

The hyperparameters reach that math as a float32 tensor on the weights'
device, one row ``(rescale_grad, lr, wd, momentum, clip)`` for each
group of parameters that share their lr and wd multipliers (written
through :class:`~mxnet_tpu_torch.ndarray.HostToDevice`), as the JAX step
carries its traced hyperparameter matrices
(``mxnet_tpu/fused_step.py:300-331``). The
update counts and the learning-rate schedule stay on the host
(:meth:`SGD.plan`); only the tensor's values change from step to step,
so a CUDA graph of the update (``fused_step.FusedTrainStep``) replays
under any schedule, and the classic ``update_multi`` runs the same
kernels.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .base import MXNetError, Registry
from .lr_scheduler import LRScheduler
from .ndarray import HostToDevice, NDArray, _host_tensor, _to_numpy

__all__ = ["Optimizer", "SGD", "create", "get_updater", "Updater"]

_REG: Registry = Registry.get_registry("optimizer")


class Optimizer:
    """Base optimizer: update counts, the learning-rate schedule and the
    per-parameter multipliers."""

    def __init__(self, rescale_grad: float = 1.0, param_idx2name=None,
                 wd: float = 0.0, clip_gradient: Optional[float] = None,
                 learning_rate: float = 0.01,
                 lr_scheduler: Optional[LRScheduler] = None,
                 sym=None, begin_num_update: int = 0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.idx2name = dict(param_idx2name or {})
        self.lr_mult: Dict[str, float] = {}
        self.wd_mult: Dict[str, float] = {}
        if sym is not None:
            attrs = sym.attr_dict()
            for name in sym.list_arguments():
                a = attrs.get(name, {})
                if "__lr_mult__" in a:
                    self.lr_mult[name] = float(a["__lr_mult__"])
                if "__wd_mult__" in a:
                    self.wd_mult[name] = float(a["__wd_mult__"])

    @staticmethod
    def create_optimizer(name: str, **kwargs) -> "Optimizer":
        return _REG.get(name)(**kwargs)

    def create_state(self, index: int, weight: NDArray):
        return None

    def update(self, index: int, weight: NDArray, grad: NDArray, state):
        self.update_multi([(index, weight, grad, state)])

    def update_multi(self, items):
        """Update many params at once; ``items`` are ``(index, weight,
        grad, state)``."""
        raise NotImplementedError

    def set_lr_mult(self, args_lr_mult: Dict[str, float]):
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: Dict[str, float]):
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index: int):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index: int) -> float:
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        return lr * self.lr_mult.get(self.idx2name.get(index, str(index)),
                                     1.0)

    def _get_wd(self, index: int) -> float:
        return self.wd * self.wd_mult.get(self.idx2name.get(index,
                                                            str(index)), 1.0)

    def get_checkpoint_state(self) -> dict:
        """The host scalars :meth:`SGD.plan` reads: update counts and the
        learning-rate schedule's state. A snapshot must carry them, or a
        resume replays the schedule from step 0."""
        st = {"num_update": self.num_update,
              "begin_num_update": self.begin_num_update,
              "index_update_count": dict(self._index_update_count)}
        if self.lr_scheduler is not None:
            st["lr_scheduler"] = {
                k: v for k, v in vars(self.lr_scheduler).items()
                if isinstance(v, (int, float, bool))}
        return st

    def set_checkpoint_state(self, st: dict) -> None:
        """Restore a state :meth:`get_checkpoint_state` captured."""
        self.num_update = int(st["num_update"])
        self.begin_num_update = int(st["begin_num_update"])
        self._index_update_count = {int(k): int(v) for k, v in
                                    st["index_update_count"].items()}
        for k, v in st.get("lr_scheduler", {}).items():
            if self.lr_scheduler is not None:
                setattr(self.lr_scheduler, k, v)


@_REG.register("sgd")
class SGD(Optimizer):
    """SGD with momentum (the state is the momentum, zeros like the
    weight; none when ``momentum`` is 0)."""

    def __init__(self, momentum: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self._scalars: Dict[tuple, HostToDevice] = {}

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return NDArray(torch.zeros_like(weight.handle), weight.context)

    def _mults(self, index):
        name = self.idx2name.get(index, str(index))
        return (self.lr_mult.get(name, 1.0), self.wd_mult.get(name, 1.0))

    def structure(self, indices: Sequence[int]) -> tuple:
        """What the update's kernels depend on besides the tensors'
        values: the groups (positions in ``indices`` sharing lr and wd
        multipliers), whether gradients are clipped, whether there is a
        momentum. A captured update is valid while this stays the same."""
        groups: Dict[tuple, List[int]] = {}
        for pos, index in enumerate(indices):
            groups.setdefault(self._mults(index), []).append(pos)
        return (tuple(tuple(g) for g in groups.values()),
                self.clip_gradient is not None, self.momentum != 0.0)

    def plan(self, indices: Sequence[int], structure: tuple) -> np.ndarray:
        """The host half of one step: bump each index's update count,
        then one row ``(rescale_grad, lr, wd, momentum, clip)`` a group of
        ``structure``, at the schedule's current learning rate."""
        for index in indices:
            self._update_count(index)
        rows = []
        for group in structure[0]:
            first = indices[group[0]]
            rows.append((self.rescale_grad, self._get_lr(first),
                         self._get_wd(first), self.momentum,
                         self.clip_gradient or 0.0))
        return np.asarray(rows, dtype=np.float32)

    def scalars(self, device: torch.device, n_groups: int) -> HostToDevice:
        """The fixed ``(n_groups, 5)`` hyperparameter tensor on
        ``device``, with its host-to-device copier."""
        key = (str(device), n_groups)
        if key not in self._scalars:
            self._scalars[key] = HostToDevice(torch.zeros(
                (n_groups, 5), dtype=torch.float32, device=device))
        return self._scalars[key]

    @staticmethod
    def apply(structure: tuple, hyper: torch.Tensor, ws, gs, ms) -> None:
        """The device half: the update of ``ws`` (and the momenta ``ms``)
        from ``gs``, in place, reading every hyperparameter from
        ``hyper``, without a host sync."""
        groups, clipped, has_momentum = structure
        for gi, group in enumerate(groups):
            w = [ws[p] for p in group]
            rescale, lr, wd, mom, clip = hyper[gi].unbind()
            g = torch._foreach_mul([gs[p] for p in group], rescale)
            if clipped:
                torch._foreach_clamp_min_(g, [-clip] * len(g))
                torch._foreach_clamp_max_(g, [clip] * len(g))
            torch._foreach_add_(g, torch._foreach_mul(w, wd))
            step = torch._foreach_mul(g, lr)
            if not has_momentum:
                torch._foreach_sub_(w, step)
                continue
            m = [ms[p] for p in group]
            torch._foreach_mul_(m, mom)
            torch._foreach_sub_(m, step)
            torch._foreach_add_(w, m)

    def update_multi(self, items):
        if not items:
            return
        indices = [index for index, _, _, _ in items]
        structure = self.structure(indices)
        ws = [w.handle for _, w, _, _ in items]
        rows = self.plan(indices, structure)
        hyper = self.scalars(ws[0].device, len(rows)).copy(rows)
        self.apply(structure, hyper, ws, [g.handle for _, _, g, _ in items],
                   [None if s is None else s.handle for _, _, _, s in items])


def create(name: str, **kwargs) -> Optimizer:
    return Optimizer.create_optimizer(name, **kwargs)


def _states_to_numpy(states: Dict[int, Any]) -> Dict[int, Any]:
    """Per-index states (NDArray or None) -> numpy copies, for a pickle
    either package reads; a fetch from the card waits for the work queued
    on the current stream."""
    return {k: None if s is None
            else _to_numpy(s.handle.detach().to("cpu", copy=True))
            for k, s in states.items()}


_MISSING = object()


class Updater:
    """An optimizer with its per-index states, created at an index's
    first update. A fused train step's CUDA graph reads the states it was
    captured with, so a restore (:meth:`set_states`) writes into the
    states that exist and never replaces one."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[int, Any] = {}
        # restored values of states not created yet, by index
        self._pending: Dict[int, Any] = {}

    def _state(self, index, weight):
        if index not in self.states:
            state = self.optimizer.create_state(index, weight)
            saved = self._pending.pop(index, _MISSING)
            if saved is not _MISSING:
                self._check_state(index, state, saved)
                self._write_state(state, saved)
            self.states[index] = state
        return self.states[index]

    def _name(self, index) -> str:
        return self.optimizer.idx2name.get(index, "index %s" % (index,))

    def _check_state(self, index, state, saved) -> None:
        """Raise unless ``saved`` (numpy) fits ``state`` (an NDArray or
        None) in form and shape."""
        if (state is None) != (saved is None):
            raise MXNetError(
                "optimizer state of '%s': the saved state is %s, this "
                "optimizer keeps %s" % (self._name(index),
                                        "none" if saved is None
                                        else "an array",
                                        "none" if state is None
                                        else "an array"))
        if state is not None and tuple(np.shape(saved)) != state.shape:
            raise MXNetError(
                "optimizer state of '%s': saved shape %s, bound shape %s"
                % (self._name(index), tuple(np.shape(saved)), state.shape))

    @staticmethod
    def _write_state(state, saved) -> None:
        if state is not None:
            with torch.no_grad():
                state.handle.copy_(_host_tensor(np.asarray(saved)))

    def get_states(self) -> bytes:
        """The states as a pickle of numpy arrays by param index (the
        JAX package reads it, and writes the same form)."""
        return pickle.dumps(_states_to_numpy(self.states))

    def set_states(self, states_bytes: bytes) -> None:
        """Restore :meth:`get_states`' form: every saved state is checked
        against the state that exists first, then copied into it in
        place; a state not created yet takes its saved value when it is.
        An existing state the saved ones lack is reset to a fresh
        state's value (zeros, SGD's momentum)."""
        states = pickle.loads(states_bytes)
        if not isinstance(states, dict):
            raise MXNetError("optimizer states are a %s, not a dict by "
                             "param index" % type(states).__name__)
        self.set_numpy_states(states)

    def set_numpy_states(self, states: Dict[int, Any]) -> None:
        """:meth:`set_states` on the unpickled dict."""
        states = {int(k): v for k, v in states.items()}
        for index, saved in states.items():
            if index in self.states:
                self._check_state(index, self.states[index], saved)
        for index, state in self.states.items():
            if index in states:
                self._write_state(state, states[index])
            elif state is not None:
                state.handle.zero_()
        self._pending = {i: v for i, v in states.items()
                         if i not in self.states}

    def __call__(self, index: int, grad: NDArray, weight: NDArray):
        self.optimizer.update(index, weight, grad, self._state(index, weight))

    def update_multi(self, items):
        """All of ``items`` (``(index, grad, weight)``, the argument order
        of ``__call__``) in one multi-tensor update."""
        self.optimizer.update_multi([(i, w, g, self._state(i, w))
                                     for i, g, w in items])


def get_updater(optimizer: Optimizer) -> Updater:
    if not isinstance(optimizer, Optimizer):
        raise MXNetError("get_updater needs an Optimizer, got %r"
                         % (optimizer,))
    return Updater(optimizer)
