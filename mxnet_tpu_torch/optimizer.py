"""Optimizers, counterpart of ``mxnet_tpu/optimizer.py``.

The reference's imperative ``update(index, weight, grad, state)``
interface, per-parameter lr/wd multipliers (symbol attrs
``__lr_mult__``/``__wd_mult__``), ``rescale_grad`` and gradient
clipping, over the bound arrays, for every optimizer the JAX package
registers: ``sgd``, ``ccsgd``, ``nag``, ``sgld``, ``adam``, ``adagrad``,
``rmsprop``, ``adadelta`` and ``test``. Each kind's math is the JAX
package's ``_update_math`` (``optimizer.py:85-161``), each product
rounded on its own as there, e.g. SGD's::

    g = clip(rescale_grad * grad) + wd * w
    m = momentum * m - lr * g
    w = w + m

Weights and states are updated in place (the JAX package donates their
buffers instead).

An optimizer whose ``_plan`` describes its update (``_fusable()``) runs
it in two halves. On the host, :meth:`Optimizer.plan` bumps the update
counts and makes one float32 row ``(rescale_grad, <the kind's scalars>,
clip)`` for each group of parameters whose rows are equal at every step
(same lr and wd multipliers; for Adam also the same update count), the
rows of the JAX step's traced hyperparameter matrices
(``mxnet_tpu/fused_step.py:304-331``). They reach the device as one
fixed tensor (:meth:`Optimizer.scalars`, written through
:class:`~mxnet_tpu_torch.ndarray.HostToDevice`), and
:meth:`Optimizer.apply` updates every group with a handful of in-place
``torch._foreach_*`` launches that read every per-step scalar from that
tensor and none from Python. So a CUDA graph of the update
(``fused_step.FusedTrainStep``) replays under any schedule and any
update count, and the classic ``update_multi`` runs the same kernels
(the two agree bit for bit). An optimizer without a fusable plan (SGLD,
Test, a subclass that overrides ``update`` or ``update_multi``) updates
one parameter at a time through its ``update``.

Optimizer states are None, an NDArray or a tuple of NDArrays (Adam's
mean and variance, RMSProp's three); ``Updater.get_states`` pickles them
as numpy in the JAX package's form, and either package reads the
other's.
"""
from __future__ import annotations

import math
import pickle
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from . import env as _env
from .base import MXNetError, Registry
from .lr_scheduler import LRScheduler
from .ndarray import HostToDevice, NDArray, _host_tensor, _to_numpy

__all__ = ["Optimizer", "SGD", "ccSGD", "NAG", "SGLD", "Adam", "AdaGrad",
           "RMSProp", "AdaDelta", "Test", "register", "create",
           "get_updater", "Updater"]

_REG: Registry = Registry.get_registry("optimizer")


def register(name_or_cls=None, override: bool = False):
    """Register an optimizer: ``@register`` on a class (its name,
    lowercased; replaces an earlier one) or ``@register("name")``."""
    if isinstance(name_or_cls, type):
        return _REG.register(override=True)(name_or_cls)
    return _REG.register(name_or_cls, override=override)


def _zeros_like_state(weight: NDArray) -> NDArray:
    return NDArray(torch.zeros_like(weight.handle), weight.context)


def _state_tensors(state) -> tuple:
    """The tensors of a state: None -> (), an NDArray -> (its tensor,),
    a tuple -> its tensors."""
    if state is None:
        return ()
    if isinstance(state, NDArray):
        return (state.handle,)
    return tuple(s.handle for s in state)


class Optimizer:
    """Base optimizer: update counts, the learning-rate schedule, the
    per-parameter multipliers, and the plan's host and device halves."""

    #: the JAX package's name of the update math ``_plan`` returns
    kind: Optional[str] = None

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
        self.sym = sym
        self.lr_mult: Dict[str, float] = {}
        self.wd_mult: Dict[str, float] = {}
        self._scalars: Dict[tuple, HostToDevice] = {}
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

    # -- the reference's interface ------------------------------------------
    def update(self, index: int, weight: NDArray, grad: NDArray, state):
        """Run this optimizer's plan on one parameter. An optimizer
        without a plan overrides this."""
        self._run_plan([(index, weight, grad, state)])

    def _plan(self, index, weight, grad, state):
        """One parameter's step: bump its update count and return
        ``(kind, states, scalars)``, the scalars at the schedule's
        current learning rate (the JAX package's ``_plan``)."""
        raise NotImplementedError

    def _fusable(self) -> bool:
        """True when the plan describes the update in effect: a subclass
        that overrides ``update`` or ``update_multi`` below the class that
        defines ``_plan`` has its own math, which the plan does not
        capture, and takes the sequential path (the JAX package checks
        ``update``; the port checks ``update_multi`` too, since its fused
        step runs the plan in place of either)."""
        mro = type(self).__mro__
        plan_cls = next((c for c in mro if "_plan" in vars(c)), None)
        if plan_cls is None or plan_cls is Optimizer:
            return False
        for method in ("update", "update_multi"):
            owner = next(c for c in mro if method in vars(c))
            if mro.index(owner) < mro.index(plan_cls):
                return False
        return True

    def update_multi(self, items):
        """Update many parameters at once; ``items`` are ``(index, weight,
        grad, state)``. One multi-tensor update a group of parameters
        where the plan describes the update and ``MXNET_TPU_FUSED_UPDATE``
        is on; otherwise :meth:`update` for each, in order."""
        if not self._fusable() or not _env.get("MXNET_TPU_FUSED_UPDATE"):
            for index, weight, grad, state in items:
                self.update(index, weight, grad, state)
            return
        self._run_plan(items)

    def _run_plan(self, items):
        if not items:
            return
        structure = self.structure([i for i, _, _, _ in items])
        rows = self.plan(items, structure)
        ws = [w.handle for _, w, _, _ in items]
        hyper = self.scalars(ws[0].device, rows.shape).copy(rows)
        self.apply(structure, hyper, ws, [g.handle for _, _, g, _ in items],
                   [_state_tensors(s) for _, _, _, s in items])

    # -- the host half --------------------------------------------------------
    def _row_key(self, index) -> tuple:
        """What makes two parameters' rows differ at some step: their lr
        and wd multipliers."""
        name = self.idx2name.get(index, str(index))
        return (self.lr_mult.get(name, 1.0), self.wd_mult.get(name, 1.0))

    def _n_states(self) -> int:
        """The number of state tensors a parameter keeps."""
        return 0

    def _eps(self) -> Optional[float]:
        """The kind's epsilon, a constructor constant added to a tensor
        list, or None."""
        return None

    def structure(self, indices: Sequence[int]) -> tuple:
        """What the update's kernels depend on besides the tensors'
        values: the groups (positions in ``indices`` whose rows are equal
        at every step), whether gradients are clipped, the number of
        state tensors a parameter and, for a kind with one, the epsilon
        as a float32 value. A captured update is valid while this stays
        the same. (The epsilon is added as a Python number because
        ``torch._foreach_add`` of a device scalar synchronises with the
        host, which a CUDA graph capture refuses; as a constant of the
        structure it is never frozen stale: a new value captures again.)"""
        groups: Dict[tuple, list] = {}
        for pos, index in enumerate(indices):
            groups.setdefault(self._row_key(index), []).append(pos)
        eps = self._eps()
        return (tuple(tuple(g) for g in groups.values()),
                self.clip_gradient is not None, self._n_states()) \
            + (() if eps is None else (float(np.float32(eps)),))

    def plan(self, items, structure: tuple) -> np.ndarray:
        """The host half of one step over ``items`` (``(index, weight,
        grad, state)``): each index's ``_plan``, then one float32 row
        ``(rescale_grad, <scalars>, clip)`` a group of ``structure``
        (the scalars computed in Python floats, rounded once when
        packed, as the JAX package packs them)."""
        full = []
        for index, weight, grad, state in items:
            kind, _, scalars = self._plan(index, weight, grad, state)
            if kind != self.kind:
                raise MXNetError("%s: _plan gave kind %r, the class %r"
                                 % (type(self).__name__, kind, self.kind))
            full.append((self.rescale_grad,) + tuple(scalars)
                        + (self.clip_gradient or 0.0,))
        return np.asarray([full[g[0]] for g in structure[0]],
                          dtype=np.float32)

    def scalars(self, device: torch.device, shape: tuple) -> HostToDevice:
        """The fixed float32 hyperparameter tensor of ``shape`` (groups,
        row width) on ``device``, with its host-to-device copier."""
        key = (str(device), tuple(shape))
        if key not in self._scalars:
            self._scalars[key] = HostToDevice(torch.zeros(
                tuple(shape), dtype=torch.float32, device=device))
        return self._scalars[key]

    # -- the device half --------------------------------------------------------
    @classmethod
    def apply(cls, structure: tuple, hyper: torch.Tensor, ws, gs,
              ss) -> None:
        """Update ``ws`` and the state tensors ``ss`` (a tuple a
        parameter) from ``gs``, in place, reading every hyperparameter
        from ``hyper``, with no host sync. ``gs`` are left as they
        are."""
        groups, clipped, n_states = structure[:3]
        eps = structure[3] if len(structure) > 3 else None
        math_fn = _MATH[cls.kind]
        for gi, group in enumerate(groups):
            row = hyper[gi].unbind()
            w = [ws[p] for p in group]
            g = torch._foreach_mul([gs[p] for p in group], row[0])
            if clipped:
                clip = row[-1]
                torch._foreach_clamp_min_(g, [-clip] * len(g))
                torch._foreach_clamp_max_(g, [clip] * len(g))
            states = [[ss[p][k] for p in group] for k in range(n_states)]
            math_fn(w, g, states, row[1:-1], eps)

    # -- per-parameter scalars ----------------------------------------------
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
        """The host scalars :meth:`plan` reads: update counts and the
        learning-rate schedule's state. A snapshot must carry them, or a
        resume replays the schedule (and Adam's bias correction) from
        step 0."""
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


# ---------------------------------------------------------------------------
# the update math of each kind, over lists of tensors. ``w`` and the
# state lists are written in place; ``g`` is the step's own copy of the
# rescaled (and clipped) gradients and may be written; ``s`` holds the
# kind's scalars as 0-d tensors of the hyperparameter row, and ``eps``
# the kind's epsilon (the structure's constant; the row's copy is
# unused).
# ---------------------------------------------------------------------------

def _add_wd(w, g, wd):
    torch._foreach_add_(g, torch._foreach_mul(w, wd))


def _sgd(w, g, states, s, eps=None, nag=False):
    lr, wd, mom = s
    _add_wd(w, g, wd)
    if not states:
        torch._foreach_mul_(g, lr)
        torch._foreach_sub_(w, g)
        return
    (m,) = states
    if nag:
        # m = mom * m + g; w = w - lr * (g + mom * m)
        torch._foreach_mul_(m, mom)
        torch._foreach_add_(m, g)
        step = torch._foreach_mul(m, mom)
        torch._foreach_add_(step, g)
        torch._foreach_mul_(step, lr)
        torch._foreach_sub_(w, step)
        return
    # m = mom * m - lr * g; w = w + m
    torch._foreach_mul_(g, lr)
    torch._foreach_mul_(m, mom)
    torch._foreach_sub_(m, g)
    torch._foreach_add_(w, m)


def _adam(w, g, states, s, eps):
    step_lr, wd, b1, b2, _ = s
    mean, var = states
    _add_wd(w, g, wd)
    # mean = b1 * mean + (1 - b1) * g
    torch._foreach_mul_(mean, b1)
    torch._foreach_add_(mean, torch._foreach_mul(g, 1 - b1))
    # var = b2 * var + (1 - b2) * g * g
    torch._foreach_mul_(var, b2)
    sq = torch._foreach_mul(g, 1 - b2)
    torch._foreach_mul_(sq, g)
    torch._foreach_add_(var, sq)
    # w = w - step_lr * mean / (sqrt(var) + eps)
    den = torch._foreach_sqrt(var)
    torch._foreach_add_(den, eps)
    step = torch._foreach_mul(mean, step_lr)
    torch._foreach_div_(step, den)
    torch._foreach_sub_(w, step)


def _adagrad(w, g, states, s, eps):
    lr, wd, _ = s
    (acc,) = states
    # acc = acc + g * g; w = w - lr * (g / sqrt(acc + eps) + wd * w)
    torch._foreach_add_(acc, torch._foreach_mul(g, g))
    den = torch._foreach_add(acc, eps)
    torch._foreach_sqrt_(den)
    torch._foreach_div_(g, den)
    _add_wd(w, g, wd)
    torch._foreach_mul_(g, lr)
    torch._foreach_sub_(w, g)


def _rmsprop(w, g, states, s, eps=None):
    lr, wd, g1, g2 = s
    n, gs, delta = states
    _add_wd(w, g, wd)
    # n = (1 - g1) * g * g + g1 * n
    sq = torch._foreach_mul(g, 1 - g1)
    torch._foreach_mul_(sq, g)
    torch._foreach_mul_(n, g1)
    torch._foreach_add_(n, sq)
    # gs = (1 - g1) * g + g1 * gs
    torch._foreach_mul_(gs, g1)
    torch._foreach_add_(gs, torch._foreach_mul(g, 1 - g1))
    # delta = g2 * delta - lr * g / sqrt(n - gs * gs + 1e-4); w = w + delta
    den = torch._foreach_mul(gs, gs)
    torch._foreach_neg_(den)
    torch._foreach_add_(den, n)
    torch._foreach_add_(den, 1e-4)
    torch._foreach_sqrt_(den)
    torch._foreach_mul_(g, lr)
    torch._foreach_div_(g, den)
    torch._foreach_mul_(delta, g2)
    torch._foreach_sub_(delta, g)
    torch._foreach_add_(w, delta)


def _adadelta(w, g, states, s, eps):
    wd, rho, _ = s
    acc_g, acc_d = states
    # acc_g = rho * acc_g + (1 - rho) * g * g
    sq = torch._foreach_mul(g, 1 - rho)
    torch._foreach_mul_(sq, g)
    torch._foreach_mul_(acc_g, rho)
    torch._foreach_add_(acc_g, sq)
    # cur = sqrt(acc_d + eps) / sqrt(acc_g + eps) * g
    cur = torch._foreach_add(acc_d, eps)
    torch._foreach_sqrt_(cur)
    den = torch._foreach_add(acc_g, eps)
    torch._foreach_sqrt_(den)
    torch._foreach_div_(cur, den)
    torch._foreach_mul_(cur, g)
    # acc_d = rho * acc_d + (1 - rho) * cur * cur
    sq = torch._foreach_mul(cur, 1 - rho)
    torch._foreach_mul_(sq, cur)
    torch._foreach_mul_(acc_d, rho)
    torch._foreach_add_(acc_d, sq)
    # w = w - cur - wd * w
    wdw = torch._foreach_mul(w, wd)
    torch._foreach_sub_(w, cur)
    torch._foreach_sub_(w, wdw)


_MATH = {"sgd": _sgd, "nag": lambda *a: _sgd(*a, nag=True), "adam": _adam,
         "adagrad": _adagrad, "rmsprop": _rmsprop, "adadelta": _adadelta}


@register("sgd")
class SGD(Optimizer):
    """SGD with momentum (the state is the momentum, zeros like the
    weight; none when ``momentum`` is 0)."""

    kind = "sgd"

    def __init__(self, momentum: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like_state(weight)

    def _n_states(self):
        return int(self.momentum != 0.0)

    def _plan(self, index, weight, grad, state):
        self._update_count(index)
        return (self.kind, () if state is None else (state,),
                (self._get_lr(index), self._get_wd(index), self.momentum))


@register("ccsgd")
class ccSGD(SGD):
    """SGD under the reference's C++-side name."""


@register("nag")
class NAG(SGD):
    """Nesterov accelerated gradient: ``m = momentum * m + g``, ``w = w -
    lr * (g + momentum * m)``; plain SGD's step when ``momentum`` is 0."""

    kind = "nag"


@register("sgld")
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: ``w = w - lr / 2 * g +
    sqrt(lr) * noise``, the noise one standard normal draw a parameter a
    step from :mod:`mxnet_tpu_torch.random`. It has no plan (its noise
    is a fresh draw), so it updates one parameter at a time and the
    fused step refuses it."""

    def update(self, index, weight, grad, state):
        from . import random as _random

        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight.handle
        noise = _random.normal(0.0, 1.0, shape=weight.shape,
                               ctx=weight.context, dtype=w.dtype).handle
        with torch.no_grad():
            g = grad.handle * self.rescale_grad
            if self.clip_gradient is not None:
                g.clamp_(-self.clip_gradient, self.clip_gradient)
            g += wd * w
            w.sub_(lr / 2 * g)
            w.add_(math.sqrt(lr) * noise)


@register("adam")
class Adam(Optimizer):
    """Adam, bias-corrected through the step's learning rate ``lr *
    sqrt(1 - beta2^t) / (1 - beta1^t)``, ``t`` the parameter's update
    count; ``epsilon`` is added after the square root."""

    kind = "adam"

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like_state(weight), _zeros_like_state(weight))

    def _row_key(self, index):
        # the step's learning rate depends on the update count, so rows
        # are equal only between parameters whose counts are; all of a
        # group's counts move together, so the grouping stays put
        return super()._row_key(index) + (
            self._index_update_count.get(index, self.begin_num_update),)

    def _n_states(self):
        return 2

    def _eps(self):
        return self.epsilon

    def _plan(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        step_lr = lr * math.sqrt(1.0 - self.beta2 ** t) \
            / (1.0 - self.beta1 ** t)
        return (self.kind, tuple(state),
                (step_lr, self._get_wd(index), self.beta1, self.beta2,
                 self.epsilon))


@register("adagrad")
class AdaGrad(Optimizer):
    """AdaGrad; weight decay is added after the normalised gradient."""

    kind = "adagrad"

    def __init__(self, eps: float = 1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like_state(weight)

    def _n_states(self):
        return 1

    def _eps(self):
        return self.float_stable_eps

    def _plan(self, index, weight, grad, state):
        self._update_count(index)
        return (self.kind, (state,),
                (self._get_lr(index), self._get_wd(index),
                 self.float_stable_eps))


@register("rmsprop")
class RMSProp(Optimizer):
    """RMSProp in the reference's form (Graves): running E[g^2], E[g]
    and a momentum ``delta``, with 1e-4 under the square root."""

    kind = "rmsprop"

    def __init__(self, learning_rate: float = 0.002, gamma1: float = 0.95,
                 gamma2: float = 0.9, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2

    def create_state(self, index, weight):
        return (_zeros_like_state(weight),   # n
                _zeros_like_state(weight),   # g
                _zeros_like_state(weight))   # delta

    def _n_states(self):
        return 3

    def _plan(self, index, weight, grad, state):
        self._update_count(index)
        return (self.kind, tuple(state),
                (self._get_lr(index), self._get_wd(index), self.gamma1,
                 self.gamma2))


@register("adadelta")
class AdaDelta(Optimizer):
    """AdaDelta; it has no learning rate: ``w = w - cur - wd * w``."""

    kind = "adadelta"

    def __init__(self, rho: float = 0.90, epsilon: float = 1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like_state(weight), _zeros_like_state(weight))

    def _n_states(self):
        return 2

    def _eps(self):
        return self.epsilon

    def _plan(self, index, weight, grad, state):
        self._update_count(index)
        return (self.kind, tuple(state),
                (self._get_wd(index), self.rho, self.epsilon))


@register("test")
class Test(Optimizer):
    """The reference's test optimizer, in NDArray arithmetic."""

    def create_state(self, index, weight):
        return _zeros_like_state(weight)

    def update(self, index, weight, grad, state):
        weight += grad * self.rescale_grad
        state[:] = weight


def create(name: str, **kwargs) -> Optimizer:
    return Optimizer.create_optimizer(name, **kwargs)


def _states_to_numpy(obj):
    """States (NDArrays, tuples and lists of them, dicts by index) ->
    the same form over numpy copies, for a pickle either package reads;
    a fetch from the card waits for the work queued on the current
    stream."""
    if isinstance(obj, NDArray):
        return _to_numpy(obj.handle.detach().to("cpu", copy=True))
    if isinstance(obj, tuple):
        return tuple(_states_to_numpy(o) for o in obj)
    if isinstance(obj, list):
        return [_states_to_numpy(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _states_to_numpy(v) for k, v in obj.items()}
    return obj


def _form(state) -> str:
    if state is None:
        return "none"
    if isinstance(state, (tuple, list)):
        return "a tuple of %d" % len(state)
    return "an array"


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
        """Raise unless ``saved`` (numpy, or a tuple of it) fits
        ``state`` (None, an NDArray or a tuple of them) in form and
        shape."""
        if isinstance(saved, list):
            saved = tuple(saved)
        if _form(state) != _form(saved):
            raise MXNetError(
                "optimizer state of '%s': the saved state is %s, this "
                "optimizer keeps %s" % (self._name(index), _form(saved),
                                        _form(state)))
        if isinstance(state, tuple):
            for s, v in zip(state, saved):
                self._check_state(index, s, v)
        elif state is not None and tuple(np.shape(saved)) != state.shape:
            raise MXNetError(
                "optimizer state of '%s': saved shape %s, bound shape %s"
                % (self._name(index), tuple(np.shape(saved)), state.shape))

    @classmethod
    def _write_state(cls, state, saved) -> None:
        if isinstance(state, tuple):
            for s, v in zip(state, saved):
                cls._write_state(s, v)
        elif state is not None:
            with torch.no_grad():
                state.handle.copy_(_host_tensor(np.asarray(saved)))

    @classmethod
    def _zero_state(cls, state) -> None:
        for t in _state_tensors(state):
            t.zero_()

    def get_states(self) -> bytes:
        """The states as a pickle of numpy arrays (tuples of them for a
        kind with several) by param index (the JAX package reads it, and
        writes the same form)."""
        return pickle.dumps(_states_to_numpy(self.states))

    def set_states(self, states_bytes: bytes) -> None:
        """Restore :meth:`get_states`' form: every saved state is checked
        against the state that exists first, then copied into it in
        place; a state not created yet takes its saved value when it is.
        An existing state the saved ones lack is reset to a fresh
        state's value (zeros)."""
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
            else:
                self._zero_state(state)
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
