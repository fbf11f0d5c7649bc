"""Evaluation metrics, counterpart of ``mxnet_tpu/metric.py``.

Accuracy, TopKAccuracy, CrossEntropy, MAE, MSE and RMSE fold on the
device
(``has_device_fold``, as ``device_fold`` in ``mxnet_tpu/metric.py:
205-216``): :meth:`EvalMetric.device_fold` adds a batch's (sum, count)
into a fixed float64 accumulator beside the predictions, in place and
without a host sync, so the fused train step can run it inside its CUDA
graph; the host reads the accumulator only in ``get()``, and ``reset()``
zeroes it in place. Labels may be NDArrays, tensors or host arrays.
MAE, MSE and RMSE reshape the prediction to the label's shape and add
one batch mean (in float32, as the JAX package's fold) a batch. F1 and
:class:`CustomMetric` (a numpy ``feval``) update on the host.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .analysis import sanitizers as _san
from .base import MXNetError, Registry
from .ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MAE", "MSE",
           "RMSE", "CrossEntropy", "CompositeEvalMetric", "CustomMetric",
           "np_metric", "create"]

_REG: Registry = Registry.get_registry("metric")


def _tensor(a, device=None) -> torch.Tensor:
    if isinstance(a, NDArray):
        a = a.handle
    elif not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.detach() if device is None else a.detach().to(device)


def _to_host(a) -> np.ndarray:
    if isinstance(a, NDArray):
        return a.asnumpy()
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def check_label_shapes(labels, preds):
    if len(labels) != len(preds):
        raise MXNetError("labels/preds count mismatch: %d vs %d"
                         % (len(labels), len(preds)))


class EvalMetric:
    """Base: a running ``sum_metric`` over ``num_inst`` instances on the
    host, plus, for a metric with a device fold, the device accumulator
    ``(sum, count)`` that :meth:`get` adds in. With ``num`` (a metric of
    several outputs) ``sum_metric`` and ``num_inst`` are lists of that
    length that a subclass's ``update`` fills, and :meth:`get` returns
    ``["<name>_0", ...]`` with one value each."""

    #: True where :meth:`_batch` is torch code that needs no host sync
    has_device_fold = False

    def __init__(self, name: str, num: Optional[int] = None):
        self.name = name
        self.num = num
        self._acc: Optional[torch.Tensor] = None
        # the other replicas' accumulators (a fused step over several
        # cards folds each card's slice on that card), by replica
        self._replica_accs: Dict[int, torch.Tensor] = {}
        self.reset()

    def reset(self):
        if self.num is None:
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num
        if self._acc is not None:
            self._acc.zero_()
        for acc in getattr(self, "_replica_accs", {}).values():
            acc.zero_()

    def _batch(self, label: torch.Tensor, pred: torch.Tensor):
        """``(sum, count)`` of one (label, pred) pair: ``sum`` a 0-d
        tensor on pred's device, ``count`` an int from the shapes."""
        raise NotImplementedError

    def accumulator(self, device: torch.device) -> torch.Tensor:
        """The float64 ``(sum, count)`` accumulator on ``device``. It
        moves only when the device does: what it held is added to the
        host totals first."""
        if self._acc is not None and self._acc.device != device:
            with _san.intentional_transfer():
                s, n = self._acc.tolist()
            self.sum_metric += s
            self.num_inst += int(n)
            self._acc = None
        if self._acc is None:
            self._acc = torch.zeros(2, dtype=torch.float64, device=device)
        return self._acc

    def replica_accumulator(self, replica: int,
                            device: torch.device) -> torch.Tensor:
        """Replica ``replica``'s (1 and up) float64 ``(sum, count)``
        accumulator on ``device``, beside the first replica's
        :meth:`accumulator`; :meth:`get` adds them all."""
        acc = self._replica_accs.get(replica)
        if acc is None or acc.device != device:
            acc = self._replica_accs[replica] = torch.zeros(
                2, dtype=torch.float64, device=device)
        return acc

    def device_fold(self, labels: Sequence[torch.Tensor],
                    preds: Sequence[torch.Tensor], replica: int = 0) -> None:
        """Add a batch into the accumulator, in place, with no host
        sync: the labels must lie on the predictions' device. A replica
        after the first (a fused step over several cards) folds into its
        own :meth:`replica_accumulator`."""
        acc = (self.accumulator(preds[0].device) if replica == 0 else
               self.replica_accumulator(replica, preds[0].device))
        for label, pred in zip(labels, preds):
            s, n = self._batch(label, pred)
            acc[0].add_(s.double())
            acc[1].add_(n)

    def update(self, labels: Sequence, preds: Sequence[NDArray]):
        check_label_shapes(labels, preds)
        ps = [_tensor(p) for p in preds]
        if not ps:
            return
        ls = [_tensor(lab, p.device) for lab, p in zip(labels, ps)]
        if self.has_device_fold:
            self.device_fold(ls, ps)
            return
        for label, pred in zip(ls, ps):
            s, n = self._batch(label, pred)
            self.sum_metric += float(s)
            self.num_inst += n

    def device_totals(self):
        """The device accumulators' ``(sum, count)`` added up on the host
        (one read each), or None where there is none."""
        accs = ([self._acc] if self._acc is not None else []) \
            + list(self._replica_accs.values())
        if not accs:
            return None
        s = n = 0.0
        with _san.intentional_transfer():
            for acc in accs:
                acc_s, acc_n = acc.tolist()
                s, n = s + acc_s, n + acc_n
        return s, n

    def _totals(self):
        s, n = self.sum_metric, self.num_inst
        dev = self.device_totals()
        if dev is not None:
            s, n = s + dev[0], n + int(dev[1])
        return s, n

    def get(self):
        if self.num is not None:
            names = ["%s_%d" % (self.name, i) for i in range(self.num)]
            values = [s / n if n else float("nan")
                      for s, n in zip(self.sum_metric, self.num_inst)]
            return names, values
        s, n = self._totals()
        return self.name, s / n if n else float("nan")

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            return [(name, value)]
        return list(zip(name, value))


@_REG.register("acc")
@_REG.register("accuracy")
class Accuracy(EvalMetric):
    has_device_fold = True

    def __init__(self):
        super().__init__("accuracy")

    def _batch(self, label, pred):
        lab = label.to(torch.int64).reshape(-1)
        pl = torch.argmax(pred, dim=1) if pred.dim() > 1 else pred
        return (pl.to(torch.int64).reshape(-1) == lab).sum(), lab.numel()


@_REG.register("top_k_accuracy")
class TopKAccuracy(EvalMetric):
    has_device_fold = True

    def __init__(self, top_k: int = 1):
        self.top_k = top_k
        super().__init__("top_k_accuracy_%d" % top_k)
        if top_k <= 1:
            raise MXNetError("top_k should be >1; use Accuracy otherwise")

    def _batch(self, label, pred):
        lab = label.to(torch.int64).reshape(-1)
        top = torch.topk(pred.float(), self.top_k, dim=1).indices
        return (top == lab[:, None]).any(dim=1).sum(), lab.numel()


@_REG.register("f1")
class F1(EvalMetric):
    """Binary F1 of the argmax prediction, one value a batch."""

    def __init__(self):
        super().__init__("f1")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            p = np.argmax(_to_host(pred), axis=1)
            lab = _to_host(label).astype(np.int32).ravel()
            if len(np.unique(lab)) > 2:
                raise MXNetError("F1 supports binary classification only")
            tp = int(((p == 1) & (lab == 1)).sum())
            fp = int(((p == 1) & (lab == 0)).sum())
            fn = int(((p == 0) & (lab == 1)).sum())
            precision = tp / (tp + fp) if tp + fp else 0.0
            recall = tp / (tp + fn) if tp + fn else 0.0
            f1 = 2 * precision * recall / (precision + recall) \
                if precision + recall else 0.0
            self.sum_metric += f1
            self.num_inst += 1


class _Regression(EvalMetric):
    """A batch's error against labels of any shape the prediction
    reshapes to; one float32 mean a batch."""

    has_device_fold = True

    def _err(self, diff: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _batch(self, label, pred):
        diff = label.float() - pred.float().reshape(label.shape)
        return self._err(diff), 1


@_REG.register("mae")
class MAE(_Regression):
    def __init__(self):
        super().__init__("mae")

    def _err(self, diff):
        return diff.abs().mean()


@_REG.register("mse")
class MSE(_Regression):
    def __init__(self):
        super().__init__("mse")

    def _err(self, diff):
        return (diff ** 2).mean()


@_REG.register("rmse")
class RMSE(_Regression):
    def __init__(self):
        super().__init__("rmse")

    def _err(self, diff):
        return torch.sqrt((diff ** 2).mean())


@_REG.register("ce")
@_REG.register("cross-entropy")
class CrossEntropy(EvalMetric):
    has_device_fold = True

    def __init__(self, eps: float = 1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def _batch(self, label, pred):
        lab = label.to(torch.int64).reshape(-1)
        prob = pred.gather(1, lab[:, None])[:, 0]
        return (-torch.log(prob + self.eps)).sum(), lab.numel()


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together; it folds on the device when
    every one of them does."""

    def __init__(self, metrics: Optional[List[EvalMetric]] = None):
        self.metrics = list(metrics or [])
        super().__init__("composite")

    @property
    def has_device_fold(self):
        return bool(self.metrics) and all(m.has_device_fold
                                          for m in self.metrics)

    def add(self, metric: EvalMetric):
        self.metrics.append(metric)

    def get_metric(self, index: int) -> EvalMetric:
        return self.metrics[index]

    def reset(self):
        for m in self.metrics:
            m.reset()

    def device_fold(self, labels, preds, replica=0):
        for m in self.metrics:
            m.device_fold(labels, preds, replica)

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.extend(n if isinstance(n, list) else [n])
            values.extend(v if isinstance(v, list) else [v])
        return names, values


class CustomMetric(EvalMetric):
    """``feval(label, pred)`` on numpy arrays, one (label, pred) pair at a
    time: a float (one instance) or ``(sum, count)``."""

    def __init__(self, feval: Callable, name: Optional[str] = None,
                 allow_extra_outputs: bool = False):
        name = name or getattr(feval, "__name__", "custom")
        super().__init__("custom(%s)" % name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            reval = self._feval(_to_host(label), _to_host(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np_metric(numpy_feval: Callable, name: Optional[str] = None,
              allow_extra_outputs: bool = False) -> CustomMetric:
    """A :class:`CustomMetric` over a numpy function."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = name or numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


def create(metric: Union[str, Callable, EvalMetric, list],
           **kwargs) -> EvalMetric:
    """A metric from its registered name (``"acc"``, ``"ce"``,
    ``"top_k_accuracy"``, ``"f1"``, ``"mae"``, ``"mse"``, ``"rmse"``), a
    callable ``feval(label, pred)`` (a :class:`CustomMetric`), a list of
    them, or a metric itself."""
    if isinstance(metric, EvalMetric):
        return metric
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, list):
        return CompositeEvalMetric([create(m, **kwargs) for m in metric])
    return _REG.get(metric)(**kwargs)
