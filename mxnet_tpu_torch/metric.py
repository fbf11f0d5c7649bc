"""Evaluation metrics, counterpart of ``mxnet_tpu/metric.py`` (the
metrics the training loop uses).

Accumulation stays on the device: ``update`` adds the batch's sum to a
tensor beside the predictions and counts instances on the host, so a
training step does not wait for the device; ``get`` reads the sum back.
Labels may be NDArrays, tensors or host arrays.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .base import MXNetError, Registry
from .ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "CrossEntropy",
           "CompositeEvalMetric", "create"]

_REG: Registry = Registry.get_registry("metric")


def _tensor(a, device=None) -> torch.Tensor:
    if isinstance(a, NDArray):
        a = a.handle
    elif not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.detach() if device is None else a.detach().to(device)


def check_label_shapes(labels, preds):
    if len(labels) != len(preds):
        raise MXNetError("labels/preds count mismatch: %d vs %d"
                         % (len(labels), len(preds)))


class EvalMetric:
    """Base: a running ``sum_metric`` (a device tensor once a batch has
    been seen) over ``num_inst`` instances."""

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def _batch(self, label: torch.Tensor, pred: torch.Tensor):
        """``(sum, count)`` of one (label, pred) pair; ``sum`` a 0-d
        tensor on pred's device."""
        raise NotImplementedError

    def update(self, labels: Sequence, preds: Sequence[NDArray]):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            p = _tensor(pred)
            s, n = self._batch(_tensor(label, p.device), p)
            self.sum_metric = self.sum_metric + s.double()
            self.num_inst += n

    def get(self):
        s = float(self.sum_metric)
        return self.name, s / self.num_inst if self.num_inst else float("nan")

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            return [(name, value)]
        return list(zip(name, value))


@_REG.register("acc")
@_REG.register("accuracy")
class Accuracy(EvalMetric):
    def __init__(self):
        super().__init__("accuracy")

    def _batch(self, label, pred):
        lab = label.to(torch.int64).reshape(-1)
        pl = torch.argmax(pred, dim=1) if pred.dim() > 1 else pred
        return (pl.to(torch.int64).reshape(-1) == lab).sum(), lab.numel()


@_REG.register("top_k_accuracy")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k: int = 1):
        self.top_k = top_k
        super().__init__("top_k_accuracy_%d" % top_k)
        if top_k <= 1:
            raise MXNetError("top_k should be >1; use Accuracy otherwise")

    def _batch(self, label, pred):
        lab = label.to(torch.int64).reshape(-1)
        top = torch.topk(pred.float(), self.top_k, dim=1).indices
        return (top == lab[:, None]).any(dim=1).sum(), lab.numel()


@_REG.register("ce")
@_REG.register("cross-entropy")
class CrossEntropy(EvalMetric):
    def __init__(self, eps: float = 1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def _batch(self, label, pred):
        lab = label.to(torch.int64).reshape(-1)
        prob = pred.gather(1, lab[:, None])[:, 0]
        return (-torch.log(prob + self.eps)).sum(), lab.numel()


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics: Optional[List[EvalMetric]] = None):
        self.metrics = list(metrics or [])
        super().__init__("composite")

    def add(self, metric: EvalMetric):
        self.metrics.append(metric)

    def get_metric(self, index: int) -> EvalMetric:
        return self.metrics[index]

    def reset(self):
        for m in self.metrics:
            m.reset()

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


def create(metric: Union[str, EvalMetric, list], **kwargs) -> EvalMetric:
    """A metric from its registered name (``"acc"``, ``"ce"``,
    ``"top_k_accuracy"``), a list of them, or a metric itself."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        return CompositeEvalMetric([create(m, **kwargs) for m in metric])
    return _REG.get(metric)(**kwargs)
