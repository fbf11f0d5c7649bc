"""Data descriptors and the in-memory iterator, counterpart of the part
of ``mxnet_tpu/io.py`` that Module's inference path reads. Batches stay
host numpy arrays; the executor group copies them onto the device."""
from __future__ import annotations

from collections import namedtuple
from typing import List, Optional

import numpy as np

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "NDArrayIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name+shape descriptor; ``layout`` declares the batch axis."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout: Optional[str]) -> int:
        return 0 if layout is None else layout.find("N")


class DataBatch:
    def __init__(self, data, label=None, pad=0):
        self.data = data
        self.label = label or []
        self.pad = pad


def _init_data(data, allow_empty, default_name):
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and not data:
            raise MXNetError("empty data")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"%s_%d" % (default_name, i): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise MXNetError("data must be NDArray, numpy array, list or dict")
    return [(k, v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
            for k, v in data.items()]


class NDArrayIter:
    """Iterate over in-memory arrays in batches; the last partial batch
    wraps around and reports the wrapped rows in ``pad``."""

    def __init__(self, data, label=None, batch_size=1,
                 data_name="data", label_name="softmax_label"):
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        self.batch_size = batch_size
        self.cursor = -batch_size
        if self.num_data < batch_size:
            raise MXNetError("batch_size larger than dataset")

    @property
    def provide_data(self) -> List[DataDesc]:
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self) -> List[DataDesc]:
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        self.cursor = -self.batch_size

    def __iter__(self):
        return self

    def __next__(self) -> DataBatch:
        self.cursor += self.batch_size
        if self.cursor >= self.num_data:
            raise StopIteration
        pad = max(0, self.cursor + self.batch_size - self.num_data)
        return DataBatch(self._slice(self.data), self._slice(self.label),
                         pad=pad)

    def _slice(self, source):
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            return [v[self.cursor:end] for _, v in source]
        pad = end - self.num_data
        return [np.concatenate([v[self.cursor:], v[:pad]], axis=0)
                for _, v in source]
