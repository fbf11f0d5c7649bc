"""Data iterators, counterpart of ``mxnet_tpu/io.py``: the ``DataIter``
protocol (``reset``/``next``/``iter_next``/``getdata``/``getlabel``/
``getindex``/``getpad``), batching with pad semantics, and the
in-memory, MNIST idx and CSV iterators.

Batches are port NDArrays on the CPU (the reference's are NDArrays on
its default device); the executor group copies them onto the card.
"""
from __future__ import annotations

import gzip
import struct
from collections import namedtuple
from typing import List, Optional

import numpy as np

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, _host_tensor, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "MNISTIter",
           "CSVIter"]


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
    """One batch: ``data`` and ``label`` lists, ``pad`` (rows at the end
    that are filler), ``index`` (the rows' indices, where the iterator
    knows them), and the optional ``bucket_key``/``provide_data``/
    ``provide_label`` of bucketing iterators."""

    def __init__(self, data, label=None, pad=0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label or []
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """The iterator protocol: ``iter_next`` advances, ``getdata``/
    ``getlabel``/``getindex``/``getpad`` read the current batch, ``next``
    packs them into a :class:`DataBatch` or raises ``StopIteration``."""

    def __init__(self):
        self.batch_size = 0

    def reset(self):
        pass

    def __iter__(self):
        return self

    def __next__(self) -> DataBatch:
        return self.next()

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             self.getpad(), self.getindex())
        raise StopIteration

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0

    @property
    def provide_data(self) -> List[DataDesc]:
        raise NotImplementedError

    @property
    def provide_label(self) -> List[DataDesc]:
        raise NotImplementedError


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


def _batch_array(rows: np.ndarray) -> NDArray:
    """A CPU NDArray of a batch's rows: a view of ``rows`` where
    :func:`~mxnet_tpu_torch.ndarray.array` would not change its dtype
    (the executor group copies it onto the card once), else
    ``array``'s float32 copy."""
    if rows.dtype in (np.float64, np.int64):
        return array(rows, ctx=cpu())
    return NDArray(_host_tensor(rows), cpu())


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays in batches of CPU NDArrays.
    ``shuffle`` permutes the rows once, with ``np.random`` (seed it for a
    fixed order). ``last_batch_handle="pad"`` wraps the last partial
    batch around and reports the wrapped rows in ``getpad``;
    ``"discard"`` drops it."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__()
        if last_batch_handle not in ("pad", "discard"):
            raise MXNetError("last_batch_handle must be pad or discard, got "
                             "%r" % (last_batch_handle,))
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle
        if shuffle:
            idx = np.random.permutation(self.num_data)
            self.data = [(k, v[idx]) for k, v in self.data]
            self.label = [(k, v[idx]) for k, v in self.label]
        if last_batch_handle == "discard":
            self.num_data -= self.num_data % batch_size
        if self.num_data < batch_size:
            raise MXNetError("batch_size larger than dataset")
        self.cursor = -batch_size

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

    def get_checkpoint_state(self) -> dict:
        """What identifies this stream in a snapshot."""
        return {"kind": type(self).__name__, "batch_size": self.batch_size,
                "num_data": self.num_data}

    def set_checkpoint_state(self, state: dict) -> None:
        """Seek to ``state["batches"]`` batches already consumed this
        epoch (0: as after ``reset``): a count of the batches the
        training loop saw, not a copy of the cursor."""
        self.cursor = (int(state.get("batches", 0)) - 1) * self.batch_size

    def iter_next(self) -> bool:
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, source):
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            return [_batch_array(v[self.cursor:end]) for _, v in source]
        # the last partial batch wraps around to the first rows
        pad = end - self.num_data
        return [_batch_array(np.concatenate([v[self.cursor:self.num_data],
                                             v[:pad]], axis=0))
                for _, v in source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" \
                and self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


def _read_idx_file(path: str) -> np.ndarray:
    """An idx-format (MNIST) file as a numpy array; ``.gz`` is read
    through gzip."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise MXNetError("invalid idx file %s" % path)
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtype = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                 0x0C: np.int32, 0x0D: np.float32,
                 0x0E: np.float64}.get(dtype_code)
        if dtype is None:
            raise MXNetError("invalid idx file %s: unknown type code 0x%02x"
                             % (path, dtype_code))
        data = np.frombuffer(f.read(),
                             dtype=np.dtype(dtype).newbyteorder(">"))
        return data.reshape(shape).astype(dtype)


class _Wrapped(DataIter):
    """A DataIter that hands every call to an inner NDArrayIter."""

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def get_checkpoint_state(self) -> dict:
        return dict(self._inner.get_checkpoint_state(),
                    kind=type(self).__name__)

    def set_checkpoint_state(self, state: dict) -> None:
        self._inner.set_checkpoint_state(state)

    def iter_next(self):
        return self._inner.iter_next()

    def getdata(self):
        return self._inner.getdata()

    def getlabel(self):
        return self._inner.getlabel()

    def getpad(self):
        return self._inner.getpad()


class MNISTIter(_Wrapped):
    """MNIST idx files (``image``, ``label``; gzip or plain) in batches:
    pixels scaled to [0, 1], ``(N, 1, 28, 28)`` or ``flat`` ``(N, 784)``
    or ``input_shape``; rows ``part_index::num_parts`` for one worker of
    ``num_parts``; shuffled once from ``seed``; the last partial batch
    dropped."""

    def __init__(self, image: str, label: str, batch_size: int = 128,
                 shuffle: bool = True, flat: bool = False, seed: int = 0,
                 silent: bool = False, num_parts: int = 1,
                 part_index: int = 0, input_shape=None, **kwargs):
        super().__init__()
        images = _read_idx_file(image).astype(np.float32) / 255.0
        labels = _read_idx_file(label).astype(np.float32)
        if flat:
            images = images.reshape(images.shape[0], -1)
        else:
            images = images.reshape(images.shape[0], 1, images.shape[1],
                                    images.shape[2])
            if input_shape is not None:
                images = images.reshape((images.shape[0],)
                                        + tuple(input_shape))
        if num_parts > 1:
            images = images[part_index::num_parts]
            labels = labels[part_index::num_parts]
        if shuffle:
            idx = np.random.RandomState(seed).permutation(images.shape[0])
            images, labels = images[idx], labels[idx]
        self._inner = NDArrayIter(images, labels, batch_size=batch_size,
                                  last_batch_handle="discard")
        self.batch_size = batch_size


class CSVIter(_Wrapped):
    """Rows of ``data_csv`` reshaped to ``data_shape`` (labels from
    ``label_csv`` reshaped to ``label_shape``, zeros without one), in
    batches; the last partial batch wraps around with ``pad``."""

    def __init__(self, data_csv: str, data_shape,
                 label_csv: Optional[str] = None, label_shape=(1,),
                 batch_size: int = 1, **kwargs):
        super().__init__()
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32,
                          ndmin=2).reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2).reshape((-1,) + tuple(label_shape))
            if label.shape[1:] == (1,):
                label = label[:, 0]
        else:
            label = np.zeros(data.shape[0], dtype=np.float32)
        self._inner = NDArrayIter(data, label, batch_size=batch_size,
                                  last_batch_handle="pad")
        self.batch_size = batch_size
