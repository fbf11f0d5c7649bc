"""Data iterators, counterpart of ``mxnet_tpu/io.py``: the ``DataIter``
protocol (``reset``/``next``/``iter_next``/``getdata``/``getlabel``/
``getindex``/``getpad``), batching with pad semantics, the in-memory,
MNIST idx and CSV iterators, the image-record iterator with its
decoder, the resizing and prefetching wrappers, and ``MXDataIter`` over
the ``data_iter`` registry.

Batches are port NDArrays on the CPU (the reference's are NDArrays on
its default device); the executor group copies them onto the card.
Image records decode on the host with PIL, on a thread pool or, with
``preprocess_mode="process"`` (``MXNET_TPU_DECODE_PROCS``), in worker
processes through :mod:`~mxnet_tpu_torch.io_pipeline`'s shared-memory
ring; both give the same batches bit for bit.
"""
from __future__ import annotations

import gzip
import logging
import os
import queue
import struct
import threading
import time
from collections import namedtuple
from typing import List, Optional, Tuple

import numpy as np

from . import env as _env
from . import telemetry as _tel
from .base import MXNetError, Registry
from .context import cpu
from .ndarray import NDArray, _host_tensor, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "MNISTIter",
           "CSVIter", "ResizeIter", "PrefetchingIter", "RecordDecoder",
           "ImageRecordIter", "MXDataIter"]

_REG: Registry = Registry.get_registry("data_iter")


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


@_REG.register("NDArrayIter")
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


@_REG.register("MNISTIter")
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


@_REG.register("CSVIter")
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


class ResizeIter(DataIter):
    """``data_iter`` cut or stretched to ``size`` batches an epoch: past
    the inner iterator's end it resets the inner one and goes on;
    ``reset`` resets the inner one too unless ``reset_internal`` is
    False."""

    def __init__(self, data_iter: DataIter, size: int,
                 reset_internal: bool = True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch: Optional[DataBatch] = None
        self.batch_size = data_iter.batch_size

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Batches of ``iters`` (one iterator or several, whose batches are
    joined: data after data, label after label) made ahead by a producer
    thread into a queue of ``prefetch_depth``. ``rename_data`` /
    ``rename_label`` (one dict an iterator) rename the descriptors.
    :meth:`close` (or leaving the ``with`` block) stops and joins the
    thread, so an exception mid-epoch leaves no live thread;
    :meth:`reset` closes, resets the inner iterators and starts again.
    With telemetry on, each wait for a batch lands in the
    ``io.prefetch_stall_ms`` histogram."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth: int = 2):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0].shape[0]
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.current_batch: Optional[DataBatch] = None
        self._start()

    @staticmethod
    def _descs(renames, lists):
        if renames is None:
            return [d for descs in lists for d in descs]
        return [DataDesc(r.get(d.name, d.name), d.shape, d.dtype)
                for r, descs in zip(renames, lists) for d in descs]

    @property
    def provide_data(self):
        return self._descs(self.rename_data,
                           [it.provide_data for it in self.iters])

    @property
    def provide_label(self):
        return self._descs(self.rename_label,
                           [it.provide_label for it in self.iters])

    def _start(self):
        stop, out = self._stop, self._queue

        def run():
            while not stop.is_set():
                try:
                    batches = [it.next() for it in self.iters]
                except StopIteration:
                    out.put(None)
                    return
                merged = DataBatch([d for b in batches for d in b.data],
                                   [lb for b in batches for lb in b.label],
                                   batches[0].pad, batches[0].index)
                while not stop.is_set():
                    try:
                        out.put(merged, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="PrefetchingIter")
        self._thread.start()

    def _drain(self):
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def close(self):
        """Stop and join the producer thread and empty the queue; safe to
        call again. After it the iterator is exhausted until
        :meth:`reset`."""
        th, self._thread = self._thread, None
        if th is None:
            return
        self._stop.set()
        # a producer blocked on the full queue polls the stop flag every
        # 100 ms; draining lets it leave at once
        self._drain()
        th.join(timeout=5.0)
        if th.is_alive():
            logging.warning("PrefetchingIter.close: the producer thread did "
                            "not exit within 5 s; leaving the daemon thread")
        self._drain()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def reset(self):
        self.close()
        for it in self.iters:
            it.reset()
        self._stop = threading.Event()
        self._start()

    def iter_next(self):
        if self._thread is None:
            return False
        if _tel.enabled():
            t0 = time.perf_counter()
            batch = self._queue.get()
            _tel.observe("io.prefetch_stall_ms",
                         (time.perf_counter() - t0) * 1e3)
        else:
            batch = self._queue.get()
        if batch is None:
            return False
        self.current_batch = batch
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad

    def getindex(self):
        return self.current_batch.index


class RecordDecoder:
    """Decode and augment one image record on the host (PIL): resize of
    the short side, rotation and shear with a ``fill_value`` border,
    padding, random or center crop, random mirror, HSL jitter (OpenCV
    units: H in [0, 180], S and L in [0, 255]); mean and scale are
    applied to the stacked batch (:meth:`normalize_inplace`). Every draw
    comes from an RNG keyed by ``(seed, epoch, record index)``
    (:meth:`derive_rng`), so 1 and N decode threads give bit-equal
    batches, equal to the JAX package's ``RecordDecoder``'s."""

    def __init__(self, data_shape, seed: int = 0, rand_crop: bool = False,
                 rand_mirror: bool = False, resize: int = -1,
                 scale: float = 1.0, max_rotate_angle: int = 0,
                 rotate: float = -1.0, rotate_list=(),
                 max_shear_ratio: float = 0.0, pad: int = 0,
                 fill_value: int = 255, random_h: int = 0, random_s: int = 0,
                 random_l: int = 0, mean=None, label_width: int = 1):
        self.data_shape = tuple(data_shape)
        self.seed = int(seed)
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.resize = resize
        self.scale = scale
        self.max_rotate_angle = max_rotate_angle
        self.rotate = rotate
        self.rotate_list = list(rotate_list)
        self.max_shear_ratio = max_shear_ratio
        self.pad = pad
        self.fill_value = fill_value
        self.random_h = random_h
        self.random_s = random_s
        self.random_l = random_l
        self.mean = None if mean is None else np.asarray(mean,
                                                         dtype=np.float32)
        self.label_width = label_width

    def config(self) -> dict:
        """Picklable keyword arguments that rebuild this decoder, bit for
        bit, in another process."""
        return {"data_shape": self.data_shape, "seed": self.seed,
                "rand_crop": self.rand_crop, "rand_mirror": self.rand_mirror,
                "resize": self.resize, "scale": self.scale,
                "max_rotate_angle": self.max_rotate_angle,
                "rotate": self.rotate, "rotate_list": self.rotate_list,
                "max_shear_ratio": self.max_shear_ratio, "pad": self.pad,
                "fill_value": self.fill_value, "random_h": self.random_h,
                "random_s": self.random_s, "random_l": self.random_l,
                "mean": self.mean, "label_width": self.label_width}

    def derive_rng(self, epoch: int, idx: int) -> np.random.RandomState:
        """The augmentation RNG of record ``idx`` in ``epoch``."""
        mixed = (self.seed * 0x9E3779B1 + epoch * 1000003
                 + idx * 2654435761) & 0xFFFFFFFF
        return np.random.RandomState(mixed)

    def _affine_augment(self, img: np.ndarray,
                        rng: np.random.RandomState) -> np.ndarray:
        """Rotation and shear about the image center: forward matrix
        [[a - s*b, b + s*a], [-b, a]], bilinear, ``fill_value`` border;
        PIL takes the inverse (output to input) map."""
        angle = 0.0
        if self.max_rotate_angle > 0:
            angle = float(rng.randint(-self.max_rotate_angle,
                                      self.max_rotate_angle + 1))
        if self.rotate > 0:
            angle = float(self.rotate)
        if self.rotate_list:
            angle = float(self.rotate_list[
                rng.randint(len(self.rotate_list))])
        shear = 0.0
        if self.max_shear_ratio > 0:
            shear = (rng.rand() * 2 - 1) * self.max_shear_ratio
        if angle == 0.0 and shear == 0.0:
            return img
        import math

        from PIL import Image

        h, w = img.shape[:2]
        th = math.radians(angle)
        a, b = math.cos(th), math.sin(th)
        fwd = np.array([[a - shear * b, b + shear * a], [-b, a]])
        inv = np.linalg.inv(fwd)
        # PIL's AFFINE works in the corner frame (pixel index + 0.5), where
        # the image center is exactly (w/2, h/2)
        cx, cy = w / 2.0, h / 2.0
        coeffs = (inv[0, 0], inv[0, 1], cx - inv[0, 0] * cx - inv[0, 1] * cy,
                  inv[1, 0], inv[1, 1], cy - inv[1, 0] * cx - inv[1, 1] * cy)
        color = img.shape[2] == 3
        pim = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8).squeeze())
        fill = (self.fill_value,) * 3 if color else self.fill_value
        pim = pim.transform((w, h), Image.AFFINE, coeffs,
                            resample=Image.BILINEAR, fillcolor=fill)
        out = np.asarray(pim).astype(np.float32)
        return out if out.ndim == 3 else out[:, :, None]

    def _hsl_augment(self, img: np.ndarray,
                     rng: np.random.RandomState) -> np.ndarray:
        """HSL jitter: uniform offsets in [-random_h, random_h] (and S,
        L), H clamped to [0, 180] and S, L to [0, 255]."""
        if not (self.random_h or self.random_s or self.random_l) \
                or img.shape[2] != 3:
            return img
        dh = (rng.rand() * 2 - 1) * self.random_h
        ds = (rng.rand() * 2 - 1) * self.random_s
        dl = (rng.rand() * 2 - 1) * self.random_l
        eps = 1e-12
        rgb = np.clip(img, 0, 255) / 255.0
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        maxc = np.maximum(np.maximum(r, g), b)
        minc = np.minimum(np.minimum(r, g), b)
        light = (maxc + minc) / 2.0
        delta = maxc - minc
        sat = np.where(delta < eps, 0.0,
                       np.where(light <= 0.5, delta / (maxc + minc + eps),
                                delta / (2.0 - maxc - minc + eps)))
        rc = (maxc - r) / (delta + eps)
        gc = (maxc - g) / (delta + eps)
        bc = (maxc - b) / (delta + eps)
        hue = np.where(maxc == r, bc - gc,
                       np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
        hue = np.where(delta < eps, 0.0, (hue / 6.0) % 1.0)
        hue = np.clip(hue * 180.0 + dh, 0.0, 180.0) / 180.0
        light = np.clip(light * 255.0 + dl, 0.0, 255.0) / 255.0
        sat = np.clip(sat * 255.0 + ds, 0.0, 255.0) / 255.0
        m2 = np.where(light <= 0.5, light * (1.0 + sat),
                      light + sat - light * sat)
        m1 = 2.0 * light - m2

        def channel(h12):
            h12 = h12 % 1.0
            return np.where(
                h12 < 1 / 6, m1 + (m2 - m1) * h12 * 6.0,
                np.where(h12 < 0.5, m2,
                         np.where(h12 < 2 / 3,
                                  m1 + (m2 - m1) * (2 / 3 - h12) * 6.0, m1)))

        out = np.stack([channel(hue + 1 / 3), channel(hue),
                        channel(hue - 1 / 3)], axis=-1)
        return (out * 255.0).astype(np.float32)

    @staticmethod
    def _resized(img: np.ndarray, w: int, h: int) -> np.ndarray:
        from PIL import Image

        out = np.asarray(Image.fromarray(img.astype(np.uint8)).resize(
            (w, h))).astype(np.float32)
        return out if out.ndim == 3 else out[:, :, None]

    def decode(self, rec: bytes,
               rng: np.random.RandomState) -> Tuple[np.ndarray, np.ndarray]:
        """One record -> (CHW float32 image in pixel units, label)."""
        from . import recordio as rio

        _tel.inc("io.decoded_records")
        header, img = rio.unpack_img(
            rec, iscolor=1 if self.data_shape[0] == 3 else 0)
        label = np.asarray(header.label, dtype=np.float32)
        img = img.astype(np.float32)
        if img.ndim == 2:
            img = img[:, :, None]
        _, h, w = self.data_shape
        if self.resize > 0:
            ratio = self.resize / min(img.shape[0], img.shape[1])
            img = self._resized(img, int(round(img.shape[1] * ratio)),
                                int(round(img.shape[0] * ratio)))
        img = self._affine_augment(img, rng)
        if self.pad > 0:
            img = np.pad(img, ((self.pad, self.pad), (self.pad, self.pad),
                               (0, 0)), constant_values=float(self.fill_value))
        ih, iw = img.shape[0], img.shape[1]
        if ih < h or iw < w:
            img = self._resized(img, w, h)
            ih, iw = h, w
        if self.rand_crop:
            top = rng.randint(0, ih - h + 1)
            left = rng.randint(0, iw - w + 1)
        else:
            top, left = (ih - h) // 2, (iw - w) // 2
        img = img[top:top + h, left:left + w]
        if self.rand_mirror and rng.rand() < 0.5:
            img = img[:, ::-1]
        img = self._hsl_augment(img, rng)
        return img.transpose(2, 0, 1), label

    def normalize_inplace(self, imgs: np.ndarray) -> np.ndarray:
        """Subtract the mean and scale a stacked float32 batch in place."""
        if self.mean is not None:
            imgs -= self.mean
        if self.scale != 1.0:
            imgs *= self.scale
        return imgs


@_REG.register("ImageRecordIter")
class ImageRecordIter(DataIter):
    """Batches of images from a ``.rec`` file, decoded and augmented by
    :class:`RecordDecoder` on ``preprocess_threads`` threads, with
    ``prefetch_buffer`` batches read ahead. ``num_parts``/``part_index``
    keep every ``num_parts``-th record from ``part_index``; ``shuffle``
    permutes them once from ``seed``; the last batch wraps around to the
    first records and ``getpad`` counts the wrapped ones. ``mean_img``
    names a mean-image file: loaded if it exists, else computed once
    over every record (unaugmented) and written atomically in the
    NDArray container, which both packages read; otherwise
    ``mean_r``/``mean_g``/``mean_b``. With telemetry on, records decoded
    count in ``io.decoded_records`` and repeated reads of one batch in
    ``io.decode_cache_hit``.

    ``preprocess_mode="process"`` (or ``MXNET_TPU_DECODE_PROCS`` > 0,
    which also sets the worker count; else ``preprocess_threads``
    workers) decodes in worker processes into a shared-memory ring
    (:class:`~mxnet_tpu_torch.io_pipeline.ProcessDecodePipeline`), with
    the same batches. A pipeline that fails to start, a dead worker or a
    wedged ring moves the iterator to in-process decode for good
    (``io.pipeline.fallbacks``, ``io.pipeline.worker_crashes``), as the
    JAX package does; :meth:`close` stops the workers."""

    def __init__(self, path_imgrec: str, data_shape, batch_size: int,
                 path_imgidx: Optional[str] = None, label_width: int = 1,
                 shuffle: bool = False, num_parts: int = 1,
                 part_index: int = 0, mean_img: Optional[str] = None,
                 mean_r: float = 0.0, mean_g: float = 0.0,
                 mean_b: float = 0.0, scale: float = 1.0,
                 rand_crop: bool = False, rand_mirror: bool = False,
                 resize: int = -1, round_batch: bool = True, seed: int = 0,
                 preprocess_threads: int = 4, prefetch_buffer: int = 2,
                 preprocess_mode: Optional[str] = None,
                 max_rotate_angle: int = 0, rotate: float = -1.0,
                 rotate_list=(), max_shear_ratio: float = 0.0,
                 pad: int = 0, fill_value: int = 255,
                 random_h: int = 0, random_s: int = 0, random_l: int = 0,
                 **kwargs):
        super().__init__()
        from . import recordio as rio

        procs = _env.get("MXNET_TPU_DECODE_PROCS")
        if preprocess_mode is None:
            preprocess_mode = "process" if procs > 0 else "thread"
        if preprocess_mode not in ("thread", "process"):
            raise MXNetError("preprocess_mode must be 'thread' or "
                             "'process', got %r" % (preprocess_mode,))
        self.preprocess_mode = preprocess_mode
        self._num_procs = procs if procs > 0 else max(1,
                                                      int(preprocess_threads))
        self._proc_pipe = None
        self.data_shape = tuple(data_shape)
        self.batch_size = batch_size
        self.preprocess_threads = max(1, int(preprocess_threads))
        self.prefetch_buffer = max(1, int(prefetch_buffer))
        self._pool = None
        self._inflight = {}
        self._epoch = 0
        self._cache_cursor = None
        self._cache = None
        if isinstance(rotate_list, str):
            rotate_list = [v for v in rotate_list.split(",") if v.strip()]
        rotate_list = [int(v) for v in rotate_list]
        mean = None
        if mean_img is not None and os.path.isfile(mean_img):
            from . import ndarray as nd
            mean = list(nd.load(mean_img, ctx=cpu()).values())[0].asnumpy()
        elif mean_r or mean_g or mean_b:
            mean = np.array([mean_r, mean_g, mean_b],
                            dtype=np.float32).reshape(3, 1, 1)
        self._path_imgrec = path_imgrec
        self._records: List[bytes] = []
        reader = rio.MXRecordIO(path_imgrec, "r")
        i = 0
        while True:
            rec = reader.read()
            if rec is None:
                break
            if i % num_parts == part_index:
                self._records.append(rec)
            i += 1
        reader.close()
        if shuffle:
            np.random.RandomState(seed).shuffle(self._records)
        self.label_width = label_width
        self.cursor = -batch_size
        self.num_data = len(self._records)
        if self.num_data == 0:
            raise MXNetError("no records found in %s" % path_imgrec)
        self._decoder = RecordDecoder(
            data_shape=self.data_shape, seed=seed, rand_crop=rand_crop,
            rand_mirror=rand_mirror, resize=resize, scale=scale,
            max_rotate_angle=max_rotate_angle, rotate=rotate,
            rotate_list=rotate_list, max_shear_ratio=max_shear_ratio,
            pad=pad, fill_value=fill_value, random_h=random_h,
            random_s=random_s, random_l=random_l, label_width=label_width)
        if mean_img is not None and mean is None:
            mean = self._compute_mean(mean_img)
        self._decoder.mean = mean

    def _compute_mean(self, path: str) -> np.ndarray:
        """The mean image over every record of the file (not only this
        part's), unaugmented and unscaled, summed in float64 in record
        order; written to ``path`` through a temporary file and a
        rename, so a killed run leaves no torn file."""
        from concurrent.futures import ThreadPoolExecutor

        from . import ndarray as nd
        from . import recordio as rio

        dec = RecordDecoder(data_shape=self.data_shape,
                            resize=self._decoder.resize,
                            pad=self._decoder.pad,
                            fill_value=self._decoder.fill_value)
        workers = self.preprocess_threads
        pool = ThreadPoolExecutor(max_workers=workers,
                                  thread_name_prefix="meandec") \
            if workers > 1 else None
        acc = np.zeros(self.data_shape, dtype=np.float64)
        count = 0

        def decode_one(rec):
            return dec.decode(rec, np.random.RandomState(0))[0]

        reader = rio.MXRecordIO(self._path_imgrec, "r")
        try:
            chunk: List[bytes] = []

            def flush():
                nonlocal acc, count
                imgs = pool.map(decode_one, chunk) if pool is not None \
                    else map(decode_one, chunk)
                for img in imgs:
                    acc += img
                    count += 1
                chunk.clear()

            while True:
                rec = reader.read()
                if rec is None:
                    break
                chunk.append(rec)
                if len(chunk) >= max(64, 8 * workers):
                    flush()
            if chunk:
                flush()
        finally:
            reader.close()
            if pool is not None:
                pool.shutdown()
        logging.info("computed mean image from %d records -> %s",
                     count, path)
        mean = (acc / max(count, 1)).astype(np.float32)
        tmp = "%s.tmp.%d" % (path, os.getpid())
        nd.save(tmp, {"mean_img": nd.array(mean, ctx=cpu())})
        os.replace(tmp, path)
        return mean

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shape)]

    def reset(self):
        """Back to the first batch of the next epoch, whose augmentation
        draws differ (they are keyed by the epoch); read-ahead of the
        old epoch is cancelled."""
        self.cursor = -self.batch_size
        self._epoch += 1
        for futs in self._inflight.values():
            for f in futs:
                f.cancel()
        self._inflight.clear()
        if self._proc_pipe is not None:
            # parked ring results belong to the finished epoch
            self._proc_pipe.flush()
        self._cache_cursor = None

    def close(self):
        """Stop the decode workers (and free their shared memory) and shut
        the decode pool down; the next batch starts what it needs."""
        pipe, self._proc_pipe = self._proc_pipe, None
        if pipe is not None:
            pipe.shutdown()
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
        self._inflight.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _ensure_pool(self):
        if self._pool is None and self.preprocess_threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=self.preprocess_threads,
                thread_name_prefix="imgdec")
        return self._pool

    def _decode_at(self, epoch: int, idx: int):
        return self._decoder.decode(self._records[idx % self.num_data],
                                    self._decoder.derive_rng(epoch, idx))

    def _submit(self, cursor: int):
        pool = self._pool
        if pool is None or cursor in self._inflight:
            return
        ep = self._epoch
        self._inflight[cursor] = [
            pool.submit(self._decode_at, ep, i)
            for i in range(cursor, cursor + self.batch_size)]

    def _gather(self, cursor: int):
        futs = self._inflight.pop(cursor, None)
        if futs is not None:
            return [f.result() for f in futs]
        pool = self._ensure_pool()
        idxs = range(cursor, cursor + self.batch_size)
        ep = self._epoch
        if pool is not None:
            return list(pool.map(lambda i: self._decode_at(ep, i), idxs))
        return [self._decode_at(ep, i) for i in idxs]

    # -- process decode (io_pipeline) --------------------------------------
    def _ensure_pipe(self):
        """The worker pipeline, started at first use in process mode; a
        start that fails moves the iterator to in-process decode."""
        if self.preprocess_mode != "process":
            return None
        if self._proc_pipe is None:
            from . import io_pipeline

            try:
                self._proc_pipe = io_pipeline.ProcessDecodePipeline(
                    self._records, self._decoder.config(), self.batch_size,
                    label_width=self.label_width,
                    num_workers=self._num_procs)
            except Exception as e:
                self._disable_process_mode("pipeline startup failed: %s" % e)
                return None
        return self._proc_pipe

    def _disable_process_mode(self, reason: str):
        """Drop the worker pipeline and decode in process from here on."""
        logging.warning(
            "ImageRecordIter: multi-process decode disabled (%s); "
            "falling back to in-process decode", reason)
        _tel.inc("io.pipeline.fallbacks")
        pipe, self._proc_pipe = self._proc_pipe, None
        self.preprocess_mode = "thread"
        if pipe is not None:
            pipe.shutdown()

    def _decode_batch(self):
        if self._cache_cursor == self.cursor:
            _tel.inc("io.decode_cache_hit")
            return self._cache
        pipe = self._ensure_pipe()
        if pipe is not None:
            from .io_pipeline import PipelineError

            try:
                imgs, labels = pipe.get_batch(self.cursor, self._epoch,
                                              limit=self.num_data)
            except PipelineError as e:
                # a dead worker or a wedged ring: decode in process
                _tel.inc("io.pipeline.worker_crashes")
                self._disable_process_mode(str(e))
            else:
                labels = np.ascontiguousarray(
                    labels[:, 0] if self.label_width == 1 else labels)
                self._cache = (imgs, labels)
                self._cache_cursor = self.cursor
                return self._cache
        results = self._gather(self.cursor)
        if self._pool is not None:
            # keep the pool decoding the next batches while this one is
            # consumed
            for k in range(1, self.prefetch_buffer + 1):
                nxt = self.cursor + k * self.batch_size
                if nxt < self.num_data:
                    self._submit(nxt)
        imgs = np.stack([r[0] for r in results])
        labels = [r[1] if self.label_width > 1 else float(r[1].ravel()[0])
                  for r in results]
        self._decoder.normalize_inplace(imgs)
        self._cache = (imgs, np.asarray(labels, dtype=np.float32))
        self._cache_cursor = self.cursor
        return self._cache

    def getdata(self):
        return [_batch_array(self._decode_batch()[0])]

    def getlabel(self):
        return [_batch_array(self._decode_batch()[1])]

    def getpad(self):
        if self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


def MXDataIter(name: str, **kwargs) -> DataIter:
    """An iterator of the ``data_iter`` registry by name (NDArrayIter,
    MNISTIter, CSVIter, ImageRecordIter), built from ``kwargs``."""
    return _REG.get(name)(**kwargs)
