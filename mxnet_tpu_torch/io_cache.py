"""The decoded-image cache, counterpart of ``mxnet_tpu/io_cache.py``:
decode a JPEG record file once into a uint8 store, then feed every epoch
from it.

* :func:`build_decoded_cache` — one offline pass: decode and resize every
  record (PIL), store the raw uint8 HWC frames in a memory-mapped file,
  the labels in a float32 table and a JSON header. One builder at a time
  a prefix (an ``O_EXCL`` lock naming host and pid; a waiter on the same
  host breaks the lock of a builder that died), written through
  temporary files and renames, and rebuilt when the source record file
  changes (its size and ``st_mtime_ns`` are in the header).
* :class:`CachedImageRecordIter` — the training iterator over the memory
  map: a reshuffle a epoch, random or center crops from the stored
  margin, random mirrors. Three ways to hand a batch out:

  - host crop (the default): the host slices the uint8 crops; with
    ``device_normalize`` the card casts and normalises them (the
    ``crop_norm`` kernel over uint8 crops), without it numpy does;
  - ``device_augment``: the host gathers the whole stored frames and the
    card crops, mirrors and normalises them (``crop_norm``);
  - ``device_feed`` (``MXNET_TPU_DEVICE_FEED``): the batch carries the
    raw uint8 frames and the augmentation in ``batch.aug`` (crop offsets,
    mirror flags, mean, scale, layout, crop size); the fused train step
    runs ``crop_norm`` as the first node of its CUDA graph, and the
    classic loop materialises the batch through the same kernel
    (:func:`materialize_device_feed`). The frames cross to the card as
    uint8: at the 256-store/224-crop recipe 0.33 of the float32 crops'
    bytes.

  The crop and mirror draws are the JAX package's ``np.random.RandomState``
  formulas, keyed by (seed, epoch, cursor) and, with ``aug_replicas``, by
  replica, so both packages draw the same crops, and the device_feed and
  device_augment modes agree bit for bit.

Cache layout (``<prefix>.meta.json`` / ``.data`` / ``.label``), byte-
compatible with the JAX package's (each package reads the other's)::

    meta:  {"num": N, "height": H, "width": W, "channels": C,
            "label_width": L, "version": 1, "src_size": ..., "src_mtime": ...}
    data:  uint8  [N, H, W, C]   (.npy, memory-mapped at iteration time)
    label: float32 [N, L]        (.npy)

Store the training crop plus the augmentation margin (256 for 224 crops).
"""
from __future__ import annotations

import json
import logging
import os
import socket
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from . import env as _env
from . import telemetry as _tel
from .base import MXNetError
from .context import Context, current_context
from .io import _REG, DataBatch, DataDesc, DataIter, _batch_array
from .ndarray import HostToDevice, NDArray, _host_tensor

__all__ = ["build_decoded_cache", "CachedImageRecordIter",
           "materialize_device_feed", "DeviceFeed", "load_device_feed"]


def _decode_record(rec: bytes, store_hw: Tuple[int, int], channels: int):
    """A JPEG record -> (uint8 HWC frame resized to ``store_hw``, label
    vector)."""
    from PIL import Image

    from . import recordio as rio

    header, img = rio.unpack_img(rec, iscolor=1 if channels == 3 else 0)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w = store_hw
    if img.shape[0] != h or img.shape[1] != w:
        # PIL takes a one-channel frame as (H, W)
        pil = img[:, :, 0] if img.shape[2] == 1 else img
        img = np.asarray(Image.fromarray(pil.astype(np.uint8))
                         .resize((w, h)))
        if img.ndim == 2:
            img = img[:, :, None]
    return img.astype(np.uint8), np.atleast_1d(
        np.asarray(header.label, dtype=np.float32))


def build_decoded_cache(path_imgrec: str, cache_prefix: str,
                        store_shape: Tuple[int, int, int],
                        preprocess_threads: int = 4,
                        overwrite: bool = False) -> dict:
    """Decode every record of ``path_imgrec`` once into a memory-mapped
    uint8 cache at ``cache_prefix``; ``store_shape`` is (C, H, W).
    Returns the header dict.

    A complete cache of the same store shape and the same source (size
    and mtime) is reused; another shape, a changed source or
    ``overwrite`` rebuilds. With the source gone, a cache of the right
    shape is still used. Memory stays at one decode chunk whatever the
    dataset's size."""
    c, h, w = store_shape
    meta_path = cache_prefix + ".meta.json"
    try:
        src_stat = os.stat(path_imgrec)
    except FileNotFoundError:
        if not overwrite and os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if (meta.get("height"), meta.get("width"),
                    meta.get("channels")) == (h, w, c):
                return meta
        raise MXNetError("no recordio at %s and no matching decoded "
                         "cache at %s" % (path_imgrec, cache_prefix))

    def existing():
        if overwrite or not os.path.exists(meta_path):
            return None
        with open(meta_path) as f:
            meta = json.load(f)
        fresh = ((meta.get("height"), meta.get("width"),
                  meta.get("channels")) == (h, w, c)
                 and meta.get("src_size") == src_stat.st_size
                 and meta.get("src_mtime") == src_stat.st_mtime_ns)
        return meta if fresh else None

    meta = existing()
    if meta is not None:
        return meta
    # one builder a prefix: O_CREAT|O_EXCL is atomic on POSIX and NFSv3+;
    # the lock names host:pid so a waiter on the same host can break the
    # lock of a builder that died
    lock_path = cache_prefix + ".build.lock"
    deadline = time.time() + _env.get("MXTPU_CACHE_BUILD_TIMEOUT")
    while True:
        try:
            fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, ("%s:%d" % (socket.gethostname(),
                                     os.getpid())).encode())
            os.close(fd)
        except FileExistsError:
            while os.path.exists(lock_path):
                if _lock_owner_dead(lock_path):
                    logging.warning(
                        "io_cache: cache-build lock %s held by a dead "
                        "local builder; breaking it", lock_path)
                    try:
                        os.unlink(lock_path)
                    except OSError:
                        pass
                    break
                if time.time() > deadline:
                    raise MXNetError(
                        "timed out waiting for another rank's cache "
                        "build (lock %s); if the builder crashed, "
                        "delete the lock file and retry" % lock_path)
                time.sleep(2.0)
            meta = existing()
            if meta is not None:
                return meta
            continue    # the other builder made another cache: our turn
        break
    try:
        # the cache may have been completed between the check and the lock
        meta = existing()
        if meta is not None:
            return meta
        return _locked_build(path_imgrec, cache_prefix, store_shape,
                             preprocess_threads, src_stat)
    finally:
        try:
            os.unlink(lock_path)
        except OSError:
            pass


def _lock_owner_dead(lock_path: str) -> bool:
    """True only for a lock naming a builder on this host whose pid no
    longer exists; a lock being written, or of another host, reads as
    alive (two builders at once would be worse than waiting)."""
    try:
        with open(lock_path) as f:
            host, pid = f.read().strip().rsplit(":", 1)
        pid = int(pid)
    except (OSError, ValueError):
        return False
    if host != socket.gethostname():
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    except OSError:
        pass
    return False


def _locked_build(path_imgrec, cache_prefix, store_shape, preprocess_threads,
                  src_stat):
    from . import recordio as rio

    c, h, w = store_shape
    meta_path = cache_prefix + ".meta.json"
    # pass 1: count the records (framing reads only)
    n = 0
    reader = rio.MXRecordIO(path_imgrec, "r")
    while reader.read() is not None:
        n += 1
    reader.close()
    if n == 0:
        raise MXNetError("no records found in %s" % path_imgrec)
    # pass 2: decode in bounded chunks
    reader = rio.MXRecordIO(path_imgrec, "r")
    first = reader.read()
    _, first_label = _decode_record(first, (h, w), c)
    label_width = first_label.size
    # host and pid: ranks on two hosts may share a pid
    sfx = ".tmp.%s.%d" % (socket.gethostname(), os.getpid())
    data_tmp = cache_prefix + ".data" + sfx
    label_tmp = cache_prefix + ".label" + sfx
    meta_tmp = meta_path + sfx
    try:
        data_mm = np.lib.format.open_memmap(
            data_tmp, mode="w+", dtype=np.uint8, shape=(n, h, w, c))
        labels = np.zeros((n, label_width), dtype=np.float32)

        def work(item):
            i, rec = item
            img, label = _decode_record(rec, (h, w), c)
            data_mm[i] = img
            labels[i, :] = label

        threads = max(1, int(preprocess_threads))
        chunk_size = max(64, 16 * threads)
        pool = ThreadPoolExecutor(threads) if threads > 1 else None

        def flush(chunk):
            if pool is not None:
                list(pool.map(work, chunk))
            else:
                for item in chunk:
                    work(item)

        try:
            i, rec, chunk = 0, first, []
            while rec is not None:
                chunk.append((i, rec))
                if len(chunk) >= chunk_size:
                    flush(chunk)
                    chunk = []
                i += 1
                rec = reader.read()
            if chunk:
                flush(chunk)
        finally:
            if pool is not None:
                pool.shutdown()
            reader.close()
        data_mm.flush()
        del data_mm
        np.save(label_tmp, labels)
        if os.path.exists(label_tmp + ".npy"):   # np.save appends .npy
            os.replace(label_tmp + ".npy", label_tmp)
        meta = {"num": n, "height": h, "width": w, "channels": c,
                "label_width": int(label_width), "version": 1,
                "src_size": src_stat.st_size,
                "src_mtime": src_stat.st_mtime_ns}
        with open(meta_tmp, "w") as f:
            json.dump(meta, f)
        # the header last: its existence marks the cache complete
        os.replace(data_tmp, cache_prefix + ".data")
        os.replace(label_tmp, cache_prefix + ".label")
        os.replace(meta_tmp, meta_path)
    except BaseException:
        # a failed build leaves no dataset-sized temporary file behind
        for p in (data_tmp, label_tmp, label_tmp + ".npy", meta_tmp):
            try:
                os.unlink(p)
            except OSError:
                pass
        raise
    return meta


def _to_device(arr, device: torch.device) -> torch.Tensor:
    """Host data (numpy or a tensor) on ``device``; the bytes that cross
    to a card count in ``ndarray.h2d_bytes``."""
    t = arr if isinstance(arr, torch.Tensor) else _host_tensor(arr)
    if device.type == "cuda" and t.device.type != "cuda":
        _tel.inc("ndarray.h2d_bytes", t.numel() * t.element_size())
    return t.to(device)


class CachedImageRecordIter(DataIter):
    """Batches from a decoded uint8 cache (see the module docstring).
    ``num_parts``/``part_index`` give each worker a contiguous, disjoint
    shard; a shard that is not a multiple of ``batch_size`` wraps its
    last batch to the epoch's start and reports the wrapped rows through
    ``getpad()``. The current context when the iterator is made is the
    device that normalises or augments (``device_normalize``,
    ``device_augment``: ``with mx.cpu():`` for the CPU); a device-feed
    batch stays on the host until its consumer takes it."""

    def __init__(self, cache_prefix: str, data_shape, batch_size: int,
                 shuffle: bool = True, rand_crop: bool = False,
                 rand_mirror: bool = False, num_parts: int = 1,
                 part_index: int = 0, seed: int = 0,
                 mean_r: float = 0.0, mean_g: float = 0.0,
                 mean_b: float = 0.0, scale: float = 1.0,
                 device_normalize: bool = True,
                 device_augment: bool = False,
                 device_feed: Optional[bool] = None,
                 output_layout: str = "NCHW",
                 label_name: str = "softmax_label",
                 aug_replicas: Optional[int] = None):
        super().__init__()
        meta_path = cache_prefix + ".meta.json"
        if not os.path.exists(meta_path):
            raise MXNetError(
                "no decoded cache at %s (build one with "
                "mxnet_tpu_torch.io_cache.build_decoded_cache)" % meta_path)
        with open(meta_path) as f:
            self.meta = json.load(f)
        c, h, w = data_shape
        if c != self.meta["channels"]:
            raise MXNetError("cache stores %d channels, asked for %d"
                             % (self.meta["channels"], c))
        if h > self.meta["height"] or w > self.meta["width"]:
            raise MXNetError(
                "crop %dx%d exceeds stored size %dx%d — rebuild the "
                "cache with a larger store_shape"
                % (h, w, self.meta["height"], self.meta["width"]))
        self.data_shape = (c, h, w)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.scale = scale
        self.mean = np.asarray([mean_r, mean_g, mean_b][:c], np.float32)
        self.device_normalize = device_normalize
        self.device_augment = device_augment
        if device_feed is None:
            device_feed = _env.get("MXNET_TPU_DEVICE_FEED")
        self.device_feed = bool(device_feed)
        if aug_replicas is None:
            aug_replicas = _env.get("MXNET_TPU_AUG_REPLICAS") or 1
        self.aug_replicas = max(1, int(aug_replicas))
        if batch_size % self.aug_replicas:
            raise MXNetError(
                "batch_size %d not divisible by aug_replicas %d"
                % (batch_size, self.aug_replicas))
        if output_layout not in ("NCHW", "NHWC"):
            raise MXNetError("output_layout must be NCHW or NHWC, got %r"
                             % (output_layout,))
        self.output_layout = output_layout
        self.label_name = label_name
        self._ctx = current_context()
        self._consts = None     # (mean, scale) on the device
        self._data = np.load(cache_prefix + ".data", mmap_mode="r")
        self._labels = np.load(cache_prefix + ".label", mmap_mode="r")
        self._seed = int(seed)
        self._epoch = 0
        n = self.meta["num"]
        if not (0 <= part_index < num_parts):
            raise MXNetError("part_index %d out of range for num_parts %d"
                             % (part_index, num_parts))
        per, extra = n // num_parts, n % num_parts
        start = part_index * per + min(part_index, extra)
        count = per + (1 if part_index < extra else 0)
        self._indices = np.arange(start, start + count)
        self.num_data = count
        if count % batch_size != 0:
            logging.warning(
                "CachedImageRecordIter: %d samples in this shard is not "
                "a multiple of batch_size=%d; the last batch of each "
                "epoch wraps to the epoch start and reports pad=%d via "
                "getpad()", count, batch_size,
                batch_size - count % batch_size)
        self.cursor = -batch_size
        self._order = None
        self._batch_cursor = None

    # -- the device's work: crop_norm --------------------------------------
    def _device_constants(self, device):
        if self._consts is None or self._consts[0].device != device:
            self._consts = (_to_device(self.mean, device),
                            _to_device(np.float32(self.scale).reshape(1),
                                       device))
        return self._consts

    def _on_device(self, frames_u8, tops, lefts, mirror) -> NDArray:
        """uint8 NHWC frames and each image's crop offsets and mirror flag
        -> the normalised float32 batch on the iterator's device, one
        ``crop_norm`` launch (its plain version on the CPU)."""
        from .ops import kernels

        dev = self._ctx.torch_device()
        mean, scale = self._device_constants(dev)
        _, h, w = self.data_shape
        y = kernels.crop_norm(
            _to_device(frames_u8, dev), _to_device(tops.astype(np.int32), dev),
            _to_device(lefts.astype(np.int32), dev),
            _to_device(np.asarray(mirror, np.uint8), dev), mean, scale,
            (h, w), self.output_layout)
        return NDArray(y, self._ctx)

    # -- DataIter interface ----------------------------------------------
    @property
    def provide_data(self):
        c, h, w = self.data_shape
        shape = (self.batch_size, c, h, w) if self.output_layout == "NCHW" \
            else (self.batch_size, h, w, c)
        return [DataDesc("data", shape)]

    @property
    def provide_label(self):
        lw = self.meta["label_width"]
        shape = (self.batch_size,) if lw == 1 else (self.batch_size, lw)
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        self.cursor = -self.batch_size
        self._epoch += 1
        self._order = None
        self._batch_cursor = None

    # -- checkpoint state ---------------------------------------------------
    def get_checkpoint_state(self) -> dict:
        """The stream's identity: the shuffle order and every crop and
        mirror draw are functions of (seed, epoch, cursor, replica)."""
        return {"kind": type(self).__name__,
                "batch_size": self.batch_size,
                "seed": self._seed,
                "epoch": self._epoch,
                "aug_replicas": self.aug_replicas}

    def set_checkpoint_state(self, state: dict) -> None:
        """Seek to ``state["batches"]`` batches consumed within epoch
        ``state["epoch"]``: the next batch's order and augmentation are
        the uninterrupted run's, bit for bit."""
        if "epoch" in state:
            self._epoch = int(state["epoch"])
        k = int(state.get("batches", 0))
        self.cursor = (k - 1) * self.batch_size
        self._order = None
        self._batch_cursor = None

    def _epoch_order(self):
        if self._order is None:
            if self.shuffle:
                rng = np.random.RandomState(
                    (self._seed * 0x9E3779B1 + self._epoch * 1000003)
                    & 0xFFFFFFFF)
                self._order = self._indices[rng.permutation(self.num_data)]
            else:
                self._order = self._indices
        return self._order

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    # the accessor protocol builds the current batch once
    def getdata(self):
        return self._current_batch().data

    def getlabel(self):
        return self._current_batch().label

    def getpad(self):
        return max(0, self.cursor + self.batch_size - self.num_data)

    def getindex(self):
        return self._current_batch().index

    def next(self) -> DataBatch:
        if not self.iter_next():
            raise StopIteration
        _tel.inc("io.batches")
        return self._current_batch()

    def _current_batch(self) -> DataBatch:
        if self._batch_cursor != self.cursor:
            self._batch = self._make_batch()
            self._batch_cursor = self.cursor
        else:
            _tel.inc("io.batch_cache_hit")
        return self._batch

    def _aug_params(self, sh, sw, h, w):
        """Each image's crop offsets and mirror flag for this batch,
        replica r's rows ``[r*B/R, (r+1)*B/R)`` from a RandomState keyed
        (seed, epoch, cursor, r); ``aug_replicas=1`` is one stream. The
        device_feed and device_augment modes share these draws."""
        R = self.aug_replicas
        shard = self.batch_size // R
        tops, lefts, mirror = [], [], []
        for r in range(R):
            rs = np.random.RandomState(
                (self._seed * 2654435761 + self._epoch * 1000003
                 + self.cursor + r * 0x85EBCA6B) & 0xFFFFFFFF)
            if self.rand_crop and (sh > h or sw > w):
                tops.append(rs.randint(0, sh - h + 1, shard))
                lefts.append(rs.randint(0, sw - w + 1, shard))
            else:
                tops.append(np.full(shard, (sh - h) // 2))
                lefts.append(np.full(shard, (sw - w) // 2))
            mirror.append((rs.rand(shard) < 0.5) if self.rand_mirror
                          else np.zeros(shard, bool))
        return (np.concatenate(tops), np.concatenate(lefts),
                np.concatenate(mirror))

    def _make_batch(self) -> DataBatch:
        order = self._epoch_order()
        idx = order[self.cursor:self.cursor + self.batch_size]
        pad = self.getpad()
        if pad:
            # the trailing partial batch wraps to the epoch's start
            idx = np.concatenate([idx, np.resize(order, pad)])
            _tel.inc("io.pad_samples", pad)
        c, h, w = self.data_shape
        sh, sw = self.meta["height"], self.meta["width"]
        if self.device_feed or self.device_augment:
            # order within a batch does not matter to SGD; a sorted
            # gather reads the memory map in order
            gidx = np.sort(idx)
            full = np.ascontiguousarray(self._data[gidx])
            tops, lefts, mirror = self._aug_params(sh, sw, h, w)
            labels = np.asarray(self._labels[gidx])
            if self.meta["label_width"] == 1:
                labels = labels[:, 0]
            labels = _batch_array(np.ascontiguousarray(labels))
            if self.device_feed:
                batch = DataBatch([_batch_array(full)], [labels], pad=pad,
                                  index=gidx)
                batch.aug = {"tops": tops.astype(np.int32),
                             "lefts": lefts.astype(np.int32),
                             "mirror": mirror,
                             "mean": self.mean,
                             "scale": float(self.scale),
                             "layout": self.output_layout,
                             "crop": (h, w)}
                _tel.inc("io.feed_batches")
                return batch
            data = self._on_device(full, tops, lefts, mirror)
            return DataBatch([data], [labels], pad=pad, index=gidx)

        rng = np.random.RandomState(
            (self._seed * 2654435761 + self._epoch * 1000003
             + self.cursor) & 0xFFFFFFFF)
        out = np.empty((self.batch_size, h, w, c), dtype=np.uint8)
        for k, i in enumerate(idx):
            if self.rand_crop and (sh > h or sw > w):
                top = rng.randint(0, sh - h + 1)
                left = rng.randint(0, sw - w + 1)
            else:
                top, left = (sh - h) // 2, (sw - w) // 2
            img = self._data[i, top:top + h, left:left + w]
            if self.rand_mirror and rng.rand() < 0.5:
                img = img[:, ::-1]
            out[k] = img
        labels = np.asarray(self._labels[idx])
        if self.meta["label_width"] == 1:
            labels = labels[:, 0]
        labels = _batch_array(np.ascontiguousarray(labels))
        if self.device_normalize:
            zeros = np.zeros(self.batch_size, np.int32)
            data = self._on_device(out, zeros, zeros, zeros.astype(bool))
        else:
            x = (out.astype(np.float32) - self.mean) * self.scale
            if self.output_layout == "NCHW":
                x = np.transpose(x, (0, 3, 1, 2))
            data = _batch_array(np.ascontiguousarray(x))
        return DataBatch([data], [labels], pad=pad, index=np.asarray(idx))


def materialize_device_feed(batch: DataBatch, ctx: Optional[Context] = None
                            ) -> DataBatch:
    """A device-feed batch with its deferred augmentation applied: the
    same ``crop_norm`` the fused step runs inside its graph, launched on
    ``ctx``'s device (default: where the frames lie), returned as an
    ordinary batch of float32 data there. The classic loop and
    ``score``/``predict`` on one context take device-feed batches
    through this (over several contexts each replica crops its own rows:
    :class:`DeviceFeed`). A batch without ``aug`` is returned as it
    is."""
    aug = getattr(batch, "aug", None)
    if aug is None:
        return batch
    from .ops import kernels

    x = batch.data[0]
    if ctx is None:
        ctx = x.context if isinstance(x, NDArray) else current_context()
    dev = ctx.torch_device()
    frames = x.handle if isinstance(x, NDArray) else x
    y = kernels.crop_norm(
        _to_device(frames, dev),
        _to_device(np.asarray(aug["tops"], np.int32), dev),
        _to_device(np.asarray(aug["lefts"], np.int32), dev),
        _to_device(np.asarray(aug["mirror"], np.uint8), dev),
        _to_device(np.asarray(aug["mean"], np.float32), dev),
        _to_device(np.asarray(aug["scale"], np.float32).reshape(1), dev),
        aug["crop"], aug["layout"])
    return DataBatch([NDArray(y, ctx)], batch.label, pad=batch.pad,
                     index=batch.index, provide_data=batch.provide_data,
                     provide_label=batch.provide_label)


def _feed_frames(batch: DataBatch, rows: Optional[slice],
                 device: torch.device):
    """The uint8 frames of ``rows`` (all of them for None) of a
    device-feed batch: the part the staging put on ``device`` where it
    split the batch so (``batch.feed_parts``: ``(rows, tensor)`` a
    card), else those rows of the whole frames, wherever they lie."""
    for part_rows, part in getattr(batch, "feed_parts", None) or ():
        if part_rows == rows and part.device == device:
            return part
    x = batch.data[0]
    x = x.handle if isinstance(x, NDArray) else x
    return x if rows is None else x[rows]


class DeviceFeed:
    """A device-feed batch's frames and augmentation on one device, for
    one frame shape, crop and layout (``key``), in buffers that keep
    their storage from batch to batch, so a CUDA graph that reads them
    serves every batch: the uint8 frames, the crop offsets and mirror
    flags of its rows, the mean and the scale. Host data go through a
    pinned :class:`~mxnet_tpu_torch.ndarray.HostToDevice` a buffer, on
    the current stream; frames already on a card (a staged batch) are
    copied device to device. :meth:`crop` launches ``crop_norm`` from
    the buffers. The fused step keeps one (one a card over several
    contexts), the classic loop over several contexts one a context:
    :func:`load_device_feed` fills or replaces it."""

    def __init__(self, device: torch.device, key):
        self.device = device
        self.key = key
        (b, _, _, c), _, _ = key
        self.bufs = {
            "x": torch.empty(key[0], dtype=torch.uint8, device=device),
            "tops": torch.empty(b, dtype=torch.int32, device=device),
            "lefts": torch.empty(b, dtype=torch.int32, device=device),
            "mirror": torch.empty(b, dtype=torch.uint8, device=device),
            "mean": torch.empty(c, dtype=torch.float32, device=device),
            "scale": torch.empty(1, dtype=torch.float32, device=device)}
        self._loaders = {k: HostToDevice(v) for k, v in self.bufs.items()}

    def load(self, frames, aug, rows: Optional[slice] = None):
        """``frames`` (the rows' uint8 frames) and those rows of ``aug``
        into the buffers."""
        rows = slice(None) if rows is None else rows
        host = {"x": frames,
                "tops": np.asarray(aug["tops"], np.int32)[rows],
                "lefts": np.asarray(aug["lefts"], np.int32)[rows],
                "mirror": np.asarray(aug["mirror"], np.uint8)[rows],
                "mean": np.asarray(aug["mean"], np.float32),
                "scale": np.asarray(aug["scale"], np.float32).reshape(1)}
        for k, loader in self._loaders.items():
            loader.copy(host[k])

    def crop(self, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The float32 crop of the buffers (one ``crop_norm`` launch on
        a card), into ``out`` where given."""
        from .ops import kernels

        b = self.bufs
        _, crop, layout = self.key
        return kernels.crop_norm(b["x"], b["tops"], b["lefts"], b["mirror"],
                                 b["mean"], b["scale"], crop, layout,
                                 out=out)


def load_device_feed(feed: Optional[DeviceFeed], batch: DataBatch,
                     device: torch.device,
                     rows: Optional[slice] = None) -> DeviceFeed:
    """``rows`` (all for None) of a device-feed batch into ``feed`` on
    ``device``, or into a new :class:`DeviceFeed` where ``feed`` is None
    or was made for another frame shape, crop or layout (so a CUDA graph
    over the old one is not replayed over the new): returns the feed
    loaded. A replica's rows are ``k * B/N .. (k + 1) * B/N`` of the
    batch whatever ``aug_replicas`` drew them, so its crop is those rows
    of the one-device crop, bit for bit."""
    aug = batch.aug
    frames = _feed_frames(batch, rows, device)
    key = (tuple(frames.shape), tuple(int(v) for v in aug["crop"]),
           aug["layout"])
    if feed is None or feed.key != key or feed.device != device:
        feed = DeviceFeed(device, key)
    feed.load(frames, aug, rows)
    return feed


_REG.register("CachedImageRecordIter")(CachedImageRecordIter)
