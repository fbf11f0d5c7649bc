"""Pluggable URI filesystem layer, counterpart of
``mxnet_tpu/filesystem.py``.

``open_uri`` routes a URI to the handler registered for its scheme and a
plain path to the local filesystem, wherever a file name is taken:
``nd.save``/``nd.load``, ``Symbol.save``/``load``,
``checkpoint.atomic_ndarray_save`` and the RecordIO files. ``mem://`` is
an in-process object store (tests, ephemeral checkpoints); ``s3://`` and
``hdfs://`` are registration points that raise until a handler is
installed.

    from mxnet_tpu_torch import filesystem as fs
    fs.register_scheme("s3", MyS3Handler())
    mx.nd.save("s3://bucket/weights.nd", {...})
"""
from __future__ import annotations

import io
import threading
from typing import Dict

from .base import MXNetError

__all__ = ["register_scheme", "open_uri", "exists", "scheme_of",
           "MemFS"]


def scheme_of(uri):
    """URI scheme, or None for plain paths (str or os.PathLike). Windows
    drive letters and single-char schemes are treated as paths."""
    import os

    uri = os.fspath(uri)
    if not isinstance(uri, str) or "://" not in uri:
        return None
    scheme = uri.split("://", 1)[0]
    if len(scheme) <= 1:
        return None
    return scheme.lower()


class MemFS:
    """In-process object store: ``mem://name`` → bytes. Thread-safe;
    shared process-wide (the registry holds one instance)."""

    def __init__(self):
        self._store: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def open(self, uri: str, mode: str):
        key = uri.split("://", 1)[1]
        if "r" in mode:
            with self._lock:
                if key not in self._store:
                    raise FileNotFoundError(uri)
                return io.BytesIO(self._store[key])

        fs = self

        class _Writer(io.BytesIO):
            def close(w):
                # idempotent like real file objects; commits once
                if not w.closed:
                    with fs._lock:
                        fs._store[key] = w.getvalue()
                io.BytesIO.close(w)

            def __exit__(w, exc_type, exc, tb):
                # don't commit a partial blob when the with-block raised
                if exc_type is not None:
                    io.BytesIO.close(w)
                else:
                    w.close()

        return _Writer()

    def exists(self, uri: str) -> bool:
        with self._lock:
            return uri.split("://", 1)[1] in self._store

    def clear(self):
        with self._lock:
            self._store.clear()


class _UnavailableFS:
    """Placeholder for schemes the reference supported via dmlc-core but
    that need a site-provided client here."""

    def __init__(self, scheme: str):
        self.scheme = scheme

    def open(self, uri: str, mode: str):
        raise MXNetError(
            "%s:// URIs need a handler: call mxnet_tpu_torch.filesystem."
            "register_scheme(%r, handler) with an object exposing "
            "open(uri, mode) (reference dmlc-core bundled its own "
            "S3/HDFS clients; this build delegates to yours)"
            % (self.scheme, self.scheme))

    def exists(self, uri: str) -> bool:
        return False  # nothing is reachable until a handler is installed


_SCHEMES = {
    "mem": MemFS(),
    "s3": _UnavailableFS("s3"),
    "hdfs": _UnavailableFS("hdfs"),
}


def register_scheme(scheme: str, handler) -> None:
    """Install/replace the handler for a URI scheme. The handler needs
    ``open(uri, mode) -> file object``; ``exists(uri) -> bool`` is
    optional (open-and-close probing is the fallback)."""
    _SCHEMES[scheme.lower()] = handler


def open_uri(uri, mode: str = "rb"):
    """Open a path (str or os.PathLike) or URI for read/write."""
    scheme = scheme_of(uri)
    if scheme is None:
        return open(uri, mode)
    handler = _SCHEMES.get(scheme)
    if handler is None:
        raise MXNetError(
            "unknown URI scheme '%s://' (registered: %s; plain paths "
            "use the local filesystem)"
            % (scheme, sorted(_SCHEMES)))
    return handler.open(uri, mode)


def exists(uri) -> bool:
    scheme = scheme_of(uri)
    if scheme is None:
        import os

        return os.path.exists(uri)
    handler = _SCHEMES.get(scheme)
    if handler is None:
        return False
    if hasattr(handler, "exists"):
        return bool(handler.exists(uri))
    try:
        handler.open(uri, "rb").close()
        return True
    except Exception:
        return False
