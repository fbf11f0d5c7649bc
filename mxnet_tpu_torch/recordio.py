"""RecordIO files, counterpart of ``mxnet_tpu/recordio.py``.

A stream of length-prefixed records (``magic(u32) lrecord(u32) data
pad-to-4``, little-endian; the upper 3 bits of ``lrecord`` are the
continuation flag), an indexed variant with a ``key\\toffset`` text
index, and the image-record header that ``ImageRecordIter`` reads
(label and ids ahead of the payload). The bytes on disk are the JAX
package's, both ways. Local paths only: the JAX package's URI schemes
(``mem://`` and registered filesystems) are not ported. PIL is imported
by :func:`pack_img` and :func:`unpack_img` alone.
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple
from typing import Optional

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_LFLAG_BITS = 29
_LENGTH_MASK = (1 << _LFLAG_BITS) - 1


class MXRecordIO:
    """Sequential record reader (``flag="r"``) or writer (``"w"``).
    ``write`` returns the record's byte offset, which the indexed
    variant stores."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self.fp = None
        self.open()

    def open(self):
        if self.flag not in ("r", "w"):
            raise MXNetError("invalid flag %s" % self.flag)
        self.writable = self.flag == "w"
        self.fp = open(self.uri, "wb" if self.writable else "rb")

    def close(self):
        if self.fp is not None:
            self.fp.close()
            self.fp = None

    def reset(self):
        self.close()
        self.open()

    def write(self, buf: bytes) -> int:
        if not self.writable:
            raise MXNetError("not opened for writing")
        off = self.fp.tell()
        self.fp.write(struct.pack("<II", _MAGIC, len(buf) & _LENGTH_MASK))
        self.fp.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.fp.write(b"\x00" * pad)
        return off

    def tell(self) -> int:
        return self.fp.tell()

    def seek(self, offset: int):
        self.fp.seek(offset)

    def read(self) -> Optional[bytes]:
        """The next record's payload, or None at the end of the file."""
        if self.writable:
            raise MXNetError("not opened for reading")
        header = self.fp.read(8)
        if len(header) < 8:
            return None
        magic, lrec = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise MXNetError("invalid record magic at %d"
                             % (self.fp.tell() - 8))
        length = lrec & _LENGTH_MASK
        buf = self.fp.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.fp.read(pad)
        return buf

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


class MXIndexedRecordIO(MXRecordIO):
    """Records with random access through an ``.idx`` text file of
    ``key\\toffset`` lines, written on ``close``."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if not self.writable and os.path.exists(idx_path):
            with open(idx_path, "rb") as fin:
                for line in fin.read().decode().splitlines():
                    if not line.strip():
                        continue
                    key, off = line.strip().split("\t")
                    key = key_type(key)
                    self.idx[key] = int(off)
                    self.keys.append(key)

    def close(self):
        # the records first: a failing index write must not lose them
        super().close()
        if self.writable and self.idx:
            with open(self.idx_path, "wb") as fout:
                for key in self.keys:
                    fout.write(("%s\t%d\n" % (key, self.idx[key])).encode())

    def seek(self, idx):
        MXRecordIO.seek(self, self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf: bytes):
        key = self.key_type(idx)
        self.idx[key] = self.write(buf)
        self.keys.append(key)


IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """An image-record header and its payload as one record; a vector
    label goes ahead of the payload with its length in ``flag``."""
    header = IRHeader(*header)
    if isinstance(header.label, (list, tuple, np.ndarray)):
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0.0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, header.flag, header.label,
                       header.id, header.id2) + s


def unpack(s: bytes):
    """(header, payload) of a record; a vector label comes back as a
    float32 array in ``header.label``."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    payload = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(payload[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        payload = payload[header.flag * 4:]
    return header, payload


def pack_img(header: IRHeader, img: np.ndarray, quality: int = 95,
             img_fmt: str = ".jpg") -> bytes:
    """Encode an HWC uint8 image (JPEG or PNG, with PIL) and pack it."""
    import io as _io

    from PIL import Image

    buf = _io.BytesIO()
    fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
    Image.fromarray(img.astype(np.uint8)).save(buf, format=fmt,
                                               quality=quality)
    return pack(header, buf.getvalue())


def unpack_img(s: bytes, iscolor: int = -1):
    """(header, HWC uint8 array) of an image record, decoded with PIL:
    ``iscolor`` 0 greyscale, 1 RGB, -1 as stored."""
    import io as _io

    from PIL import Image

    header, payload = unpack(s)
    img = Image.open(_io.BytesIO(payload))
    if iscolor == 0:
        img = img.convert("L")
    elif iscolor == 1:
        img = img.convert("RGB")
    return header, np.asarray(img)
