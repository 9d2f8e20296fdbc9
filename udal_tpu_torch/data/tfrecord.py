"""TFRecord files: write, scan, read at an offset, iterate, index.

Port of ``udal_tpu/data/tfrecord.py`` with its own copy of the framing,
as TensorFlow frames a record:

  uint64 length | uint32 masked_crc32c(length) | data | uint32 masked_crc32c(data)

The checksum runs in the host library (``csrc/host_io.cc``, built at first
use); ``crc32c_plain`` is its table-driven Python twin, kept for the tests.
A length's checksum is checked on every scan (as the JAX package's native
reader does), the data's when ``verify_crc`` is set.
"""

from __future__ import annotations

import glob as globlib
import os
import struct
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from udal_tpu_torch.data import host_io

_MASK_DELTA = 0xA282EAD8
_CRC_TABLE: Optional[List[int]] = None


def crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli) of ``data``."""
    return host_io.crc32c(bytes(data))


def crc32c_plain(data: bytes) -> int:
    """The same CRC bit by bit in Python (one table lookup a byte)."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if (c & 1) else (c >> 1)
            table.append(c)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _mask(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def _unmask(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


class TFRecordWriter:
    """Writes records to a TFRecord file; a context manager."""

    def __init__(self, path: str):
        self._path = path
        self._file = open(path, "wb")

    def write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._file.write(header + struct.pack("<I", _mask(crc32c(header))))
        self._file.write(record)
        self._file.write(struct.pack("<I", _mask(crc32c(record))))

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def scan_tfrecord(path: str, verify_crc: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets, lengths) of every record's data in the file, int64.
    Raises IOError on a truncated file or a checksum that disagrees."""
    offsets, lengths = [], []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                break
            if len(header) != 12:
                raise IOError(f"corrupt TFRecord (truncated header): {path}")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:])
            if _unmask(len_crc) != crc32c(header[:8]):
                raise IOError(f"corrupt TFRecord (length checksum): {path}")
            offset = f.tell()
            if offset + length + 4 > size:
                raise IOError(f"corrupt TFRecord (truncated record): {path}")
            if verify_crc:
                data = f.read(length)
                (data_crc,) = struct.unpack("<I", f.read(4))
                if _unmask(data_crc) != crc32c(data):
                    raise IOError(f"corrupt TFRecord (data checksum): {path}")
            else:
                f.seek(length + 4, os.SEEK_CUR)
            offsets.append(offset)
            lengths.append(length)
    return np.asarray(offsets, np.int64), np.asarray(lengths, np.int64)


def read_record(path: str, offset: int, length: int) -> bytes:
    """The record data of ``length`` bytes at ``offset``."""
    with open(path, "rb") as f:
        f.seek(offset)
        data = f.read(length)
    if len(data) != length:
        raise IOError(f"read failed: {path}@{offset}")
    return data


def iterate_tfrecord(path: str) -> Iterator[bytes]:
    """Every record of the file in order (no checksum checked)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            (length,) = struct.unpack("<Q", header[:8])
            data = f.read(length)
            f.read(4)
            yield data


class TFRecordIndex:
    """Random access to the records of a set of TFRecord shards."""

    def __init__(self, paths: Sequence[str], verify_crc: bool = False):
        self.paths = list(paths)
        self._entries: List[Tuple[int, int, int]] = []   # (file, offset, length)
        for fi, p in enumerate(self.paths):
            offs, lens = scan_tfrecord(p, verify_crc)
            self._entries.extend((fi, o, n) for o, n in zip(offs.tolist(), lens.tolist()))

    @classmethod
    def from_pattern(cls, pattern: str) -> "TFRecordIndex":
        paths = sorted(globlib.glob(pattern))
        if not paths:
            raise FileNotFoundError(pattern)
        return cls(paths)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i: int) -> bytes:
        fi, off, ln = self._entries[i]
        return read_record(self.paths[fi], off, ln)
