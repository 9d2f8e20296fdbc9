"""ctypes bindings of the input pipeline's host library (``csrc/host_io.cc``).

The library is compiled at first use by the system's C++ compiler
(``ops/_build.load_host_library``); a missing compiler raises. Each call
releases the interpreter lock while it runs, so reader threads overlap.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from udal_tpu_torch.ops import _build


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded library with every function's signature declared."""
    h = _build.load_host_library("host_io")
    h.udal_crc32c.restype = ctypes.c_uint32
    h.udal_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    h.udal_png_unfilter.restype = ctypes.c_int
    h.udal_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int, ctypes.c_void_p]
    h.udal_jpeg_scan.restype = ctypes.c_int64
    h.udal_jpeg_scan.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int]
    h.udal_jpeg_idct.restype = None
    h.udal_jpeg_idct.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_void_p]
    h.udal_jpeg_ycc_rgb.restype = None
    h.udal_jpeg_ycc_rgb.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_void_p]
    return h


def crc32c(data: bytes) -> int:
    """CRC32C of ``data``."""
    return int(lib().udal_crc32c(data, len(data)))


def png_unfilter(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Reconstruct ``height`` PNG scanlines from the decompressed stream
    ``raw`` (uint8, each row a filter byte then ``row_bytes``): uint8
    [height, row_bytes]."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size < height * (row_bytes + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, {height} rows need "
                         f"{height * (row_bytes + 1)}")
    out = np.empty((height, row_bytes), np.uint8)
    rc = lib().udal_png_unfilter(raw.ctypes.data, height, row_bytes, bpp, out.ctypes.data)
    if rc != 0:
        raise ValueError(f"PNG row {-1 - rc}: unknown filter type {raw[(-1 - rc) * (row_bytes + 1)]}")
    return out


def jpeg_scan(data: bytes, pos: int, comps: np.ndarray, coefs, tables: np.ndarray,
              mcux: int, mcuy: int, restart: int) -> int:
    """Entropy-decode one baseline scan into ``coefs`` (one int16 [rows,
    cols, 64] array a component of the scan, filled in place); returns the
    offset where the scan's data ends. ``comps`` is int32 [n, 8] (h, v, DC
    table, AC table, the arrays' block columns and rows, the component's
    own blocks a row and column); ``tables`` uint8 [8, 272] (DC 0-3, AC
    0-3: 16 code counts, 256 values)."""
    comps = np.ascontiguousarray(comps, np.int32)
    tables = np.ascontiguousarray(tables, np.uint8)
    for c, a in zip(comps, coefs):
        if a.dtype != np.int16 or not a.flags.c_contiguous or a.shape != (c[5], c[4], 64):
            raise ValueError(f"coefficient array {a.shape} {a.dtype} does not match {c}")
    ptrs = (ctypes.c_void_p * len(coefs))(*[a.ctypes.data for a in coefs])
    end = lib().udal_jpeg_scan(data, len(data), pos, len(coefs), comps.ctypes.data, ptrs,
                               tables.ctypes.data, mcux, mcuy, restart)
    if end == -1:
        raise ValueError("JPEG: corrupt Huffman data")
    if end == -2:
        raise ValueError("JPEG: a restart marker is missing")
    if end == -3:
        raise ValueError("JPEG: bad Huffman table")
    return int(end)


def jpeg_idct(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """libjpeg's islow IDCT of quantised blocks int16 [N, 64] (natural
    order) dequantised by ``quant`` [64]: uint8 [N, 8, 8]."""
    coefs = np.ascontiguousarray(coefs, np.int16).reshape(-1, 64)
    quant = np.ascontiguousarray(quant, np.int32).reshape(64)
    out = np.empty((coefs.shape[0], 8, 8), np.uint8)
    lib().udal_jpeg_idct(coefs.ctypes.data, quant.ctypes.data, coefs.shape[0], out.ctypes.data)
    return out


def jpeg_ycc_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's YCbCr → RGB of three uint8 planes [H, W]: uint8 [H, W, 3]."""
    planes = [np.ascontiguousarray(p, np.uint8) for p in (y, cb, cr)]
    if not planes[0].shape == planes[1].shape == planes[2].shape:
        raise ValueError(f"plane shapes differ: {[p.shape for p in planes]}")
    out = np.empty(planes[0].shape + (3,), np.uint8)
    lib().udal_jpeg_ycc_rgb(*[p.ctypes.data for p in planes], planes[0].size, out.ctypes.data)
    return out
