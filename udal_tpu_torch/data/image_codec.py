"""PNG and baseline-JPEG decoding, and PNG encoding, without cv2 or PIL.

The port's counterpart of ``cv2.imdecode(..., IMREAD_COLOR)`` + BGR→RGB and
of ``cv2.imencode(".png")``, which the JAX package's reader, dataset
writers and synthetic data call (the machine with the card has neither cv2
nor PIL). ``decode_image`` returns RGB uint8 [H, W, 3], as the JAX
reader's ``decode_image`` does.

- **PNG**: 8-bit gray, gray + alpha, RGB, RGBA and palette images, filter
  types 0-4, no interlace (an interlaced file raises
  ``NotImplementedError``). Alpha is dropped and gray replicated, as
  libpng's transforms under ``IMREAD_COLOR`` do. zlib inflates; the
  scanline filters (Average and Paeth are serial along a row) run in the
  host library (``csrc/host_io.cc``).
- **JPEG**: baseline and extended sequential Huffman, 8-bit; gray and
  YCbCr (or RGB by the Adobe marker); sampling 4:4:4, 4:2:2, 4:2:0 and
  4:4:0; restart markers; single-component and interleaved scans. What
  libjpeg-turbo does by default, as cv2 calls it: the ``islow`` integer
  IDCT (6b's constants and rounding), fancy (triangle) upsampling with
  edge rows and columns replicated, and the fixed-point YCbCr→RGB tables.
  The Huffman decode, the IDCT and the colour conversion run in the
  host library; the upsampling is numpy. Progressive,
  arithmetic-coded, lossless, hierarchical, 12-bit and 4-component
  (CMYK) files raise ``NotImplementedError``.

``plain=True`` swaps the host library's loops for their numpy / Python
twins (``_unfilter_plain``, ``_scan_plain``, ``idct_islow``,
``_ycc_to_rgb``), which the tests hold them against.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from udal_tpu_torch.data import host_io

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def decode_image(data: bytes, plain: bool = False) -> np.ndarray:
    """PNG or JPEG bytes → RGB uint8 [H, W, 3]."""
    data = bytes(data)
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data, plain)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data, plain)
    raise ValueError("image decode failed: neither a PNG nor a JPEG stream")


def image_size(data: bytes) -> Tuple[int, int]:
    """(height, width) from a PNG's IHDR or a JPEG's frame header."""
    data = bytes(data)
    if data[:8] == PNG_SIGNATURE:
        w, h = struct.unpack(">II", data[16:24])
        return h, w
    if data[:2] == b"\xff\xd8":
        pos = 2
        while pos + 4 <= len(data):
            pos, marker = _next_marker(data, pos)
            if marker in _SOF_ANY:
                h, w = struct.unpack(">HH", data[pos + 3:pos + 7])
                return h, w
            if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
                continue
            pos += struct.unpack(">H", data[pos:pos + 2])[0]
        raise ValueError("JPEG: no frame header")
    raise ValueError("image size: neither a PNG nor a JPEG stream")


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunks(data: bytes):
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if kind in (b"IHDR", b"PLTE", b"IDAT") and zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG: {kind.decode()} chunk fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length


def decode_png(data: bytes, plain: bool = False) -> np.ndarray:
    """A PNG stream → RGB uint8 [H, W, 3]."""
    header, palette, idat = None, None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError("PNG: no IHDR or IDAT chunk")
    w, h, depth, color, _, _, interlace = header
    if interlace:
        raise NotImplementedError("interlaced (Adam7) PNG is not decoded by the port's "
                                  "image codec; re-encode the image without interlace")
    if depth != 8 or color not in _PNG_CHANNELS:
        raise NotImplementedError(f"PNG bit depth {depth}, colour type {color}: the port "
                                  "decodes 8-bit gray, gray + alpha, RGB, RGBA and palette")
    ch = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    unfilter = _unfilter_plain if plain else host_io.png_unfilter
    px = unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if color == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        table = np.zeros((256, 3), np.uint8)       # indices past the palette read black
        table[:len(palette)] = palette[:256]
        return table[px[..., 0]]
    if ch <= 2:                                     # gray (+ alpha): alpha dropped, gray replicated
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_plain(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """numpy twin of ``host_io.png_unfilter``: Sub and Up at once per row,
    Average and Paeth a pixel at a time."""
    rows = np.asarray(raw, np.uint8)[:height * (row_bytes + 1)].reshape(height, row_bytes + 1)
    out = np.zeros((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.int32)
    for y in range(height):
        ft, src = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if ft == 0:
            cur = src
        elif ft == 1:
            cur = np.cumsum(src.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ft == 2:
            cur = (src + prev) & 255
        elif ft in (3, 4):
            cur = np.zeros(row_bytes, np.int32)
            for x in range(0, row_bytes, bpp):
                a = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                b = prev[x:x + bpp]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    pred = _paeth(a, b, c)
                cur[x:x + bpp] = (src[x:x + bpp] + pred) & 255
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ft}")
        out[y] = cur
        prev = cur.astype(np.int32)
    return out


def _png_filtered(px: np.ndarray, bpp: int, types: Sequence[int]) -> np.ndarray:
    """Every row under each filter of ``types``: int16 [len(types), H,
    row_bytes], modulo 256."""
    x = px.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    filters = {0: lambda: x, 1: lambda: x - a, 2: lambda: x - b,
               3: lambda: x - ((a + b) >> 1)}

    def paeth():
        c = np.zeros_like(x)
        c[1:, bpp:] = x[:-1, :-bpp]
        return x - _paeth(a, b, c)

    filters[4] = paeth
    return np.stack([filters[t]() for t in types]) & 255


def encode_png(image: np.ndarray, filter_type: Union[None, int, Sequence[int]] = None,
               level: int = 6) -> bytes:
    """uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA) → PNG bytes.

    ``filter_type``: one of 0-4 for every row, one a row, or None for the
    per-row choice of libpng's default heuristic (the filter whose bytes,
    read as signed, have the least absolute sum). ``level``: zlib's."""
    px = np.ascontiguousarray(image, np.uint8)
    if px.ndim == 2:
        px = px[..., None]
    h, w, ch = px.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}.get(ch)
    if color is None:
        raise ValueError(f"encode_png takes 1-4 channels, got {ch}")
    rows = px.reshape(h, w * ch)
    if filter_type is None:
        filtered = _png_filtered(rows, ch, range(5))
        signed = np.where(filtered > 127, 256 - filtered, filtered).astype(np.int64)
        choice = np.argmin(signed.sum(axis=2), axis=0)
    else:
        choice = np.broadcast_to(np.asarray(filter_type, np.int64), (h,))
        if choice.min() < 0 or choice.max() > 4:
            raise ValueError(f"PNG filter types are 0-4, got {filter_type}")
        types = sorted(set(choice.tolist()))
        filtered = np.zeros((5,) + rows.shape, np.int16)
        filtered[types] = _png_filtered(rows, ch, types)
    body = np.empty((h, w * ch + 1), np.uint8)
    body[:, 0] = choice
    body[:, 1:] = filtered[choice, np.arange(h)]

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(body.tobytes(), level))
            + chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    """``image`` as a PNG file at ``path``, encoded for speed: the Sub
    filter on every row and zlib level 1 (about 4x faster than
    ``encode_png``'s defaults on a 375x1242 frame, for files ~7% larger;
    the pixels are the same). The apps' image artifacts are written so."""
    with open(path, "wb") as f:
        f.write(encode_png(image, filter_type=1, level=1))


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

_NATURAL_ORDER = np.asarray([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_SOF_SEQUENTIAL = (0xC0, 0xC1)
_SOF_ANY = (0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)
_SOF_NAMES = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical sequential",
              0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
              0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
              0xCE: "arithmetic-coded hierarchical progressive",
              0xCF: "arithmetic-coded hierarchical lossless"}


def _next_marker(data: bytes, pos: int) -> Tuple[int, int]:
    """(offset after the marker, marker byte) of the first marker at or
    after ``pos``; garbage and fill bytes before it are skipped, as
    libjpeg's ``next_marker`` does."""
    n = len(data)
    while pos + 1 < n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        while pos + 1 < n and data[pos + 1] == 0xFF:
            pos += 1
        if pos + 1 < n and data[pos + 1] != 0x00:
            return pos + 2, data[pos + 1]
        pos += 2
    raise ValueError("JPEG: the stream ends before its EOI marker")


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.q: Optional[np.ndarray] = None
        self.coefs: Optional[np.ndarray] = None
        self.bw = self.bh = 0       # the component's own blocks a row / column


def decode_jpeg(data: bytes, plain: bool = False) -> np.ndarray:
    """A sequential Huffman JPEG stream → RGB uint8 [H, W, 3]."""
    qt: Dict[int, np.ndarray] = {}
    tables = np.zeros((8, 16 + 256), np.uint8)
    restart, adobe = 0, None
    comps: List[_Component] = []
    height = width = 0
    hmax = vmax = 1
    pos = 2
    while True:
        pos, marker = _next_marker(data, pos)
        if marker == 0xD9:                         # EOI
            break
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        (seglen,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + seglen]
        nxt = pos + seglen
        if marker in _SOF_SEQUENTIAL:
            precision, height, width, nf = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise NotImplementedError(f"{precision}-bit JPEG is not decoded by the port's "
                                          "image codec (8-bit only)")
            if nf not in (1, 3):
                raise NotImplementedError(f"JPEG with {nf} components (CMYK or other) is not "
                                          "decoded by the port's image codec (gray, YCbCr, RGB)")
            comps = [_Component(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15,
                                seg[8 + 3 * i]) for i in range(nf)]
            if not (height and width and all(1 <= c.h <= 4 and 1 <= c.v <= 4 for c in comps)):
                raise ValueError(f"JPEG: bad frame header ({height}x{width}, sampling "
                                 f"{[(c.h, c.v) for c in comps]})")
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                c.coefs = np.zeros((mcuy * c.v, mcux * c.h, 64), np.int16)
                c.bw = -(-(-(-width * c.h // hmax)) // 8)
                c.bh = -(-(-(-height * c.v // vmax)) // 8)
        elif marker in _SOF_ANY:
            raise NotImplementedError(f"{_SOF_NAMES[marker]} JPEG (SOF{marker - 0xC0}) is not "
                                      "decoded by the port's image codec: baseline and "
                                      "extended sequential Huffman only")
        elif marker == 0xC4:                       # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                bits = np.frombuffer(seg[p + 1:p + 17], np.uint8)
                nvals = int(bits.sum())
                if tc > 1 or th > 3 or len(bits) < 16 or nvals > min(256, len(seg) - p - 17):
                    raise ValueError("JPEG: bad Huffman table")
                t = 4 * tc + th
                tables[t] = 0
                tables[t, :16] = bits
                tables[t, 16:16 + nvals] = np.frombuffer(seg[p + 17:p + 17 + nvals], np.uint8)
                p += 17 + nvals
        elif marker == 0xDB:                       # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(seg[p + 1:p + 1 + n], ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[_NATURAL_ORDER] = vals
                qt[tq & 3] = q
                p += 1 + n
        elif marker == 0xDD:                       # DRI
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDA:                       # SOS
            if not comps:
                raise ValueError("JPEG: a scan before the frame header")
            ns = seg[0]
            if not 1 <= ns <= len(comps) or len(seg) != 4 + 2 * ns:
                raise ValueError(f"JPEG: bad scan header ({ns} components)")
            scan = []
            for i in range(ns):
                cid, td_ta = seg[1 + 2 * i], seg[2 + 2 * i]
                c = next((c for c in comps if c.cid == cid), None)
                if c is None or any(c is d for d, _, _ in scan):
                    raise ValueError(f"JPEG: the scan names an unknown or repeated "
                                     f"component {cid}")
                if c.q is None:
                    if c.tq not in qt:
                        raise ValueError(f"JPEG: quantisation table {c.tq} is not defined")
                    c.q = qt[c.tq].copy()             # latched at the component's first scan
                scan.append((c, td_ta >> 4, td_ta & 15))
            ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            if (ss, se, ahal) != (0, 63, 0):
                raise NotImplementedError("progressive JPEG scans are not decoded by the "
                                          "port's image codec")
            for _, td, ta in scan:
                if td > 3 or ta > 3 or not (_huff_table_ok(tables[td], dc=True)
                                            and _huff_table_ok(tables[4 + ta], dc=False)):
                    raise ValueError("JPEG: bad Huffman table")
            info = np.asarray([[c.h, c.v, td, ta, c.coefs.shape[1], c.coefs.shape[0],
                                c.bw, c.bh] for c, td, ta in scan], np.int32)
            run = _scan_plain if plain else host_io.jpeg_scan
            nxt = run(data, nxt, info, [c.coefs for c, _, _ in scan], tables, mcux, mcuy,
                      restart)
        pos = nxt
    if not comps or any(c.q is None for c in comps):
        raise ValueError("JPEG: a component was never scanned")
    planes = [_upsample(_component_pixels(c, plain), c, hmax, vmax, height, width)
              for c in comps]
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    if adobe == 0 or [c.cid for c in comps] == [82, 71, 66]:
        return np.stack(planes, axis=-1)           # stored as RGB
    return _ycc_to_rgb(*planes) if plain else host_io.jpeg_ycc_rgb(*planes)


# -- the plain twin of the host library's scan decoder ------------------------

class _PlainBits:
    def __init__(self, data: bytes, pos: int):
        self.d, self.pos, self.buf, self.n, self.at_marker = data, pos, 0, 0, False

    def _byte(self) -> int:
        d = self.d
        if self.at_marker or self.pos >= len(d):
            return 0
        b = d[self.pos]
        if b == 0xFF:
            if self.pos + 1 < len(d) and d[self.pos + 1] == 0:
                self.pos += 2
                return 0xFF
            self.at_marker = True
            return 0
        self.pos += 1
        return b

    def get(self, n: int) -> int:
        while self.n < n:
            self.buf = (self.buf << 8) | self._byte()
            self.n += 8
        self.n -= n
        v = (self.buf >> self.n) & ((1 << n) - 1)
        self.buf &= (1 << self.n) - 1
        return v


def _huff_table_ok(table: np.ndarray, dc: bool) -> bool:
    """libjpeg's test of a table used in a scan: the codes of each length
    fit in it with no all-ones code, and a DC table's sizes are at most 15
    (the host library refuses the same tables)."""
    code = 0
    for length in range(1, 17):
        code += int(table[length - 1])
        if code >= 1 << length:
            return False
        code <<= 1
    nvals = int(table[:16].sum())
    return nvals <= 256 and not (dc and (table[16:16 + nvals] > 15).any())


def _huff_lookup(table: np.ndarray) -> Dict[Tuple[int, int], int]:
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(int(table[length - 1])):
            out[(length, code)] = int(table[16 + k])
            code += 1
            k += 1
        code <<= 1
    return out


def _decode_symbol(bits: _PlainBits, lut: Dict[Tuple[int, int], int]) -> int:
    code = 0
    for length in range(1, 17):
        code = (code << 1) | bits.get(1)
        if (length, code) in lut:
            return lut[(length, code)]
    raise ValueError("JPEG: corrupt Huffman data")


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _scan_plain(data: bytes, pos: int, info: np.ndarray, coefs, tables: np.ndarray,
                mcux: int, mcuy: int, restart: int) -> int:
    """Python twin of ``host_io.jpeg_scan``, bit by bit."""
    luts = [_huff_lookup(t) for t in tables]
    bits = _PlainBits(data, pos)
    ncomp = len(coefs)
    per_row, total = (info[0, 6], info[0, 6] * info[0, 7]) if ncomp == 1 else \
        (mcux, mcux * mcuy)
    pred = [0] * ncomp
    todo = restart
    for m in range(int(total)):
        if restart and todo == 0:
            p = bits.pos
            while p + 1 < len(data) and not (data[p] == 0xFF and 0xD0 <= data[p + 1] <= 0xD7):
                p += 1
            if p + 1 >= len(data):
                raise ValueError("JPEG: a restart marker is missing")
            bits = _PlainBits(data, p + 2)
            pred = [0] * ncomp
            todo = restart
        my, mx = divmod(m, int(per_row))
        for c in range(ncomp):
            h, v = (1, 1) if ncomp == 1 else (int(info[c, 0]), int(info[c, 1]))
            dc, ac = luts[int(info[c, 2])], luts[4 + int(info[c, 3])]
            for by in range(v):
                for bx in range(h):
                    blk = coefs[c][my * v + by, mx * h + bx]
                    blk[:] = 0
                    s = _decode_symbol(bits, dc)
                    pred[c] += _extend(bits.get(s) if s else 0, s)
                    blk[0] = pred[c]
                    k = 1
                    while k < 64:
                        rs = _decode_symbol(bits, ac)
                        r, sz = rs >> 4, rs & 15
                        if sz:
                            k += r
                            if k > 63:
                                break
                            blk[_NATURAL_ORDER[k]] = _extend(bits.get(sz), sz)
                            k += 1
                        elif r == 15:
                            k += 16
                        else:
                            break
        if restart:
            todo -= 1
    return bits.pos


# -- reconstruction: libjpeg-turbo's islow IDCT, fancy upsampling, colour -------

_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373, f1175=9633,
          f1501=12299, f1847=15137, f1961=16069, f2053=16819, f2562=20995, f3072=25172)
_CONST_BITS, _PASS1_BITS = 13, 2
# the post-IDCT range limit: the sample for x & 1023 (x centred on 0)
_IDCT_LIMIT = np.clip(np.where(np.arange(1024) < 512, np.arange(1024),
                               np.arange(1024) - 1024) + 128, 0, 255).astype(np.uint8)


def _islow_1d(x: Sequence[np.ndarray], shift: int) -> List[np.ndarray]:
    """One pass of ``jpeg_idct_islow`` over the eight inputs of a column
    (or row), descaled by ``shift`` bits with rounding."""
    f = _F
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * f["f0541"]
    tmp2 = z1 - z3 * f["f1847"]
    tmp3 = z1 + z2 * f["f0765"]
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * f["f1175"]
    tmp0, tmp1 = tmp0 * f["f0298"], tmp1 * f["f2053"]
    tmp2, tmp3 = tmp2 * f["f3072"], tmp3 * f["f1501"]
    z1, z2 = z1 * -f["f0899"], z2 * -f["f2562"]
    z3, z4 = z3 * -f["f1961"] + z5, z4 * -f["f0390"] + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4
    r = 1 << (shift - 1)
    return [(v + r) >> shift for v in (tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
                                        tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3)]


def idct_islow(dq: np.ndarray) -> np.ndarray:
    """libjpeg's ``jpeg_idct_islow`` of dequantised blocks int [N, 8, 8]
    (natural order, [vertical][horizontal] frequency) → uint8 [N, 8, 8]."""
    dq = dq.astype(np.int64)
    cols = _islow_1d([dq[:, k, :] for k in range(8)], _CONST_BITS - _PASS1_BITS)
    ws = np.stack(cols, axis=1)                              # [N, row, col]
    rows = _islow_1d([ws[:, :, k] for k in range(8)], _CONST_BITS + _PASS1_BITS + 3)
    return _IDCT_LIMIT[np.stack(rows, axis=2) & 1023]


def _component_pixels(c: _Component, plain: bool) -> np.ndarray:
    """The component's samples over its own blocks: uint8 [bh·8, bw·8]."""
    blocks = c.coefs[:c.bh, :c.bw].reshape(-1, 64)
    if plain:
        px = idct_islow((blocks.astype(np.int64) * c.q).reshape(-1, 8, 8))
    else:
        px = host_io.jpeg_idct(blocks, c.q)
    px = px.reshape(c.bh, c.bw, 8, 8)
    return px.transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)


def _upsample(px: np.ndarray, c: _Component, hmax: int, vmax: int, height: int,
              width: int) -> np.ndarray:
    """A component's samples at the full size [height, width]: libjpeg-turbo's
    fancy upsampling (edges replicated) for 2x1, 1x2 and 2x2, a copy at 1x1."""
    fh, fv = hmax // c.h, vmax // c.v
    if (fh * c.h, fv * c.v) != (hmax, vmax) or fh > 2 or fv > 2:
        raise NotImplementedError(f"JPEG sampling {c.h}x{c.v} of {hmax}x{vmax} is not decoded "
                                  "by the port's image codec (4:4:4, 4:2:2, 4:2:0, 4:4:0)")
    cw, ch = -(-width * c.h // hmax), -(-height * c.v // vmax)
    x = px[:ch, :cw].astype(np.int32)
    if fv == 2:
        above = np.concatenate([x[:1], x[:-1]])
        below = np.concatenate([x[1:], x[-1:]])
        if fh == 2 and cw > 2:                          # h2v2: column sums, then across
            out = np.empty((2 * ch, 2 * cw), np.int32)
            for r0, near in ((0, above), (1, below)):
                s = 3 * x + near
                left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
                right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
                out[r0::2, 0::2] = (3 * s + left + 8) >> 4
                out[r0::2, 1::2] = (3 * s + right + 7) >> 4
            x = out
        elif fh == 2:                                   # narrow: libjpeg's box filter
            x = np.repeat(np.repeat(x, 2, axis=0), 2, axis=1)
        else:                                           # h1v2
            out = np.empty((2 * ch, cw), np.int32)
            out[0::2] = (3 * x + above + 1) >> 2
            out[1::2] = (3 * x + below + 2) >> 2
            x = out
    elif fh == 2:
        if cw > 2:                                      # h2v1
            left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
            right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
            out = np.empty((ch, 2 * cw), np.int32)
            out[:, 0::2] = (3 * x + left + 1) >> 2
            out[:, 1::2] = (3 * x + right + 2) >> 2
            x = out
        else:
            x = np.repeat(x, 2, axis=1)
    return x[:height, :width].astype(np.uint8)


def _fix(v: float) -> int:
    return int(v * (1 << 16) + 0.5)


_CENTRED = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _CENTRED + (1 << 15)) >> 16
_CB_B = (_fix(1.77200) * _CENTRED + (1 << 15)) >> 16
_CR_G = -_fix(0.71414) * _CENTRED
_CB_G = -_fix(0.34414) * _CENTRED + (1 << 15)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's ``ycc_rgb_convert`` tables (16 fraction bits)."""
    yi = y.astype(np.int64)
    r = yi + _CR_R[cr]
    g = yi + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = yi + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)
