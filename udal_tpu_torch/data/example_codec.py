"""tf.train.Example protobuf wire-format codec (no TensorFlow dependency).

The port's copy of ``udal_tpu/data/example_codec.py``: parses and
serializes the subset of the tf.Example schema the detection pipeline uses
(the reference's decoder and dataset writers' feature keys):

  image/encoded (bytes), image/source_id, image/height, image/width,
  image/filename, image/format, image/object/bbox/{xmin,xmax,ymin,ymax}
  (float lists, normalized), image/object/class/{label,text},
  image/object/area, image/object/is_crowd, image/object/pseudo_score.

Written directly on the protobuf wire format:

  Example       = { 1: Features }
  Features      = { 1: map<string, Feature> }  (map entry: 1=key, 2=value)
  Feature       = { 1: BytesList | 2: FloatList | 3: Int64List }
  BytesList     = { 1: repeated bytes }
  FloatList     = { 1: repeated float (packed) }
  Int64List     = { 1: repeated int64 (packed or not) }
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterable, List, Tuple, Union

FeatureValue = Union[List[bytes], List[float], List[int]]


# ---------------------------------------------------------------------------
# Wire-format primitives
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _iter_fields(buf: bytes) -> Iterable[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:            # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:          # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:          # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:          # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

def _parse_feature(buf: bytes) -> FeatureValue:
    for field, wire, val in _iter_fields(buf):
        if field == 1:       # BytesList
            return [v for f, w, v in _iter_fields(val) if f == 1]
        if field == 2:       # FloatList
            floats: List[float] = []
            for f, w, v in _iter_fields(val):
                if f != 1:
                    continue
                if w == 2:   # packed
                    floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
                else:        # single 32-bit
                    floats.append(struct.unpack("<f", v)[0])
            return floats
        if field == 3:       # Int64List
            ints: List[int] = []
            for f, w, v in _iter_fields(val):
                if f != 1:
                    continue
                if w == 2:   # packed varints
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        ints.append(x - (1 << 64) if x >= (1 << 63) else x)
                else:
                    ints.append(v - (1 << 64) if v >= (1 << 63) else v)
            return ints
    return []


def parse_example(record: bytes) -> Dict[str, FeatureValue]:
    """Parse a serialized tf.train.Example into {key: list-of-values}."""
    features: Dict[str, FeatureValue] = {}
    for field, _, val in _iter_fields(record):
        if field != 1:       # Features
            continue
        for f2, _, entry in _iter_fields(val):
            if f2 != 1:      # map entry
                continue
            key = None
            fval: FeatureValue = []
            for f3, _, v3 in _iter_fields(entry):
                if f3 == 1:
                    key = v3.decode("utf-8")
                elif f3 == 2:
                    fval = _parse_feature(v3)
            if key is not None:
                features[key] = fval
    return features


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------

def _ld(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, (field << 3) | 2)
    _write_varint(out, len(payload))
    out.extend(payload)


def _encode_feature(value: FeatureValue) -> bytes:
    inner = bytearray()
    out = bytearray()
    if not value:
        # encode as empty bytes list
        _ld(out, 1, b"")
        return bytes(out)
    first = value[0]
    if isinstance(first, (bytes, str)):
        for v in value:
            if isinstance(v, str):
                v = v.encode("utf-8")
            _ld(inner, 1, v)
        _ld(out, 1, bytes(inner))
    elif isinstance(first, float):
        packed = struct.pack(f"<{len(value)}f", *value)
        _ld(inner, 1, packed)
        _ld(out, 2, bytes(inner))
    elif isinstance(first, (int,)):
        buf = bytearray()
        for v in value:
            _write_varint(buf, v & ((1 << 64) - 1) if v < 0 else v)
        _ld(inner, 1, bytes(buf))
        _ld(out, 3, bytes(inner))
    else:
        raise TypeError(f"unsupported feature value type {type(first)}")
    return bytes(out)


def serialize_example(features: Dict[str, FeatureValue]) -> bytes:
    """Serialize {key: list} into a tf.train.Example wire message."""
    fmap = bytearray()
    for key, value in features.items():
        entry = bytearray()
        _ld(entry, 1, key.encode("utf-8"))
        _ld(entry, 2, _encode_feature(value))
        _ld(fmap, 1, bytes(entry))
    out = bytearray()
    _ld(out, 1, bytes(fmap))
    return bytes(out)


# ---------------------------------------------------------------------------
# Detection-schema helpers
# ---------------------------------------------------------------------------

def bytes_feature(v: Union[bytes, str]) -> List[bytes]:
    return [v.encode("utf-8") if isinstance(v, str) else v]


def int64_feature(v: int) -> List[int]:
    return [int(v)]


def float_list_feature(v: Iterable[float]) -> List[float]:
    return [float(x) for x in v]


def int64_list_feature(v: Iterable[int]) -> List[int]:
    return [int(x) for x in v]


def bytes_list_feature(v: Iterable[Union[bytes, str]]) -> List[bytes]:
    return [x.encode("utf-8") if isinstance(x, str) else x for x in v]
