"""The port's TFRecord framing and tf.Example codec against the JAX
package's (``udal_tpu/data/tfrecord.py``, ``example_codec.py``).

- The port's writer writes the JAX writer's bytes for the same records;
  each side reads the other's files (scan, read at an offset, iterate,
  index).
- The host library's CRC32C (``csrc/host_io.cc``) and its Python twin
  equal ``udal_tpu.data.tfrecord.crc32c`` (exactly) on random bytes and the
  CRC32C check value of "123456789".
- A corrupt data checksum is refused with ``verify_crc``; a corrupt length
  checksum or a truncated file on every scan.
- ``parse_example`` / ``serialize_example`` equal the JAX codec's (bytes
  and values) on a detection example.
"""


import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("torch")

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu.data import example_codec as jax_codec  # noqa: E402
from udal_tpu.data import tfrecord as jax_tfr  # noqa: E402
from udal_tpu_torch.data import example_codec as codec  # noqa: E402
from udal_tpu_torch.data import tfrecord as tfr  # noqa: E402


def records(seed, n=6):
    rng = np.random.RandomState(seed)
    return [rng.bytes(int(k)) for k in rng.randint(0, 3000, n)] + [b"", b"x" * 70000]


def test_crc32c_check_value_and_twins_equal_jax():
    assert tfr.crc32c(b"123456789") == tfr.crc32c_plain(b"123456789") == 0xE3069283
    rng = np.random.RandomState(0)
    for n in (0, 1, 7, 8, 9, 63, 64, 1000, 65537):
        data = rng.bytes(n)
        assert tfr.crc32c(data) == tfr.crc32c_plain(data) == jax_tfr.crc32c(data)


@settings(max_examples=30, deadline=None)
@given(st.binary(min_size=0, max_size=200))
def test_crc32c_equals_jax_on_drawn_bytes(data):
    assert tfr.crc32c(data) == jax_tfr.crc32c(data) == tfr.crc32c_plain(data)


def test_writer_bytes_equal_and_each_reads_the_other(tmp_path):
    recs = records(1)
    port, jax_path = str(tmp_path / "port.tfrecord"), str(tmp_path / "jax.tfrecord")
    with tfr.TFRecordWriter(port) as w:
        for r in recs:
            w.write(r)
    with jax_tfr.TFRecordWriter(jax_path) as w:
        for r in recs:
            w.write(r)
    assert open(port, "rb").read() == open(jax_path, "rb").read()
    for path in (port, jax_path):
        offs, lens = tfr.scan_tfrecord(path, verify_crc=True)
        j_offs, j_lens = jax_tfr.scan_tfrecord(path, verify_crc=True)
        np.testing.assert_array_equal(offs, j_offs)
        np.testing.assert_array_equal(lens, j_lens)
        assert [tfr.read_record(path, o, n) for o, n in zip(offs, lens)] == recs
        assert list(tfr.iterate_tfrecord(path)) == list(jax_tfr.iterate_tfrecord(path)) == recs
    index = tfr.TFRecordIndex([port, jax_path])
    assert len(index) == 2 * len(recs)
    assert [index[i] for i in range(len(index))] == recs + recs
    assert tfr.TFRecordIndex.from_pattern(str(tmp_path / "*.tfrecord"))[len(recs)] == recs[0]
    with pytest.raises(FileNotFoundError):
        tfr.TFRecordIndex.from_pattern(str(tmp_path / "none-*.tfrecord"))


def test_corrupt_records_are_refused(tmp_path):
    path = str(tmp_path / "c.tfrecord")
    with tfr.TFRecordWriter(path) as w:
        for r in records(2, 3):
            w.write(r)
    data = bytearray(open(path, "rb").read())
    offs, _ = tfr.scan_tfrecord(path)
    bad_data = bytearray(data)
    bad_data[offs[1] + 2] ^= 0x40                  # a payload byte
    open(path, "wb").write(bytes(bad_data))
    tfr.scan_tfrecord(path)                        # the lengths still check out
    with pytest.raises(IOError, match="data checksum"):
        tfr.scan_tfrecord(path, verify_crc=True)
    with pytest.raises(IOError):
        jax_tfr.scan_tfrecord(path, verify_crc=True)
    bad_len = bytearray(data)
    bad_len[offs[1] - 4] ^= 0x01                   # the second record's length checksum
    open(path, "wb").write(bytes(bad_len))
    with pytest.raises(IOError, match="length checksum"):
        tfr.scan_tfrecord(path)
    open(path, "wb").write(bytes(data[:-3]))       # truncated
    with pytest.raises(IOError, match="truncated"):
        tfr.scan_tfrecord(path)


def detection_features():
    return {
        "image/encoded": codec.bytes_feature(b"\x89PNG" + bytes(range(256))),
        "image/format": codec.bytes_feature("png"),
        "image/height": codec.int64_feature(375),
        "image/width": codec.int64_feature(1242),
        "image/filename": codec.bytes_feature("000042.png"),
        "image/source_id": codec.bytes_feature("42"),
        "image/object/bbox/ymin": codec.float_list_feature([0.1, 0.25]),
        "image/object/bbox/xmin": codec.float_list_feature([0.3, 0.5]),
        "image/object/bbox/ymax": codec.float_list_feature([0.6, 0.75]),
        "image/object/bbox/xmax": codec.float_list_feature([0.9, 0.55]),
        "image/object/class/label": codec.int64_list_feature([1, 7]),
        "image/object/class/text": codec.bytes_list_feature(["car", "tram"]),
        "image/object/difficult": codec.int64_list_feature([0, -3]),
        "image/object/pseudo_score": codec.float_list_feature([0.5, 0.875]),
        "empty": [],
    }


def test_example_codec_equals_jax():
    feats = detection_features()
    data = codec.serialize_example(feats)
    assert data == jax_codec.serialize_example(feats)
    assert codec.parse_example(data) == jax_codec.parse_example(data)
    parsed = codec.parse_example(data)
    assert parsed["image/object/difficult"] == [0, -3]
    assert parsed["image/object/class/text"] == [b"car", b"tram"]
    assert parsed["image/height"] == [375]
    assert codec.bytes_feature("a") == jax_codec.bytes_feature("a")
    assert codec.int64_list_feature(np.arange(3)) == jax_codec.int64_list_feature(np.arange(3))
