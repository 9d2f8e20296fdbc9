"""The port's image codec and resize against cv2 (the dev box has cv2 and
PIL; the machine with the card has neither).

- PNG decode equals ``cv2.imdecode(IMREAD_COLOR)`` + BGR→RGB bit for bit:
  hypothesis-drawn sizes (odd widths included), gray / RGB / RGBA, each
  filter type forced on every row by the port's encoder, a random filter
  a row, libpng's own (cv2-encoded) files, and palette files (PIL).
- cv2 decodes the port's PNG encode back to the input.
- JPEG decode equals cv2's decode of ``cv2.imencode(".jpg")`` bit for bit:
  qualities 50 / 90 / 95, sampling 4:2:0 / 4:2:2 / 4:4:4 / 4:4:0, gray,
  restart intervals, sizes that are not multiples of 16 (tolerance 0:
  the decoder follows libjpeg-turbo's islow IDCT, fancy upsampling and
  colour tables).
- The host library's loops (PNG un-filtering, the JPEG scan's Huffman
  decode, the IDCT, YCbCr→RGB) equal their numpy / Python twins exactly.
- ``resize_bilinear_uint8`` equals ``cv2.resize(INTER_LINEAR)`` bit for
  bit (numpy and torch paths), up and down, the reader's KITTI 1242x375 →
  1024x309 case included; ``resize_bilinear_float`` within 1e-6 of cv2's
  f32 resize (values up to ~2.6 in size: a few f32 ulps; cv2 sums in f32).
- Interlaced PNG, progressive JPEG and 16-bit PNG raise
  ``NotImplementedError``; the size helper reads both headers.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu_torch.data import host_io  # noqa: E402
from udal_tpu_torch.data import image_codec as ic  # noqa: E402
from udal_tpu_torch.ops.image_ops import (resize_bilinear_float,  # noqa: E402
                                          resize_bilinear_uint8)

SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def cv2_decode(data: bytes) -> np.ndarray:
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


def textured(rng, h, w, c=3):
    """Smooth colour fields with pixel noise and a flat box: compresses
    like a photograph, exercises every filter's prediction."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * (k + 3) + yy * (7 - k)) % 256 for k in range(c)], axis=-1)
    img = np.clip(base + rng.randint(-12, 12, (h, w, c)), 0, 255).astype(np.uint8)
    img[h // 4:h // 2 + 1, w // 3:w // 2 + 1] = rng.randint(0, 256, c)
    return img


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 41), channels=st.sampled_from([1, 3, 4]),
       filt=st.sampled_from([None, 0, 1, 2, 3, 4, "mixed"]), seed=st.integers(0, 2**16))
def test_png_decode_equals_cv2(h, w, channels, filt, seed):
    rng = np.random.RandomState(seed)
    img = textured(rng, h, w, channels)
    if filt == "mixed":
        filt = rng.randint(0, 5, h)
    data = ic.encode_png(img[..., 0] if channels == 1 else img, filt)
    got = ic.decode_image(data)
    assert np.array_equal(got, cv2_decode(data))
    assert np.array_equal(got, ic.decode_image(data, plain=True))
    # cv2 reads the port's encode back to the input (RGB order kept)
    back = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if channels == 3:
        back = cv2.cvtColor(back, cv2.COLOR_BGR2RGB)
    elif channels == 4:
        back = cv2.cvtColor(back, cv2.COLOR_BGRA2RGBA)
    assert np.array_equal(back.reshape(img.shape), img)
    assert ic.image_size(data) == (h, w)


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_each_png_filter_on_every_row(filt):
    img = textured(np.random.RandomState(filt), 23, 37)
    data = ic.encode_png(img, filt)
    raw = zlib.decompress(data[data.index(b"IDAT") + 4:])
    assert set(raw[::37 * 3 + 1]) == {filt}
    assert np.array_equal(ic.decode_image(data), cv2_decode(data))
    assert np.array_equal(ic.decode_image(data), img)


def test_libpng_files_and_palette_images_decode_as_cv2():
    pil = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(3)
    for shape in ((31, 17, 3), (8, 64, 4), (19, 5)):
        img = textured(rng, shape[0], shape[1], shape[2] if len(shape) == 3 else 1)
        img = img if len(shape) == 3 else img[..., 0]
        for level in (0, 1, 9):
            ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, level])
            assert np.array_equal(ic.decode_image(buf.tobytes()), cv2_decode(buf.tobytes()))
    for colors in (2, 16, 256):
        p = pil.fromarray(textured(rng, 21, 33)).quantize(colors)
        out = io.BytesIO()
        p.save(out, format="PNG", bits=8)
        data = out.getvalue()
        assert np.array_equal(ic.decode_image(data), cv2_decode(data))


def natural(rng, h, w):
    low = rng.randint(0, 255, (max(2, h // 16), max(2, w // 16), 3), np.uint8)
    img = cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(img.astype(np.int16) + rng.randint(-8, 8, img.shape), 0, 255).astype(np.uint8)


def jpeg(img, quality=90, sampling="420", restart=0, progressive=False):
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
                                         cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("quality", [50, 90, 95])
@pytest.mark.parametrize("sampling", ["420", "422", "444", "440"])
def test_jpeg_decode_equals_cv2(quality, sampling):
    rng = np.random.RandomState(quality)
    for h, w in ((48, 64), (37, 53), (17, 9), (1, 1), (3, 2), (100, 130)):
        for restart in (0, 2):
            data = jpeg(natural(rng, h, w), quality, sampling, restart)
            got = ic.decode_image(data)
            assert np.array_equal(got, cv2_decode(data)), (h, w, restart)
            assert ic.image_size(data) == (h, w)


def test_jpeg_gray_and_the_plain_twins():
    rng = np.random.RandomState(7)
    for h, w in ((48, 64), (37, 53), (9, 30)):
        data = jpeg(natural(rng, h, w)[..., 1], 90)
        assert np.array_equal(ic.decode_image(data), cv2_decode(data))
        assert np.array_equal(ic.decode_image(data, plain=True), cv2_decode(data))
    for sampling in ("420", "422", "444"):
        data = jpeg(natural(rng, 29, 43), 75, sampling, restart=3)
        assert np.array_equal(ic.decode_image(data, plain=True), ic.decode_image(data))


def test_host_loops_equal_their_twins():
    rng = np.random.RandomState(11)
    raw = rng.randint(0, 256, (12, 3 * 10 + 1)).astype(np.uint8)
    raw[:, 0] = np.arange(12) % 5
    assert np.array_equal(host_io.png_unfilter(raw.reshape(-1), 12, 30, 3),
                          ic._unfilter_plain(raw.reshape(-1), 12, 30, 3))
    raw[5, 0] = 9
    with pytest.raises(ValueError, match="row 5"):
        host_io.png_unfilter(raw.reshape(-1), 12, 30, 3)
    coefs = rng.randint(-300, 300, (50, 64)).astype(np.int16)
    coefs[::3, 1:] = 0                                    # DC-only blocks
    q = rng.randint(1, 60, 64).astype(np.int32)
    assert np.array_equal(host_io.jpeg_idct(coefs, q),
                          ic.idct_islow((coefs.astype(np.int64) * q).reshape(-1, 8, 8)))
    y, cb, cr = (rng.randint(0, 256, (7, 9)).astype(np.uint8) for _ in range(3))
    assert np.array_equal(host_io.jpeg_ycc_rgb(y, cb, cr), ic._ycc_to_rgb(y, cb, cr))


def test_unsupported_files_raise():
    img = textured(np.random.RandomState(0), 16, 16)
    data = bytearray(ic.encode_png(img))
    ihdr = data.index(b"IHDR")
    data[ihdr + 16] = 1                                   # interlace method: Adam7
    data[ihdr + 17:ihdr + 21] = struct.pack(">I", zlib.crc32(bytes(data[ihdr:ihdr + 17])))
    with pytest.raises(NotImplementedError, match="interlaced"):
        ic.decode_image(bytes(data))
    ok, buf16 = cv2.imencode(".png", img.astype(np.uint16) * 257)
    with pytest.raises(NotImplementedError, match="bit depth 16"):
        ic.decode_image(buf16.tobytes())
    with pytest.raises(NotImplementedError, match="progressive"):
        ic.decode_image(jpeg(natural(np.random.RandomState(1), 24, 24), progressive=True))
    with pytest.raises(ValueError):
        ic.decode_image(b"GIF89a")


def _huffman_tables(data: bytes):
    """The offset of each Huffman table (its class/index byte) in a JPEG."""
    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        (seglen,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if data[pos + 1] == 0xC4:
            p = pos + 4
            while p < pos + 2 + seglen:
                out.append(p)
                p += 17 + sum(data[p + 1:p + 17])
        pos += 2 + seglen
    return out


@pytest.mark.parametrize("fault", ["dc_oversubscribed", "ac_oversubscribed", "dc_size_20",
                                   "ac_all_ones_code"])
def test_corrupt_huffman_tables_raise(fault):
    """A table libjpeg refuses ("Bogus Huffman table") raises ValueError in
    both decoders, before any code of it is used, and cv2 refuses it too."""
    data = bytearray(jpeg(natural(np.random.RandomState(3), 24, 40), 90))
    tables = {data[p] >> 4: p for p in reversed(_huffman_tables(bytes(data)))}
    p = tables[1 if fault.startswith("ac") else 0]
    bits = list(data[p + 1:p + 17])
    if fault.endswith("oversubscribed"):                  # two codes of length 1
        i = next(i for i in range(1, 16) if bits[i] >= 2)
        bits[0], bits[i] = bits[0] + 2, bits[i] - 2
    elif fault == "ac_all_ones_code":                     # a code of length 16 more
        last = max(i for i in range(16) if bits[i])
        bits[last] -= 1
        bits[15] += 2
        data[p + 17 + sum(bits) - 1:p + 17 + sum(bits) - 1] = b"\x01"
        (seglen,) = struct.unpack(">H", data[p - 2:p])
        data[p - 2:p] = struct.pack(">H", seglen + 1)
    else:
        data[p + 17] = 20                                 # a DC size of 20 bits
    data[p + 1:p + 17] = bytes(bits)
    data = bytes(data)
    assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
    for plain in (False, True):
        with pytest.raises(ValueError, match="bad Huffman table"):
            ic.decode_image(data, plain=plain)


def test_host_scan_refuses_bad_tables_and_headers():
    """The host library checks what the parser checks: a table that would
    overrun its lookahead or a DC size past 15 bits, a table index past 3,
    more than four components."""
    coefs = [np.zeros((2, 2, 64), np.int16)]
    info = np.asarray([[1, 1, 0, 0, 2, 2, 2, 2]], np.int32)
    good = np.zeros((8, 272), np.uint8)
    good[:, 1] = 2                                        # codes 00 and 01 ...
    good[:, 16:18] = [0, 1]                               # ... sizes 0 and 1
    data = b"\x00" * 64 + b"\xff\xd9"
    assert host_io.jpeg_scan(data, 0, info, coefs, good, 2, 2, 0) >= 0
    over = good.copy()
    over[0, :3] = [2, 1, 0]                               # 0, 1, then 100 > 2 bits
    dc20 = good.copy()
    dc20[0, 17] = 20
    for tables, comps in ((over, info), (dc20, info), (good, info + [[0, 0, 4, 0] + [0] * 4]),
                          (good, np.repeat(info, 5, axis=0))):
        with pytest.raises(ValueError, match="bad Huffman table"):
            host_io.jpeg_scan(data, 0, comps, coefs * len(comps), tables, 2, 2, 0)


KITTI = [(375, 1242, 309, 1024), (375, 1242, 512, 1024)]


@settings(max_examples=30, deadline=None)
@given(h=st.integers(1, 60), w=st.integers(1, 60), oh=st.integers(1, 90),
       ow=st.integers(1, 90), channels=st.sampled_from([None, 1, 3, 4]),
       seed=st.integers(0, 2**16))
def test_resize_equals_cv2(h, w, oh, ow, channels, seed):
    shape = (h, w) if channels is None else (h, w, channels)
    img = np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)
    want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR).reshape((oh, ow) + shape[2:])
    assert np.array_equal(resize_bilinear_uint8(img, (oh, ow)), want)
    assert np.array_equal(resize_bilinear_uint8(torch.from_numpy(img), (oh, ow)).numpy(), want)


@pytest.mark.parametrize("h,w,oh,ow", KITTI + [(100, 100, 50, 50), (64, 48, 128, 96)])
def test_resize_equals_cv2_at_the_readers_sizes(h, w, oh, ow):
    rng = np.random.RandomState(h + oh)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
    assert np.array_equal(resize_bilinear_uint8(img, (oh, ow)), want)
    assert np.array_equal(resize_bilinear_uint8(torch.from_numpy(img), (oh, ow)).numpy(), want)
    norm = ((img.astype(np.float32) - 120.0) / 58.0).astype(np.float32)
    want_f = cv2.resize(norm, (ow, oh), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(resize_bilinear_float(norm, (oh, ow)), want_f, rtol=0, atol=1e-6)


def test_committed_jpeg_fixtures_decode_to_cv2s_hashes():
    """The 1280x720 fixtures ``chip_smoke.py`` decodes on the card: the
    port's decode hashes to the committed sha256 of cv2's, and so does
    cv2's own decode here."""
    import hashlib
    import json
    import pathlib

    folder = pathlib.Path(__file__).resolve().parent / "data" / "torch_jpeg"
    hashes = json.loads((folder / "hashes.json").read_text())
    assert len(hashes) == 3
    for name, digest in hashes.items():
        data = (folder / name).read_bytes()
        assert ic.image_size(data) == (720, 1280)
        assert hashlib.sha256(ic.decode_image(data).tobytes()).hexdigest() == digest
        assert hashlib.sha256(cv2_decode(data).tobytes()).hexdigest() == digest
