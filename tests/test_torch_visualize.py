"""The port's drawing against cv2 5.0 and ``udal_tpu.utils.visualize``.

* ``cv_ops.rectangle`` bit for bit with ``cv2.rectangle`` at thickness 1,
  2 and −1, on hypothesis-drawn corners inside and across the border of
  three small canvases.
* ``cv_ops.get_text_size`` equal to ``cv2.getTextSize`` on
  hypothesis-drawn text at the drawing code's two scales, and its table
  (``ops.text_metrics``) equal to what cv2 measures: ``measure_simplex``
  below made it.
* ``cv_ops.put_text`` bit for bit with ``cv2.putText`` on hypothesis-drawn
  text, origins in and across every edge, colours and backgrounds, and its
  glyph table (``ops.text_glyphs``) equal to what cv2 draws:
  ``measure_glyphs`` below made it. Characters outside printable ASCII:
  control characters and NUL as cv2 draws them, the rest refused. (Run
  this file as a script to print both tables again.)
* ``visualize_boxes_and_labels``, ``overlay_panels``, ``contact_sheet``,
  ``draw_detection_grid`` and ``plot_tfrecord_groundtruth`` against the
  JAX package's on the same seeded inputs, every pixel, label text
  included.
"""

import base64
import zlib

import numpy as np
import pytest

pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from hypothesis import given, settings, strategies as st  # noqa: E402

import udal_tpu.utils.visualize as jax_vis  # noqa: E402
from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu_torch.ops import cv_ops, text_glyphs, text_metrics  # noqa: E402
from udal_tpu_torch.utils import visualize as vis  # noqa: E402

SIZES = [(48, 64), (100, 80), (37, 129)]
PRINTABLE = "".join(chr(c) for c in range(32, 127))
# what cv2 draws as "?" (control characters other than the newline), and NUL, which
# ends the text
CONTROL = "".join(chr(c) for c in list(range(0, 10)) + list(range(11, 32)) + [127])


def measure_simplex(scale: float) -> dict:
    """cv2's FONT_HERSHEY_SIMPLEX metrics at ``scale``, thickness 1: the
    height, each printable character's advance (the width of two of it
    less the width of one) and baseline."""
    font = cv2.FONT_HERSHEY_SIMPLEX
    one = {c: cv2.getTextSize(c, font, scale, 1) for c in PRINTABLE}
    return {"height": one["a"][0][1],
            "advance": [cv2.getTextSize(c * 2, font, scale, 1)[0][0] - one[c][0][0]
                        for c in PRINTABLE],
            "baseline": [one[c][1] for c in PRINTABLE]}


def measure_glyphs(scale: float) -> np.ndarray:
    """cv2's coverage of each printable character at ``scale``, thickness
    1: the character drawn white on black at (20, 30), the ``BOX`` of
    ``ops.text_glyphs`` cut around the origin (every lit pixel inside)."""
    rows, cols = text_glyphs.BOX
    out = np.zeros((len(PRINTABLE), rows, cols), np.uint8)
    for i, ch in enumerate(PRINTABLE):
        img = np.zeros((60, 60, 3), np.uint8)
        cv2.putText(img, ch, (20, 30), cv2.FONT_HERSHEY_SIMPLEX, scale, (255, 255, 255), 1)
        r0, c0 = 30 - text_glyphs.ROW0, 20 - text_glyphs.COL0
        out[i] = img[r0:r0 + rows, c0:c0 + cols, 0]
        assert int(out[i].sum(dtype=np.int64)) == int(img[..., 0].sum(dtype=np.int64)), ch
    return out


def glyph_table_source() -> str:
    """``ops.text_glyphs``' ``_ENCODED`` entries as measured here."""
    lines = []
    for scale in (0.4, 0.45):
        enc = base64.b64encode(zlib.compress(measure_glyphs(scale).tobytes(), 9)).decode()
        body = "\n".join(f'        "{enc[i:i + 88]}"' for i in range(0, len(enc), 88))
        lines.append(f"    {scale}: (\n{body}),")
    return "\n".join(lines)


@pytest.fixture
def jax_drawings(monkeypatch):
    """Each image the JAX package's ``visualize_boxes_and_labels`` returns
    (also from within its other functions), in order."""
    real = jax_vis.visualize_boxes_and_labels
    drawn = []

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        drawn.append(out)
        return out

    monkeypatch.setattr(jax_vis, "visualize_boxes_and_labels", recording)
    return drawn


def assert_same_image(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got != want).reshape(got.shape[0], got.shape[1], -1).any(-1)
    assert not diff.any(), f"{int(diff.sum())} pixels differ"


# -- primitives ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(size=st.sampled_from(SIZES), thickness=st.sampled_from([1, 2, -1]),
       seed=st.integers(0, 2 ** 31 - 1))
def test_rectangle_equals_cv2(size, thickness, seed):
    rng = np.random.RandomState(seed)
    h, w = size
    canvas = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    got, want = canvas.copy(), canvas.copy()
    for _ in range(6):
        x1, x2 = (int(v) for v in rng.randint(-30, w + 30, 2))
        y1, y2 = (int(v) for v in rng.randint(-30, h + 30, 2))
        if rng.rand() < 0.15:
            x2 = x1
        if rng.rand() < 0.15:
            y2 = y1
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        cv2.rectangle(want, (x1, y1), (x2, y2), color, thickness)
        cv_ops.rectangle(got, (x1, y1), (x2, y2), color, thickness)
    np.testing.assert_array_equal(got, want)


@settings(max_examples=60, deadline=None)
@given(text=st.text(alphabet=PRINTABLE + CONTROL, max_size=40),
       scale=st.sampled_from([0.4, 0.45]))
def test_get_text_size_equals_cv2(text, scale):
    assert cv_ops.get_text_size(text, scale, 1) == \
        cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, 1)


def test_text_metrics_are_what_cv2_measures():
    for scale, table in text_metrics.SIMPLEX.items():
        assert measure_simplex(scale) == table
    assert text_metrics.FIRST_CHAR == ord(PRINTABLE[0])
    with pytest.raises(ValueError):
        cv_ops.get_text_size("car", 0.5)
    with pytest.raises(ValueError):
        cv_ops.get_text_size("é", 0.4)


@pytest.mark.parametrize("scale", [0.4, 0.45])
def test_glyph_table_is_what_cv2_draws(scale):
    np.testing.assert_array_equal(text_glyphs.coverage(scale), measure_glyphs(scale))
    assert text_glyphs.FIRST_CHAR == ord(PRINTABLE[0])
    assert text_glyphs.NUM_CHARS == len(PRINTABLE)


@settings(max_examples=150, deadline=None)
@given(size=st.sampled_from(SIZES + [(9, 7)]), text=st.text(alphabet=PRINTABLE + CONTROL,
                                                           max_size=16),
       scale=st.sampled_from([0.4, 0.45]), flat=st.booleans(),
       seed=st.integers(0, 2 ** 31 - 1))
def test_put_text_equals_cv2(size, text, scale, flat, seed):
    """Origins from well left of the canvas to past its right and bottom
    edges, so glyphs are cut at every edge; black, yellow and random
    colours on flat and random backgrounds."""
    rng = np.random.RandomState(seed)
    h, w = size
    canvas = (np.full((h, w, 3), rng.randint(0, 256), np.uint8) if flat
              else rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    org = (int(rng.randint(-60, w + 4)), int(rng.randint(-4, h + 14)))
    color = [(0, 0, 0), (255, 255, 0), tuple(int(c) for c in rng.randint(0, 256, 3))][seed % 3]
    want = canvas.copy()
    cv2.putText(want, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale, color, 1)
    got = cv_ops.put_text(canvas.copy(), text, org, scale, color, 1)
    np.testing.assert_array_equal(got, want)


def test_put_text_outside_printable_ascii():
    """A control character draws cv2's "?" and NUL ends the text, as in
    cv2; a newline (cv2 lays out lines of its own) and characters past
    ASCII (cv2 draws them from its font, which the port does not carry)
    raise."""
    for text in ("a\x01b\x7f", "car\x00 van", "\t"):
        want = np.zeros((20, 60, 3), np.uint8)
        cv2.putText(want, text, (2, 14), cv2.FONT_HERSHEY_SIMPLEX, 0.4, (255, 255, 255), 1)
        got = cv_ops.put_text(np.zeros((20, 60, 3), np.uint8), text, (2, 14), 0.4,
                              (255, 255, 255))
        np.testing.assert_array_equal(got, want)
    for text in ("é", "car\nvan", "车"):
        blank = np.zeros((20, 60, 3), np.uint8)
        cv2.putText(blank, text, (2, 14), cv2.FONT_HERSHEY_SIMPLEX, 0.4, (255, 255, 255), 1)
        assert blank.any()
        with pytest.raises(ValueError, match="printable ASCII"):
            cv_ops.put_text(np.zeros((20, 60, 3), np.uint8), text, (2, 14), 0.4, (0, 0, 0))
    with pytest.raises(ValueError):
        cv_ops.put_text(np.zeros((20, 60, 3), np.uint8), "car", (2, 14), 0.5, (0, 0, 0))


# -- the JAX package's drawing -----------------------------------------------------------

def detections(rng, h, w, n, with_uncert):
    """n boxes around and across the canvas's border, one scoring 0.9."""
    y = rng.uniform(-20, h + 20, (n, 2))
    x = rng.uniform(-20, w + 20, (n, 2))
    boxes = np.stack([y.min(1), x.min(1), y.max(1), x.max(1)], -1).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    scores[:1] = 0.9
    classes = rng.randint(1, 12, n)
    uncert = rng.gamma(2.0, 0.5, (n, 4)) if with_uncert else None
    return boxes, classes, scores, uncert


@settings(max_examples=40, deadline=None)
@given(size=st.sampled_from(SIZES), n=st.integers(1, 8), with_uncert=st.booleans(),
       label_map=st.sampled_from([None, {1: "car", 2: "pedestrian", 7: "tram"}]),
       seed=st.integers(0, 2 ** 31 - 1))
def test_visualize_boxes_and_labels_equals_jax(size, n, with_uncert, label_map, seed):
    rng = np.random.RandomState(seed)
    image = rng.randint(0, 256, size + (3,)).astype(np.uint8)
    boxes, classes, scores, uncert = detections(rng, *size, n, with_uncert)
    want = jax_vis.visualize_boxes_and_labels(image, boxes, classes, scores, label_map, uncert)
    before = image.copy()
    got = vis.visualize_boxes_and_labels(image, boxes, classes, scores, label_map, uncert)
    assert_same_image(got, want)
    np.testing.assert_array_equal(image, before)


@pytest.mark.parametrize("size", SIZES)
def test_overlay_panels_equal_jax(size):
    rng = np.random.RandomState(size[1])
    image = rng.randint(0, 256, size + (3,)).astype(np.uint8)
    boxes, classes, scores, _ = detections(rng, *size, 6, False)
    planes = {"albox": rng.rand(6), "mcbox": None, "mcclass": rng.rand(6),
              "entropy": rng.rand(6), "other": rng.rand(6, 4)}
    want = jax_vis.overlay_panels(image, boxes, classes, scores, planes, min_score_thresh=0.2)
    got = vis.overlay_panels(image, boxes, classes, scores, planes, min_score_thresh=0.2)
    assert list(got) == list(want) == ["", "_mean_albox", "_max_epcls", "_entropy", "_other"]
    for suffix in want:
        assert_same_image(got[suffix], want[suffix])


@pytest.mark.parametrize("cols,thumb_hw,n", [(5, (40, 60), 7), (3, (33, 50), 3), (4, (20, 20), 1)])
def test_contact_sheet_equals_jax(cols, thumb_hw, n):
    """Thumbnails of mixed sizes, RGB and gray, bigger and smaller than
    the thumbnail, with their captions (one longer than the 40 characters
    drawn)."""
    rng = np.random.RandomState(n)
    images = [rng.randint(0, 256, (int(rng.randint(5, 90)), int(rng.randint(5, 90)), 3))
              .astype(np.uint8) for _ in range(n)]
    images[0] = images[0][..., 0]
    labels = [f"img{i}.png {rng.rand():.3g}" for i in range(n)]
    labels[-1] += " uncertainty panel of a long frame name"
    want = jax_vis.contact_sheet(images, cols, thumb_hw, labels)
    got = vis.contact_sheet(images, cols, thumb_hw, labels)
    assert_same_image(got, want)
    assert not np.array_equal(got, vis.contact_sheet(images, cols, thumb_hw))
    np.testing.assert_array_equal(vis.contact_sheet(images, cols, thumb_hw),
                                  jax_vis.contact_sheet(images, cols, thumb_hw))


@pytest.mark.parametrize("grid", [(2, 2), (3, 3), (1, 2)])
def test_draw_detection_grid_equals_jax(grid, jax_drawings):
    rng = np.random.RandomState(sum(grid))
    image = rng.randint(0, 256, (40, 56, 3)).astype(np.uint8)
    cells = []
    for k in range(grid[0] * grid[1]):
        boxes, classes, scores, uncert = detections(rng, 40, 56, 4, k % 2 == 1)
        cells.append(dict(boxes=boxes, classes=classes, scores=scores, uncertainties=uncert,
                          min_score_thresh=0.1 * k))
    want = jax_vis.draw_detection_grid(image, cells, grid)
    got = vis.draw_detection_grid(image, cells, grid)
    assert len(jax_drawings) == len(cells)
    assert_same_image(got, want)


def test_plot_tfrecord_groundtruth_equals_jax(tmp_path, jax_drawings, monkeypatch):
    """The GT plots of a synthetic shard: the same files, whose decoded
    pixels are equal, the labels' text included (the JAX package writes
    BGR through cv2, so its files decode to RGB)."""
    from udal_tpu.data import plot_gt as jax_plot_gt
    from udal_tpu.data.synthetic import write_synthetic_dataset
    from udal_tpu_torch.data import plot_gt
    from udal_tpu_torch.data.image_codec import decode_image

    path = str(tmp_path / "gt.tfrecord")
    write_synthetic_dataset(path, num_images=5, height=48, width=72, num_classes=7, seed=4)
    label_map = {1: "car", 2: "van", 3: "truck"}
    monkeypatch.setattr(jax_plot_gt, "visualize_boxes_and_labels",
                        jax_vis.visualize_boxes_and_labels)
    n_jax = jax_plot_gt.plot_tfrecord_groundtruth(path, str(tmp_path / "jax"), label_map, 4)
    n = plot_gt.plot_tfrecord_groundtruth(path, str(tmp_path / "port"), label_map, 4)
    assert n == n_jax == len(jax_drawings) == 4
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == 4
    for name in names:
        want = cv2.cvtColor(cv2.imread(str(tmp_path / "jax" / name)), cv2.COLOR_BGR2RGB)
        got = decode_image((tmp_path / "port" / name).read_bytes())
        assert_same_image(got, want)


if __name__ == "__main__":
    for s in (0.4, 0.45):
        print(s, measure_simplex(s))
    print(glyph_table_source())
