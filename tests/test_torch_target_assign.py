"""The port's box geometry and target assignment against the JAX package's.

``build_labels`` (and through it ``label_anchors``, batched here, vmapped
there) at 3 seeds x M in {0, 1, 5, 100} groundtruth rows a frame, with
padded rows and a frame with no valid box, on d0's anchors at 256x256
(12,276 anchors): class targets and positives equal, box targets within
1e-5. JAX runs unjitted: jitted, XLA fuses the IoU into a form that rounds
differently by an ulp, and a box that two anchors overlap equally (anchors
placed symmetrically about it) can then force-match the other. JAX cannot
take M = 0 (its argmax over no rows raises), so M = 0 is held against JAX's
labels of one padded row, which mean the same. The IoU family (iou, giou,
diou, ciou), the masked IoU loss, the pairwise IoU and the clip within
1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu import config as jax_config  # noqa: E402
from udal_tpu.data.labels import build_labels as jax_build_labels  # noqa: E402
from udal_tpu.ops import anchors as jax_anchors  # noqa: E402
from udal_tpu.ops import boxes as jax_boxes  # noqa: E402
from udal_tpu.ops import target_assign as jax_ta  # noqa: E402
from udal_tpu_torch import config as torch_config  # noqa: E402
from udal_tpu_torch.data.labels import build_labels  # noqa: E402
from udal_tpu_torch.ops import anchors as anchor_lib  # noqa: E402
from udal_tpu_torch.ops import boxes, target_assign  # noqa: E402

IMAGE, BATCH = 256, 3


def cfgs():
    out = []
    for api in (jax_config, torch_config):
        cfg = api.get_detection_config("efficientdet-d0")
        cfg.override(dict(image_size=IMAGE, num_classes=8))
        out.append(cfg)
    return out


def random_gt(rng, m, batch=BATCH, fill=None):
    """[B, M, 4] boxes (some overlapping, some tiny, some at the border) and
    [B, M] classes 1..7; frame b has ``fill[b]`` valid rows, the rest zero
    padding; the last frame has none."""
    y1 = rng.uniform(0, IMAGE - 20, (batch, m))
    x1 = rng.uniform(0, IMAGE - 20, (batch, m))
    h = rng.uniform(2, 160, (batch, m))
    w = rng.uniform(2, 160, (batch, m))
    gt = np.stack([y1, x1, np.minimum(y1 + h, IMAGE), np.minimum(x1 + w, IMAGE)], -1)
    gt = gt.astype(np.float32)
    cls = rng.randint(1, 8, (batch, m)).astype(np.int32)
    fill = fill if fill is not None else [m, max(m // 2, min(m, 1)), 0][:batch]
    for b, n in enumerate(fill):
        gt[b, n:] = 0.0
        cls[b, n:] = 0
    return gt, cls


def assert_labels_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        w = np.asarray(w)
        assert g.shape == w.shape, k
        if k.startswith("cls_targets"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("m", [1, 5, 100])
def test_build_labels_matches_jax(seed, m):
    jcfg, tcfg = cfgs()
    rng = np.random.RandomState(seed)
    gt, cls = random_gt(rng, m)
    pseudo = rng.uniform(0, 1, cls.shape).astype(np.float32)
    with jax.disable_jit():
        want = jax_build_labels(jcfg, gt, cls, pseudo)
    got = build_labels(tcfg, torch.from_numpy(gt), torch.from_numpy(cls), pseudo)
    assert_labels_equal(got, want)
    assert got["groundtruth_data"].shape == (BATCH, m, 8)
    # every valid groundtruth row is some anchor's match (force match)
    assert float(got["mean_num_positives"][0]) > 0


def test_no_groundtruth_rows_is_all_background():
    jcfg, tcfg = cfgs()
    got = build_labels(tcfg, np.zeros((BATCH, 0, 4), np.float32), np.zeros((BATCH, 0), np.int32))
    want = jax_build_labels(jcfg, np.zeros((BATCH, 1, 4), np.float32),
                            np.zeros((BATCH, 1), np.int32))
    for k in want:
        if k != "groundtruth_data":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["groundtruth_data"].shape == (BATCH, 0, 7)
    assert float(got["mean_num_positives"].sum()) == 0.0


@pytest.mark.parametrize("thresholds", [(0.5, 0.5, True), (0.6, 0.4, True), (0.6, 0.4, False)])
def test_argmax_match_matches_jax(thresholds):
    """Ties (duplicate rows, so two rows share a best anchor: the lowest
    row wins), padded rows and both threshold conventions."""
    matched, unmatched, negatives_lower = thresholds
    rng = np.random.RandomState(7)
    sim = rng.uniform(0, 1, (BATCH, 6, 50)).astype(np.float32)
    sim[:, 3] = sim[:, 1]                            # rows 1 and 3 tie everywhere
    sim[:, :, 10] = sim[:, :, 11]                    # anchors 10 and 11 tie
    valid = np.ones((BATCH, 6), bool)
    valid[1, 4:] = False
    valid[2] = False
    got = target_assign.argmax_match(torch.from_numpy(sim), torch.from_numpy(valid), matched,
                                     unmatched, negatives_lower)
    for b in range(BATCH):
        want = jax_ta.argmax_match(jnp.asarray(sim[b]), jnp.asarray(valid[b]), matched,
                                   unmatched, negatives_lower)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def test_unpack_and_multilevel_labels_match_jax():
    jcfg, tcfg = cfgs()
    gt, cls = random_gt(np.random.RandomState(3), 4, batch=1)
    valid = cls > 0
    j_cls, j_box, j_pos = jax_ta.label_anchors_multilevel(jax_anchors.from_config(jcfg), gt[0],
                                                          cls[0], valid[0])
    p_cls, p_box, p_pos = target_assign.label_anchors_multilevel(
        anchor_lib.from_config(tcfg), torch.from_numpy(gt), torch.from_numpy(cls),
        torch.from_numpy(valid))
    assert sorted(p_cls) == sorted(j_cls)
    for level in j_cls:
        np.testing.assert_array_equal(p_cls[level][0].numpy(), np.asarray(j_cls[level]))
        np.testing.assert_allclose(p_box[level][0].numpy(), np.asarray(j_box[level]),
                                   rtol=1e-5, atol=1e-5)
    assert float(p_pos[0]) == float(j_pos)


def random_box_pairs(rng, n):
    """Aligned predicted and target boxes: overlapping, disjoint, nested,
    degenerate (zero width) and all-zero target rows."""
    def draw():
        y1, x1 = rng.uniform(0, 50, (2, n))
        h, w = rng.uniform(0, 30, (2, n))
        return np.stack([y1, x1, y1 + h, x1 + w], -1)
    pred, tgt = draw(), draw()
    tgt[::5] = 0.0
    pred[1::7, 3] = pred[1::7, 1]
    tgt[2::9] = pred[2::9]
    return pred.astype(np.float32), tgt.astype(np.float32)


@pytest.mark.parametrize("iou_type", ["iou", "giou", "diou", "ciou"])
def test_iou_family_and_loss_match_jax(iou_type):
    pred, tgt = random_box_pairs(np.random.RandomState(4), 64)
    got = boxes.iou_per_anchor(torch.from_numpy(pred), torch.from_numpy(tgt), iou_type)
    want = jax_boxes.iou_per_anchor(jnp.asarray(pred), jnp.asarray(tgt), iou_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # [..., 4k] rows of k boxes
    for shape in ((64, 4), (8, 2, 16)):
        gl = boxes.iou_loss(torch.from_numpy(pred.reshape(shape)),
                            torch.from_numpy(tgt.reshape(shape)), iou_type)
        wl = jax_boxes.iou_loss(jnp.asarray(pred.reshape(shape)),
                                jnp.asarray(tgt.reshape(shape)), iou_type)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-6, atol=1e-6)


def test_pairwise_iou_and_clip_match_jax():
    pred, tgt = random_box_pairs(np.random.RandomState(5), 40)
    got = boxes.pairwise_iou(torch.from_numpy(pred), torch.from_numpy(tgt[:17]))
    want = jax_boxes.pairwise_iou(jnp.asarray(pred), jnp.asarray(tgt[:17]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    big = pred * 3 - 20
    np.testing.assert_array_equal(boxes.clip_boxes(torch.from_numpy(big), (64, 96)).numpy(),
                                  np.asarray(jax_boxes.clip_boxes(jnp.asarray(big), (64, 96))))
