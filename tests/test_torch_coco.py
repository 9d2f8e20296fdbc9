"""The port's COCO evaluator against ``udal_tpu.eval.coco``: random
detections and groundtruth (crowd rows, padded rows, empty images, ties
in score) give the same ``result()`` to 1e-12, on the COCO grid and the
fine 0.05 grid, with and without a label map."""

import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu.eval.coco import COCOEvaluator as JaxEvaluator  # noqa: E402
from udal_tpu_torch.eval.coco import COCOEvaluator  # noqa: E402


def batches(seed, n_batches=3, b=4, m=6, k=20, classes=4):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_batches):
        gt = np.zeros((b, m, 7))
        det = np.zeros((b, k, 7))
        for j in range(b):
            n = rng.randint(0, m + 1)
            y1, x1 = rng.uniform(0, 200, (2, n))
            hh, ww = rng.uniform(5, 120, (2, n))
            gt[j, :n] = np.stack([y1, x1, y1 + hh, x1 + ww, rng.rand(n) < 0.15, hh * ww,
                                  rng.randint(1, classes + 1, n)], axis=1)
            # detections: jittered groundtruth and clutter, some scores tied
            src = gt[j, rng.randint(0, max(n, 1), k)] if n else np.zeros((k, 7))
            jit = rng.normal(0, 6, (k, 4))
            y, x = src[:, 0] + jit[:, 0], src[:, 1] + jit[:, 1]
            h, w = np.abs(src[:, 2] - src[:, 0] + jit[:, 2]) + 1, \
                np.abs(src[:, 3] - src[:, 1] + jit[:, 3]) + 1
            scores = np.round(rng.rand(k), 2)
            cls = np.where(rng.rand(k) < 0.8, src[:, 6], rng.randint(1, classes + 1, k))
            det[j] = np.stack([np.full(k, i * b + j), x, y, w, h, scores,
                               np.where(src[:, 6] > 0, cls, 0)], axis=1)
        out.append((gt, det))
    return out


@pytest.mark.parametrize("fine_grid", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_result_equals_jax(fine_grid, seed):
    label_map = {1: "car", 2: "van", 3: "truck"} if seed else None
    port = COCOEvaluator(label_map=label_map, fine_grid=fine_grid)
    ref = JaxEvaluator(label_map=label_map, fine_grid=fine_grid)
    for gt, det in batches(seed):
        port.update_state(gt, det)
        ref.update_state(gt, det)
    got, want = port.result(), ref.result()
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert 0.0 <= got["AP"] <= 1.0
