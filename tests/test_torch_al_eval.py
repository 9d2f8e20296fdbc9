"""The port's AL-set similarity (``udal_tpu_torch/apps/al_eval.py``)
against ``udal_tpu.apps.al_eval`` on the same crops and samples.

The crop statistics' histogram is cv2's ``calcHist`` counts (equal), the
DCT mean comes from the gray crop resized in f32 by cv2's INTER_LINEAR
(``resize_bilinear_float``, within 1e-6 of cv2's, so the means agree to
1e-5); everything downstream is the same numpy and scipy: the
similarities and the KL / JSD estimators to 1e-9 relative (1e-5 where
they take the DCT means). The eval-config rewrite is read back by both
YAML readers; the metrics scrape reads the port's ``metrics.jsonl``.
"""

import json

import numpy as np
import pytest
import yaml

pytest.importorskip("torch")

import udal_tpu.apps.al_eval as jax_eval  # noqa: E402
from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu_torch.apps import al_eval  # noqa: E402
from udal_tpu_torch.config import load_yaml  # noqa: E402
from udal_tpu_torch.utils.metrics_writer import MetricsWriter  # noqa: E402


def samples(seed, n=6, classes=(1, 2, 3)):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img = rng.randint(0, 256, (90, 120, 3)).astype(np.uint8)
        k = rng.randint(2, 6)
        y1, x1 = rng.randint(0, 60, k), rng.randint(0, 80, k)
        boxes = np.stack([y1, x1, y1 + rng.randint(2, 30, k), x1 + rng.randint(2, 40, k)], -1)
        out.append((img, boxes.astype(np.float32), [int(c) for c in rng.choice(classes, k)]))
    return out


def test_crop_statistics_and_collected_metrics_equal_jax():
    for image, boxes, classes in samples(0):
        for box in list(boxes) + [np.asarray([5, 5, 5, 5]), np.asarray([-3, 80, 40, 200])]:
            got, want = al_eval.crop_statistics(image, box), jax_eval.crop_statistics(image, box)
            assert got["aspect"] == want["aspect"]
            np.testing.assert_array_equal(got["hist"], want["hist"])
            np.testing.assert_allclose(got["dct_mean"], want["dct_mean"], rtol=1e-5)
    got, want = al_eval.collect_metrics(samples(1)), jax_eval.collect_metrics(samples(1))
    assert sorted(got) == sorted(want)
    for c in want:
        assert got[c]["aspect"] == want[c]["aspect"]
        np.testing.assert_allclose(got[c]["dct"], want[c]["dct"], rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(got[c]["hist"]), np.asarray(want[c]["hist"]))
    sim = al_eval.calculate_set_similarity(got, al_eval.collect_metrics(samples(2)))
    jsim = jax_eval.calculate_set_similarity(want, jax_eval.collect_metrics(samples(2)))
    np.testing.assert_allclose(sim, jsim, rtol=1e-5)


def test_crop_metrics_kl_jsd_and_full_similarity_equal_jax():
    classes = [1, 2, 3, 4]
    sets = [samples(s, n=8) for s in (3, 4, 5)]
    got = [al_eval.collect_crop_metrics(s, classes) for s in sets]
    want = [jax_eval.collect_crop_metrics(s, classes) for s in sets]
    for g, w in zip(got, want):
        for c in classes:
            assert len(g[c]) == len(w[c])
            for a, b in zip(g[c], w[c]):
                np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(6)
    p, q = rng.rand(40, 3) + 0.1, rng.rand(50, 3) + 0.2
    assert al_eval.emp_kl_divergence(p, q) == jax_eval.emp_kl_divergence(p, q)
    assert al_eval.empirical_jsd(p, q, num_samples=300) == \
        jax_eval.empirical_jsd(p, q, num_samples=300)
    ranked, act, per = al_eval.calculate_set_similarity_full(got, classes, ["a", "b"], True,
                                                              num_samples=300)
    jranked, jact, jper = jax_eval.calculate_set_similarity_full(want, classes, ["a", "b"], True,
                                                                  num_samples=300)
    assert [m for m, _ in ranked] == [m for m, _ in jranked] and act == jact
    np.testing.assert_allclose([v for _, v in ranked], [v for _, v in jranked], rtol=1e-9)
    np.testing.assert_allclose(np.asarray(per, float), np.asarray(jper, float), rtol=1e-9)
    sims, aps = {"a": 0.3, "b": 0.5, "c": 0.1}, {"a": 20.0, "b": 31.0, "c": 5.0}
    assert al_eval.rank_correlation(sims, aps) == jax_eval.rank_correlation(sims, aps)


def test_eval_config_metrics_and_similarity_run(tmp_path):
    src = "configs/eval/eval_k.yaml"
    for name, count in ((None, 0), ("B", 25)):
        got, want = tmp_path / "port.yaml", tmp_path / "jax.yaml"
        for path in (got, want):
            path.write_text(open(src).read())
        al_eval.update_eval_config(str(got), "models/x", name, count)
        jax_eval.update_eval_config(str(want), "models/x", name, count)
        with open(want) as f:
            wanted = yaml.safe_load(f)
        assert load_yaml(str(got)) == wanted
        with open(got) as f:
            assert yaml.safe_load(f) == wanted
    logs = tmp_path / "m" / "logs"
    writer = MetricsWriter(str(logs))
    writer.write(1, {"loss": 2.5, "val_loss": 3.0})
    writer.write(2, {"loss": 2.0, "AP": 0.25})
    writer.close()
    with open(logs / "metrics.jsonl", "a") as f:
        f.write("not json\n")
    assert al_eval.extract_eval_metrics(str(logs)) == jax_eval.extract_eval_metrics(str(logs)) \
        == {"loss": 2.0, "val_loss": 3.0, "AP": 0.25}
    assert al_eval.EVAL_CONFIG_BY_DATASET == jax_eval.EVAL_CONFIG_BY_DATASET
    methods = {"a": str(tmp_path / "m"), "b": str(tmp_path / "n")}
    per_method = {"a": samples(7), "b": samples(8)}
    runs = [mod.Similarity("k", methods, eval_fn=lambda d: 10.0 + len(d)).run(
        per_method, samples(9)) for mod in (al_eval, jax_eval)]
    assert runs[0]["ranking"] == runs[1]["ranking"] and runs[0]["ap"] == runs[1]["ap"]
    for m in methods:
        np.testing.assert_allclose(runs[0]["similarities"][m], runs[1]["similarities"][m],
                                   rtol=1e-5)
    json.dumps({k: v for k, v in runs[0].items() if k != "similarities"})
