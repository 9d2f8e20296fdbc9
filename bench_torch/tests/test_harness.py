"""The harness on the CPU: lookup by name, the refusal without a card, what
a run imports, a rehearsal of every cell, and that the check fails where
it must: the control in the program's place, and the timed path broken."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_torch import compare, harness
from bench_torch.tests.conftest import CELLS, rehearse, tiny

REPO = Path(__file__).resolve().parents[2]
BENCHMARK = json.loads((REPO / "BENCHMARK.json").read_text())
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def test_every_name_in_benchmark_json_has_its_files():
    for cfg in BENCHMARK["configs"]:
        assert harness.load("configs", cfg["name"])["name"] == cfg["name"]
        assert (REPO / cfg["file"]).is_file()
    for cell in BENCHMARK["workloads"]:
        spec = harness.load("workloads", cell["name"])
        assert spec["config"] == cell["config"] and spec["traffic"] == cell["traffic"]
        harness.load("mixes", spec["traffic"])
        assert hasattr(harness.module("entries", spec["entry"]), "Entry")
    readers = harness.metric_readers()
    for metric in BENCHMARK["per_layer"]:
        assert metric["name"] in readers and readers[metric["name"]].UNIT == metric["unit"]


def test_lookup_takes_a_file_added_in_another_directory(tmp_path):
    (tmp_path / "workloads").mkdir()
    spec = harness.load("workloads", "kitti_mc.serve_b8")
    (tmp_path / "workloads" / "kitti_mc.added.json").write_text(json.dumps(spec))
    roots = [tmp_path, harness.ROOT]
    assert harness.load("workloads", "kitti_mc.added", roots)["entry"] == "serve_uint8"
    with pytest.raises(FileNotFoundError):
        harness.load("workloads", "kitti_mc.added")
    # the added cell runs through the committed entry, configuration and mix
    overrides = tiny("kitti_mc.added", roots)
    overrides["harness"]["check_most"] = 1
    r = harness.run("kitti_mc.added", 99, 0.5, False, 0.0, device="cpu", roots=roots,
                    overrides=overrides, log=lambda *_: None)
    assert r["correct"] is True and r["compared_calls"] == 1


def test_without_a_card_the_run_fails_and_prints_no_result(tmp_path):
    proc = subprocess.run([sys.executable, str(REPO / "bench_torch" / "run.py"), "--workload",
                           "kitti_mc.serve_b8", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tmp_path,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_a_run_imports_no_jax_flax_yaml_or_the_jax_package():
    code = (
        "import sys, time\n"
        "sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(1)\n"
        "from bench_torch import harness, readings\n"
        "from bench_torch.tests.conftest import tiny\n"
        "for name in harness.metric_readers(): pass\n"
        "r = harness.run('kitti_head.serve_native_b8', 3, 0.2, True, time.perf_counter(),\n"
        "                device='cpu', overrides=tiny('kitti_head.serve_native_b8'),\n"
        "                log=lambda *_: None)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'yaml',\n"
        "       'udal_tpu', 'bench', 'chip_smoke')]\n"
        "print(bad)\n") % str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_of_each_cell(cell, trace):
    r = rehearse(cell, bool(trace))
    assert RESULT_KEYS <= set(r) and list(r)[-2:] == ["compared_calls", "checked"]
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert r["compared_calls"] >= 1
    assert all(m["value"] == harness.NOT_MEASURED for m in r["metrics"].values())
    names = set(r["metrics"])
    if trace:
        assert names == {m["name"] for m in BENCHMARK["per_layer"]
                         if cell in m.get("workloads", [cell])} | (names - {
                             m["name"] for m in BENCHMARK["per_layer"]})
    else:
        assert names == {m["name"] for m in BENCHMARK["end_to_end"]
                         if cell in m.get("workloads", [cell])}
    assert set(r["checked"]) == set(harness.load("workloads", cell)["limits"])
    json.dumps(r)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check(cell):
    """The reference in float8, in the program's place, at a small size."""
    from bench_torch import readings

    r = readings.readings(cell, 2**31 + 11, 1, device="cpu", overrides=tiny(cell))
    limits = harness.load("workloads", cell)["limits"]
    assert all(r["program"][k] <= limits[k] for k in limits), r["program"]
    assert any(r["control"][k] > limits[k] for k in limits), r["control"]


def _broken(monkeypatch, fault: str):
    """Break the program's post-processing underneath the serve entries."""
    from udal_tpu_torch.apps import serving

    real = serving.postprocess_global
    state = {}

    def post(config, cls, box, image_scales=None, **kw):
        if fault == "half_batch":     # the second half served the first half's answers
            b = cls[0].shape[1]
            half = b // 2 or 1
            cls = [torch.cat([c[:, :half]] * 2, 1)[:, :b] for c in cls]
            box = [torch.cat([t[:, :half]] * 2, 1)[:, :b] for t in box]
        det = real(config, cls, box, image_scales, **kw)
        if fault == "altered":        # every class id off by one where it is produced
            c = config.num_classes
            det.classes = torch.where(det.classes > 0, det.classes % c + 1, det.classes)
        if fault == "scaled_scores":  # every score 0.85 of itself (a decay or mapping off)
            det.scores = det.scores * 0.85
        if fault == "shifted_boxes":  # every box moved by a tenth of its size (IoU 0.68)
            size = (det.boxes[..., 2:] - det.boxes[..., :2]).repeat(1, 1, 2)
            det.boxes = det.boxes + 0.1 * size
        if fault == "stale":          # the state left as it was: the previous call's answer
            det, state["last"] = state.get("last", det), det
        return det

    monkeypatch.setattr(serving, "postprocess_global", post)


@pytest.mark.parametrize("fault", ["half_batch", "altered", "scaled_scores", "shifted_boxes",
                                   "stale"])
@pytest.mark.parametrize("cell", CELLS[:2])
def test_a_broken_timed_path_reads_incorrect(cell, fault, monkeypatch):
    _broken(monkeypatch, fault)
    overrides = tiny(cell)
    if fault == "stale":       # two pool batches, so the previous answer is another's
        overrides["traffic"]["pool_batches"] = 2
    r = rehearse(cell, seed=5, overrides=overrides)
    assert r["correct"] is False, r["checked"]
    if fault in ("scaled_scores", "shifted_boxes"):   # caught by the pair gaps alone
        limits = harness.load("workloads", cell)["limits"]
        gap = "score_vs_bf16" if fault == "scaled_scores" else "box_vs_bf16"
        assert [k for k in limits if r["checked"][k]["value"] > limits[k]] == [gap], r["checked"]


def test_compare_reads_zero_on_equal_tuples_and_sees_moved_answers():
    g = torch.Generator().manual_seed(0)
    k = 10
    yx = torch.rand((2, k, 2), generator=g) * 200
    boxes = torch.cat([yx, yx + 40], -1)
    sig = torch.rand((2, k, 8), generator=g) + 0.5
    scores = torch.sort(torch.rand((2, k), generator=g), descending=True).values
    classes = torch.cat([torch.randint(1, 4, (2, k, 1), generator=g).float(),
                         torch.rand((2, k, 3), generator=g) + 0.1], -1)
    packed = (torch.cat([boxes, sig], -1), scores, classes, torch.tensor([k, k]))
    assert all(v == 0.0 for v in compare.numbers(packed, packed).values())
    moved = tuple(t.clone() for t in packed)
    moved[0][1, 0, :4] += 100.0
    got = compare.numbers(moved, packed)
    assert 0.0 < got["unmatched"] < 0.5 and got["sigma_gap"] == 0.0
    assert got["score_gap"] == 0.0 and got["box_gap"] == 0.0
    moved[2][0, :, 0] = moved[2][0, :, 0] % 3 + 1      # one image's classes all off by one
    got = compare.numbers(moved, packed)
    assert got["unmatched"] > 0.5 and got["sigma_gap"] == 0.5
    assert got["score_gap"] == 0.5 and got["box_gap"] == 0.5    # image 0 has no pair
    # scores scaled and boxes shifted keep every pair: only the pair gaps see them
    scaled = (packed[0], packed[1] * 0.9, packed[2], packed[3])
    got = compare.numbers(scaled, packed)
    assert got["unmatched"] == 0.0 and got["score_gap"] == pytest.approx(0.1)
    shifted = tuple(t.clone() for t in packed)
    shifted[0][..., [0, 2]] += 4.0                      # a tenth of each box's height
    got = compare.numbers(shifted, packed)
    assert got["unmatched"] == 0.0 and got["box_gap"] == pytest.approx(0.1)
    assert got["score_gap"] == 0.0 and got["sigma_gap"] == 0.0
    # the check's numbers: the pair gaps over the witness's
    witness = dict(unmatched=0.3, sigma_gap=0.3, score_gap=0.02, box_gap=0.05)
    assert compare.compared(got, witness) == dict(
        unmatched=0.0, sigma_gap=0.0, score_vs_bf16=0.0, box_vs_bf16=pytest.approx(2.0))
    assert compare.compared(got, dict(witness, box_gap=0.0))["box_vs_bf16"] == float("inf")


def test_reference_weights_load_into_the_program_strictly():
    from udal_tpu_torch.config import get_detection_config
    from udal_tpu_torch.models.efficientdet import EfficientDetNet
    from bench_torch import weights

    for name in ("kitti_mc_d0", "kitti_head_d0"):
        cfg = harness.load("configs", name)
        config = get_detection_config(cfg["model_name"])
        config.override(cfg["overrides"], allow_new_keys=True)
        with torch.device("meta"):
            model = EfficientDetNet(config)
        p = weights.make(cfg["arch"], 7, "cpu")
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
            {k: tuple(v.shape) for k, v in p.items()}
        assert sum(v.numel() for v in p.values()) == 3_880_988
        # the same seed gives the same weights
        q = weights.make(cfg["arch"], 7, "cpu")
        assert all(torch.equal(p[k], q[k]) for k in p)
