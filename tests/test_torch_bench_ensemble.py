"""The 5-member deep ensemble on BDD100K against the benchmark's plain ensemble reference.

``bench_torch/reference_ens.py`` computes the ensemble from the
architecture alone: each member's deterministic ``reference.network``,
the members' maps on a leading axis, ``reference.postprocess`` over it.
``bench_torch/entries/serve_uint8_ens.py`` serves the same members through
the port's ``ServingDriver(..., ensemble=True)``. Here at a tiny size
(d0's widths on a 128x256 canvas, batch 2, 3 members), the port in f32 on
the CPU; the cell's check rehearsed with its limits; the ensemble's spans
and the cell's three readers on hand-made records.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from bench_torch import compare, harness, readings  # noqa: E402
from bench_torch import reference as R  # noqa: E402
from bench_torch import reference_ens as RE  # noqa: E402
from test_torch_fixtures import one_cpu_thread, small_overrides  # noqa: E402,F401
from udal_tpu_torch.apps.serving import ServingDriver  # noqa: E402
from udal_tpu_torch.config import get_detection_config  # noqa: E402
from udal_tpu_torch.models.ensemble import init_ensemble, stack_variables  # noqa: E402
from udal_tpu_torch.utils import profiling  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CELL = "bdd_ens5.serve_b8"
CONFIG = "bdd_ens5_d0"
CANVAS = (128, 256)
TINY = dict(members=3, arch=dict(image_size=list(CANVAS)),
            program=dict(image_size=f"{CANVAS[1]}x{CANVAS[0]}"),
            traffic=dict(batch=2, frame_hw=list(CANVAS), pool_batches=1))
EPS = torch.finfo(torch.float32).eps
# f32 on both sides in another order of operations: boxes and σ_al agree to
# a few ulps of the canvas (3 seen), the logits and scores to a few of
# theirs. σ_mc and σ_cls are the members' spread, which the port takes as
# sqrt(E[x²] − E[x]²) in one pass (as the JAX package does) and the
# reference as sqrt(E[(x − E[x])²]): where the members nearly agree, the
# one-pass variance keeps the rounding of x², about eps·x², so the spreads
# differ by up to sqrt(eps)·|x| (0.06 px seen on the 256-wide canvas)
BOX_ATOL = 64 * EPS * max(CANVAS)
SPREAD_ATOL = 2 * math.sqrt(EPS) * max(CANVAS)
LOGIT_TOL = 1e-5


def _entry(seed=2**33 + 7, **extra):
    cell = harness.load("workloads", CELL)
    overrides = dict(TINY, **extra)
    mix = dict(harness.load("mixes", cell["traffic"]), **overrides["traffic"])
    return harness.module("entries", cell["entry"]).Entry(
        harness.load("configs", cell["config"]), mix, harness.seeds_from(seed),
        torch.device("cpu"), overrides)


@pytest.fixture(scope="module")
def entry():
    return _entry()


def test_the_configuration_is_baseline_config_3():
    """d0's widths, the YAML's overrides, 5 members, no dropout, nothing cut."""
    cfg = harness.load("configs", CONFIG)
    arch = cfg["arch"]
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG)
    assert entry["reduced"] == [] and entry["file"] == f"bench_torch/configs/{CONFIG}.json"
    assert cfg["members"] == arch["members"] == 5
    assert (arch["mc_backbone_rate"], arch["mc_head_rate"], arch["mc_samples"]) == (0, 0, 1)
    yaml_file = REPO / "configs" / "train" / "allclasses_lossatt_BDD.yaml"
    yaml = {}
    for line in yaml_file.read_text().splitlines():
        if ":" in line and not line.startswith(("#", "-")):
            key, value = (s.strip() for s in line.split(":", 1))
            yaml[key] = json.loads(value.replace("'", '"'))
    assert cfg["overrides"] == yaml
    program = get_detection_config(cfg["model_name"])
    program.override(cfg["overrides"], allow_new_keys=True)
    assert not program.mc_dropout and program.label_map == "bdd"
    d0 = harness.load("configs", "kitti_mc_d0")["arch"]
    for key, value in d0.items():
        if key not in ("num_classes", "mc_samples", "mc_backbone_rate", "mc_head_rate"):
            assert arch[key] == value, key
    for key in ("fpn_num_filters", "fpn_cell_repeats", "box_class_repeats", "min_level",
                "max_level", "anchor_scale", "num_classes"):
        assert arch[key] == program[key], key
    assert arch["image_size"] == [512, 1024] and program.image_size == "1024x512"
    cell = harness.load("workloads", CELL)
    assert (cell["config"], cell["entry"], cell.get("chips")) == (CONFIG, "serve_uint8_ens", 1)


def test_the_port_serves_the_ensemble_reference_in_f32(entry):
    served = entry.call(0, keep=True)
    (ref,) = entry.reference_serves(0, ("f32",))
    assert torch.equal(served[3], ref[3]) and int(ref[3].min()) > 0
    assert torch.equal(served[2][..., 0], ref[2][..., 0])        # the classes, so the picks
    boxes, al, mc = (slice(0, 4), slice(4, 8), slice(8, 12))
    torch.testing.assert_close(served[0][..., boxes], ref[0][..., boxes], atol=BOX_ATOL, rtol=0)
    torch.testing.assert_close(served[0][..., al], ref[0][..., al], atol=BOX_ATOL, rtol=0)
    torch.testing.assert_close(served[0][..., mc], ref[0][..., mc], atol=SPREAD_ATOL, rtol=0)
    torch.testing.assert_close(served[1], ref[1], atol=LOGIT_TOL, rtol=LOGIT_TOL)
    logit_scale = float(ref[4].abs().max())
    torch.testing.assert_close(served[2][..., 1:], ref[2][..., 1:],
                               atol=2 * math.sqrt(EPS) * logit_scale, rtol=0)
    torch.testing.assert_close(served[4], ref[4], atol=LOGIT_TOL, rtol=LOGIT_TOL)
    # the members differ: σ_mc is their spread, far above the rounding
    assert float(ref[0][..., mc].median()) > 10 * SPREAD_ATOL


@pytest.mark.parametrize("precision", ["f32", "bf16", "fp8"])
def test_one_member_is_the_reference_serve_bit_for_bit(entry, precision):
    p = entry.reference_weights[0]
    images, scales = entry.reference_input(0)
    one = RE.run(RE.serve, images, scales, [p], entry.arch, precision)
    single = R.run(R.serve, images, scales, p, entry.arch, precision)
    assert len(one) == len(single) == 5
    for a, b in zip(one, single):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("side", ["reference", "port"])
def test_five_identical_members_have_no_spread(entry, side):
    """σ_mc of five copies of one member: the rounding of the corners'
    mean alone in the reference (a few ulps of the canvas); in the port,
    whose one-pass variance keeps the rounding of x², at most sqrt(eps)
    of the canvas; against a spread of pixels between distinct members."""
    p = entry.reference_weights[0]
    if side == "reference":
        images, scales = entry.reference_input(0)
        out = RE.run(RE.serve, images, scales, [p] * 5, entry.arch, "f32")
        bound = 8 * EPS * max(CANVAS)
    else:
        driver = ServingDriver(entry.program_config, stack_variables([p] * 5), 2,
                               device="cpu", ensemble=True)
        out = driver.serve(entry.pool[0])
        bound = SPREAD_ATOL
    assert int(out[3].min()) > 0
    assert float(out[0][..., 8:12].abs().max()) <= bound
    assert float(out[2][..., 1:].abs().max()) <= 2 * math.sqrt(EPS) * float(out[4].abs().max())


def test_the_entry_refuses_a_program_of_other_members(monkeypatch):
    import udal_tpu_torch.apps.serving as serving

    class Fewer(ServingDriver):
        def __init__(self, config, stacked, *args, **kwargs):
            super().__init__(config, {k: v[:-1] for k, v in stacked.items()}, *args, **kwargs)

    monkeypatch.setattr(serving, "ServingDriver", Fewer)
    with pytest.raises(ValueError, match="serves 2 members, the configuration file 3"):
        _entry()


def test_the_cell_rehearses_correct_and_its_controls_fail():
    """The cell's limits at the tiny size, 5 members: the f32 program
    passes; the float8 control, and a program that serves 4 of the 5
    members, each fail at least one."""
    overrides = dict(TINY, members=5, harness=dict(check_every=1, check_most=1, trace_calls=2))
    r = readings.readings(CELL, 2**31 + 13, 1, device="cpu", overrides=overrides)
    limits = harness.load("workloads", CELL)["limits"]
    assert all(r["program"][k] <= limits[k] for k in limits), r["program"]
    assert any(r["control"][k] > limits[k] for k in limits), r["control"]

    e = _entry(seed=2**31 + 13, members=5)
    four = ServingDriver(e.program_config, stack_variables(e.reference_weights[:4]), 2,
                         device="cpu", ensemble=True)
    served = tuple(t.cpu() for t in four.serve(e.pool[0]))
    ref, wit = e.reference_serves(0, ("f32", "bf16"))
    fewer = compare.compared(compare.numbers(served, ref), compare.numbers(wit, ref))
    assert any(fewer[k] > limits[k] for k in limits), fewer


def test_a_traced_serve_marks_each_members_stages_and_stacks_once():
    n, calls = 3, 2
    cfg = get_detection_config("efficientdet-d0")
    cfg.override(small_overrides(), allow_new_keys=True)
    driver = ServingDriver(cfg, init_ensemble(cfg, n, seed=4)[1], 2, device="cpu",
                           ensemble=True)
    frames = torch.randint(0, 256, (2, 100, 160, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(calls):
            driver.serve(frames)
    spans = profiling.spans()
    profiling.clear_spans()
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["serve"] * calls
    assert all(r.attrs["samples"] == n for r in roots)
    for root in roots:
        inner = [s for s in spans if s.root == root.id and s.parent is not None]
        model = [(s.name, s.attrs.get("member")) for s in inner if s.name.startswith("model.")]
        assert model == [(stage, i) for i in range(n)
                         for stage in ("model.backbone", "model.bifpn", "model.heads")] + [
                             ("model.stack", None)]
        (stack,) = [s for s in inner if s.name == "model.stack"]
        assert stack.attrs == dict(members=n)
        assert not any("member" in s.attrs for s in inner
                       if not s.name.startswith(("model.backbone", "model.bifpn",
                                                 "model.heads")))


# -- the cell's readers on hand-made records ---------------------------------------

MS = 1_000_000      # ns
READERS = {name: harness.module("metrics", name)
           for name in ("model.host_ms.member", "model.host_ms.stack",
                        "device.busy_ms_per_member")}


def _call(first_id, t0, stages, samples):
    """A root ``serve`` span at ``t0`` (ns) with ``stages`` [(name, ms,
    attrs)] back to back, its end 1 ms after the last; the spans and the
    next call's start, 2 ms later."""
    root = profiling.Span("serve", first_id, None, first_id, t0,
                          attrs=dict(samples=samples, graph="replay"))
    out, t, sid = [root], t0, first_id
    for name, ms, attrs in stages:
        sid += 1
        out.append(profiling.Span(name, sid, first_id, first_id, t, t + int(ms * MS),
                                  dict(attrs)))
        t += int(ms * MS)
    root.end_ns = t + MS
    return out, root.end_ns + 2 * MS


def _members(n, ms):
    return [(stage, ms, dict(member=i)) for i in range(n)
            for stage in ("model.backbone", "model.bifpn", "model.heads")]


def _buffer():
    """Two calls of a 2-member ensemble (each member's stages 1 ms, then
    1 ms of ``model.stack``, the second call's 0.5; a 0.25 ms span inside
    call 1's first backbone), then a call the readers leave out (the
    second trace's)."""
    a, t = _call(1, 0, _members(2, 1) + [("model.stack", 1, dict(members=2)),
                                         ("post", 1, {})], 2)
    first = a[1]
    a.append(profiling.Span("inner", 99, first.id, 1, first.start_ns, first.start_ns + MS // 4))
    b, t = _call(20, t, _members(2, 1) + [("model.stack", 0.5, dict(members=2))], 2)
    c, _ = _call(40, t, _members(2, 9) + [("model.stack", 9, dict(members=2))], 2)
    return a + b + c


def _record(kind="serve"):
    """Device spans of the two traced calls: busy 0-3 and 5-6 ms (one
    copy overlapping a kernel), 2-member roots."""
    device = [("k", 0.0, 0.002), ("copy", 0.001, 0.003), ("k", 0.005, 0.006)]
    return dict(kind=kind, calls=2, device=device, gap_device=device, host=[], traced_s=0.01)


def test_the_readers_by_hand(monkeypatch):
    spans = _buffer()
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    record = _record()
    # members: 2 calls x 2 members x 3 stages of 1 ms, less 0.25 ms inside
    assert READERS["model.host_ms.member"].read(record) == pytest.approx(
        (12 - 0.25) / 2 / 2, rel=1e-12)
    assert READERS["model.host_ms.stack"].read(record) == pytest.approx((1 + 0.5) / 2,
                                                                         rel=1e-12)
    assert READERS["device.busy_ms_per_member"].read(record) == pytest.approx(
        (3 + 1) / 2 / 2, rel=1e-12)
    for reader in READERS.values():
        assert reader.read(_record(kind="train")) is None


def test_the_readers_read_nothing_of_a_single_network_or_a_program_without_spans(monkeypatch):
    single = []
    for first, t0 in ((1, 0), (20, 50 * MS)):
        spans, _ = _call(first, t0, [("model.backbone", 1, {}), ("model.bifpn", 1, {}),
                                     ("model.heads", 1, {}), ("post", 1, {})], 10)
        single += spans
    monkeypatch.setattr(profiling, "spans", lambda: list(single))
    for reader in READERS.values():
        assert reader.read(_record()) is None
    monkeypatch.delattr(profiling, "spans")        # as the parent program reads
    for reader in READERS.values():
        assert reader.read(_record()) is None


def test_the_reference_imports_neither_jax_nor_the_port():
    code = ("import sys, bench_torch.reference_ens; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, check=True).stdout.split()
    assert "bench_torch.reference_ens" in out and "torch" in out
    assert [m for m in out if m.split(".")[0] in ("jax", "flax", "udal_tpu",
                                                  "udal_tpu_torch")] == []
