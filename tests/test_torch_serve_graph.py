"""The serve's model step as stages, eager or replayed (``apps/detect_graph.py``), on the CPU.

A fake capture backend stands in for CUDA graphs: a capture runs the stage
once, a replay runs it again on the same static inputs and copies what it
makes into the captured outputs, leaving the kernels' launch counters as
they were, as a replayed graph leaves them. On it the stages, with the
masks drawn up front into the flat static bits, give ``_detect`` as it was
composed before the stages (the model's own methods, written out here) bit
for bit for each forward; the recorded draws are the eager forward's; the
engagement rule (never on the CPU's real backend, never for the
sample-parallel serve, eager then capture then replay, at most
``MAX_GRAPHS`` keys, one pool for all); the wrappers' counters see only
the eager and captured calls; a dropped driver is freed without the cycle
collector. Also the cached clip limit and the benchmark's reader of the
``graph`` attribute. Tiny d0 at 128x128, random weights.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bench_torch import harness  # noqa: E402
from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from udal_tpu_torch.apps import detect_graph  # noqa: E402
from udal_tpu_torch.apps.serving import ServingDriver  # noqa: E402
from udal_tpu_torch.models import bifpn, mc_fast  # noqa: E402
from udal_tpu_torch.models.efficientdet import head_only_mc  # noqa: E402
from udal_tpu_torch.models.efficientnet import ChannelDropout  # noqa: E402
from udal_tpu_torch.models.ensemble import init_ensemble  # noqa: E402
from udal_tpu_torch.ops import anchors as anchor_lib  # noqa: E402
from udal_tpu_torch.ops import cuda_nms, fused_dw, fused_mbconv  # noqa: E402
from udal_tpu_torch.ops.postprocess import _clip, postprocess_global  # noqa: E402
from udal_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from udal_tpu_torch.utils import profiling  # noqa: E402

B = 2
SMALL = dict(image_size="128x128", num_classes=8, loss_attenuation=True, fpn_cell_repeats=1,
             box_class_repeats=1, mc_dropoutsamp=3)
MC = dict(mc_dropout=True, mc_dropoutrate=0.05)
HEAD_ONLY = dict(mc_dropout=True, mc_classheadrate=0.05, mc_boxheadrate=0.05,
                 enable_softmax=True)
KINDS = {"deterministic": dict(mc_dropout=False), "head_only_mc": HEAD_ONLY, "mc_fast": MC,
         "mc": dict(MC, mc_fast_fold=False), "ensemble": dict(mc_dropout=False)}


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            _copy_into(getattr(dst, f.name), getattr(src, f.name))
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    else:
        assert dst is None and src is None


def _launch_counts():
    """The kernel wrappers' launch counters: soft-NMS, the fused depthwise,
    the fused expand + depthwise."""
    return cuda_nms.launches, fused_dw.launches, fused_mbconv.launches


def _set_launch_counts(counts):
    cuda_nms.launches, fused_dw.launches, fused_mbconv.launches = counts


class FakeGraphs:
    """Captures by running the stage, replays by running it again into the
    captured outputs, the launch counters left as they were; a new pool
    object at each ``pool()``."""

    def __init__(self):
        self.captured = self.replayed = 0
        self.pools = []

    @staticmethod
    def takes(device):
        return True

    def pool(self):
        self.pools.append(object())
        return self.pools[-1]

    def capture(self, fn, pool):
        assert pool is self.pools[-1]
        self.captured += 1
        out = fn()
        return (fn, out), out

    def replay(self, graph):
        self.replayed += 1
        fn, out = graph
        counts = _launch_counts()
        _copy_into(out, fn())
        _set_launch_counts(counts)

    def pool_bytes(self, pool):
        """A pool's bytes: 2 MiB a capture so far."""
        assert pool is self.pools[-1]
        return (2 << 20) * self.captured


def _driver(kind, seed=7, backend=None, state=None):
    overrides = dict(SMALL, **KINDS[kind])
    if kind == "ensemble":
        if state is None:
            cfg = ServingDriver.create("efficientdet-d0", overrides=overrides, device="cpu").config
            state = init_ensemble(cfg, 2, seed=11)[1]
        d = ServingDriver.create("efficientdet-d0", state, overrides=overrides, device="cpu",
                                 mc_seed=seed, ensemble=True)
    else:
        d = ServingDriver.create("efficientdet-d0", state, overrides=overrides, device="cpu",
                                 mc_seed=seed)
    if backend is not None:
        d._graphs = detect_graph.DetectGraphs(backend)
        d.graph_stats = d._graphs.stats
    return d


def _images(i, b=B):
    return np.random.RandomState(100 + i).uniform(-2, 2, (b, 128, 128, 3)).astype(np.float32)


def _scales(i, b=B):
    return np.linspace(1.0, 2.0, b).astype(np.float32) + i


def _composed(driver, images, masks):
    """The network's outputs as ``ServingDriver._forward`` composed them
    before the stages: the model's own forward, ``mc_forward``'s three
    branches, the members' forwards stacked."""
    cfg, model = driver.config, driver.model
    samples = int(cfg.mc_dropoutsamp)
    x = images.permute(0, 3, 1, 2)
    if driver.ensemble:
        outs = [m(images) for m in driver.members]
        return tuple([torch.stack([o[j][level] for o in outs]) for level in range(len(first))]
                     if isinstance(first, list) else torch.stack([o[j] for o in outs])
                     for j, first in enumerate(outs[0]))
    if not driver._mc():
        return model(images)
    if head_only_mc(cfg):
        return model.head_outputs(model.features(x.contiguous()), masks, samples, repeat=True)
    if mc_fast.fast_mc_eligible(cfg, model):
        x0, x0_mean = mc_fast.mc_shared_prefix(model, images)
        x1 = mc_fast.folded_block0_all_samples(model, x0, x0_mean, cfg.mc_dropoutrate, samples,
                                               drop=masks)
        return model.head_outputs(model.features(x1, masks, start_block=1), masks, samples)
    return model.head_outputs(model.features(x.repeat(samples, 1, 1, 1), masks), masks, samples)


def _today(driver, images, scales, masks=None):
    """``_detect`` as it was: the composed forward then ``postprocess_global``."""
    with torch.inference_mode():
        images = torch.as_tensor(images).to(driver.dtype)
        outs = _composed(driver, images, driver.masks if masks is None else masks)
        return postprocess_global(driver.config, outs[0], outs[1],
                                  image_scales=torch.as_tensor(scales))


def _assert_same_bits(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert (g is None) == (w is None), f.name
        if w is not None:
            assert g.dtype == w.dtype and torch.equal(g, w), f.name


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_stages_give_todays_detect_bit_for_bit(kind):
    """Eager, capture (the masks drawn up front into the flat static bits)
    and two replays: each call the bits of ``_forward`` + ``postprocess_global``
    of a twin driver drawing the same masks."""
    backend = FakeGraphs()
    driver, twin = _driver(kind, backend=backend), _driver(kind)
    modes = []
    for i in range(4):
        got = driver.serve_detections_preprocessed(_images(i), _scales(i))
        _assert_same_bits(got, _today(twin, _images(i), _scales(i)))
        modes.append(dict(driver.graph_stats))
    assert modes[-1] == dict(captures=1, replays=2, eager=1)
    stages = driver._detect_stages(B)
    assert backend.captured == len(stages)
    assert backend.replayed == 3 * len(stages)
    spans = [s.span for s in stages]
    assert spans[-1] == "post"
    assert spans.count("model.backbone") == {"mc_fast": 2, "ensemble": 2}.get(kind, 1)


@pytest.mark.parametrize("kind", ["head_only_mc", "mc_fast"])
def test_fused_separable_convs_replay_as_eager_bit_for_bit(kind, monkeypatch):
    """With the CPU taken as a card for the separable convs (each fused
    call runs the plain version): eager, capture and two replays give the
    bits of a twin driver's composed forward under the same masks, and
    every forward the driver and the twin run makes the fused calls: 8
    nodes, and a tower layer and a predict conv a head a level."""
    calls = []
    real = bifpn.fused_sepconv

    def count(x, *args, **kwargs):
        calls.append(tuple(x.shape))
        return real(x, *args, **kwargs)

    monkeypatch.setattr(bifpn, "fused_sepconv", count)
    monkeypatch.setattr(bifpn, "_kernel_takes", lambda x: True)
    driver, twin = _driver(kind, backend=FakeGraphs()), _driver(kind)
    for i in range(4):
        got = driver.serve_detections_preprocessed(_images(i), _scales(i))
        _assert_same_bits(got, _today(twin, _images(i), _scales(i)))
    assert driver.graph_stats == dict(captures=1, replays=2, eager=1)
    # the driver's forwards: eager, the capture and its replay, two replays;
    # the twin's four
    assert len(calls) == (5 + 4) * (8 + 2 * 5 * 2)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_recorded_draws_are_the_eager_forwards(kind):
    class Recorder:
        def __init__(self, source):
            self.source, self.seen = source, []

        def draw(self, n, c, keep, device):
            self.seen.append((n, c, keep))
            return self.source.draw(n, c, keep, device)

    driver, twin = _driver(kind, backend=FakeGraphs()), _driver(kind)
    driver.serve_detections_preprocessed(_images(0), _scales(0))
    (plan,) = driver._graphs.slots.values()
    recorder = Recorder(twin.masks)
    _today(twin, _images(0), _scales(0), recorder)
    assert plan == recorder.seen
    samples = SMALL["mc_dropoutsamp"]
    if kind in ("deterministic", "ensemble"):
        assert plan == []
    else:
        assert all(n == samples * B and keep == pytest.approx(0.95) for n, _, keep in plan)
        # the head-only forward draws in the heads alone: a class and a box
        # site a level (one repeat), five levels
        assert (len(plan) == 10) if kind == "head_only_mc" else (len(plan) > 10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cached_clip_limit_gives_the_same_bits(dtype):
    cfg = _driver("deterministic").config
    boxes = torch.from_numpy(np.random.RandomState(1).uniform(-50, 200, (B, 100, 4))).to(dtype)
    h, w = anchor_lib.from_config(cfg).image_size
    want = torch.minimum(torch.clamp_min(boxes, 0.0), torch.tensor([h, w, h, w], dtype=dtype))
    got = _clip(cfg, boxes)
    assert got.dtype == dtype and torch.equal(got, want)
    anchors = anchor_lib.from_config(cfg)
    assert anchors.clip_limit("cpu", dtype) is anchors.clip_limit(torch.device("cpu"), dtype)


def test_the_cpu_backend_never_captures():
    driver = _driver("mc_fast")
    for i in range(3):
        driver.serve_detections_preprocessed(_images(i), _scales(i))
    assert driver.graph_stats == dict(captures=0, replays=0, eager=3)
    assert driver._graphs.slots == {}


def test_the_sample_parallel_serve_never_captures():
    """Its MC path all-reduces the moments inside ``post``: it never reaches
    ``_detect`` (a world of one, no process group)."""
    driver = _driver("mc_fast", backend=FakeGraphs())
    mesh = Mesh(shape={"data": 1, "model": 1}, rank=0, device=torch.device("cpu"))
    frames = np.random.RandomState(3).randint(0, 256, (B, 96, 160, 3)).astype(np.uint8)
    for _ in range(3):
        driver.serve_sample_parallel(mesh, frames)
    assert driver.graph_stats == dict(captures=0, replays=0, eager=0)


def test_a_decode_that_draws_its_own_noise_stays_eager():
    driver = _driver("head_only_mc", backend=FakeGraphs())
    driver.config.uncert_adjust_method = "sample"
    driver.config.decode_nsamples = 4
    for i in range(3):
        driver.serve_detections_preprocessed(_images(i), _scales(i))
    assert driver.graph_stats == dict(captures=0, replays=0, eager=3)


def test_eager_then_capture_then_replay_in_the_serve_span():
    driver = _driver("head_only_mc", backend=FakeGraphs())
    frames = np.random.RandomState(3).randint(0, 256, (B, 96, 160, 3)).astype(np.uint8)
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(4):
            driver.serve(frames)
    roots = [s for s in profiling.spans() if s.parent is None]
    assert [r.attrs["graph"] for r in roots] == ["eager", "capture", "replay", "replay"]
    # a replay's stages keep their spans, in order, inside the root
    last = [s.name for s in profiling.spans() if s.root == roots[-1].id][1:]
    assert last == ["serve.upload", "serve.prep", "model.backbone", "model.bifpn",
                    "model.heads", "post"]
    # the pool's bytes on the roots once it exists: eager calls have none
    held = driver._graphs.backend.captured * (2 << 20)      # one graph a stage: 4 stages
    assert held == 4 * (2 << 20)
    assert [r.attrs.get("pool_bytes") for r in roots] == [None] + [held] * 3
    pool = harness.module("metrics", "serve.graph_pool_gib")
    assert pool.read(dict(kind="serve", calls=4)) == pytest.approx(held / 2**30)
    reader = harness.module("metrics", "model.graph_replay_share")
    assert reader.UNIT == "%"
    assert reader.read(dict(kind="serve", calls=4)) == pytest.approx(50.0)
    assert reader.read(dict(kind="serve", calls=5)) is None     # fewer roots than calls
    for r in roots:     # a program that sets no attribute: nothing to read
        del r.attrs["graph"]
    assert reader.read(dict(kind="serve", calls=4)) is None
    profiling.clear_spans()


def test_at_most_four_keys_and_none_evicted():
    driver = _driver("deterministic", backend=FakeGraphs())
    for b in range(1, 6):
        for i in range(3):
            driver.serve_detections_preprocessed(_images(i, b), _scales(i, b))
    assert len(driver._graphs.slots) == detect_graph.MAX_GRAPHS == 4
    assert driver.graph_stats == dict(captures=4, replays=4, eager=4 + 3)
    driver.serve_detections_preprocessed(_images(0, 1), _scales(0, 1))
    driver.serve_detections_preprocessed(_images(0, 5), _scales(0, 5))
    assert driver.graph_stats == dict(captures=4, replays=5, eager=8)
    # without scales, another key: no slot left
    with torch.inference_mode():
        driver._detect(torch.from_numpy(_images(0, 1)), None)
    assert driver.graph_stats["eager"] == 9


def test_the_launch_counters_see_the_eager_and_captured_calls_alone(monkeypatch):
    """The wrappers count where the kernels would launch (monkeypatched on
    the CPU): 1 / 15 / 1 for the eager call and the capture, nothing for a
    replay, which launches the kernels without them."""
    def counted(module, name, counter):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            setattr(counter[0], counter[1], getattr(counter[0], counter[1]) + 1)
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)

    counted(cuda_nms, "batched_soft_nms", (cuda_nms, "launches"))
    counted(fused_mbconv, "fused_expand_dw", (fused_mbconv, "launches"))
    counted(fused_dw, "fused_depthwise", (fused_dw, "launches"))
    driver = _driver("head_only_mc", backend=FakeGraphs())
    for i in range(4):
        before = _launch_counts()
        driver.serve_detections_preprocessed(_images(i), _scales(i))
        after = _launch_counts()
        want = [1, 1, 15] if i < 2 else [0, 0, 0]
        assert [a - b for a, b in zip(after, before)] == want, i
    assert driver.graph_stats == dict(captures=1, replays=2, eager=1)


def test_every_key_captures_into_the_drivers_one_pool():
    backend = FakeGraphs()
    driver = _driver("deterministic", backend=backend)
    for b in (1, 2):
        for i in range(3):
            driver.serve_detections_preprocessed(_images(i, b), _scales(i, b))
    assert driver.graph_stats == dict(captures=2, replays=2, eager=2)
    assert len(backend.pools) == 1 and driver._graphs.pool is backend.pools[0]


def test_a_dropped_driver_is_freed_without_the_cycle_collector():
    """No cycle holds a driver: its graphs and their pool go with its last
    reference, not at the cycle collector's next pass."""
    driver = _driver("mc_fast", backend=FakeGraphs())
    for i in range(3):
        driver.serve_detections_preprocessed(_images(i), _scales(i))
    assert driver.graph_stats["captures"] == 1
    (captured,) = driver._graphs.slots.values()
    refs = [weakref.ref(o) for o in (driver, driver._graphs, captured, driver.model)]
    del captured
    gc.collect()
    gc.disable()
    try:
        del driver
        assert [r() is None for r in refs] == [True] * len(refs)
    finally:
        gc.enable()


def test_detections_held_by_a_caller_outlive_the_next_call():
    driver = _driver("mc_fast", backend=FakeGraphs())
    held = [driver.serve_detections_preprocessed(_images(i), _scales(i)) for i in range(4)]
    copies = [dataclasses.replace(d, **{f.name: getattr(d, f.name).clone()
                                        for f in dataclasses.fields(d)
                                        if getattr(d, f.name) is not None}) for d in held]
    for i in range(4, 6):
        driver.serve_detections_preprocessed(_images(i), _scales(i))
    for d, c in zip(held, copies):
        _assert_same_bits(d, c)
    assert not torch.equal(held[2].boxes, held[3].boxes)


def test_new_weights_reach_the_replay():
    """``load_state_dict`` and ``prepare_inference`` write into the tensors
    the graphs read: the next call replays, with a fresh driver's bits."""
    driver = _driver("mc_fast", backend=FakeGraphs())
    for i in range(3):
        driver.serve_detections_preprocessed(_images(i), _scales(i))
    other = ServingDriver.create("efficientdet-d0", overrides=dict(SMALL, **MC), device="cpu",
                                 seed=5).model.state_dict()
    fresh = _driver("mc_fast", state=other)
    folds = detect_graph._folds(driver)
    driver.model.load_state_dict(other)
    driver.model.prepare_inference()
    assert all(a is b for a, b in zip(folds, detect_graph._folds(driver)))
    for source in (driver, fresh):
        source.masks = ChannelDropout(torch.Generator().manual_seed(21))
    got = driver.serve_detections_preprocessed(_images(7), _scales(7))
    assert driver.graph_stats == dict(captures=1, replays=2, eager=1)
    _assert_same_bits(got, _today(fresh, _images(7), _scales(7)))


def test_a_fold_replaced_elsewhere_drops_the_graphs():
    driver = _driver("deterministic", backend=FakeGraphs())
    for i in range(3):
        driver.serve_detections_preprocessed(_images(i), _scales(i))
    driver.model.drop_folds()
    twin = _driver("deterministic")
    twin.model.drop_folds()
    pool = driver._graphs.pool
    got = driver.serve_detections_preprocessed(_images(3), _scales(3))
    assert driver.graph_stats == dict(captures=1, replays=1, eager=2)
    assert pool is not None and driver._graphs.pool is None
    _assert_same_bits(got, _today(twin, _images(3), _scales(3)))
