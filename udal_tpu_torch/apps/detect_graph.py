"""The serve's model step as a list of stages, run eagerly or replayed as CUDA graphs.

``ServingDriver._detect`` runs the stages of ``_detect_stages``: the
driver's forward (the stages of ``models/stages.py``: ``model.backbone``,
twice on the MC fast path, ``model.bifpn``, ``model.heads``), then the
global post-processing as a ``post`` stage, each in its span. A stage's
body may open the same span itself (``head_outputs``,
``postprocess_global``): inside the stage's it records nothing.
``DetectGraphs`` runs them one of three ways, and says which in the root
``serve`` span's attribute ``graph``:

- ``eager``: the stages one after another, the dropout masks drawn where
  the sites are. Always on the CPU. On a CUDA device the first call of a
  key (the images' shape and dtype, the scales', the forward) runs so: it
  finishes the lazy set-up (kernel builds, cuDNN's handles, the anchors
  and clip limit on the device) and records the draws (order, n, c, keep).
  A key beyond ``MAX_GRAPHS`` runs so for good; no key is evicted.
- ``capture``: the key's second call captures every stage as a CUDA graph
  in one pass, then replays them. Every key's graphs allocate from the
  one memory pool of the driver: a key's replays run back to back and
  their outputs are cloned before the next call, so no key needs another's
  blocks to keep their contents.
- ``replay``: later calls. The call's masks are drawn from the driver's
  source (or the ``masks`` given) before the replay, one ``draw`` a site in
  the recorded order, and written into the graphs' flat static mask input
  with one ``torch.cat``; the graphs scale them by 1/keep as
  ``dropout_mask`` does. The images are copied into the static input in
  the compute dtype, the scales into theirs; each stage's graph is
  replayed inside its span; the detections returned are clones of the
  static outputs, so no later call overwrites what a caller holds. A
  replay launches the kernels without their wrappers, so the wrappers'
  launch counters count the eager and captured calls alone.

Once the pool exists, a call under a profiler sets the root ``serve``
span's ``pool_bytes``: the bytes of the card's memory the pool holds, which
``torch.cuda.max_memory_allocated`` does not count. Replays allocate
nothing, so the pool changes only at a capture, which takes its size.

The graphs read the weights by address: ``load_state_dict`` copies into
them and ``EfficientDetNet.prepare_inference`` refolds into the folds'
tensors, so replays see new weights; a fold replaced otherwise
(``train()``, ``drop_folds``) drops every graph and the pool. The
``sample`` box decode draws noise of its own inside ``post``, so such a
driver stays eager.
``DetectGraphs`` holds no reference to its driver (the driver is passed to
each call), so a dropped driver frees its graphs and their pool at once.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from udal_tpu_torch.models.efficientnet import KernelFold
from udal_tpu_torch.models.stages import Stage, run_stages, span_of
from udal_tpu_torch.ops.postprocess import Detections
from udal_tpu_torch.utils import profiling

# keys a driver holds graphs for
MAX_GRAPHS = 4
# the entry of ``DetectGraphs.stats`` that counts a call of each mode
_COUNTED_AS = dict(eager="eager", capture="captures", replay="replays")


class _Recording:
    """A mask source passed through; each draw's (n, c, keep) appended to
    ``plan``."""

    def __init__(self, source, plan: List[Tuple[int, int, float]]):
        self.source, self.plan = source, plan

    def draw(self, n: int, c: int, keep: float, device) -> torch.Tensor:
        self.plan.append((n, c, keep))
        return self.source.draw(n, c, keep, device)


class _StaticMasks:
    """The mask source of a capture: each dropout site gets its [n, c]
    slice of the flat static bits, sites in the recorded order (from the
    first again after the last)."""

    def __init__(self, plan: Sequence[Tuple[int, int, float]], flat: Optional[torch.Tensor]):
        self.plan, self.flat, self.drawn = plan, flat, 0
        self.offsets = [0, *itertools.accumulate(n * c for n, c, _ in plan)]

    def draw(self, n: int, c: int, keep: float, device) -> torch.Tensor:
        i = self.drawn % max(1, len(self.plan))
        if i >= len(self.plan) or self.plan[i] != (n, c, keep):
            raise RuntimeError(f"dropout site {self.drawn} draws {(n, c, keep)}; the eager "
                               f"call recorded {list(self.plan)}")
        self.drawn += 1
        return self.flat[self.offsets[i]:self.offsets[i + 1]].view(n, c)


def _folds(driver) -> List[Optional[Dict]]:
    """Every member's folds (the MBConv blocks', the separable convs'),
    which the graphs read by address."""
    return [m.folded for member in driver.members for m in member.modules()
            if isinstance(m, KernelFold)]


class CudaGraphs:
    """Capture and replay through ``torch.cuda.CUDAGraph``: the backend of
    CUDA tensors."""

    @staticmethod
    def takes(device: torch.device) -> bool:
        return device.type == "cuda"

    @staticmethod
    def pool():
        return torch.cuda.graph_pool_handle()

    @staticmethod
    def capture(fn: Callable[[], Any], pool) -> Tuple[torch.cuda.CUDAGraph, Any]:
        """``fn()`` captured into a graph allocating from ``pool``: the
        graph and the outputs it writes."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            out = fn()
        return graph, out

    @staticmethod
    def replay(graph: torch.cuda.CUDAGraph) -> None:
        graph.replay()

    @staticmethod
    def pool_bytes(pool) -> int:
        """The bytes of the card's memory segments that ``pool`` holds."""
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


@dataclasses.dataclass(eq=False)
class _Captured:
    """One key's graphs, their static inputs and outputs."""
    plan: List[Tuple[int, int, float]]
    images: torch.Tensor
    scales: Optional[torch.Tensor]
    flat: Optional[torch.Tensor]
    folds: List[Optional[Dict]]
    graphs: List[Tuple[Stage, Any]] = dataclasses.field(default_factory=list)
    out: Optional[Detections] = None

    def load(self, images: torch.Tensor, scales: Optional[torch.Tensor], masks) -> None:
        """The call's images, scales and mask bits into the static inputs."""
        self.images.copy_(images)
        if self.scales is not None:
            self.scales.copy_(scales)
        if self.flat is not None:
            device = self.flat.device
            torch.cat([masks.draw(n, c, keep, device).reshape(-1) for n, c, keep in self.plan],
                      out=self.flat)


class DetectGraphs:
    """A driver's model step (``ServingDriver._detect``): its stages eager,
    captured or replayed by ``backend`` (``CudaGraphs`` by default) as the
    module docstring sets out. ``stats`` counts the calls each way."""

    def __init__(self, backend=None):
        self.backend = CudaGraphs() if backend is None else backend
        # a key's recorded draws after its first call, its graphs after its second
        self.slots: Dict[tuple, Any] = {}
        # the memory pool every key's graphs allocate from (made at the first
        # capture) and its bytes after the last capture
        self.pool = self.pool_bytes = None
        self.stats = dict(captures=0, replays=0, eager=0)

    def key(self, driver, images: torch.Tensor,
            scales: Optional[torch.Tensor]) -> Optional[tuple]:
        """The call's key, or None where no graph may serve it."""
        cfg = driver.config
        if not self.backend.takes(images.device) or \
                (cfg.loss_attenuation and cfg.uncert_adjust_method == "sample"):
            return None
        return (tuple(images.shape), images.dtype,
                None if scales is None else (tuple(scales.shape), scales.dtype),
                driver._forward_kind())

    def detect(self, driver, images: torch.Tensor, scales: Optional[torch.Tensor],
               masks) -> Detections:
        """``driver``'s model step of ``images`` and ``scales`` with dropout
        from ``masks``."""
        key = self.key(driver, images, scales)
        slot = self.slots.get(key) if key is not None else None
        if isinstance(slot, _Captured) and any(
                a is not b for a, b in zip(slot.folds, _folds(driver))):
            # refolded into new tensors: the graphs read the old
            self.slots.clear()
            self.pool = self.pool_bytes = slot = None
        if key is None or (slot is None and len(self.slots) >= MAX_GRAPHS):
            mode, out = "eager", self.eager(driver, images, scales, masks)
        elif slot is None:
            plan: List[Tuple[int, int, float]] = []
            mode, out = "eager", self.eager(driver, images, scales, _Recording(masks, plan))
            self.slots[key] = plan
        elif isinstance(slot, list):
            self.slots[key] = captured = self.capture(driver, slot, images, scales, masks)
            self.pool_bytes = self.backend.pool_bytes(self.pool)
            mode, out = "capture", self.replay(captured)
        else:
            slot.load(images, scales, masks)
            mode, out = "replay", self.replay(slot)
        self.stats[_COUNTED_AS[mode]] += 1
        if self.pool_bytes is None:
            profiling.annotate("serve", graph=mode)
        else:
            profiling.annotate("serve", graph=mode, pool_bytes=self.pool_bytes)
        return out

    @staticmethod
    def eager(driver, images: torch.Tensor, scales: Optional[torch.Tensor],
              masks) -> Detections:
        state = dict(images=images.to(driver.dtype), scales=scales, masks=masks)
        return run_stages(driver._detect_stages(images.shape[0]), state, "detections")

    def capture(self, driver, plan, images: torch.Tensor, scales: Optional[torch.Tensor],
                masks) -> _Captured:
        """Load the call into fresh static inputs and capture every stage
        into the driver's pool."""
        flat = None
        if plan:
            flat = torch.empty(sum(n * c for n, c, _ in plan), dtype=torch.bool,
                               device=images.device)
        captured = _Captured(plan,
                             torch.empty(images.shape, dtype=driver.dtype, device=images.device),
                             None if scales is None else torch.empty_like(scales), flat,
                             _folds(driver))
        captured.load(images, scales, masks)
        static_masks = _StaticMasks(plan, flat)
        state = dict(images=captured.images, scales=captured.scales, masks=static_masks)
        if self.pool is None:
            self.pool = self.backend.pool()

        def step(st: Stage, call: Callable[[], Any]) -> Any:
            graph, out = self.backend.capture(call, self.pool)
            captured.graphs.append((st, graph))
            return out

        captured.out = run_stages(driver._detect_stages(images.shape[0]), state, "detections",
                                  step)
        if static_masks.drawn != len(plan):
            raise RuntimeError(f"the capture drew {static_masks.drawn} masks; the eager call "
                               f"recorded {len(plan)}")
        return captured

    def replay(self, captured: _Captured) -> Detections:
        """Each stage's graph in its span; clones of the static detections."""
        for st, graph in captured.graphs:
            with span_of(st):
                self.backend.replay(graph)
        out = captured.out
        return Detections(**{f.name: _clone(getattr(out, f.name))
                             for f in dataclasses.fields(out)})


def _clone(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.clone()
