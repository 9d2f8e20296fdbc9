"""The network's forward as a list of stages, the one composition of every forward.

A ``Stage`` is the work of one span: ``fn`` of the state entries ``reads``
makes entry ``writes``. ``forward_kind`` chooses the forward,
``forward_stages`` lists its stages from the NHWC ``images`` (and the mask
source ``masks``) to the NHWC outputs ``outs``, and ``run_stages`` runs
them, each in its span. ``mc_forward``, ``ensemble_forward`` and
``ServingDriver`` run these lists eagerly; the serve's model step captures
them one CUDA graph a stage (``apps/detect_graph.py``).

The forwards:

- ``deterministic``: ``model.backbone``, ``model.bifpn``, ``model.heads``
  at B (the last two with attribute ``levels``, the pyramid's levels).
- ``head_only_mc``: the backbone and BiFPN at B, the heads at T·B on the
  maps repeated t-major.
- ``mc_fast``: the shared prefix at B with the block-0 fold of all samples
  (``mc_fast.py``; its masks drawn first), then blocks 1-15 at T·B: two
  ``model.backbone`` stages; the BiFPN and heads at T·B.
- ``mc``: everything at T·B.
- ``ensemble``: each member's deterministic stages, their spans with
  attribute ``member`` (the member's index), then ``model.stack`` (with
  attribute ``members``, N) stacks the members' outputs on a leading axis.

The MC forwards' outputs have [T, B, H, W, C] maps, the ensemble's [N, B,
H, W, C].
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from udal_tpu_torch.models import mc_fast
from udal_tpu_torch.models.efficientdet import EfficientDetNet, Outputs, head_only_mc
from udal_tpu_torch.utils import profiling


class Stage(NamedTuple):
    """One stage of a forward: ``fn`` of the state entries ``reads`` makes
    entry ``writes``, in span ``span`` (None: no span)."""
    span: Optional[str]
    attrs: Dict[str, Any]
    reads: Tuple[str, ...]
    writes: str
    fn: Callable


def forward_kind(model: EfficientDetNet, mc: bool, ensemble: bool = False) -> str:
    """The forward of ``model`` (the first member of an ensemble) with MC
    dropout on or off: ``ensemble``, ``deterministic``, ``head_only_mc``,
    ``mc_fast`` (where the fold applies exactly) or ``mc``."""
    if ensemble:
        return "ensemble"
    if not mc:
        return "deterministic"
    if head_only_mc(model.config):
        return "head_only_mc"
    if mc_fast.fast_mc_eligible(model.config, model):
        return "mc_fast"
    return "mc"


def _network(model: EfficientDetNet, kind: str, batch: int, samples: int,
             suffix: str = "") -> List[Stage]:
    """The stages of one network's forward of the NHWC ``images``: the
    backbone, the BiFPN and the heads, into entry ``outs<suffix>``."""
    feats, outs = f"feats{suffix}", f"outs{suffix}"
    levels = model.num_levels
    if kind == "mc_fast":
        backbone = [
            Stage("model.backbone", dict(batch=batch), ("images", "masks"), "x",
                  lambda images, masks: mc_fast.block1_input(model, images, samples, masks)),
            Stage("model.backbone", dict(batch=samples * batch), ("x", "masks"), feats,
                  lambda x, masks: model.backbone_features(x, masks, start_block=1))]
    elif kind == "mc":
        backbone = [Stage("model.backbone", dict(batch=samples * batch), ("images", "masks"), feats,
                          lambda images, masks: model.backbone_features(
                              images.permute(0, 3, 1, 2).repeat(samples, 1, 1, 1), masks))]
    else:
        backbone = [Stage("model.backbone", dict(batch=batch), ("images",), feats,
                          lambda images: model.backbone_features(
                              images.permute(0, 3, 1, 2).contiguous()))]
    if kind in ("head_only_mc", "mc_fast", "mc"):
        repeat = kind == "head_only_mc"
        heads = Stage("model.heads", dict(batch=samples * batch, levels=levels),
                      (feats, "masks"), outs,
                      lambda f, masks: model.head_outputs(f, masks, samples, repeat))
    else:
        heads = Stage("model.heads", dict(batch=batch, levels=levels), (feats,), outs,
                      model.head_outputs)
    return backbone + [Stage("model.bifpn", dict(levels=levels), (feats,), feats, model.bifpn),
                       heads]


def stack_outputs(outs: Sequence[Outputs]) -> Outputs:
    """N members' outputs stacked on a leading axis, level by level."""
    return tuple([torch.stack([o[j][level] for o in outs]) for level in range(len(first))]
                 if isinstance(first, list) else torch.stack([o[j] for o in outs])
                 for j, first in enumerate(outs[0]))


def forward_stages(members: Sequence[EfficientDetNet], kind: str, batch: int,
                   samples: int = 1) -> List[Stage]:
    """The stages of forward ``kind`` for ``batch`` images: ``members``' (one
    model unless ``kind`` is ``ensemble``) with ``samples`` MC samples."""
    if kind != "ensemble":
        return _network(members[0], kind, batch, samples)
    stages = [s._replace(attrs=dict(s.attrs, member=i))
              for i, m in enumerate(members) for s in _network(m, kind, batch, 1, str(i))]
    stages.append(Stage("model.stack", dict(members=len(members)),
                        tuple(f"outs{i}" for i in range(len(members))), "outs",
                        lambda *outs: stack_outputs(outs)))
    return stages


def _last_reads(stages: Sequence[Stage]) -> List[List[str]]:
    """For each stage, the entries it reads that no later stage reads."""
    later: set = set()
    out = []
    for st in reversed(stages):
        out.append([k for k in st.reads if k not in later])
        later.update(st.reads)
    return out[::-1]


def span_of(stage: Stage):
    """The stage's span (a null context for a stage without one)."""
    return profiling.span(stage.span, **stage.attrs) if stage.span else contextlib.nullcontext()


def _in_span(stage: Stage, call: Callable[[], Any]) -> Any:
    with span_of(stage):
        return call()


def run_stages(stages: Sequence[Stage], state: Dict[str, Any], result: str = "outs",
               step: Callable[[Stage, Callable[[], Any]], Any] = _in_span) -> Any:
    """Each stage's ``fn`` of its entries through ``step(stage, call)`` (by
    default ``call()`` in the stage's span); an entry is dropped after its
    last reader. Returns entry ``result``."""
    for st, done in zip(stages, _last_reads(stages)):
        state[st.writes] = step(st, functools.partial(st.fn, *(state[k] for k in st.reads)))
        for k in done:
            if k != st.writes:
                del state[k]
    return state[result]
