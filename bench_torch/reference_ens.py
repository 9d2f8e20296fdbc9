"""Plain PyTorch reference of a deep ensemble of EfficientDets, for the check of ``correct``.

A deep ensemble (Lakshminarayanan, Pritzel and Blundell, arXiv:1612.01474)
serves N networks of one architecture, each with weights of its own, and
takes its epistemic uncertainty from their spread. Here each member is
``reference.network`` without masks (the deterministic network: no layer
drops out), its per-level class and box maps [1, B, C, H, W]; the members'
maps are concatenated on the leading axis, [N, B, C, H, W], and
``reference.postprocess`` reduces that axis as it reduces MC samples: the
mean class logits and their spread (σ_cls), the mean l-norm decoded boxes
and their spread (σ_mc, here the members'), the aleatoric σ_al averaged
over the members, the exact top-k, Gaussian soft-NMS and the packed tuple.

The arithmetic is ``reference.Arith``'s, one for every member: ``f32``
(TF32 off by ``run``), ``bf16`` (the witness) and ``fp8`` (the control).
``calibrate`` is ``reference.calibrate``, of one member at a time: its
BatchNorm statistics and predict-conv scales from its own pass.

Departures from the published model, all of them ``reference.py``'s: the
weights are random and calibrated (``weights.py``, ``calibrate``), not
trained. Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from bench_torch import reference as R
from bench_torch.reference import Arith, calibrate, run

__all__ = ["network", "serve", "calibrate", "run", "Arith"]

Weights = Dict[str, torch.Tensor]


def network(images, members: Sequence[Weights], arch, ar: Arith
            ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Normalised NHWC images [B, H, W, 3] → per-level class and box maps
    [N, B, C, H, W], member i's deterministic network on ``members[i]``."""
    outs = [R.network(images, p, arch, ar, None) for p in members]
    return tuple([torch.cat([o[k][level] for o in outs]) for level in range(len(outs[0][k]))]
                 for k in (0, 1))


def serve(images, image_scales, members: Sequence[Weights], arch,
          precision: str = "f32") -> Tuple[torch.Tensor, ...]:
    """Normalised NHWC images → the packed tuple of the ensemble of
    ``members`` at ``precision``."""
    ar = Arith(precision)
    cls, box = network(ar.q(images), members, arch, ar)
    return R.postprocess(cls, box, arch, image_scales)

