"""Deep-ensemble inference: port of ``udal_tpu/models/ensemble.py``.

The JAX package ``vmap``s one forward over N members' stacked variables.
Here the members are N modules run one after another (each launches its
own kernels: the fused ones take no member axis), and their outputs are
stacked on a leading axis: the same [T, B, H, W, C] sample-axis contract
as ``mc_forward``, which ``pre_nms`` reads by rank and reduces to mean
boxes with the members' spread as the epistemic σ.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from udal_tpu_torch.models.efficientdet import EfficientDetNet, Outputs, init_flax_style
from udal_tpu_torch.models.stages import forward_stages, run_stages


def stack_variables(state_dicts: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Stack N members' state dicts on a new leading axis."""
    return {k: torch.stack([sd[k] for sd in state_dicts]) for k in state_dicts[0]}


def unstack_variables(stacked: Mapping[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """The N members' state dicts of a stacked one."""
    n = len(next(iter(stacked.values())))
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def ensemble_forward(members: Sequence[EfficientDetNet], images: torch.Tensor) -> Outputs:
    """Each member's deterministic forward of NHWC ``images``, stacked:
    outputs with [N, B, H, W, C] maps."""
    return run_stages(forward_stages(members, "ensemble", images.shape[0]), dict(images=images))


def init_ensemble(config, num_members: int, generators: Optional[Sequence[torch.Generator]] = None,
                  seed: int = 0) -> Tuple[EfficientDetNet, Dict[str, torch.Tensor]]:
    """N members drawn as flax's initializers draw them, member i from
    ``generators[i]`` (by default one seeded ``seed + i``). Returns (the
    model, the stacked state dict)."""
    if generators is None:
        generators = [torch.Generator().manual_seed(seed + i) for i in range(num_members)]
    if len(generators) != num_members:
        raise ValueError(f"{num_members} members need as many generators, got {len(generators)}")
    model = EfficientDetNet(config)
    members = []
    for g in generators:
        init_flax_style(model, g)
        members.append({k: v.clone() for k, v in model.state_dict().items()})
    return model, stack_variables(members)
