"""The training state, the train and eval steps.

Port of ``udal_tpu/train/train_lib.py`` on one device. ``TrainState`` holds
the step count, the model (its parameters and BatchNorm running statistics),
the optimizer (its momentum or moment buffers) and the EMA of the
parameters, or None. ``train_step`` puts the model in train mode (which
drops the backbone's folds), runs forward, loss and backward, clips,
updates and moves the EMA; ``eval_step`` runs the model in eval mode, through the serving kernels on a
card.

Under a mesh (``state.mesh``, set by ``parallel.mesh.replicate_state`` or
``shard_state_tp``) a rank's step is its share of the JAX package's global
SPMD step: it takes its rows of the batch, draws the whole batch's dropout
masks and keeps its rows, reduces BatchNorm's moments and the detection
loss's normaliser (the positives) over the data group, sums the gradients
over it (the L2 term's once: data rank 0 carries it), clips by the global
norm and updates identically on every rank; the reported values are the
global batch's. Under tensor parallelism (``state.tp``) the forward runs on
channel-sharded state (``parallel/tensor_parallel.py``). SSL batches split
at a row index refuse a world above one (ROADMAP A11b).

Covers the JAX step's branches: plain detection training (per-image
pseudo-score weights from the groundtruth's pseudo column), STAC's
labelled / pseudo-labelled split, CSD's flipped second forward (BatchNorm
statistics updated by both forwards, in that order) and the segmentation
head's loss; the L2 term, per-tensor and global gradient clipping, bf16
mixed precision (autocast over the forward; parameters, gradients and the
optimizer stay f32) and true f32 otherwise (TF32 off for the step).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

from udal_tpu_torch.config import parse_image_size
from udal_tpu_torch.data.labels import build_labels
from udal_tpu_torch.models.efficientdet import EfficientDetNet, init_flax_style
from udal_tpu_torch.models.efficientnet import ChannelDropout, ShardedDropout
from udal_tpu_torch.ops.image_ops import warp_resize_batch
from udal_tpu_torch.parallel.collectives import all_reduce, global_mean
from udal_tpu_torch.parallel.mesh import Mesh
from udal_tpu_torch.parallel.tensor_parallel import TensorParallel
from udal_tpu_torch.train import losses as loss_lib
from udal_tpu_torch.train.schedules import Schedule, clip_gradients, make_optimizer


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step (and checkpoints).
    ``ema_params`` maps each parameter's name to its moving average."""
    step: int
    model: EfficientDetNet
    optimizer: torch.optim.Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    mesh: Optional[Mesh] = None                 # data / tensor parallelism
    tp: Optional[TensorParallel] = None         # the 'model' axis's layout


def resolve_device(device=None) -> torch.device:
    """``device``, by default the card; raises when a card is asked for and
    there is none."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training runs on a CUDA device unless device='cpu' is given, "
                           "and torch.cuda.is_available() is False")
    return device


def create_train_state(config, steps_per_epoch: int,
                       generator: Optional[torch.Generator] = None, device=None,
                       state_dict: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> Tuple[TrainState, Schedule]:
    """A fresh state and its schedule: the model with ``state_dict``, or
    with random weights drawn as flax's initializers draw them from
    ``generator`` (by default one seeded 0), on ``device`` (the card unless
    ``device="cpu"``), in train mode; the optimizer; the EMA as a copy of
    the parameters when ``config.moving_average_decay`` is set."""
    device = resolve_device(device)
    model = EfficientDetNet(config)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_flax_style(model, generator if generator is not None
                        else torch.Generator().manual_seed(0))
    model = model.to(device).train()
    optimizer, schedule = make_optimizer(config, list(model.parameters()), steps_per_epoch)
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if config.moving_average_decay else None)
    return TrainState(0, model, optimizer, ema), schedule


def prepare_batch(config, images, labels: Mapping, device
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """A batch on ``device`` in the classic contract (normalised f32 NHWC
    images, per-level targets).

    The reader's fast-input contracts are converted there: native-size
    frames with ``warp_scale`` / ``warp_offset`` are resized onto the
    network's canvas (``ops.image_ops.warp_resize_batch``); uint8 images
    (or any with ``valid_hw``) are normalised and zeroed past each image's
    ``valid_hw``; compact groundtruth (``gt_boxes``, ``gt_classes``,
    optional ``gt_pseudo``) becomes the per-level targets
    (``data.labels.build_labels``, the target assignment on ``device``).
    """
    images = torch.as_tensor(images, device=device)
    labels = {k: torch.as_tensor(v, device=device) for k, v in labels.items()}
    if "warp_scale" in labels:
        images = warp_resize_batch(images, labels.pop("warp_scale"), labels.pop("warp_offset"),
                                   parse_image_size(config.image_size))
    if images.dtype == torch.uint8 or "valid_hw" in labels:
        mean = torch.tensor(config.mean_rgb, dtype=torch.float32, device=device)
        std = torch.tensor(config.stddev_rgb, dtype=torch.float32, device=device)
        x = (images.to(torch.float32) - mean) / std
        vhw = labels.get("valid_hw")
        if vhw is not None:
            h, w = x.shape[1], x.shape[2]
            rmask = torch.arange(h, device=device)[None, :] < vhw[:, :1]      # [B, H]
            cmask = torch.arange(w, device=device)[None, :] < vhw[:, 1:]      # [B, W]
            x = x * (rmask[:, :, None] & cmask[:, None, :])[..., None].to(x.dtype)
        images = x
    labels.pop("valid_hw", None)
    if "gt_boxes" in labels:
        labels.update(build_labels(config, labels.pop("gt_boxes"), labels.pop("gt_classes"),
                                   labels.pop("gt_pseudo", None)))
    return images, labels


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of step ``step``: a fresh stream a step (the
    JAX step folds its key with the step count), so a resumed run draws
    what an unbroken one would."""
    return torch.Generator(device=device).manual_seed(
        (seed * 0x9E3779B97F4A7C15 + step) % (1 << 63))


def _autocast(config, device: torch.device):
    """bf16 autocast under mixed precision (the forward only: the loss
    follows the outputs' type, as the JAX package's does)."""
    if config.mixed_precision:
        return torch.autocast(device.type, dtype=torch.bfloat16)
    return contextlib.nullcontext()


@contextlib.contextmanager
def _precision_ctx(config):
    """f32 training at ``train_matmul_precision="highest"`` runs in true
    f32: TF32 off for cuDNN's convolutions and cuBLAS's matmuls while the
    step (backward included) runs, the flags restored after. Mixed
    precision and other precisions leave the flags as they are."""
    if config.mixed_precision or config.get("train_matmul_precision", "highest") != "highest":
        yield
        return
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _split(tensors, start: int, end: int):
    """The batch rows [start, end) of each per-level map or label."""
    if isinstance(tensors, dict):
        return {k: v[start:end] for k, v in tensors.items()}
    return [t[start:end] for t in tensors]


def compute_loss(config, model: EfficientDetNet, images: torch.Tensor,
                 labels: Mapping[str, torch.Tensor], masks: Optional[ChannelDropout],
                 step: int, steps_per_epoch: int, mesh: Optional[Mesh] = None,
                 forward=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward of the model as its mode stands (through ``forward`` when
    given), and the total loss with its parts. ``masks`` is the dropout
    source (MC dropout and stochastic depth); CSD's flipped forward draws
    from it after the first. Under a ``mesh`` the loss is this rank's share
    of the global batch's: the ranks' shares sum to it, the L2 term counted
    on data rank 0 (the others carry its value without its gradient)."""
    forward = forward or model
    group = mesh.data_group if mesh is not None else None
    with _autocast(config, images.device):
        outs = forward(images, masks)
    loss_vals: Dict[str, torch.Tensor] = {}
    idx = 0
    if "object_detection" in config.heads:
        cls_outputs, box_outputs = list(outs[0]), list(outs[1])
        idx = 2
        if config.loss_attenuation:
            box_outputs = [loss_lib.clip_uncert_channels(
                b, config.clip_min_uncert, config.clip_max_uncert) for b in box_outputs]

    batch = images.shape[0]
    unlabeled_start = int(config.get("unlabeled_start", batch) or batch)
    ssl_method = config.get("ssl_method", None)

    total = 0.0
    gt = labels.get("groundtruth_data")
    im_scores = None
    if gt is not None and gt.shape[-1] > 7:
        # the last column holds per-detection pseudo scores: each image's mean
        scores_col = gt[:, :, -1]
        valid = (scores_col >= 0).to(scores_col.dtype)
        im_scores = torch.sum(scores_col * valid, 1) / torch.clamp_min(torch.sum(valid, 1), 1.0)

    if "object_detection" in config.heads:
        if ssl_method == "CSD":
            with _autocast(config, images.device):
                outs_aug = forward(torch.flip(images, dims=[2]), masks)
            cls_aug, box_aug = outs_aug[0], outs_aug[1]
            if config.loss_attenuation:
                box_mu = [b[..., : b.shape[-1] // 2] for b in box_outputs]
                box_aug_mu = [b[..., : b.shape[-1] // 2] for b in box_aug]
            else:
                box_mu, box_aug_mu = box_outputs, box_aug
            sup_loss, loss_vals = loss_lib.detection_loss(
                config, _split(cls_outputs, 0, unlabeled_start),
                _split(box_outputs, 0, unlabeled_start), _split(labels, 0, unlabeled_start))
            u_cls, u_box = loss_lib.csd_consistency_loss(config, cls_outputs, box_mu, cls_aug,
                                                         box_aug_mu)
            ramp = (loss_lib.csd_ramp_weight(step, steps_per_epoch * config.num_epochs)
                    if config.get("csd_ramp") else 1.0)
            total += sup_loss + ramp * (u_cls + u_box)
            loss_vals.update(unsup_cls_loss=u_cls, unsup_box_loss=u_box,
                             ramp_w=torch.tensor(ramp))
        elif ssl_method == "STAC":
            sup_loss, loss_vals = loss_lib.detection_loss(
                config, _split(cls_outputs, 0, unlabeled_start),
                _split(box_outputs, 0, unlabeled_start), _split(labels, 0, unlabeled_start))
            pseudo_scores = im_scores[unlabeled_start:] if im_scores is not None else None
            pseudo_loss, pseudo_vals = loss_lib.detection_loss(
                config, _split(cls_outputs, unlabeled_start, batch),
                _split(box_outputs, unlabeled_start, batch),
                _split(labels, unlabeled_start, batch), pseudo_scores=pseudo_scores)
            loss_vals.update({f"pseudo_{k}": v for k, v in pseudo_vals.items()})
            avg_batch = (torch.mean(im_scores[:unlabeled_start])
                         if im_scores is not None else 1.0)
            avg_pseudo = torch.mean(pseudo_scores) if pseudo_scores is not None else 1.0
            stac_lambda = float(config.get("stac_lambda", 1.0) or 1.0)
            total += sup_loss * avg_batch + stac_lambda * pseudo_loss * avg_pseudo
        else:
            det_loss, loss_vals = loss_lib.detection_loss(config, cls_outputs, box_outputs,
                                                          labels, group=group)
            if im_scores is not None:
                det_loss = det_loss * global_mean(im_scores, group)
            total += det_loss

    if "segmentation" in config.heads:
        logp = torch.log_softmax(outs[idx], dim=-1)
        seg_loss = -torch.mean(torch.gather(
            logp, -1, labels["image_masks"][..., None].to(torch.int64)))
        if mesh is not None:                 # the rank's share of the batch's mean
            seg_loss = seg_loss / mesh.shape["data"]
        loss_vals["seg_loss"] = seg_loss
        total += seg_loss

    reg = loss_lib.l2_regularization(loss_lib.l2_parameters(model), config.weight_decay)
    if mesh is not None and mesh.data_index != 0:
        reg = reg.detach()
    loss_vals["reg_l2_loss"] = reg
    total = total + reg
    loss_vals["loss"] = total
    return total, loss_vals


def train_step(config, schedule: Schedule, steps_per_epoch: int, state: TrainState,
               images, labels: Mapping, seed: int = 0, masks=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One training step on the model's device; ``state`` is updated in
    place and returned with the step's values (device tensors, nothing
    read on the host): the loss and its parts, ``gradient_norm`` (after
    clipping) and ``learning_rate``, the rate this update used. Under a
    mesh, ``images`` and ``labels`` are this rank's rows of the global
    batch (``parallel.mesh.shard_batch``), as each data rank's reader
    yields them. ``masks`` is the dropout source (MC dropout and
    stochastic depth draw from it in the forward's order); by default a
    fresh generator a step, ``step_generator(seed, state.step)``."""
    model, optimizer, mesh, tp = state.model, state.optimizer, state.mesh, state.tp
    device = next(model.parameters()).device
    if masks is None:
        masks = ChannelDropout(step_generator(seed, state.step, device))
    if mesh is not None:
        _refuse_ssl(config, mesh)
        masks = ShardedDropout(masks, mesh.data_index, mesh.shape["data"])
    images, labels = prepare_batch(config, images, labels, device)
    model.train()
    names, params = zip(*model.named_parameters())
    optimizer.zero_grad(set_to_none=True)
    forward = (lambda *args: tp.forward(model, *args)) if tp is not None else None
    with _precision_ctx(config):
        loss, loss_vals = compute_loss(config, model, images, labels, masks, state.step,
                                       steps_per_epoch, mesh, forward)
        loss.backward()
    for p in params:
        if p.grad is None:      # a parameter the loss does not reach: a zero gradient
            p.grad = torch.zeros_like(p)
    if mesh is not None:
        _sum_gradients([p.grad for p in params], mesh.data_group)
        loss_vals = _global_values(config, loss_vals, model, mesh, tp)
    if config.clip_gradients_norm and config.clip_gradients_norm > 0:
        loss_vals["gradient_norm"] = clip_gradients(
            [p.grad for p in params], abs(config.clip_gradients_norm),
            [tp.is_sharded(n) for n in names] if tp is not None else None,
            tp.group if tp is not None else None)

    lr = schedule(state.step)           # optax reads the count before the update
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    if state.ema_params is not None:
        d = config.moving_average_decay
        ema = [state.ema_params[n] for n in names]
        with torch.no_grad():
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, list(params), alpha=1.0 - d)
    loss_vals["learning_rate"] = torch.tensor(lr)
    state.step += 1
    return state, {k: v.detach() for k, v in loss_vals.items()}


def _refuse_ssl(config, mesh: Mesh) -> None:
    if mesh.size > 1 and (config.get("ssl_method") or config.get("unlabeled_start")):
        raise ValueError("SSL batches split their rows at unlabeled_start, a global index; "
                         "training them on a mesh of more than one rank is not ported yet "
                         "(ROADMAP A11b)")


def _sum_gradients(grads, group) -> None:
    """Sum the ranks' gradients over the data group, in place, as one
    flat buffer."""
    flat = all_reduce(torch._utils._flatten_dense_tensors(grads), group)
    for g, s in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(s)


def _global_values(config, loss_vals: Dict[str, torch.Tensor], model, mesh: Mesh,
                   tp: Optional[TensorParallel]) -> Dict[str, torch.Tensor]:
    """The global batch's loss and parts from the ranks' shares: the
    parts summed over the data group, the L2 term once (over the whole
    tensors under tensor parallelism)."""
    reg = loss_vals["reg_l2_loss"].detach()
    if tp is not None:
        squares = tp.square_sums(loss_lib.l2_named_parameters(model))
        reg = (config.weight_decay * squares / 2.0).to(reg.dtype)
    keys = [k for k in loss_vals if k != "reg_l2_loss"]
    shares = torch.stack([(loss_vals[k].detach() - loss_vals["reg_l2_loss"].detach()
                           if k == "loss" else loss_vals[k].detach()).float() for k in keys])
    shares = all_reduce(shares, mesh.data_group)
    out = {k: shares[i].to(loss_vals[k].dtype) for i, k in enumerate(keys)}
    out["loss"] = out["loss"] + reg
    out["reg_l2_loss"] = reg
    return out


def eval_step(config, state: TrainState, images, labels: Mapping) -> Dict[str, torch.Tensor]:
    """The validation loss: the model in eval mode (BatchNorm's running
    statistics; on a card, each MBConv front half through its kernel), the
    detection loss's parts, each key prefixed ``val_``."""
    model = state.model
    device = next(model.parameters()).device
    images, labels = prepare_batch(config, images, labels, device)
    model.eval()
    with torch.no_grad(), _precision_ctx(config):
        with _autocast(config, device):
            outs = model(images)
        cls_outputs, box_outputs = list(outs[0]), list(outs[1])
        if config.loss_attenuation:
            box_outputs = [loss_lib.clip_uncert_channels(
                b, config.clip_min_uncert, config.clip_max_uncert) for b in box_outputs]
        _, loss_vals = loss_lib.detection_loss(config, cls_outputs, box_outputs, labels)
    return {f"val_{k}": v for k, v in loss_vals.items()}
