"""Serving driver: raw images to packed detections with uncertainty.

Port of the serving path of ``udal_tpu/apps/serving.py``: preprocess
(normalise / resize) → deterministic or MC-dropout forward (the shared
prefix + block-0 fold, then T samples as one T·B batch; each MBConv's
front half one fused call) → global uncertainty post-processing with
soft-NMS. The fused depthwise, fused expand + depthwise and soft-NMS run as
CUDA kernels when the tensors live on a GPU. Eager PyTorch under
``inference_mode``.

Imports neither ``yaml`` nor the JAX package, so it loads on a machine that
has only PyTorch and numpy.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from udal_tpu_torch.config import Config, get_detection_config
from udal_tpu_torch.models.efficientdet import (EfficientDetNet, init_flax_style,
                                                mc_forward, preprocess_images)
from udal_tpu_torch.models.efficientnet import ChannelDropout
from udal_tpu_torch.ops.postprocess import postprocess_global


class ServingDriver:
    """End-to-end detection serving with uncertainty.

      driver = ServingDriver.create("efficientdet-d0", overrides=..., device="cuda")
      boxes, scores, classes, valid_len = driver.serve(uint8_images)

    ``state_dict`` holds the model weights (for instance from
    ``convert.flax_to_torch``). The compute dtype is bf16 on a CUDA device
    and f32 on the CPU unless ``dtype`` is given. MC-dropout masks come from
    a ``torch.Generator`` seeded with ``mc_seed``; ``self.masks`` is the
    source the forward draws from.
    """

    def __init__(self, config: Config, state_dict: Mapping[str, torch.Tensor],
                 dtype: Optional[torch.dtype] = None, mc_seed: int = 0, device=None):
        self.config = config
        self.device = torch.device(device if device is not None else "cpu")
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.dtype = dtype
        model = EfficientDetNet(config)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self.model.backbone.prepare_inference()
        generator = torch.Generator(device=self.device)
        generator.manual_seed(mc_seed)
        self.masks = ChannelDropout(generator)

    @classmethod
    def create(cls, model_name: str, state_dict: Optional[Mapping] = None,
               overrides: Optional[Dict] = None, seed: int = 0,
               **kwargs) -> "ServingDriver":
        """Driver for a named model; without ``state_dict``, random weights
        drawn as flax's initializers draw them, from ``seed``."""
        config = get_detection_config(model_name)
        if overrides:
            config.override(overrides, allow_new_keys=True)
        if state_dict is None:
            model = EfficientDetNet(config)
            init_flax_style(model, torch.Generator().manual_seed(seed))
            state_dict = model.state_dict()
        return cls(config, state_dict, **kwargs)

    # -- core program --------------------------------------------------------

    def _forward(self, images: torch.Tensor):
        cfg = self.config
        if cfg.mc_dropout and (cfg.mc_dropoutrate or cfg.mc_classheadrate or
                               cfg.mc_boxheadrate):
            return mc_forward(self.model, images, cfg.mc_dropoutsamp, self.masks)
        return self.model(images)

    def _serve_pre_impl(self, images: torch.Tensor, scales: torch.Tensor):
        cls_s, box_s = self._forward(images.to(self.dtype))
        return postprocess_global(self.config, cls_s, box_s,
                                  image_scales=scales).packed()

    def serve(self, raw_images) -> Tuple[torch.Tensor, ...]:
        """Raw uint8/float images [B, H, W, 3] → packed detection tuple
        (boxes⊕sigma_al⊕sigma_mc, scores, classes⊕sigma_cls, valid_len
        [, logits])."""
        cfg = self.config
        with torch.inference_mode():
            raw = torch.as_tensor(raw_images, device=self.device)
            images, scales = preprocess_images(raw, cfg.image_size, cfg.mean_rgb,
                                               cfg.stddev_rgb)
            return self._serve_pre_impl(images, scales)

    def serve_preprocessed(self, images, image_scales=None) -> Tuple[torch.Tensor, ...]:
        """Packed serve of already normalised and resized NHWC images;
        ``image_scales`` [B] map boxes back to the original frame."""
        with torch.inference_mode():
            images = torch.as_tensor(images, device=self.device)
            if image_scales is None:
                image_scales = torch.ones((images.shape[0],), dtype=torch.float32,
                                          device=self.device)
            scales = torch.as_tensor(image_scales, dtype=torch.float32,
                                     device=self.device)
            return self._serve_pre_impl(images, scales)
