"""Serving driver: raw images to detections with uncertainty.

Port of the serving surface of ``udal_tpu/apps/serving.py``: preprocess
(normalise / resize) → deterministic, MC-dropout (the shared prefix +
block-0 fold, or the backbone once and the heads T times, then T samples
as one T·B batch; each MBConv's front half one fused call) or deep-ensemble
forward → global uncertainty post-processing with soft-NMS. The fused
depthwise, fused expand + depthwise and soft-NMS run as CUDA kernels when
the tensors live on a GPU. Eager PyTorch under ``inference_mode``; on a
card a shape's later calls replay the model step as CUDA graphs
(``apps/detect_graph.py``).

``create_ensemble`` builds a deep-ensemble driver from the members'
training checkpoints (``utils/checkpoint.py``). The entries follow the
input reader's three batch contracts: raw images
(``serve``), normalised network-size f32 (``serve_preprocessed``),
network-size uint8 (``serve_preprocessed_uint8``, normalised on the
device) and native-size uint8 with warp parameters (the same entry; the
bilinear resize runs on the device too). Each has a ``serve_detections*``
twin that returns ``Detections`` instead of the packed tuple.

Imports neither ``yaml`` nor the JAX package, so it loads on a machine that
has only PyTorch and numpy.
"""

from __future__ import annotations

import functools
import inspect
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from udal_tpu_torch.apps.detect_graph import DetectGraphs
from udal_tpu_torch.config import Config, get_detection_config, parse_image_size
from udal_tpu_torch.models.efficientdet import (EfficientDetNet, init_flax_style,
                                                preprocess_images)
from udal_tpu_torch.models.efficientnet import ChannelDropout, ShardedDropout
from udal_tpu_torch.models.ensemble import stack_variables, unstack_variables
from udal_tpu_torch.models.stages import Stage, forward_kind, forward_stages, run_stages
from udal_tpu_torch.ops.image_ops import warp_resize_batch
from udal_tpu_torch.ops.postprocess import Detections, postprocess_global
from udal_tpu_torch.parallel.collectives import all_gather
from udal_tpu_torch.utils import profiling


def _entry(frames: str):
    """A public entry of the serve path: one root ``serve`` span a call,
    none where another entry calls it (attributes: the entry, the batch in
    argument ``frames``, the samples or members a frame)."""
    def wrap(fn):
        signature = inspect.signature(fn)

        @functools.wraps(fn)
        def entry(self, *args, **kwargs):
            with profiling.span("serve") as s:
                if s is not None:
                    batch = signature.bind(self, *args, **kwargs).arguments[frames]
                    s.attrs.update(entry=fn.__name__, batch=len(batch), samples=self._samples())
                return fn(self, *args, **kwargs)
        return entry
    return wrap


def _post(config: Config, outs, scales: Optional[torch.Tensor]) -> Detections:
    """The global post-processing of the network's outputs (``_detect``'s
    last stage)."""
    return postprocess_global(config, outs[0], outs[1], image_scales=scales)


class ServingDriver:
    """End-to-end detection serving with uncertainty.

      driver = ServingDriver.create("efficientdet-d0", overrides=..., device="cuda")
      boxes, scores, classes, valid_len = driver.serve(uint8_images)

    ``state_dict`` holds the model weights (for instance from
    ``convert.flax_to_torch``); with ``ensemble=True`` it is N members'
    stacked on a leading axis (``models.ensemble.stack_variables``,
    ``convert.flax_to_torch_stacked``) and every serve runs all members,
    fused as MC samples are. It runs on the card (``cuda``) unless
    ``device`` says otherwise, and raises without one; the CPU is asked for
    as ``device="cpu"``. The compute dtype is bf16 on a CUDA device and f32
    on the CPU unless ``dtype`` is given. MC-dropout masks come from a
    ``torch.Generator`` seeded with ``mc_seed``; ``self.masks`` is the
    source the forward draws from. ``batch_size`` is the rows of one serve
    in ``serve_sharded``, which cuts a rank's rows into batches of it; the
    other entries serve the batch they are given.
    """

    def __init__(self, config: Config, state_dict: Mapping[str, torch.Tensor],
                 batch_size: int = 1, dtype: Optional[torch.dtype] = None, mc_seed: int = 0,
                 device=None, ensemble: bool = False):
        self.config = config
        self.batch_size = batch_size
        self.ensemble = ensemble
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingDriver runs on a CUDA device unless device='cpu' is "
                               "given, and torch.cuda.is_available() is False")
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.dtype = dtype
        self.members = [self._build(sd) for sd in
                        (unstack_variables(state_dict) if ensemble else [state_dict])]
        self.num_members = len(self.members)
        self.model = self.members[0]
        generator = torch.Generator(device=self.device)
        generator.manual_seed(mc_seed)
        self.masks = ChannelDropout(generator)
        self._graphs = DetectGraphs()
        # calls of the model step eager, captured and replayed as CUDA graphs
        self.graph_stats = self._graphs.stats
        # the uint8 entries' normalisation, on the device once
        self._mean, self._std = (torch.tensor(v, dtype=torch.float32, device=self.device)
                                 for v in (config.mean_rgb, config.stddev_rgb))

    def _build(self, state_dict: Mapping[str, torch.Tensor]) -> EfficientDetNet:
        model = EfficientDetNet(self.config)
        model.load_state_dict(state_dict, strict=True)
        model = model.to(device=self.device, dtype=self.dtype).eval()
        model.prepare_inference()
        return model

    @classmethod
    def create(cls, model_name: str, state_dict: Optional[Mapping] = None,
               overrides: Optional[Dict] = None, batch_size: int = 1, seed: int = 0,
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
        return cls(config, state_dict, batch_size, **kwargs)

    @classmethod
    def create_ensemble(cls, config: Config, member_dirs: Sequence[str], batch_size: int = 1,
                        use_ema: bool = True, **kwargs) -> "ServingDriver":
        """Deep-ensemble driver from N members' checkpoint directories
        (``utils.checkpoint``, as ``train.loop.train_and_evaluate`` writes
        them): each member's latest checkpoint, EMA weights swapped in where
        it has them, stacked and served with ``ensemble=True``."""
        stacked = load_ensemble_variables(config, member_dirs, use_ema=use_ema)
        return cls(config, stacked, batch_size, ensemble=True, **kwargs)

    # -- core program --------------------------------------------------------

    def _mc(self) -> bool:
        cfg = self.config
        return bool(cfg.mc_dropout and (cfg.mc_dropoutrate or cfg.mc_classheadrate or
                                        cfg.mc_boxheadrate))

    def _samples(self) -> int:
        """Passes of the network a frame: members, MC samples or 1."""
        if self.ensemble:
            return self.num_members
        return int(self.config.mc_dropoutsamp) if self._mc() else 1

    def _forward_kind(self) -> str:
        """The forward a serve runs (``models/stages.py``)."""
        return forward_kind(self.model, self._mc(), self.ensemble)

    def _forward_stages(self, batch: int, members=None, samples=None) -> List[Stage]:
        """The stages of the network's forward of ``batch`` images: the
        ensemble's ``members`` (all by default), or ``samples`` MC samples
        (the config's T by default), or one deterministic pass."""
        if members is None or not self.ensemble:
            members = self.members
        return forward_stages(members, self._forward_kind(), batch,
                              int(samples or self.config.mc_dropoutsamp))

    def _detect_stages(self, batch: int) -> List[Stage]:
        """``_detect``'s stages for ``batch`` images: the forward's, then the
        global post-processing (span ``post``), from the state entries
        ``images`` (NHWC, compute dtype), ``scales`` and ``masks`` (a mask
        source) to ``detections``."""
        return self._forward_stages(batch) + [
            Stage("post", {}, ("outs", "scales"), "detections",
                  functools.partial(_post, self.config))]

    def _forward(self, images: torch.Tensor, masks=None, members=None, samples=None):
        """The network's outputs of ``_forward_stages``, with dropout from
        ``masks`` (the driver's source by default)."""
        state = dict(images=images, masks=self.masks if masks is None else masks)
        return run_stages(self._forward_stages(images.shape[0], members, samples), state)

    def _detect(self, images: torch.Tensor, scales: torch.Tensor, masks=None) -> Detections:
        """The model step: the forward's stages and the global
        post-processing (``detect_graph``: on a card captured as CUDA graphs
        at a shape's second call and replayed after), with dropout from
        ``masks`` (the driver's source by default)."""
        return self._graphs.detect(self, images, scales, self.masks if masks is None else masks)

    def _upload(self, frames) -> torch.Tensor:
        """The frames on the device (span ``serve.upload``: the bytes taken
        from host memory, and whether they were pinned)."""
        with profiling.span("serve.upload") as s:
            x = torch.as_tensor(frames, device=self.device)
            if s is not None:
                host = not isinstance(frames, torch.Tensor) or frames.device.type == "cpu"
                s.attrs.update(bytes=x.nbytes if host else 0,
                               pinned=isinstance(frames, torch.Tensor) and frames.is_pinned())
        return x

    def _raw(self, raw_images) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        raw = self._upload(raw_images)
        with profiling.span("serve.prep"):
            return preprocess_images(raw, cfg.image_size, cfg.mean_rgb, cfg.stddev_rgb)

    def _scales(self, image_scales, batch: int) -> torch.Tensor:
        if image_scales is None:
            return torch.ones((batch,), dtype=torch.float32, device=self.device)
        return torch.as_tensor(image_scales, dtype=torch.float32, device=self.device)

    def _pre(self, images, image_scales) -> Tuple[torch.Tensor, torch.Tensor]:
        images = self._upload(images)
        return images, self._scales(image_scales, images.shape[0])

    def _u8_prep(self, images: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
        """Normalise network-size uint8 (or warped f32) images on the device
        and zero the rows and columns past each image's ``valid_hw``."""
        x = (images.to(torch.float32) - self._mean) / self._std
        h, w = x.shape[1], x.shape[2]
        rmask = torch.arange(h, device=x.device)[None, :] < valid_hw[:, :1]
        cmask = torch.arange(w, device=x.device)[None, :] < valid_hw[:, 1:]
        return x * (rmask[:, :, None] & cmask[:, None, :])[..., None].to(x.dtype)

    def _dispatch_uint8(self, images_u8, valid_hw, image_scales, warp_scale,
                        warp_offset) -> Tuple[torch.Tensor, torch.Tensor]:
        """The fast-input entries' images on the device, normalised at the
        network size (warped first when ``warp_scale`` is given), and
        their scales. ``valid_hw`` defaults to everything valid: the
        network size with warp parameters, the input's size without."""
        x = self._upload(images_u8)
        with profiling.span("serve.prep"):
            b, h, w = x.shape[:3]
            if warp_scale is not None:
                out_hw = parse_image_size(self.config.image_size)
                if warp_offset is None:
                    raise ValueError("warp_scale comes with warp_offset (the device-resize "
                                     "reader gives both)")
                x = warp_resize_batch(x, torch.as_tensor(warp_scale, device=self.device),
                                      torch.as_tensor(warp_offset, device=self.device), out_hw)
                h, w = out_hw
            if valid_hw is None:
                valid_hw = torch.tensor([[h, w]] * b, dtype=torch.int32)
            valid_hw = torch.as_tensor(valid_hw, dtype=torch.int32, device=self.device)
            return self._u8_prep(x, valid_hw), self._scales(image_scales, b)

    # -- entries ---------------------------------------------------------------

    @_entry("raw_images")
    def serve(self, raw_images) -> Tuple[torch.Tensor, ...]:
        """Raw uint8/float images [B, H, W, 3] → packed detection tuple
        (boxes⊕sigma_al⊕sigma_mc, scores, classes⊕sigma_cls, valid_len
        [, logits])."""
        return self.serve_detections(raw_images).packed()

    @_entry("raw_images")
    def serve_detections(self, raw_images) -> Detections:
        """Structured (unpacked) serve of raw images."""
        with torch.inference_mode():
            return self._detect(*self._raw(raw_images))

    @_entry("images")
    def serve_preprocessed(self, images, image_scales=None) -> Tuple[torch.Tensor, ...]:
        """Packed serve of already normalised and resized NHWC images;
        ``image_scales`` [B] map boxes back to the original frame."""
        return self.serve_detections_preprocessed(images, image_scales).packed()

    @_entry("images")
    def serve_detections_preprocessed(self, images, image_scales=None) -> Detections:
        """Structured serve of already normalised and resized images."""
        with torch.inference_mode():
            return self._detect(*self._pre(images, image_scales))

    @_entry("images_u8")
    def serve_preprocessed_uint8(self, images_u8, valid_hw=None, image_scales=None,
                                 warp_scale=None, warp_offset=None) -> Tuple[torch.Tensor, ...]:
        """Packed serve of network-size, unnormalised uint8 images [B, H, W,
        3] (the reader's fast-input contract): the upload is uint8, and the
        normalisation and the zeroing past ``valid_hw`` [B, 2] run on the
        device. With ``warp_scale`` / ``warp_offset`` [B, 2] (y, x; the
        reader's device-resize contract) the images are native-size and
        the bilinear resize onto the network's canvas runs on the device
        first (``ops.image_ops.warp_resize_batch``)."""
        return self.serve_detections_preprocessed_uint8(
            images_u8, valid_hw, image_scales, warp_scale, warp_offset).packed()

    @_entry("images_u8")
    def serve_detections_preprocessed_uint8(self, images_u8, valid_hw=None,
                                            image_scales=None, warp_scale=None,
                                            warp_offset=None) -> Detections:
        """Structured twin of ``serve_preprocessed_uint8``."""
        with torch.inference_mode():
            return self._detect(*self._dispatch_uint8(images_u8, valid_hw, image_scales,
                                                      warp_scale, warp_offset))

    # -- over a mesh ----------------------------------------------------------

    @_entry("raw_images")
    def serve_sharded(self, mesh, raw_images) -> Tuple[torch.Tensor, ...]:
        """Serve a pool-sized batch sharded over the mesh's 'data' axis (the
        AL / SSL pool-scoring layout): every rank holds the weights, takes
        its rows of ``raw_images`` (``Mesh.data_rows``) and serves them
        through the eval path in batches of ``batch_size``; the packed
        tuples are gathered over the data group, so every rank returns the
        whole pool's. The MC masks of each batch are drawn for the rows of
        every rank and cut to this rank's (``ShardedDropout``), so a world
        of one serves what ``serve`` of the same batches serves."""
        rows = mesh.data_rows(len(raw_images))
        local = raw_images[rows]
        samples = self.config.mc_dropoutsamp if self._mc() and not self.ensemble else 1
        masks = ShardedDropout(self.masks, mesh.data_index, mesh.shape["data"], samples)
        step = max(1, int(self.batch_size))
        with torch.inference_mode():
            parts = [self._detect(*self._raw(local[i:i + step]), masks=masks).packed()
                     for i in range(0, len(local), step)]
            return tuple(all_gather(torch.cat(ts), mesh.data_group) for ts in zip(*parts))

    @_entry("raw_images")
    def serve_sample_parallel(self, mesh, raw_images) -> Tuple[torch.Tensor, ...]:
        """Latency-oriented MC serving: the batch replicated, the T MC
        samples (or the N ensemble members) split over the mesh's 'data'
        axis. Rank r runs the shared prefix once and the samples [r·T/n,
        (r+1)·T/n) of the single mask sequence (``ShardedDropout``); the
        T-moments are all-reduced in the post-processing
        (``postprocess_global(sample_group=...)``), so every rank selects
        and suppresses on the same moments and returns the same packed
        tuple. Requires T divisible by the axis."""
        n, r = mesh.shape["data"], mesh.data_index
        n_samples = self.num_members if self.ensemble else int(self.config.mc_dropoutsamp)
        if n_samples % n != 0:
            raise ValueError(
                f"serve_sample_parallel requires the sample axis "
                f"({n_samples}) divisible by the mesh 'data' axis "
                f"({n})")
        per = n_samples // n
        with torch.inference_mode():
            images, scales = self._raw(raw_images)
            images = images.to(self.dtype)
            if not (self.ensemble or self._mc()):
                return self._detect(images, scales).packed()
            outs = self._forward(images, ShardedDropout(self.masks, r, n),
                                 self.members[r * per:(r + 1) * per], per)
            return postprocess_global(self.config, outs[0], outs[1], image_scales=scales,
                                      sample_group=mesh.data_group).packed()

    # -- benchmark ------------------------------------------------------------

    def benchmark(self, raw_images, warmup: int = 3, iters: int = 10) -> Dict[str, float]:
        """Latency and throughput of the forward + post-processing on one
        preprocessed batch: ``warmup`` calls, then ``iters`` timed calls
        (each with fresh dropout masks) ending in a device synchronisation.
        Returns {"latency_ms": per call, "fps": images per second}."""
        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        with torch.inference_mode():
            images, scales = self._raw(raw_images)
            images = images.to(self.dtype)
            for _ in range(warmup):
                self._detect(images, scales)
            sync()
            t0 = time.perf_counter()
            for _ in range(iters):
                self._detect(images, scales)
            sync()
            dt = (time.perf_counter() - t0) / iters
        return {"latency_ms": dt * 1e3, "fps": images.shape[0] / dt}


def checkpoint_state_dict(config: Config, model_dir: Optional[str]) -> Dict[str, torch.Tensor]:
    """The model weights of ``model_dir``'s latest checkpoint, the EMA
    swapped in where it was kept; random weights (drawn as flax's
    initializers draw them from seed 0) when there is no directory or it
    holds none, as the JAX package's restore leaves a fresh state."""
    from udal_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint, swap_in_ema

    epoch = latest_checkpoint(model_dir) if model_dir else None
    if epoch is not None:
        return swap_in_ema(load_checkpoint(model_dir, epoch))
    model = EfficientDetNet(config)
    init_flax_style(model, torch.Generator().manual_seed(0))
    return model.state_dict()


def load_ensemble_variables(config: Config, member_dirs: Sequence[str],
                            use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """N members' state dicts from their latest checkpoints (EMA weights
    swapped in when present and ``use_ema``), stacked on a leading axis for
    ``ServingDriver(ensemble=True)``, which loads each into ``config``'s
    model strictly."""
    from udal_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint, swap_in_ema

    members = []
    for d in member_dirs:
        epoch = latest_checkpoint(d)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint in ensemble member {d}")
        payload = load_checkpoint(d, epoch)
        members.append(swap_in_ema(payload) if use_ema else payload["model"])
    return stack_variables(members)
