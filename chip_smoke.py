"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure ends the run with a traceback and a nonzero
exit code:

1. device: a CUDA card is required; prints its name and power limit
   (nvidia-smi), the torch and CUDA versions; turns TF32 off.
2. build: compiles ``udal_tpu_torch/csrc/{soft_nms,fused_dw,
   fused_expand_dw,packed_pointwise,packed_lane,fused_sepconv}.cu`` with
   nvcc (sm_90a), one process each, all at once; prints each kernel
   instance's registers, shared memory and spills (soft-NMS and the fused
   depthwise must not spill), and the count of tensor-core instructions
   (HMMA, HGMMA) in the libraries of packed_pointwise, fused_expand_dw and
   fused_sepconv (cuobjdump -sass), which must not be 0.
3. kernels vs plain, on the card:
   - soft-NMS at the main path's shapes (B=8, N=5000, K=100), gaussian and
     hard, random and tied scores: equal valid_len, equal indices over it,
     scores within 1e-6; the cluster size it launches with (blocks an
     image), its time, and the latency of one pick ((time at K - time at
     K=1) / (K-1), the dependency floor of the K picks). Then the same
     check on per-class operands (gaussian and hard): boxes shifted by
     class ids in [0, 10) times 2·1024, as ``per_class_nms`` shifts them.
   - fused depthwise and fused expand + depthwise in f32 at N=8, every
     (k, s) in {3,5}x{1,2}: the depthwise on its fast and its general path
     with act swish and identity, with and without mask and mean; the
     expand with and without masks. Both
     sides sum in f32 in another order: 1e-5 (depthwise) and 1e-4 (expand,
     up to 192 products a sum), absolute and relative.
   - both in bf16 at the main path's shapes (the MC prefix at B=8, blocks
     1, 3 and 12 at T*B=80), against the plain version on the same bf16
     inputs, which computes in f32 and rounds where the kernel rounds:
     within 1 bf16 ulp plus 1% of an ulp of the largest value (depthwise:
     one rounding of values that differ in the f32 sum order; near zero,
     where the pre-activation cancels, that difference scales with the
     terms, not the result), 2 ulps plus 1 ulp of the largest value
     (expand: an expanded value can round the other way), SE sums and
     means to 1e-3 of their largest value.
   Median times of kernel, plain version and the unfused bf16 eager chain
   (the unfused block code), from CUDA events (the depthwise at the MC
   prefix on its fast path, which it must take, beside its general path,
   held to the same tolerances); then the bf16 expand
   kernel's time at each of d0's 15 expand blocks at T*B=80 and their sum,
   and at each distinct expand block of B7 at d7x's 1536x768 and B=8: the
   planned launch (16-byte copies, the weights streamed through the ring)
   and the resident layout (plain loads), each held to the plain version
   within 2 + 1 bf16 ulps and SE sums to 1e-3, y equal bit for bit between
   the two; each time beside its tile, its bound and the launches a serve.
   - the fused separable conv (``SEPCONV_CASES``), one launch a level:
     in bf16 a tower layer, a BiFPN node and the two predict convs at
     d0's five levels of 1024x512 (the heads at T*B=320, the BiFPN at
     B=32; the first kernel) and at d7x's six of 1536x768 (the heads at
     T*B=80, the BiFPN at B=8; Cin = 384, the resident kernel), against
     the plain version on the same inputs within 2 bf16 ulps plus 1 of
     the largest value (both round pre(x) and the depthwise to bf16; the
     f32 sums run in other orders). Each layer over all its levels: the
     kernel's and the unfused bf16 chain's device time (ATen's depthwise,
     cuDNN's 1x1, BatchNorm, the activation, the mask; 10 calls a CUDA
     graph), at d7x also the first kernel's at its own plans, the plain
     version's (CUDA events), and the bound of the bytes in and out once
     and the products. Then a d7x serve at 1536x768 (B=2, replayed):
     its 152 launches read from a trace of the card, every one resident;
     d0's 64 a serve (phases 4, 7, 8, 12) none.
4. the slice at full width: MC-dropout EfficientDet-d0 (1024x512, 8
   classes, loss attenuation, T=10 at rate 0.05, batch 8, bf16, random
   weights from a seed) serves uint8 batches; checks the packed shapes,
   finiteness, detections, and that every serve call launched the fused
   depthwise kernel once (the MC prefix, on its fast path), the fused
   expand + depthwise
   kernel 15 times (blocks 1-15), the NMS kernel once and the fused
   separable conv 64 times (``sepconv_per_forward``: 24 BiFPN nodes, and
   in each head 3 tower layers and the predict conv at 5 levels; as many
   a member in every bf16 serve phases 7, 8 and 12 count; phase 5's f32
   serves run the chain and launch none). With
   ``--profile``, a torch.profiler operator split of two serves follows
   (and of each phase-7 path), with the card's busy time a call against
   the call's unprofiled host time.
5. device parity: the same weights (numpy from a seed, through
   ``convert.py``) at 128x128 in f32 served on the CPU (plain versions) and
   on the card (kernels) with the same dropout masks, on the MC fold path,
   the MC path without the fold (block 0 masked at T*B), the
   deterministic path, head-only MC (``serve_preprocessed``, and
   ``serve_detections_preprocessed_uint8`` from native-size uint8 frames
   with warp parameters), ``EfficientDetModel`` with per-class NMS and a
   2-member ensemble; detections agree as matched sets, and the kernels
   ran on the card only (the depthwise on its fast path), as many times as
   each path launches them. Then one f32 train step (dropout off, TF32
   off) from the same weights and batch on the CPU and on the card: the
   losses to 1e-4, the gradients as a tree to 1e-2 relative L2 and each
   leaf that is not rounding noise to 3e-2, no kernel launched in the
   step, and the stepped models' serves agree as matched sets (1/15/1 on
   the card).
6. the packed-layout microbench (``udal_tpu_torch.tools.perf_packed``, the
   port of ``tools/perf_packed.py``): ``check`` at the tool's shapes (the
   script's references; each of the five kernels against its plain
   version: B4 within 1 bf16 ulp plus 1% of the largest value's, B5-B7
   exact, B8 within 1 ulp), then every timed case, asserting each kernel's
   launch count. The packed rows of the summary give the medians of the
   tool's CUDA-graph replays (device time: B6 and B7 run for less time than
   their wrappers take on the host). Then B6, B7 and ``x + 1`` streamed
   from HBM (each a graph of 8 calls on 8 copies of the input, every output
   kept: 252 MB, past the 50 MB L2) in 5 rounds of 20 replays each, in
   turns: the median and spread of each a call, and each against the bound
   of the bytes they move at HBM's rate.
7. the repo's own inference configurations at full width (bf16, batch 8,
   random weights from a seed, 4 calls a path, medians of calls 2-4, then
   4 calls more in a trace of the card that counts their launches):
   - KITTI (``configs/train/allclasses_mcdropout_lossatt_head.yaml``:
     7 classes, head-only MC T=10, softmax logits) through
     ``serve_detections_preprocessed_uint8`` from native 375x1242 uint8
     frames with the device-resize reader's warp parameters: 1/15/1
     launches a call, the shapes, finite values, detections; ms/batch,
     img/s, peak memory, the device time of the warp + uint8 prep alone,
     and ``ServingDriver.benchmark``'s result;
   - BASELINE config #3: a 5-member ensemble at the overrides of
     ``configs/train/allclasses_lossatt_BDD.yaml`` (10 classes) serving
     [8, 512, 1024, 3] uint8: 5/75/1 launches a call;
   - ``EfficientDetModel(post_mode="per_class")`` at the KITTI
     configuration: one soft-NMS launch a call.
8. training at KITTI's operating point, full width (the overrides of
   ``configs/train/allclasses_mcdropout_lossatt.yaml``: 7 classes,
   1024x512, MC dropout 0.05, loss attenuation, MSE box loss x100, bf16,
   no EMA; batch 8 from ``configs/train/train_runner.ini``; SGD 0.9, cosine
   with warmup, clip 10; random weights from a seed): ``train_and_evaluate``
   for 2 epochs x 5 steps with a validation step and a checkpoint an epoch,
   on host-made uint8 frames with 1-8 boxes each (targets assigned on the
   card): finite losses, the validation steps' kernel launches (1/15/0 each;
   the train steps launch none), ms/step (median of steps 2-10, each timed
   to a synchronisation), img/s, peak memory, the first and last loss, the
   learning rates. A second call resumes from the epoch-2 checkpoint for a
   third epoch; the trained weights then serve (MC T=10, bf16) with 1/15/1
   launches a call and finite detections. With ``--profile``, a
   torch.profiler split of two train steps and the card's idle share.
9. calibrate, threshold, auto-label and validate at KITTI's inference
   configuration (``configs/inference/inference_k.yaml``, whose hparams
   are phase 7's KITTI file: head-only MC T=10, 7 classes, softmax
   logits), 1024x512, bf16, batch 8, random weights from a seed, on
   synthetic uint8 frames with groundtruth: ``Calibrate.run`` over 4
   batches (the calibrators read back from their ``.npz`` files),
   ``UncertOptimal`` on the gathered entropy and relative aleatoric σ
   (its thresholds read back), ``InferImages`` with the calibrators,
   weights and thresholds, auto-labeling, over 2 batches
   (``prediction_data.txt`` read back, the calibrated σ finite, every
   image labeled or to examine), ``Validator`` over 2 batches (its four
   artifacts, ``validate_results.txt`` read back) and
   ``consistency_check`` (flip, the card's 9x9 blur, noise) on one batch;
   1/15/1 launches a serve in every app; each app's time a batch, split
   into the serve (timed to a synchronisation) and the host. The
   temperature fits on the gathered arrays agree card vs CPU within 1e-5
   relative. It writes and removes ``build/chip_smoke_apps/``.
10. training and evaluation fed from TFRecords, through the CLI, at
   KITTI's training operating point: 48 frames of 375x1242 (smooth colour
   fields, pixel noise, 1-10 flat boxes of KITTI's classes, from a seed)
   encoded by the port's PNG encoder with ``label_2`` files,
   ``kitti_to_tfrecord`` into 32 train and 16 val records;
   ``cli.main(["train", ...])`` with ``--hparams`` a copy of
   ``configs/train/allclasses_mcdropout_lossatt.yaml`` (map_freq and
   save_freq 1) read by the port's YAML reader, batch 8, 2 epochs x 4
   steps: ms a step (each timed to a synchronisation), the reader's
   input-wait share, the COCO callback's ms an evaluation (split into the
   serves, the driver build and the rest) and its AP in [0, 1], its
   launches asserted 1/1/15 (soft-NMS, fused depthwise on its fast path,
   fused expand) a validation batch plus its NMS grid's 9/1/15 (a
   post-processing a cell, one forward of the probe image); one epoch
   with ``--device_resize``;
   ``cli eval --fine_grid`` (dropout off) from the checkpoint, its COCO
   numbers equal to the callback's on the same weights and val file
   within 1e-6 (at least one of them above 0), and ``inspect --mode
   validate``, each 1/15/1 a batch, with img/s; the reader alone (decode +
   resize + labels, the classic contract) at 1, 4 and 8 threads and 4
   processes, and with ``fast_input`` at 1 and 8 threads, against the
   21.4 img/s a 373.7 ms step needs; the committed 1280x720 JPEG fixtures
   (``tests/data/torch_jpeg``) decoded to the sha256 of cv2's decode, with
   img/s. ``--profile`` adds a torch.profiler split of a train step on a
   reader batch. It writes and removes ``build/chip_smoke_reader/``.
11. augmentation, active learning and SSL at the main path's operating
   point (8 classes, 1024x512, MC T=10 at rate 0.05, loss attenuation,
   the KITTI training file's other hparams with save_freq 1, batch 8,
   bf16), on 96 KITTI PNG frames written as phase 10 writes them: the
   training reader with autoaugment_policy v0, randaug and albu (img/s on
   1 and 8 threads, uint8 contract, beside no policy); ``cli al`` over a
   pool of 48 (entropy, budgets 25,25, 4 steps an iteration): each train
   step's ms, ``collect_pool``'s ms and img/s with its serves' stream time
   (CUDA events, no synchronisation) against its wall time, 1/15/1
   launches a pool batch asserted, and a rerun that resumes to the same
   selection with no step and no launch; the whole pool scored again by the
   trained model in the classic and the uint8 reader contracts (wall time
   and the serves' stream time of each); ``cli ssl --method stac
   --stac_randaug`` (16 labelled, 32 unlabelled, tau 0, 4 teacher and 4
   student steps) with 1/15/1 launches a pseudo-label batch asserted, and
   ``cli ssl --method csd`` (4 steps); ``Validator(infer_augment=[heq, alb,
   aug, flip])`` on one batch: 20 serves at 1/15/1 asserted, the variants'
   stream time on the card against the same variants made image by image
   on the host. It writes and removes ``build/chip_smoke_al/``.
12. the apps' image artifacts and profiling at phase 9's KITTI inference
   configuration (batch 8, bf16) on 48 native 375x1242 PNG frames written
   as phase 10 writes them, read by the device-resize reader:
   ``InferImages`` with auto-labeling over 4 batches without and with
   ``save_visualizations`` (1/15/1 launches a serve asserted; every
   overlay, uncertainty panel, bucket copy and contact sheet read back
   with the port's decoder, its shape checked; ms a batch split into the
   serve, drawing, PNG writing, the buckets' read-back and the rest of
   the host, beside the run without artifacts); ``Validator`` over the
   same batches and ``export_quadrant_crops`` over its rows;
   ``plot_tfrecord_groundtruth`` over the 16 val frames; two serves under
   ``utils.profiling.trace`` (the Chrome trace names the soft-NMS, fused
   depthwise and expand kernels) and ``device_memory_stats``. It writes
   and removes ``build/chip_smoke_artifacts/``; rehearse it on the CPU as
   phase 11 (``phase12("cpu", "...", native=(60, 100),
   extra=dict(image_size="64x64", fpn_cell_repeats=1, box_class_repeats=1,
   mc_dropoutsamp=2))``, ~5 s).
13. multi-GPU, the port over ``torch.distributed`` on the one card: (a) a
   world of one over NCCL (a TCP store on 127.0.0.1): a data-parallel
   step at phase 8's operating point equal to the single process's with
   cuDNN deterministic (and the single bf16 step's swing when the batch's
   rows are only reordered), ``serve_sharded`` of 16 images equal to two
   ``serve`` calls with 1/15/1 launches a batch, ``serve_sample_parallel``
   at T=10 equal to ``serve``; (b) two spawned processes sharing the card
   over gloo: which collectives gloo takes on CUDA tensors, f32
   data-parallel (4 rows a rank) and tensor-parallel (n_model 2) steps
   against the single process's f32 step (loss 2e-3 relative, update 1e-2
   relative L2), each rank's parameter + optimizer bytes, and
   ``serve_sample_parallel`` with 5 samples a rank (1/15/1 launches on
   each) against the same split samples served in one process. It writes
   and removes ``build/chip_smoke_parallel/``; rehearse it on the CPU from
   a script with the ``__main__`` guard, one torch thread and ``per_serve``
   giving (0, 0, 0): ``phase13(torch.device("cpu"), "...", 0.0, 0.0,
   extra=dict(image_size="64x64", fpn_cell_repeats=1, box_class_repeats=1,
   mc_dropoutsamp=2))``, ~25 s.
   Then the script's total time.

Every count of the serve's launches is read from a trace of the card
(``profiling.KernelLaunches``): a driver's later calls replay CUDA graphs,
whose kernels launch without their wrappers' counters.

The line before the last is a JSON summary of the kernels: each with its
launches on the main path (phase 4's traced calls, or phase 6's timed cases for the
probes), largest error, time (soft_nms and fused_dw: device time of 10
calls captured in a CUDA graph; fused_expand_dw: CUDA events around eager
calls; the packed rows: the tool's graph medians, rows 6-7 and their
plain version the 5-round medians of phase 6, streamed from HBM;
fused_sepconv: d0's tower layer over its five levels at T*B=320, 10
calls in a CUDA graph, its launches those of phase 4's traced serves),
plain time (CUDA events
around eager calls), its bound (the largest of the
bytes it must move at 3.35 TB/s, its bf16 operations on tensor cores at
989 TFLOP/s and its f32 operations at 67 TFLOP/s, the H100 SXM data
sheet's rates), and the time of one PyTorch call that computes the same
function where there is one (fused_sepconv: the unfused chain's device
time). The last line is ``{"ok": true, "device":
{...}}``.
"""

import ast
import collections
import contextlib
import hashlib
import itertools
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from udal_tpu_torch import cli
from udal_tpu_torch.apps import calibration
from udal_tpu_torch.apps.calibrate_model import Calibrate
from udal_tpu_torch.apps.infer import (InferImages, consistency_check, read_prediction_data,
                                       split_serve_outputs)
from udal_tpu_torch.apps.serving import ServingDriver, checkpoint_state_dict
from udal_tpu_torch.apps.thresholding import UncertOptimal, read_optimal_thresholds
from udal_tpu_torch.apps.validate import Validator, read_validate_results
from udal_tpu_torch.config import get_detection_config, parse_image_size
from udal_tpu_torch.convert import flax_to_torch, torch_to_flax
from udal_tpu_torch.models.efficientdet import EfficientDetModel, EfficientDetNet, init_flax_style
from udal_tpu_torch.models.bifpn import SeparableConv
from udal_tpu_torch.models.ensemble import init_ensemble, stack_variables
from udal_tpu_torch.models.efficientnet import (BatchNorm, ChannelDropout, Conv2d,
                                                activation_fn, backbone_spec,
                                                block_input_sizes)
from udal_tpu_torch.data.dataloader import InputReader
from udal_tpu_torch.data.dataset_creators import kitti_to_tfrecord
from udal_tpu_torch.data.image_codec import decode_image, encode_png
from udal_tpu_torch.data.label_maps import get_label_map
from udal_tpu_torch.data import tfrecord
from udal_tpu_torch.data.synthetic import synthetic_batch
from udal_tpu_torch.ops import (_build, cuda_nms, fused_dw, fused_mbconv, fused_sepconv, nms,
                                packed)
from udal_tpu_torch.ops.image_ops import gaussian_blur_uint8, resize_bilinear_uint8
from udal_tpu_torch.tools import perf_packed
from udal_tpu_torch.train import loop, train_lib
from udal_tpu_torch.train.callbacks import COCOCallback
from udal_tpu_torch.utils import profiling
from udal_tpu_torch.utils.checkpoint import (latest_checkpoint, load_checkpoint,
                                             restore_checkpoint, swap_in_ema)

MAIN_PATH = dict(image_size="1024x512", num_classes=8, loss_attenuation=True,
                 mc_dropout=True, mc_dropoutrate=0.05, mc_dropoutsamp=10)
# phase 7: the repo's own inference configurations. The card has no yaml, so
# each file's overrides are carried here as they stand in it
# (tests/test_torch_config.py holds them against the files).
KITTI_HEAD = ("configs/train/allclasses_mcdropout_lossatt_head.yaml", dict(
    num_classes=7, image_size="1024x512", moving_average_decay=0, mixed_precision=True,
    map_freq=20, label_map="kitti", save_freq=20, enable_softmax=True, mc_dropout=True,
    mc_boxheadrate=0.05, mc_classheadrate=0.05, loss_attenuation=True, box_loss_weight=100.0,
    boxloss_type="MSE"))
BDD = ("configs/train/allclasses_lossatt_BDD.yaml", dict(
    num_classes=10, image_size="1024x512", moving_average_decay=0, mixed_precision=True,
    map_freq=20, label_map="bdd", save_freq=20, enable_softmax=True, loss_attenuation=True,
    box_loss_weight=100.0, boxloss_type="MSE"))
# phase 8: KITTI's training operating point (the overrides of the MC-dropout +
# loss-attenuation hparams file, and the runner's batch)
KITTI_TRAIN = ("configs/train/allclasses_mcdropout_lossatt.yaml", dict(
    num_classes=7, image_size="1024x512", moving_average_decay=0, mixed_precision=True,
    map_freq=20, label_map="kitti", save_freq=20, enable_softmax=True, mc_dropout=True,
    mc_dropoutrate=0.05, loss_attenuation=True, box_loss_weight=100.0, boxloss_type="MSE"))
KITTI_RUNNER = ("configs/train/train_runner.ini", dict(batch_size=8))
TRAIN_EPOCHS, TRAIN_STEPS = 2, 5   # cut from the runner's 500 epochs of 748 steps
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
KITTI_NATIVE = (375, 1242)     # a KITTI frame's native size
# phase 9: calibrate -> thresholds -> auto-label -> validate at KITTI's
# inference configuration (configs/inference/inference_k.yaml takes its
# hparams from KITTI_HEAD's file), batches of BATCH synthetic frames
APPS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_apps"
CALIB_BATCHES, INFER_BATCHES, VAL_BATCHES = 4, 2, 2
ENSEMBLE_MEMBERS = 5           # BASELINE config #3
BATCH, N_CAND, K = 8, 5000, 100
SERVE_CALLS = 4
SOURCES = ("soft_nms", "fused_dw", "fused_expand_dw", "packed_pointwise", "packed_lane",
           "fused_sepconv")
# the packed probes: (kernel, source, TPU kernel, the tool's kernel and plain cases)
PACKED_ROWS = (
    ("packed_pointwise", "packed_pointwise", "tools/perf_packed.py:80",
     "packed_pw_128x256x24to144", "plain_pw_128x256x24to144"),
    ("packed_wshift", "packed_lane", "tools/perf_packed.py:147",
     "packed_wshift_128x32x1152", "plain_packed_wshift_128x32x1152"),
    ("add_one_natural", "packed_lane", "tools/perf_packed.py:236", "p1_reshape_roundtrip",
     "p1_plain"),
    ("add_one_packed", "packed_lane", "tools/perf_packed.py:264", "p1_copy_baseline", "p1_plain"),
    ("packed_dw_w3", "packed_lane", "tools/perf_packed.py:296", "p2_packed_dwW_128x32x1152",
     "plain_p2_packed_dwW_128x32x1152"))
# the fused kernels at the main path's shapes: (what, N, Cin, Ce, H, W, k, s)
PREFIX = ("MC prefix (block 0)", BATCH, 32, 32, 256, 512, 3, 1)
BLOCKS = (("block 1", 80, 16, 96, 256, 512, 3, 2),
          ("block 3", 80, 24, 144, 128, 256, 5, 2),
          ("block 12", 80, 192, 1152, 16, 32, 5, 1))
# phase 3's fused separable convs, bf16: (what, pre, post, BatchNorm, mask, N,
# Cin, Cout, levels); d0's pyramid at 1024x512 (the heads at T·B = 320 as in
# kitti_head.serve_native_b32's, the BiFPN at B = 32; 7 classes, 9 anchors,
# boxes with σ), d7x's at 1536x768 (the heads at T·B = 80, the BiFPN at B = 8;
# 10 classes)
D0_LEVELS = ((64, 128), (32, 64), (16, 32), (8, 16), (4, 8))
D7X_LEVELS = ((96, 192), (48, 96), (24, 48), (12, 24), (6, 12), (3, 6))
SEPCONV_CASES = (
    ("d0 tower layer", "identity", "swish", True, True, 320, 64, 64, D0_LEVELS),
    ("d0 BiFPN node", "swish", "identity", True, False, 32, 64, 64, D0_LEVELS),
    ("d0 class predict", "identity", "identity", False, False, 320, 64, 63, D0_LEVELS),
    ("d0 box predict", "identity", "identity", False, False, 320, 64, 72, D0_LEVELS),
    ("d7x tower layer", "identity", "swish", True, True, 80, 384, 384, D7X_LEVELS),
    ("d7x BiFPN node", "swish", "identity", True, False, 8, 384, 384, D7X_LEVELS),
    ("d7x class predict", "identity", "identity", False, False, 80, 384, 90, D7X_LEVELS),
    ("d7x box predict", "identity", "identity", False, False, 80, 384, 72, D7X_LEVELS))
# f32 checks at N=8 over every (k, s): shapes of d0's blocks at 1024x512
F32_BLOCKS = {(3, 2): (16, 96, 256, 512), (3, 1): (24, 144, 128, 256),
              (5, 2): (24, 144, 128, 256), (5, 1): (192, 1152, 16, 32)}
# d0's expand blocks 1-15 at the main path's shapes: (index, Cin, Ce, H, W, k, s)
EXPAND_BLOCKS = [(i, a.input_filters, a.input_filters * a.expand_ratio, h, w, a.kernel_size,
                  a.strides[0])
                 for i, (a, h, w) in enumerate(block_input_sizes(backbone_spec("efficientnet-b0"),
                                                                 256, 512)) if i > 0]
# B7's expanding blocks at d7x's 1536x768: {(Cin, Ce, H, W, k, s): launches a serve}
B7_EXPAND = collections.Counter(
    (a.input_filters, a.input_filters * a.expand_ratio, h, w, a.kernel_size, a.strides[0])
    for a, h, w in block_input_sizes(backbone_spec("efficientnet-b7"), 384, 768)
    if a.expand_ratio > 1)
# the card's data-sheet rates (H100 SXM, 700 W): bytes/s, bf16 tensor-core
# and f32 FLOP/s
HBM_RATE, BF16_RATE, F32_RATE = 3.35e12, 989e12, 67e12


def bound(nbytes, bf16_flops=0.0, f32_flops=0.0):
    """(ms, "bytes" or "operations"): the largest of the bytes over the
    memory rate and the operations of each type over that type's peak rate
    (tensor cores and CUDA cores run side by side)."""
    t_bytes = nbytes / HBM_RATE * 1e3
    t_ops = max(bf16_flops / BF16_RATE, f32_flops / F32_RATE) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def expand_bound(n, cin, ce, h, w, k, s, itemsize=2):
    """The fused expand + depthwise's bound: x in and y out once (masks,
    parameters and SE sums are small), the expand on tensor cores, the
    depthwise and the per-value bias, swish and mask in f32."""
    ho, wo = -(-h // s), -(-w // s)
    nbytes = (n * cin * h * w + n * ce * ho * wo) * itemsize + n * ce * 4
    return bound(nbytes, 2.0 * n * h * w * cin * ce,
                 n * ce * (h * w * 4.0 + ho * wo * (2 * k * k + 4)))


def phase(n, msg):
    print(f"[phase {n}] {msg}", flush=True)


def random_boxes(rng, b, n, tied=False, size=256):
    y1 = rng.uniform(0, size - 30, (b, n))
    x1 = rng.uniform(0, size - 30, (b, n))
    h = rng.uniform(10, 80, (b, n))
    w = rng.uniform(10, 80, (b, n))
    boxes = np.stack([y1, x1, y1 + h, x1 + w], -1).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, (b, n)).astype(np.float32)
    if tied:
        scores = np.asarray([0.3, 0.6, 0.9], np.float32)[rng.randint(0, 3, (b, n))]
    return boxes, scores


def cuda_median_ms(fn, runs=25, warmup=5):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_median_ms(fn, runs=25, calls=10):
    """Device time of one call of ``fn``: ``calls`` calls captured in a CUDA
    graph, the median of ``runs`` replays over ``calls``. The kernels' own
    time and the gaps between them, without the host's launch overhead or
    the graph's own start (about 10 us on the H100). Counts ``calls``
    launches of each kernel ``fn`` launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_median_ms(graph.replay, runs) / calls


def ptxas_summary(name):
    """One line per kernel instance: registers, shared memory, spills.
    Returns the instances that spill."""
    spills, entry, spilled = "", None, []
    for line in _build.library_path(name).with_suffix(".log").read_text().splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            base = re.search(r"(soft_nms_kernel|fused_dw_kernel|fused_dw_rows_kernel|"
                             r"fused_expand_dw_kernel|fused_sepconv_tc_kernel|"
                             r"fused_sepconv_resident_kernel|"
                             r"expand_dw_tc_kernel_streamed|expand_dw_tc_kernel|sum_partials|"
                             r"packed_pointwise_gmma_kernel|"
                             r"packed_pointwise_kernel|"
                             r"wshift_kernel|add_one_kernel|dw_w3_kernel)(I.*?EE)?", m.group(1))
            args = base.group(2) or ""
            kind = ("bf16" if "bfloat16" in args or base.group(1) in (
                "expand_dw_tc_kernel", "expand_dw_tc_kernel_streamed", "fused_sepconv_tc_kernel",
                "fused_sepconv_resident_kernel")
                    else ("f32" if args.startswith("If")
                          or base.group(1) == "fused_expand_dw_kernel" else ""))
            entry = base.group(1) + "<" + ",".join(
                [kind] * bool(kind) + re.findall(r"L[ib](\d+)E", args)) + ">"
        elif "spill" in line:
            spills = line.split(":")[-1].strip()
        elif "registers" in line:
            print(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}; {spills}")
            if re.search(r"[1-9]\d* bytes spill", spills):
                spilled.append(entry)
    return spilled


def tensor_core_instructions(name):
    """Count of HMMA and HGMMA instructions in csrc/<name>.cu's library."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return len(re.findall(r"\bHG?MMA\.", sass))


def time_expand_blocks(dev, rng, smi):
    """Phase 3: the bf16 expand kernel at each of d0's 15 expand blocks at
    T*B = 80, then at each distinct expand block of B7 at d7x's 1536x768
    and B = 8: the planned launch (16-byte copies, weights streamed) and
    the resident layout (plain loads: the split weights 2 bytes off an
    aligned address) each held to the plain version, y equal bit for bit
    between the two, and both timed. Returns {block: ms} of d0's blocks."""
    times = {}
    for i, cin, ce, h, w, k, s in EXPAND_BLOCKS:
        o = fused_operands(rng, 80, cin, ce, h, w, k, dev, torch.bfloat16)
        args = (o["x"], o["we"], o["b0"], o["m1"], o["wd"], o["b1"], o["m2"], s, k, "swish",
                fused_mbconv.split_weights(o["we"]))
        times[i] = cuda_median_ms(lambda: fused_mbconv.fused_expand_dw_cuda(*args), runs=15,
                                  warmup=3)
        th, tw, streamed = fused_mbconv.tc_tile_shape(-(-h // s), -(-w // s), cin, s, k)
        b_ms, b_by = expand_bound(80, cin, ce, h, w, k, s)
        phase(3, f"fused_expand_dw bf16 block {i}: 80x{cin}->{ce} {h}x{w} k{k} s{s}, tile "
                 f"{th}x{tw} {'streamed' if streamed else 'resident'}: {times[i]:.4f} ms; "
                 f"bound {b_ms:.4f} ms ({b_by}); {smi}")
        del o, args
    phase(3, f"fused_expand_dw bf16 over the 15 blocks: {sum(times.values()):.4f} ms "
             f"(kernel medians, one call each); {smi}")
    total = {"planned": 0.0, "resident": 0.0, "bound": 0.0}
    for (cin, ce, h, w, k, s), count in sorted(B7_EXPAND.items()):
        o = fused_operands(rng, 8, cin, ce, h, w, k, dev, torch.bfloat16)
        args = (o["x"], o["we"], o["b0"], o["m1"], o["wd"], o["b1"], o["m2"], s, k, "swish")
        split = fused_mbconv.split_weights(o["we"])
        plain_loads = tuple(two_bytes_off(t) for t in split)
        ho, wo = -(-h // s), -(-w // s)
        plan = fused_mbconv.tc_tile_shape(ho, wo, cin, s, k)
        resident = fused_mbconv.tc_tile_shape(ho, wo, cin, s, k, vec=False)
        launch = {"planned": lambda: fused_mbconv.fused_expand_dw_cuda(*args, split),
                  "resident": lambda: fused_mbconv.fused_expand_dw_cuda(*args, plain_loads)}
        want = fused_mbconv.fused_expand_dw_plain(*args[:-1])
        outs = {layout: fn() for layout, fn in launch.items()}
        torch.cuda.synchronize()
        errs = []
        for layout, out in outs.items():
            excess, in_top = bf16_excess(out[0], want[0], 2, 1)
            if excess > 0:
                raise AssertionError(f"fused_expand_dw d7x {cin}->{ce} k{k} s{s}, {layout} "
                                     f"launch: y beyond 2 + 1 top bf16 ulps by {excess}")
            torch.testing.assert_close(out[1], want[1], rtol=1e-3,
                                       atol=1e-3 * float(want[1].abs().max()))
            se_err = float((out[1] - want[1]).abs().max() / want[1].abs().max())
            errs.append(f"{layout} max err {in_top:.2f} ulp of max|y|, SE {se_err:.3g}")
        if not torch.equal(outs["planned"][0], outs["resident"][0]):
            raise AssertionError(f"d7x {cin}->{ce} k{k} s{s}: the streamed layout's y "
                                 f"differs from the resident one's")
        ms = {layout: cuda_median_ms(fn, runs=15, warmup=3) for layout, fn in launch.items()}
        b_ms, b_by = expand_bound(8, cin, ce, h, w, k, s)
        phase(3, f"fused_expand_dw bf16 d7x 8x{cin}->{ce} {h}x{w} k{k} s{s} ({count} a serve), "
                 f"tile {plan.th}x{plan.tw} {'streamed' if plan.streamed else 'resident'}: "
                 f"{ms['planned']:.4f} ms; resident, plain loads, {resident.th}x{resident.tw}: "
                 f"{ms['resident']:.4f} ms; against the plain version: {'; '.join(errs)}; "
                 f"bound {b_ms:.4f} ms ({b_by}); {smi}")
        total["planned"] += count * ms["planned"]
        total["resident"] += count * ms["resident"]
        total["bound"] += count * b_ms
        del o, args, split, plain_loads, want, outs
    phase(3, f"fused_expand_dw bf16 over d7x's {sum(B7_EXPAND.values())} launches: "
             f"{total['planned']:.4f} ms as planned, {total['resident']:.4f} ms resident with "
             f"plain loads; bound {total['bound']:.4f} ms; {smi}")
    return times


def two_bytes_off(t):
    """A copy of ``t`` 2 bytes off an aligned address, which the bf16
    expand kernel's 16-byte copies cannot take."""
    base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = base[1:].view(t.shape)
    view.copy_(t)
    return view


def bf16_excess(got, want, ulps, top_ulps):
    """Largest amount by which |got - want| exceeds ulps · ulp(|want|) +
    top_ulps · ulp(max |want|) (bf16 spacing: 8 significant bits); <= 0
    passes. Also returns the largest error in ulps of the largest value."""
    got, want = got.float(), want.float()

    def ulp(t):
        return torch.ldexp(torch.ones_like(t), torch.frexp(t.abs())[1] - 8)

    top = ulp(want.abs().max())
    err = (got - want).abs()
    return (float((err - ulps * ulp(want) - top_ulps * top).max()),
            float(err.max() / top))


def eager_chain(x, block, m1, m2):
    """The unfused chain the fused kernels replace, op by op as the unfused
    ``MBConvBlock`` ran it in x's type: expand conv, bn0, swish, mask, TF
    SAME pad, depthwise conv, bn1, swish, mask, spatial mean."""
    act = activation_fn("swish")
    if "expand_conv" in block:
        x = act(block["bn0"](block["expand_conv"](x))) * m1.to(x.dtype)[:, :, None, None]
    x = act(block["bn1"](block["depthwise_conv"](x)))
    if m2 is not None:
        x = x * m2.to(x.dtype)[:, :, None, None]
    return x, torch.mean(x, dim=(2, 3))


def fused_operands(rng, n, cin, ce, h, w, k, dev, dtype, masked=True):
    """Random operands of one fused call, f32 parameters, x in ``dtype``;
    BN stats in the ranges of the parity tests."""
    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    x = f32(rng.normal(0, 1, (n, cin, h, w))).to(dtype)
    masks = [f32((rng.uniform(size=(n, ce)) < 0.95) / 0.95) if masked else None
             for _ in range(2)]
    return dict(x=x, we=f32(rng.normal(0, 1 / np.sqrt(cin), (cin, ce))),
                b0=f32(rng.normal(0, 0.1, ce)), wd=f32(rng.normal(0, 1.0 / k, (ce, k, k))),
                scale=f32(rng.uniform(0.5, 1.5, ce)), b1=f32(rng.normal(0, 0.1, ce)),
                m1=masks[0], m2=masks[1])


def check_soft_nms(dev, rng, smi):
    """Phase 3, soft-NMS at B=8, N=5000, K=100. Returns the largest score
    error, {mode: (kernel ms, plain ms)} and {mode: picks made}."""
    max_err, times, picks = 0.0, {}, {}
    for sigma, tied in ((0.5, False), (0.0, False), (0.5, True)):
        boxes, scores = random_boxes(rng, BATCH, N_CAND, tied)
        b = torch.from_numpy(boxes).to(dev)
        s = torch.from_numpy(scores).to(dev)
        thr = 0.001 if sigma > 0 else float("-inf")
        want = nms.batched_soft_nms(b, s, K, 0.5, thr, sigma)
        vlen = want.valid_len.cpu()
        mode = ("gaussian" if sigma > 0 else "hard") + (" tied" if tied else "")
        got = cuda_nms.soft_nms_cuda(b, s, K, 0.5, thr, sigma)
        torch.cuda.synchronize()
        if not torch.equal(got.valid_len.cpu(), vlen):
            raise AssertionError(f"{mode}: valid_len {got.valid_len.tolist()} vs "
                                 f"{vlen.tolist()}")
        for i, n in enumerate(vlen.tolist()):
            if not torch.equal(got.indices[i, :n], want.indices[i, :n]):
                raise AssertionError(f"{mode} image {i}: picks differ")
            max_err = max(max_err, float((got.scores[i, :n] - want.scores[i, :n]).abs().max()))
        if max_err > 1e-6:
            raise AssertionError(f"kernel scores differ from the plain version by {max_err}")
        if tied:
            phase(3, f"soft-NMS {mode} B={BATCH} N={N_CAND} K={K}: valid_len {vlen.tolist()} "
                     f"equal, indices equal: ties broken alike; {smi}")
            continue
        picks[mode] = sum(vlen.tolist())
        t_kernel = graph_median_ms(lambda: cuda_nms.launch_picks(b, s, K, 0.5, thr, sigma))
        one = graph_median_ms(lambda: cuda_nms.launch_picks(b, s, 1, 0.5, thr, sigma))
        per_pick = (t_kernel - one) / (K - 1) * 1e3
        call = cuda_median_ms(lambda: cuda_nms.soft_nms_cuda(b, s, K, 0.5, thr, sigma))
        times[mode] = (t_kernel,
                       cuda_median_ms(lambda: nms.batched_soft_nms(b, s, K, 0.5, thr, sigma)))
        phase(3, f"soft-NMS {mode} B={BATCH} N={N_CAND} K={K}: valid_len {vlen.tolist()} "
                 f"equal, indices equal; clusters of {cuda_nms.CLUSTER} blocks an image "
                 f"({BATCH * cuda_nms.CLUSTER} blocks of {cuda_nms.plan(N_CAND).threads} "
                 f"threads); kernel (device time: 10 calls a CUDA graph, medians of 25 "
                 f"replays) {t_kernel:.4f} ms, at K=1 {one:.4f} ms, {per_pick:.3f} us a pick "
                 f"(dependency floor {per_pick * K / 1e3:.4f} ms); the wrapper's call with "
                 f"pack_picks (eager) {call:.4f} ms; plain {times[mode][1]:.4f} ms (medians "
                 f"of 25); {smi}")
    return max_err, times, picks


def check_per_class_nms(dev, rng, smi):
    """Phase 3, per-class soft-NMS operands: boxes as ``random_boxes``
    shifted by class ids in [0, 10) times 2·1024, as ``per_class_nms``
    shifts them at 1024x512. Returns the largest score error."""
    max_err = 0.0
    for sigma in (0.5, 0.0):
        boxes, scores = random_boxes(rng, BATCH, N_CAND)
        classes = rng.randint(0, 10, (BATCH, N_CAND, 1)).astype(np.float32)
        b = torch.from_numpy(boxes + classes * 2.0 * 1024).to(dev)
        s = torch.from_numpy(scores).to(dev)
        thr = 0.001 if sigma > 0 else float("-inf")
        mode = "gaussian" if sigma > 0 else "hard"
        want = nms.batched_soft_nms(b, s, K, 0.5, thr, sigma)
        got = cuda_nms.soft_nms_cuda(b, s, K, 0.5, thr, sigma)
        vlen = want.valid_len.cpu()
        if not torch.equal(got.valid_len.cpu(), vlen):
            raise AssertionError(f"per-class {mode}: valid_len {got.valid_len.tolist()} vs "
                                 f"{vlen.tolist()}")
        for i, n in enumerate(vlen.tolist()):
            if not torch.equal(got.indices[i, :n], want.indices[i, :n]):
                raise AssertionError(f"per-class {mode} image {i}: picks differ")
            max_err = max(max_err, float((got.scores[i, :n] - want.scores[i, :n]).abs().max()))
        if max_err > 1e-6:
            raise AssertionError(f"per-class kernel scores differ from the plain version by "
                                 f"{max_err}")
        t_kernel = graph_median_ms(lambda: cuda_nms.launch_picks(b, s, K, 0.5, thr, sigma))
        phase(3, f"soft-NMS per-class {mode} B={BATCH} N={N_CAND} K={K}, boxes shifted by "
                 f"class x 2048 (up to {float(b.max()):.0f} px): valid_len {vlen.tolist()} "
                 f"equal, indices equal, scores within {max_err:.1e}; kernel {t_kernel:.4f} ms "
                 f"(device time, 10 calls a CUDA graph); {smi}")
    return max_err


def check_fused_f32(dev, rng):
    """Phase 3, f32 at N=8 over every (k, s). Returns the largest errors."""
    worst = {"fused_dw": 0.0, "fused_expand_dw": 0.0}
    for (k, s), (cin, ce, h, w) in sorted(F32_BLOCKS.items()):
        o = fused_operands(rng, 8, cin, ce, h, w, k, dev, torch.float32)
        for masked in (True, False):
            m1, m2 = (o["m1"], o["m2"]) if masked else (None, None)
            got = fused_mbconv.fused_expand_dw_cuda(o["x"], o["we"], o["b0"], m1, o["wd"],
                                                    o["b1"], m2, s, k)
            want = fused_mbconv.fused_expand_dw_plain(o["x"], o["we"], o["b0"], m1, o["wd"],
                                                      o["b1"], m2, s, k)
            for g, wt in zip(got, want):
                torch.testing.assert_close(g, wt, atol=1e-4, rtol=1e-4)
            worst["fused_expand_dw"] = max(worst["fused_expand_dw"],
                                           float((got[0] - want[0]).abs().max()))
        phase(3, f"fused_expand_dw f32 N=8 {cin}->{ce} {h}x{w} k{k} s{s}, masks on/off: "
                 f"within 1e-4")
        d = fused_operands(rng, 8, ce, ce, h, w, k, dev, torch.float32)
        taps = d["wd"]
        for path, act, masked in itertools.product(("fast", "general"), ("swish", "identity"),
                                                   (True, False)):
            mask = d["m2"] if masked else None
            got = fused_dw.fused_depthwise_cuda(d["x"], taps, d["scale"], d["b1"], mask, s,
                                                act, masked, path)
            want = fused_dw.fused_depthwise_plain(d["x"], taps, d["scale"], d["b1"], mask,
                                                  s, act, masked)
            for g, wt in zip(*((got, want) if masked else ((got,), (want,)))):
                torch.testing.assert_close(g, wt, atol=1e-5, rtol=1e-5)
            y = got[0] if masked else got
            worst["fused_dw"] = max(worst["fused_dw"], float(
                (y - (want[0] if masked else want)).abs().max()))
        phase(3, f"fused_dw f32 N=8 C={ce} {tuple(d['x'].shape[2:])} k{k} s{s}, fast and "
                 f"general path, swish and identity, mask+mean on/off: within 1e-5")
    return worst


def check_fused_bf16(dev, rng, smi):
    """Phase 3, bf16 at the main path's shapes. Returns {kernel: largest
    error} and {kernel: (kernel ms, plain ms)} at its first shape."""
    errs, times = {}, {}
    for what, n, cin, ce, h, w, k, s in (PREFIX,) + BLOCKS:
        expand = what != PREFIX[0]
        o = fused_operands(rng, n, cin, ce, h, w, k, dev, torch.bfloat16, masked=expand)
        if expand:
            args = (o["x"], o["we"], o["b0"], o["m1"], o["wd"], o["b1"], o["m2"], s, k, "swish")
            split = fused_mbconv.split_weights(o["we"])
            kernel = lambda: fused_mbconv.fused_expand_dw_cuda(*args, split)  # noqa: E731
            plain = lambda: fused_mbconv.fused_expand_dw_plain(*args)  # noqa: E731
            ulps, top_ulps, name = 2, 1, "fused_expand_dw"
        else:
            args = (o["x"], o["wd"], o["scale"], o["b1"], None, s, "swish", True)
            kernel = lambda: fused_dw.fused_depthwise_cuda(*args)  # noqa: E731
            general = lambda: fused_dw.fused_depthwise_cuda(*args, "general")  # noqa: E731
            plain = lambda: fused_dw.fused_depthwise_plain(*args)  # noqa: E731
            ulps, top_ulps, name = 1, 0.01, "fused_dw"
        fast_before = fused_dw.path_launches["fast"]
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        outs = [("", got)]
        if not expand:
            if fused_dw.path_launches["fast"] != fast_before + 1:
                raise AssertionError(f"fused_dw {what} did not take the fast path")
            outs.append((" (general path)", general()))
        for tag, out in outs:
            excess, in_top = bf16_excess(out[0], want[0], ulps, top_ulps)
            if excess > 0:
                raise AssertionError(f"{name}{tag} {what}: y beyond {ulps} + {top_ulps} top "
                                     f"bf16 ulps by {excess}")
            torch.testing.assert_close(out[1], want[1], rtol=1e-3,
                                       atol=1e-3 * float(want[1].abs().max()))
        excess, in_top = bf16_excess(got[0], want[0], ulps, top_ulps)
        se_err = float((got[1] - want[1]).abs().max() / want[1].abs().max())
        block = eager_modules(o, expand, cin, ce, k, s, dev)
        t_kernel = cuda_median_ms(kernel, runs=15, warmup=3)
        t_plain = cuda_median_ms(plain, runs=15, warmup=3)
        t_eager = cuda_median_ms(lambda: eager_chain(o["x"], block, o["m1"], o["m2"]),
                                 runs=15, warmup=3)
        err = float((got[0].float() - want[0].float()).abs().max())
        if not expand:
            plan = fused_dw.row_plan(h, w, k, s, 2)
            t_call, t_kernel = t_kernel, graph_median_ms(kernel)
            t_general = graph_median_ms(general)
            nbytes = 2 * 2 * n * cin * h * w
            y_copy = torch.empty_like(o["x"])
            t_copy = graph_median_ms(lambda: y_copy.copy_(o["x"]))
            phase(3, f"fused_dw bf16 {what}, device time (10 calls a CUDA graph, medians of 25 "
                     f"replays): fast "
                     f"path (bands of {plan.th} rows x {plan.iwx} staged columns, ring of "
                     f"{fused_dw.ROW_STAGES}) {t_kernel:.4f} ms ({nbytes / t_kernel / 1e9:.2f} "
                     f"TB/s), general path (8x64 tiles) {t_general:.4f} ms; the wrapper's "
                     f"eager call {t_call:.4f} ms; torch copy_ of x (the same bytes, no "
                     f"stencil) {t_copy:.4f} ms; {smi}")
        phase(3, f"{name} bf16 {what}: N={n} {cin}->{ce} {h}x{w} k{k} s{s}: max err "
                 f"{err:.3g} ({in_top:.2f} ulp of max|y|), SE {se_err:.3g} of the largest "
                 f"(limit 1e-3); kernel {t_kernel:.4f} ms, plain "
                 f"(f32 inside) {t_plain:.4f} ms, unfused bf16 eager chain {t_eager:.4f} ms "
                 f"(medians of 15); {smi}")
        errs[name] = max(errs.get(name, 0.0), err)
        times.setdefault(name, (t_kernel, t_plain))
    return errs, times


def eager_modules(o, expand, cin, ce, k, s, dev):
    """bf16 modules holding the operands unfolded (BN with unit variance
    and zero mean carries the bias), for ``eager_chain``."""
    mods = {}
    with torch.no_grad():
        if expand:
            mods["expand_conv"] = Conv2d(cin, ce, 1, bias=False)
            mods["expand_conv"].weight.copy_(o["we"].t()[:, :, None, None])
            mods["bn0"] = BatchNorm(ce)
            mods["bn0"].bias.copy_(o["b0"])
        mods["depthwise_conv"] = Conv2d(ce, ce, k, s, groups=ce, bias=False)
        mods["depthwise_conv"].weight.copy_(o["wd"][:, None])
        mods["bn1"] = BatchNorm(ce)
        mods["bn1"].bias.copy_(o["b1"])
    return {n: m.to(dev, torch.bfloat16).eval() for n, m in mods.items()}


def check_fused_sepconv(dev, smi):
    """Phase 3, the fused separable conv at ``SEPCONV_CASES`` (at Cin > 128
    the resident kernel, timed beside the first kernel at its own plans),
    then d7x's serve launches. Returns the largest error and, for the
    first case (d0's tower layer), the kernel's, the plain version's and
    the unfused chain's ms and the bound."""
    g = torch.Generator(device=dev).manual_seed(17)
    worst, first = 0.0, None
    dtype = torch.bfloat16
    for what, pre, post, use_bn, masked, n, cin, cout, levels in SEPCONV_CASES:
        taps = (torch.randn((cin, 1, 3, 3), device=dev, generator=g) / 3).to(dtype)
        wt = (torch.randn((cout, cin, 1, 1), device=dev, generator=g) / cin ** 0.5).to(dtype)
        scale = (torch.rand(cout, device=dev, generator=g) + 0.5 if use_bn
                 else torch.ones(cout, device=dev))
        bias = 0.1 * torch.randn(cout, device=dev, generator=g)
        ops = []
        for h, w in levels:
            x = torch.randn((n, cin, h, w), device=dev, generator=g).to(dtype)
            mask = ((torch.rand((n, cout), device=dev, generator=g) < 0.95) / 0.95
                    if masked else None)
            ops.append((x, taps, wt, scale, bias, mask, pre, post))
        err = 0.0
        resident = cin > fused_sepconv.RESIDENT_FROM
        for args in ops:
            before, before_resident = fused_sepconv.launches, fused_sepconv.resident_launches
            got = fused_sepconv.fused_sepconv(*args)
            want = fused_sepconv.fused_sepconv_plain(*args)
            torch.cuda.synchronize()
            if (fused_sepconv.launches - before,
                    fused_sepconv.resident_launches - before_resident) != (1, int(resident)):
                raise AssertionError(f"fused_sepconv {what}: {fused_sepconv.launches - before} "
                                     f"launches a level, "
                                     f"{fused_sepconv.resident_launches - before_resident} "
                                     f"resident; want 1, {int(resident)}")
            excess, _ = bf16_excess(got, want, 2, 1)
            if excess > 0:
                raise AssertionError(f"fused_sepconv {what} at {tuple(got.shape)}: beyond 2 + 1 "
                                     f"top bf16 ulps by {excess}")
            err = max(err, float((got.float() - want.float()).abs().max()))
            del got, want
        worst = max(worst, err)
        # the unfused chain of the port's modules on the same operands
        with torch.no_grad():
            conv = SeparableConv(cin, cout, use_bias=False).to(dev, dtype).eval()
            conv.depthwise.weight.copy_(taps)
            conv.pointwise.weight.copy_(wt)
            bn = BatchNorm(cout).to(dev).eval()
            bn.weight.copy_(scale)
            bn.bias.copy_(bias)
            bn.running_var.fill_(1.0 - bn.eps)
            bn = bn.to(dtype)
        act_pre, act_post = activation_fn(pre), activation_fn(post)

        def chain():
            with torch.no_grad():
                for x, *_, mask, _, _ in ops:
                    y = act_post(bn(conv(act_pre(x))))
                    if mask is not None:
                        y = y * mask.to(dtype)[:, :, None, None]

        def kernel():
            for args in ops:
                fused_sepconv.fused_sepconv(*args)

        def plain():
            for args in ops:
                fused_sepconv.fused_sepconv_plain(*args)

        def first_kernel():
            for args in ops:
                x = args[0]
                fused_sepconv._launch(*args, fused_sepconv.tc_plan(
                    x.shape[0], cin, cout, x.shape[2], x.shape[3]))

        t_kernel, t_chain = graph_median_ms(kernel), graph_median_ms(chain)
        t_plain = cuda_median_ms(plain, runs=5, warmup=1)
        first_ms = (f"; the first kernel at its plans {graph_median_ms(first_kernel):.4f} ms"
                    if resident else "")
        pixels = sum(n * h * w for h, w in levels)
        nbytes = pixels * (cin + cout) * 2 + len(levels) * (
            (cin * 9 + cout * cin) * 2 + 8 * cout + (4 * n * cout if masked else 0))
        layer_bound = bound(nbytes, 2.0 * pixels * cin * cout, pixels * (18.0 * cin + 8.0 * cout))
        plans = [fused_sepconv.plan(n, cin, cout, h, w) for h, w in levels]
        phase(3, f"fused_sepconv bf16 {what}: N={n} {cin}->{cout}, "
                 f"levels {'/'.join(f'{h}x{w}' for h, w in levels)}, pre {pre}, post {post}, "
                 f"mask {'on' if masked else 'off'}: max err {err:.3g}; a layer over its "
                 f"levels: {'resident' if resident else 'first'} kernel {t_kernel:.4f} ms"
                 f"{first_ms}, unfused chain {t_chain:.4f} ms (device "
                 f"time, 10 calls a CUDA graph), plain (f32 inside) {t_plain:.4f} ms; bound "
                 f"{layer_bound[0]:.4f} ms ({layer_bound[1]}), the kernel at "
                 f"{layer_bound[0] / t_kernel:.0%} of it; plans {plans}; {smi}")
        if first is None:
            first = (t_kernel, t_plain, t_chain, layer_bound)
        del ops, conv, bn
        torch.cuda.empty_cache()
    d7x_serve_launches(dev, smi)
    return worst, first


def d7x_serve_launches(dev, smi):
    """EfficientDet-d7x with the benchmark's ``bdd_head_d7x`` overrides at
    1536x768, batch 2: a replayed serve's fused separable convs, read from
    a trace of the card, are 152 (``sepconv_per_forward``), every one on
    the resident kernel."""
    LAUNCHES.stop()         # one trace at a time
    spec = json.loads((Path(__file__).resolve().parent / "bench_torch" / "configs"
                       / "bdd_head_d7x.json").read_text())
    driver = ServingDriver.create(spec["model_name"], seed=1, device=dev,
                                  overrides=spec["overrides"])
    images = torch.randn((2, 768, 1536, 3), generator=torch.Generator().manual_seed(0)).to(dev)
    scales = torch.ones(2, device=dev)
    for _ in range(3):
        driver.serve_preprocessed(images, scales)
    with profiling.KernelLaunches() as launches:
        driver.serve_preprocessed(images, scales)
    want = sepconv_per_forward(driver.config)
    if (launches.sepconv, launches.sepconv_resident) != (want, want):
        raise AssertionError(f"d7x serve: fused_sepconv {launches.sepconv} launches, "
                             f"{launches.sepconv_resident} resident; want {want}, all resident")
    phase(3, f"d7x 1536x768 B=2 replayed serve ({driver.graph_stats}): fused_sepconv "
             f"{launches.sepconv} launches, {launches.sepconv_resident} of them resident, read "
             f"from a trace of the card; {smi}")
    del driver
    torch.cuda.empty_cache()


# the port's kernels launched on the card between ``reset_counts`` and
# ``counts``: a trace of the card, since a replayed CUDA graph launches the
# serve's kernels without their wrappers and their counters
LAUNCHES = profiling.KernelLaunches()


def reset_counts(trace=True):
    """Set the wrappers' launch counters to 0 and, with ``trace``, start
    counting the port's kernels in a trace of the card (which times traced
    work from here to ``counts``)."""
    cuda_nms.launches = fused_dw.launches = fused_mbconv.launches = fused_sepconv.launches = 0
    fused_sepconv.resident_launches = 0
    fused_dw.path_launches.update(dict.fromkeys(fused_dw.path_launches, 0))
    packed.launches.update(dict.fromkeys(packed.launches, 0))
    LAUNCHES.stop()
    if trace:
        LAUNCHES.start()


def counts():
    """(fused_dw, fused_expand_dw, soft_nms) launches on the card since
    ``reset_counts``, measured in its trace (ended at the first read)."""
    return LAUNCHES.stop().counts


def fast_launches():
    """The fused depthwise's fast-path launches of the same trace."""
    return LAUNCHES.stop().fast


def sepconv_launches():
    """The fused separable conv's launches of the same trace."""
    return LAUNCHES.stop().sepconv


def resident_launches():
    """The launches of its resident kernel (Cin > 128) in the same trace."""
    return LAUNCHES.stop().sepconv_resident


def sepconv_per_forward(cfg):
    """The fused separable conv's launches a forward of a member: each
    BiFPN node's conv, and in each of the two heads a tower layer a repeat
    and the predict conv, level by level (64 at d0, 152 at d7x)."""
    levels = cfg.max_level - cfg.min_level + 1
    return cfg.fpn_cell_repeats * 2 * (levels - 1) + 2 * levels * (cfg.box_class_repeats + 1)


def profile_calls(label, fn, wall_ms, calls=2):
    """torch.profiler over ``calls`` calls of ``fn``: device time by
    operator, the port's kernels' totals, and the device's busy time a call
    (the union of the spans of its kernels and copies) against ``wall_ms``,
    the unprofiled host time of a call: the rest is the share the card
    idles."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    LAUNCHES.stop()         # one trace at a time
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    print(events.table(sort_by="cuda_time_total", row_limit=25))
    for name in ("soft_nms_kernel", "fused_dw_rows_kernel", "fused_dw_kernel", "sum_partials",
                 "expand_dw_tc_kernel"):
        rows = [e for e in events if name in e.key and e.device_time_total > 0]
        total = sum(e.device_time_total for e in rows) / 1e3
        print(f"[profile] {label} {name}: {total:.4f} ms of device time in {calls} calls, "
              f"{sum(e.count for e in rows)} launches")
    # the union of the kernels' and copies' spans on the device
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, reached = 0.0, float("-inf")
    for start, end in spans:
        if end > reached:
            busy += end - max(start, reached)
            reached = end
    busy /= 1e3 * calls
    print(f"[profile] {label}: {busy:.3f} ms of device time a call against {wall_ms:.3f} ms "
          f"a call on the host's clock (unprofiled): the card idles "
          f"{max(0.0, 1 - busy / wall_ms) * 100:.1f}% of a call")


class HostMasks(ChannelDropout):
    """Dropout masks drawn on the host, so a CPU and a CUDA run share them."""

    def draw(self, n, c, keep, device):
        return super().draw(n, c, keep, "cpu").to(device)


def random_flax_variables(model, seed):
    """Numpy weights from ``seed`` in the flax variable layout (lecun-scale
    kernels, BN scales and variances in [0.5, 1.5])."""
    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "kernel":
                out[k] = rng.normal(0, np.sqrt(1.0 / np.prod(v.shape[:-1])), v.shape)
            elif k in ("scale", "var", "edge_weights"):
                out[k] = rng.uniform(0.5, 1.5, v.shape)
            else:
                out[k] = rng.normal(0, 0.1, v.shape)
            if not isinstance(out[k], dict):
                out[k] = out[k].astype(np.float32)
        return out

    params, stats = torch_to_flax(model)
    return fill(params), fill(stats)


def matched_sets(got, want, tag):
    """Same count per image; each reference detection pairs with one of the
    same class, box IoU >= 0.99 and score within 1e-4; aleatoric sigma to
    rtol 1e-3. Returns the largest score difference of the pairs."""
    g_boxes, g_scores, g_classes, g_len = (t.float().cpu().numpy() for t in got)
    w_boxes, w_scores, w_classes, w_len = (t.float().cpu().numpy() for t in want)
    # without MC the class column has no sigma beside it
    g_classes, w_classes = (c.reshape(*c.shape[:2], -1) for c in (g_classes, w_classes))
    if not np.array_equal(g_len, w_len) or w_len.min() <= 0:
        raise AssertionError(f"{tag}: valid_len {g_len} vs {w_len}")
    worst = 0.0
    for b in range(len(w_len)):
        n = int(w_len[b])
        used = np.zeros(n, bool)
        for i in range(n):
            tl = np.maximum(g_boxes[b, :n, :2], w_boxes[b, i, :2])
            br = np.minimum(g_boxes[b, :n, 2:4], w_boxes[b, i, 2:4])
            inter = np.prod(np.clip(br - tl, 0, None), -1)
            area = lambda x: np.prod(np.clip(x[..., 2:4] - x[..., :2], 0, None), -1)  # noqa: E731
            iou = inter / np.maximum(area(g_boxes[b, :n]) + area(w_boxes[b, i]) - inter, 1e-12)
            diff = np.abs(g_scores[b, :n] - w_scores[b, i])
            ok = (iou >= 0.99) & (diff <= 1e-4) & (g_classes[b, :n, 0] == w_classes[b, i, 0]) & ~used
            if not ok.any():
                raise AssertionError(f"{tag}: image {b} detection {i} has no match")
            j = int(np.argmax(ok))
            used[j] = True
            worst = max(worst, float(diff[j]))
            np.testing.assert_allclose(g_boxes[b, j, 4:8], w_boxes[b, i, 4:8], rtol=1e-3,
                                       atol=1e-6, err_msg=tag)
    return worst


def phase5(dev):
    """The same weights at 128x128 in f32, served on the CPU (plain
    versions) and on the card (kernels), path by path: matched sets, and
    the kernels launched on the card only."""
    small = dict(image_size="128x128", num_classes=8, loss_attenuation=True,
                 fpn_cell_repeats=1, box_class_repeats=1, mc_dropout=True,
                 mc_dropoutrate=0.05, mc_dropoutsamp=3)
    head_only = dict(mc_dropoutrate=0.0, mc_classheadrate=0.05, mc_boxheadrate=0.05,
                     enable_softmax=True)
    deterministic = {"mc_dropout": False, "mc_dropoutrate": 0.0}

    def small_config(extra):
        return get_detection_config("efficientdet-d0").override({**small, **extra},
                                                                allow_new_keys=True)

    config = small_config({})
    params, stats = random_flax_variables(EfficientDetNet(config), seed=2)
    state = flax_to_torch(params, stats)
    state2 = flax_to_torch(*random_flax_variables(EfficientDetNet(config), seed=6))
    images = np.random.RandomState(3).uniform(-2, 2, (2, 128, 128, 3)).astype(np.float32)
    raw_small = np.random.RandomState(7).randint(0, 256, (2, 100, 160, 3)).astype(np.uint8)
    native_small = np.random.RandomState(8).randint(0, 256, (2, 90, 150, 3)).astype(np.uint8)
    scale = min(128 / 90, 128 / 150)
    warp_small = dict(warp_scale=np.asarray([[int(90 * scale) / 90, int(150 * scale) / 150]] * 2,
                                            np.float32),
                      warp_offset=np.zeros((2, 2), np.float32),
                      valid_hw=np.asarray([[int(90 * scale), int(150 * scale)]] * 2, np.int32),
                      image_scales=np.full((2,), 1.0 / scale, np.float32))

    def driver(extra, device, **kwargs):
        d = ServingDriver(small_config(extra), kwargs.pop("state", state), dtype=torch.float32,
                          device=device, **kwargs)
        d.masks = HostMasks(torch.Generator().manual_seed(4))
        return d

    def per_class_model(device):
        model = EfficientDetModel(small_config(deterministic))
        model.load_state_dict(state)
        model = model.to(device).eval()
        model.prepare_inference()
        with torch.inference_mode():
            return model(torch.as_tensor(raw_small, device=device), post_mode="per_class")

    paths = (
        ("MC fold", (1, 15, 1), lambda d: driver({}, d).serve_preprocessed(images)),
        ("MC without the fold", (1, 15, 1),
         lambda d: driver({"mc_fast_fold": False}, d).serve_preprocessed(images)),
        ("deterministic", (1, 15, 1), lambda d: driver(deterministic, d).serve_preprocessed(images)),
        ("head-only MC", (1, 15, 1), lambda d: driver(head_only, d).serve_preprocessed(images)),
        ("head-only MC, native uint8 + warp (serve_detections_preprocessed_uint8)", (1, 15, 1),
         lambda d: driver(head_only, d).serve_detections_preprocessed_uint8(
             native_small, **warp_small).packed()),
        ("EfficientDetModel post_mode=per_class", (1, 15, 1), per_class_model),
        ("2-member ensemble", (2, 30, 1),
         lambda d: driver(deterministic, d, state=stack_variables([state, state2]),
                          ensemble=True).serve_preprocessed(images)),
    )
    for path, want, run in paths:
        outs = []
        for device in ("cpu", dev):
            reset_counts()
            outs.append(run(device)[:4])
            expect = (0, 0, 0) if device == "cpu" else want
            # f32: the separable convs run the chain on the card too
            if counts() != expect or fast_launches() != expect[0] or sepconv_launches() != 0:
                raise AssertionError(f"{path} on {device}: (fused_dw, fused_expand_dw, "
                                     f"soft_nms) launches {counts()}, want {expect}; fused_dw "
                                     f"fast path {fast_launches()}; fused_sepconv "
                                     f"{sepconv_launches()}, want 0 in f32")
        worst = matched_sets(outs[1], outs[0], f"{path}: cuda vs cpu")
        phase(5, f"128x128 f32 {path}: card (kernels, launches {'/'.join(map(str, want))}, "
                 f"fused_dw on its fast path, no fused_sepconv in f32) and CPU (plain) "
                 f"detections agree as matched sets, valid_len {outs[0][3].tolist()}, max "
                 f"score diff {worst:.2e}")
    train_parity(dev, small_config({**deterministic, "batch_size": 2}), state, images)
    torch.cuda.empty_cache()


def train_parity(dev, config, state, images):
    """Phase 5: one f32 train step (dropout off) from the same weights and
    batch on the CPU and on the card, TF32 off: the losses to 1e-4
    relative, the gradients as a tree to 1e-2 (relative L2) and each leaf
    whose norm is 1% of the largest's or more to 3e-2 of its largest value
    (the f32 sums run in other orders through an ill-conditioned random
    network: tests/test_torch_train_step.py measures the port's own f32
    gradients against its f64 ones); no kernel launches in the step. Then
    the stepped models' eval serves agree as matched sets (the card's
    through the kernels, 1/15/1)."""
    batch = synthetic_batch(np.random.RandomState(9), 2, 128, 128, config.num_classes)
    runs = {}
    for device in ("cpu", dev):
        st, schedule = train_lib.create_train_state(config, 10, device=device, state_dict=state)
        reset_counts()
        _, vals = train_lib.train_step(config, schedule, 10, st, *batch)
        if counts() != (0, 0, 0) or sepconv_launches() != 0:
            raise AssertionError(f"a train step on {device} launched kernels: {counts()}, "
                                 f"fused_sepconv {sepconv_launches()}")
        grads = {n: p.grad.detach().cpu() for n, p in st.model.named_parameters()}
        driver = ServingDriver(config, st.model.state_dict(), dtype=torch.float32,
                               device=device)
        reset_counts()
        serve = driver.serve_preprocessed(images)[:4]
        runs[str(device)] = ({k: float(v) for k, v in vals.items()}, grads, serve,
                             counts() + (sepconv_launches(),))
    (cpu_vals, cpu_grads, cpu_serve, _), (vals, grads, serve, launches) = runs.values()
    for k, v in cpu_vals.items():
        if abs(vals[k] - v) > 1e-4 * abs(v) + 1e-7:
            raise AssertionError(f"train step {k}: card {vals[k]} vs CPU {v}")
    err = sum(float((grads[n] - g).square().sum()) for n, g in cpu_grads.items()) ** 0.5
    norm = sum(float(g.square().sum()) for g in cpu_grads.values()) ** 0.5
    largest = max(float(g.norm()) for g in cpu_grads.values())
    worst = max(float((grads[n] - g).abs().max() / g.abs().max())
                for n, g in cpu_grads.items() if float(g.norm()) >= 1e-2 * largest)
    if err > 1e-2 * norm or worst > 3e-2:
        raise AssertionError(f"train step gradients: relative L2 {err / norm:.2e}, worst leaf "
                             f"{worst:.2e}")
    if launches != (1, 15, 1, 0):
        raise AssertionError(f"serve of the stepped model launched {launches}, want 1/15/1 "
                             f"and no fused separable conv (f32)")
    diff = matched_sets(serve, cpu_serve, "stepped model: cuda vs cpu")
    phase(5, f"128x128 f32 train step (dropout off, TF32 off), card vs CPU: loss "
             f"{vals['loss']:.6f} vs {cpu_vals['loss']:.6f}, gradient norm "
             f"{vals['gradient_norm']:.6f} vs {cpu_vals['gradient_norm']:.6f}; gradients "
             f"relative L2 {err / norm:.2e}, worst large leaf {worst:.2e}; no kernel in the "
             f"step; the stepped models' serves agree as matched sets (card 1/15/1), max score "
             f"diff {diff:.2e}")


def timed_calls(fn):
    """``SERVE_CALLS`` calls of ``fn``, each ending in a synchronisation,
    with the peak memory reset, then ``SERVE_CALLS`` more in a trace of the
    card that counts their launches (for a driver, replays). Returns (the
    last output, ms per call from the median of calls 2 to SERVE_CALLS, the
    first call's ms, the traced calls' launches, peak GiB)."""
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(SERVE_CALLS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    out, launches = traced_calls(fn)
    return out, statistics.median(walls[1:]) * 1e3, walls[0] * 1e3, launches, peak


def traced_calls(fn):
    """``SERVE_CALLS`` calls of ``fn`` in a trace of the card: (the last
    output, their launches)."""
    reset_counts()
    for _ in range(SERVE_CALLS):
        out = fn()
    return out, counts()


def assert_launches(what, launches, per_call, sepconv):
    """(fused_dw, fused_expand_dw, soft_nms) launches of SERVE_CALLS calls,
    every fused_dw launch on its fast path, and ``sepconv`` fused
    separable convs a call, none resident (d0: Cin = 64)."""
    want = tuple(SERVE_CALLS * n for n in per_call)
    if launches != want or fast_launches() != want[0] or \
            sepconv_launches() != SERVE_CALLS * sepconv or resident_launches() != 0:
        raise AssertionError(f"{what}: (fused_dw, fused_expand_dw, soft_nms) launches "
                             f"{launches} in {SERVE_CALLS} calls, want {per_call} a call; "
                             f"fused_dw fast path {fast_launches()}; fused_sepconv "
                             f"{sepconv_launches()}, want {sepconv} a call")


def assert_detections(what, tensors, shapes):
    got = [tuple(t.shape) for t in tensors]
    if got != shapes:
        raise AssertionError(f"{what}: shapes {got}, want {shapes}")
    if not all(bool(torch.isfinite(t.float()).all()) for t in tensors):
        raise AssertionError(f"{what}: non-finite outputs")


def phase7(dev, smi, profiled=False):
    """The repo's inference configurations at full width, bf16, batch 8,
    random weights from a seed; with ``profiled``, a torch.profiler split
    of each path after its timed calls."""
    # 1. KITTI: head-only MC, native frames through the device-resize entry
    path, overrides = KITTI_HEAD
    server = ServingDriver.create("efficientdet-d0", overrides=overrides, batch_size=BATCH,
                                  seed=0, device=dev)
    cfg = server.config
    h, w = KITTI_NATIVE
    net_h, net_w = parse_image_size(cfg.image_size)
    scale = min(net_h / h, net_w / w)
    sh, sw = int(h * scale), int(w * scale)
    frames = torch.from_numpy(np.random.RandomState(5).randint(0, 256, (BATCH, h, w, 3))
                              .astype(np.uint8))
    warp = dict(valid_hw=torch.tensor([[sh, sw]] * BATCH, dtype=torch.int32),
                image_scales=torch.full((BATCH,), 1.0 / scale),
                warp_scale=torch.tensor([[sh / h, sw / w]] * BATCH),
                warp_offset=torch.zeros((BATCH, 2)))
    det, ms, first, launches, peak = timed_calls(
        lambda: server.serve_detections_preprocessed_uint8(frames, **warp))
    what = f"KITTI ({path}), head-only MC T={cfg.mc_dropoutsamp}"
    assert_launches(what, launches, (1, 15, 1), sepconv_per_forward(cfg))
    fast = fast_launches()
    c = cfg.num_classes
    assert_detections(what, [det.boxes, det.sigma_al, det.sigma_mc, det.sigma_cls, det.logits],
                      [(BATCH, K, 4)] * 3 + [(BATCH, K, c)] * 2)
    if int(det.valid_len.max()) <= 0:
        raise AssertionError(f"{what}: no detections")
    dev_frames = frames.to(dev)
    dev_warp = {k: v.to(dev) for k, v in warp.items()}
    prep = graph_median_ms(lambda: server._dispatch_uint8(dev_frames, **dev_warp))
    bench = server.benchmark(frames, warmup=1, iters=3)
    phase(7, f"{what}: serve_detections_preprocessed_uint8 from native {h}x{w} uint8 frames "
             f"(warp to {sh}x{sw} on the {net_h}x{net_w} canvas), B={BATCH} bf16: launches in "
             f"{SERVE_CALLS} calls {launches} (fused_dw fast path {fast}), fused_sepconv "
             f"{sepconv_launches()}; boxes, sigma_al, "
             f"sigma_mc [{BATCH}, {K}, 4], "
             f"sigma_cls, logits [{BATCH}, {K}, {c}], valid_len {det.valid_len.tolist()}; "
             f"{ms:.1f} ms/batch ({BATCH / ms * 1e3:.1f} img/s, median of calls 2-{SERVE_CALLS}, "
             f"first {first:.0f} ms), peak {peak:.2f} GiB; warp + uint8 prep alone "
             f"{prep:.4f} ms device time (10 calls a CUDA graph); ServingDriver.benchmark "
             f"{json.dumps(bench)}; {smi}")
    if profiled:
        profile_calls("KITTI head-only serve",
                      lambda: server.serve_detections_preprocessed_uint8(frames, **warp), ms)
    del server, det
    torch.cuda.empty_cache()

    # 2. BASELINE config #3: a 5-member deep ensemble on BDD100K
    path, overrides = BDD
    cfg = get_detection_config("efficientdet-d0").override(overrides)
    _, stacked = init_ensemble(cfg, ENSEMBLE_MEMBERS, seed=1)
    server = ServingDriver(cfg, stacked, BATCH, device=dev, ensemble=True)
    raw = np.random.RandomState(6).randint(0, 256, (BATCH, 512, 1024, 3)).astype(np.uint8)
    out, ms, first, launches, peak = timed_calls(lambda: server.serve(raw))
    what = f"BDD ({path}), {ENSEMBLE_MEMBERS}-member ensemble"
    assert_launches(what, launches, (ENSEMBLE_MEMBERS, 15 * ENSEMBLE_MEMBERS, 1),
                    ENSEMBLE_MEMBERS * sepconv_per_forward(cfg))
    c = cfg.num_classes
    assert_detections(what, out, [(BATCH, K, 12), (BATCH, K), (BATCH, K, 1 + c), (BATCH,),
                                  (BATCH, K, c)])
    if int(out[3].max()) <= 0:
        raise AssertionError(f"{what}: no detections")
    phase(7, f"{what}: serve of [{BATCH}, 512, 1024, 3] uint8, bf16: launches in "
             f"{SERVE_CALLS} calls {launches} (fused_dw fast path "
             f"{fast_launches()}), fused_sepconv {sepconv_launches()}; packed "
             f"{[tuple(t.shape) for t in out]}, valid_len {out[3].tolist()}; {ms:.1f} ms/batch "
             f"({BATCH / ms * 1e3:.1f} img/s, median of calls 2-{SERVE_CALLS}, first "
             f"{first:.0f} ms), peak {peak:.2f} GiB; {smi}")
    if profiled:
        profile_calls("5-member ensemble serve", lambda: server.serve(raw), ms)
    del server, stacked, out
    torch.cuda.empty_cache()

    # 3. EfficientDetModel with per-class NMS at the KITTI configuration
    cfg = get_detection_config("efficientdet-d0").override(KITTI_HEAD[1])
    model = EfficientDetModel(cfg)
    init_flax_style(model, torch.Generator().manual_seed(0))
    model = model.to(dev, torch.bfloat16).eval()
    model.prepare_inference()

    def per_class():
        with torch.inference_mode():
            return model(frames.to(dev), post_mode="per_class")

    out, ms, first, launches, peak = timed_calls(per_class)
    what = "EfficientDetModel(post_mode='per_class') at the KITTI configuration"
    assert_launches(what, launches, (1, 15, 1), sepconv_per_forward(cfg))
    c = cfg.num_classes
    assert_detections(what, out, [(BATCH, K, 8), (BATCH, K), (BATCH, K), (BATCH,), (BATCH, K, c)])
    if int(out[3].max()) <= 0:
        raise AssertionError(f"{what}: no detections")
    phase(7, f"{what}: native {h}x{w} uint8 frames, preprocess on the card, one deterministic "
             f"pass, per-class soft-NMS, B={BATCH} bf16: launches in {SERVE_CALLS} calls "
             f"{launches}, fused_sepconv {sepconv_launches()}; valid_len {out[3].tolist()}; "
             f"{ms:.1f} ms/batch "
             f"({BATCH / ms * 1e3:.1f} img/s, median of calls 2-{SERVE_CALLS}), peak "
             f"{peak:.2f} GiB; {smi}")
    if profiled:
        profile_calls("EfficientDetModel per-class", per_class, ms)
    del model, out
    torch.cuda.empty_cache()


def phase8(dev, smi, profiled=False):
    """KITTI's training operating point at full width: ``train_and_evaluate``
    for TRAIN_EPOCHS epochs of TRAIN_STEPS steps with a validation step an
    epoch and a checkpoint an epoch, then a second call that resumes from
    the checkpoint and trains one epoch more; then the trained weights
    served. Batches: host-made uint8 frames with 1-8 boxes each, from a
    seed; the targets are assigned on the card. Each step is timed to a
    synchronisation after it (a wrapper around the loop's ``train_step``),
    so the loop's host run-ahead is not measured."""
    path = KITTI_TRAIN[0]
    cfg = kitti_train_config()
    h, w = parse_image_size(cfg.image_size)
    rng = np.random.RandomState(10)
    data = [synthetic_batch(rng, cfg.batch_size, h, w, cfg.num_classes) for _ in range(4)]

    def batches():
        for i in itertools.count():
            yield data[i % len(data)]

    steps, real_step = [], loop.train_step

    def timed_step(*args, **kwargs):
        t0 = time.perf_counter()
        out = real_step(*args, **kwargs)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0, float(out[1]["loss"]),
                      float(out[1]["learning_rate"])))
        return out

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    logs = []
    loop.train_step = timed_step
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        hist = loop.train_and_evaluate(cfg, batches(), TRAIN_STEPS, str(TRAIN_DIR),
                                       val_iter_fn=batches, val_steps=1, device=dev,
                                       log_fn=logs.append)
        launches, peak = counts(), torch.cuda.max_memory_allocated() / 2**30
        # the validation steps run in eval mode through the kernels; train steps run none
        if launches != (TRAIN_EPOCHS, 15 * TRAIN_EPOCHS, 0):
            raise AssertionError(f"training: (fused_dw, fused_expand_dw, soft_nms) launches "
                                 f"{launches}, want {TRAIN_EPOCHS}/{15 * TRAIN_EPOCHS}/0 (the "
                                 f"validation steps only)")
        losses = [loss for _, loss, _ in steps] + hist["loss"] + hist["val_loss"]
        if len(steps) != TRAIN_EPOCHS * TRAIN_STEPS or not np.all(np.isfinite(losses)):
            raise AssertionError(f"training: {len(steps)} steps, losses {losses}")
        if latest_checkpoint(str(TRAIN_DIR)) != TRAIN_EPOCHS:
            raise AssertionError(f"no checkpoint of epoch {TRAIN_EPOCHS} in {TRAIN_DIR}")
        ms = statistics.median(t for t, _, _ in steps[1:]) * 1e3
        phase(8, f"KITTI training ({path}, {KITTI_RUNNER[0]} batch {cfg.batch_size}): d0 "
                 f"{h}x{w}, {cfg.num_classes} classes, MC dropout {cfg.mc_dropoutrate}, loss "
                 f"attenuation, MSE box loss x{cfg.box_loss_weight}, bf16 autocast, SGD "
                 f"{cfg.momentum}, cosine with warmup, clip {cfg.clip_gradients_norm}: "
                 f"train_and_evaluate {TRAIN_EPOCHS} epochs x {TRAIN_STEPS} steps + 1 "
                 f"validation step an epoch: {ms:.1f} ms/step ({cfg.batch_size / ms * 1e3:.1f} "
                 f"img/s; median of steps 2-{len(steps)}, each timed to a synchronisation; "
                 f"first {steps[0][0] * 1e3:.0f} ms), peak {peak:.2f} GiB; loss first "
                 f"{steps[0][1]:.4f}, last {steps[-1][1]:.4f}, epochs {hist['loss']}, "
                 f"val {hist['val_loss']}; learning rates "
                 f"{[round(lr, 6) for _, _, lr in steps]}; launches {launches}; {smi}")
        for line in logs:
            phase(8, line)
        if profiled:
            state = hist["final_state"]
            schedule = train_lib.create_train_state(cfg, TRAIN_STEPS, device=dev)[1]
            profile_calls("phase 8 train step", lambda: real_step(
                cfg, schedule, TRAIN_STEPS, state, *data[0]), ms)

        # resume from the epoch-2 checkpoint for one epoch more
        cfg.num_epochs = TRAIN_EPOCHS + 1
        steps.clear()
        reset_counts()
        resumed = loop.train_and_evaluate(cfg, batches(), TRAIN_STEPS, str(TRAIN_DIR),
                                          val_iter_fn=batches, val_steps=1, device=dev,
                                          log_fn=logs.append)
    finally:
        loop.train_step = real_step
    state = resumed["final_state"]
    if not (logs[-1].startswith(f"epoch {TRAIN_EPOCHS + 1}/") and len(steps) == TRAIN_STEPS
            and state.step == (TRAIN_EPOCHS + 1) * TRAIN_STEPS and counts() == (1, 15, 0)):
        raise AssertionError(f"resume: {logs[-1]!r}, {len(steps)} steps, step {state.step}, "
                             f"launches {counts()}")
    phase(8, f"resumed at epoch {TRAIN_EPOCHS} from {TRAIN_DIR.name}/ckpt_{TRAIN_EPOCHS}: "
             f"{logs[-1]}; step {state.step}")
    del state, resumed, hist
    torch.cuda.empty_cache()

    # serve the trained weights (the last checkpoint's, EMA swapped in where kept)
    trained = swap_in_ema(load_checkpoint(str(TRAIN_DIR), latest_checkpoint(str(TRAIN_DIR))))
    server = ServingDriver(cfg, trained, cfg.batch_size, device=dev)
    raw = np.random.RandomState(11).randint(0, 256, (cfg.batch_size, h, w, 3)).astype(np.uint8)
    out, serve_ms, _, launches, _ = timed_calls(lambda: server.serve(raw))
    what = "serve of the trained weights"
    assert_launches(what, launches, (1, 15, 1), sepconv_per_forward(cfg))
    c = cfg.num_classes
    assert_detections(what, out, [(cfg.batch_size, K, 12), (cfg.batch_size, K),
                                  (cfg.batch_size, K, 1 + c), (cfg.batch_size,),
                                  (cfg.batch_size, K, c)])
    if int(out[3].max()) <= 0:
        raise AssertionError(f"{what}: no detections")
    phase(8, f"{what} (prepare_inference, MC T={cfg.mc_dropoutsamp}, bf16): launches in "
             f"{SERVE_CALLS} calls {launches}; valid_len {out[3].tolist()}; {serve_ms:.1f} "
             f"ms/batch; {smi}")
    del server, out
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return ms


class ServeClock:
    """Counts the driver's serves and times each to a synchronisation (a
    wrapper around its three packed entries, which every app reaches)."""

    def __init__(self, driver):
        self.calls, self.seconds, self.device = 0, 0.0, driver.device
        for name in ("serve", "serve_preprocessed", "serve_preprocessed_uint8"):
            setattr(driver, name, self._timed(getattr(driver, name)))

    def _timed(self, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(self.device)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        return timed


def app_run(what, clock, batches, fn):
    """fn() with the launch counts set to 0 before and read after: asserts
    1/15/1 launches a serve; returns (its result, a line of the app's time
    a batch: all, in the serve, on the host)."""
    reset_counts()
    calls0, serve0 = clock.calls, clock.seconds
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    calls, serve = clock.calls - calls0, clock.seconds - serve0
    launches = counts()
    if calls == 0 or launches != per_serve(calls) or \
            fast_launches() != per_serve(calls)[0]:
        raise AssertionError(f"{what}: (fused_dw, fused_expand_dw, soft_nms) launches "
                             f"{launches} in {calls} serves, want 1/15/1 a serve (fast path "
                             f"{fast_launches()})")
    return out, (f"{what}: {batches} batches, {calls} serves, launches {launches}; "
                 f"{wall / batches * 1e3:.1f} ms a batch = serve "
                 f"{serve / batches * 1e3:.1f} + host {(wall - serve) / batches * 1e3:.1f}")


def phase9(dev, smi):
    """Calibrate, threshold, auto-label and validate at KITTI's inference
    configuration, full width: ``Calibrate.run`` over CALIB_BATCHES
    batches, ``UncertOptimal`` on the gathered entropy and relative
    aleatoric σ, ``InferImages`` with the calibrators and thresholds over
    INFER_BATCHES, ``Validator`` over VAL_BATCHES, ``consistency_check`` on
    one batch; every artifact read back, the launches asserted a serve, the
    temperature fits held card vs CPU."""
    path, overrides = KITTI_HEAD
    server = ServingDriver.create("efficientdet-d0", overrides=overrides, batch_size=BATCH,
                                  seed=0, device=dev)
    cfg = server.config
    h, w = parse_image_size(cfg.image_size)
    rng = np.random.RandomState(20)

    def batches(n, tag):
        out = []
        for k in range(n):
            images, labels = synthetic_batch(rng, BATCH, h, w, cfg.num_classes)
            labels["image_names"] = [f"{tag}_{k}_{i}.png" for i in range(BATCH)]
            out.append((images, labels))
        return out

    calib_data, infer_data, val_data = (batches(CALIB_BATCHES, "calib"),
                                        batches(INFER_BATCHES, "infer"),
                                        batches(VAL_BATCHES, "val"))
    shutil.rmtree(APPS_DIR, ignore_errors=True)
    clock = ServeClock(server)
    lines = []
    app = Calibrate(server, str(APPS_DIR / "calib"))
    data, line = app_run("Calibrate.gather_detections", clock, CALIB_BATCHES,
                         lambda: app.gather_detections(calib_data))
    lines.append(line)
    (reg, cls), line = app_run("Calibrate.run", clock, CALIB_BATCHES,
                               lambda: app.run(calib_data))
    lines.append(line)
    loaded = calibration.load_calibrators(str(APPS_DIR / "calib"))
    if sorted(loaded[0]) != sorted(calibration.REGRESSION_CALIBRATORS) or len(loaded[1]) != 8:
        raise AssertionError(f"calibrators read back: {sorted(loaded[0])}, {sorted(loaded[1])}")
    figures = {p.stem: json.loads(p.read_text()) for p in (APPS_DIR / "calib" / "plots").glob("*")}
    if sorted(figures) != ["regression_reliability", "reliability_raw", "reliability_ts"]:
        raise AssertionError(f"Calibrate's figures' numbers: {sorted(figures)}")
    lines.append("Calibrate's figures: " + ", ".join(
        f"{k} " + " ".join(f"{m}={v[m]:.4f}" for m in ("ECE", "MCE", "ACE", "miscal_area",
                                                     "sharpness", "rmsue") if m in v)
        for k, v in sorted(figures.items())))

    # the temperature fits, card vs CPU, on the gathered arrays
    res = np.abs(data["pred_boxes"] - data["gt_boxes"])
    onehot = np.eye(cfg.num_classes)[data["gt_classes"] - 1]
    fits, fit_ms = {}, {}
    for name, fn in (("regression", lambda d: calibration.fit_temperature_regression(
                         res, data["sigma_al"], device=d)),
                     ("classification", lambda d: calibration.fit_temperature_classification(
                         onehot, data["logits"], False, device=d)),
                     ("per class", lambda d: calibration.fit_temperature_classification(
                         onehot, data["logits"], True, device=d))):
        t0 = time.perf_counter()
        card = np.asarray(fn(dev), np.float64)
        t1 = time.perf_counter()
        cpu = np.asarray(fn("cpu"), np.float64)
        fits[name] = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
        fit_ms[name] = ((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3)
        if fits[name] > 1e-5:
            raise AssertionError(f"temperature fit ({name}) card {card} vs CPU {cpu}")

    # thresholds on the entropy and the relative aleatoric σ of the gathered pairs
    probs = calibration.stable_softmax(data["logits"])
    entropy = -np.sum(probs * np.log(np.clip(probs, 1e-12, 1)), -1)
    rel_al = np.mean(calibration.relativize(data["pred_boxes"], data["sigma_al"]), -1)
    tps = (data["pred_classes"] == data["gt_classes"]).astype(float)
    t0 = time.perf_counter()
    uo = UncertOptimal(data["gt_classes"], tps, data["ious"], [entropy, rel_al],
                       source_path=str(APPS_DIR / "thresholds"))
    params = uo.optimize()
    thresholds = read_optimal_thresholds(str(APPS_DIR / "thresholds"))
    lines.append(f"UncertOptimal on {len(tps)} pairs (ENT, ALBOX): weights {params.tolist()}, "
                 f"thresholds {thresholds.tolist()}, {time.perf_counter() - t0:.2f} s")

    # On random weights the ROC never reaches the budget and the thresholds
    # are inf, which labels every image (ROADMAP C10). So the gate is driven
    # with a finite threshold: midway in the widest gap between the images'
    # largest combined uncertainties, read from a probe run on the same masks.
    masks = server.masks.generator.get_state()
    probe = InferImages(server, str(APPS_DIR / "probe"), opt_params=params).run(infer_data)
    server.masks.generator.set_state(masks)
    by_image = {}
    for r in probe:
        u = params[0] * r["entropy"] + params[1] * np.mean(calibration.relativize(
            np.asarray([r["bbox"]]), np.asarray([r["uncalib_albox"]])))
        by_image[r["image_name"]] = max(by_image.get(r["image_name"], -np.inf), u)
    top = np.sort(list(by_image.values()))
    gap = int(np.argmax(np.diff(top) / np.abs(top[1:])))
    gate = (top[gap] + top[gap + 1]) / 2
    want_labeled = sorted(n for n, u in by_image.items() if u < gate)
    gate_dir = APPS_DIR / "gate"
    gate_dir.mkdir()
    (gate_dir / "optimal_thrs_cd_0.95_iou_0.5_0.75.txt").write_text(
        "[" + " ".join([repr(float(gate))] * 6) + "]")

    infer = InferImages(server, str(APPS_DIR / "infer"), calib_dir=str(APPS_DIR / "calib"),
                        auto_labeling=True, opt_params=params, opt_thrs_path=str(gate_dir))
    rows, line = app_run("InferImages", clock, INFER_BATCHES, lambda: infer.run(infer_data))
    lines.append(line)
    parsed = read_prediction_data(str(APPS_DIR / "infer" / "prediction_data.txt"))
    labeled = (APPS_DIR / "infer" / "labeled" / "images.txt").read_text().split()
    examine = (APPS_DIR / "infer" / "examine" / "images.txt").read_text().split()
    sigmas = [v for r in parsed for k, v in r.items() if k.endswith(("_albox", "_mcbox"))]
    pseudo = len(list((APPS_DIR / "infer" / "labeled").glob("*.txt"))) - 1
    if len(parsed) != len(rows) or not parsed or not np.all(np.isfinite(sigmas)) or \
            len(by_image) != INFER_BATCHES * BATCH or not labeled or not examine or \
            sorted(labeled) != want_labeled or pseudo != len(labeled) or \
            len(labeled) + len(examine) != INFER_BATCHES * BATCH:
        raise AssertionError(f"InferImages: {len(parsed)} rows read back of {len(rows)}, "
                             f"{len(by_image)} images with detections, labeled {len(labeled)} "
                             f"(want {len(want_labeled)} below the gate {gate}, {pseudo} "
                             f"pseudo-label files), examine {len(examine)}, calibrated σ "
                             f"finite {np.all(np.isfinite(sigmas))}")
    lines.append(f"InferImages: {len(parsed)} rows, {len(sigmas)} calibrated σ vectors, all "
                 f"finite; gate {float(gate)!r}, midway in the widest gap (relative "
                 f"{np.diff(top)[gap] / abs(top[gap + 1]):.2e}) between the images' largest "
                 f"combined uncertainties, {float(top[0])!r}..{float(top[-1])!r}: labeled {len(labeled)} "
                 f"({pseudo} pseudo-label files), examine {len(examine)}, as the probe run "
                 f"predicts")

    val = Validator(server, str(APPS_DIR / "val"), calib_dir=str(APPS_DIR / "calib"))
    vrows, line = app_run("Validator", clock, VAL_BATCHES, lambda: val.run(val_data))
    lines.append(line)
    vparsed = read_validate_results(str(APPS_DIR / "val" / "validate_results.txt"))
    artifacts = [p.name for p in sorted((APPS_DIR / "val").iterdir())]
    panels = {tag: ast.literal_eval((APPS_DIR / "val" / tag / "metrics.txt").read_text())
              for tag in ("aleatoric", "mcdropout")
              if (APPS_DIR / "val" / tag / "calibration.json").exists()}
    if len(vparsed) != len(vrows) or not vparsed or len(artifacts) != 6 or len(panels) != 2 \
            or not all(np.isfinite(list(m.values())).all() for m in panels.values()):
        raise AssertionError(f"Validator: {len(vparsed)} rows read back of {len(vrows)}, "
                             f"artifacts {artifacts}, calibration panels {panels}")
    lines.append(f"Validator: {len(vparsed)} rows, {artifacts}; "
                 + (APPS_DIR / "val" / "model_performance.txt").read_text().replace("\n", " ")
                 + f"; calibration panels {panels}")

    images = infer_data[0][0]
    blur = gaussian_blur_uint8(images, 9, dev)
    if not torch.equal(blur.cpu(), gaussian_blur_uint8(images, 9, "cpu")):
        raise AssertionError("the 9x9 blur on the card differs from the CPU's")
    lines.append(f"gaussian_blur_uint8 9x9 of {tuple(blur.shape)}: card equal to the CPU")
    base = split_serve_outputs(cfg, server.serve(images))
    (miou, agree), line = app_run("consistency_check (flip, blur, noise)", clock, 1,
                                  lambda: consistency_check(server, images, base["boxes"],
                                                            base["classes"]))
    lines.append(line + f"; mean IoU {float(miou.mean()):.4f}, class agreement "
                        f"{float(agree.mean()):.4f}")
    for line in lines:
        phase(9, line)
    phase(9, f"KITTI ({path}) d0 {h}x{w}, head-only MC T={cfg.mc_dropoutsamp}, bf16, batch "
             f"{BATCH}: temperature fits card vs CPU, largest relative difference "
             f"{fits}, ms a fit (card, CPU) "
             f"{ {k: (round(a, 1), round(b, 1)) for k, (a, b) in fit_ms.items()} }; {smi}")
    del server
    shutil.rmtree(APPS_DIR, ignore_errors=True)
    torch.cuda.empty_cache()


# phase 10: KITTI's training operating point fed from TFRecords of PNG frames
READER_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_reader"
KITTI_FRAMES, KITTI_TRAIN_FRAMES = 48, 32
CLI_EPOCHS, CLI_STEPS = 2, 4
KITTI_CLASSES = ("Car", "Van", "Truck", "Pedestrian", "Person_sitting", "Cyclist", "Tram")
JPEG_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "torch_jpeg"
STEP_BUDGET_MS = 373.7          # KITTI's training step on the H100 (PERF.md §5): 8 images a step


def kitti_frame(rng, h, w):
    """A KITTI-sized frame: smooth colour fields (a coarse grid of random
    colours, bilinearly enlarged) with pixel noise, under 1-10 flat boxes
    of KITTI's classes; its ``label_2`` lines."""
    low = rng.randint(0, 256, (max(2, h // 32), max(2, w // 32), 3)).astype(np.uint8)
    img = resize_bilinear_uint8(low, (h, w)).astype(np.int16)
    img += rng.randint(-6, 7, img.shape).astype(np.int16)
    lines = []
    for _ in range(rng.randint(1, 11)):
        bh, bw = rng.randint(h // 10, h // 2), rng.randint(w // 20, w // 4)
        y1, x1 = rng.randint(0, h - bh), rng.randint(0, w - bw)
        cls = KITTI_CLASSES[rng.randint(len(KITTI_CLASSES))]
        img[y1:y1 + bh, x1:x1 + bw] = rng.randint(0, 256, 3)
        lines.append(f"{cls} 0.00 0 0.00 {x1:.2f} {y1:.2f} {x1 + bw:.2f} {y1 + bh:.2f} "
                     "1.50 1.60 3.90 0.00 1.50 10.00 0.00")
    return np.clip(img, 0, 255).astype(np.uint8), lines


def write_kitti_layout(root, frames, native, seed):
    """``image_2/*.png`` (the port's encoder, 8 threads) and ``label_2/*.txt``
    of ``frames`` frames, then ``kitti_to_tfrecord`` into train and val.
    Returns (train file, val file, seconds)."""
    t0 = time.perf_counter()
    (root / "image_2").mkdir(parents=True)
    (root / "label_2").mkdir()
    rng = np.random.RandomState(seed)
    drawn = [kitti_frame(rng, *native) for _ in range(frames)]

    def write(i):
        img, lines = drawn[i]
        (root / "image_2" / f"{i:06d}.png").write_bytes(encode_png(img))
        (root / "label_2" / f"{i:06d}.txt").write_text("\n".join(lines) + "\n")

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(frames)))
    stems = [f"{i:06d}" for i in range(frames)]
    train, val = str(root / "train.tfrecord"), str(root / "val.tfrecord")
    n_train = kitti_to_tfrecord(str(root / "image_2"), str(root / "label_2"), train,
                                indices=stems[:KITTI_TRAIN_FRAMES])
    n_val = kitti_to_tfrecord(str(root / "image_2"), str(root / "label_2"), val,
                              indices=stems[KITTI_TRAIN_FRAMES:])
    if (n_train, n_val) != (KITTI_TRAIN_FRAMES, frames - KITTI_TRAIN_FRAMES):
        raise AssertionError(f"kitti_to_tfrecord wrote {n_train} + {n_val} records")
    return train, val, time.perf_counter() - t0


def derived_hparams(src, dst, **overrides):
    """``src``'s yaml with ``overrides`` put in place of its lines for
    those keys (or added): the file the CLI reads with the port's reader."""
    lines = [line for line in Path(src).read_text().splitlines()
             if line.split(":", 1)[0].strip() not in overrides]
    lines += [f"{k}: {v}" for k, v in overrides.items()]
    Path(dst).write_text("\n".join(lines) + "\n")
    return str(dst)


def reader_rate(pattern, cfg, batches=3, **kw):
    """img/s of a training reader over ``batches`` batches of BATCH, after
    a first batch that warms it (and starts its workers)."""
    reader = InputReader(pattern, True, prefetch=2, seed=0, **kw)
    it = reader(cfg, BATCH)
    next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    dt = time.perf_counter() - t0
    it.close()
    return batches * BATCH / dt


def jpeg_rates():
    """Decode every committed JPEG fixture and hold it to the sha256 of
    cv2's decode; img/s of the decode alone at 1 and 8 threads."""
    hashes = json.loads((JPEG_FIXTURES / "hashes.json").read_text())
    data = {name: (JPEG_FIXTURES / name).read_bytes() for name in hashes}
    for name, blob in data.items():
        got = hashlib.sha256(decode_image(blob).tobytes()).hexdigest()
        if got != hashes[name]:
            raise AssertionError(f"JPEG fixture {name}: decode sha256 {got}, cv2's "
                                 f"{hashes[name]}")
    blobs = list(data.values()) * 4
    rates = {}
    for threads in (1, 8):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(decode_image, blobs))
        rates[threads] = len(blobs) / (time.perf_counter() - t0)
    return sorted(hashes), rates


def phase10(dev, smi, profiled=False, native=KITTI_NATIVE, extra=None):
    """KITTI's training operating point fed from TFRecords: a KITTI layout
    of PNG frames written by the port's encoder and ``kitti_to_tfrecord``;
    ``cli train`` (the KITTI hparams file with map_freq and save_freq 1,
    batch 8, CLI_EPOCHS x CLI_STEPS) with the COCO callback every epoch,
    its launches asserted 1/1/15 a validation batch; one epoch with
    ``--device_resize``; ``cli eval`` and ``inspect --mode validate`` from
    the checkpoint, the eval's COCO numbers held to the callback's with
    dropout off; the reader alone on the host and the JPEG fixtures. ``extra`` adds
    hparams (a CPU rehearsal's small size). Writes and removes
    ``build/chip_smoke_reader/``."""
    path, _ = KITTI_TRAIN
    shutil.rmtree(READER_DIR, ignore_errors=True)
    train, val, write_s = write_kitti_layout(READER_DIR / "kitti", KITTI_FRAMES, native, 30)
    hparams = derived_hparams(path, READER_DIR / "kitti_train.yaml", map_freq=1, save_freq=1,
                              **(extra or {}))
    eval_hparams = derived_hparams(hparams, READER_DIR / "kitti_eval.yaml", mc_dropout="false")
    n_val = KITTI_FRAMES - KITTI_TRAIN_FRAMES
    common = ["--batch_size", str(BATCH), "--val_file_pattern", val, "--eval_samples",
              str(n_val), "--device", str(dev)]
    phase(10, f"KITTI layout: {KITTI_FRAMES} PNG frames {native[0]}x{native[1]} "
              f"({sum(p.stat().st_size for p in (READER_DIR / 'kitti' / 'image_2').iterdir()) / KITTI_FRAMES / 1e6:.2f} "
              f"MB a frame), TFRecords {KITTI_TRAIN_FRAMES} train + {n_val} val in "
              f"{write_s:.1f} s")

    steps, callbacks, real_step = [], [], loop.train_step
    real_callback = COCOCallback.__call__

    def timed_step(*args, **kwargs):
        t0 = time.perf_counter()
        out = real_step(*args, **kwargs)
        sync(dev)
        steps.append(time.perf_counter() - t0)
        return out

    def timed_callback(self, epoch, state, writer=None):
        reset_counts()
        serve_s, build_s = [], []
        real_driver = self.driver

        def timed_driver(state):
            t0 = time.perf_counter()
            driver = real_driver(state)
            build_s.append(time.perf_counter() - t0)
            for name in ("serve_detections_preprocessed", "serve_detections_preprocessed_uint8"):
                entry = getattr(driver, name)

                def timed(*args, _entry=entry, **kwargs):
                    t1 = time.perf_counter()
                    out = _entry(*args, **kwargs)
                    sync(dev)
                    serve_s.append(time.perf_counter() - t1)
                    return out
                setattr(driver, name, timed)
            return driver

        self.driver = timed_driver
        t0 = time.perf_counter()
        try:
            ap = real_callback(self, epoch, state, writer)
        finally:
            del self.driver
        sync(dev)
        callbacks.append((time.perf_counter() - t0, counts(), fast_launches(),
                          self.val_steps, ap, sum(serve_s), sum(build_s)))
        return ap

    runs = {}
    loop.train_step, COCOCallback.__call__ = timed_step, timed_callback
    try:
        for name, flags, epochs in (("classic", [], CLI_EPOCHS),
                                    ("device_resize", ["--device_resize"], 1)):
            steps.clear()
            model_dir = str(READER_DIR / f"model_{name}")
            t0 = time.perf_counter()
            hist = cli.main(["train", "--train_file_pattern", train, "--model_dir", model_dir,
                             "--hparams", hparams, "--num_epochs", str(epochs),
                             "--steps_per_epoch", str(CLI_STEPS), *flags, *common])
            runs[name] = (hist, list(steps), time.perf_counter() - t0, model_dir)
    finally:
        loop.train_step, COCOCallback.__call__ = real_step, real_callback

    hist, step_s, wall, model_dir = runs["classic"]
    ms = statistics.median(step_s[1:]) * 1e3
    losses = hist["loss"] + hist["val_loss"]
    if len(step_s) != CLI_EPOCHS * CLI_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"cli train: {len(step_s)} steps, losses {losses}")
    if latest_checkpoint(model_dir) != CLI_EPOCHS:
        raise AssertionError(f"cli train: no checkpoint of epoch {CLI_EPOCHS} in {model_dir}")
    aps = hist.get("AP", [])
    if len(aps) != CLI_EPOCHS or not all(0.0 <= ap <= 1.0 for ap in aps):
        raise AssertionError(f"cli train: the callback's APs {aps}")
    check_callback_launches(callbacks)
    cb_ms = [c[0] * 1e3 for c in callbacks]
    cb_split = ", ".join(f"{c[0] * 1e3:.0f} = serves {c[5] * 1e3:.0f} + driver build "
                         f"{c[6] * 1e3:.0f} + reader, COCO matching and the NMS grid "
                         f"{(c[0] - c[5] - c[6]) * 1e3:.0f}" for c in callbacks)
    wait = hist["input_wait"]
    phase(10, f"cli train ({path} via the port's YAML reader, map_freq 1, batch {BATCH}): "
              f"{CLI_EPOCHS} epochs x {CLI_STEPS} steps in {wall:.1f} s, {ms:.1f} ms/step "
              f"(median of steps 2-{len(step_s)}, each timed to a synchronisation; first "
              f"{step_s[0] * 1e3:.0f} ms), {BATCH / ms * 1e3:.1f} img/s; input wait "
              f"{wait['wait_s']:.2f} s of {wait['total_s']:.2f} s iterating "
              f"({wait['wait_fraction']:.1%}); losses {hist['loss']}, val {hist['val_loss']}; "
              f"COCO callback AP {aps}; ms an evaluation of {n_val} images: {cb_split}; "
              f"launches a call {[c[1] for c in callbacks]}; {smi}")
    dr_hist, dr_steps, dr_wall, _ = runs["device_resize"]
    dr_ms = statistics.median(dr_steps[1:]) * 1e3
    if len(dr_steps) != CLI_STEPS or not np.all(np.isfinite(dr_hist["loss"])):
        raise AssertionError(f"cli train --device_resize: {len(dr_steps)} steps, "
                             f"losses {dr_hist['loss']}")
    phase(10, f"cli train --device_resize (native {native[0]}x{native[1]} uint8, warped on "
              f"the card): 1 epoch x {CLI_STEPS} steps in {dr_wall:.1f} s, {dr_ms:.1f} ms/step "
              f"(classic contract {ms:.1f}); input wait "
              f"{dr_hist['input_wait']['wait_fraction']:.1%}; {smi}")
    if profiled:
        cfg = get_detection_config("efficientdet-d0").override(hparams)
        cfg.override({"batch_size": BATCH}, allow_new_keys=True)
        state, schedule = train_lib.create_train_state(cfg, CLI_STEPS, device=dev)
        it = InputReader(train, True, prefetch=0)(cfg, BATCH)
        images, labels = next(it)
        it.close()
        labels = {k: v for k, v in labels.items() if not isinstance(v, list)}
        profile_calls("phase 10 train step", lambda: real_step(
            cfg, schedule, CLI_STEPS, state, images, labels), ms)
        del state

    # cli eval from the checkpoint with dropout off, against the callback on
    # the same weights and val file
    cfg_off = get_detection_config("efficientdet-d0").override(eval_hparams)
    cfg_off.override({"batch_size": BATCH}, allow_new_keys=True)
    state, _ = train_lib.create_train_state(cfg_off, CLI_STEPS, device=dev)
    restore_checkpoint(model_dir, state)
    val_reader = InputReader(val, False)
    callback = COCOCallback(cfg_off, lambda: val_reader(cfg_off, BATCH), n_val // BATCH,
                            str(READER_DIR / "eval_logs"), get_label_map(cfg_off.label_map))
    want = callback.evaluate(callback.driver(state))[0]
    del state
    reset_counts()
    t0 = time.perf_counter()
    results = cli.main(["eval", "--model_dir", model_dir, "--hparams", eval_hparams,
                        "--fine_grid", *common])
    sync(dev)
    eval_s, eval_launches = time.perf_counter() - t0, counts()
    # every number on the 0.05 grid, not the AP alone: a few random-weight
    # boxes overlap groundtruth at the low IoUs, where the numbers are not 0
    diff = {k: abs(results[k] - v) for k, v in want.items()}
    nonzero = sorted(k for k, v in want.items() if v > 0)
    if results.keys() - {"ECE"} != want.keys() or max(diff.values()) > 1e-6 or not nonzero \
            or not np.isfinite(results["ECE"]):
        raise AssertionError(f"cli eval {results} against the callback's {want} on the same "
                             f"weights, dropout off: largest difference {max(diff.values())}, "
                             f"{len(nonzero)} numbers above 0")
    reset_counts()
    t0 = time.perf_counter()
    rows = cli.main(["inspect", "--mode", "validate", "--model_dir", model_dir, "--hparams",
                     hparams, "--output_dir", str(READER_DIR / "validate"), *common])
    sync(dev)
    inspect_s, inspect_launches = time.perf_counter() - t0, counts()
    if not (READER_DIR / "validate" / "validate_results.txt").exists():
        raise AssertionError("inspect --mode validate wrote no validate_results.txt")
    check_serve_launches("cli eval", eval_launches, n_val // BATCH)
    check_serve_launches("inspect --mode validate", inspect_launches, n_val // BATCH)
    phase(10, f"cli eval --fine_grid (dropout off, from {Path(model_dir).name}/"
              f"ckpt_{CLI_EPOCHS}): AP {results['AP']:.6f}, the callback's {want['AP']:.6f}; all "
              f"{len(want)} numbers within {max(diff.values()):.1e} of the callback's, "
              f"{len(nonzero)} above 0 (AP@0.05 {want['AP@0.05']:.6f}); ECE "
              f"{results['ECE']:.4f}; "
              f"{n_val} images in {eval_s:.2f} s ({n_val / eval_s:.1f} img/s, driver build and "
              f"reader included), launches {eval_launches}; inspect --mode validate (MC "
              f"dropout): {len(rows)} groundtruths in {inspect_s:.2f} s "
              f"({n_val / inspect_s:.1f} img/s), launches {inspect_launches}; {smi}")

    # the reader alone on the host: decode + resize + labels (classic contract)
    cfg = get_detection_config("efficientdet-d0").override(hparams)
    need = BATCH / STEP_BUDGET_MS * 1e3
    rates = {f"{t} threads": reader_rate(train, cfg, num_workers=t) for t in (1, 4, 8)}
    rates["4 processes"] = reader_rate(train, cfg, num_proc=4)
    fast = {f"{t} threads": reader_rate(train, cfg, num_workers=t, fast_input=True)
            for t in (1, 8)}
    names, jpeg = jpeg_rates()
    phase(10, "reader alone, training batches of {BATCH}, img/s: PNG decode + f32 resize + "
              "per-level labels (the classic contract, cli train's default) ".format(BATCH=BATCH)
          + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
          + "; PNG decode + uint8 resize + compact groundtruth (--fast_input) "
          + ", ".join(f"{k} {v:.1f}" for k, v in fast.items())
          + f"; a {STEP_BUDGET_MS} ms step needs {need:.1f} img/s (classic best "
          f"{max(rates.values()):.1f}, fast_input best {max(fast.values()):.1f}); JPEG "
          f"1280x720 decode img/s: 1 thread {jpeg[1]:.1f}, 8 threads {jpeg[8]:.1f} "
          f"({', '.join(names)}: each decode's sha256 equals cv2's); {smi}")
    shutil.rmtree(READER_DIR, ignore_errors=True)
    torch.cuda.empty_cache()


# phase 11: augmentation, active learning and semi-supervised learning at the
# main path's operating point, on phase 10's layout of KITTI PNG frames
AL_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_al"
AL_POOL, SSL_LABELED, SSL_UNLABELED = 48, 16, 32
AL_BUDGETS, AL_STEPS, SSL_STEPS = "25,25", 4, 4
POLICIES = ("v0", "randaug", "albu")


class DeviceClock:
    """CUDA events around each call of a method (no synchronisation): the
    stream time of the calls, read once the work is done; host time on the
    CPU."""

    def __init__(self, dev):
        self.cuda = torch.device(dev).type == "cuda"
        self.spans, self.host, self.calls = [], 0.0, 0

    def wrap(self, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            if self.cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
            out = fn(*args, **kwargs)
            if self.cuda:
                end.record()
                self.spans.append((start, end))
            self.host += time.perf_counter() - t0
            self.calls += 1
            return out
        return timed

    def device_ms(self):
        if not self.cuda:
            return float("nan")
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.spans)


def per_serve(n):
    """(fused_dw, fused_expand_dw, soft_nms) launches of n serves."""
    return (n, 15 * n, n)


def al_args(hparams, pool, work, dev, strategy="entropy"):
    return ["al", "--pool_file_pattern", pool, "--work_dir", work, "--strategy", strategy,
            "--budgets", AL_BUDGETS, "--batch_size", str(BATCH), "--num_epochs", "1",
            "--steps_per_epoch", str(AL_STEPS), "--hparams", hparams, "--device", str(dev)]


def phase11(dev, smi, native=KITTI_NATIVE, extra=None):
    """Augmentation, active learning and SSL at the main path's operating
    point (``MAIN_PATH``'s 8 classes, 1024x512, MC T=10 at rate 0.05, loss
    attenuation, on the KITTI training file's other hparams, save_freq 1),
    batch 8, bf16, on a KITTI layout of PNG frames as phase 10 writes it:
    the training reader with each policy of ``POLICIES`` (img/s on 1 and 8
    threads, uint8 contract); ``cli al`` over a pool of AL_POOL frames
    (entropy, budgets AL_BUDGETS, AL_STEPS steps an iteration): ms of each
    training and of ``collect_pool`` (its serves' stream time against its
    wall time: the host's share), img/s scored, 1/15/1 launches a pool
    batch, and a rerun that resumes to the same selection with no launch;
    ``cli ssl --method stac --stac_randaug`` (SSL_LABELED labelled,
    SSL_UNLABELED unlabelled frames, SSL_STEPS teacher and student steps)
    with 1/15/1 launches a pseudo-label batch; ``cli ssl --method csd``;
    ``Validator`` with all four ``infer_augment`` modes on one batch: 20
    serves at 1/15/1 each, the variants' stream time on the card against
    the same variants made image by image on the host, as the JAX package
    makes them.
    ``extra`` adds hparams (a CPU rehearsal's small size). Writes and
    removes ``build/chip_smoke_al/``."""
    from udal_tpu_torch.apps import al_scoring
    from udal_tpu_torch.apps import infer as infer_mod
    from udal_tpu_torch.data import augment

    path, _ = KITTI_TRAIN
    shutil.rmtree(AL_DIR, ignore_errors=True)
    t_phase = time.perf_counter()
    frames = AL_POOL + SSL_LABELED + SSL_UNLABELED
    (AL_DIR / "kitti" / "image_2").mkdir(parents=True)
    (AL_DIR / "kitti" / "label_2").mkdir()
    rng = np.random.RandomState(31)
    drawn = [kitti_frame(rng, *native) for _ in range(frames)]

    def write(i):
        img, lines = drawn[i]
        (AL_DIR / "kitti" / "image_2" / f"{i:06d}.png").write_bytes(encode_png(img))
        (AL_DIR / "kitti" / "label_2" / f"{i:06d}.txt").write_text("\n".join(lines) + "\n")

    with ThreadPoolExecutor(8) as pool_exec:
        list(pool_exec.map(write, range(frames)))
    stems = [f"{i:06d}" for i in range(frames)]
    files = {}
    for name, part in (("pool", stems[:AL_POOL]),
                       ("labeled", stems[AL_POOL:AL_POOL + SSL_LABELED]),
                       ("unlabeled", stems[AL_POOL + SSL_LABELED:])):
        files[name] = str(AL_DIR / f"{name}.tfrecord")
        if kitti_to_tfrecord(str(AL_DIR / "kitti" / "image_2"), str(AL_DIR / "kitti" / "label_2"),
                             files[name], indices=part) != len(part):
            raise AssertionError(f"kitti_to_tfrecord wrote a short {name} file")
    main = {k: v for k, v in MAIN_PATH.items() if k != "image_size"}
    hparams = derived_hparams(path, AL_DIR / "kitti_al.yaml",
                              **{"save_freq": 1, "map_freq": 0, **main, **(extra or {})})
    cfg = get_detection_config("efficientdet-d0").override(hparams)
    lines = [f"KITTI layout: {frames} PNG frames {native[0]}x{native[1]} (pool {AL_POOL}, SSL "
             f"{SSL_LABELED} labelled + {SSL_UNLABELED} unlabelled) in "
             f"{time.perf_counter() - t_phase:.1f} s; {path} with {main}"]

    # the training reader with each policy (uint8 contract), img/s
    rates = {}
    for policy in POLICIES:
        pc = cfg.copy()
        pc.autoaugment_policy = policy
        rates[policy] = {t: reader_rate(files["pool"], pc, num_workers=t, fast_input=True)
                         for t in (1, 8)}
    plain = {t: reader_rate(files["pool"], cfg, num_workers=t, fast_input=True) for t in (1, 8)}
    lines.append("training reader (uint8 contract, batches of 8), img/s on 1 / 8 threads: "
                 + ", ".join(f"{p} {r[1]:.1f} / {r[8]:.1f}" for p, r in rates.items())
                 + f"; no policy {plain[1]:.1f} / {plain[8]:.1f}")

    # cli al: training and the pool's scoring timed, launches a pool batch
    steps, pools = [], []
    real_step, real_collect = loop.train_step, al_scoring.collect_pool

    def timed_step(*args, **kwargs):
        t0 = time.perf_counter()
        out = real_step(*args, **kwargs)
        sync(dev)
        steps.append(time.perf_counter() - t0)
        return out

    def timed_collect(driver, batches, *args, **kwargs):
        clock = DeviceClock(dev)
        driver.serve_preprocessed = clock.wrap(driver.serve_preprocessed)
        reset_counts()
        t0 = time.perf_counter()
        out = real_collect(driver, batches, *args, **kwargs)
        sync(dev)
        wall = time.perf_counter() - t0
        pools.append((wall, clock.device_ms(), clock.calls, counts(),
                      fast_launches(), out.n_images))
        return out

    work = str(AL_DIR / "al")
    loop.train_step, al_scoring.collect_pool = timed_step, timed_collect
    try:
        t0 = time.perf_counter()
        selected = cli.main(al_args(hparams, files["pool"], work, dev))
        al_s = time.perf_counter() - t0
        reset_counts()
        n_steps = len(steps)
        again = cli.main(al_args(hparams, files["pool"], work, dev))
        resumed = (counts(), len(steps) - n_steps)
    finally:
        loop.train_step, al_scoring.collect_pool = real_step, real_collect
    per_iter = AL_POOL * 25 // 100
    if len(selected) != 2 * per_iter or len(set(selected)) != len(selected) or \
            any(n.startswith("__pad") for n in selected):
        raise AssertionError(f"cli al selected {selected}")
    if again != selected or resumed != ((0, 0, 0), 0):
        raise AssertionError(f"cli al rerun: {again} (launches {resumed[0]}, {resumed[1]} "
                             f"steps) against {selected}")
    if len(pools) != 1:
        raise AssertionError(f"cli al scored the pool {len(pools)} times, want 1")
    wall, dev_ms, serves, launches, fast, scored = pools[0]
    batches = -(-(AL_POOL - per_iter) // BATCH)
    if serves != batches or launches != per_serve(batches) or fast != per_serve(batches)[0]:
        raise AssertionError(f"collect_pool: {serves} serves, launches {launches} (fast path "
                             f"{fast}) over {batches} batches, want 1/15/1 a batch")
    step_ms = [s * 1e3 for s in steps[:n_steps]]
    # the same pool scored again by the trained model, in each reader contract
    driver = ServingDriver(cfg, checkpoint_state_dict(cfg, str(Path(work) / "iter_1" / "model")),
                           batch_size=BATCH, device=dev)
    contracts = {}
    for name, fast in (("classic", False), ("uint8", True)):
        it = InputReader(files["pool"], False, names=True, fast_input=fast)(cfg, BATCH)
        clock = DeviceClock(dev)
        entry = "serve_preprocessed_uint8" if fast else "serve_preprocessed"
        setattr(driver, entry, clock.wrap(getattr(driver, entry)))
        t0 = time.perf_counter()
        pool_out = real_collect(driver, it)
        sync(dev)
        contracts[name] = ((time.perf_counter() - t0) * 1e3, clock.device_ms(),
                           pool_out.n_images)
        it.close()
    del driver
    lines.append(f"collect_pool over the whole pool of {AL_POOL} with the trained model, ms "
                 f"(wall, serves' stream time): " + ", ".join(
                     f"{k} contract {w:.1f}, {d:.1f} ({AL_POOL / w * 1e3:.1f} img/s)"
                     for k, (w, d, _) in contracts.items()))
    lines.append(
        f"cli al (entropy, budgets {AL_BUDGETS} of {AL_POOL}, {AL_STEPS} steps an iteration): "
        f"{al_s:.1f} s; train steps ms {[round(x, 1) for x in step_ms]} (median "
        f"{statistics.median(step_ms[1:]):.1f}); collect_pool over {AL_POOL - per_iter} images "
        f"({batches} batches, {scored} images with detections, padding included): "
        f"{wall * 1e3:.1f} ms, "
        f"{(AL_POOL - per_iter) / wall:.1f} img/s scored, serves' stream time {dev_ms:.1f} ms "
        f"(host share {1 - dev_ms / (wall * 1e3):.1%}), launches {launches} (1/15/1 a batch); "
        f"the rerun resumed to the same {len(again)} names with no step and no launch")

    # cli ssl: STAC with RandAugment on the pseudo-labelled stream, then CSD
    real_run = infer_mod.InferImages.run
    infers = []

    def counted_run(self, batch_iter):
        reset_counts()
        t0 = time.perf_counter()
        rows = real_run(self, batch_iter)
        sync(dev)
        infers.append((time.perf_counter() - t0, counts(), len(rows)))
        return rows

    ssl_common = ["--train_file_pattern", files["labeled"], "--unlabeled_file_pattern",
                  files["unlabeled"], "--batch_size", str(BATCH), "--num_epochs", "1",
                  "--steps_per_epoch", str(SSL_STEPS), "--hparams", hparams, "--device",
                  str(dev)]
    steps.clear()
    loop.train_step, infer_mod.InferImages.run = timed_step, counted_run
    try:
        t0 = time.perf_counter()
        arts = cli.main(["ssl", "--method", "stac", "--stac_randaug", "--tau", "0.0",
                         "--pseudoscore", "--work_dir", str(AL_DIR / "stac"), *ssl_common])
        stac_s, stac_steps = time.perf_counter() - t0, [s * 1e3 for s in steps]
        steps.clear()
        t0 = time.perf_counter()
        csd_dir = cli.main(["ssl", "--method", "csd", "--csd_ramp", "--work_dir",
                            str(AL_DIR / "csd"), *ssl_common])
        csd_s, csd_steps = time.perf_counter() - t0, [s * 1e3 for s in steps]
    finally:
        loop.train_step, infer_mod.InferImages.run = real_step, real_run
    n_batches = -(-SSL_UNLABELED // BATCH)
    if len(infers) != 1 or infers[0][1] != per_serve(n_batches):
        raise AssertionError(f"STAC's pseudo-label round: launches {infers} over {n_batches} "
                             f"batches, want 1/15/1 a batch")
    pseudo = len(list(tfrecord.iterate_tfrecord(arts[0])))
    if len(stac_steps) != 2 * SSL_STEPS or len(csd_steps) != SSL_STEPS or not pseudo or \
            latest_checkpoint(csd_dir) != 1:
        raise AssertionError(f"cli ssl: {len(stac_steps)} STAC and {len(csd_steps)} CSD steps, "
                             f"{pseudo} pseudo-labelled records, CSD checkpoint "
                             f"{latest_checkpoint(csd_dir)}")
    lines.append(
        f"cli ssl --method stac --stac_randaug ({SSL_LABELED} labelled, {SSL_UNLABELED} "
        f"unlabelled, tau 0): {stac_s:.1f} s; teacher + student steps ms "
        f"{[round(x, 1) for x in stac_steps]}; pseudo-label round {infers[0][0] * 1e3:.1f} ms, "
        f"{infers[0][2]} rows, {pseudo} records, launches {infers[0][1]} (1/15/1 a batch); "
        f"cli ssl --method csd: {csd_s:.1f} s, steps ms {[round(x, 1) for x in csd_steps]}")

    # the Validator's four inference-time augmentations on one batch
    driver = ServingDriver(cfg, random_state_dict(cfg), batch_size=BATCH, device=dev)
    h, w = parse_image_size(cfg.image_size)
    images, labels = synthetic_batch(np.random.RandomState(32), BATCH, h, w, cfg.num_classes)
    labels["image_names"] = [f"val_{i}.png" for i in range(BATCH)]
    val = Validator(driver, str(AL_DIR / "val"), infer_augment=["heq", "alb", "aug", "flip"])
    vclock = DeviceClock(dev)
    for name in ("heq", "weather", "corruption"):
        setattr(val.variants, name, vclock.wrap(getattr(val.variants, name)))
    serve_clock = ServeClock(driver)
    reset_counts()
    t0 = time.perf_counter()
    vrows = val.run([(images, labels)])
    sync(dev)
    val_s = time.perf_counter() - t0
    launches = counts()
    if serve_clock.calls != 20 or launches != per_serve(20) or \
            fast_launches() != per_serve(20)[0]:
        raise AssertionError(f"Validator with heq/alb/aug/flip: {serve_clock.calls} serves, "
                             f"launches {launches}, want 20 serves at 1/15/1")
    tags = {r["image_name"].split("@")[-1] for r in vrows if "@" in r["image_name"]}
    t0 = time.perf_counter()
    for im in images:                      # the same variants image by image on the host
        augment.AugmentVariants("cpu").heq(torch.from_numpy(im)[None])
        for weather in ("snow", "fog", "rain", "noise"):
            augment.add_weather(im, weather)
        for kind in ("ns", "mb", "ct", "br"):
            augment.apply_corruption(kind, im)
    host_ms = (time.perf_counter() - t0) * 1e3
    lines.append(
        f"Validator(infer_augment=[heq, alb, aug, flip]) on one batch of {BATCH}: "
        f"{val_s:.2f} s, {serve_clock.calls} serves ({serve_clock.seconds * 1e3:.0f} ms to a "
        f"synchronisation), launches {launches} (1/15/1 a serve), {len(vrows)} rows, "
        f"{len(tags)} variant tags with rows; the 17 variants besides the flips: stream time "
        f"{vclock.device_ms():.2f} ms (host {vclock.host * 1e3:.1f} ms to enqueue, the shape's "
        f"draws made on the first call); the same variants image by image on the host "
        f"(the per-image functions, the JAX package's layout of the work) {host_ms:.0f} ms")
    del driver
    for line in lines:
        phase(11, line)
    phase(11, f"d0 {h}x{w}, {cfg.num_classes} classes, MC T={cfg.mc_dropoutsamp}, bf16, batch "
              f"{BATCH}; {smi}")
    shutil.rmtree(AL_DIR, ignore_errors=True)
    torch.cuda.empty_cache()


# phase 12: the apps' image artifacts and profiling, on native KITTI frames
ART_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_artifacts"
ART_BATCHES, GT_FRAMES = 4, 16


class Stopwatch:
    """Host seconds spent in each wrapped function, by name."""

    def __init__(self):
        self.seconds = {}

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
        return timed


def phase12(dev, smi, native=KITTI_NATIVE, extra=None):
    """The apps' image artifacts and profiling at KITTI's inference
    configuration (phase 9's), batch 8, bf16, on native ``native`` frames
    read by the device-resize reader (a KITTI layout written as phase 10
    writes it): ``InferImages`` with auto-labeling over ART_BATCHES
    batches without and with ``save_visualizations`` (1/15/1 launches a
    serve; every overlay, panel and contact sheet read back with the
    port's decoder and its shape checked; ms a batch split into the serve,
    drawing, PNG writing, the buckets' read-back and the rest of the
    host); ``Validator`` over the same batches and ``export_quadrant_crops``
    over its rows; ``plot_tfrecord_groundtruth`` over the GT_FRAMES
    frames of the val shard; ``profiling.trace`` around two serves (the
    trace file names the soft-NMS, fused depthwise and expand kernels) and
    ``device_memory_stats``. ``extra`` adds hparams (a CPU rehearsal's
    small size). Writes and removes ``build/chip_smoke_artifacts/``."""
    from udal_tpu_torch.apps import infer as infer_mod
    from udal_tpu_torch.apps.reader_batches import serve_reader_batch
    from udal_tpu_torch.apps.uncertainty_analysis import export_quadrant_crops
    from udal_tpu_torch.data.plot_gt import plot_tfrecord_groundtruth

    path, overrides = KITTI_HEAD
    shutil.rmtree(ART_DIR, ignore_errors=True)
    t_phase = time.perf_counter()
    train, val, write_s = write_kitti_layout(ART_DIR / "kitti", ART_BATCHES * BATCH + GT_FRAMES,
                                             native, seed=41)
    server = ServingDriver.create("efficientdet-d0", overrides={**overrides, **(extra or {})},
                                  batch_size=BATCH, seed=0, device=dev)
    cfg = server.config
    h, w = parse_image_size(cfg.image_size)
    it = InputReader(train, False, names=True, fast_input=True, device_resize=True)(cfg, BATCH)
    batches = [next(it) for _ in range(ART_BATCHES)]
    it.close()
    frames = {n: im for images, labels in batches
              for n, im in zip(labels["image_names"], images)}
    if any(im.shape != (*native, 3) for im in frames.values()) or len(frames) != ART_BATCHES * BATCH:
        raise AssertionError(f"device-resize reader: {len(frames)} frames of "
                             f"{ {im.shape for im in frames.values()} }, want {native}")
    serve_reader_batch(server, *batches[0])         # a first serve at these shapes, untimed
    sync(dev)
    clock = ServeClock(server)
    lines = []

    def measured(what, fn):
        """fn() through app_run, and the seconds of its wall and serves."""
        serve0, t0 = clock.seconds, time.perf_counter()
        out, line = app_run(what, clock, ART_BATCHES, fn)
        return out, line, time.perf_counter() - t0, clock.seconds - serve0

    params = [0.5, 0.5]
    plain = InferImages(server, str(ART_DIR / "plain"), auto_labeling=True, opt_params=params)
    _, line, plain_s, plain_serve = measured("InferImages", lambda: plain.run(batches))
    lines.append(line)

    watch = Stopwatch()
    real = {n: getattr(infer_mod, n) for n in ("overlay_panels", "contact_sheet", "write_png",
                                               "decode_image")}
    for n, fn in real.items():
        setattr(infer_mod, n, watch.wrap(n, fn))
    try:
        vis = InferImages(server, str(ART_DIR / "vis"), auto_labeling=True, opt_params=params,
                          save_visualizations=True)
        rows, line, vis_s, vis_serve = measured("InferImages(save_visualizations=True)",
                                                lambda: vis.run(batches))
    finally:
        for n, fn in real.items():
            setattr(infer_mod, n, fn)
    lines.append(line)
    drawn = sorted((ART_DIR / "vis" / "visualizations").glob("*.png"))
    sheets = sorted((ART_DIR / "vis" / "uncert").rglob("contact_sheet.png"))
    copies = [p for p in (ART_DIR / "vis" / "uncert").rglob("*.png") if p not in sheets]
    images_with_rows = {r["image_name"] for r in rows}
    t0 = time.perf_counter()
    for p in drawn + copies:
        if decode_image(p.read_bytes()).shape != (*native, 3):
            raise AssertionError(f"{p.name}: not a {native} RGB overlay")
    for p in sheets:
        n = len([q for q in p.parent.glob("*.png") if q != p])
        cols = min(5, n)
        want = (-(-n // cols) * 180, cols * 320, 3)
        if decode_image(p.read_bytes()).shape != want:
            raise AssertionError(f"{p.relative_to(ART_DIR)}: shape, want {want} for {n} images")
    read_s = time.perf_counter() - t0
    if len(drawn) != 5 * len(images_with_rows) or not drawn or len(sheets) != 8 or not copies:
        raise AssertionError(f"InferImages(save_visualizations=True): {len(drawn)} overlays and "
                             f"panels for {len(images_with_rows)} images with detections (want "
                             f"5 each), {len(sheets)} contact sheets (want 8), {len(copies)} "
                             f"bucket copies")
    draw_s = watch.seconds.get("overlay_panels", 0.0) + watch.seconds.get("contact_sheet", 0.0)
    png_s = watch.seconds.get("write_png", 0.0)
    back_s = watch.seconds.get("decode_image", 0.0)
    per = 1e3 / ART_BATCHES
    lines.append(
        f"artifacts: {len(drawn)} overlay/panel PNGs of {native[0]}x{native[1]}, {len(copies)} "
        f"bucket copies, {len(sheets)} contact sheets, all read back with the port's decoder "
        f"({read_s:.2f} s); ms a batch of {BATCH}: {vis_s * per:.1f} with the artifacts = serve "
        f"{vis_serve * per:.1f} + drawing {draw_s * per:.1f} + PNG writing {png_s * per:.1f} + "
        f"buckets' read-back {back_s * per:.1f} + other host "
        f"{(vis_s - vis_serve - draw_s - png_s - back_s) * per:.1f}; without them "
        f"{plain_s * per:.1f} = serve {plain_serve * per:.1f} + host "
        f"{(plain_s - plain_serve) * per:.1f}; {smi}")

    validator = Validator(server, str(ART_DIR / "val"))
    vrows, line, _, _ = measured("Validator", lambda: validator.run(batches))
    lines.append(line)
    t0 = time.perf_counter()
    res = export_quadrant_crops(vrows, frames.get, str(ART_DIR / "crops"))
    crops_s = time.perf_counter() - t0
    n_crops = sum(res["crop_counts"].values())
    crop_files = sorted((ART_DIR / "crops").rglob("*.png"))
    if n_crops == 0 or len(crop_files) != n_crops or \
            any(decode_image(p.read_bytes()).ndim != 3 for p in crop_files):
        raise AssertionError(f"export_quadrant_crops: {n_crops} crops counted, "
                             f"{len(crop_files)} files")
    t0 = time.perf_counter()
    n_gt = plot_tfrecord_groundtruth(val, str(ART_DIR / "gt"), get_label_map("kitti"), GT_FRAMES)
    gt_s = time.perf_counter() - t0
    gt_files = sorted((ART_DIR / "gt").glob("*.png"))
    if n_gt != GT_FRAMES or len(gt_files) != GT_FRAMES or \
            any(decode_image(p.read_bytes()).shape != (*native, 3) for p in gt_files):
        raise AssertionError(f"plot_tfrecord_groundtruth: {n_gt} frames, {len(gt_files)} files")
    lines.append(f"export_quadrant_crops over {len(vrows)} Validator rows: {n_crops} crops in "
                 f"{crops_s * 1e3:.1f} ms, quality-epistemic correlation "
                 f"{res['quality_epistemic_corr']:.4f}; plot_tfrecord_groundtruth: {n_gt} "
                 f"frames in {gt_s * 1e3:.1f} ms ({gt_s / n_gt * 1e3:.1f} ms a frame)")

    images, labels = batches[0]
    LAUNCHES.stop()         # one trace at a time
    with profiling.trace(str(ART_DIR / "trace")):
        for _ in range(2):
            serve_reader_batch(server, images, labels)
        sync(dev)
    traces = sorted((ART_DIR / "trace").glob("trace_*.json"))
    if len(traces) != 1:
        raise AssertionError(f"profiling.trace: {len(traces)} trace files")
    events = json.loads(traces[0].read_text())["traceEvents"]
    launched = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    # the launches counted in the trace written, by profiling.KERNELS' names
    by_wrapper = {w: sum(1 for n in launched if any(re.search(rf"\b{k}\b", n) for k in names))
                  for w, names in profiling.KERNELS.items()}
    launches = tuple(by_wrapper[w] for w in ("fused_dw", "fused_expand_dw", "soft_nms"))
    sepconv = 2 * sepconv_per_forward(cfg) if torch.device(dev).type == "cuda" else 0
    if launches != per_serve(2) or by_wrapper["fused_sepconv"] != sepconv:
        raise AssertionError(f"profiling.trace: launches {launches}, fused_sepconv "
                             f"{by_wrapper['fused_sepconv']} in 2 serves (want {sepconv})")
    kernels = set(launched)
    found = {k: sum(k in name for name in kernels) for k in ("soft_nms", "fused_dw", "expand_dw")}
    if torch.device(dev).type == "cuda" and not all(found.values()):
        raise AssertionError(f"profiling.trace: kernels named {found} in {len(kernels)} kernel "
                             f"names")
    lines.append(f"profiling.trace of 2 serves: {traces[0].stat().st_size / 1e6:.2f} MB, "
                 f"{len(events)} events, {len(kernels)} kernel names, of them {found}; "
                 f"device_memory_stats {profiling.device_memory_stats()}")
    for line in lines:
        phase(12, line)
    phase(12, f"KITTI ({path}) d0 {h}x{w}, head-only MC T={cfg.mc_dropoutsamp}, bf16, batch "
              f"{BATCH}, native {native[0]}x{native[1]} frames (layout written in "
              f"{write_s:.1f} s); phase {time.perf_counter() - t_phase:.1f} s; {smi}")
    del server
    shutil.rmtree(ART_DIR, ignore_errors=True)
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def random_state_dict(cfg):
    """Random weights of ``cfg``'s model, drawn as flax's initializers draw
    them from seed 0."""
    model = EfficientDetNet(cfg)
    init_flax_style(model, torch.Generator().manual_seed(0))
    return model.state_dict()


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def check_callback_launches(calls):
    """Each COCO callback call launched (fused_dw, fused_expand_dw,
    soft_nms) 1/15/1 times a validation batch, plus the NMS grid's one
    forward of its probe image (1/15/0) and its 9 post-processings
    (0/0/9), the depthwise on its fast path every time."""
    for seconds, launches, fast, batches, *_ in calls:
        want = (batches + 1, 15 * (batches + 1), batches + 9)
        if launches != want or fast != batches + 1:
            raise AssertionError(f"COCO callback: launches {launches} (fast path {fast}) over "
                                 f"{batches} validation batches and the NMS grid, want {want}")


def check_serve_launches(what, launches, batches):
    """An app's serves over ``batches`` batches: 1/15/1 launches a batch."""
    if launches != (batches, 15 * batches, batches):
        raise AssertionError(f"{what}: launches {launches} over {batches} batches, want "
                             f"1/15/1 a batch")


# -- phase 13: multi-GPU (the port over torch.distributed) ---------------------

PARALLEL_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_parallel"
POOL = 16                       # serve_sharded's pool: two batches of BATCH
# the step comparisons' tolerances (loss: relative; update: the parameters'
# change, relative L2 over the tree), every step with cuDNN's deterministic
# algorithms: (a) a world of one against the single process, both bf16;
# (b) in f32 (TF32 off) two ranks of 4 rows, and the tensor-parallel pair,
# against the single process (loss: JAX's own TP-vs-DP tolerance,
# tests/test_tensor_parallel.py; update: the gradient tolerance of
# tests/test_torch_train_step.py); (b) in bf16, the configuration's own
# precision, against (a)'s step: a rank's 4 rows and the channel slices round
# otherwise than the whole batch does, as reordering the batch's rows (each
# keeping its masks) does, and phase 13 (a) prints how far that moves the
# step. On the H100 the reordered bf16 step's loss moved 0.0611 and its
# update 1.38 relative L2 (f32: 8.2e-6 and 1.0e-3): two clipped bf16 updates
# of these random weights are as far apart as unrelated ones of equal norm
# (sqrt 2), so in bf16 only the loss is held, within 0.15 (above every
# reading, PERF.md phase 13), and the update is printed
STEP_TOL_A = dict(loss=1e-6, update=1e-5)
STEP_TOL_B = dict(loss=2e-3, update=1e-2)
STEP_TOL_BF16 = dict(loss=0.15, update=None)
# serve_sample_parallel's per-sample maps against serve's single T-sample forward
# (the largest difference over the largest magnitude): the two differ only in
# the batch of samples a convolution sees (readings in PERF.md, phase 13)
WHOLE_TOL = 2.0 ** -8


def kitti_train_config(extra=None):
    """Phase 8's configuration: KITTI's training hparams at the runner's batch."""
    cfg = get_detection_config("efficientdet-d0").override(KITTI_TRAIN[1])
    cfg.override(dict(KITTI_RUNNER[1], **(extra or {})), allow_new_keys=True)
    cfg.override(dict(num_epochs=TRAIN_EPOCHS, save_freq=1))
    return cfg


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class PermutedDropout:
    """A mask source whose draws follow a reordering of the batch's rows:
    row i of a draw is row ``perm[i]`` of the plain source's, so every
    image of a reordered batch keeps its own masks."""

    def __init__(self, source, perm):
        self.source, self.perm = source, torch.as_tensor(perm)

    def draw(self, n, c, keep, device):
        return self.source.draw(n, c, keep, device)[self.perm.to(device)]


@contextlib.contextmanager
def timed_collectives(dev):
    """Count and time every ``torch.distributed`` all_reduce, all_gather
    and broadcast inside (the port's three collectives), each call between
    two synchronisations of ``dev``: yields {"calls", "ms", "bytes"}, filled
    as the calls come."""
    import torch.distributed as dist

    stats = {"calls": 0, "ms": 0.0, "bytes": 0}
    saved = {name: getattr(dist, name) for name in ("all_reduce", "all_gather", "broadcast")}

    def wrap(name, fn):
        def call(*args, **kwargs):
            t = kwargs.get("tensor", args[1] if name == "all_gather" else args[0])
            sync(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(dev)
            stats["calls"] += 1
            stats["ms"] += (time.perf_counter() - t0) * 1e3
            stats["bytes"] += t.numel() * t.element_size()
            return out
        return call

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield stats
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def parallel_step(cfg, dev, batch, mesh=None, tensor_parallel=False, perm=None,
                  collectives=None):
    """One training step from the weights of seed 0 (the single process's
    without ``mesh``; a data- or tensor-parallel rank's, on its rows of the
    batch, with it), the batch's rows reordered by ``perm`` with their
    masks: (the global values, the whole parameters after it on the host,
    ms to a synchronisation, this rank's parameter + optimizer-state
    bytes). A ``collectives`` dict gets the step's collectives counted and
    timed (``timed_collectives``)."""
    from udal_tpu_torch.parallel.mesh import replicate_state, shard_batch, shard_state_tp

    state, schedule = train_lib.create_train_state(cfg, TRAIN_STEPS,
                                                   torch.Generator().manual_seed(0), dev)
    images, labels = batch
    if perm is not None:
        images, labels = images[perm], {k: v[perm] for k, v in labels.items()}
    if mesh is not None:
        (shard_state_tp if tensor_parallel else replicate_state)(mesh, state)
        rows = shard_batch(mesh, {"images": images, **labels})
        images, labels = rows.pop("images"), rows
    dropout = train_lib.ChannelDropout
    if perm is not None:
        train_lib.ChannelDropout = lambda generator: PermutedDropout(dropout(generator), perm)
    sync(dev)
    t0 = time.perf_counter()
    try:
        with (timed_collectives(dev) if collectives is not None
              else contextlib.nullcontext({})) as stats:
            state, vals = train_lib.train_step(cfg, schedule, TRAIN_STEPS, state, images,
                                               labels)
    finally:
        train_lib.ChannelDropout = dropout
    sync(dev)
    if collectives is not None:
        collectives.update(stats)
    ms = (time.perf_counter() - t0) * 1e3
    own = list(state.model.parameters()) + [v for s in state.optimizer.state.values()
                                            for v in s.values() if torch.is_tensor(v)]
    nbytes = sum(t.numel() * t.element_size() for t in own)
    with state.tp.gathered(state) if state.tp is not None else contextlib.nullcontext():
        params = {n: p.detach().float().cpu() for n, p in state.model.named_parameters()}
    return {k: float(v) for k, v in vals.items()}, params, ms, nbytes


def step_difference(got, want, init):
    """(the loss's relative difference, the update's relative L2 difference
    over the tree) of two steps from the same ``init`` parameters."""
    loss = abs(got[0]["loss"] - want[0]["loss"]) / abs(want[0]["loss"])
    num = sum(float(((got[1][n] - want[1][n]) ** 2).sum()) for n in want[1])
    den = sum(float(((want[1][n] - init[n]) ** 2).sum()) for n in want[1])
    return loss, (num / den) ** 0.5


def timed_serves(fn, dev):
    """``SERVE_CALLS`` calls of ``fn``, each ending in a synchronisation,
    then ``SERVE_CALLS`` more in a trace of the card: (the last output, ms
    per call from the median of calls 2 to SERVE_CALLS, the first call's
    ms, the traced calls' launches)."""
    walls = []
    for _ in range(SERVE_CALLS):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        walls.append(time.perf_counter() - t0)
    out, launches = traced_calls(fn)
    return out, statistics.median(walls[1:]) * 1e3, walls[0] * 1e3, launches


def check_step(what, diff, tol):
    """Hold a step's (loss, update) differences to ``tol``; an update
    tolerance of None prints the update's difference and holds nothing."""
    loss, update = diff
    if not (loss <= tol["loss"] and (tol["update"] is None or update <= tol["update"])):
        raise AssertionError(f"{what}: loss {loss:.3g} (tolerance {tol['loss']}), update "
                             f"{update:.3g} relative L2 (tolerance {tol['update']})")
    held = f"tolerance {tol['update']}" if tol["update"] is not None else "not held"
    return (f"loss within {loss:.3g} (tolerance {tol['loss']}), update {update:.3g} "
            f"relative L2 away ({held})")


def gloo_cuda_collectives(dev):
    """Which of the port's three collectives the gloo backend runs on a
    CUDA tensor (each rank calls them in one order): {name: True, or the
    refusal's first line}; then each through the port's wrapper, checked
    (``parallel/collectives.py`` relies on gloo taking all three)."""
    import torch.distributed as dist

    from udal_tpu_torch.parallel import collectives

    rank, out = dist.get_rank(), {}
    for name, call in (("all_reduce", lambda t: dist.all_reduce(t)),
                       ("broadcast", lambda t: dist.broadcast(t, 0)),
                       ("all_gather", lambda t: dist.all_gather(
                           [torch.empty_like(t) for _ in range(2)], t))):
        try:
            call(torch.full((4,), float(rank + 1), device=dev))
            sync(dev)
            out[name] = True
        except RuntimeError as e:
            out[name] = str(e).splitlines()[0][:120]
    t = torch.full((4,), float(rank + 1), device=dev)
    if float(collectives.all_reduce(t, dist.group.WORLD)[0]) != 3.0:
        raise AssertionError(f"all_reduce over gloo on {dev}: {t.tolist()}")
    g = collectives.all_gather(torch.full((2,), float(rank), device=dev), dist.group.WORLD)
    if g.tolist() != [0.0, 0.0, 1.0, 1.0]:
        raise AssertionError(f"all_gather over gloo on {dev}: {g.tolist()}")
    b = collectives.broadcast(torch.full((2,), float(rank + 5), device=dev), 0)
    if b.tolist() != [5.0, 5.0]:
        raise AssertionError(f"broadcast over gloo on {dev}: {b.tolist()}")
    return out


def phase13_rank(rank, info, dev_name, extra, batch, raw):
    """One of phase 13 (b)'s two processes on the card (gloo): the
    collectives gloo takes, a data-parallel step at world 2 and a
    tensor-parallel step at n_model 2, each in bf16 and in f32, then each
    bf16 step again with its collectives counted and timed, and
    serve_sample_parallel with T / 2 samples a rank with its launches;
    written to PARALLEL_DIR."""
    from udal_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device(dev_name)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cudnn.deterministic = True
    out = {"gloo_cuda": gloo_cuda_collectives(dev) if dev.type == "cuda" else {}}
    cfg16 = kitti_train_config(extra)
    cfg32 = kitti_train_config(dict(extra or {}, mixed_precision=False))
    dp_mesh, tp_mesh = make_mesh(device=dev), make_mesh(n_model=2, device=dev)
    for key, cfg in (("", cfg16), ("32", cfg32)):
        out["dp" + key] = parallel_step(cfg, dev, batch, dp_mesh)
        out["tp" + key] = parallel_step(cfg, dev, batch, tp_mesh, tensor_parallel=True)
    for key, mesh in (("dp", dp_mesh), ("tp", tp_mesh)):
        stats = {}
        step_ms = parallel_step(cfg16, dev, batch, mesh, tensor_parallel=key == "tp",
                                collectives=stats)[2]
        out[key + "_collectives"] = dict(stats, step_ms=step_ms)
    server = ServingDriver.create("efficientdet-d0", overrides={**MAIN_PATH, **(extra or {})},
                                  seed=0, device=dev)
    mesh = make_mesh(device=dev)
    server.serve_sample_parallel(mesh, raw)            # warm
    reset_counts()
    sync(dev)
    t0 = time.perf_counter()
    packed_out = server.serve_sample_parallel(mesh, raw)
    sync(dev)
    out["sample"] = ([t.cpu() for t in packed_out], (time.perf_counter() - t0) * 1e3, counts())
    torch.save(out, PARALLEL_DIR / f"rank{rank}.pt")


def split_sample_reference(extra, dev, raw, ranks=2):
    """What ``ranks`` ranks' ``serve_sample_parallel`` (each after one
    warm-up call) computes, in this process: rank r's share of the samples
    from a fresh driver warmed by one ``serve``, at the rank's batch of
    T/ranks samples (the convolutions' rounding follows the batch), the
    sample maps joined and post-processed once. Returns (its packed tuple,
    the joined maps: class and box outputs, lists of [T, B, H, W, C])."""
    from udal_tpu_torch.models.efficientnet import ShardedDropout
    from udal_tpu_torch.ops.postprocess import postprocess_global

    outs = []
    for r in range(ranks):
        d = ServingDriver.create("efficientdet-d0", overrides={**MAIN_PATH, **(extra or {})},
                                 seed=0, device=dev)
        d.serve(raw)
        with torch.inference_mode():
            images, scales = d._raw(raw)
            outs.append(d._forward(images.to(d.dtype), ShardedDropout(d.masks, r, ranks),
                                   samples=d.config.mc_dropoutsamp // ranks))
    cls, box = ([torch.cat([o[j][level] for o in outs]) for level in range(len(outs[0][j]))]
                for j in (0, 1))
    with torch.inference_mode():
        return (postprocess_global(d.config, cls, box, image_scales=scales).packed(),
                (cls, box))


def maps_difference(a, b, shift=0):
    """The largest differences of two MC forwards' per-sample class and box
    maps (lists of [T, B, H, W, C]), each over the largest magnitude of
    ``b``'s; ``shift`` rolls ``a``'s samples first (a shift of T/2 pairs
    each sample with the one a rank taking the wrong block would draw)."""
    return tuple(max(float((x.float().roll(shift, 0) - y.float()).abs().max()) for x, y in
                     zip(a[j], b[j])) / max(float(y.float().abs().max()) for y in b[j])
                 for j in (0, 1))


def phase13(dev, smi, ms_serve, ms_step, extra=None, pool=POOL):
    """Multi-GPU: the port over torch.distributed, on the one card.

    (a) a world of one over NCCL (a TCP store on 127.0.0.1; every
    collective a real NCCL call): one data-parallel step at phase 8's
    operating point against the single process's step from the same
    weights and batch; ``serve_sharded`` of ``pool`` images at the main
    path's operating point against two ``serve`` calls (matched sets,
    1/15/1 launches a batch); ``serve_sample_parallel`` at T = 10 against
    ``serve`` under the same masks; how far reordering the batch's rows
    (each keeping its masks) moves the single process's step, in bf16 and
    in f32. (b) two spawned processes sharing the card over gloo (NCCL
    refuses two ranks on one device): the collectives gloo takes on CUDA
    tensors, a data-parallel step at world 2 (4 rows a rank) and a
    tensor-parallel step at n_model 2, in bf16 against (a)'s step and in
    f32 against the single process's f32 step, each step's collectives
    counted and timed, each rank's parameter + optimizer-state bytes, and
    serve_sample_parallel with 5 samples a rank against the same samples
    served in one process, whose per-sample maps are held against
    ``serve``'s T-sample forward, every rank launching B1/B2/B3. ``extra``
    adds hparams (a CPU rehearsal's small size)."""
    import torch.distributed as dist

    from udal_tpu_torch.parallel.dryrun import free_port, spawn_world
    from udal_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    t_phase = time.perf_counter()
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    PARALLEL_DIR.mkdir(parents=True)
    cfg = kitti_train_config(extra)
    h, w = parse_image_size(cfg.image_size)
    batch = synthetic_batch(np.random.RandomState(13), cfg.batch_size, h, w, cfg.num_classes)
    raw = np.random.RandomState(1).randint(0, 256, (BATCH, h, w, 3)).astype(np.uint8)
    t = {**MAIN_PATH, **(extra or {})}["mc_dropoutsamp"]
    cfg32 = kitti_train_config(dict(extra or {}, mixed_precision=False))
    perm = np.r_[cfg.batch_size // 2:cfg.batch_size, 0:cfg.batch_size // 2]
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        single = parallel_step(cfg, dev, batch)
        again = parallel_step(cfg, dev, batch)
        reordered = parallel_step(cfg, dev, batch, perm=perm)
        single32 = parallel_step(cfg32, dev, batch)
        reordered32 = parallel_step(cfg32, dev, batch, perm=perm)
        init = {n: p.detach().float().cpu() for n, p in train_lib.create_train_state(
            cfg, TRAIN_STEPS, torch.Generator().manual_seed(0), "cpu")[0].model.named_parameters()}
        info = initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
        backend = dist.get_backend()
        mesh = make_mesh(device=dev)
        world1 = parallel_step(cfg, dev, batch, mesh)
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    repeat = check_step("phase 13 (a) single process twice", step_difference(again, single, init),
                        STEP_TOL_A)
    line = check_step("phase 13 (a) data-parallel step at a world of one",
                      step_difference(world1, single, init), STEP_TOL_A)
    moved = step_difference(reordered, single, init)
    moved32 = step_difference(reordered32, single32, init)
    phase(13, f"(a) world of one over {backend} ({info}): data-parallel train_step at phase 8's "
              f"operating point (d0 {h}x{w}, batch {cfg.batch_size}, bf16, KITTI MC + loss "
              f"attenuation) vs the single process from the same weights and batch, cuDNN "
              f"deterministic: {line} (single process twice: {repeat}); {world1[2]:.1f} ms "
              f"(single process {again[2]:.1f} ms, its first call {single[2]:.1f} ms; phase 8: "
              f"{ms_step:.1f} ms/step). The single process's step on the batch's rows "
              f"reordered, each image keeping its masks: bf16 loss {moved[0]:.3g}, update "
              f"{moved[1]:.3g} relative L2 away; f32 (TF32 off) loss {moved32[0]:.3g}, update "
              f"{moved32[1]:.3g} away; the f32 step, (b)'s f32 reference: "
              f"{single32[2]:.1f} ms, loss {single32[0]['loss']:.4f}; {smi}")

    server = ServingDriver.create("efficientdet-d0", overrides={**MAIN_PATH, **(extra or {})},
                                  batch_size=BATCH, seed=0, device=dev)
    images = np.random.RandomState(2).randint(0, 256, (pool, h, w, 3)).astype(np.uint8)
    got, ms_sharded, first, launches = timed_serves(lambda: server.serve_sharded(mesh, images),
                                                    dev)
    calls = SERVE_CALLS * pool // BATCH
    if dev.type == "cuda" and launches != (calls, 15 * calls, calls):
        raise AssertionError(f"serve_sharded: launches {launches} in {SERVE_CALLS} calls of "
                             f"{pool // BATCH} batches, want 1/15/1 a batch")
    ref = ServingDriver.create("efficientdet-d0", overrides={**MAIN_PATH, **(extra or {})},
                               batch_size=BATCH, seed=0, device=dev)
    for _ in range(2 * SERVE_CALLS - 1):    # the same place in the mask sequence
        for i in range(0, pool, BATCH):
            ref.serve(images[i:i + BATCH])
    want = [torch.cat(ts) for ts in zip(*(ref.serve(images[i:i + BATCH])
                                          for i in range(0, pool, BATCH)))]
    worst = matched_sets(got[:4], want[:4], "serve_sharded vs serve")
    phase(13, f"(a) serve_sharded of {pool} images [{pool}, {h}, {w}, 3] at the main path's "
              f"operating point (T=10, batch {BATCH}, bf16) = {pool // BATCH} serve calls as "
              f"matched sets (largest score difference {worst:.3g}); launches in {SERVE_CALLS} "
              f"calls {launches} (1/15/1 a batch); {ms_sharded:.1f} ms a call, "
              f"{ms_sharded * BATCH / pool:.1f} ms a batch (phase 4: {ms_serve:.1f} ms/batch); "
              f"first {first:.0f} ms; {smi}")

    sp_server, single_server = (ServingDriver.create(
        "efficientdet-d0", overrides={**MAIN_PATH, **(extra or {})}, seed=0, device=dev)
        for _ in range(2))
    got, ms_sp, _, launches = timed_serves(lambda: sp_server.serve_sample_parallel(mesh, raw),
                                           dev)
    for _ in range(2 * SERVE_CALLS):        # as many calls as timed_serves made
        want = single_server.serve(raw)
    worst = matched_sets(got[:4], want[:4], "serve_sample_parallel vs serve")
    if dev.type == "cuda" and launches != per_serve(SERVE_CALLS):
        raise AssertionError(f"serve_sample_parallel: launches {launches}, want 1/15/1 a call")
    phase(13, f"(a) serve_sample_parallel T={t} on a world of one = serve under the same masks "
              f"(largest score difference {worst:.3g}); launches {launches}; {ms_sp:.1f} ms "
              f"a call (phase 4's serve: {ms_serve:.1f} ms); {smi}")
    dist.destroy_process_group()
    del server, ref, sp_server, single_server, got, want
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (b) two processes on the card over gloo
    t0 = time.perf_counter()
    spawn_world(phase13_rank, 2, str(dev), extra, batch, raw, device=str(dev), backend="gloo")
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(PARALLEL_DIR / f"rank{r}.pt", weights_only=False) for r in range(2)]
    want = None
    for r, out in enumerate(ranks):
        dp = check_step(f"phase 13 (b) rank {r} bf16 data-parallel step at world 2 vs (a)",
                        step_difference(out["dp"], single, init), STEP_TOL_BF16)
        tp = check_step(f"phase 13 (b) rank {r} bf16 tensor-parallel step vs (a)",
                        step_difference(out["tp"], single, init), STEP_TOL_BF16)
        tp_dp = check_step(f"phase 13 (b) rank {r} bf16 tensor- vs data-parallel",
                           step_difference(out["tp"], out["dp"], init), STEP_TOL_BF16)
        dp32 = check_step(f"phase 13 (b) rank {r} f32 data-parallel step at world 2",
                          step_difference(out["dp32"], single32, init), STEP_TOL_B)
        tp32 = check_step(f"phase 13 (b) rank {r} f32 tensor-parallel step at n_model 2",
                          step_difference(out["tp32"], single32, init), STEP_TOL_B)
        tp_dp32 = check_step(f"phase 13 (b) rank {r} f32 tensor- vs data-parallel",
                             step_difference(out["tp32"], out["dp32"], init), STEP_TOL_B)
        calls = "; ".join(
            f"{key} step {c['step_ms']:.1f} ms with each collective synchronised, of which "
            f"{c['calls']} collectives {c['ms']:.1f} ms ({c['ms'] / c['calls']:.3f} ms a call, "
            f"{c['bytes'] / 2**20:.1f} MiB)"
            for key, c in (("data-parallel", out["dp_collectives"]),
                           ("tensor-parallel", out["tp_collectives"])))
        phase(13, f"(b) rank {r} of 2 over gloo on {dev} (gloo's own collectives on CUDA "
                  f"tensors: {out['gloo_cuda'] or 'n/a on the CPU'}): bf16 data-parallel step, "
                  f"4 rows a rank, vs (a)'s step: {dp}, {out['dp'][2]:.1f} ms; bf16 "
                  f"tensor-parallel step (n_model 2) vs (a)'s: {tp}, vs the data-parallel "
                  f"step: {tp_dp}, {out['tp'][2]:.1f} ms; in f32 vs the single process's f32 "
                  f"step: data-parallel {dp32}, {out['dp32'][2]:.1f} ms; tensor-parallel "
                  f"{tp32}, vs data-parallel {tp_dp32}, {out['tp32'][2]:.1f} ms; {calls}; "
                  f"parameter + optimizer-state bytes a rank (bf16 steps): "
                  f"tensor-parallel {out['tp'][3] / 2**20:.1f} MiB, data-parallel "
                  f"{out['dp'][3] / 2**20:.1f} MiB ({out['tp'][3] / out['dp'][3]:.1%}); {smi}")
        if not out["tp"][3] < 0.75 * out["dp"][3]:
            raise AssertionError(f"rank {r}: tensor-parallel state {out['tp'][3]} bytes, "
                                 f"data-parallel {out['dp'][3]}")
        packed_r, ms_r, launches = out["sample"]
        if want is None:
            want, split_maps = split_sample_reference(extra, dev, raw)
            ref = ServingDriver.create("efficientdet-d0", overrides={**MAIN_PATH, **(extra or {})},
                                       seed=0, device=dev)
            ref.serve(raw)                   # the rank's warm-up serve came first
            with torch.inference_mode():
                images, scales = ref._raw(raw)
                whole = ref._forward(images.to(ref.dtype))
            whole_diff = maps_difference(split_maps, whole)
            wrong_diff = maps_difference(split_maps, whole, t // 2)
            del ref, whole, split_maps
            if max(whole_diff) > WHOLE_TOL or max(wrong_diff) <= WHOLE_TOL:
                raise AssertionError(f"the split samples' maps differ from serve's T={t} "
                                     f"forward by {whole_diff} of their largest (tolerance "
                                     f"{WHOLE_TOL:.3g}); a wrong block of samples would "
                                     f"differ by {wrong_diff}, which must exceed it")
        worst = matched_sets(packed_r[:4], want[:4],
                             f"rank {r} serve_sample_parallel vs the split samples in one process")
        if dev.type == "cuda" and launches != (1, 15, 1):
            raise AssertionError(f"rank {r}: serve_sample_parallel launches {launches}, "
                                 f"want 1/15/1")
        phase(13, f"(b) rank {r} serve_sample_parallel, {t // 2} of T={t} samples a rank = the "
                  f"same samples ({t // 2} a forward, as on the ranks) served in one process, "
                  f"as matched sets (largest score difference {worst:.3g}); against serve's "
                  f"single T={t} forward, under the masks of one plain mask source, the per-sample maps "
                  f"differ by {whole_diff[0]:.3g} (class) and {whole_diff[1]:.3g} (box) of "
                  f"their largest (tolerance {WHOLE_TOL:.3g}; the other rank's block of "
                  f"samples would differ by {wrong_diff[0]:.3g} and {wrong_diff[1]:.3g}); "
                  f"launches {launches}; {ms_r:.1f} ms; {smi}")
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    phase(13, f"(b) two processes spawned and joined in {spawn_s:.1f} s; phase 13 took "
              f"{time.perf_counter() - t_phase:.1f} s")


def main():
    start = time.perf_counter()
    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() "
                           "is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    phase(1, f"device {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build(SOURCES)
    phase(2, f"built csrc/{{{','.join(SOURCES)}}}.cu in {time.perf_counter() - t0:.2f} s "
             f"(one nvcc each, in parallel)")
    for name in SOURCES:
        spilled = ptxas_summary(name)
        if spilled and name in ("soft_nms", "fused_dw"):
            raise AssertionError(f"csrc/{name}.cu: {spilled} spill registers")
    for name in ("packed_pointwise", "fused_expand_dw", "fused_sepconv"):
        mma = tensor_core_instructions(name)
        phase(2, f"{name}: {mma} tensor-core instructions (HMMA/HGMMA) in its SASS")
        if mma == 0:
            raise AssertionError(f"{name}'s library holds no tensor-core instruction")

    # -- 3. kernels vs plain ---------------------------------------------------
    rng = np.random.RandomState(0)
    max_err, times, picks = check_soft_nms(dev, rng, smi)
    max_err = max(max_err, check_per_class_nms(dev, rng, smi))
    f32_err = check_fused_f32(dev, rng)
    bf16_err, fused_times = check_fused_bf16(dev, rng, smi)
    torch.cuda.empty_cache()
    sepconv_err, sepconv_times = check_fused_sepconv(dev, smi)
    time_expand_blocks(dev, rng, smi)
    torch.cuda.empty_cache()

    # -- 4. the slice at full width -------------------------------------------
    server = ServingDriver.create("efficientdet-d0", overrides=MAIN_PATH,
                                  seed=0, device=dev)
    raw = np.random.RandomState(1).randint(0, 256, (BATCH, 512, 1024, 3)).astype(np.uint8)
    out, ms, first, launches, peak = timed_calls(lambda: server.serve(raw))
    if launches != (SERVE_CALLS, 15 * SERVE_CALLS, SERVE_CALLS):
        raise AssertionError(f"(fused_dw, fused_expand_dw, soft_nms) launches {launches} in "
                             f"{SERVE_CALLS} traced serve calls; want 1, 15 and 1 a call")
    if fast_launches() != SERVE_CALLS:
        raise AssertionError(f"fused_dw fast path {fast_launches()} in {SERVE_CALLS} serve "
                             f"calls; the MC prefix must take the fast path")
    serve_sepconv = sepconv_launches()
    if serve_sepconv != SERVE_CALLS * sepconv_per_forward(server.config) or \
            resident_launches() != 0:
        raise AssertionError(f"fused_sepconv {serve_sepconv} in {SERVE_CALLS} serve calls, "
                             f"{resident_launches()} resident; want "
                             f"{sepconv_per_forward(server.config)} a call, none resident")
    shapes = [tuple(t.shape) for t in out]
    if shapes != [(BATCH, K, 12), (BATCH, K), (BATCH, K, 9), (BATCH,)]:
        raise AssertionError(f"packed shapes {shapes}")
    if not all(bool(torch.isfinite(t.float()).all()) for t in out):
        raise AssertionError("non-finite detections")
    if int(out[3].max()) <= 0:
        raise AssertionError("no detections at full width")
    ms_serve = ms
    phase(4, f"d0 1024x512 T=10 B={BATCH} bf16: packed {shapes}, valid_len "
             f"{out[3].tolist()}; launches on the card in {SERVE_CALLS} traced calls after "
             f"the timed ones: fused_dw {launches[0]} (fast path {fast_launches()}), "
             f"fused_expand_dw {launches[1]}, soft_nms {launches[2]}, fused_sepconv "
             f"{serve_sepconv}; model step calls "
             f"{server.graph_stats} (CUDA graphs); {ms:.1f} ms/batch "
             f"({BATCH / ms * 1e3:.1f} img/s, median of calls 2-{SERVE_CALLS}, first "
             f"{first:.0f} ms), peak {peak:.2f} "
             f"GiB (unfused eager serve on this card model: 91.4 ms/batch, 4.73 GiB); {smi}")
    if "--profile" in sys.argv[1:]:
        profile_calls("phase 4 serve", lambda: server.serve(raw), ms)
    del server, out
    torch.cuda.empty_cache()

    # -- 5. device parity: CPU (plain versions) vs card (kernels), f32 -------
    phase5(dev)

    # -- 6. the packed-layout microbench ---------------------------------------
    t0 = time.perf_counter()
    packed_err = perf_packed.main(["check"])
    phase(6, f"perf_packed check: the script's references and every kernel against its "
             f"plain version at the tool's shapes passed, max abs err {packed_err} "
             f"({time.perf_counter() - t0:.1f} s)")
    reset_counts(trace=False)      # the tool traces the card itself; its wrappers count
    bench_rows = perf_packed.main(list(perf_packed.CASES))
    bench = {r["case"]: r["graph_ms"] for r in bench_rows}
    conv_kernels = next(r["cuda_kernels"] for r in bench_rows if "cuda_kernels" in r)
    calls = perf_packed.WARMUP + perf_packed.RUNS + 1
    want = {name: calls for name in packed.launches}
    want["packed_pointwise"] = calls * (1 + len(perf_packed.M_TILES))
    if packed.launches != want:
        raise AssertionError(f"packed launches {packed.launches} in the timed cases; want {want}")
    packed_launches = dict(packed.launches)
    sweep = ", ".join(f"m_tile {mt} {bench[f'packed_pw_mt{mt}']:.4f}" for mt in perf_packed.M_TILES)
    phase(6, f"perf_packed timed cases, launches {packed.launches}; packed_pointwise "
             f"{bench['packed_pw_128x256x24to144']:.4f} ms, plain "
             f"{bench['plain_pw_128x256x24to144']:.4f} ms, cuDNN 1x1 conv "
             f"{bench['conv_pw_128x256x24to144']:.4f} ms, cuBLAS bf16 matmul on the same "
             f"operands {bench['matmul_pw_128x256x24to144']:.4f} ms (a2's "
             f"{bench['packed_pw_torch_matmul_bf16out']:.4f}); {sweep} (medians of "
             f"{perf_packed.RUNS} CUDA-graph replays); {smi}")
    phase(6, f"library calls beside B5 and B8: packed_wshift "
             f"{bench['packed_wshift_128x32x1152']:.4f} ms vs F.pad of the unpacked view "
             f"{bench['pad_packed_wshift_128x32x1152']:.4f} ms; packed_dw_w3 "
             f"{bench['p2_packed_dwW_128x32x1152']:.4f} ms vs the depthwise F.conv2d (groups=C, "
             f"channels-last, contiguous weight, cuDNN benchmark mode) "
             f"{bench['conv_p2_packed_dwW_128x32x1152']:.4f} ms, launching {conv_kernels} "
             f"(CUDA-graph replay medians); {smi}")
    rounds = perf_packed.p1_rounds(dev)
    p1 = {case: statistics.median(ms) for case, ms in rounds.items()}
    p1_bytes = 4096 * perf_packed.N // 8 * perf_packed.G * perf_packed.CI * 2
    p1_bound = bound(2 * p1_bytes, f32_flops=p1_bytes / 2)[0]
    phase(6, f"p1 streamed from HBM (graphs of {perf_packed.P1_COPIES} calls on as many "
          f"copies of x, outputs kept) in {perf_packed.P1_ROUNDS} rounds of {perf_packed.RUNS} "
          "replays, ms a call, median of the round medians [min, max]: " + ", ".join(
              f"{case} {p1[case]:.4f} [{min(ms):.4f}, {max(ms):.4f}]"
              for case, ms in rounds.items()) + f"; bound {p1_bound:.4f} ms: B6 at "
          f"{p1_bound / p1['p1_reshape_roundtrip']:.0%} and B7 at "
          f"{p1_bound / p1['p1_copy_baseline']:.0%} of it, x + 1 at "
          f"{p1_bound / p1['p1_plain']:.0%}; {smi}")

    # -- 7. the repo's inference configurations at full width ---------------
    t0 = time.perf_counter()
    phase7(dev, smi, "--profile" in sys.argv[1:])
    phase(7, f"done in {time.perf_counter() - t0:.1f} s")

    # -- 8. training at KITTI's operating point, full width -------------------
    t0 = time.perf_counter()
    ms_step = phase8(dev, smi, "--profile" in sys.argv[1:])
    phase(8, f"done in {time.perf_counter() - t0:.1f} s")

    # -- 9. calibrate, threshold, auto-label and validate at full width -------
    t0 = time.perf_counter()
    phase9(dev, smi)
    phase(9, f"done in {time.perf_counter() - t0:.1f} s")

    # -- 10. training and evaluation fed from TFRecords, through the CLI ------
    t0 = time.perf_counter()
    phase10(dev, smi, "--profile" in sys.argv[1:])
    phase(10, f"done in {time.perf_counter() - t0:.1f} s")

    # -- 11. augmentation, active learning and SSL at full width ---------------
    t0 = time.perf_counter()
    phase11(dev, smi)
    phase(11, f"done in {time.perf_counter() - t0:.1f} s")

    # -- 12. the apps' image artifacts and profiling, on native frames ----------
    t0 = time.perf_counter()
    phase12(dev, smi)
    phase(12, f"done in {time.perf_counter() - t0:.1f} s")

    # -- 13. multi-GPU: the port over torch.distributed ------------------------
    torch.cuda.empty_cache()
    phase13(dev, smi, ms_serve, ms_step)

    kernel_ms, plain_ms = times["gaussian"]
    # soft-NMS: boxes and scores in, picks out; ~20 f32 operations per
    # candidate per pick made (IoU, the decay, the argmax)
    nms_bound = bound(BATCH * N_CAND * 20 + BATCH * K * 8 + BATCH * 4,
                      f32_flops=20.0 * picks["gaussian"] * N_CAND)
    bounds = {"soft_nms": nms_bound,
              "fused_dw": bound(2 * 2 * PREFIX[1] * PREFIX[2] * PREFIX[4] * PREFIX[5],
                                f32_flops=(2 * 9 + 4.0) * PREFIX[1] * PREFIX[2] * PREFIX[4]
                                * PREFIX[5]),
              "fused_expand_dw": expand_bound(*BLOCKS[0][1:])}
    pw_m, pw_k, pw_n = perf_packed.N * perf_packed.H * perf_packed.W // perf_packed.G, \
        perf_packed.G * perf_packed.CI, perf_packed.G * perf_packed.CE
    wide = perf_packed.N * perf_packed.H * perf_packed.W * perf_packed.CE * 2
    bounds.update({"packed_pointwise": bound((pw_m * pw_k + pw_k * pw_n + pw_m * pw_n) * 2,
                                             2.0 * pw_m * pw_k * pw_n),
                   "packed_wshift": bound(2 * wide),
                   "add_one_natural": bound(2 * p1_bytes, f32_flops=p1_bytes / 2),
                   "add_one_packed": bound(2 * p1_bytes, f32_flops=p1_bytes / 2),
                   "packed_dw_w3": bound(2 * wide + 3 * pw_n * 2, f32_flops=5.0 * wide / 2)})
    # rows 6-7 (and x + 1, their plain version and library call): the 5-round medians
    bench.update(p1)
    library = {"packed_pointwise": bench["matmul_pw_128x256x24to144"],
               "packed_wshift": bench["pad_packed_wshift_128x32x1152"],
               "add_one_natural": p1["p1_plain"], "add_one_packed": p1["p1_plain"],
               "packed_dw_w3": bench["conv_p2_packed_dwW_128x32x1152"]}
    rows = [{"name": "soft_nms", "route": "cuda", "source": "udal_tpu_torch/csrc/soft_nms.cu",
             "replaces": "udal_tpu/ops/pallas_nms.py:36", "launches": launches[2],
             "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms}]
    for name, i, replaces in (("fused_dw", 0, "udal_tpu/ops/pallas_dw.py:37"),
                              ("fused_expand_dw", 1, "udal_tpu/ops/pallas_mbconv.py:36")):
        k_ms, p_ms = fused_times[name]
        rows.append({"name": name, "route": "cuda", "source": f"udal_tpu_torch/csrc/{name}.cu",
                     "replaces": replaces, "launches": launches[i],
                     "max_abs_err": max(bf16_err[name], f32_err[name]), "ms": k_ms,
                     "plain_ms": p_ms})
    for name, source, replaces, case, plain_case in PACKED_ROWS:
        rows.append({"name": name, "route": "cuda", "source": f"udal_tpu_torch/csrc/{source}.cu",
                     "replaces": replaces, "launches": packed_launches[name],
                     "max_abs_err": packed_err[name], "ms": bench[case],
                     "plain_ms": bench[plain_case]})
    k_ms, p_ms, library["fused_sepconv"], bounds["fused_sepconv"] = sepconv_times
    rows.append({"name": "fused_sepconv", "route": "cuda",
                 "source": "udal_tpu_torch/csrc/fused_sepconv.cu", "replaces": None,
                 "launches": serve_sepconv, "max_abs_err": sepconv_err, "ms": k_ms,
                 "plain_ms": p_ms})
    for row in rows:
        row["bound_ms"], row["bound_by"] = bounds[row["name"]]
        row["library_ms"] = library.get(row["name"])
    phase("total", f"{time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
