#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result:

1. device: torch / CUDA versions and the card's name and power limit;
2. build: every kernel from ``scaleprotoseg_torch/csrc``, one ``nvcc``
   per source, all started together;
3. kernels: K2 (ASPP), K1 (prototype head) and K3 (upsample + argmax) at
   the flagship serving shapes (batch 2 at 1024 x 2048), each against its
   plain PyTorch version on the same inputs: K2 within 2 bf16 ulps of
   the fp32-accumulated plain form and the same bits on a second run,
   also at the training shape (2 x 65 x 65 x 2048) and at a ragged one
   (2 x 21 x 37 x 512: no multiple of the kernel's patch, smaller than
   the largest rate), K1 rtol = atol = 1e-4 in fp32 with TF32 off on
   the plain side (also at a pruned bank; and against a float64 head: at
   pushed prototypes, and its distances on a sparse probe), K3 labels
   equal wherever the plain
   version's top-two margin is at least 1e-5.  K2's backward at the
   training shapes (batch 2 at 65 x 65 x 2048): ``aspp_grad_pack`` bit
   for bit against the plain pack, ``aspp_grad_weight`` (called per
   image with the rates, as the backward calls it) within rtol = atol =
   1e-3 of the fp32 plain product (TF32 off) and the same bits on a
   second run, timed beside one bf16 x bf16 -> fp32 GEMM of the same
   product and cuDNN's weight gradient, and the whole
   ``aspp_trainable`` backward against autograd through the plain form
   (dx within 2 bf16 ulps, dW and db
   within 1e-3 of their scale).  The int8 kernels of the quant8 path:
   ``int8_mm`` (K4) at ``pallas_mm``'s own 8192 x 512 x 512 and at the
   eight 1x1 conv shapes of layer4/5 (66306 pixels), its int32 arm bit
   for bit against the plain version (float64 products cast to int32,
   exact), its dequantized bf16 epilogue within 1 bf16 ulp of
   ``(acc.float() * (sx * sw)).bfloat16()``, its bf16 arm within rtol =
   1e-4, atol = 1e-3 of the float32 product (TF32 off); ``int8_conv3x3``
   at layer4's and layer5's dilated 3x3 shapes, the int32 accumulator bit
   for bit against a float64 conv of the int8 values and the same bits on
   a second call, with the launch-weighted times of a quant8 batch's 26
   3x3 convs; ``quantize_int8`` (static and dynamic) and
   ``int8_absmax`` bit for bit.  Times are
   CUDA-event medians of 10 runs after warmup, beside the plain version,
   one PyTorch library call computing the same function (a yardstick the
   port never calls: cuDNN, ``torch._int_mm``, ``torch.matmul``) and the
   least time the card could take;
4. serving slice: a temporary run directory (the Cityscapes group
   config, seeded synthetic weights for the full-depth ResNet-101
   flagship, 256 seeded uint8 1024 x 2048 images) served three times
   through ``scaleprotoseg_torch.serving.serve.main`` at batch 2, a timed
   window of several seconds each.  Every serving kernel must launch at
   least once per batch of every run, and the labels must agree with the
   port's plain path (same bf16 model, plain versions instead of kernels)
   on at least 99% of pixels.  Per run: img/s and the device's idle share
   of the timed window (``ServingEngine``'s per-batch stream spans).
   Then quant8 serving: the same run and images served three times
   through ``serve.main --quant8-static --calib-images 8`` and once with
   ``--quant8``: the int8 kernels launch 54 / 26 / 80 times per batch
   (and ``int8_absmax`` 80 under ``--quant8``), K1, K2 and K3 on every
   batch under static and not at all under dynamic; on the first 16
   images the static labels agree on >= 99% of pixels with the plain
   quant8 path (same calibration, every kernel replaced by its plain
   version, int8 products in float64); the agreement with the bf16 labels
   is reported, not gated; img/s and idle share per run and a profile of
   one resident quant8 batch; and, measured only, dynamic quant8 with K2,
   K1 and K3 (``fast_logits`` then ``fused_upsample_argmax``) against
   dynamic quant8 as it serves (device ms a batch in turns, label
   agreement over 8 images).  Then the deployable artifact:
   ``serve.main --export`` writes three artifacts of the run at full width
   (bf16 fast at batch 2 with the normalization inside, static quant8 fast
   calibrated on the first 8 images with its scales shipped, and a
   ``--dynamic-batch`` float32 plain one); a fresh interpreter loads each
   (timed) and serves it through ``serve.main --artifact`` (bf16 and
   quant8 over the 256 images, the plain one over the first 8), printing
   its launch counts and the modules it imported: K1, K2 and K3 once a
   batch (and the int8 kernels' 54 / 26 / 80 under quant8), no kernel in
   the plain one, no model, config or JAX module imported, labels equal
   to the run-dir serve's (bf16, static quant8, float32 ``--no-fast``) on
   >= 99.99% of pixels (bit-equality printed); export, save and load
   seconds, artifact MB and img/s beside the run-dir img/s; one resident
   batch of each fast artifact loaded in this process beside the run-dir
   forward (CUDA-event ms, host ms to enqueue it, profile), and that enqueue
   time below 0/3/7/12/20 extra Python frames through ``predict`` and
   through the program's module alone; then one
   ``--canvas 1024 2048`` run over a full-size and a 600 x 900 image: the
   crops' shapes, the full-size labels equal to the run-dir serve's.
   Then evaluation: a temporary
   Cityscapes-layout val root (8 images of 1024 x 2048, labels holding
   void and every class) evaluated on the same run through
   ``eval_valid_multiscale.run_evaluation``, bf16 and
   ``--quant8-static``: both finish into separate directories with a
   finite mIoU, and each run's confusion matrix equals the host
   ``bincount`` over its own predicted labels, and each writes the
   sample renders of its first 5 images (input | ground truth |
   prediction); both mIoUs, their difference, img/s and the launches are
   printed;
5. training slice: a temporary Cityscapes-layout data root (24 train and
   4 val seeded uint8 1024 x 2048 images, raw category-index labels in
   blocks holding void and every train class, each block a seeded colour
   of its class plus noise) trained through
   ``scaleprotoseg_torch.train_wandb_multiscale.main --gpu-recipe`` on
   the full-depth flagship backbone: 20 warm-up and 40 joint micro-steps
   (``iter_size`` 5), a validation every 20.  Per phase: every micro-step's
   loss finite, K2's forward launched once per micro-step and validation
   batch, both backward kernels once per micro-step; training img/s,
   median step ms (CUDA events) and the device's idle share past the
   first 3 steps.  Then one micro-step of the kernel path against the
   plain path (same bf16 model and batch; plain K2 forward and backward)
   from the joint phase's last weights: loss within 1e-3, ASPP-weight and
   prototype gradients within 2e-2 relative L2 (the same step from the
   pushed ``push_final`` is printed beside it).  Between the joint phase
   and ``push_final`` the trainer
   pushes the prototypes (float32 forward over the 24 full-size train
   images, duplicates pruned): the prototypes scanned, matched and pruned
   are printed, and every kept prototype's distance at its winning pixel,
   recomputed with the float32 plain forward, must be at most
   1e-5 (1 + |p|^2).  ``push_final`` loads through ``load_model`` and
   serves one finite batch.  Then the group phase from that
   ``push_final``: ``finetune_wandb_group.main --gpu-recipe``, 10 warm-up
   and 10 joint micro-steps of the group config (``joint_last``): every
   loss finite, K2's forward on every micro-step and validation batch,
   every group-projection row of ``final-group`` >= 0 and summing to 1
   within 1e-5; one group micro-step of the kernel path against the plain
   path (loss within 1e-3 of max(1, |loss|), group-projection gradients
   within 2e-2 relative L2) and a profile of a joint one.  ``final-group`` is served
   through ``serve.main`` in bf16 on 8 full-size images (K2, K1 and K3 on
   every batch, labels against the plain path on >= 99% of pixels), and
   K1 is held at the bank push left: on random features against its plain
   version (rtol = atol = 1e-4), on the served features (pushed
   prototypes, d ~ 0) against the float64 head within
   ``PROTO_PUSHED_RTOL`` of its largest logit.  Then the pruning slice on
   the same runs: the push artifacts the trainer wrote (seconds, files, one
   ``bb.npy`` row per prototype of the scanned bank, every matched box
   inside 1024 x 2048); ``run_pruning.main`` (k = 6, threshold 3, the 24
   train images at full size; no kernel launch): every kept prototype has
   >= 3 own-class labels among its 6 and every pruned one fewer, each
   pushed prototype's nearest non-void patch lies within 1e-5 (1 + |p|^2),
   the share whose first label is its own class is printed;
   ``train_wandb.main --pruned --gpu-recipe`` for 10 last-layer
   micro-steps: losses finite, K2's forward on every micro-step and
   validation batch, its backward never, only ``last_layer.weight`` moved,
   img/s, step ms and idle share; the ``pruned`` phase served as
   ``final-group`` is (labels and K1 at its bank);
   ``threshold_save`` at 0.1 on ``final-group``: entries below 0.1 zeroed,
   the rest bit-equal, no row re-normalised, ``th-0.1-final-group``
   served likewise; ``eval_test.main`` on ``pruned`` over 4 test images:
   K1, K2 and K3 once a batch, 4 gray PNGs of 1024 x 2048 decoded by
   ``imageio.read_png``, every value a Cityscapes label id, equal to the
   plain path's after the label table on >= 99% of pixels; and
   ``run_evaluation`` of ``pruned`` over the 4 val images (a finite mIoU,
   K2 and K3 once a batch).  Then the ProtoSeg baseline
   (``baseline_cityscapes``: summed ASPP, 190 prototypes on one scale) at
   full depth through ``train_wandb.main --gpu-recipe`` without
   ``--pruned`` on the same data: 10 warm-up, 10 joint and 5 last-layer
   micro-steps around push, K2's forward and backward launched exactly as
   the phases imply (the last layer: the forward alone), losses finite,
   img/s, step ms and idle share per phase; its ``push_final`` served as
   ``final-group`` is (K1, K2 and K3 on every batch, labels against the
   plain path, K1 at the pushed bank).  Then resume after SIGTERM: the
   baseline's joint phase (20 micro-steps, ``iter_size`` 5, a validation
   every 5, ``det_seed`` bound) through the trainer CLI in processes of
   its own, twice straight (the two must agree bit for bit), once stopped
   by SIGTERM to its process group once the first validation's state has
   committed (exit 143, the state committed at the step it stopped) and
   once relaunched (exit 0, the state restored at that step): every
   checkpoint and metrics row of the relaunch equal to the straight
   run's, bit for bit; the state's MB, the blocking snapshot's host ms,
   the commit and restore seconds and the relaunch's launches are
   printed. The training data path, on the same data root: first, before
   the flagship's trainer, the native augmentation (``native/fastaug.cc``)
   built with g++ (a failed build fails the script) and held bit for bit
   against the numpy pipeline on 32 training items (the 513 x 513 window,
   scales 0.5-1.5, ``det_seed`` draws), the median ms an item of each; the
   train loader alone (8 workers, batch 2, one untimed epoch and three
   timed) as threads + numpy, threads + native, processes + native,
   processes + jitter and threads + jitter: img/s and the first batch's
   seconds, every pair of streams with the same items bit-equal over the
   four epochs and after a ``fast_forward``. Then, after the resume phase,
   the baseline's joint phase (20 micro-steps, a validation every 10,
   ``det_seed``) through the trainer CLI: jittered on worker processes
   (``loader_backend = 'grain_processes'``) straight; the same SIGTERM'd
   to its process group once the first validation's state committed (exit
   143, its loader workers gone) and relaunched; jittered on threads;
   unjittered on threads with native and with numpy augmentation
   (``SPS_NATIVE_AUG=0``). The relaunch ends on the straight run's bits,
   the processes' run on the threads' run's, the numpy run on the native
   one's (each checkpoint and metrics row); K2's kernels launch in every
   run; img/s, step ms and idle share of each run are printed. Then the
   trainer's knobs: ``ops.gradconv.conv3x3_dilated`` (``fast_gradconv``'s
   hybrid backward) against cuDNN's autograd backward at layer4's (256
   ch, d = 2) and layer5's (512 ch, d = 4) training shapes in bf16, dX
   and dW each within twice cuDNN's largest error against float32
   autograd on the same values, forward + backward CUDA-event ms and the
   device ms of the forward, dX and dW of each (calls queued behind a
   device sleep, CUDA events around them); then the
   flagship's joint phase (10 micro-steps, ``det_seed``, one validation)
   through ``train_wandb_multiscale.main --gpu-recipe`` as is, with
   ``train.fast_gradconv``, with ``train.remat``, with
   ``train.profile_steps = 5`` and as is again: every first loss within
   1e-3 of the first run's, K2's forward once a micro-step (twice under
   remat) and a validation batch, its backward once a micro-step; img/s,
   step ms, idle share and peak memory of each run; the profiled run's
   trace under ``<run>/profile`` read by ``python -m
   scaleprotoseg_torch.profiling --steps-from 0`` (its top 10 kernels,
   categories and ``TOTAL`` printed; 5 steps traced, on the device);
6. one line per kernel with its times, bound and launches, for the six
   kernels since redesigned the earlier design's recorded times beside
   the new ones, the card's name and power limit, the kernels
   line (every kernel with its status),
   then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from scaleprotoseg_torch import eval_valid_multiscale as evm
from scaleprotoseg_torch import kernels
from scaleprotoseg_torch.checkpoints.convert import (load_checkpoint,
                                                     save_checkpoint,
                                                     synthetic_state_dict)
from scaleprotoseg_torch.configlib import parse_config
from scaleprotoseg_torch.constants import (CITYSCAPES_19_EVAL_CATEGORIES,
                                           IMAGENET_MEAN, IMAGENET_STD)
from scaleprotoseg_torch.eval.miou import SegEvaluator
from scaleprotoseg_torch.eval_valid_multiscale import eval_targets
from scaleprotoseg_torch.imageio import read_png
from scaleprotoseg_torch.kernels.aspp import (aspp_plain, aspp_trainable,
                                              grad_pack_plain,
                                              grad_weight_plain, pack_weights,
                                              shifted_sum)
from scaleprotoseg_torch.kernels.int8 import (absmax_plain,
                                              int8_conv3x3_plain,
                                              int8_mm_plain,
                                              quantize_int8_plain)
from scaleprotoseg_torch.kernels.proto import (distance_error, pack_head,
                                               proto_float64, proto_plain)
from scaleprotoseg_torch.kernels.upsample import (fused_upsample_argmax,
                                                  upsample_argmax_plain)
from scaleprotoseg_torch.model_loading import (calibrate_quant_scales,
                                               load_model, quant_sites)
from scaleprotoseg_torch.models.factory import construct_ppnet
from scaleprotoseg_torch.ops.prototype import EPSILON
from scaleprotoseg_torch.ops.resize import _bilinear_matrix
from scaleprotoseg_torch.profiling import (QUANT_GROUPS, SERVING_GROUPS,
                                           TRAINING_GROUPS, kernel_group)
from scaleprotoseg_torch.serving import serve
from scaleprotoseg_torch.serving.export import load_artifact, make_serving_fn
from scaleprotoseg_torch.spec import ProtoSpec

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its
# operations over the peak rate for their type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12

B, HEIGHT, WIDTH = 2, 1024, 2048
FH, FW = 129, 257             # output-stride-8 grid of 1024 x 2048
TH = TW = 65                  # output-stride-8 grid of a 513 x 513 crop
RATES = (6, 12, 18, 24)
N_IMAGES = 256                # ~5 s of serving per run at ~50 img/s
SERVE_RUNS = 3
N_TRAIN, N_VAL = 24, 4
WARMUP_STEPS, JOINT_STEPS, VAL_EVERY = 20, 40, 20
GROUP_WARMUP_STEPS, GROUP_JOINT_STEPS = 10, 10   # a validation at each end
N_GROUP_SERVE = 8
PRUNED_STEPS = 10             # last-layer micro-steps of the pruned model
N_TEST = 4                    # test-split images exported by eval_test
SINGLE_STEPS = (10, 10, 5)    # the baseline's warm-up, joint, last layer
SINGLE_VAL_EVERY = 10
RESUME_STEPS, RESUME_VAL_EVERY = 20, 5   # the resumed joint phase
RESUME_TIMEOUT_S = 300
DATA_STEPS, DATA_VAL_EVERY = 20, 10      # the data phase's joint runs
KNOB_STEPS, KNOB_PROFILE_STEPS = 10, 5   # the knobs phase's joint runs
KNOB_RUNS = {"recipe": [], "fast_gradconv": ["train.fast_gradconv = True"],
             "remat": ["train.remat = True"],
             "profiled": [f"train.profile_steps = {KNOB_PROFILE_STEPS}"],
             "recipe_again": []}   # the spread of the runs, in turns
GRADCONV_SHAPES = {"layer4": (256, 2), "layer5": (512, 4)}  # channels, d
N_FASTAUG = 32                # native vs numpy items at the training crop
LOADER_EPOCHS = 3             # timed epochs of each loader configuration
LOADER_WORKERS = 8
SERVING_KERNELS = ("aspp", "proto", "upsample")
TRAINING_KERNELS = ("aspp", "aspp_grad_pack", "aspp_grad_weight")

CONFIG = """\
PPNetMultiScale.num_groups = 3
PPNetMultiScale.num_scales = 4
construct_PPNet_Group.add_on_layers_type = 'deeplab_simple'
construct_PPNet_Group.base_architecture = 'deeplabv2_resnet101_multiscale'
construct_PPNet_Group.num_classes = 19
construct_PPNet_Group.pretrained = False
construct_PPNet_Group.prototype_activation_function = 'log'
construct_PPNet_Group.prototype_shape = (228, 64, 1, 1)
construct_PPNet_Group.scale_head_type = None
deeplabv2_resnet101_features_multiscale.deeplab_n_features = 64
deeplabv2_resnet101_features_multiscale.scales = []
"""

# K1 against the float64 head (``proto_float64``).  At pushed prototypes
# (every prototype a pixel's features, d = 0 there) the activation's slope,
# -1e4, magnifies the fp32 rounding of |x|^2 - 2 x.p + |p|^2 in the kernel
# and the plain head alike: the largest logit error allowed there, as a
# share of the largest float64 logit (the head's exp sets the scale).  On the
# sparse probe (features and prototypes non-zero on four coordinates a
# scale, so that the cross term's error is the distance's) the largest
# distance error, in units of fp32 rounding (``distance_error``).  Both
# set from readings on an H100 (``tools/kernel_variants.py proto`` and this
# script): at pushed prototypes the kernel 0.0097-0.011, the fp32 plain
# head 0.0068-0.0075, a kernel with two bf16 pieces a prototype the same
# as three (a pushed prototype is bf16: its lo piece is zero); on the
# probe the kernel 1.45-1.51, the fp32 plain head 1.41-1.51, two pieces
# 29.6.
PROTO_PUSHED_RTOL = 2e-2
PROTO_DISTANCE_ERR = 3.0

# every pallas_call site of the repo is ported; a site still to port
# would be listed here with its name and "replaces"
STILL_TO_PORT = []

# quant8: layer4 and layer5 (23 and 3 bottlenecks) of ResNet-101 at the
# serving grid; per batch each block runs reduce, conv3x3 and increase,
# the first a shortcut too, and every conv quantizes its input once
N_BLOCKS = {"layer4": (23, 512, 256, 1024, 2),
            "layer5": (3, 1024, 512, 2048, 4)}   # n, cin, mid, out, dilation
PER_BATCH = {"int8_mm": sum(2 * n + 1 for n, *_ in N_BLOCKS.values()),
             "int8_conv3x3": sum(n for n, *_ in N_BLOCKS.values()),
             "quantize_int8": sum(3 * n + 1 for n, *_ in N_BLOCKS.values())}
QUANT_KERNELS = tuple(PER_BATCH)
N_CALIB = 8
N_CHECK_PLAIN = 16
N_EVAL = 8
N_SAMPLES = 5                 # eval's sample renders (the first files)

# The earlier designs of the kernels since rebuilt, as
# measured on NVIDIA H100 80GB HBM3 at 700 W (wrapper ms and profiler device
# ms at the shapes of this script's rows; the 54 1x1 convs of a quant8
# batch for int8_mm's path, layer4 beside layer5 for int8_conv3x3): printed
# beside the new times on a line of their own (the ``kernels`` line holds
# only what this run measured), no second implementation.
EARLIER_DESIGN = {
    "aspp": dict(design="wmma 128 x 64 tile, cp.async gather", ms=4.18,
                 device_ms=4.10, training_shape_device_ms=0.77),
    "int8_mm": dict(design="mma.sync 128 x 128 tile, cp.async", ms=0.046,
                    device_ms=0.024, path_ms_per_batch=11.6,
                    path_device_ms_per_batch=9.39),
    "int8_conv3x3": dict(design="mma.sync 128 x 128 tile, cp.async tap "
                         "gather", ms=0.605, device_ms=0.554,
                         layer4_ms=0.193, layer4_device_ms=0.155),
    "aspp_grad_weight": dict(design="wmma 128 x 64 tile, cp.async ring",
                             ms=0.684, device_ms=0.618),
    "proto": dict(design="one thread per pixel, fp32 FMA, bank staged "
                  "64 rows at a time", ms=0.205, device_ms=0.172),
    "upsample": dict(design="one thread per output pixel, gathered loads",
                     ms=0.167, device_ms=0.134),
}

BWD = "scaleprotoseg_tpu/ops/pallas_aspp.py:319 fused_aspp_trainable bwd"
SOURCES = {"aspp": "aspp", "aspp_grad_pack": "aspp_bwd",
           "aspp_grad_weight": "aspp_bwd", "proto": "proto",
           "upsample": "upsample", "int8_mm": "int8_mm",
           "int8_conv3x3": "int8_mm", "quantize_int8": "int8_mm",
           "int8_absmax": "int8_mm"}
QUANT = "scaleprotoseg_tpu/ops/quant.py"
REPLACES = {
    "aspp": "scaleprotoseg_tpu/ops/pallas_aspp.py:68 fused_aspp "
            "(pallas_call :169)",
    "aspp_grad_pack": BWD + " (shifted-gradient pack G, :349-360)",
    "aspp_grad_weight": BWD + " (dW_all = x^T G, :369-370)",
    "proto": "scaleprotoseg_tpu/ops/pallas_proto.py:99 fused_proto_logits "
             "(pallas_call :173)",
    "upsample": "scaleprotoseg_tpu/ops/pallas_upsample.py:127 "
                "fused_upsample_argmax (_apply :62, pallas_call :96)",
    "int8_mm": "benchmarks/bench_int8_mosaic.py:34 pallas_mm "
               "(pallas_call :48)",
    "int8_conv3x3": "benchmarks/bench_int8_mosaic.py:63 int8_dilated_conv "
                    "(pallas_mm over 9 taps); XLA's s8 conv in " + QUANT +
                    ":154 static_int8_conv and :125 dynamic_int8_conv",
    "quantize_int8": QUANT + ":150-152 static quantize and :102 dynamic "
                     "quantize (XLA-fused elementwise)",
    "int8_absmax": QUANT + ":93-94 quantize_symmetric per-tensor max|x| "
                   "(XLA reduce)",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    """Median CUDA-event time of ``fn()`` in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def enqueue_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    """Median host-clock ms that ``fn()`` takes to return from an idle
    card: the time to enqueue one call's device work (the card runs it
    behind; a call whose enqueueing outlasts its device time leaves the card
    idle)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------
def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    return smi


def build_phase() -> None:
    t0 = time.perf_counter()
    report = kernels.build()
    for name, r in report.items():
        ptxas = [ln.strip() for ln in r["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"build {name}: {r['seconds']:.1f} s  " + " | ".join(ptxas))
    log(f"build: {time.perf_counter() - t0:.1f} s wall")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def aspp_case(gen, dev, h: int, w: int, c: int = 2048):
    """Seeded K2 inputs at (B, h, w, c) -> 4 x 64, the kernel held against
    the plain form (2 bf16 ulps) and against its own second run (the same
    bits).  Returns (x, ws, bs, packed, got, max_abs_err)."""
    f, rates = 64, RATES
    x = torch.rand((B, h, w, c), generator=gen, device=dev) \
        .to(torch.bfloat16)
    std = math.sqrt(2.0 / (9 * c))
    ws = [torch.randn((3, 3, c, f), generator=gen, device=dev) * std
          for _ in rates]
    bs = [torch.randn((f,), generator=gen, device=dev) * 0.1 for _ in rates]
    # packed once, as the model packs its weights once
    packed = pack_weights(ws, bs)
    got = kernels.fused_aspp(x, ws, bs, rates, packed)
    want = aspp_plain(x, ws, bs, rates).float()
    mag = torch.maximum(want.abs(), want.abs().max() * 2.0 ** -10)
    ulps = ((got.float() - want).abs()
            / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max().item()
    if not ulps <= 2:
        raise AssertionError(f"aspp {h}x{w}x{c}: {ulps} bf16 ulps from the "
                             "plain form")
    if not torch.equal(got, kernels.fused_aspp(x, ws, bs, rates, packed)):
        raise AssertionError(f"aspp {h}x{w}x{c}: a second run gave other bits")
    return x, ws, bs, packed, got, (got.float() - want).abs().max().item()


def check_aspp(gen, dev) -> dict:
    """K2's forward at the serving shape (the row), at the training shape
    and at a ragged one (H, W no multiples of the kernel's 32 x 8 patch,
    H below the largest rate)."""
    c, f = 2048, 64
    for h, w, cc in ((TH, TW, c), (21, 37, 512)):
        x, ws, bs, packed, _, err = aspp_case(gen, dev, h, w, cc)
        fn = lambda: kernels.fused_aspp(x, ws, bs, RATES, packed)  # noqa: E731
        log(f"aspp {B}x{h}x{w}x{cc}: within 2 bf16 ulps of the plain form "
            f"(max_abs_err {err:.3g}), same bits twice; kernel "
            f"{time_ms(fn):.4f} ms, device "
            f"{device_kernel_ms(fn, 'aspp_kernel')}")
    x, ws, bs, packed, got, err = aspp_case(gen, dev, FH, FW)
    xc = x.permute(0, 3, 1, 2)                       # channels_last view
    w_oihw = [w.permute(3, 2, 0, 1).to(torch.bfloat16) for w in ws]
    b_bf = [b.to(torch.bfloat16) for b in bs]

    def library():
        return torch.cat([F.conv2d(xc, w, b, padding=r, dilation=r)
                          for w, b, r in zip(w_oihw, b_bf, RATES)], dim=1)

    # work the function must do: only taps that land inside the image
    flops = valid_tap_flops(FH, FW, c, f)
    moved = nbytes(x, got) + len(RATES) * (9 * c * f * 2 + f * 4)
    b_ms, b_by = bound(moved, flops, PEAK_BF16_FLOPS)
    return dict(
        name="aspp", max_abs_err=err,
        device_ms=device_kernel_ms(
            lambda: kernels.fused_aspp(x, ws, bs, RATES, packed),
            "aspp_kernel"),
        ms=time_ms(lambda: kernels.fused_aspp(x, ws, bs, RATES, packed)),
        plain_ms=time_ms(lambda: aspp_plain(x, ws, bs, RATES)),
        library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)


def check_proto(gen, dev) -> dict:
    spec = ProtoSpec.equal_allocation(228, 64, num_classes=19, num_groups=3)
    c, g, a = 19, 3, spec.num_active_prototypes
    feats = torch.rand((B, FH, FW, 256), generator=gen, device=dev) \
        .to(torch.bfloat16)
    protos = torch.rand((228, 64), generator=gen, device=dev)
    gw = torch.rand((c, g, spec.max_protos_per_class), generator=gen,
                    device=dev) + 1e-3
    gw = gw / gw.sum(-1, keepdim=True)
    glw = torch.randn((c * g, c), generator=gen, device=dev) * \
        math.sqrt(2.0 / (c * g))
    kw = dict(group_projection=gw, last_layer_group=glw)
    # packed once, as the model packs its head once
    head = pack_head(protos, None, spec, **kw)
    got = kernels.fused_proto_logits(feats, protos, None, spec, **kw,
                                     head=head)
    want = proto_plain(feats, protos, None, spec, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    err = (got - want).abs().max().item()
    check_proto_rounding(gen, dev, feats, spec, kw)
    check_proto_pruned(feats, protos, spec, kw)

    # yardstick: the TPU kernel's block-diagonal matmul chain, in torch
    pd = torch.zeros((256, a), device=dev)
    mt = torch.zeros((256, a), device=dev)
    for s, (lo, hi) in enumerate(spec.scale_bounds):
        pd[s * 64:(s + 1) * 64, lo:hi] = protos[lo:hi].t()
        mt[s * 64:(s + 1) * 64, lo:hi] = 1.0
    pn = (protos[:a] ** 2).sum(-1)
    gw_dense = torch.zeros((a, c * g), device=dev)
    for cls in range(c):
        idx = spec.class_proto_index[cls]
        idx = idx[idx >= 0]
        gw_dense[idx, cls * g:(cls + 1) * g] = gw[cls, :, :len(idx)].t()

    def library():
        xf = feats.reshape(-1, 256).float()
        d = torch.relu((xf * xf) @ mt - 2.0 * (xf @ pd) + pn)
        act = torch.log((d + 1.0) / (d + EPSILON))
        return torch.exp(act @ gw_dense) @ glw

    # The cross term x_s.p, fp32-accurate, is three bf16 products on the
    # tensor cores (the fp32 prototype split into hi + mid + lo pieces):
    # counted as three bf16 passes at the bf16 peak.  The rest (|x_s|^2,
    # the distance and log, the group projection, exp and the last layer)
    # runs on the fp32 pipes.  Bytes: each input read once, the logits
    # written once.
    n = B * FH * FW
    cross = n * a * 2 * 64
    rest = n * (2 * 256 + a * 6 + a * g * 2 + c * g + c * g * c * 2)
    t_ops = (3 * cross / PEAK_BF16_FLOPS + rest / PEAK_FP32_FLOPS) * 1e3
    t_bytes = nbytes(feats, protos, gw, glw, got) / PEAK_BYTES_PER_S * 1e3
    b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "operations")
    log(f"proto bound: bytes {t_bytes:.4f} ms, operations {t_ops:.4f} ms "
        f"(cross term as 3 bf16 passes {3 * cross / 1e9:.2f} GFLOP, fp32 "
        f"rest {rest / 1e9:.3f} GFLOP); the cross term on the fp32 pipes "
        f"alone {(cross + rest) / PEAK_FP32_FLOPS * 1e3:.4f} ms")
    return dict(
        name="proto", max_abs_err=err,
        device_ms=device_kernel_ms(lambda: kernels.fused_proto_logits(
            feats, protos, None, spec, **kw, head=head), "proto_kernel"),
        ms=time_ms(lambda: kernels.fused_proto_logits(
            feats, protos, None, spec, **kw, head=head)),
        plain_ms=time_ms(lambda: proto_plain(feats, protos, None, spec,
                                             **kw)),
        library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)


def check_proto_pruned(feats, protos, spec, kw) -> None:
    """K1 at a bank pruned as push's dedup prunes one: prototypes gone from
    three scales and every prototype of class 4, so scales and classes
    hold uneven counts and a class is empty; rtol = atol = 1e-4."""
    drop = [3, 60, 61, 130] + [p for p, c in enumerate(spec.class_ids)
                               if c == 4]
    pruned = spec.prune(drop)
    keep = torch.as_tensor(spec.keep_indices(drop), device=protos.device)
    gw = torch.zeros((19, 3, pruned.max_protos_per_class),
                     device=protos.device)
    for c in pruned.nonempty_classes:
        old = [j for j, p in enumerate(spec.class_proto_index[c])
               if p >= 0 and p not in drop]
        gw[c, :, :len(old)] = kw["group_projection"][c][:, old]
    pkw = dict(group_projection=gw, last_layer_group=kw["last_layer_group"])
    got = kernels.fused_proto_logits(feats, protos[keep], None, pruned, **pkw)
    want = proto_plain(feats, protos[keep], None, pruned, **pkw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    log(f"proto at a pruned bank ({pruned.num_prototypes} prototypes, scale "
        f"sizes {[hi - lo for lo, hi in pruned.scale_bounds]}, class 4 "
        f"empty): max |err| {(got - want).abs().max().item():.3g}")


def check_proto_rounding(gen, dev, feats, spec, kw) -> None:
    """K1 and the fp32 plain head against the float64 head: at pushed
    prototypes (the group head of ``check_proto``), and the distance error
    on the sparse probe under an identity plain head (the logits are the
    activations)."""
    n = feats.shape[0] * feats.shape[1] * feats.shape[2]
    pushed = torch.empty((spec.num_prototypes, 64), device=dev)
    at = torch.randint(0, n, (spec.num_prototypes,), generator=gen,
                       device=dev)
    flat = feats.reshape(n, -1)
    for s, (lo, hi) in enumerate(spec.scale_bounds):
        pushed[lo:hi] = flat[at[lo:hi], s * 64:(s + 1) * 64].float()
    want = proto_float64(feats, pushed, None, spec, **kw)
    scale = want.abs().max().item()
    got = kernels.fused_proto_logits(feats, pushed, None, spec, **kw)
    err = (got - want).abs().max().item() / scale
    plain = (proto_plain(feats, pushed, None, spec, **kw) - want).abs() \
        .max().item() / scale
    log(f"proto at pushed prototypes, max |err| against the float64 head "
        f"over its largest logit ({scale:.4g}): kernel {err:.3g}, fp32 plain "
        f"head {plain:.3g} (limit {PROTO_PUSHED_RTOL:g})")
    if not err <= PROTO_PUSHED_RTOL:
        raise AssertionError(f"proto: {err:.3g} from the float64 head at "
                             "pushed prototypes")

    probe = ProtoSpec.equal_allocation(228, 64, num_classes=228)
    x = torch.zeros(feats.shape[:3] + (4, 64), device=dev)
    x[..., :4] = 0.5 + 0.5 * torch.rand(x[..., :4].shape, generator=gen,
                                        device=dev)
    x = x.flatten(-2).to(torch.bfloat16)
    p = torch.zeros((228, 64), device=dev)
    p[:, :4] = 0.5 + 0.5 * torch.rand((228, 4), generator=gen, device=dev)
    eye = torch.eye(228, device=dev)
    got = distance_error(kernels.fused_proto_logits(x, p, eye, probe), x, p,
                         probe)
    plain = distance_error(proto_plain(x, p, eye, probe), x, p, probe)
    log(f"proto distance error on the sparse probe (units of fp32 "
        f"rounding): kernel {got:.3g}, fp32 plain head {plain:.3g} (limit "
        f"{PROTO_DISTANCE_ERR:g})")
    if not got <= PROTO_DISTANCE_ERR:
        raise AssertionError(f"proto: distance error {got:.3g} on the "
                             "sparse probe")


def check_upsample(gen, dev) -> dict:
    c = 19
    lg = torch.randn((B, FH, FW, c), generator=gen, device=dev)
    got = kernels.fused_upsample_argmax(lg, HEIGHT, WIDTH)
    want = upsample_argmax_plain(lg, HEIGHT, WIDTH)
    # the plain version's upsampled values, for the top-two margin
    mx = torch.einsum("bhwc,pw->bhpc", lg, torch.as_tensor(
        _bilinear_matrix(WIDTH, FW), device=dev))
    up = torch.einsum("oh,bhpc->bopc", torch.as_tensor(
        _bilinear_matrix(HEIGHT, FH), device=dev), mx)
    top2 = torch.topk(up, 2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) >= 1e-5
    del mx, up, top2
    diff = got.int() != want.int()
    mismatch = int((diff & decided).sum())
    log(f"upsample: {int(diff.sum())} labels differ from the plain version, "
        f"{mismatch} of them where the margin is >= 1e-5; "
        f"{int((~decided).sum())} near-tie pixels")
    if mismatch:
        raise AssertionError(f"upsample: {mismatch} decided labels differ")
    err = float((got.int() - want.int()).abs()[decided].max())

    def library():
        return F.interpolate(lg.permute(0, 3, 1, 2), size=(HEIGHT, WIDTH),
                             mode="bilinear",
                             align_corners=False).argmax(dim=1)

    # separable interpolation: W taps per (class, source row, out column),
    # H taps and one comparison per (class, output pixel)
    flops = B * c * (FH * WIDTH * 3 + HEIGHT * WIDTH * 4)
    b_ms, b_by = bound(nbytes(lg, got), flops, PEAK_FP32_FLOPS)
    return dict(
        name="upsample", max_abs_err=err,
        device_ms=device_kernel_ms(
            lambda: kernels.fused_upsample_argmax(lg, HEIGHT, WIDTH),
            "upsample_argmax_kernel"),
        ms=time_ms(lambda: kernels.fused_upsample_argmax(lg, HEIGHT, WIDTH)),
        plain_ms=time_ms(lambda: upsample_argmax_plain(lg, HEIGHT, WIDTH)),
        library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)


def valid_tap_flops(h: int, w: int, c: int, f: int,
                    rates=RATES) -> float:
    """Operations of dilated 3x3 products over (h, w, c) -> f per rate
    (the concat ASPP by default) that only count the taps landing inside
    the image, batch B."""
    taps = 0
    for r in rates:
        for d in (-r, 0, r):
            for e in (-r, 0, r):
                taps += max(h - abs(d), 0) * max(w - abs(e), 0)
    return 2.0 * B * taps * c * f


def check_aspp_backward(gen, dev) -> list:
    """K2's backward kernels at the training shapes (batch 2, 65 x 65 x
    2048 bf16): the pack bit for bit, dW within 1e-3 of the fp32 plain
    product and deterministic, and the whole Function backward against
    autograd through the plain form."""
    c, f = 2048, 64
    x = torch.rand((B, TH, TW, c), generator=gen, device=dev) \
        .to(torch.bfloat16)
    std = math.sqrt(2.0 / (9 * c))
    ws = [torch.randn((3, 3, c, f), generator=gen, device=dev) * std
          for _ in RATES]
    bs = [torch.randn((f,), generator=gen, device=dev) * 0.1 for _ in RATES]
    g = torch.randn((B, TH, TW, len(RATES) * f), generator=gen,
                    device=dev).to(torch.bfloat16)
    x2d = x.reshape(-1, c)

    packed_g = kernels.aspp_grad_pack(g, RATES, f)
    if not torch.equal(packed_g, grad_pack_plain(g, RATES, f)):
        raise AssertionError("aspp_grad_pack differs from the plain pack")
    # as the backward calls it: the zero rows of G skipped, one partial
    # per image
    dw = kernels.aspp_grad_weight(x, packed_g, RATES)
    dw_plain = grad_weight_plain(x2d, packed_g)
    torch.testing.assert_close(dw, dw_plain, rtol=1e-3, atol=1e-3)
    if not torch.equal(dw, kernels.aspp_grad_weight(x, packed_g, RATES)):
        raise AssertionError("aspp_grad_weight is not deterministic")
    dw_err = (dw - dw_plain).abs().max().item()
    log(f"aspp_grad_weight: max_abs_err {dw_err:.3g} against the fp32 "
        f"product, {dw_err / dw_plain.abs().max().item():.3g} of dW's "
        f"scale; same bits twice")

    # the whole backward: the Function against autograd through the plain
    # form on x upcast (36 tap gradients added in fp32, rounded once) and
    # on the bf16-rounded weights (the rounding passed through, so dW
    # stays fp32)
    def grads(fn):
        xs = x.clone().requires_grad_()
        wv = [w.clone().requires_grad_() for w in ws]
        bv = [b.clone().requires_grad_() for b in bs]
        fn(xs, wv, bv).backward(g)
        return [xs.grad] + [w.grad for w in wv] + [b.grad for b in bv]

    got = grads(lambda a, w, b: aspp_trainable(a, w, b, RATES))
    want = grads(lambda a, w, b: shifted_sum(
        a.float(), [wt + (wt.to(torch.bfloat16).float() - wt).detach()
                    for wt in w], b, RATES).to(torch.bfloat16))
    gx, wx = got[0].float(), want[0].float()
    mag = torch.maximum(wx.abs(), wx.abs().max() * 2.0 ** -10)
    ulps = ((gx - wx).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)
            ).max().item()
    if not ulps <= 2:
        raise AssertionError(f"aspp backward dx: {ulps} bf16 ulps")
    rel = []
    for a, b in zip(got[1:], want[1:]):
        scale = b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3 * scale)
        rel.append((a - b).abs().max().item() / scale)
    log(f"aspp backward: dx within {ulps:g} bf16 ulps, dW/db within "
        f"{max(rel):.3g} of their scale, of autograd through the plain form")
    del got, want

    # yardsticks: cuDNN's dilated convs, their weight gradient alone and
    # their whole backward, on the same tensors
    xc = x.permute(0, 3, 1, 2)                       # channels_last view
    gc = g.permute(0, 3, 1, 2)

    def cudnn_backward(x_grad: bool):
        xs = xc.detach().requires_grad_(x_grad)
        wv = [w.permute(3, 2, 0, 1).to(torch.bfloat16).requires_grad_()
              for w in ws]
        bv = [b.to(torch.bfloat16).requires_grad_() for b in bs]
        y = torch.cat([F.conv2d(xs, w, b, padding=r, dilation=r)
                       for w, b, r in zip(wv, bv, RATES)], dim=1)
        inputs = ([xs] if x_grad else []) + wv + bv
        return lambda: torch.autograd.grad(y, inputs, gc, retain_graph=True)

    xr = x.clone().requires_grad_()
    wr = [w.clone().requires_grad_() for w in ws]
    br = [b.clone().requires_grad_() for b in bs]
    y_fn = aspp_trainable(xr, wr, br, RATES)
    fn_bwd = lambda: torch.autograd.grad(  # noqa: E731
        y_fn, [xr] + wr + br, g, retain_graph=True)
    log(f"aspp backward ms: Function (dx, dW, db) "
        f"{time_ms(fn_bwd):.4f}; cuDNN dilated convs + cat, whole backward "
        f"{time_ms(cudnn_backward(True)):.4f}")
    xt = x2d.t()
    try:    # one bf16 x bf16 -> fp32 GEMM of the same product, all taps
        gemm = lambda: torch.mm(xt, packed_g,  # noqa: E731
                                out_dtype=torch.float32)
        gemm()
        what = "torch.mm(x^T, G, out_dtype=float32)"
    except TypeError:
        gemm = lambda: torch.matmul(xt, packed_g)  # noqa: E731
        what = "torch.matmul(x^T, G) (bf16 output: no out_dtype here)"
    log(f"aspp_grad_weight yardsticks ms: one GEMM {what} "
        f"{time_ms(gemm):.4f}, cuDNN's weight gradient "
        f"{time_ms(cudnn_backward(False)):.4f}")

    n = B * TH * TW
    kc = packed_g.shape[1]
    pack_ms, pack_by = bound(nbytes(g, packed_g), 0.0, PEAK_BF16_FLOPS)
    w_ms, w_by = bound(nbytes(x, packed_g, dw),
                       valid_tap_flops(TH, TW, c, f), PEAK_BF16_FLOPS)
    log(f"aspp backward work: G {tuple(packed_g.shape)} over {n} pixels, "
        f"dW {c} x {kc}; all taps {2.0 * n * c * kc / 1e9:.1f} GFLOP, "
        f"inside the image {valid_tap_flops(TH, TW, c, f) / 1e9:.1f} GFLOP")
    return [
        dict(name="aspp_grad_pack", max_abs_err=0.0,
             device_ms=device_kernel_ms(
                 lambda: kernels.aspp_grad_pack(g, RATES, f),
                 "aspp_grad_pack_kernel"),
             ms=time_ms(lambda: kernels.aspp_grad_pack(g, RATES, f)),
             plain_ms=time_ms(lambda: grad_pack_plain(g, RATES, f)),
             library_ms=None, bound_ms=pack_ms, bound_by=pack_by),
        dict(name="aspp_grad_weight", max_abs_err=dw_err,
             device_ms=device_kernel_ms(
                 lambda: kernels.aspp_grad_weight(x, packed_g, RATES),
                 ("aspp_grad_weight_kernel", "split_sum_kernel")),
             ms=time_ms(lambda: kernels.aspp_grad_weight(x, packed_g, RATES)),
             plain_ms=time_ms(lambda: grad_weight_plain(x2d, packed_g)),
             library_ms=time_ms(cudnn_backward(False)), bound_ms=w_ms,
             bound_by=w_by)]


def _int8(gen, shape, dev) -> torch.Tensor:
    return torch.randint(-127, 128, shape, generator=gen, device=dev,
                         dtype=torch.int8)


def _scales(gen, n, dev):
    sx = torch.tensor(2e-3, device=dev)
    sw = torch.rand((n,), generator=gen, device=dev) * 1e-3 + 1e-5
    return sx, sw


def _bf16_within_one_ulp(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Each bf16 value equal to the float32 one rounded, or one bf16 step
    from it."""
    g = got.float()
    r = want.to(torch.bfloat16).float()
    step = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30))) - 7)
    return bool(((g - r).abs() <= step).all())


def path_1x1_shapes() -> list:
    """(K, N, convs per batch) of the 1x1 convs of layer4/5."""
    out = []
    for n, cin, mid, cout, _ in N_BLOCKS.values():
        out += [(cin, mid, 1), (cin, cout, 1), (mid, cout, n),
                (cout, mid, n - 1)]
    return out


def check_int8_mm(gen, dev) -> dict:
    """K4 at pallas_mm's own shape, both arms, and at the path's 1x1 conv
    shapes with the dequant epilogue the model uses."""
    m, k, n = 8192, 512, 512
    a, bt = _int8(gen, (m, k), dev), _int8(gen, (n, k), dev)
    got = kernels.int8_mm(a, bt)
    if not torch.equal(got, int8_mm_plain(a, bt)):
        raise AssertionError("int8_mm int32 arm differs from the plain "
                             "product at 8192 x 512 x 512")
    af = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    bf = torch.randn((n, k), generator=gen, device=dev).to(torch.bfloat16)
    got_f = kernels.int8_mm(af, bf)
    want_f = int8_mm_plain(af, bf)
    torch.testing.assert_close(got_f, want_f, rtol=1e-4, atol=1e-3)
    bf16_err = (got_f - want_f).abs().max().item()
    b_ms, b_by = bound(nbytes(af, bf, got_f), 2.0 * m * k * n,
                       PEAK_BF16_FLOPS)
    log(f"int8_mm bf16 arm 8192x512x512: max_abs_err {bf16_err:.3g}; "
        f"kernel {time_ms(lambda: kernels.int8_mm(af, bf)):.4f} ms, "
        f"plain {time_ms(lambda: int8_mm_plain(af, bf)):.4f} ms, "
        f"torch.matmul (bf16 out) "
        f"{time_ms(lambda: torch.matmul(af, bf.t())):.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    del af, bf, got_f, want_f

    px = B * FH * FW
    total = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for kk, nn, per_batch in path_1x1_shapes():
        xa, wt = _int8(gen, (px, kk), dev), _int8(gen, (nn, kk), dev)
        sx, sw = _scales(gen, nn, dev)
        acc = kernels.int8_mm(xa, wt)
        want = int8_mm_plain(xa, wt)
        if not torch.equal(acc, want):
            raise AssertionError(f"int8_mm int32 differs at {px}x{kk}x{nn}")
        del acc
        deq = kernels.int8_mm(xa, wt, sx, sw, torch.bfloat16)
        if not _bf16_within_one_ulp(deq, want.float() * (sx * sw)):
            raise AssertionError(f"int8_mm epilogue > 1 bf16 ulp at "
                                 f"{px}x{kk}x{nn}")
        del want
        ms = time_ms(lambda: kernels.int8_mm(xa, wt, sx, sw, torch.bfloat16))
        lib = time_ms(lambda: torch._int_mm(xa, wt.t()))
        bms, bby = bound(nbytes(xa, wt, deq, sw), 2.0 * px * kk * nn,
                         PEAK_INT8_OPS)
        for key, v in (("ms", ms), ("library_ms", lib), ("bound_ms", bms)):
            total[key] += v * per_batch
        log(f"int8_mm path 1x1 {px}x{kk}x{nn} (x{per_batch} per batch): "
            f"kernel (bf16 epilogue) {ms:.4f} ms, torch._int_mm (int32) "
            f"{lib:.4f} ms, bound {bms:.4f} ms ({bby}); "
            f"{2.0 * px * kk * nn / ms / 1e9:.1f} TOP/s")
        del xa, wt, deq
    log(f"int8_mm path 1x1 convs per batch: kernel {total['ms']:.3f} ms, "
        f"torch._int_mm {total['library_ms']:.3f} ms, bound "
        f"{total['bound_ms']:.3f} ms")

    b_ms, b_by = bound(nbytes(a, bt, got), 2.0 * m * k * n, PEAK_INT8_OPS)
    return dict(
        name="int8_mm", max_abs_err=0.0,
        device_ms=device_kernel_ms(lambda: kernels.int8_mm(a, bt),
                                   "int8_gemm_kernel"),
        ms=time_ms(lambda: kernels.int8_mm(a, bt)),
        plain_ms=time_ms(lambda: int8_mm_plain(a, bt)),
        library_ms=time_ms(lambda: torch._int_mm(a, bt.t())),
        bound_ms=b_ms, bound_by=b_by, path_ms_per_batch=total)


def check_int8_conv3x3(gen, dev) -> dict:
    """The dilated 3x3 int8 convs of layer4 (256 ch, d=2) and layer5 (512
    ch, d=4) at the serving grid, bit for bit and the same bits twice; the
    row reports layer5's, the log layer4's and the launch-weighted sum of a
    quant8 batch (23 layer4 + 3 layer5 convs)."""
    row = None
    total = dict.fromkeys(("ms", "device_ms", "library_ms", "bound_ms"), 0.0)
    for layer in ("layer4", "layer5"):
        n_conv, _, c, _, dil = N_BLOCKS[layer]
        x, wt = _int8(gen, (B, FH, FW, c), dev), _int8(gen, (9, c, c), dev)
        sx, sw = _scales(gen, c, dev)
        acc = kernels.int8_conv3x3(x, wt, dil)
        if not torch.equal(acc, int8_conv3x3_plain(x, wt, dil)):
            raise AssertionError(f"int8_conv3x3 accumulator differs at "
                                 f"{layer}")
        if not torch.equal(acc, kernels.int8_conv3x3(x, wt, dil)):
            raise AssertionError(f"int8_conv3x3 gave other bits on a second "
                                 f"call at {layer}")
        deq = kernels.int8_conv3x3(x, wt, dil, sx, sw, torch.bfloat16)
        if not _bf16_within_one_ulp(deq, acc.float() * (sx * sw)):
            raise AssertionError(f"int8_conv3x3 epilogue > 1 bf16 ulp at "
                                 f"{layer}")
        del acc
        xc = torch.randn((B, c, FH, FW), generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wc = (torch.randn((c, c, 3, 3), generator=gen, device=dev) * 0.02) \
            .to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        ops = valid_tap_flops(FH, FW, c, c, rates=(dil,))
        b_ms, b_by = bound(nbytes(x, wt, deq, sw), ops, PEAK_INT8_OPS)
        fn = lambda: kernels.int8_conv3x3(  # noqa: E731
            x, wt, dil, sx, sw, torch.bfloat16)
        r = dict(
            name="int8_conv3x3", max_abs_err=0.0,
            device_ms=device_kernel_ms(fn, "int8_conv3x3_kernel"),
            ms=time_ms(fn),
            plain_ms=time_ms(lambda: int8_conv3x3_plain(
                x, wt, dil, sx, sw, torch.bfloat16), warmup=1, iters=3),
            library_ms=time_ms(lambda: F.conv2d(xc, wc, padding=dil,
                                                dilation=dil)),
            bound_ms=b_ms, bound_by=b_by)
        for key in total:
            total[key] += r[key] * n_conv
        log(f"int8_conv3x3 {layer} {B}x{FH}x{FW}x{c} d={dil} "
            f"(x{n_conv} per batch): kernel {r['ms']:.4f} ms "
            f"({ops / r['ms'] / 1e9:.1f} TOP/s on the taps inside the image), "
            f"device {r['device_ms']}, plain {r['plain_ms']:.4f}, bf16 cuDNN "
            f"conv {r['library_ms']:.4f}, bound {b_ms:.4f} ({b_by}); same "
            f"bits twice")
        del x, wt, deq, xc, wc
        row = r
    log(f"int8_conv3x3 path 3x3 convs per batch: kernel {total['ms']:.3f} "
        f"ms, device {total['device_ms']:.3f}, bf16 cuDNN conv "
        f"{total['library_ms']:.3f}, bound {total['bound_ms']:.3f}")
    return dict(row, path_ms_per_batch=total)


def check_quantize(gen, dev) -> list:
    """Both quantize forms and the dynamic scale at the path's widest
    activation (layer5's 2048 channels at the serving grid, bf16)."""
    x = (torch.randn((B, FH, FW, 2048), generator=gen, device=dev) * 3) \
        .to(torch.bfloat16)
    scale = torch.tensor(0.02, device=dev)
    q = kernels.quantize_int8(x, scale)
    if not torch.equal(q, quantize_int8_plain(x, scale)):
        raise AssertionError("quantize_int8 (static) differs")
    s = kernels.int8_absmax(x)
    if not torch.equal(s, absmax_plain(x)):
        raise AssertionError("int8_absmax differs")
    if not torch.equal(kernels.quantize_int8(x, s, divide=True),
                       quantize_int8_plain(x, s, divide=True)):
        raise AssertionError("quantize_int8 (dynamic) differs")
    q_ms, q_by = bound(nbytes(x, q, scale), 0.0, PEAK_INT8_OPS)
    a_ms, a_by = bound(nbytes(x, s), 0.0, PEAK_INT8_OPS)
    log(f"quantize_int8 dynamic form (division): "
        f"{time_ms(lambda: kernels.quantize_int8(x, s, divide=True)):.4f} ms")
    return [
        dict(name="quantize_int8", max_abs_err=0.0,
             device_ms=device_kernel_ms(
                 lambda: kernels.quantize_int8(x, scale), "quantize_kernel"),
             ms=time_ms(lambda: kernels.quantize_int8(x, scale)),
             plain_ms=time_ms(lambda: quantize_int8_plain(x, scale)),
             library_ms=None, bound_ms=q_ms, bound_by=q_by),
        dict(name="int8_absmax", max_abs_err=0.0,
             device_ms=device_kernel_ms(lambda: kernels.int8_absmax(x),
                                        "absmax_"),
             ms=time_ms(lambda: kernels.int8_absmax(x)),
             plain_ms=time_ms(lambda: absmax_plain(x)),
             library_ms=None, bound_ms=a_ms, bound_by=a_by)]


def device_kernel_ms(fn, symbol, iters: int = 5):
    """Device ms per call of the CUDA kernel whose name holds ``symbol``,
    from the profiler (None if the trace shows no such kernel)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    symbols = (symbol,) if isinstance(symbol, str) else symbol
    total = None
    for evt in prof.key_averages():
        if any(sym in evt.key for sym in symbols):
            total = (total or 0.0) + _device_us(evt) / 1e3 / iters
    return total


def _device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return t if t is not None else getattr(evt, "self_cuda_time_total", 0)


# ---------------------------------------------------------------------------
# phase 4: the serving slice
# ---------------------------------------------------------------------------
def write_run(root: str, seed: int, dev) -> str:
    """The flagship run directory with seeded weights that give varied
    labels: ``synthetic_state_dict``, except that the last BN of every
    residual branch is scaled by 0.1 (activations stay bounded at full
    depth instead of growing ~1e8-fold), the group last layer keeps the
    model's own class connection (1 own class, -0.5 others) and each
    prototype sits on the features of a seeded pixel of a seeded image, as
    push places it.  With random weights throughout every pixel takes the
    same class, and a label comparison would prove little."""
    run = os.path.join(root, "city_flagship")
    os.makedirs(run)
    with open(os.path.join(run, "config.gin"), "w") as f:
        f.write(CONFIG)
    model, spec = construct_ppnet(
        "group", "deeplabv2_resnet101_multiscale", (228, 64, 1, 1), 19,
        add_on_layers_type="deeplab_simple", bindings=parse_config(CONFIG))
    sd = synthetic_state_dict(model, seed=seed)
    for key in sd:
        if key.endswith(".increase.bn.weight"):
            sd[key] = sd[key] * np.float32(0.1)
    sd["last_layer_group.weight"] = \
        model.last_layer_group.weight.detach().numpy().copy()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.integers(0, 256, (1, HEIGHT, WIDTH, 3),
                                        dtype=np.uint8)).to(dev)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    with torch.no_grad():
        feats = model.to(dev).eval().conv_features(
            (img.float() / 255.0 - mean) / std).reshape(-1, 256).cpu()
    pixels = rng.choice(feats.shape[0], size=spec.num_prototypes,
                        replace=False)
    protos = sd["prototype_vectors"]
    for s_, (lo, hi) in enumerate(spec.scale_bounds):
        for p in range(lo, hi):
            protos[p] = feats[pixels[p], s_ * 64:(s_ + 1) * 64].numpy() \
                .reshape(protos[p].shape)
    del model
    save_checkpoint(os.path.join(run, "checkpoints", "push_final"), sd, spec,
                    extra={"variant": "group"})
    return run


def head_kw(model) -> dict:
    """The prototype head's weights as K1 and its plain versions take
    them: the plain last layer, or the dense group weights."""
    if model.grouped:
        gw, glw = model.group_weights()
        return dict(last_layer=None, group_projection=gw,
                    last_layer_group=glw)
    return dict(last_layer=model.last_layer.weight.t())


def plain_path(model):
    """``fn(x)`` for raw uint8 batches: the labels of the serving fast path
    with every kernel replaced by its plain version (K2 by ``aspp_plain``,
    the float32-accumulated ASPP rounded to bf16 as the kernel rounds its
    output; K1 by ``proto_plain``; K3 by ``upsample_argmax_plain``; the
    int8 kernels by ``static_int8_conv`` / ``dynamic_int8_conv``)."""
    base = model.features.base
    base.aspp.fast = False
    base.aspp.register_forward_hook(
        lambda m, i, out: out.to(torch.bfloat16).float())
    for _, m in quant_sites(model):
        m.plain = True
    dev = next(model.parameters()).device
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)

    @torch.inference_mode()
    def fn(x: torch.Tensor) -> torch.Tensor:
        xn = ((x.float() / 255.0 - mean) / std).to(torch.bfloat16)
        feats = model.conv_features(xn).contiguous()
        logits = proto_plain(feats, model.prototypes(), spec=model.spec,
                             **head_kw(model))
        return upsample_argmax_plain(logits, x.shape[1], x.shape[2])

    return fn


def serve_run(run_root: str, img_dir: str, out_dir: str) -> dict:
    """One run of the main path through serve.main, launch counts from
    zero; every kernel must launch on every batch."""
    kernels.reset_launch_counts()
    record = serve.main(["city_flagship", "push_final", "--input", img_dir,
                         "--output", out_dir, "--batch", str(B),
                         "--raw-output", "--results-root", run_root,
                         "--workers", "4"])
    counts = kernels.launch_counts()
    batches = 1 + math.ceil(N_IMAGES / B)     # warmup + timed pass
    for name in SERVING_KERNELS:
        n = counts[name]
        if n < batches:
            raise AssertionError(f"{name} launched {n} times in "
                                 f"{batches} batches")
    if not record["fast"] or record["images"] != N_IMAGES:
        raise AssertionError(f"unexpected serve record {record}")
    return dict(record, counts=counts)


def serving_phase(dev, smi: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run = write_run(tmp, seed=0, dev=dev)
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        rng = np.random.default_rng(0)
        for i in range(N_IMAGES):
            np.save(os.path.join(img_dir, f"frame_{i:03d}.npy"),
                    rng.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8))
        log(f"slice: run directory and {N_IMAGES} images written in "
            f"{time.perf_counter() - t0:.1f} s")

        out_dir = os.path.join(tmp, "labels")
        runs = [serve_run(tmp, img_dir, out_dir) for _ in range(SERVE_RUNS)]
        counts = runs[0]["counts"]
        log(f"slice: launches per run {[r['counts'] for r in runs]} over "
            f"{1 + math.ceil(N_IMAGES / B)} batches each")

        # the plain path: the same bf16 model with every kernel replaced
        # by its plain version
        ckpt = os.path.join(run, "checkpoints", "push_final.ckpt")
        plain_model, _ = load_model(run, ckpt, dtype=torch.bfloat16,
                                    fast=False, device=dev)
        plain = plain_path(plain_model)
        agree = total = 0
        names = sorted(os.listdir(img_dir))
        for i in range(0, N_IMAGES, B):
            batch = np.stack([np.load(os.path.join(img_dir, n))
                              for n in names[i:i + B]])
            want = plain(torch.from_numpy(batch).to(dev)).cpu().numpy()
            got = np.stack([np.load(os.path.join(out_dir, n))
                            for n in names[i:i + B]])
            if got.shape != want.shape or got.dtype != np.uint8 \
                    or got.max() >= 19 or want.dtype != np.uint8:
                raise AssertionError(f"labels {got.shape} {got.dtype}")
            agree += int((got == want).sum())
            total += got.size
        agreement = agree / total
        log(f"slice: labels agree with the plain path on "
            f"{100 * agreement:.4f}% of {total} pixels")
        if agreement < 0.99:
            raise AssertionError(f"agreement {agreement} < 0.99")
        del plain_model, plain

        # the device forward of one resident batch, and where it goes
        fast_model, _ = load_model(run, ckpt, dtype=torch.bfloat16,
                                   fast=True, device=dev)
        fast = make_serving_fn(fast_model, fast=True,
                               normalize_to=torch.bfloat16)
        x = torch.from_numpy(np.stack([np.load(os.path.join(img_dir, n))
                                       for n in names[:B]])).to(dev)
        logits = make_serving_fn(fast_model, output="logits", upsample=False,
                                 fast=True, normalize_to=torch.bfloat16)(x)
        if logits.shape != (B, FH, FW, 19) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"fast-path logits {tuple(logits.shape)} "
                                 "not finite or misshapen")
        batch_ms = time_ms(lambda: fast(x), warmup=2, iters=10)
        queue_ms = enqueue_ms(lambda: fast(x))
        breakdown = profile_batch(lambda: fast(x))
        for i, r in enumerate(runs):
            log(f"slice: run {i + 1}: {r['img_per_s']} img/s through "
                f"serve.main ({N_IMAGES} images in {r['seconds']} s, batch "
                f"{B}, {HEIGHT}x{WIDTH}, full depth); device idle share "
                f"{r['device_idle_share']} on {smi}")
        rates = [r["img_per_s"] for r in runs]
        log(f"slice: img/s median {statistics.median(rates)} min "
            f"{min(rates)} max {max(rates)} spread "
            f"{(max(rates) - min(rates)) / statistics.median(rates)}; device "
            f"forward {batch_ms} ms per batch (CUDA-event median of 10)")
        log("slice: device time per batch by kernel: " + json.dumps(breakdown))
        del fast_model, fast, logits, x
        torch.cuda.empty_cache()
        quant = quant8_phase(tmp, run, img_dir, out_dir, dev, smi)
        art = artifact_phase(tmp, img_dir, out_dir,
                             os.path.join(tmp, "labels_q8"), dev, smi, rates,
                             quant["img_per_s"])
        for name, run_ms, run_queue, run_prof in (
                ("bf16", batch_ms, queue_ms, breakdown),
                ("quant8", quant["batch_ms"], quant["enqueue_ms"],
                 quant["profile"])):
            r = art["resident"][name]
            log(f"artifact {name}: one resident batch {r['ms']} ms (CUDA-"
                f"event median of 10) vs the run-dir forward {run_ms} ms; "
                f"host ms to enqueue it {r['enqueue_ms']} vs {run_queue} "
                f"(median of 10 from an idle card); "
                f"host clock {r['profile']['wall_ms']} vs "
                f"{run_prof['wall_ms']} ms, device {r['profile']['device_ms']} vs "
                f"{run_prof['device_ms']} ms, busy share "
                f"{r['profile']['busy_share']} vs {run_prof['busy_share']}, "
                f"device operations {r['profile']['kernels_per_call']} vs "
                f"{run_prof['kernels_per_call']}; host ms to enqueue it below "
                f"0/3/7/12/20 more frames {r['by_depth']}; on {smi}")
        log(f"slice: img/s bf16 {rates} vs quant8-static "
            f"{quant['img_per_s']} vs quant8 dynamic "
            f"{quant['dyn_img_per_s']}, same call; device forward per batch "
            f"bf16 {batch_ms} ms vs quant8-static {quant['batch_ms']} ms")
        evals = eval_phase(tmp, dev, smi)
        return dict(counts=counts, img_per_s=rates, agreement=agreement,
                    batch_ms=batch_ms, quant=quant, evals=evals,
                    artifact=art)


def serve_quant8_run(run_root: str, img_dir: str, out_dir: str,
                     static: bool) -> dict:
    """One quant8 run through serve.main, launch counts from zero: the
    int8 kernels on every conv of layer4/5 of every batch; under static
    K1, K2 and K3 on every batch too, under dynamic none of them."""
    flag = ["--quant8-static", "--calib-images", str(N_CALIB)] if static \
        else ["--quant8"]
    kernels.reset_launch_counts()
    record = serve.main(["city_flagship", "push_final", "--input", img_dir,
                         "--output", out_dir, "--batch", str(B),
                         "--raw-output", "--results-root", run_root,
                         "--workers", "4", *flag])
    counts = kernels.launch_counts()
    batches = 1 + math.ceil(N_IMAGES / B)
    want = {k: v * batches for k, v in PER_BATCH.items()}
    want["int8_absmax"] = 0 if static else want["quantize_int8"]
    if not static:
        want.update(aspp=0, proto=0, upsample=0)
    if counts != {**counts, **want}:
        raise AssertionError(f"quant8 {'static' if static else 'dynamic'}: "
                             f"launches {counts}, want {want} over "
                             f"{batches} batches")
    if static and min(counts[k] for k in SERVING_KERNELS) < batches:
        raise AssertionError(f"static quant8 skipped a serving kernel: "
                             f"{counts}")
    if record["quant8"] != ("static" if static else True) or \
            record["fast"] != static or record["images"] != N_IMAGES:
        raise AssertionError(f"unexpected quant8 serve record {record}")
    return dict(record, counts=counts)


def _labels(out_dir: str, names) -> np.ndarray:
    return np.stack([np.load(os.path.join(out_dir, n)) for n in names])


def quant8_phase(tmp: str, run: str, img_dir: str, bf16_dir: str, dev,
                 smi: str) -> dict:
    """Quant8 serving of the same run and images: three static runs and
    one dynamic, the static labels against the plain quant8 path, and the
    profile of one resident static batch."""
    out_dir = os.path.join(tmp, "labels_q8")
    runs = [serve_quant8_run(tmp, img_dir, out_dir, static=True)
            for _ in range(SERVE_RUNS)]
    dyn = serve_quant8_run(tmp, img_dir, os.path.join(tmp, "labels_q8d"),
                           static=False)
    names = sorted(os.listdir(img_dir))
    ckpt = os.path.join(run, "checkpoints", "push_final.ckpt")

    def calibrated(fast: bool):
        """The bf16 static model calibrated as serve.main calibrates it."""
        model, _ = load_model(run, ckpt, dtype=torch.bfloat16, fast=fast,
                              device=dev, quant8="static")
        pre = serve._make_preprocess(img_dir, normalize=True)
        calibrate_quant_scales(model, (
            torch.from_numpy(pre(n))[None].to(dev, torch.bfloat16)
            for n in names[:N_CALIB]))
        return model

    # the plain quant8 path: the same calibration, every kernel replaced
    # by its plain version (int8 products in float64)
    plain_model = calibrated(fast=False)
    plain_scales = [m.x_scale.item() for _, m in quant_sites(plain_model)]
    plain = plain_path(plain_model)
    kernels.reset_launch_counts()
    agree = total = 0
    for i in range(0, N_CHECK_PLAIN, B):
        batch = np.stack([np.load(os.path.join(img_dir, n))
                          for n in names[i:i + B]])
        want = plain(torch.from_numpy(batch).to(dev)).cpu().numpy()
        got = _labels(out_dir, names[i:i + B])
        if got.shape != want.shape or got.dtype != np.uint8:
            raise AssertionError(f"quant8 labels {got.shape} {got.dtype}")
        agree += int((got == want).sum())
        total += got.size
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"the plain quant8 path launched kernels: "
                             f"{kernels.launch_counts()}")
    agreement = agree / total
    classes = len(np.unique(_labels(out_dir, names[:N_CHECK_PLAIN])))
    log(f"quant8: static labels agree with the plain quant8 path on "
        f"{100 * agreement:.4f}% of {total} pixels (first "
        f"{N_CHECK_PLAIN} images, {classes} distinct labels)")
    if agreement < 0.99:
        raise AssertionError(f"quant8 agreement {agreement} < 0.99")
    del plain_model, plain
    torch.cuda.empty_cache()
    same = sum(int((_labels(out_dir, names[i:i + 16]) ==
                    _labels(bf16_dir, names[i:i + 16])).sum())
               for i in range(0, N_IMAGES, 16))
    vs_bf16 = same / (N_IMAGES * HEIGHT * WIDTH)
    log(f"quant8: static labels agree with the bf16 kernel-path labels on "
        f"{100 * vs_bf16:.4f}% of pixels over {N_IMAGES} images "
        f"(reported, not gated)")

    model = calibrated(fast=True)
    if plain_scales != [m.x_scale.item() for _, m in quant_sites(model)]:
        raise AssertionError("calibration is not deterministic: the plain "
                             "and kernel-path models got other scales")
    fast = make_serving_fn(model, fast=True, normalize_to=torch.bfloat16)
    x = torch.from_numpy(np.stack([np.load(os.path.join(img_dir, n))
                                   for n in names[:B]])).to(dev)
    logits = make_serving_fn(model, output="logits", upsample=False,
                             fast=True, normalize_to=torch.bfloat16)(x)
    if logits.shape != (B, FH, FW, 19) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("quant8 logits not finite or misshapen")
    batch_ms = time_ms(lambda: fast(x), warmup=2, iters=10)
    queue_ms = enqueue_ms(lambda: fast(x))
    breakdown = profile_batch(lambda: fast(x), QUANT_GROUPS)
    share = breakdown["quantize_kernel"] / breakdown["device_ms"]
    del model, fast, logits, x
    torch.cuda.empty_cache()
    for i, r in enumerate(runs + [dyn]):
        kind = "dynamic" if r is dyn else f"static run {i + 1}"
        log(f"quant8 {kind}: {r['img_per_s']} img/s through serve.main "
            f"({N_IMAGES} images in {r['seconds']} s, batch {B}, {HEIGHT}x"
            f"{WIDTH}, full depth); device idle share "
            f"{r['device_idle_share']}; launches {r['counts']} on {smi}")
    log(f"quant8: static device forward {batch_ms} ms per batch "
        f"(CUDA-event median of 10); quantize passes "
        f"{100 * share:.2f}% of its device time")
    log("quant8: device time per static batch by kernel: "
        + json.dumps(breakdown))
    dyn_kernels = dynamic_with_kernels(run, img_dir, names, dev, smi)
    return dict(counts=runs[0]["counts"], dyn_counts=dyn["counts"],
                dyn_kernels=dyn_kernels, profile=breakdown,
                enqueue_ms=queue_ms,
                img_per_s=[r["img_per_s"] for r in runs],
                dyn_img_per_s=dyn["img_per_s"], agreement=agreement,
                vs_bf16=vs_bf16, batch_ms=batch_ms)


def dynamic_with_kernels(run: str, img_dir: str, names, dev,
                         smi: str) -> dict:
    """Dynamic quant8 as it serves (the JAX package's rule: no fast path,
    so the plain head and the resize + argmax) against the same model
    with K2, K1 and K3 (``fast_logits``, then ``fused_upsample_argmax``,
    called from here): device ms a batch, in turns, and their labels over
    the first ``N_CALIB`` images.  A measurement only: the package keeps
    the rule."""
    ckpt = os.path.join(run, "checkpoints", "push_final.ckpt")
    model, _ = load_model(run, ckpt, dtype=torch.bfloat16, device=dev,
                          quant8=True)
    aspp = model.features.base.aspp
    plain = make_serving_fn(model, normalize_to=torch.bfloat16)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)

    def today(x):
        aspp.fast = False
        return plain(x)

    @torch.inference_mode()
    def fused(x):
        aspp.fast = True
        xn = ((x.float() / 255.0 - mean) / std).to(torch.bfloat16)
        return fused_upsample_argmax(model.fast_logits(xn), x.shape[1],
                                     x.shape[2])

    agree = total = 0
    kernels.reset_launch_counts()
    for i in range(0, N_CALIB, B):
        x = torch.from_numpy(np.stack([np.load(os.path.join(img_dir, n))
                                       for n in names[i:i + B]])).to(dev)
        a, b = today(x), fused(x)
        agree += int((a == b).sum())
        total += a.numel()
    counts = kernels.launch_counts()
    if min(counts[k] for k in SERVING_KERNELS) < N_CALIB // B:
        raise AssertionError(f"dynamic quant8 with kernels: {counts}")
    ms = {"today": [], "kernels": []}
    for name in ("today", "kernels", "kernels", "today"):
        fn = today if name == "today" else fused
        ms[name].append(time_ms(lambda: fn(x), warmup=2, iters=10))
    out = dict(today_ms=ms["today"], kernels_ms=ms["kernels"],
               agreement=agree / total)
    log(f"quant8 dynamic: the forward a batch as served (no K1/K3, plain "
        f"ASPP) {ms['today']} ms vs with K2, K1 and K3 {ms['kernels']} ms "
        f"(CUDA-event medians of 10, in turns); labels equal on "
        f"{100 * out['agreement']:.4f}% of {total} pixels over {N_CALIB} "
        f"images; on {smi} (measured only: dynamic quant8 serves without "
        f"the fast path)")
    del model
    torch.cuda.empty_cache()
    return out


# served in a fresh interpreter, as a deployment would: each artifact loaded
# once on its own (the load timed), then served through serve.main
# --artifact with the launch counts from zero; the last line names every
# model, config or JAX module the interpreter imported (none may be)
ARTIFACT_SERVE = r"""
import json, sys, time
from scaleprotoseg_torch import kernels
from scaleprotoseg_torch.serving import serve
from scaleprotoseg_torch.serving.export import load_artifact
out = {}
for name, art, img_dir, out_dir in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    load_artifact(art)
    load_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    rec = serve.main(["--artifact", art, "--input", img_dir, "--output",
                      out_dir, "--batch", "2", "--raw-output",
                      "--workers", "4"])
    out[name] = dict(rec, load_s=load_s, counts=kernels.launch_counts())
out["modules"] = sorted(m for m in sys.modules if m.startswith((
    "scaleprotoseg_torch.models", "scaleprotoseg_torch.configlib",
    "scaleprotoseg_tpu", "jax", "flax")))
print(json.dumps(out))
"""
ARTIFACTS = {   # name -> serve.main flags of its export
    "bf16": [],
    "quant8": ["--quant8-static", "--calib-images", str(N_CALIB)],
    "dynamic_batch": ["--dynamic-batch"],
}


def time_exports(spans: dict):
    """Wrap ``serving.export``'s ``export_serving`` and ``save_artifact``
    so that each call appends its host seconds to ``spans``; returns the
    function that restores them."""
    from scaleprotoseg_torch.serving import export
    real = {n: getattr(export, n) for n in ("export_serving",
                                            "save_artifact")}

    def timed(name):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real[name](*args, **kwargs)
            finally:
                spans.setdefault(name, []).append(time.perf_counter() - t0)
        return call

    for name in real:
        setattr(export, name, timed(name))
    return lambda: [setattr(export, n, f) for n, f in real.items()]


def _agreement(got_dir: str, want_dir: str, names) -> tuple:
    """(share of equal labels, pixels) of two prediction directories."""
    same = total = 0
    for n in names:
        got, want = np.load(os.path.join(got_dir, n)), \
            np.load(os.path.join(want_dir, n))
        if got.shape != want.shape or got.dtype != np.uint8:
            raise AssertionError(f"{n}: labels {got.shape} {got.dtype}, "
                                 f"want {want.shape}")
        same += int((got == want).sum())
        total += got.size
    return same / total, total


def enqueue_by_depth(model, x, depths=(0, 3, 7, 12, 20)) -> dict:
    """Host ms to enqueue one batch of a loaded artifact, called below
    ``depths`` extra Python frames: through ``predict`` (its roomy frame,
    ``serving.export._roomy_call``) and through the program's module
    alone.  Where the module's big frame lands at the end of a CPython
    frame-stack chunk, every Python call it makes maps a chunk of its own;
    the roomy frame keeps the enqueue time flat."""
    def below(depth, fn):
        return fn() if depth == 0 else below(depth - 1, fn)

    def bare():
        with torch.inference_mode():
            return model.call(x)

    return {name: [round(enqueue_ms(lambda: below(d, fn), iters=5), 2)
                   for d in depths]
            for name, fn in (("predict", lambda: model.predict(x)),
                             ("module_alone", bare))}


def artifact_phase(tmp: str, img_dir: str, bf16_dir: str, q8_dir: str,
                   dev, smi: str, rates, q8_rates) -> dict:
    """The deploy step and the artifact served: three artifacts of the run
    written through ``serve.main --export`` at full width (bf16 fast at
    batch 2 with the normalization inside, static quant8 fast with its
    scales, a ``--dynamic-batch`` plain one), served by ``serve.main
    --artifact`` in a fresh interpreter (the bf16 and quant8 ones over the
    256 images, the plain one over the first 8), their labels against the
    run-dir serve's, their launches and the modules imported; then one
    ``--canvas`` run over a full-size and a smaller image."""
    names = sorted(os.listdir(img_dir))
    few = os.path.join(tmp, "images_8")
    os.makedirs(few)
    for n in names[:N_CALIB]:
        os.symlink(os.path.join(img_dir, n), os.path.join(few, n))
    run_args = ["city_flagship", "push_final", "--results-root", tmp,
                "--batch", str(B), "--workers", "4"]
    arts = {}
    for name, flags in ARTIFACTS.items():
        path = os.path.join(tmp, f"artifact_{name}")
        spans = {}
        restore = time_exports(spans)
        t0 = time.perf_counter()
        try:
            rec = serve.main([*run_args, "--input", few, "--export", path,
                              *flags])
        finally:
            restore()
        cli_s = time.perf_counter() - t0
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        want = [None if name == "dynamic_batch" else B, HEIGHT, WIDTH, 3]
        if rec["input"] != want or meta["input"]["shape"] != want or \
                meta["platforms"] != ["cuda"] or \
                not meta["input"]["device_normalize"]:
            raise AssertionError(f"artifact {name}: {rec} {meta}")
        mb = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path)) / 2 ** 20
        arts[name] = dict(path=path, cli_s=cli_s,
                          export_s=spans["export_serving"][0],
                          save_s=spans["save_artifact"][0], mb=mb,
                          files={f: os.path.getsize(os.path.join(path, f))
                                 for f in sorted(os.listdir(path))})
        log(f"artifact {name}: serve --export {cli_s:.2f} s (export_serving "
            f"{arts[name]['export_s']:.2f} s, save_artifact "
            f"{arts[name]['save_s']:.2f} s), {mb:.1f} MB {arts[name]['files']}"
            f"; input {meta['input']}; on {smi}")
        torch.cuda.empty_cache()

    # the plain artifact's reference: the run-dir serve of the same images
    # in float32, under the library defaults the fresh interpreter has
    # (cuDNN may take TF32 for a float32 conv)
    plain_dir = os.path.join(tmp, "labels_f32")
    torch.backends.cudnn.allow_tf32 = True
    try:
        serve.main([*run_args, "--input", few, "--output", plain_dir,
                    "--raw-output", "--no-fast"])
    finally:
        torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()

    out_dirs = {n: os.path.join(tmp, f"labels_art_{n}") for n in arts}
    jobs = [(n, arts[n]["path"], few if n == "dynamic_batch" else img_dir,
             out_dirs[n]) for n in arts]
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", ARTIFACT_SERVE, json.dumps(jobs)], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=900)
    if proc.returncode:
        raise AssertionError(f"artifact serving failed (exit "
                             f"{proc.returncode}):\n{proc.stderr[-6000:]}")
    served = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"artifact: the fresh interpreter took {time.perf_counter() - t0:.1f}"
        f" s; model, config or JAX modules imported: {served['modules']}")
    if served["modules"]:
        raise AssertionError(f"serving an artifact imported "
                             f"{served['modules']}")
    batches = 1 + math.ceil(N_IMAGES / B)
    refs = {"bf16": (bf16_dir, names), "quant8": (q8_dir, names),
            "dynamic_batch": (plain_dir, names[:N_CALIB])}
    for name, (want_dir, want_names) in refs.items():
        r = served[name]
        want = dict.fromkeys(kernels.WRAPPERS, 0)
        if name != "dynamic_batch":
            want.update(aspp=batches, proto=batches, upsample=batches)
        if name == "quant8":
            want.update({k: v * batches for k, v in PER_BATCH.items()})
        if r["counts"] != want or r["images"] != len(want_names):
            raise AssertionError(f"artifact {name}: launches {r['counts']}, "
                                 f"want {want}; record {r}")
        agreement, total = _agreement(out_dirs[name], want_dir, want_names)
        r.update(agreement=agreement, pixels=total)
        log(f"artifact {name}: loaded in {r['load_s']:.2f} s in a fresh "
            f"interpreter; labels equal to the run-dir serve's on "
            f"{100 * agreement:.4f}% of {total} pixels"
            f"{' (bit-equal)' if agreement == 1.0 else ''}; "
            f"{r['img_per_s']} img/s, device idle share "
            f"{r['device_idle_share']} ({r['images']} images, batch "
            f"{r['batch_size']}); launches {r['counts']} on {smi}")
        if agreement < 0.9999:
            raise AssertionError(f"artifact {name}: labels agree on "
                                 f"{agreement} < 0.9999")
    # one resident batch of each fast artifact in this process: its device
    # time and the host clock it takes, beside the run-dir forward's
    resident = {}
    x = torch.from_numpy(np.stack([np.load(os.path.join(img_dir, n))
                                   for n in names[:B]])).to(dev)
    for name, groups in (("bf16", SERVING_GROUPS), ("quant8", QUANT_GROUPS)):
        model = load_artifact(arts[name]["path"])
        resident[name] = dict(
            ms=time_ms(lambda: model.predict(x), warmup=2, iters=10),
            enqueue_ms=enqueue_ms(lambda: model.predict(x)),
            profile=profile_batch(lambda: model.predict(x), groups),
            by_depth=enqueue_by_depth(model, x))
        del model
        torch.cuda.empty_cache()
    log(f"artifact: img/s bf16 artifact {served['bf16']['img_per_s']} vs "
        f"run dir {rates}; static quant8 artifact "
        f"{served['quant8']['img_per_s']} vs run dir {q8_rates}; same call, "
        f"on {smi}")

    # --canvas: a full-size and a smaller image through one program
    mixed = os.path.join(tmp, "images_mixed")
    os.makedirs(mixed)
    os.symlink(os.path.join(img_dir, names[0]),
               os.path.join(mixed, names[0]))
    np.save(os.path.join(mixed, "small.npy"), np.random.default_rng(5)
            .integers(0, 256, (600, 900, 3), dtype=np.uint8))
    canvas_dir = os.path.join(tmp, "labels_canvas")
    rec = serve.main([*run_args, "--input", mixed, "--output", canvas_dir,
                      "--raw-output", "--canvas", str(HEIGHT), str(WIDTH)])
    full = np.load(os.path.join(canvas_dir, names[0]))
    small = np.load(os.path.join(canvas_dir, "small.npy"))
    same = float((full == np.load(os.path.join(bf16_dir, names[0]))).mean())
    log(f"canvas: {rec['images']} images through one {HEIGHT}x{WIDTH} "
        f"program ({rec['preprocess']} preprocess): crops {full.shape} and "
        f"{small.shape}, the full-size labels equal to the plain serve's on "
        f"{100 * same:.4f}% of pixels")
    if rec["preprocess"] != "host" or full.shape != (HEIGHT, WIDTH) or \
            small.shape != (600, 900) or small.max() >= 19 or same != 1.0:
        raise AssertionError(f"canvas: {rec} {full.shape} {small.shape} "
                             f"{same}")
    return dict(exports=arts, served=served, counts={
        "bf16": served["bf16"]["counts"],
        "quant8": served["quant8"]["counts"]}, canvas_agreement=same,
        resident=resident)


def check_samples(eval_dir: str, names) -> None:
    """The sample renders of an evaluation: one PNG a name, input |
    ground truth | prediction, 1024 high, the input panel's pixels the
    image's own."""
    got = sorted(os.listdir(os.path.join(eval_dir, "samples")))
    if got != sorted(f"{n}.png" for n in names):
        raise AssertionError(f"sample renders {got}, want {names}")
    png = read_png(os.path.join(eval_dir, "samples", got[0]))
    if png.shape != (HEIGHT, WIDTH + 2 * (8 + FW), 3):
        raise AssertionError(f"sample render of shape {png.shape}")


class RecordingEvaluator(SegEvaluator):
    """``SegEvaluator`` that keeps each batch's predicted labels on the
    host, so the confusion matrix can be rebuilt from them."""

    last = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.preds = []
        RecordingEvaluator.last = self

    def predict(self, images, h, w):
        out, pred = super().predict(images, h, w)
        self.preds.append(pred.cpu().numpy())
        return out, pred


def eval_phase(tmp: str, dev, smi: str) -> dict:
    """``run_evaluation`` of the flagship run over a Cityscapes-size val
    root, bf16 and static quant8."""
    data = write_city_root(os.path.join(tmp, "city_val"), seed=3,
                           splits=(("val", N_EVAL),))
    names = sorted(p[:-4] for p in os.listdir(
        os.path.join(data, "annotations", "val")))
    targets = np.stack([eval_targets(np.load(os.path.join(
        data, "annotations", "val", n + ".npy")), "cityscapes")
        for n in names])
    batches = math.ceil(N_EVAL / B)
    out = {}
    evm.SegEvaluator = RecordingEvaluator
    try:
        for quant8 in (False, "static"):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = evm.run_evaluation("city_flagship", "push_final",
                                     batch_size=B, data_root=data,
                                     results_root=tmp, quant8=quant8,
                                     calib_images=N_CALIB)
            secs = time.perf_counter() - t0
            counts = kernels.launch_counts()
            ev = RecordingEvaluator.last
            pred = np.concatenate(ev.preds)
            t = targets.astype(np.int64) - 1
            valid = t >= 0
            host = np.bincount(t[valid] * 19 + pred[valid],
                               minlength=19 * 19).reshape(19, 19)
            if not np.array_equal(ev.cm, host):
                raise AssertionError(f"eval {quant8}: confusion matrix "
                                     "differs from the host bincount")
            # the sample renders run the model's forward once a sample
            want = {"upsample": batches, "int8_absmax": 0,
                    "aspp": batches + N_SAMPLES
                    + (N_CALIB if quant8 else 0)}
            want.update({k: (v * (batches + N_SAMPLES) if quant8 else 0)
                         for k, v in PER_BATCH.items()})
            if counts != {**counts, **want}:
                raise AssertionError(f"eval {quant8}: launches {counts}, "
                                     f"want {want}")
            name = "push_final" + ("-quant8static" if quant8 else "")
            path = os.path.join(tmp, "city_flagship", "evaluation", name,
                                "mean_iou.txt")
            if not (math.isfinite(res["mean_iou"]) and os.path.exists(path)):
                raise AssertionError(f"eval {quant8}: {res['mean_iou']} "
                                     f"{path}")
            check_samples(os.path.dirname(path), names[:N_SAMPLES])
            out[quant8] = dict(miou=res["mean_iou"],
                               pixel_accuracy=res["pixel_accuracy"],
                               img_per_s=N_EVAL / secs, counts=counts)
            log(f"eval {'quant8-static' if quant8 else 'bf16'}: mIoU "
                f"{res['mean_iou']:.6f}, pixel acc "
                f"{res['pixel_accuracy']:.6f}, {N_EVAL / secs:.3f} img/s "
                f"({N_EVAL} images of {HEIGHT}x{WIDTH}, load and "
                f"calibration included); confusion matrix equal to the host "
                f"bincount; launches {counts} on {smi}")
    finally:
        evm.SegEvaluator = SegEvaluator
    log(f"eval: quant8-static mIoU - bf16 mIoU = "
        f"{out['static']['miou'] - out[False]['miou']:.6f}")
    return out


# ---------------------------------------------------------------------------
# phase 5: the training slice
# ---------------------------------------------------------------------------
def write_city_root(root: str, seed: int,
                    splits=(("train", N_TRAIN), ("val", N_VAL))) -> str:
    """Cityscapes layout at Cityscapes size: uint8 1024 x 2048 images and
    raw category-index labels in a 4 x 5 grid of blocks, one void block
    and one per train class, shuffled per image; ``splits`` gives the
    image count of each split.  Each block's pixels are a seeded colour of
    its class plus uniform noise of +-48, so that patches of one class lie
    near each other (purity pruning then keeps most prototypes)."""
    rng = np.random.default_rng(seed)
    cats = [0] + [next(k for k, v in CITYSCAPES_19_EVAL_CATEGORIES.items()
                       if v == c) for c in range(1, 20)]
    palette = np.zeros((256, 3), np.int16)
    palette[cats] = rng.integers(48, 208, (len(cats), 3))
    bh, bw = HEIGHT // 4, WIDTH // 5 + 1
    index = {}
    for split, n in splits:
        ann = os.path.join(root, "annotations", split)
        img = os.path.join(root, "img_with_margin_0", split)
        os.makedirs(ann)
        os.makedirs(img)
        index[split] = [f"{split}_{i:03d}" for i in range(n)]
        for name in index[split]:
            grid = rng.permutation(cats).reshape(4, 5).astype(np.uint8)
            label = np.repeat(np.repeat(grid, bh, 0), bw, 1)[:HEIGHT, :WIDTH]
            np.save(os.path.join(ann, name + ".npy"),
                    np.ascontiguousarray(label))
            noise = rng.integers(-48, 49, (HEIGHT, WIDTH, 3), dtype=np.int16)
            np.save(os.path.join(img, name + ".npy"),
                    (palette[label] + noise).astype(np.uint8))
    with open(os.path.join(root, "all_images.json"), "w") as f:
        json.dump(index, f)
    return root


def micro_step_grads(model, batch, dev) -> tuple:
    """(loss, ASPP-weight gradient, prototype gradient) of one micro-step
    of ``model`` on ``batch``, every parameter trainable."""
    from scaleprotoseg_torch.train.steps import LossWeights, compute_losses
    model.zero_grad(set_to_none=True)
    for p in model.parameters():
        p.requires_grad_(True)
    x = torch.from_numpy(batch[0]).to(dev)
    t = torch.from_numpy(batch[1]).to(dev)
    loss, _ = compute_losses(model, model(x), t,
                             LossWeights(crs_ent=1.0, l1=1e-4, kld=0.25))
    loss.backward()
    aspp = torch.cat([p.grad.flatten() for n, p in model.named_parameters()
                      if ".aspp." in n and n.endswith("weight")])
    return loss.item(), aspp, model.prototype_vectors.grad.flatten().clone()


def training_phase(dev, smi: str) -> dict:
    from scaleprotoseg_torch import cli_common, train_wandb_multiscale

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = write_city_root(os.path.join(tmp, "city"), seed=1)
        log(f"train: {N_TRAIN} + {N_VAL} Cityscapes-size images written in "
            f"{time.perf_counter() - t0:.1f} s")
        loaders = data_loader_phase(data, smi)
        gin = ["train.finetune_steps = 0",
               f"train.warmup_steps = {WARMUP_STEPS}",
               f"train.joint_steps = {JOINT_STEPS}",
               f"Trainer.val_check_interval = {VAL_EVERY}"]
        argv = ["scaleproto_cityscapes", "city_train", "--gpu-recipe",
                "--data-root", data, "--results-root", tmp]
        for line in gin:
            argv += ["--gin", line]
        artifacts = time_artifacts()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = train_wandb_multiscale.main(argv)
        counts = kernels.launch_counts()
        log(f"train: main took {time.perf_counter() - t0:.1f} s; launches "
            f"{counts}")
        val_batches = math.ceil(N_VAL / B)
        for phase, steps in ((0, WARMUP_STEPS), (1, JOINT_STEPS)):
            res = out["phases"][phase]
            n_val = res.validations * val_batches
            want = {"aspp": steps + n_val, "aspp_grad_pack": steps,
                    "aspp_grad_weight": steps}
            if res.steps_done != steps or len(res.losses) != steps or \
                    not all(math.isfinite(v) for v in res.losses):
                raise AssertionError(f"phase {phase}: {res.steps_done} "
                                     f"steps, losses {res.losses}")
            if res.launches != {**res.launches, **want}:
                raise AssertionError(f"phase {phase}: launches "
                                     f"{res.launches}, want {want}")
            log(f"train phase {phase}: {steps} micro-steps, "
                f"{res.validations} validations; launches {res.launches}; "
                f"losses first {res.losses[0]:.4f} last "
                f"{res.losses[-1]:.4f}, all finite")
            perf = res.perf
            log(f"train phase {phase}: {perf['img_per_s']} img/s, median "
                f"step {perf['step_ms_median']} ms (CUDA events), device "
                f"idle share {perf['device_idle_share']} over "
                f"{perf['steps_timed']} steps past the first 3; batch {B} "
                f"at 513 x 513, full depth, bf16 recipe, on {smi}")
        # push runs the float32 forward: no kernel launches outside the
        # phases
        if sum(counts[k] for k in TRAINING_KERNELS) != sum(
                sum(out["phases"][p].launches[k] for k in TRAINING_KERNELS)
                for p in (0, 1)):
            raise AssertionError(f"launches outside the phases: {counts}")
        push_stats = check_push(out, data, dev)

        # one micro-step of the kernel path against the plain path, from
        # the joint phase's last weights (before push) and one batch
        run = os.path.join(tmp, "city_train")
        _, bindings = cli_common.load_config(os.path.join(run, "config.gin"))
        batch = next(iter(cli_common.make_loaders(bindings, B, seed=5,
                                                  data_root=data)[0]))
        ckpts = os.path.join(run, "checkpoints")
        step_cmp, model = kernel_vs_plain_step(
            bindings, os.path.join(ckpts, "nopush_last"), batch, dev)
        log("train: one micro-step, kernel path vs plain path: "
            + json.dumps(step_cmp))
        if not (step_cmp["loss_abs_err"] <= 1e-3
                and step_cmp["aspp_grad_rel_l2"] <= 2e-2
                and step_cmp["proto_grad_rel_l2"] <= 2e-2):
            raise AssertionError(f"kernel vs plain micro-step {step_cmp}")
        step_profiles = profile_train_steps(model, bindings, batch, dev)
        # the same at the pushed prototypes: the activation's slope at
        # d ~ 0 (-1e4) magnifies the forward's bf16 differences; reported
        pushed_cmp, model = kernel_vs_plain_step(bindings, out["final"],
                                                 batch, dev)
        log("train: the same micro-step at the pushed prototypes "
            "(push_final; not gated): " + json.dumps(pushed_cmp))
        del model
        torch.cuda.empty_cache()

        # the trained model serves
        served, _ = load_model(run, out["final"] + ".pth",
                               dtype=torch.bfloat16, fast=True, device=dev)
        x = torch.from_numpy(np.random.default_rng(2).integers(
            0, 256, (B, HEIGHT, WIDTH, 3), dtype=np.uint8)).to(dev)
        logits = make_serving_fn(served, output="logits", upsample=False,
                                 fast=True, normalize_to=torch.bfloat16)(x)
        if logits.shape != (B, FH, FW, 19) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError("push_final does not serve finite logits")
        log(f"train: push_final serves {tuple(logits.shape)} finite logits")
        del served, logits, x
        torch.cuda.empty_cache()
        group = group_phase(tmp, data, out["final"], batch, dev, smi)
        pruning = pruning_phase(tmp, data, out, artifacts, dev, smi)
        torch.cuda.empty_cache()
        single = single_phase(tmp, data, dev, smi)
        torch.cuda.empty_cache()
        resume = resume_phase(tmp, data, smi)
        data_run = data_trainer_phase(tmp, data, smi, resume)
        knobs = knobs_phase(tmp, data, smi)
        return dict(counts=counts, step_cmp=step_cmp, pushed_cmp=pushed_cmp,
                    profiles=step_profiles,
                    perf={p: out["phases"][p].perf for p in (0, 1)},
                    push=push_stats, group=group, pruning=pruning,
                    single=single, resume=resume,
                    data=dict(loaders=loaders, trainers=data_run),
                    knobs=knobs)


# ---------------------------------------------------------------------------
# the single-scale baseline, and resume after SIGTERM
# ---------------------------------------------------------------------------
def single_phase(tmp: str, data: str, dev, smi: str) -> dict:
    """The ProtoSeg baseline (``baseline_cityscapes``: summed ASPP, 190
    prototypes on one scale) trained at full depth through
    ``train_wandb.main`` without ``--pruned``: warm-up and joint with K2's
    forward and backward, push, the last layer with K2's forward alone;
    ``push_final`` served like ``final-group``."""
    from scaleprotoseg_torch import train_wandb
    gin = [f"train.warmup_steps = {SINGLE_STEPS[0]}",
           f"train.joint_steps = {SINGLE_STEPS[1]}",
           f"train.finetune_steps = {SINGLE_STEPS[2]}",
           f"Trainer.val_check_interval = {SINGLE_VAL_EVERY}"]
    argv = ["baseline_cityscapes", "city_single", "--gpu-recipe",
            "--data-root", data, "--results-root", tmp]
    for line in gin:
        argv += ["--gin", line]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = train_wandb.main(argv)
    counts = kernels.launch_counts()
    log(f"single: main took {time.perf_counter() - t0:.1f} s; launches "
        f"{counts}")
    val_batches = math.ceil(N_VAL / B)
    for phase, steps in enumerate(SINGLE_STEPS):
        res = out["phases"][phase]
        bwd = 0 if phase == 2 else steps    # the last layer: forward only
        want = {"aspp": steps + res.validations * val_batches,
                "aspp_grad_pack": bwd, "aspp_grad_weight": bwd}
        if res.steps_done != steps or len(res.losses) != steps or \
                not all(math.isfinite(v) for v in res.losses):
            raise AssertionError(f"single phase {phase}: {res.steps_done} "
                                 f"steps, losses {res.losses}")
        if res.launches != {**res.launches, **want}:
            raise AssertionError(f"single phase {phase}: launches "
                                 f"{res.launches}, want {want}")
        perf = res.perf
        log(f"single phase {phase}: {steps} micro-steps, {res.validations} "
            f"validations; launches {res.launches}; losses first "
            f"{res.losses[0]:.4f} last {res.losses[-1]:.4f}, all finite; "
            f"{perf['img_per_s']} img/s, median step {perf['step_ms_median']}"
            f" ms, device idle share {perf['device_idle_share']} over "
            f"{perf['steps_timed']} steps past the first 3; batch {B} at "
            f"513 x 513, full depth, bf16 recipe, on {smi}")
    if sum(counts[k] for k in TRAINING_KERNELS) != sum(
            sum(out["phases"][p].launches[k] for k in TRAINING_KERNELS)
            for p in range(3)):
        raise AssertionError(f"single: launches outside the phases {counts}")
    push = out["push"]
    if push.spec.num_scales != 1:
        raise AssertionError(f"single: push left {push.spec.num_scales} "
                             "scales")
    push_stats = dict(prototypes=int(push.winners.shape[0]),
                      matched=int((push.winners >= 0).sum()),
                      pruned=int(push.winners.shape[0] - push.kept.shape[0]))
    log("single push: " + json.dumps(push_stats))
    served = serve_checkpoint(tmp, "city_single", "push_final", dev, smi,
                              "single_serving")
    return dict(counts=counts, push=push_stats, serve=served,
                perf={p: out["phases"][p].perf for p in range(3)})


def _trainer_cmd(data: str, results: str, name: str,
                 steps: int = RESUME_STEPS, val_every: int = RESUME_VAL_EVERY,
                 gin=()) -> list:
    cmd = [sys.executable, "-m", "scaleprotoseg_torch.train_wandb",
           "baseline_cityscapes", name, "--gpu-recipe", "--data-root", data,
           "--results-root", results]
    for line in ("train.warmup_steps = 0",
                 f"train.joint_steps = {steps}",
                 "train.finetune_steps = 0", "train.push_proto = False",
                 f"Trainer.val_check_interval = {val_every}",
                 "PatchClassificationDataset.det_seed = 11", *gin):
        cmd += ["--gin", line]
    return cmd


def _children(pid: int) -> list:
    """(pid, command line) of the live processes whose parent is ``pid``."""
    out = []
    for d in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{d}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{d}/cmdline") as f:
                cmd = f.read().replace("\0", " ")
        except OSError:
            continue
        if int(ppid) == pid and state != "Z":
            out.append((int(d), cmd))
    return out


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _run_trainer(data: str, results: str, name: str, stop_when=None,
                 env=None, **cmd_kw) -> tuple:
    """The trainer CLI in a session of its own: (exit code, its output,
    seconds, its loader worker processes when it was stopped, those of
    them alive after it exited).  ``stop_when(output)``: send SIGTERM to
    its process group, as a scheduler does, once it is true."""
    out_path = os.path.join(results, f"{name}-{time.time_ns()}.out")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    workers = []
    with open(out_path, "w") as out:
        proc = subprocess.Popen(_trainer_cmd(data, results, name, **cmd_kw),
                                cwd=here, stdout=out,
                                stderr=subprocess.STDOUT,
                                start_new_session=True,
                                env=None if env is None
                                else {**os.environ, **env})
        try:
            if stop_when is not None:
                while proc.poll() is None:
                    with open(out_path) as f:
                        if stop_when(f.read()):
                            workers = [p for p, cmd in _children(proc.pid)
                                       if "spawn_main" in cmd]
                            os.killpg(proc.pid, 15)     # SIGTERM
                            break
                    time.sleep(0.02)
            rc = proc.wait(timeout=RESUME_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    with open(out_path) as f:
        text = f.read()
    return (rc, text, time.perf_counter() - t0, workers,
            [p for p in workers if _alive(p)])


def _logged(text: str, prefix: str) -> list:
    """The JSON objects the trainer logged after ``prefix``."""
    return [json.loads(line.split(prefix, 1)[1]) for line in
            text.splitlines() if prefix in line]


def _phase_launches(text: str) -> dict:
    import ast
    line = [ln for ln in text.splitlines() if "PHASE 1 (nopush) END" in ln][-1]
    return ast.literal_eval(line.split("kernel launches ", 1)[1])


def _phase_perf(text: str) -> dict:
    """The joint phase's img/s, step ms and idle share (``StepTimer``)."""
    import ast
    line = [ln for ln in text.splitlines() if "PHASE 1 (nopush) END" in ln][-1]
    return ast.literal_eval(line.split(" steps; ", 1)[1].split(
        "; kernel launches", 1)[0])


def _checkpoint_diffs(run_a: str, run_b: str) -> dict:
    """Per checkpoint of ``run_a``, the largest |a - b| over its tensors
    (0.0: bit-equal) against ``run_b``'s."""
    out = {}
    for name in sorted(os.listdir(os.path.join(run_a, "checkpoints"))):
        if not name.endswith(".pth"):
            continue
        a = torch.load(os.path.join(run_a, "checkpoints", name))
        b = torch.load(os.path.join(run_b, "checkpoints", name))
        if set(a) != set(b):
            raise AssertionError(f"{name}: other tensors")
        out[name] = max(0.0 if torch.equal(a[k], b[k]) else
                        (a[k].double() - b[k].double()).abs().max().item()
                        for k in a)
    return out


def _metric_rows(run: str) -> list:
    import csv
    with open(os.path.join(run, "metrics.csv"), newline="") as f:
        return [{k: v for k, v in r.items() if k != "time"}
                for r in csv.DictReader(f)]


def resume_phase(tmp: str, data: str, smi: str) -> dict:
    """The baseline's joint phase at full depth (``RESUME_STEPS``
    micro-steps, ``iter_size`` 5, a validation every
    ``RESUME_VAL_EVERY``, ``det_seed`` bound) through the trainer CLI in
    processes of its own: twice straight, once stopped by SIGTERM past
    its first validation (exit 143, the state committed), once relaunched
    (exit 0).  The relaunch's checkpoints and metrics rows must equal the
    straight run's bit for bit, and the two straight runs each other's."""
    results = os.path.join(tmp, "resume")
    os.makedirs(results)
    runs = {}
    for name in ("straight_a", "straight_b"):
        rc, text, secs, *_ = _run_trainer(data, results, name)
        if rc != 0:
            raise AssertionError(f"resume: {name} exited {rc}:\n"
                                 + text[-3000:])
        runs[name] = text
        log(f"resume: {name} exit 0 in {secs:.1f} s")
    a, b = (os.path.join(results, n) for n in ("straight_a", "straight_b"))
    repeat = _checkpoint_diffs(a, b)
    rows_repeat = _metric_rows(a) == _metric_rows(b)
    log(f"resume: straight run twice, largest |difference| per checkpoint "
        f"{json.dumps(repeat)}; metrics rows equal: {rows_repeat}")

    # SIGTERM once the first validation's state has committed, which
    # happens in the background while the next micro-steps run
    state_dir = os.path.join(results, "killed", "checkpoints", "nopush_state")
    first_val = f"step {RESUME_VAL_EVERY}/{RESUME_STEPS} "
    rc, text, secs, *_ = _run_trainer(
        data, results, "killed", stop_when=lambda out: first_val in out and
        os.path.exists(os.path.join(state_dir, "meta.json")))
    stopped = [int(ln.split("PREEMPTED at step ")[1].split(":")[0])
               for ln in text.splitlines() if "PREEMPTED at step " in ln]
    if rc != 143 or not stopped:
        raise AssertionError(f"resume: the SIGTERM'd run exited {rc}:\n"
                             + text[-3000:])
    saved = _logged(text, "train state saved: ")[-1]
    with open(os.path.join(state_dir, "meta.json")) as f:
        meta = json.load(f)
    if meta["step"] != stopped[0] or saved["step"] != stopped[0] or \
            stopped[0] <= RESUME_VAL_EVERY:
        raise AssertionError(f"resume: stopped at {stopped}, state "
                             f"{meta['step']}")
    log(f"resume: SIGTERM after the state of step {RESUME_VAL_EVERY} "
        "committed: "
        f"exit 143 in {secs:.1f} s, stopped at micro-step {stopped[0]} "
        f"(accumulation {stopped[0] % 5} of 5); state "
        f"{saved['bytes'] / 1e6:.1f} MB, blocking snapshot "
        f"{saved['snapshot_ms']:.1f} ms host time in the step loop, commit "
        f"{saved['commit_s']:.2f} s; on {smi}")
    rc, text, secs, *_ = _run_trainer(data, results, "killed")
    if rc != 0:
        raise AssertionError(f"resume: the relaunch exited {rc}:\n"
                             + text[-3000:])
    restored = _logged(text, "train state restored: ")
    async_saves = _logged(text, "train state saved: ")
    launches = _phase_launches(text)
    if not restored or restored[0]["step"] != stopped[0]:
        raise AssertionError(f"resume: the relaunch restored {restored}")
    diffs = _checkpoint_diffs(a, os.path.join(results, "killed"))
    rows_equal = _metric_rows(a) == _metric_rows(
        os.path.join(results, "killed"))
    log(f"resume: relaunch exit 0 in {secs:.1f} s, restored step "
        f"{restored[0]['step']} in {restored[0]['seconds']:.2f} s; its "
        f"last async save {json.dumps(async_saves[-1])}; launches "
        f"{launches}; largest |difference| per checkpoint against the "
        f"straight run {json.dumps(diffs)}; metrics rows equal: "
        f"{rows_equal}; on {smi}")
    bitwise = not any(repeat.values()) and rows_repeat
    if bitwise:
        if any(diffs.values()) or not rows_equal:
            raise AssertionError("resume: the relaunched run differs from "
                                 "the straight run")
    elif any(d > repeat[k] for k, d in diffs.items()):
        raise AssertionError("resume: the relaunched run differs from the "
                             "straight run by more than two straight runs "
                             "differ")
    for k in TRAINING_KERNELS:
        if launches[k] < 1:
            raise AssertionError(f"resume: {k} not launched after the "
                                 "relaunch")
    return dict(launches=launches, stopped=stopped[0], saved=saved,
                restored=restored[0], straight_repeat=repeat,
                relaunch_diff=diffs, bitwise=bitwise)


# ---------------------------------------------------------------------------
# the training data path: native augmentation, the loaders, color jitter
# ---------------------------------------------------------------------------
def _digest(batch) -> str:
    import hashlib
    h = hashlib.sha256()
    for a in batch:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _loaders(data: str, backend: str, jitter: bool, native: bool):
    """``make_loaders`` of the baseline config with ``backend``, jitter
    and augmentation path, ``det_seed`` 11, batch ``B``; returns (train
    loader, the augmentation its items take)."""
    from scaleprotoseg_torch import cli_common
    _, bindings = cli_common.load_config("baseline_cityscapes")
    cli_common.apply_overrides(bindings, [
        f"PatchClassificationDataModule.loader_backend = '{backend}'",
        f"PatchClassificationDataset.jitter = {jitter}",
        "PatchClassificationDataset.det_seed = 11"])
    old = os.environ.get("SPS_NATIVE_AUG")
    os.environ["SPS_NATIVE_AUG"] = "1" if native else "0"
    try:
        tl, _ = cli_common.make_loaders(bindings, B,
                                        num_workers=LOADER_WORKERS, seed=3,
                                        data_root=data, log=lambda m: None)
    finally:
        if old is None:
            del os.environ["SPS_NATIVE_AUG"]
        else:
            os.environ["SPS_NATIVE_AUG"] = old
    return tl, tl.dataset.augmentation


def time_loader(data: str, backend: str, jitter: bool, native: bool,
                smi: str) -> dict:
    """The train loader alone: the first batch's seconds (for processes
    the workers' start), one epoch untimed, then img/s over
    ``LOADER_EPOCHS`` epochs; every batch's digest, and the digests of 8
    batches after ``fast_forward`` to the middle of the next epoch."""
    loader, aug = _loaders(data, backend, jitter, native)
    t0 = time.perf_counter()
    digests, first_s = [], None
    for epoch in range(1 + LOADER_EPOCHS):
        if epoch == 1:
            t1 = time.perf_counter()
        for batch in loader:
            digests.append(_digest(batch))
            if first_s is None:
                first_s = time.perf_counter() - t0
    secs = time.perf_counter() - t1
    n_img = LOADER_EPOCHS * N_TRAIN
    k = (1 + LOADER_EPOCHS) * len(loader) + len(loader) // 2
    loader.fast_forward(k)
    after_ff = []
    while len(after_ff) < 8:
        for batch in loader:
            after_ff.append(_digest(batch))
            if len(after_ff) == 8:
                break
    out = dict(backend=backend, augmentation=aug,
               loader=type(loader).__name__, first_batch_s=first_s,
               img_per_s=n_img / secs, images=n_img,
               workers=loader.num_workers, digests=digests,
               fast_forward=k, after_ff=after_ff)
    log(f"data: loader {backend} + {aug}: {out['img_per_s']:.2f} img/s over "
        f"{n_img} images ({LOADER_EPOCHS} epochs of {N_TRAIN} at batch {B} "
        f"after one untimed, 513 x 513 crops of 1024 x 2048, "
        f"{LOADER_WORKERS} workers), first batch after {first_s:.2f} s; "
        f"host {os.cpu_count()} cores; on {smi}")
    return out


def data_loader_phase(data: str, smi: str) -> dict:
    """The native library built from ``native/fastaug.cc`` (a failed build
    fails the script) and held bit for bit against the numpy pipeline on
    ``N_FASTAUG`` training items (the config's 513 x 513 window, scales
    0.5-1.5) of the Cityscapes-size root; then the train loader alone in
    five configurations (threads + numpy, threads + native, processes +
    native, processes + jitter, threads + jitter): img/s, and the
    processes' jittered stream equal to the threads' bit for bit over two
    epochs and after a ``fast_forward``."""
    from scaleprotoseg_torch import native
    from scaleprotoseg_torch.data.dataset import PatchClassificationDataset
    t0 = time.perf_counter()
    built = native.library_path().exists()
    lib = native.build()
    native.load_library()
    log(f"data: native augmentation {lib.name} "
        f"{'reused' if built else 'built with g++'} in "
        f"{time.perf_counter() - t0:.2f} s")
    kw = dict(data_type="cityscapes", mean=IMAGENET_MEAN, std=IMAGENET_STD,
              window_size=(513, 513), scales=(0.5, 1.5), det_seed=11,
              root=data)
    nat = PatchClassificationDataset("train", **kw)
    ref = PatchClassificationDataset("train", native=False, **kw)
    if (nat.augmentation, ref.augmentation) != ("native", "numpy"):
        raise AssertionError("data: the datasets took "
                             f"{nat.augmentation} / {ref.augmentation}")
    ms = {"native": [], "numpy": []}
    for k in range(N_FASTAUG):
        epoch, i = divmod(k, len(nat))
        nat.set_epoch(epoch)
        ref.set_epoch(epoch)
        t0 = time.perf_counter()
        a = nat[i]
        t1 = time.perf_counter()
        b = ref[i]
        ms["native"].append((t1 - t0) * 1e3)
        ms["numpy"].append((time.perf_counter() - t1) * 1e3)
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            raise AssertionError(f"data: native item {i} of epoch {epoch} "
                                 "differs from the numpy pipeline's")
    item_ms = {k: statistics.median(v) for k, v in ms.items()}
    log(f"data: native augmentation bit-equal to the numpy pipeline on "
        f"{N_FASTAUG} items (513 x 513 from 1024 x 2048, scales 0.5-1.5, "
        f"det_seed draws); median ms an item, load included, one thread: "
        f"native {item_ms['native']:.2f}, numpy {item_ms['numpy']:.2f}")
    runs = {}
    for name, backend, jitter, nat_on in (
            ("threads_numpy", "threads", False, False),
            ("threads_native", "threads", False, True),
            ("processes_native", "grain_processes", False, True),
            ("processes_jitter", "grain_processes", True, True),
            ("threads_jitter", "threads", True, True)):
        runs[name] = time_loader(data, backend, jitter, nat_on, smi)
    for a, b in (("processes_jitter", "threads_jitter"),
                 ("processes_native", "threads_native"),
                 ("threads_native", "threads_numpy")):
        if runs[a]["digests"] != runs[b]["digests"] or \
                runs[a]["after_ff"] != runs[b]["after_ff"]:
            raise AssertionError(f"data: the {a} batch stream differs from "
                                 f"{b}'s")
    log(f"data: batch streams bit-equal, processes + jitter = threads + "
        f"jitter, processes + native = threads + native = threads + numpy, "
        f"over {1 + LOADER_EPOCHS} epochs and 8 batches after fast_forward("
        f"{runs['threads_jitter']['fast_forward']})")
    return dict(item_ms=item_ms, loaders={
        k: {f: v for f, v in r.items() if f not in ("digests", "after_ff")}
        for k, r in runs.items()})


def data_trainer_phase(tmp: str, data: str, smi: str, resume: dict) -> dict:
    """The baseline's joint phase at full depth (``DATA_STEPS``
    micro-steps, a validation every ``DATA_VAL_EVERY``, ``det_seed``)
    through the trainer CLI: jittered on worker processes straight, the
    same SIGTERM'd (to its process group) past its first validation and
    relaunched, jittered on threads; then unjittered on threads, native
    and numpy.  The processes' and threads' runs, the relaunch and the
    straight run, and the native and numpy runs must end on the same
    bits (or, where the resume phase found that two straight runs do not
    repeat, within their difference); the SIGTERM'd run must exit 143
    with its state committed and no worker left."""
    results = os.path.join(tmp, "data")
    os.makedirs(results)
    procs = ["PatchClassificationDataModule.loader_backend = "
             "'grain_processes'"]
    jitter = ["PatchClassificationDataset.jitter = True"]
    kw = dict(steps=DATA_STEPS, val_every=DATA_VAL_EVERY)
    perf, launches = {}, {}

    def straight(name, gin, env=None):
        rc, text, secs, *_ = _run_trainer(data, results, name, env=env,
                                          gin=gin, **kw)
        if rc != 0:
            raise AssertionError(f"data: {name} exited {rc}:\n"
                                 + text[-3000:])
        perf[name], launches[name] = _phase_perf(text), _phase_launches(text)
        aug = [ln.split("augmentation ", 1)[1] for ln in text.splitlines()
               if "train loader: " in ln]
        log(f"data: trainer {name} exit 0 in {secs:.1f} s, train items "
            f"{aug[-1]}: {json.dumps(perf[name])}; launches "
            f"{launches[name]}; on {smi}")
        return text

    straight("procs_jitter", procs + jitter)
    state_dir = os.path.join(results, "killed", "checkpoints", "nopush_state")
    first_val = f"step {DATA_VAL_EVERY}/{DATA_STEPS} "
    rc, text, secs, workers, left = _run_trainer(
        data, results, "killed", gin=procs + jitter,
        stop_when=lambda out: first_val in out and
        os.path.exists(os.path.join(state_dir, "meta.json")), **kw)
    stopped = [int(ln.split("PREEMPTED at step ")[1].split(":")[0])
               for ln in text.splitlines() if "PREEMPTED at step " in ln]
    if rc != 143 or not stopped or not workers or left:
        raise AssertionError(f"data: the SIGTERM'd run exited {rc}, "
                             f"stopped {stopped}, workers {workers}, left "
                             f"alive {left}:\n" + text[-3000:])
    log(f"data: SIGTERM to the trainer's process group after step "
        f"{DATA_VAL_EVERY}'s state committed: exit 143 in {secs:.1f} s at "
        f"micro-step {stopped[0]}; its {len(workers)} loader workers, none "
        "left")
    straight("killed", procs + jitter)
    straight("threads_jitter", jitter)
    straight("threads_native", [])
    straight("threads_numpy", [], env={"SPS_NATIVE_AUG": "0"})
    runs = {n: os.path.join(results, n) for n in perf}
    diffs = {}
    for a, b in (("procs_jitter", "killed"), ("procs_jitter",
                                              "threads_jitter"),
                 ("threads_native", "threads_numpy")):
        d = _checkpoint_diffs(runs[a], runs[b])
        rows = _metric_rows(runs[a]) == _metric_rows(runs[b])
        diffs[f"{a} vs {b}"] = dict(checkpoints=d, rows_equal=rows)
        if resume["bitwise"]:
            bad = any(d.values()) or not rows
        else:
            bad = any(v > max(resume["straight_repeat"].values())
                      for v in d.values())
        if bad:
            raise AssertionError(f"data: {a} and {b} end apart: {d}, "
                                 f"metrics rows equal {rows}")
    held = "bit for bit" if resume["bitwise"] else \
        "within two straight runs' difference (resume phase)"
    log(f"data: largest |difference| per checkpoint {json.dumps(diffs)}, "
        f"held {held}")
    for k in TRAINING_KERNELS:
        if launches["procs_jitter"][k] < 1:
            raise AssertionError(f"data: {k} not launched")
    return dict(perf=perf, launches=launches["procs_jitter"], diffs=diffs,
                stopped=stopped[0], workers=len(workers))


# ---------------------------------------------------------------------------
# the trainer's knobs: fast_gradconv, remat, profile_steps
# ---------------------------------------------------------------------------
def queued_device_ms(fn, n: int = 20):
    """Device ms per call of ``fn``: ``n`` calls enqueued while the card
    sleeps (``torch.cuda._sleep``), so that it runs them back to back and
    the CUDA events around them time the card alone; None where enqueueing
    them outlasted the sleep."""
    fn()
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(100_000_000)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    ev[2].synchronize()
    if enqueue_ms >= ev[0].elapsed_time(ev[1]):
        return None
    return ev[1].elapsed_time(ev[2]) / n


def check_gradconv(smi: str) -> dict:
    """``ops.gradconv.conv3x3_dilated`` against cuDNN's autograd backward
    at layer4's and layer5's training shapes (batch 2 at 65 x 65, bf16):
    dX and dW of each against float32 autograd on the same bf16 values
    (TF32 off), the hybrid's largest error at most twice cuDNN's; forward
    + backward CUDA-event ms, and the device ms of each part
    (``queued_device_ms``; the forward is one call, the same for both).
    The profiler's device time of such short calls did not repeat from
    one profiled run to the next on the card, so it is not read here."""
    from torch.nn.grad import conv2d_input, conv2d_weight
    from scaleprotoseg_torch.ops.gradconv import (conv3x3_dilated,
                                                  grad_input, grad_weight)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for name, (c, d) in GRADCONV_SHAPES.items():
        cl = dict(memory_format=torch.channels_last)
        x = torch.randn(B, c, TH, TW, generator=gen, device=dev) \
            .bfloat16().contiguous(**cl)
        w = (torch.randn(c, c, 3, 3, generator=gen, device=dev)
             * (2.0 / (9 * c)) ** 0.5).bfloat16()
        dy = torch.randn(B, c, TH, TW, generator=gen, device=dev) \
            .bfloat16().contiguous(**cl)
        fwd = {"cudnn": lambda a, b: F.conv2d(a, b, None, 1, d, d),
               "hybrid": lambda a, b: conv3x3_dilated(a, b, d)}

        def grads(f, dtype):
            a = x.detach().to(dtype, copy=True).requires_grad_()
            b = w.detach().to(dtype, copy=True).requires_grad_()
            f(a, b).backward(dy.to(dtype))
            return a.grad.float(), b.grad.float()

        ref = grads(fwd["cudnn"], torch.float32)
        err = {}
        for k, f in fwd.items():
            got = grads(f, torch.bfloat16)
            err[k] = {g: ((a - r).abs().max() / r.abs().max()).item()
                      for g, a, r in zip(("dx", "dw"), got, ref)}
        if not all(err["hybrid"][g] <= 2 * err["cudnn"][g]
                   for g in ("dx", "dw")):
            raise AssertionError(f"gradconv {name}: errors {err}")
        xr = x.detach().clone().requires_grad_()
        wr = w.detach().clone().requires_grad_()
        ms = {k: time_ms(lambda f=f: f(xr, wr).backward(dy))
              for k, f in fwd.items()}
        device = {k: queued_device_ms(f) for k, f in {
            "cudnn/forward": lambda: F.conv2d(x, w, None, 1, d, d),
            "cudnn/dx": lambda: conv2d_input(x.shape, w, dy, 1, d, d),
            "cudnn/dw": lambda: conv2d_weight(x, w.shape, dy, 1, d, d),
            "hybrid/dx": lambda: grad_input(dy, w, d),
            "hybrid/dw": lambda: grad_weight(x, dy, d)}.items()}
        gflop = 2 * 9 * c * c * B * TH * TW / 1e9
        out[name] = dict(channels=c, dilation=d, max_rel_err=err,
                         fwd_bwd_ms=ms, device_ms=device,
                         dw_gflop=round(gflop, 2))
        log(f"gradconv {name} ({c} ch, d = {d}, batch {B} at {TH} x {TW}, "
            f"bf16): " + json.dumps(out[name]) + f"; on {smi}")
        del x, w, dy, xr, wr
    torch.cuda.empty_cache()
    return out


def knobs_phase(tmp: str, data: str, smi: str) -> dict:
    """The trainer's knobs at full depth: ``check_gradconv``, then the
    flagship's joint phase (``KNOB_STEPS`` micro-steps from the same
    seeded weights, ``det_seed``, one validation) through
    ``train_wandb_multiscale.main --gpu-recipe`` five times: as is, with
    ``train.fast_gradconv``, with ``train.remat``, with
    ``train.profile_steps`` and as is again.  Each run's first loss must
    be the recipe's
    within 1e-3, K2's forward launch once a micro-step (twice under
    remat) and a validation batch, its backward kernels once a
    micro-step; the profiled run's trace must exist under
    ``<run>/profile`` and ``python -m scaleprotoseg_torch.profiling``
    must read ``KNOB_PROFILE_STEPS`` steps from it."""
    import gc
    from scaleprotoseg_torch import train_wandb_multiscale
    gradconv = check_gradconv(smi)
    results = os.path.join(tmp, "knobs")
    gin = ["train.warmup_steps = 0", f"train.joint_steps = {KNOB_STEPS}",
           "train.finetune_steps = 0", "train.push_proto = False",
           f"Trainer.val_check_interval = {KNOB_STEPS}",
           "PatchClassificationDataset.det_seed = 11"]
    val_batches = math.ceil(N_VAL / B)
    runs = {}
    log(f"knobs: {torch.cuda.memory_allocated() / 2**20:.1f} MB allocated "
        "before the runs")
    for name, extra in KNOB_RUNS.items():
        argv = ["scaleproto_cityscapes", f"knob_{name}", "--gpu-recipe",
                "--data-root", data, "--results-root", results]
        for line in gin + extra:
            argv += ["--gin", line]
        t0 = time.perf_counter()
        res = train_wandb_multiscale.main(argv)["phases"][1]
        secs = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        fwd = 2 if name == "remat" else 1
        want = {"aspp": fwd * KNOB_STEPS + res.validations * val_batches,
                "aspp_grad_pack": KNOB_STEPS,
                "aspp_grad_weight": KNOB_STEPS}
        if res.steps_done != KNOB_STEPS or \
                not all(math.isfinite(v) for v in res.losses):
            raise AssertionError(f"knobs {name}: {res.steps_done} steps, "
                                 f"losses {res.losses}")
        if res.launches != {**res.launches, **want}:
            raise AssertionError(f"knobs {name}: launches {res.launches}, "
                                 f"want {want}")
        first = abs(res.losses[0] - runs["recipe"]["losses"][0]) \
            if runs else 0.0
        if first > 1e-3:
            raise AssertionError(f"knobs {name}: first loss "
                                 f"{res.losses[0]} against the recipe's "
                                 f"{runs['recipe']['losses'][0]}")
        runs[name] = dict(losses=res.losses, perf=res.perf,
                          launches=res.launches, seconds=secs,
                          first_loss_abs_err=first)
        perf = res.perf
        log(f"knobs {name}: {KNOB_STEPS} joint micro-steps in {secs:.1f} s "
            f"of main; {perf['img_per_s']} img/s, median step "
            f"{perf['step_ms_median']} ms, device idle share "
            f"{perf['device_idle_share']}, peak memory "
            f"{perf['peak_memory_mb']} MB; first loss {res.losses[0]:.6f} "
            f"(|diff| to the recipe {first:.3g}); launches {res.launches}; "
            f"batch {B} at 513 x 513, full depth, bf16 recipe, on {smi}")
    log("knobs: " + json.dumps({k: {
        "img_per_s": r["perf"]["img_per_s"],
        "step_ms_median": r["perf"]["step_ms_median"],
        "peak_memory_mb": r["perf"]["peak_memory_mb"]}
        for k, r in runs.items()}) + f" on {smi}")
    trace_dir = os.path.join(results, "knob_profiled", "profile")
    traces = [n for n in os.listdir(trace_dir)
              if n.endswith(".pt.trace.json.gz")] \
        if os.path.isdir(trace_dir) else []
    if len(traces) != 1:
        raise AssertionError(f"knobs: traces under {trace_dir}: {traces}")
    size = os.path.getsize(os.path.join(trace_dir, traces[0])) / 2**20
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    table = subprocess.run(
        [sys.executable, "-m", "scaleprotoseg_torch.profiling", trace_dir,
         "--top", "10", "--steps-from", "0"], cwd=here, check=True,
        capture_output=True, text=True, timeout=300).stdout.splitlines()
    log(f"knobs: trace {traces[0]} ({size:.1f} MB) tabled in "
        f"{time.perf_counter() - t0:.1f} s by python -m "
        "scaleprotoseg_torch.profiling --top 10 --steps-from 0:")
    for line in table:
        log("  " + line)
    total = json.loads(table[-1])
    if total.get("op") != "TOTAL" or total.get("timeline") != "device" or \
            total.get("n_steps_traced") != KNOB_PROFILE_STEPS:
        raise AssertionError(f"knobs: the trace's table ends {total}")
    categories = [json.loads(ln) for ln in table
                  if ln.startswith('{"op": "CATEGORY:')]
    return dict(gradconv=gradconv, runs=runs, total=total,
                categories=categories, trace_mb=size)


def kernel_vs_plain_step(bindings, stem: str, batch, dev):
    """One micro-step from checkpoint ``stem`` with K2's forward and
    backward against the plain path (same bf16 model and batch): losses
    and the relative L2 of the ASPP-weight and prototype gradients; and
    the kernel-path model."""
    from scaleprotoseg_torch import train_wandb_multiscale
    sd, meta = load_checkpoint(stem)
    spec = ProtoSpec.from_meta(meta["spec"])
    res = {}
    for fast in (False, True):
        model, _ = train_wandb_multiscale.build_model(bindings, 0, spec)
        model.load_state_dict(sd, strict=True)
        model.set_compute_dtype(torch.bfloat16)
        model.features.base.aspp.fast = fast
        res[fast] = micro_step_grads(model.to(dev), batch, dev)
    (lk, ak, pk), (lp, ap, pp) = res[True], res[False]
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    return dict(loss_kernel=lk, loss_plain=lp, loss_abs_err=abs(lk - lp),
                aspp_grad_rel_l2=rel(ak, ap),
                proto_grad_rel_l2=rel(pk, pp)), model


def check_push(out: dict, data: str, dev) -> dict:
    """Prototype push of the training run: what it scanned, matched and
    pruned, and the push property: every kept prototype's distance at its
    winning pixel, recomputed with the float32 plain forward of the pushed
    model (no K2, TF32 off), is at most 1e-5 (1 + |p|^2)."""
    from scaleprotoseg_torch import cli_common
    push = out["push"]
    real = int((push.min_dists < 1e9).sum())
    stats = dict(scanned_images=N_TRAIN,
                 prototypes=int(push.winners.shape[0]),
                 matched=int((push.winners >= 0).sum()),
                 matched_class_pixel=real,
                 pruned=int(push.winners.shape[0] - push.kept.shape[0]),
                 winner_images=int(np.unique(push.winners).size))
    log("push: " + json.dumps(stats))
    run = os.path.dirname(os.path.dirname(out["final"]))
    model, spec = load_model(run, out["final"] + ".pth", device=dev)
    if spec != push.spec:
        raise AssertionError("push_final's spec is not push's")
    _, bindings = cli_common.load_config(os.path.join(run, "config.gin"))
    loader = cli_common.make_push_loader(bindings, data_root=data)
    p = model.prototypes().detach()
    p_sq = (p * p).sum(-1)
    worst = 0.0
    kept_of = {int(i): j for j, i in enumerate(push.kept)}
    offset = 0
    with torch.no_grad():
        for images, _ in loader:
            for b in range(len(images)):
                won = [int(i) for i in np.nonzero(push.winners == offset + b)[0]
                       if int(i) in kept_of]
                if not won:
                    continue
                _, d = model.push_forward(torch.from_numpy(
                    images[b:b + 1]).to(dev))
                d = d.reshape(-1, d.shape[-1])
                js = torch.as_tensor([kept_of[i] for i in won], device=dev)
                flat = torch.as_tensor(push.flat_idx[won], device=dev)
                ratio = d[flat, js] / (1.0 + p_sq[js])
                worst = max(worst, float(ratio.max()))
            offset += len(images)
    stats["max_distance_over_1_plus_p_sq"] = worst
    log(f"push: largest distance at a winning pixel over (1 + |p|^2): "
        f"{worst:.3g} (limit 1e-5) over {len(push.kept)} kept prototypes")
    if not worst <= 1e-5:
        raise AssertionError(f"push: a kept prototype sits {worst:.3g} from "
                             "its winning pixel")
    return stats


def time_artifacts() -> dict:
    """Times push's artifact pass inside the trainer: the returned dict
    gets its ``seconds`` and its bound-box table."""
    from scaleprotoseg_torch.push import artifacts
    seen = {}
    save = artifacts.save_push_artifacts

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        seen["bb"] = save(*args, **kwargs)
        seen["seconds"] = time.perf_counter() - t0
        return seen["bb"]

    artifacts.save_push_artifacts = timed
    return seen


def check_artifacts(run: str, push, artifacts: dict, smi: str) -> dict:
    """The push artifacts the trainer wrote: five files a matched
    prototype under its class's directory, and ``bb.npy`` one row per
    prototype of the scanned bank, each matched row its winner image and
    a box inside the image."""
    root = os.path.join(run, "prototypes")
    files = [f for _, _, fs in os.walk(root) for f in fs
             if f.startswith(("prototype-", "bb"))]
    bb = np.load(os.path.join(root, "bb.npy"))
    matched = push.winners >= 0
    rows = bb[matched]
    if bb.shape != (len(push.winners), 6) or not np.array_equal(
            rows[:, 0], push.winners[matched]) or \
            not (bb[~matched] == -1).all():
        raise AssertionError(f"bb.npy {bb.shape} does not follow the winners")
    inside = ((rows[:, 1] >= 0) & (rows[:, 1] < rows[:, 2]) &
              (rows[:, 2] <= HEIGHT) & (rows[:, 3] >= 0) &
              (rows[:, 3] < rows[:, 4]) & (rows[:, 4] <= WIDTH))
    if not inside.all() or len(files) != 5 * int(matched.sum()) + 2:
        raise AssertionError(f"artifacts: {int((~inside).sum())} boxes "
                             f"outside the image, {len(files)} files")
    if not np.array_equal(np.load(os.path.join(root, "bb-receptive_field"
                                                ".npy")), bb) or \
            not np.array_equal(artifacts["bb"], bb):
        raise AssertionError("artifacts: the bound-box tables differ")
    area = (rows[:, 2] - rows[:, 1]) * (rows[:, 4] - rows[:, 3])
    stats = dict(seconds=artifacts["seconds"], files=len(files),
                 prototypes=int(matched.sum()),
                 box_area_share_median=float(np.median(area)) /
                 (HEIGHT * WIDTH), zlib=zlib_levels(root))
    log(f"artifacts: {json.dumps(stats)}; every box inside {HEIGHT} x "
        f"{WIDTH}; on {smi}")
    return stats


def zlib_levels(root: str) -> dict:
    """What the zlib level costs on this run's artifacts: one heat-map
    overlay and one original, decoded and encoded again at levels 0, 1
    (``imageio.ZLIB_LEVEL``) and 6 (PIL's default), host seconds and MB
    each (one thread)."""
    from scaleprotoseg_torch.imageio import encode_png
    pngs = sorted(os.path.join(d, f) for d, _, fs in os.walk(root)
                  for f in fs if f.endswith(".png"))
    picks = [next(p for p in pngs if "with_self_act" in p),
             next(p for p in pngs if "-original" in os.path.basename(p)
                  and "_" not in os.path.basename(p))]
    out = {}
    for level in (0, 1, 6):
        for path in picks:
            px = read_png(path)
            t0 = time.perf_counter()
            n = len(encode_png(px, level))
            kind = "overlay" if "with_self_act" in path else "original"
            out[f"{kind}_level{level}"] = dict(
                seconds=round(time.perf_counter() - t0, 4),
                mb=round(n / 2 ** 20, 3))
    return out


def pruning_phase(tmp: str, data: str, trained: dict, artifacts: dict, dev,
                  smi: str) -> dict:
    """The pruning slice on the training run: the push artifacts, then
    ``run_pruning`` (k = 6, threshold 3, over the 24 train images at full
    size, as the README runs it), ``train_wandb --pruned`` for
    ``PRUNED_STEPS`` last-layer micro-steps, the ``pruned`` phase served,
    ``threshold_save`` at 0.1 on the group run's ``final-group`` and its
    ``th-`` checkpoint served, and ``eval_test`` of ``pruned`` on
    ``N_TEST`` test images."""
    from scaleprotoseg_torch import (eval_test, find_nearest, prune,
                                     run_pruning, train_wandb)
    from scaleprotoseg_torch.analysis import threshold_save
    run = os.path.join(tmp, "city_train")
    out = dict(artifacts=check_artifacts(run, trained["push"], artifacts,
                                         smi))

    # the scan's labels and distances, caught on their way to the pruning
    seen = {}
    nearest, find = find_nearest.nearest_patches, \
        prune.find_k_nearest_patches_to_prototypes

    def nearest_spy(*args, **kwargs):
        seen["top"] = nearest(*args, **kwargs)
        return seen["top"]

    def find_spy(*args, **kwargs):
        seen["labels"] = find(*args, **kwargs)
        return seen["labels"]

    find_nearest.nearest_patches = nearest_spy
    prune.find_k_nearest_patches_to_prototypes = find_spy
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        res = run_pruning.main(["scaleproto_cityscapes", "city_train",
                                "--data-root", data, "--results-root", tmp])
    finally:
        find_nearest.nearest_patches = nearest
        prune.find_k_nearest_patches_to_prototypes = find
    seconds = time.perf_counter() - t0
    if sum(kernels.launch_counts().values()):
        raise AssertionError("run_pruning launched a kernel: its scan is the "
                             "float32 plain forward")
    sd, meta = load_checkpoint(res["source"])
    spec = ProtoSpec.from_meta(meta["spec"])
    labels = seen["labels"]
    top_d = seen["top"][0]
    own_class = np.argmax(spec.class_identity, axis=1)
    own = (labels == own_class[:, None]).sum(1)
    kept = np.zeros(spec.num_prototypes, bool)
    kept[res["kept"]] = True
    if not ((own[kept] >= 3).all() and (own[~kept] < 3).all()):
        raise AssertionError("pruning kept a prototype with fewer than 3 "
                             "own-class patches, or pruned one with more")
    p = sd["prototype_vectors"].flatten(1).double()
    ratio = top_d[:, 0] / (1.0 + (p * p).sum(1).numpy())
    emptied = [c for c in range(spec.num_classes)
               if spec.class_counts[c] and not res["spec"].class_counts[c]]
    stats = dict(seconds=seconds, prototypes=spec.num_prototypes,
                 pruned=int((~kept).sum()), classes_emptied=emptied,
                 first_label_own_share=float((labels[:, 0] == own_class)
                                             .mean()),
                 own_labels_histogram=np.bincount(own, minlength=7).tolist(),
                 max_nearest_over_1_plus_p_sq=float(ratio.max()))
    log(f"pruning: run_pruning {json.dumps(stats)}; on {smi}")
    if not 0 < len(res["kept"]) or not ratio.max() <= 1e-5:
        raise AssertionError(f"pruning: kept {len(res['kept'])}, nearest "
                             f"patch {ratio.max():.3g} of (1 + |p|^2)")
    out["run_pruning"] = stats

    # the last-layer re-finetune of the pruned model
    argv = ["scaleproto_cityscapes", "city_train", "--pruned",
            "--gpu-recipe", "--data-root", data, "--results-root", tmp,
            "--gin", f"train.finetune_steps = {PRUNED_STEPS}"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ft = train_wandb.main(argv)
    phase = ft["phases"][2]
    want = PRUNED_STEPS + phase.validations * math.ceil(N_VAL / B)
    log(f"pruning: train_wandb --pruned took {time.perf_counter() - t0:.1f} "
        f"s; {phase.steps_done} micro-steps, {phase.validations} "
        f"validations; launches {phase.launches}; losses first "
        f"{phase.losses[0]:.4f} last {phase.losses[-1]:.4f}; "
        f"{phase.perf['img_per_s']} img/s, median step "
        f"{phase.perf['step_ms_median']} ms, device idle share "
        f"{phase.perf['device_idle_share']} over "
        f"{phase.perf['steps_timed']} steps past the first 3; batch {B} at "
        f"513 x 513, bf16 recipe, on {smi}")
    if phase.steps_done != PRUNED_STEPS or not all(
            math.isfinite(v) for v in phase.losses):
        raise AssertionError(f"pruned finetune: {phase.steps_done} steps, "
                             f"losses {phase.losses}")
    if phase.launches["aspp"] != want or phase.launches["aspp_grad_pack"] \
            or phase.launches["aspp_grad_weight"]:
        raise AssertionError(f"pruned finetune launches {phase.launches}, "
                             f"want K2 {want} and no backward")
    before, _ = load_checkpoint(res["pruned"])
    after, _ = load_checkpoint(ft["final"])
    moved = sorted(k for k in before if not torch.equal(before[k], after[k]))
    if moved != ["last_layer.weight"]:
        raise AssertionError(f"pruned finetune moved {moved}")
    out["finetune"] = dict(perf=phase.perf, launches=phase.launches,
                           validations=phase.validations)
    torch.cuda.empty_cache()
    out["serve_pruned"] = serve_checkpoint(tmp, "city_train", "pruned", dev,
                                           smi, "pruned")

    # the group model's pruning analog
    src, _ = load_checkpoint(os.path.join(tmp, "city_group", "checkpoints",
                                          "final-group"))
    th = threshold_save.main(["city_group", "final-group", "0.1",
                              "--results-root", tmp])
    thr, _ = load_checkpoint(th)
    zeroed = rows = 0
    for k, w in src.items():
        if not k.startswith("group_projection."):
            if not torch.equal(w, thr[k]):
                raise AssertionError(f"threshold_save changed {k}")
            continue
        low = w < 0.1
        if not (torch.equal(thr[k][~low], w[~low]) and
                bool((thr[k][low] == 0).all())):
            raise AssertionError(f"threshold_save: {k} re-normalised")
        zeroed += int((low & (w != 0)).sum())
        rows += w.shape[0]
    log(f"pruning: threshold_save zeroed {zeroed} group weights below 0.1 "
        f"over {rows} rows, the rest bit-equal (no row re-normalised); on "
        f"{smi}")
    out["threshold"] = dict(zeroed=zeroed, rows=rows)
    out["serve_th"] = serve_checkpoint(tmp, "city_group",
                                       "th-0.1-final-group", dev, smi, "th")

    # the test-split export of the pruned model
    test_dir = os.path.join(data, "img_with_margin_0", "test")
    os.makedirs(test_dir)
    rng = np.random.default_rng(8)
    names = [f"test_{i:03d}" for i in range(N_TEST)]
    for n in names:
        np.save(os.path.join(test_dir, n + ".npy"),
                rng.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out_dir = eval_test.main(["city_train", "pruned", str(B), "--data-root",
                              data, "--results-root", tmp])
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    batches = math.ceil(N_TEST / B)
    if any(counts[k] != batches for k in SERVING_KERNELS):
        raise AssertionError(f"eval_test launches {counts}, want {batches} "
                             "of K1, K2 and K3")
    lut = eval_test.train_id_to_source_lut()
    model, _ = load_model(run, os.path.join(run, "pruned", "checkpoints",
                                            "push_last.pth"),
                          dtype=torch.bfloat16, fast=False, device=dev)
    plain = plain_path(model)
    agree = 0
    for i in range(0, N_TEST, B):
        x = np.stack([np.load(os.path.join(test_dir, n + ".npy"))
                      for n in names[i:i + B]])
        want = lut[plain(torch.from_numpy(x).to(dev)).cpu().numpy()
                   .astype(np.int64) + 1]
        for j, n in enumerate(names[i:i + B]):
            png = read_png(os.path.join(out_dir, n + ".png"))
            if png.shape != (HEIGHT, WIDTH) or png.dtype != np.uint8 or \
                    not np.isin(png, lut[1:20]).all():
                raise AssertionError(f"eval_test: {n}.png {png.shape} "
                                     "outside the label ids")
            agree += int((png == want[j]).sum())
    agreement = agree / (N_TEST * HEIGHT * WIDTH)
    log(f"pruning: eval_test wrote {N_TEST} PNGs of {HEIGHT} x {WIDTH} in "
        f"{seconds:.2f} s ({seconds / N_TEST:.3f} s an image, the model load "
        f"included); launches {counts}; label ids agree with the plain path "
        f"on {100 * agreement:.4f}% of pixels; on {smi}")
    if agreement < 0.99:
        raise AssertionError(f"eval_test agreement {agreement} < 0.99")
    del model, plain
    torch.cuda.empty_cache()
    out["eval_test"] = dict(seconds=seconds, counts=counts,
                            agreement=agreement)

    # the pruned model on the val split
    kernels.reset_launch_counts()
    res = evm.run_evaluation("city_train", "pruned", batch_size=B,
                             data_root=data, results_root=tmp)
    counts = kernels.launch_counts()
    batches = math.ceil(N_VAL / B)
    samples = min(N_SAMPLES, N_VAL)
    check_samples(os.path.join(tmp, "city_train", "evaluation", "pruned"),
                  sorted(p[:-4] for p in os.listdir(os.path.join(
                      data, "annotations", "val")))[:samples])
    if not math.isfinite(res["mean_iou"]) or \
            counts["aspp"] != batches + samples or \
            counts["upsample"] != batches:
        raise AssertionError(f"eval of pruned: mIoU {res['mean_iou']}, "
                             f"launches {counts}")
    log(f"pruning: the pruned model on {N_VAL} val images: mIoU "
        f"{res['mean_iou']:.6f}, pixel acc {res['pixel_accuracy']:.6f}, "
        f"top-1 purity {res['top_k_purity_percent'][0]:.2f}%; launches "
        f"{counts}; on {smi}")
    out["eval_valid"] = dict(miou=res["mean_iou"], counts=counts)
    return out


def group_micro_step(model, batch, weights, dev) -> tuple:
    """(loss, group-projection gradient) of one group micro-step of
    ``model`` on ``batch``."""
    from scaleprotoseg_torch.train.steps import compute_losses
    model.zero_grad(set_to_none=True)
    for p in model.parameters():
        p.requires_grad_(False)
    for m in model.group_projection:
        m.weight.requires_grad_(True)
    x = torch.from_numpy(batch[0]).to(dev)
    t = torch.from_numpy(batch[1]).to(dev)
    loss, _ = compute_losses(model, model(x), t, weights)
    loss.backward()
    grad = torch.cat([m.weight.grad.flatten() for m in model.group_projection])
    return loss.item(), grad


def group_phase(tmp: str, data: str, start: str, batch, dev,
                smi: str) -> dict:
    """The group phase from the run's ``push_final`` through
    ``finetune_wandb_group.main --gpu-recipe``, then ``final-group``
    served through ``serve.main``."""
    from scaleprotoseg_torch import cli_common, finetune_wandb_group
    from scaleprotoseg_torch.train.optim import (PhaseOptimizer,
                                                 phase_groups, poly_schedule)
    from scaleprotoseg_torch.train.runner import module_hparams
    from scaleprotoseg_torch.train.state import TrainState
    from scaleprotoseg_torch.train.steps import make_train_step
    argv = ["group_scaleproto_cityscapes", "city_group", "--gpu-recipe",
            "--start-checkpoint", start, "--data-root", data,
            "--results-root", tmp]
    for line in (f"train.warmup_steps = {GROUP_WARMUP_STEPS}",
                 f"train.joint_steps = {GROUP_JOINT_STEPS}"):
        argv += ["--gin", line]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = finetune_wandb_group.main(argv)
    counts = kernels.launch_counts()
    log(f"group: main took {time.perf_counter() - t0:.1f} s; launches "
        f"{counts}")
    val_batches = math.ceil(N_VAL / B)
    for phase, steps in ((0, GROUP_WARMUP_STEPS), (1, GROUP_JOINT_STEPS)):
        res = out["phases"][phase]
        want = steps + res.validations * val_batches
        if res.steps_done != steps or len(res.losses) != steps or \
                not all(math.isfinite(v) for v in res.losses):
            raise AssertionError(f"group phase {phase}: {res.steps_done} "
                                 f"steps, losses {res.losses}")
        if res.launches["aspp"] != want:
            raise AssertionError(f"group phase {phase}: K2 launched "
                                 f"{res.launches['aspp']} times, want {want}")
        perf = res.perf
        log(f"group phase {phase}: {steps} micro-steps, {res.validations} "
            f"validations; launches {res.launches}; losses first "
            f"{res.losses[0]:.4f} last {res.losses[-1]:.4f}, all finite; "
            f"{perf['img_per_s']} img/s, median step "
            f"{perf['step_ms_median']} ms, device idle share "
            f"{perf['device_idle_share']}; on {smi}")
    if counts["aspp"] < 1:
        raise AssertionError("group phase: K2 never launched")
    sd, meta = load_checkpoint(out["final"])
    spec = ProtoSpec.from_meta(meta["spec"])
    rows = [v for k, v in sd.items() if k.startswith("group_projection.")]
    row_err = max(float((w.sum(-1) - 1.0).abs().max()) for w in rows)
    row_min = min(float(w.min()) for w in rows)
    if not (row_min >= 0 and row_err <= 1e-5):
        raise AssertionError(f"group rows off the simplex: min {row_min}, "
                             f"|sum - 1| {row_err}")
    log(f"group: final-group has {spec.num_prototypes} prototypes, "
        f"{sum(len(w) for w in rows)} group rows over {len(rows)} classes, "
        f"all >= 0, |sum - 1| <= {row_err:.3g}")

    # one group micro-step, kernel path against plain path
    run = os.path.join(tmp, "city_group")
    _, bindings = cli_common.load_config(os.path.join(run, "config.gin"))
    hp = module_hparams(bindings, "group")
    res = {}
    for fast in (False, True):
        model, _ = construct_ppnet(
            "group", "deeplabv2_resnet101_multiscale", num_classes=19,
            bindings=bindings, spec=spec)
        model.load_state_dict(sd, strict=True)
        model.set_compute_dtype(torch.bfloat16)
        model.features.base.aspp.fast = fast
        res[fast] = group_micro_step(model.to(dev), batch, hp["weights"], dev)
    (lk, gk), (lp, gp) = res[True], res[False]
    step_cmp = dict(loss_kernel=lk, loss_plain=lp, loss_abs_err=abs(lk - lp),
                    group_grad_rel_l2=((gk - gp).norm() / gp.norm()).item())
    log("group: one micro-step, kernel path vs plain path: "
        + json.dumps(step_cmp))
    # the loss within 1e-3 of its scale: at pushed prototypes the group
    # head's exp(activation) reaches 1e4 and the loss thousands, where a
    # float32 ulp alone is ~5e-4
    if not (step_cmp["loss_abs_err"] <= 1e-3 * max(1.0, abs(lp))
            and step_cmp["group_grad_rel_l2"] <= 2e-2):
        raise AssertionError(f"group kernel vs plain micro-step {step_cmp}")
    # where a group joint micro-step's time goes, on a resident batch
    opt = PhaseOptimizer(model.named_parameters(),
                         phase_groups("group", 1, hp["hp"]),
                         schedule=poly_schedule(hp["poly_lr_power"], 8),
                         iter_size=hp["iter_size"], guard_nonfinite=50)
    state = TrainState(model, opt)
    step = make_train_step(hp["weights"], project_group_simplex=True)
    x = torch.from_numpy(batch[0]).to(dev)
    t = torch.from_numpy(batch[1]).to(dev)
    profile = profile_batch(lambda: step(state, x, t), TRAINING_GROUPS,
                            iters=5)
    log("group phase 1: one micro-step on a resident batch, device ms by "
        f"kernel: {json.dumps(profile)}")
    del model, opt, state
    torch.cuda.empty_cache()
    served = serve_checkpoint(tmp, "city_group", "final-group", dev, smi,
                              "group")
    return dict(counts=counts, step_cmp=step_cmp, profile=profile,
                perf={p: out["phases"][p].perf for p in (0, 1)},
                serve=served)


def serve_checkpoint(tmp: str, run_name: str, phase: str, dev, smi: str,
                     tag: str) -> dict:
    """Phase ``phase`` of run ``run_name`` through ``serve.main`` in bf16 on
    ``N_GROUP_SERVE`` full-size images (K2, K1 and K3 on every batch), its
    labels against the plain path (>= 99% of pixels), and K1 at its bank
    and head: on random features against the plain head (rtol = atol =
    1e-4), on the served features (pushed prototypes, d ~ 0 there, where
    the activation's slope of -1e4 magnifies the fp32 rounding of every
    form) against the float64 head within ``PROTO_PUSHED_RTOL`` of its
    largest logit, as ``check_proto_rounding`` holds it."""
    from scaleprotoseg_torch.model_loading import resolve_checkpoint
    run = os.path.join(tmp, run_name)
    ckpt = resolve_checkpoint(run, phase)
    img_dir = os.path.join(tmp, "check_images")
    out_dir = os.path.join(tmp, f"labels_{tag}")
    names = [f"frame_{i:03d}.npy" for i in range(N_GROUP_SERVE)]
    if not os.path.isdir(img_dir):
        os.makedirs(img_dir)
        rng = np.random.default_rng(3)
        for n in names:
            np.save(os.path.join(img_dir, n),
                    rng.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8))
    kernels.reset_launch_counts()
    record = serve.main([run_name, phase, "--input", img_dir,
                         "--output", out_dir, "--batch", str(B),
                         "--raw-output", "--results-root", tmp,
                         "--workers", "4"])
    counts = kernels.launch_counts()
    batches = 1 + math.ceil(N_GROUP_SERVE / B)
    for name in SERVING_KERNELS:
        if counts[name] < batches:
            raise AssertionError(f"{tag}: {name} launched {counts[name]} "
                                 f"times in {batches} batches")
    plain_model, spec = load_model(run, ckpt, dtype=torch.bfloat16,
                                   fast=False, device=dev)
    plain = plain_path(plain_model)
    agree = total = 0
    classes = set()
    for i in range(0, N_GROUP_SERVE, B):
        x = np.stack([np.load(os.path.join(img_dir, n))
                      for n in names[i:i + B]])
        want = plain(torch.from_numpy(x).to(dev)).cpu().numpy()
        got = np.stack([np.load(os.path.join(out_dir, n))
                        for n in names[i:i + B]])
        agree += int((got == want).sum())
        total += got.size
        classes |= set(np.unique(got).tolist())
    agreement = agree / total
    log(f"{tag}: {phase} served {record['images']} images at "
        f"{record['img_per_s']} img/s (batch {B}, {HEIGHT}x{WIDTH}); "
        f"launches {counts}; labels agree with the plain path on "
        f"{100 * agreement:.4f}% of {total} pixels ({len(classes)} classes "
        f"predicted); on {smi}")
    if agreement < 0.99:
        raise AssertionError(f"{tag}: agreement {agreement} < 0.99")
    del plain_model, plain

    model, _ = load_model(run, ckpt, dtype=torch.bfloat16, fast=True,
                          device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.from_numpy(np.stack([np.load(os.path.join(img_dir, n))
                                   for n in names[:B]])).to(dev)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    with torch.no_grad():
        own = model.conv_features(((x.float() / 255.0 - mean) / std)
                                  .to(torch.bfloat16)).contiguous()
        protos = model.prototypes()
        kw = head_kw(model)
        head = pack_head(protos, spec=spec, **kw)
        feats = torch.rand(own.shape, generator=gen, device=dev) \
            .to(torch.bfloat16)
        got = kernels.fused_proto_logits(feats, protos, spec=spec, **kw,
                                         head=head)
        want = proto_plain(feats, protos, spec=spec, **kw)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        err = (got - want).abs().max().item()
        exact = proto_float64(own, protos, spec=spec, **kw)
        scale = exact.abs().max().item()
        pushed_err = (kernels.fused_proto_logits(
            own, protos, spec=spec, **kw, head=head) - exact).abs().max() \
            .item() / scale
        plain_err = (proto_plain(own, protos, spec=spec, **kw) - exact) \
            .abs().max().item() / scale
    log(f"{tag}: K1 at the bank ({spec.num_prototypes} prototypes, class "
        f"counts {sorted(set(spec.class_counts.tolist()))}, "
        f"{'group' if model.grouped else 'plain'} head): random features, "
        f"max |err| against the plain head {err:.3g} (rtol = atol = 1e-4); "
        f"the served features, max |err| against the float64 head over its "
        f"largest logit ({scale:.4g}): kernel {pushed_err:.3g}, fp32 plain "
        f"head {plain_err:.3g} (limit {PROTO_PUSHED_RTOL:g}); on {smi}")
    if not pushed_err <= PROTO_PUSHED_RTOL:
        raise AssertionError(f"{tag}: K1 {pushed_err:.3g} from the float64 "
                             "head")

    def k1():
        return kernels.fused_proto_logits(own, protos, spec=spec, **kw,
                                          head=head)

    k1_ms = time_ms(k1)
    log(f"{tag}: K1 at this bank, served features: {k1_ms:.4f} ms "
        f"(CUDA-event median of 10) on {smi}")
    del model
    torch.cuda.empty_cache()
    return dict(record, counts=counts, agreement=agreement,
                proto_max_abs_err=err, proto_pushed_err=pushed_err,
                proto_ms=k1_ms, prototypes=spec.num_prototypes)


def profile_train_steps(model, bindings, batch, dev) -> dict:
    """Where a micro-step's time goes, per phase, on a resident batch
    (no loader): the trainer's own step and phase optimizer, profiled."""
    from scaleprotoseg_torch.train.optim import (PhaseOptimizer,
                                                 phase_groups, poly_schedule)
    from scaleprotoseg_torch.train.runner import module_hparams
    from scaleprotoseg_torch.train.state import TrainState
    from scaleprotoseg_torch.train.steps import make_train_step
    hp = module_hparams(bindings, "multiscale")
    x = torch.from_numpy(batch[0]).to(dev)
    t = torch.from_numpy(batch[1]).to(dev)
    out = {}
    for phase in (0, 1):
        opt = PhaseOptimizer(
            model.named_parameters(),
            phase_groups("multiscale", phase, hp["hp"]),
            schedule=poly_schedule(hp["poly_lr_power"], 8),
            iter_size=hp["iter_size"], guard_nonfinite=50)
        state = TrainState(model, opt)
        step = make_train_step(hp["weights"])
        out[phase] = profile_batch(lambda: step(state, x, t),
                                   TRAINING_GROUPS, iters=5)
        log(f"train phase {phase}: one micro-step on a resident batch, "
            f"device ms by kernel: {json.dumps(out[phase])}")
    return out


def profile_batch(fn, groups=SERVING_GROUPS, top: int = 12,
                  iters: int = 3) -> dict:
    """Device ms per call by group (a kernel named in ``groups``, else
    convolution/GEMM kernels, batch norm, other elementwise kernels, the
    rest), the ``top`` kernels by time, the host-clock ms per call of an
    unprofiled run (``wall_ms``), the share of it the card is busy, and
    the device operations (kernels and copies) per call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    sums = dict.fromkeys(groups, 0.0)
    per_kernel = []
    calls = 0
    for evt in prof.key_averages():
        calls += evt.count
        ms = _device_us(evt) / 1e3 / iters
        key = evt.key
        sums[kernel_group(key, groups)] += ms
        per_kernel.append((ms, evt.count // iters, key[:90]))
    per_kernel.sort(reverse=True)
    out = {k: round(v, 4) for k, v in sums.items()}
    device = sum(sums.values())
    out.update(device_ms=round(device, 4), wall_ms=round(wall, 4),
               busy_share=round(device / wall, 4),
               kernels_per_call=calls / iters)
    out["top"] = [[round(ms, 4), n, key] for ms, n, key in per_kernel[:top]]
    return out


def main() -> None:
    smi = device_phase()
    log(smi)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase()

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for check in (check_aspp, check_aspp_backward, check_proto,
                  check_upsample, check_int8_mm, check_int8_conv3x3,
                  check_quantize):
        out = check(gen, dev)
        for r in out if isinstance(out, list) else [out]:
            results[r["name"]] = r
        torch.cuda.empty_cache()
    log("kernel device ms per call (profiler): " + json.dumps(
        {name: r["device_ms"] for name, r in results.items()}))

    served = serving_phase(dev, smi)
    torch.cuda.empty_cache()
    trained = training_phase(dev, smi)
    quant, evals = served["quant"], served["evals"]
    group, pruning = trained["group"], trained["pruning"]
    single, resume = trained["single"], trained["resume"]
    data_run = trained["data"]["trainers"]
    art = served["artifact"]["counts"]
    by_path = {name: {"serving": served["counts"][name],
                      "quant8_serving": quant["counts"][name],
                      "artifact_serving": art["bf16"][name],
                      "artifact_quant8": art["quant8"][name],
                      "quant8_dynamic": quant["dyn_counts"][name],
                      "eval": evals[False]["counts"][name],
                      "eval_quant8": evals["static"]["counts"][name],
                      "training": trained["counts"][name],
                      "group_training": group["counts"][name],
                      "group_serving": group["serve"]["counts"][name],
                      "pruned_finetune":
                          pruning["finetune"]["launches"][name],
                      "pruned_serving":
                          pruning["serve_pruned"]["counts"][name],
                      "threshold_serving": pruning["serve_th"]["counts"][name],
                      "eval_test": pruning["eval_test"]["counts"][name],
                      "pruned_eval": pruning["eval_valid"]["counts"][name],
                      "single_training": single["counts"][name],
                      "single_serving": single["serve"]["counts"][name],
                      "resumed_training": resume["launches"][name],
                      "data_training": data_run["launches"][name],
                      **{f"knob_{k}": r["launches"][name]
                         for k, r in trained["knobs"]["runs"].items()}}
               for name in results}
    # each kernel's launches in the main path of its slice: the training
    # run for K2's forward and backward, the bf16 serving run for K1 and
    # K3, the static quant8 serving run for the int8 kernels and the
    # dynamic one for its max reduction
    path = {**{k: trained for k in TRAINING_KERNELS},
            **{k: served for k in ("proto", "upsample")}}
    launches = {name: path[name]["counts"][name] if name in path
                else quant["dyn_counts"][name] if name == "int8_absmax"
                else quant["counts"][name] for name in results}
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} never launched on its main path")
    for r in results.values():
        lib = "null" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f}"
        log(f"{r['name']}: kernel_ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {lib} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) launches "
            f"{by_path[r['name']]} max_abs_err {r['max_abs_err']:.3g} "
            f"on {smi}")
    for name, old in EARLIER_DESIGN.items():
        r = results[name]
        log(f"{name}: earlier design on NVIDIA H100 80GB HBM3, 700 W "
            f"{json.dumps(old)}; now kernel_ms {r['ms']:.4f} device_ms "
            f"{r['device_ms']}"
            + (" path_ms_per_batch " + json.dumps(
                {k: round(v, 4) for k, v in r["path_ms_per_batch"].items()})
               if "path_ms_per_batch" in r else ""))

    line = {"kernels": [dict(
        name=r["name"], status="ported", route="cuda",
        source=f"scaleprotoseg_torch/csrc/{SOURCES[r['name']]}.cu",
        replaces=REPLACES[r["name"]], launches=launches[r["name"]],
        launches_by_path=by_path[r["name"]],
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"])
        for r in results.values()] + [dict(
            name=k["name"], status="still to port", route=None, source=None,
            replaces=k["replaces"], launches=0, max_abs_err=None, ms=None,
            plain_ms=None, bound_ms=None, bound_by=None, library_ms=None)
            for k in STILL_TO_PORT]}
    log(smi)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
