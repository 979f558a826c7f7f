#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py coco-push-artifacts   # the push artifact pass at
                                                # COCO's 2184 prototypes, timed

Phases; any failure exits non-zero and prints no result (the total
seconds are printed before the kernels line):

1. device: torch / CUDA versions and the card's name and power limit;
2. build: every kernel from ``scaleprotoseg_torch/csrc``, one ``nvcc``
   per source, all started together, and beside them the image decoders
   (``native/codecs.cc``, g++), its seconds printed;
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
   flagship, 160 seeded uint8 1024 x 2048 images) served three times
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
   quant8 over the 160 images, the plain one over the first 8), printing
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
   prototypes, d ~ 0) against the float64 head within ``pushed_bound``
   (the inputs' conditioning times fp32 rounding, at most 2e-2 of its
   largest logit at Cityscapes' 19 classes).  Then the pruning slice on
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
   full depth through ``train_wandb.train`` with the GPU recipe, without
   ``--pruned``, on the same data: 10 warm-up, 10 joint and 5 last-layer
   micro-steps around push (without its artifact pass), K2's forward and backward launched exactly as
   the phases imply (the last layer: the forward alone), losses finite,
   img/s, step ms and idle share per phase; its ``push_final`` served as
   ``final-group`` is (K1, K2 and K3 on every batch, labels against the
   plain path, K1 at the pushed bank).  Then resume after SIGTERM: the
   baseline's joint phase at ResNet-50 depth, as every trainer process
   of this and the data phase runs it (20 micro-steps, ``iter_size`` 5, a
   validation every 5, ``det_seed`` bound) through the trainer CLI in
   processes of its own, twice straight (the two must agree bit for bit).
   The training data path, on the same data root: first, before
   the flagship's trainer, the native augmentation (``native/fastaug.cc``)
   built with g++ (a failed build fails the script) and held bit for bit
   against the numpy pipeline on 32 training items (the 513 x 513 window,
   scales 0.5-1.5, ``det_seed`` draws), the median ms an item of each; the
   train loader alone (8 workers, batch 2, one untimed epoch and two
   timed) as threads + numpy, threads + native, processes + native,
   processes + jitter and threads + jitter: img/s and the first batch's
   seconds, every pair of streams with the same items bit-equal over the
   three epochs and after a ``fast_forward``. Then, after the resume phase,
   the same joint phase through the trainer CLI: jittered on threads
   straight; jittered on worker processes (``loader_backend =
   'grain_processes'``), stopped by SIGTERM to its process group once the
   first validation's state has committed (exit 143, the state committed
   at the step it stopped, its loader workers gone) and relaunched (exit
   0, the state restored at that step); unjittered on threads with numpy
   augmentation (``SPS_NATIVE_AUG=0``), against the resume phase's second
   straight run (the same command with native items). The relaunch on
   processes ends on the bits of the straight run on threads, the numpy
   run on the native one's (each checkpoint and metrics row); K2's
   kernels launch in every run; the state's MB, the blocking snapshot's
   host ms, the commit and restore seconds, and img/s, step ms and idle
   share of each run are printed. Then the
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
6. the Pascal VOC-2012 slice (the MSC input pyramid): K2's forward and
   backward at the pyramid's six maps at C = 2048 (batch 2 at 41 x 41, 21
   x 21, 31 x 31 of a 321 crop; batch 1 at 65 x 65, 33 x 33, 49 x 49 of
   the 513 eval input) as at the training shape, K1 at Pascal's group bank
   (252 prototypes, 21 classes, 4 scales of 63, 3 groups) and the
   baseline's (210, 1 scale) against the plain head and the float64 one
   at pushed prototypes, K3 from 65 x 65 x 21 to Pascal's image sizes;
   a synthetic Pascal root (16 train_aug, 8 train, 8 val, 4 test images
   of 500 x 375 and the like, raw ids in class blocks with void borders)
   and a seeded torchvision-layout ResNet-101 ``.pth`` written from its
   key list; ``scaleproto_pascal`` trained through
   ``train_wandb_multiscale.main --gpu-recipe`` with
   ``PRETRAINED_BACKBONE`` at that file (every converted tensor loaded,
   the frozen BN statistics the file's): 10 warm-up, 10 joint, push, 5
   last-layer micro-steps, K2 launched 3 times a micro-step and a
   validation batch (forward, pack and weight gradient in the first two
   phases), losses finite, img/s, step ms and idle share per phase; the
   TensorBoard event directory, or its disabled line; one MSC micro-step
   of the kernel path against the plain path (loss within 1e-3,
   gradients within 2e-2 relative L2, K2's weights packed once for the
   three maps); ``group_scaleproto_pascal`` from that ``push_final`` (5 +
   5 micro-steps); ``run_evaluation`` with Pascal's protocol over the 8
   val images (confusion matrix equal to a host bincount, labels >= 99%
   equal to the plain path, K3's plans built printed), ``eval_test
   --pascal`` over the 4 test images (label ids >= 99% equal to the plain
   path) and ``final-group`` served in bf16 on 8 images of 513 x 513 as
   the other checkpoints are;
7. the MSC model in int8 and as an artifact (Pascal's ``final-group`` of
   phase 6, full depth): ``int8_mm`` and ``int8_conv3x3`` at layer4/5's
   shapes on the pyramid's smallest map (1 x 33 x 33) against their plain
   versions (int32 bit for bit, dequantized bf16 within 1 ulp); 16 images
   of 513 x 513 served through ``serve.main`` in bf16, with
   ``--quant8-static --calib-images 8`` and with ``--quant8`` (launches a
   batch exact: each of the three maps runs layer4/5's 54 / 26 / 80 int8
   launches, static K2 once a map and K1 and K3 once, dynamic none of
   K1-K3), the static labels >= 99% equal to the plain quant8 path, their
   agreement with bf16 reported; ``run_evaluation`` with Pascal's protocol
   in static quant8; then the bf16 fast, static quant8 fast and
   ``--dynamic-batch`` plain artifacts written by ``serve.main --export``
   (export, save seconds, MB, the program's nodes and frame) and served by
   ``serve.main --artifact`` in a fresh interpreter (load seconds, img/s
   beside the run dir's, launches, labels >= 99.99% equal to the run-dir
   serve's, no model module imported), and the host ms to enqueue a batch
   at five call depths through ``predict`` and through the module alone;
8. COCO-Stuff at full width (182 classes, ResNet-101): K1 at its banks
   (2184 over 4 scales and over 1, 2054 with 2052 active grouped and
   plain; its packed chunks, steps and passes) against the plain head
   and the float64 one at pushed prototypes, K3 at 182 classes from
   COCO's grids to its sizes and to 321 and 513; a synthetic COCO-Stuff
   root (20 train, 8 val images of 480 x 640 and the like, final labels
   0-182 in class blocks); ``baseline_coco`` (the multiscale model)
   through ``train_wandb_multiscale.train --gpu-recipe`` at batch 10 on
   321 crops, without the push artifacts (6 warm-up, 8 joint, push, 5
   last-layer micro-steps; K2's forward, pack and weight gradient 3 times
   a micro-step); a micro-step of the kernel path against the plain path;
   ``group_scaleproto_coco`` from its ``push_final`` (5 + 5); 6 joint
   micro-steps of ``scaleproto_coco`` (the single-scale model) through
   ``train_wandb.main``; ``run_evaluation`` of ``final-group`` at batch 1
   over the 8 val images and ``final-group`` served on 8 images of 480 x
   640, each >= 99.9% equal to the plain path;
9. ADE20K at full width (150 classes, 1800 prototypes, ResNet-101): K2
   at the 512 crop (batch 2, 65 x 65) and at the 512 x 704 eval input's
   grid (65 x 89), forward and backward; K1 at its bank (plain over 4
   scales and 1, grouped) against the plain head and the float64 one at
   pushed prototypes, device ms beside the plain head's; K3 at 150
   classes from the eval grids to ADE's sizes beside ``F.interpolate`` +
   ``argmax``; a synthetic ADE20K root (16 train, 8 val images of 512 x
   683, 683 x 512, 512 x 512, 384 x 512, 768 x 1024 and 1024 x 1536,
   final labels 0-150 in class blocks framed by void); ``scaleproto_ade``
   through ``train_wandb_multiscale.train --gpu-recipe`` at batch 2 on 512
   crops (6 warm-up, 8 joint, push at batch 1 without the artifact pass,
   5 last-layer micro-steps); a micro-step of the kernel path against the
   plain path; ``group_scaleproto_ade`` from its ``push_final`` (5 + 5);
   6 joint micro-steps of ``baseline_ade`` through ``train_wandb.main``;
   ``run_evaluation`` of ``final-group`` with the short-side-512 protocol
   at the multiple of 64 and at 0 (labels equal to the plain path's on
   >= 99% of pixels and on >= 99.9% of those decided beyond the
   upsample's fp32 rounding, the K3 plans built and their host cost);
   ``final-group`` served through ``serve.main --canvas 683 683`` on 8
   images of mixed sizes (>= 99% of pixels, >= 99.9% of those decided
   beyond the fp32 rounding of the head and the upsample, K1 at the
   pushed bank);
10. EM / ISBI-2012 at full width (UNet-ASPP of base 64, 2 classes, 512 x
   512 frames and crops, trainable BatchNorm): K1 on EM's grid (2 x 512 x
   512 pixels) at ``scaleproto_em``'s 24 / 2 / 4 bank, its group head and
   ``baseline_em``'s 20 / 2 / 1 against the plain head and the float64 one
   at pushed prototypes, beside the plain head and the matmul chain; K3
   at 2 classes from 512 x 512 to 512 x 512 beside ``F.interpolate`` +
   ``argmax``; a synthetic EM root (20 train, 10 val frames of 512 x 512,
   grayscale stored as RGB, labels 1 membrane / 2 cell in Voronoi cells);
   ``scaleproto_em`` through ``train_wandb_multiscale.train --gpu-recipe``
   (20 joint micro-steps at batch 2, push at full width without the
   artifact pass, 5 last-layer), every BN's running statistics moved and
   finite and its affine parameters bit-equal to their init; the card's
   float32 micro-step against the CPU's (loss, gradients, running
   statistics); ``group_scaleproto_em`` from its ``push_final`` (10 joint
   micro-steps: the backbone frozen, its statistics moving);
   ``baseline_em`` (6 joint, frozen BN); ``run_evaluation`` of
   ``final-group`` over the 10 val frames and ``serve.main`` of it at
   batch 2 on them (labels against the plain path); ``serve
   --quant8-static`` refused by name; K2 launched 0 times on the EM path
   (64 ASPP input channels: the shifted-matmul form);
11. the preprocessing slice, on a machine without PIL: the committed
   fixtures (``tests/torch_fixtures/codecs``: JPEGs at Pascal's, COCO's,
   ADE20K's and EM's sizes, baseline 4:2:0 and 4:4:4, gray, progressive;
   a PIL-filtered PNG, a palette PNG, an LZW TIFF) decoded by
   ``codecs`` to the SHA-256 of PIL's decode in their manifest; raw
   trees of every dataset at its own size (Cityscapes PNGs at 2048 x
   1024, each scanline filtered with one of the five filters by this
   script's own encoder; Pascal, ADE20K and COCO from the JPEG fixtures
   with label PNGs, one the palette fixture; the ISBI stacks, 30 frames
   of 512 x 512, and 32-bit panoptic-parts TIFFs, by a minimal TIFF
   writer here); the eight CLIs (``python -m
   scaleprotoseg_torch.data.preprocess_*``, ``img_to_numpy``, the part
   decoders) in fresh interpreters, 128 jobs to a pooled CLI at n_jobs 8
   (two chunks of 8 a worker; images/s each, on the wall clock and by the
   CLI's own closing line), every output against its raw source (labels through their tables, EM's
   seeded split); host ms per decode at the datasets' sizes; then the
   preprocessed Cityscapes root on the card: 3 joint micro-steps of the
   flagship group model on its train split through the port's dataset
   (K2's forward and backward on each) and ``run_evaluation`` of its val
   images (K2, K3); and ``serve.main`` of raw ``.png`` / ``.jpg`` inputs
   (K2, K1, K3) without ``--raw-output`` (``--canvas 1024 2048``), its PNG
   labels read back by ``imageio.read_png`` equal to the serve of the
   ``.npy`` mirrors the CLIs wrote;
12. one line per kernel with its times, bound and launches, for the six
   kernels since redesigned the earlier design's recorded times beside
   the new ones, the card's name and power limit, the kernels
   line (every kernel with its status),
   then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from scaleprotoseg_torch import codecs
from scaleprotoseg_torch import eval_valid_multiscale as evm
from scaleprotoseg_torch import kernels
from scaleprotoseg_torch.checkpoints.convert import (load_checkpoint,
                                                     save_checkpoint,
                                                     synthetic_state_dict)
from scaleprotoseg_torch.configlib import parse_config
from scaleprotoseg_torch.constants import (CITYSCAPES_19_EVAL_CATEGORIES,
                                           IMAGENET_MEAN, IMAGENET_STD)
from scaleprotoseg_torch.data import preprocess
from scaleprotoseg_torch.data.panoptic_parts_lite import decode_uids
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
from scaleprotoseg_torch.kernels.proto import (OPEN, distance_error,
                                               logit_rounding,
                                               rounding_bound,
                                               pack_head, proto_float64,
                                               proto_plain)
from scaleprotoseg_torch.kernels.upsample import (fused_upsample_argmax,
                                                  interp_taps,
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
N_IMAGES = 160                # ~3 s of serving per run at ~50 img/s
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
# the resume and data phases' trainer processes run the baseline at
# ResNet-50 depth (the widths kept): six processes, each paying its
# start-up, the model's build and its states' writes.  The data phase's
# unjittered native run on threads is the resume phase's second straight
# run (the same command), and the SIGTERM'd run on worker processes,
# relaunched, is held against the straight run on threads.
TRAINER_DEPTH = ("construct_PPNet.base_architecture = 'deeplabv2_resnet50'",
                 "deeplabv2_resnet50_features.deeplab_n_features = 64")
RESUME_TIMEOUT_S = 300
KNOB_STEPS, KNOB_PROFILE_STEPS = 10, 5   # the knobs phase's joint runs
KNOB_RUNS = {"recipe": [], "fast_gradconv": ["train.fast_gradconv = True"],
             "remat": ["train.remat = True"],
             "profiled": [f"train.profile_steps = {KNOB_PROFILE_STEPS}"],
             "recipe_again": []}   # the spread of the runs, in turns
GRADCONV_SHAPES = {"layer4": (256, 2), "layer5": (512, 4)}  # channels, d
N_FASTAUG = 32                # native vs numpy items at the training crop
LOADER_EPOCHS = 2             # timed epochs of each loader configuration
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

# K1 against the float64 head (``proto_float64``).  On the sparse probe
# (features and prototypes non-zero on four coordinates a scale, so that the
# cross term's error is the distance's) the largest distance error, in units
# of fp32 rounding of its terms (``distance_error``): read on an H100, the
# kernel 1.45-1.51, the fp32 plain head 1.41-1.51, two pieces 29.6.  At
# pushed prototypes (every prototype a pixel's features, d = 0 there) the
# activation's slope, -1e4, magnifies that rounding once for each prototype
# that sits near a pixel.  ``kernels.proto.rounding_bound`` carries a
# distance error of ``PROTO_DISTANCE_ERR`` units through the slope, the
# group projection, its exp and the last layer to a first-order bound on
# the largest logit error over the largest float64 logit (PERF.md section
# 3): the conditioning of the inputs times fp32 rounding.  ``pushed_bound``
# holds K1 to it at every bank, and Cityscapes' 19-class banks also to
# ``PROTO_PUSHED_RTOL``, their bound before.  Readings on an H100
# (``tools/proto_pushed_error.py``): on 442 pixels at 2054 / 182 (~5
# prototypes a pixel) the plain head 0.003-0.025, K1 0.012-0.025, the bound
# 0.054-0.11; at Cityscapes' 228 / 19 K1 0.007-0.0096, the bound 0.027-0.043;
# at 2054 / 182 on COCO's 61 x 81 grid K1 reached 0.0208, past 2e-2, with
# the plain head at 0.0179.
PROTO_PUSHED_RTOL = 2e-2
PROTO_PUSHED_SEEDS = 5
PROTO_DISTANCE_ERR = 3.0


def pushed_bound(feats, protos, last, spec, kw) -> float:
    """K1's largest allowed error against the float64 head at pushed
    prototypes (over the largest float64 logit): ``rounding_bound`` of
    these inputs at ``PROTO_DISTANCE_ERR`` units; for Cityscapes' 19
    classes at most ``PROTO_PUSHED_RTOL``."""
    bound = rounding_bound(feats, protos, last, spec, **kw,
                           units=PROTO_DISTANCE_ERR)
    return min(bound, PROTO_PUSHED_RTOL) if spec.num_classes == 19 \
        else bound

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
    """The CUDA sources with nvcc and, beside them, the image decoders
    (``native/codecs.cc``) with g++."""
    t0 = time.perf_counter()
    codec_build = {}

    def build_codecs():
        t = time.perf_counter()
        try:
            codecs.load_library()
        except Exception as e:  # raised below, in the main thread
            codec_build["error"] = e
        codec_build["seconds"] = time.perf_counter() - t

    thread = threading.Thread(target=build_codecs)
    thread.start()
    report = kernels.build()
    thread.join()
    if "error" in codec_build:
        raise codec_build["error"]
    for name, r in report.items():
        ptxas = [ln.strip() for ln in r["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"build {name}: {r['seconds']:.1f} s  " + " | ".join(ptxas))
    log(f"build codecs.cc (g++, the image decoders): "
        f"{codec_build['seconds']:.1f} s")
    log(f"build: {time.perf_counter() - t0:.1f} s wall")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def aspp_case(gen, dev, h: int, w: int, c: int = 2048, b: int = B):
    """Seeded K2 inputs at (b, h, w, c) -> 4 x 64, the kernel held against
    the plain form (2 bf16 ulps) and against its own second run (the same
    bits).  Returns (x, ws, bs, packed, got, max_abs_err)."""
    f, rates = 64, RATES
    x = torch.rand((b, h, w, c), generator=gen, device=dev) \
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


def check_proto_rounding(gen, dev, feats, spec, kw, last=None) -> list:
    """K1 and the fp32 plain head against the float64 head: at pushed
    prototypes (the group head ``kw`` of ``check_proto``, or the plain
    last layer ``last``) on ``PROTO_PUSHED_SEEDS`` draws (``feats`` and
    new features of its shape), K1 held to ``pushed_bound``; and the
    distance error on the sparse probe under an identity plain head (the
    logits are the activations).  Returns (kernel, plain, bound) a draw."""
    n = feats.shape[0] * feats.shape[1] * feats.shape[2]
    rows = []
    for draw in range(PROTO_PUSHED_SEEDS):
        if draw:
            feats = torch.rand(feats.shape, generator=gen, device=dev) \
                .to(torch.bfloat16)
        # dangling rows (past the scales' bounds) stay zero
        pushed = torch.zeros((spec.num_prototypes, 64), device=dev)
        at = torch.randint(0, n, (spec.num_prototypes,), generator=gen,
                           device=dev)
        flat = feats.reshape(n, -1)
        for s, (lo, hi) in enumerate(spec.scale_bounds):
            pushed[lo:hi] = flat[at[lo:hi], s * 64:(s + 1) * 64].float()
        want = proto_float64(feats, pushed, last, spec, **kw)
        scale = want.abs().max().item()
        got = kernels.fused_proto_logits(feats, pushed, last, spec, **kw)
        err = (got - want).abs().max().item() / scale
        plain = (proto_plain(feats, pushed, last, spec, **kw) - want).abs() \
            .max().item() / scale
        rows.append((err, plain, pushed_bound(feats, pushed, last, spec, kw)))
        if not err <= rows[-1][2]:
            raise AssertionError(f"proto: {err:.3g} from the float64 head at "
                                 f"pushed prototypes (bound {rows[-1][2]:.3g}"
                                 f", plain head {plain:.3g})")
    log(f"proto at pushed prototypes ({spec.num_prototypes} / "
        f"{spec.num_classes} on {n} pixels, at most "
        f"{int(torch.bincount(at).max())} on a pixel), max |err| against the "
        f"float64 head over its largest logit, (kernel, fp32 plain head, "
        f"bound) for {PROTO_PUSHED_SEEDS} draws: "
        f"{[tuple(round(v, 5) for v in r) for r in rows]}")
    return rows

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


def aspp_backward_case(gen, dev, b: int, h: int, w: int, c: int = 2048):
    """K2's backward kernels on seeded (b, h, w, c) bf16 inputs: the pack
    bit for bit, dW within 1e-3 of the fp32 plain product and the same
    bits twice, and the whole Function backward against autograd through
    the plain form (dx within 2 bf16 ulps, dW and db within 1e-3 of their
    scale).  Returns the inputs, the packed gradient, dW and the errors."""
    f = 64
    x = torch.rand((b, h, w, c), generator=gen, device=dev) \
        .to(torch.bfloat16)
    std = math.sqrt(2.0 / (9 * c))
    ws = [torch.randn((3, 3, c, f), generator=gen, device=dev) * std
          for _ in RATES]
    bs = [torch.randn((f,), generator=gen, device=dev) * 0.1 for _ in RATES]
    g = torch.randn((b, h, w, len(RATES) * f), generator=gen,
                    device=dev).to(torch.bfloat16)
    x2d = x.reshape(-1, c)

    shape = f"{b}x{h}x{w}x{c}"
    packed_g = kernels.aspp_grad_pack(g, RATES, f)
    if not torch.equal(packed_g, grad_pack_plain(g, RATES, f)):
        raise AssertionError(f"aspp_grad_pack {shape} differs from the "
                             "plain pack")
    # as the backward calls it: the zero rows of G skipped, one partial
    # per image
    dw = kernels.aspp_grad_weight(x, packed_g, RATES)
    dw_plain = grad_weight_plain(x2d, packed_g)
    torch.testing.assert_close(dw, dw_plain, rtol=1e-3, atol=1e-3)
    if not torch.equal(dw, kernels.aspp_grad_weight(x, packed_g, RATES)):
        raise AssertionError(f"aspp_grad_weight {shape} is not "
                             "deterministic")
    dw_err = (dw - dw_plain).abs().max().item()

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
        raise AssertionError(f"aspp backward {shape} dx: {ulps} bf16 ulps")
    rel = []
    for a, w_ in zip(got[1:], want[1:]):
        scale = w_.abs().max().item()
        torch.testing.assert_close(a, w_, rtol=1e-3, atol=1e-3 * scale)
        rel.append((a - w_).abs().max().item() / scale)
    return dict(x=x, ws=ws, bs=bs, g=g, packed_g=packed_g, dw=dw,
                dw_err=dw_err, dw_rel=dw_err / dw_plain.abs().max().item(),
                dx_ulps=ulps, wb_rel=max(rel))


def check_aspp_backward(gen, dev) -> list:
    """K2's backward kernels at the training shapes (batch 2, 65 x 65 x
    2048 bf16), held by ``aspp_backward_case``, then timed beside cuDNN
    and one GEMM of the same product."""
    c, f = 2048, 64
    case = aspp_backward_case(gen, dev, B, TH, TW, c)
    x, ws, bs, g = case["x"], case["ws"], case["bs"], case["g"]
    packed_g, dw, dw_err = case["packed_g"], case["dw"], case["dw_err"]
    x2d = x.reshape(-1, c)
    log(f"aspp_grad_weight: max_abs_err {dw_err:.3g} against the fp32 "
        f"product, {case['dw_rel']:.3g} of dW's scale; same bits twice")
    log(f"aspp backward: dx within {case['dx_ulps']:g} bf16 ulps, dW/db "
        f"within {case['wb_rel']:.3g} of their scale, of autograd through "
        "the plain form")

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


def plain_labels(model):
    """``fn(xn, h, w)`` for normalized batches (in the dtype the path under
    test hands its model: the MSC pyramid resizes that input): the labels
    of the fast path at (h, w) with every kernel replaced by its plain
    version (K2 by
    ``aspp_plain``, the float32-accumulated ASPP rounded to bf16 as the
    kernel rounds its output; K1 by ``proto_plain``; K3 by
    ``upsample_argmax_plain``; the int8 kernels by ``static_int8_conv`` /
    ``dynamic_int8_conv``); ``fn.logits(xn)``: the logits before K3's
    plain version."""
    base = model.features.base
    base.aspp.fast = False
    base.aspp.register_forward_hook(
        lambda m, i, out: out.to(torch.bfloat16).float())
    for _, m in quant_sites(model):
        m.plain = True

    @torch.inference_mode()
    def logits(xn: torch.Tensor) -> torch.Tensor:
        feats = model.conv_features(xn).contiguous()
        return proto_plain(feats, model.prototypes(), spec=model.spec,
                           **head_kw(model))

    def fn(xn: torch.Tensor, h: int, w: int) -> torch.Tensor:
        return upsample_argmax_plain(logits(xn), h, w)

    fn.logits = logits
    return fn


# a label is decided where its top-two margin exceeds this many units of
# the upsample's fp32 rounding (``decided_labels``)
UPSAMPLE_ROUNDING_UNITS = 8


@torch.inference_mode()
def decided_labels(logits: torch.Tensor, h: int, w: int,
                   head_err=None) -> torch.Tensor:
    """(B, h, w) bool: where the labels of the bilinear upsample of
    ``logits`` (B, h0, w0, C) to (h, w) are decided beyond fp32 rounding:
    the top-two margin of the upsampled logits at least
    ``UPSAMPLE_ROUNDING_UNITS`` x 2^-24 x the largest |logit| among the
    pixel's source taps (any class), plus twice the largest ``head_err``
    (B, h0, w0: the head's own rounding bound, ``logit_rounding``) among
    them.  Two orders of the same fp32 sums (K3 and its plain version, K1
    and its plain head) may break a tie below that apart: a model whose
    logits span +-2e6 (a saturated group head) leaves margins of ~0.25 to
    the upsample's rounding alone."""
    b, h0, w0, _ = logits.shape
    dev = logits.device
    my = torch.as_tensor(_bilinear_matrix(h, h0), device=dev)
    mx = torch.as_tensor(_bilinear_matrix(w, w0), device=dev)
    up = torch.einsum("oh,bhpc->bopc", my,
                      torch.einsum("bhwc,pw->bhpc", logits.float(), mx))
    top2 = torch.topk(up, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    del up, top2
    iy = torch.as_tensor(interp_taps(h, h0)[0], device=dev).long()
    ix = torch.as_tensor(interp_taps(w, w0)[0], device=dev).long()

    def tap_max(v):
        rows = torch.maximum(v[:, iy[:, 0]], v[:, iy[:, 1]])
        return torch.maximum(rows[:, :, ix[:, 0]], rows[:, :, ix[:, 1]])

    limit = UPSAMPLE_ROUNDING_UNITS * 2.0 ** -24 * tap_max(
        logits.abs().amax(-1).float())
    if head_err is not None:
        limit = limit + 2 * tap_max(head_err.float())
    return margin >= limit


def plain_path(model):
    """``fn(x)`` for raw uint8 batches: ``plain_labels`` after the serving
    path's normalization (float32, then bf16), at the input's size."""
    labels = plain_labels(model)
    dev = next(model.parameters()).device
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)

    def fn(x: torch.Tensor) -> torch.Tensor:
        return labels(((x.float() / 255.0 - mean) / std)
                      .to(torch.bfloat16), x.shape[1], x.shape[2])

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
    160 images, the plain one over the first 8), their labels against the
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
        arts[name]["frame"] = program_frame(path)
        log(f"artifact {name}: serve --export {cli_s:.2f} s (export_serving "
            f"{arts[name]['export_s']:.2f} s, save_artifact "
            f"{arts[name]['save_s']:.2f} s), {mb:.1f} MB {arts[name]['files']}"
            f"; input {meta['input']}; program "
            f"{json.dumps(arts[name]['frame'])}; on {smi}")
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
    ``train_wandb.train`` without ``--pruned``: warm-up and joint with K2's
    forward and backward, push (without its artifact pass), the last layer
    with K2's forward alone; ``push_final`` served like ``final-group``."""
    from scaleprotoseg_torch import train_wandb
    gin = [f"train.warmup_steps = {SINGLE_STEPS[0]}",
           f"train.joint_steps = {SINGLE_STEPS[1]}",
           f"train.finetune_steps = {SINGLE_STEPS[2]}",
           f"Trainer.val_check_interval = {SINGLE_VAL_EVERY}"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    # push without its artifact pass (~30 s; the flagship's run writes
    # and checks the artifacts)
    out = train_wandb.train("baseline_cityscapes", "city_single",
                            data_root=data, gin_overrides=gin,
                            gpu_recipe=True, results_root=tmp,
                            push_artifacts=False)
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
                 "PatchClassificationDataset.det_seed = 11", *TRAINER_DEPTH,
                 *gin):
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
    """The baseline's joint phase at ResNet-50 depth (``RESUME_STEPS``
    micro-steps, ``iter_size`` 5, a validation every
    ``RESUME_VAL_EVERY``, ``det_seed`` bound) through the trainer CLI in
    processes of its own, twice straight: the two runs must agree bit for
    bit (else the relaunches of ``data_trainer_phase`` are held within
    their difference).  The stop by SIGTERM and the relaunch run on the
    worker-process loader in ``data_trainer_phase``."""
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
    return dict(straight_repeat=repeat,
                bitwise=not any(repeat.values()) and rows_repeat,
                native_run=b, native_perf=_phase_perf(runs["straight_b"]),
                native_launches=_phase_launches(runs["straight_b"]))


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
    """The baseline's joint phase at ResNet-50 depth (the resume phase's
    ``RESUME_STEPS`` micro-steps, a validation every ``RESUME_VAL_EVERY``,
    ``det_seed``) through the trainer CLI: jittered on threads straight;
    jittered on worker processes, stopped by SIGTERM to its process group
    once the first validation's state has committed (exit 143, the state
    committed at the step it stopped, no loader worker left) and relaunched
    (exit 0, the state restored at that step); unjittered on threads with
    numpy items, against the resume phase's second straight run (the same
    command, native items).  The relaunch on processes must end on the
    bits of the straight run on threads (every checkpoint and metrics row:
    so the processes' stream is the threads' and the relaunch the straight
    run), the numpy run on the native run's (or, where the resume phase
    found that two straight runs do not repeat, within their difference).
    The state's MB, the blocking snapshot's host ms, the commit and restore
    seconds are printed."""
    results = os.path.join(tmp, "data")
    os.makedirs(results)
    procs = ["PatchClassificationDataModule.loader_backend = "
             "'grain_processes'"]
    jitter = ["PatchClassificationDataset.jitter = True"]
    perf = {"threads_native": resume["native_perf"]}
    launches = {"threads_native": resume["native_launches"]}

    def straight(name, gin, env=None):
        rc, text, secs, *_ = _run_trainer(data, results, name, env=env,
                                          gin=gin)
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

    straight("threads_jitter", jitter)
    # SIGTERM once the first validation's state has committed, which
    # happens in the background while the next micro-steps run
    state_dir = os.path.join(results, "killed", "checkpoints", "nopush_state")
    first_val = f"step {RESUME_VAL_EVERY}/{RESUME_STEPS} "
    rc, text, secs, workers, left = _run_trainer(
        data, results, "killed", gin=procs + jitter,
        stop_when=lambda out: first_val in out and
        os.path.exists(os.path.join(state_dir, "meta.json")))
    stopped = [int(ln.split("PREEMPTED at step ")[1].split(":")[0])
               for ln in text.splitlines() if "PREEMPTED at step " in ln]
    if rc != 143 or not stopped or not workers or left:
        raise AssertionError(f"data: the SIGTERM'd run exited {rc}, "
                             f"stopped {stopped}, workers {workers}, left "
                             f"alive {left}:\n" + text[-3000:])
    saved = _logged(text, "train state saved: ")[-1]
    with open(os.path.join(state_dir, "meta.json")) as f:
        meta = json.load(f)
    if meta["step"] != stopped[0] or saved["step"] != stopped[0] or \
            stopped[0] <= RESUME_VAL_EVERY:
        raise AssertionError(f"data: stopped at {stopped}, state "
                             f"{meta['step']}")
    log(f"resume: SIGTERM to the trainer's process group after the state of "
        f"step {RESUME_VAL_EVERY} committed: exit 143 in {secs:.1f} s, "
        f"stopped at micro-step {stopped[0]} (accumulation {stopped[0] % 5} "
        f"of 5); its {len(workers)} loader workers, none left; state "
        f"{saved['bytes'] / 1e6:.1f} MB, blocking snapshot "
        f"{saved['snapshot_ms']:.1f} ms host time in the step loop, commit "
        f"{saved['commit_s']:.2f} s; on {smi}")
    text = straight("killed", procs + jitter)
    restored = _logged(text, "train state restored: ")
    if not restored or restored[0]["step"] != stopped[0]:
        raise AssertionError(f"data: the relaunch restored {restored}")
    log(f"resume: relaunch restored step {restored[0]['step']} in "
        f"{restored[0]['seconds']:.2f} s; its last async save "
        f"{json.dumps(_logged(text, 'train state saved: ')[-1])}")
    straight("threads_numpy", [], env={"SPS_NATIVE_AUG": "0"})
    runs = {n: os.path.join(results, n) for n in perf}
    runs["threads_native"] = resume["native_run"]
    diffs = {}
    for a, b in (("threads_jitter", "killed"),
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
    for name in ("threads_jitter", "killed"):
        for k in TRAINING_KERNELS:
            if launches[name][k] < 1:
                raise AssertionError(f"data: {k} not launched in {name}")
    return dict(perf=perf, launches=launches["threads_jitter"],
                relaunch_launches=launches["killed"], diffs=diffs,
                stopped=stopped[0], workers=len(workers), saved=saved,
                restored=restored[0])


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
                     tag: str, size=(HEIGHT, WIDTH), sizes=None, frames=None,
                     uses=SERVING_KERNELS) -> dict:
    """Phase ``phase`` of run ``run_name`` through ``serve.main`` in bf16 on
    ``N_GROUP_SERVE`` images of ``size`` (or the ``.npy`` frames of size
    ``size`` in the directory ``frames``; the kernels ``uses`` on every
    batch), or
    with ``sizes`` on images of those sizes through ``--canvas`` ``size``
    (host-normalized, padded with the mean, each prediction cropped back),
    its labels against the plain path (>= 99% of pixels), and K1 at its bank
    and head: on random features against the plain head (rtol = atol =
    1e-4), on the served features (pushed prototypes, d ~ 0 there, where
    the activation's slope of -1e4 magnifies the fp32 rounding of every
    form) against the float64 head within ``pushed_bound``, as
    ``check_proto_rounding`` holds it."""
    from scaleprotoseg_torch.model_loading import resolve_checkpoint
    run = os.path.join(tmp, run_name)
    ckpt = resolve_checkpoint(run, phase)
    out_dir = os.path.join(tmp, f"labels_{tag}")
    if frames:
        img_dir, names = frames, sorted(os.listdir(frames))
        shapes = [size] * len(names)
    else:
        shapes = sizes or [size] * N_GROUP_SERVE
        img_dir = os.path.join(tmp, "check_images_{}x{}".format(*size)
                               + ("_canvas" if sizes else ""))
        names = [f"frame_{i:03d}.npy" for i in range(len(shapes))]
    if not os.path.isdir(img_dir):
        os.makedirs(img_dir)
        rng = np.random.default_rng(3)
        for n, shape in zip(names, shapes):
            np.save(os.path.join(img_dir, n),
                    rng.integers(0, 256, (*shape, 3), dtype=np.uint8))
    canvas = ["--canvas", str(size[0]), str(size[1])] if sizes else []
    kernels.reset_launch_counts()
    record = serve.main([run_name, phase, "--input", img_dir,
                         "--output", out_dir, "--batch", str(B),
                         "--raw-output", "--results-root", tmp,
                         "--workers", "4", *canvas])
    counts = kernels.launch_counts()
    batches = 1 + math.ceil(len(names) / B)
    for name in uses:
        if counts[name] < batches:
            raise AssertionError(f"{tag}: {name} launched {counts[name]} "
                                 f"times in {batches} batches")
    plain_model, spec = load_model(run, ckpt, dtype=torch.bfloat16,
                                   fast=False, device=dev)
    # the serving path's plain version: device-normalized uint8, or under
    # the canvas host-normalized, padded images
    plain = plain_labels(plain_model)
    padded = serve._make_preprocess(img_dir, canvas=size)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    agree = total = decided_agree = decided = 0
    classes = set()
    for i in range(0, len(names), B):
        if sizes:
            xn = torch.from_numpy(np.stack([padded(n) for n in
                                            names[i:i + B]])).to(dev)
        else:
            x = torch.from_numpy(np.stack([np.load(os.path.join(img_dir, n))
                                           for n in names[i:i + B]])).to(dev)
            xn = (x.float() / 255.0 - mean) / std
        xn = xn.to(torch.bfloat16)
        lg = plain.logits(xn)
        with torch.inference_mode():
            kw = head_kw(plain_model)
            head_err = logit_rounding(
                plain_model.conv_features(xn), plain_model.prototypes(),
                kw.pop("last_layer"), spec, **kw,
                units=PROTO_DISTANCE_ERR)[0].amax(-1)
        full = upsample_argmax_plain(lg, *size).cpu().numpy()
        sure = decided_labels(lg, *size, head_err).cpu().numpy()
        del head_err
        for n, f, d, (h, w) in zip(names[i:i + B], full, sure,
                                   shapes[i:i + B]):
            got = np.load(os.path.join(out_dir, n))
            if got.shape != (h, w):
                raise AssertionError(f"{tag}: {n} labels {got.shape}, want "
                                     f"{(h, w)}")
            same = got == f[:h, :w]
            agree += int(same.sum())
            total += got.size
            decided_agree += int(same[d[:h, :w]].sum())
            decided += int(d[:h, :w].sum())
            classes |= set(np.unique(got).tolist())
    agreement = agree / total
    decided_agreement = decided_agree / max(decided, 1)   # 0: none decided
    where = f"--canvas {size[0]} {size[1]} over {sorted(set(shapes))}" \
        if sizes else f"{size[0]}x{size[1]}"
    log(f"{tag}: {phase} served {record['images']} images at "
        f"{record['img_per_s']} img/s (batch {B}, {where}); "
        f"launches {counts}; labels agree with the plain path on "
        f"{100 * agreement:.4f}% of {total} pixels ({len(classes)} classes "
        f"predicted), on {100 * decided_agreement:.4f}% of the "
        f"{100 * decided / total:.3f}% decided beyond the fp32 rounding of "
        f"the head and the upsample; on {smi}")
    if agreement < 0.99:
        raise AssertionError(f"{tag}: agreement {agreement} < 0.99")
    del plain_model, plain

    model, _ = load_model(run, ckpt, dtype=torch.bfloat16, fast=True,
                          device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    xn = torch.from_numpy(np.stack([padded(n) for n in names[:B]])).to(dev)
    with torch.no_grad():
        own = model.conv_features(xn.to(torch.bfloat16)).contiguous()
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
        bound = pushed_bound(own, protos, kw["last_layer"], spec, {
            k: v for k, v in kw.items() if k != "last_layer"})
    log(f"{tag}: K1 at the bank ({spec.num_prototypes} prototypes, class "
        f"counts {sorted(set(spec.class_counts.tolist()))}, "
        f"{'group' if model.grouped else 'plain'} head): random features, "
        f"max |err| against the plain head {err:.3g} (rtol = atol = 1e-4); "
        f"the served features, max |err| against the float64 head over its "
        f"largest logit ({scale:.4g}): kernel {pushed_err:.3g}, fp32 plain "
        f"head {plain_err:.3g} (limit {bound:.3g}); on {smi}")
    if not pushed_err <= bound:
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
                decided_agreement=decided_agreement,
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


# ---------------------------------------------------------------------------
# the Pascal VOC-2012 slice: the MSC pyramid, a pretrained backbone read
# from disk, the TensorBoard sink
# ---------------------------------------------------------------------------
PASCAL_SIZES = [(375, 500), (500, 375), (333, 500), (500, 333), (375, 500),
                (366, 500), (500, 400), (281, 500)]
PASCAL_SPLITS = {"train_aug": 16, "train": 8, "val": N_EVAL, "test": N_TEST}
PASCAL_STEPS = (10, 10, 5)            # warm-up, joint, last layer
PASCAL_GROUP_STEPS = (5, 5)
PASCAL_VAL_EVERY = 10
PASCAL_CROP, PASCAL_EVAL = 321, 513
# the pyramid's backbone grids (the stem's ceil-mode pool): base, 0.5,
# 0.75 of a 321 crop at batch 2; of the 513 eval input at batch 1
PYRAMID_SHAPES = ((B, 41, 41), (B, 21, 21), (B, 31, 31),
                  (1, 65, 65), (1, 33, 33), (1, 49, 49))
PASCAL_PREDICTED = 3                  # K2 launches a map of a micro-step


def write_pascal_root(root: str, seed: int) -> str:
    """Pascal's preprocessed layout at Pascal's image sizes: uint8 images
    and raw-id labels (0-20, 255 void) in a seeded grid of class blocks
    with a void border of 4 pixels, each block a seeded colour of its
    class plus noise of +-40; ``train`` is the first images of
    ``train_aug``, ``test`` has images only."""
    rng = np.random.default_rng(seed)
    palette = rng.integers(40, 216, (256, 3)).astype(np.int16)
    index = {}
    for split, n in PASCAL_SPLITS.items():
        src = "train_aug" if split == "train" else split
        img_dir = os.path.join(root, "img_with_margin_0", split)
        ann_dir = os.path.join(root, "annotations", split)
        os.makedirs(img_dir)
        os.makedirs(ann_dir)
        index[split] = [f"{src}_{i:03d}" for i in range(n)]
        if split == "train":
            for name in index[split]:
                for d in ("img_with_margin_0", "annotations"):
                    os.link(os.path.join(root, d, src, name + ".npy"),
                            os.path.join(root, d, split, name + ".npy"))
            continue
        for i, name in enumerate(index[split]):
            h, w = PASCAL_SIZES[i % len(PASCAL_SIZES)]
            grid = rng.integers(0, 21, (3, 4)).astype(np.uint8)
            label = np.ascontiguousarray(np.repeat(np.repeat(
                grid, -(-h // 3), 0), -(-w // 4), 1)[:h, :w])
            label[:4], label[-4:], label[:, :4], label[:, -4:] = 255, 255, \
                255, 255
            noise = rng.integers(-40, 41, (h, w, 3), dtype=np.int16)
            np.save(os.path.join(img_dir, name + ".npy"),
                    np.clip(palette[label] + noise, 0, 255).astype(np.uint8))
            if split != "test":
                np.save(os.path.join(ann_dir, name + ".npy"), label)
    with open(os.path.join(root, "all_images.json"), "w") as f:
        json.dump(index, f)
    return root


RESNET101_LAYERS = ((3, 64), (4, 128), (23, 256), (3, 512))  # n, planes


def torchvision_resnet101_keys():
    """(key, shape) of a torchvision ResNet-101 state dict, in its order:
    the stem, layer1-4 of 3 / 4 / 23 / 3 bottlenecks (the first of each
    with its downsample), the classifier."""
    def bn(name, c):
        return [(f"{name}.{k}", (c,)) for k in
                ("weight", "bias", "running_mean", "running_var")] + \
            [(f"{name}.num_batches_tracked", ())]

    keys = [("conv1.weight", (64, 3, 7, 7))] + bn("bn1", 64)
    cin = 64
    for layer, (n, planes) in enumerate(RESNET101_LAYERS, 1):
        for block in range(n):
            pre = f"layer{layer}.{block}"
            keys += [(f"{pre}.conv1.weight", (planes, cin, 1, 1))] + \
                bn(f"{pre}.bn1", planes) + \
                [(f"{pre}.conv2.weight", (planes, planes, 3, 3))] + \
                bn(f"{pre}.bn2", planes) + \
                [(f"{pre}.conv3.weight", (4 * planes, planes, 1, 1))] + \
                bn(f"{pre}.bn3", 4 * planes)
            if block == 0:
                keys += [(f"{pre}.downsample.0.weight",
                          (4 * planes, cin, 1, 1))] + \
                    bn(f"{pre}.downsample.1", 4 * planes)
            cin = 4 * planes
    return keys + [("fc.weight", (1000, 2048)), ("fc.bias", (1000,))]


def write_torchvision_resnet101(path: str, seed: int) -> dict:
    """A seeded torchvision-layout ResNet-101 ``.pth`` built from the key
    list (He-scaled kernels, the last BN of each residual branch at 0.1 so
    activations stay bounded at full depth, running variances in [0.9,
    1.1]); returns the state dict."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in torchvision_resnet101_keys():
        if key.endswith("num_batches_tracked"):
            v = np.asarray(1000, np.int64)
        elif key.endswith("running_var"):
            v = rng.uniform(0.9, 1.1, shape)
        elif key.endswith(("running_mean", "bias")):
            v = np.zeros(shape)
        elif key.endswith("bn3.weight"):
            v = np.full(shape, 0.1)
        elif len(shape) == 1:          # the other BN weights
            v = 1.0 + 0.01 * rng.standard_normal(shape)
        else:
            v = rng.standard_normal(shape) * math.sqrt(
                2.0 / np.prod(shape[1:]))
        sd[key] = torch.from_numpy(np.asarray(
            v, np.int64 if v.dtype == np.int64 else np.float32))
    torch.save(sd, path)
    return sd


def check_aspp_pyramid(gen, dev, smi: str, shapes=PYRAMID_SHAPES,
                       tag: str = "pascal: K2 at the pyramid's maps") -> dict:
    """K2's forward and backward at ``shapes`` (the pyramid's six maps by
    default; C = 2048):
    forward within 2 bf16 ulps of the plain form and the same bits twice;
    the backward pair and the Function's backward as ``aspp_backward_case``
    holds them.  The forward's wrapper ms and device ms at each (CUDA
    events around calls queued behind a device sleep: the profiler's short
    sessions late in this long process have come back empty)."""
    out = {}
    for b, h, w in shapes:
        x, ws, bs, packed, _, err = aspp_case(gen, dev, h, w, b=b)

        def fwd():
            return kernels.fused_aspp(x, ws, bs, RATES, packed)

        fwd_ms, fwd_device_ms = time_ms(fwd), queued_device_ms(fwd)
        del x, ws, bs, packed, fwd
        case = aspp_backward_case(gen, dev, b, h, w)
        out[f"{b}x{h}x{w}"] = dict(
            forward_max_abs_err=err, forward_ms=fwd_ms,
            forward_device_ms=fwd_device_ms,
            dw_rel=case["dw_rel"], dx_ulps=case["dx_ulps"],
            dw_db_rel=case["wb_rel"])
        del case
    log(f"{tag} (C = 2048; batch x rows x cols), forward within 2 bf16 ulps, "
        "pack bit-exact, dW within 1e-3, the Function's backward against "
        f"autograd: {json.dumps(out)} on {smi}")
    return out


def check_proto_pascal(gen, dev, smi: str) -> dict:
    """K1 at Pascal's banks on random features of the 513 eval grid (65 x
    65, batch 1): the group head (252 prototypes, 21 classes, 4 scales of
    63, 3 groups) and the baseline's plain head (210 prototypes, 1
    scale), each against its plain version (rtol = atol = 1e-4) and at
    pushed prototypes against the float64 head (``check_proto_rounding``)."""
    out = {}
    for name, spec in (("group", ProtoSpec.equal_allocation(
            252, 64, num_classes=21, num_scales=4, num_groups=3)),
            ("single", ProtoSpec.equal_allocation(
                210, 64, num_classes=21, num_scales=1))):
        c, d = spec.num_classes, spec.feature_depth
        feats = torch.rand((1, 65, 65, d), generator=gen, device=dev) \
            .to(torch.bfloat16)
        protos = torch.rand((spec.num_prototypes, 64), generator=gen,
                            device=dev)
        if spec.num_groups:
            gw = torch.rand((c, 3, spec.max_protos_per_class),
                            generator=gen, device=dev) + 1e-3
            kw = dict(group_projection=gw / gw.sum(-1, keepdim=True),
                      last_layer_group=torch.randn(
                          (c * 3, c), generator=gen, device=dev) *
                      math.sqrt(2.0 / (c * 3)))
            last = None
        else:
            kw = {}
            last = torch.randn((spec.num_prototypes, c), generator=gen,
                               device=dev) * 0.5
        # packed once, as the model packs its head once
        head = pack_head(protos, last, spec, **kw)
        got = kernels.fused_proto_logits(feats, protos, last, spec, **kw,
                                         head=head)
        want = proto_plain(feats, protos, last, spec, **kw)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        check_proto_rounding(gen, dev, feats, spec, kw, last)
        out[name] = dict(prototypes=spec.num_prototypes,
                         max_abs_err=(got - want).abs().max().item(),
                         ms=time_ms(lambda: kernels.fused_proto_logits(
                             feats, protos, last, spec, **kw, head=head)),
                         plain_ms=time_ms(lambda: proto_plain(
                             feats, protos, last, spec, **kw)))
    log(f"pascal: K1 at the group bank 252 / 21 / 4 x 63 / 3 and the "
        f"baseline bank 210 / 21 / 1 on 1 x 65 x 65 features, against the "
        f"plain head (rtol = atol = 1e-4; ms: CUDA-event medians of 10): "
        f"{json.dumps(out)} on {smi}")
    return out


def check_upsample_pascal(gen, dev) -> dict:
    """K3 from the 513 eval grid (65 x 65 x 21 logits) to Pascal's
    annotation sizes: labels equal to the plain version's wherever its
    top-two margin is >= 1e-5."""
    out = {}
    lg = torch.randn((1, 65, 65, 21), generator=gen, device=dev)
    for h, w in sorted(set(PASCAL_SIZES)):
        got = kernels.fused_upsample_argmax(lg, h, w)
        want = upsample_argmax_plain(lg, h, w)
        up = torch.einsum("oh,bhpc->bopc", torch.as_tensor(
            _bilinear_matrix(h, 65), device=dev), torch.einsum(
            "bhwc,pw->bhpc", lg, torch.as_tensor(_bilinear_matrix(w, 65),
                                                 device=dev)))
        top2 = torch.topk(up, 2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) >= 1e-5
        diff = got.int() != want.int()
        if int((diff & decided).sum()):
            raise AssertionError(f"upsample to {h} x {w}: "
                                 f"{int((diff & decided).sum())} decided "
                                 "labels differ")
        out[f"{h}x{w}"] = int(diff.sum())
    log(f"pascal: K3 from 65 x 65 x 21 to Pascal's sizes, labels that differ "
        f"from the plain version (none where the margin is >= 1e-5): "
        f"{json.dumps(out)}")
    return out


def pascal_step_check(bindings, stem: str, batch, dev) -> dict:
    """One MSC micro-step from ``stem``, kernel path against plain
    (``kernel_vs_plain_step``), K2's launches in the kernel path's step
    and the times its packed weights were built (once: the three maps of
    one weight version share them)."""
    from scaleprotoseg_torch.models import deeplab
    packs = []
    pack = deeplab.ASPP._pack

    def counted(self):
        packs.append(1)
        return pack(self)

    deeplab.ASPP._pack = counted
    try:
        kernels.reset_launch_counts()
        step_cmp, model = kernel_vs_plain_step(bindings, stem, batch, dev)
        counts = kernels.launch_counts()
    finally:
        deeplab.ASPP._pack = pack
    step_cmp.update(launches={k: counts[k] for k in TRAINING_KERNELS},
                    packs=len(packs))
    del model
    torch.cuda.empty_cache()
    return step_cmp


def pascal_phase(tmp: str, dev, smi: str) -> dict:
    """The Pascal VOC-2012 slice at full depth and the published widths:
    kernel checks at the pyramid's shapes and Pascal's banks and sizes;
    ``scaleproto_pascal`` trained through ``train_wandb_multiscale.main
    --gpu-recipe`` from a synthetic torchvision ResNet-101 file
    (``PRETRAINED_BACKBONE``), pushed and finetuned; the group phase of
    ``group_scaleproto_pascal``; ``run_evaluation`` with Pascal's protocol,
    ``eval_test --pascal`` and the served ``final-group``, each against the
    plain path; the TensorBoard sink or its disabled line."""
    from scaleprotoseg_torch import (cli_common, eval_test,
                                     finetune_wandb_group,
                                     train_wandb_multiscale)
    from scaleprotoseg_torch.kernels import upsample as kup
    from scaleprotoseg_torch.checkpoints.pretrained import \
        torchvision_resnet_to_backbone
    gen = torch.Generator(device=dev).manual_seed(14)
    out = dict(aspp=check_aspp_pyramid(gen, dev, smi),
               proto=check_proto_pascal(gen, dev, smi),
               upsample=check_upsample_pascal(gen, dev))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    data = write_pascal_root(os.path.join(tmp, "pascal"), seed=14)
    pth = os.path.join(tmp, "resnet101_torchvision.pth")
    tv = write_torchvision_resnet101(pth, seed=15)
    log(f"pascal: {PASCAL_SPLITS} images of Pascal sizes and a "
        f"{os.path.getsize(pth) / 2**20:.1f} MB torchvision-layout "
        f"ResNet-101 ({len(tv)} tensors) written in "
        f"{time.perf_counter() - t0:.1f} s on the host of {smi}")

    # the prototype phase from the pretrained file
    os.environ["PRETRAINED_BACKBONE"] = pth
    gin = [f"train.warmup_steps = {PASCAL_STEPS[0]}",
           f"train.joint_steps = {PASCAL_STEPS[1]}",
           f"train.finetune_steps = {PASCAL_STEPS[2]}",
           f"Trainer.val_check_interval = {PASCAL_VAL_EVERY}"]
    argv = ["scaleproto_pascal", "pascal_train", "--gpu-recipe",
            "--data-root", data, "--results-root", tmp]
    for line in gin:
        argv += ["--gin", line]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        trained = train_wandb_multiscale.main(argv)
    finally:
        del os.environ["PRETRAINED_BACKBONE"]
    counts = kernels.launch_counts()
    log(f"pascal train: main took {time.perf_counter() - t0:.1f} s; "
        f"launches {counts}; on {smi}")
    run = os.path.join(tmp, "pascal_train")
    with open(os.path.join(run, "train.log")) as f:
        train_log = f.read()
    n_tensors = len(torchvision_resnet_to_backbone(tv))
    loaded = f"({n_tensors} of {n_tensors} tensors)"
    if f"Loaded pretrained backbone weights from {pth} {loaded}" \
            not in train_log:
        raise AssertionError(f"pascal: the trainer did not load {pth} "
                             f"{loaded}")
    final_sd, _ = load_checkpoint(trained["final"])
    last = RESNET101_LAYERS[2][0]       # layer3's last bottleneck
    for tv_key, key in (("bn1.running_var", "layer1.conv1.bn.running_var"),
                        (f"layer3.{last - 1}.bn2.running_var",
                         f"layer4.block{last}.conv3x3.bn.running_var")):
        if not torch.equal(final_sd["features.base." + key], tv[tv_key]):
            raise AssertionError(f"pascal: push_final's {key} is not the "
                                 "file's (frozen BN statistics)")
    log(f"pascal: PRETRAINED_BACKBONE loaded {loaded}; push_final's frozen "
        "BN statistics are the file's")

    val_batches = math.ceil(PASCAL_SPLITS["val"] / B)
    perf = {}
    for phase, steps in enumerate(PASCAL_STEPS):
        res = trained["phases"][phase]
        bwd = 0 if phase == 2 else 3 * steps
        want = {"aspp": 3 * (steps + res.validations * val_batches),
                "aspp_grad_pack": bwd, "aspp_grad_weight": bwd}
        if res.steps_done != steps or len(res.losses) != steps or \
                not all(math.isfinite(v) for v in res.losses):
            raise AssertionError(f"pascal phase {phase}: {res.steps_done} "
                                 f"steps, losses {res.losses}")
        if res.launches != {**res.launches, **want}:
            raise AssertionError(f"pascal phase {phase}: launches "
                                 f"{res.launches}, want {want}")
        perf[phase] = p = res.perf
        log(f"pascal train phase {phase}: {steps} micro-steps, "
            f"{res.validations} validations; launches {res.launches} (K2 a "
            f"micro-step: {(res.launches['aspp'] - 3 * res.validations * val_batches) / steps:g} "
            f"forward, {res.launches['aspp_grad_pack'] / steps:g} pack, "
            f"{res.launches['aspp_grad_weight'] / steps:g} weight gradient); "
            f"losses first {res.losses[0]:.4f} last {res.losses[-1]:.4f}, "
            f"all finite; {p['img_per_s']} img/s, median step "
            f"{p['step_ms_median']} ms, device idle share "
            f"{p['device_idle_share']} over {p['steps_timed']} steps past "
            f"the first 3, peak {p['peak_memory_mb']} MB; batch {B} at "
            f"{PASCAL_CROP} x {PASCAL_CROP} with the pyramid, full depth, "
            f"bf16 recipe, on {smi}")
    push = trained["push"]
    out["push"] = dict(prototypes=int(push.winners.shape[0]),
                       matched=int((push.winners >= 0).sum()),
                       pruned=int(push.winners.shape[0] -
                                  push.kept.shape[0]))
    log("pascal push: " + json.dumps(out["push"]))

    # TensorBoard: the event directory where it imports, else one line
    try:
        from torch.utils import tensorboard  # noqa: F401
        tb = os.path.join(run, "logs", "tb")
        if not os.listdir(tb):
            raise AssertionError(f"pascal: {tb} holds no event file")
        out["tensorboard"] = f"events in {tb}"
    except ImportError as e:
        if "TensorBoard logging disabled" not in train_log:
            raise AssertionError("pascal: no TensorBoard sink and no "
                                 "disabled line") from e
        out["tensorboard"] = next(
            ln for ln in train_log.splitlines()
            if "TensorBoard logging disabled" in ln).split("] ", 1)[-1]
    log(f"pascal: TensorBoard: {out['tensorboard']}")

    # one MSC micro-step, kernel path against plain path
    _, bindings = cli_common.load_config(os.path.join(run, "config.gin"))
    batch = next(iter(cli_common.make_loaders(bindings, B, seed=5,
                                              data_root=data)[0]))
    step_cmp = pascal_step_check(bindings, os.path.join(
        run, "checkpoints", "nopush_last"), batch, dev)
    log("pascal: one MSC micro-step, kernel path vs plain path: "
        + json.dumps(step_cmp) + f" on {smi}")
    if not (step_cmp["loss_abs_err"] <= 1e-3
            and step_cmp["aspp_grad_rel_l2"] <= 2e-2
            and step_cmp["proto_grad_rel_l2"] <= 2e-2
            and step_cmp["launches"] == dict.fromkeys(TRAINING_KERNELS, 3)
            and step_cmp["packs"] == 1):
        raise AssertionError(f"pascal kernel vs plain micro-step {step_cmp}")
    out["step_cmp"] = step_cmp

    # the group phase
    argv = ["group_scaleproto_pascal", "pascal_group", "--gpu-recipe",
            "--start-checkpoint", trained["final"], "--data-root", data,
            "--results-root", tmp]
    for line in (f"train.warmup_steps = {PASCAL_GROUP_STEPS[0]}",
                 f"train.joint_steps = {PASCAL_GROUP_STEPS[1]}",
                 f"Trainer.val_check_interval = {PASCAL_GROUP_STEPS[0]}"):
        argv += ["--gin", line]
    kernels.reset_launch_counts()
    group = finetune_wandb_group.main(argv)
    group_counts = kernels.launch_counts()
    for phase, steps in enumerate(PASCAL_GROUP_STEPS):
        res = group["phases"][phase]
        want = 3 * (steps + res.validations * val_batches)
        if res.steps_done != steps or \
                not all(math.isfinite(v) for v in res.losses) or \
                res.launches["aspp"] != want:
            raise AssertionError(f"pascal group phase {phase}: "
                                 f"{res.steps_done} steps, K2 "
                                 f"{res.launches['aspp']} (want {want})")
        p = res.perf
        log(f"pascal group phase {phase}: {steps} micro-steps; launches "
            f"{res.launches}; losses first {res.losses[0]:.4f} last "
            f"{res.losses[-1]:.4f}, all finite; {p['img_per_s']} img/s, "
            f"median step {p['step_ms_median']} ms, device idle share "
            f"{p['device_idle_share']}; on {smi}")
    grun = os.path.join(tmp, "pascal_group")

    # evaluation with Pascal's protocol, kernel path against plain path
    names = sorted(p[:-4] for p in os.listdir(
        os.path.join(data, "annotations", "val")))
    kup.plan.cache_clear()          # count the plans this evaluation builds
    kernels.reset_launch_counts()
    evm.SegEvaluator = RecordingEvaluator
    t0 = time.perf_counter()
    try:
        res = evm.run_evaluation("pascal_group", "final-group",
                                 batch_size=B, data_type="pascal",
                                 data_root=data, results_root=tmp)
    finally:
        evm.SegEvaluator = SegEvaluator
    secs = time.perf_counter() - t0
    eval_counts = kernels.launch_counts()
    plans = kup.plan.cache_info().misses
    ev = RecordingEvaluator.last
    model, _ = load_model(grun, os.path.join(grun, "checkpoints",
                                             "final-group.pth"),
                          dtype=torch.bfloat16, fast=False, device=dev)
    plain = plain_labels(model)

    @torch.inference_mode()
    def plain_eval(xn, h, w):
        """The evaluation's own forward (the model's head, not K1) with K2
        and K3 replaced by their plain versions."""
        logits = model(xn).logits
        return upsample_argmax_plain(logits.float().contiguous(), h, w)

    agree = total = 0
    cm = np.zeros((21, 21), np.int64)
    sizes = set()
    for name, pred in zip(names, (p_ for batch_ in ev.preds
                                  for p_ in batch_)):
        img = np.load(os.path.join(data, "img_with_margin_0", "val",
                                   name + ".npy"))
        ann = eval_targets(np.load(os.path.join(
            data, "annotations", "val", name + ".npy")), "pascal")
        sizes.add(ann.shape)
        x = torch.from_numpy(evm.prepare_image(img, "pascal"))[None].to(dev)
        want = plain_eval(x, *ann.shape)[0].cpu().numpy()
        agree += int((pred == want).sum())
        total += pred.size
        t = ann.astype(np.int64) - 1
        valid = t >= 0
        cm += np.bincount(t[valid] * 21 + pred[valid],
                          minlength=21 * 21).reshape(21, 21)
    if not np.array_equal(ev.cm, cm):
        raise AssertionError("pascal eval: confusion matrix differs from "
                             "the host bincount")
    agreement = agree / total
    batches = len(ev.preds)
    want = {"upsample": batches, "aspp": 3 * (batches + N_SAMPLES)}
    if eval_counts != {**eval_counts, **want}:
        raise AssertionError(f"pascal eval: launches {eval_counts}, want "
                             f"{want}")
    log(f"pascal eval: mIoU {res['mean_iou']:.6f}, pixel acc "
        f"{res['pixel_accuracy']:.6f}, {len(names) / secs:.3f} img/s "
        f"({len(names)} images in {batches} batches at {PASCAL_EVAL} x "
        f"{PASCAL_EVAL}, the load and sample renders included); confusion "
        f"matrix equal to the host bincount; labels agree with the plain "
        f"path on {100 * agreement:.4f}% of {total} pixels; K3 plans built "
        f"{plans} for {len(sizes)} annotation sizes; launches {eval_counts} "
        f"on {smi}")
    if agreement < 0.99:
        raise AssertionError(f"pascal eval agreement {agreement} < 0.99")
    out["eval"] = dict(miou=res["mean_iou"], img_per_s=len(names) / secs,
                       agreement=agreement, plans=plans,
                       counts=eval_counts)

    # eval_test --pascal against the plain path
    test_dir = os.path.join(data, "img_with_margin_0", "test")
    tnames = sorted(p[:-4] for p in os.listdir(test_dir))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    png_dir = eval_test.main(["pascal_group", "final-group", str(B),
                              "--pascal", "--data-root", data,
                              "--results-root", tmp])
    secs = time.perf_counter() - t0
    test_counts = kernels.launch_counts()
    lut = eval_test.train_id_to_source_lut(True)
    agree = total = 0
    for name in tnames:
        img = np.load(os.path.join(test_dir, name + ".npy"))
        x = torch.from_numpy(evm.prepare_image(img, "pascal"))[None].to(dev)
        want = lut[plain(x, *img.shape[:2])[0].cpu().numpy()
                   .astype(np.int64) + 1]
        png = read_png(os.path.join(png_dir, name + ".png"))
        if png.shape != img.shape[:2] or png.max() > 20:
            raise AssertionError(f"pascal eval_test: {name}.png "
                                 f"{png.shape}, max {png.max()}")
        agree += int((png == want).sum())
        total += png.size
    if test_counts["proto"] < 1 or test_counts["upsample"] < 1 or \
            test_counts["aspp"] != 3 * test_counts["proto"]:
        raise AssertionError(f"pascal eval_test launches {test_counts}")
    agreement = agree / total
    log(f"pascal eval_test --pascal: {len(tnames)} PNGs in {secs:.2f} s; "
        f"launches {test_counts}; Pascal label ids agree with the plain "
        f"path on {100 * agreement:.4f}% of {total} pixels; on {smi}")
    if agreement < 0.99:
        raise AssertionError(f"pascal eval_test agreement {agreement} < 0.99")
    out["eval_test"] = dict(agreement=agreement, counts=test_counts)
    del model, plain
    torch.cuda.empty_cache()

    # the served final-group (K1 at its pushed bank inside)
    out["serve"] = serve_checkpoint(tmp, "pascal_group", "final-group", dev,
                                    smi, "pascal_serving",
                                    size=(PASCAL_EVAL, PASCAL_EVAL))
    out.update(counts=counts, group_counts=group_counts, perf=perf)
    return out


# ---------------------------------------------------------------------------
# MSC models in int8 and as a deployable artifact (Pascal's final-group)
# ---------------------------------------------------------------------------
N_MSC = 16                            # 513 x 513 images served
MSC_MAPS = 3              # backbone passes a batch: base, 0.5, 0.75
# the 1x1 and dilated 3x3 convs of layer4/5 at the pyramid's smallest map
# of a 513 input (the 0.5 copy: 33 x 33 at batch 1)
MSC_SMALL = (1, 33, 33)


def write_images(img_dir: str, n: int, size, seed: int) -> list:
    """``n`` seeded uint8 RGB images of ``size`` as ``.npy`` files."""
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = [f"frame_{i:03d}.npy" for i in range(n)]
    for name in names:
        np.save(os.path.join(img_dir, name),
                rng.integers(0, 256, (*size, 3), dtype=np.uint8))
    return names


def check_int8_pyramid(gen, dev, smi: str) -> dict:
    """``int8_mm`` at layer4/5's 1x1 shapes and ``int8_conv3x3`` at their
    dilated 3x3 shapes on the pyramid's smallest map (33 x 33, 1089 rows):
    int32 bit for bit against the plain versions, the dequantized bf16
    within 1 bf16 ulp of the float32 dequantization; wrapper ms beside the
    plain versions'."""
    b, h, w = MSC_SMALL
    px = b * h * w
    out = {}
    for kk, nn, _ in path_1x1_shapes():
        xa, wt = _int8(gen, (px, kk), dev), _int8(gen, (nn, kk), dev)
        sx, sw = _scales(gen, nn, dev)
        want = int8_mm_plain(xa, wt)
        if not torch.equal(kernels.int8_mm(xa, wt), want):
            raise AssertionError(f"int8_mm int32 differs at {px}x{kk}x{nn}")
        deq = kernels.int8_mm(xa, wt, sx, sw, torch.bfloat16)
        if not _bf16_within_one_ulp(deq, want.float() * (sx * sw)):
            raise AssertionError(f"int8_mm epilogue > 1 bf16 ulp at "
                                 f"{px}x{kk}x{nn}")
        out[f"int8_mm {px}x{kk}x{nn}"] = dict(
            ms=round(time_ms(lambda: kernels.int8_mm(
                xa, wt, sx, sw, torch.bfloat16)), 4),
            plain_ms=round(time_ms(lambda: int8_mm_plain(
                xa, wt, sx, sw, torch.bfloat16)), 4))
    for layer in ("layer4", "layer5"):
        _, _, c, _, dil = N_BLOCKS[layer]
        x, wt = _int8(gen, (b, h, w, c), dev), _int8(gen, (9, c, c), dev)
        sx, sw = _scales(gen, c, dev)
        want = int8_conv3x3_plain(x, wt, dil)
        got = kernels.int8_conv3x3(x, wt, dil)
        if not (torch.equal(got, want) and
                torch.equal(got, kernels.int8_conv3x3(x, wt, dil))):
            raise AssertionError(f"int8_conv3x3 differs at {layer}'s "
                                 f"{b}x{h}x{w}x{c}, d = {dil}")
        deq = kernels.int8_conv3x3(x, wt, dil, sx, sw, torch.bfloat16)
        if not _bf16_within_one_ulp(deq, want.float() * (sx * sw)):
            raise AssertionError(f"int8_conv3x3 epilogue > 1 bf16 ulp at "
                                 f"{layer}'s {b}x{h}x{w}x{c}")
        out[f"int8_conv3x3 {layer} {b}x{h}x{w}x{c} d{dil}"] = dict(
            ms=round(time_ms(lambda: kernels.int8_conv3x3(
                x, wt, dil, sx, sw, torch.bfloat16)), 4),
            plain_ms=round(time_ms(lambda: int8_conv3x3_plain(
                x, wt, dil, sx, sw, torch.bfloat16)), 4))
    log(f"msc int8: the pyramid's smallest map ({b} x {h} x {w}, {px} rows) "
        f"at layer4/5's shapes, int32 bit for bit and dequantized bf16 "
        f"within 1 ulp; wrapper ms (CUDA-event medians of 10): "
        f"{json.dumps(out)} on {smi}")
    return out


def msc_serve(run_args: list, img_dir: str, out_dir: str, flags=()) -> dict:
    """One run through ``serve.main`` of an MSC checkpoint, launch counts
    from zero."""
    kernels.reset_launch_counts()
    record = serve.main([*run_args, "--input", img_dir, "--output", out_dir,
                         "--raw-output", *flags])
    return dict(record, counts=kernels.launch_counts())


def msc_quant8_phase(tmp: str, dev, smi: str) -> dict:
    """Pascal's full-depth ``final-group`` (the pyramid (0.5, 0.75))
    served through ``serve.main`` on ``N_MSC`` images of 513 x 513 in
    bf16, with ``--quant8-static --calib-images 8`` and with ``--quant8``:
    the launches a batch (each map runs layer4/5's int8 convs; static runs
    K2 once a map, K1 and K3 once; dynamic none of them), the static
    labels against the plain quant8 path (the same calibration, every
    kernel replaced by its plain version; >= 99%), beside the bf16 labels
    (reported); the int8 kernels at the pyramid's smallest map; and
    ``run_evaluation`` with Pascal's protocol and ``quant8='static'``."""
    gen = torch.Generator(device=dev).manual_seed(15)
    small = check_int8_pyramid(gen, dev, smi)
    run = os.path.join(tmp, "pascal_group")
    ckpt = os.path.join(run, "checkpoints", "final-group.ckpt")
    img_dir = os.path.join(tmp, "msc_images")
    names = write_images(img_dir, N_MSC, (PASCAL_EVAL, PASCAL_EVAL), seed=16)
    run_args = ["pascal_group", "final-group", "--results-root", tmp,
                "--batch", str(B), "--workers", "4"]
    batches = 1 + math.ceil(N_MSC / B)      # the warm-up and the pass
    dirs = {k: os.path.join(tmp, f"labels_msc_{k}")
            for k in ("bf16", "static", "dynamic")}
    runs = {"bf16": msc_serve(run_args, img_dir, dirs["bf16"]),
            "static": msc_serve(run_args, img_dir, dirs["static"],
                                ["--quant8-static", "--calib-images",
                                 str(N_CALIB)]),
            "dynamic": msc_serve(run_args, img_dir, dirs["dynamic"],
                                 ["--quant8"])}
    int8 = {k: MSC_MAPS * v * batches for k, v in PER_BATCH.items()}
    want = {
        "bf16": dict(aspp=MSC_MAPS * batches, proto=batches,
                     upsample=batches),
        # calibration runs the float forward: K2 on each map of each
        # calibration image too
        "static": dict(int8, int8_absmax=0, proto=batches, upsample=batches,
                       aspp=MSC_MAPS * (batches + N_CALIB)),
        "dynamic": dict(int8, int8_absmax=int8["quantize_int8"], aspp=0,
                        proto=0, upsample=0)}
    for kind, r in runs.items():
        if r["counts"] != {**r["counts"], **want[kind]} or \
                r["images"] != N_MSC or \
                r["quant8"] != {"bf16": False, "static": "static",
                                "dynamic": True}[kind]:
            raise AssertionError(f"msc {kind}: launches {r['counts']}, want "
                                 f"{want[kind]}; record {r}")
        log(f"msc serve {kind}: {r['img_per_s']} img/s ({N_MSC} images of "
            f"{PASCAL_EVAL} x {PASCAL_EVAL}, batch {B}, {batches} batches "
            f"with the warm-up, full depth, pyramid (0.5, 0.75)); device "
            f"idle share {r['device_idle_share']}; launches {r['counts']} "
            f"(a batch: K2 {r['counts']['aspp'] / batches:g}, int8_mm "
            f"{r['counts']['int8_mm'] / batches:g}, int8_conv3x3 "
            f"{r['counts']['int8_conv3x3'] / batches:g}, quantize_int8 "
            f"{r['counts']['quantize_int8'] / batches:g}); on {smi}")

    # the plain quant8 path: the same calibration, every kernel replaced
    pre = serve._make_preprocess(img_dir, normalize=True)
    model, _ = load_model(run, ckpt, dtype=torch.bfloat16, fast=False,
                          device=dev, quant8="static")
    calibrate_quant_scales(model, (
        torch.from_numpy(pre(n))[None].to(dev, torch.bfloat16)
        for n in names[:N_CALIB]))
    plain = plain_path(model)
    kernels.reset_launch_counts()
    agree = total = 0
    for i in range(0, N_MSC, B):
        x = np.stack([np.load(os.path.join(img_dir, n))
                      for n in names[i:i + B]])
        want_l = plain(torch.from_numpy(x).to(dev)).cpu().numpy()
        got = _labels(dirs["static"], names[i:i + B])
        agree += int((got == want_l).sum())
        total += got.size
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"the plain quant8 path launched kernels: "
                             f"{kernels.launch_counts()}")
    agreement = agree / total
    vs_bf16, _ = _agreement(dirs["static"], dirs["bf16"], names)
    dyn_vs_bf16, _ = _agreement(dirs["dynamic"], dirs["bf16"], names)
    classes = len(np.unique(_labels(dirs["static"], names)))
    log(f"msc quant8: static labels agree with the plain quant8 path on "
        f"{100 * agreement:.4f}% of {total} pixels ({classes} distinct "
        f"labels); with the bf16 labels on {100 * vs_bf16:.4f}% (static) "
        f"and {100 * dyn_vs_bf16:.4f}% (dynamic), reported, not gated; on "
        f"{smi}")
    if agreement < 0.99:
        raise AssertionError(f"msc quant8 agreement {agreement} < 0.99")
    del model, plain
    torch.cuda.empty_cache()

    # Pascal's evaluation protocol in static quant8
    data = os.path.join(tmp, "pascal")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = evm.run_evaluation("pascal_group", "final-group", batch_size=B,
                             data_type="pascal", data_root=data,
                             results_root=tmp, quant8="static")
    secs = time.perf_counter() - t0
    eval_counts = kernels.launch_counts()
    out_dir = os.path.join(run, "evaluation", "final-group-quant8static")
    if not os.path.exists(os.path.join(out_dir, "iou_scores.json")) or \
            not math.isfinite(res["mean_iou"]) or \
            min(eval_counts[k] for k in ("int8_mm", "int8_conv3x3",
                                         "upsample", "aspp")) < 1:
        raise AssertionError(f"msc eval quant8: {res} launches "
                             f"{eval_counts}")
    log(f"msc eval --quant8-static (Pascal protocol, {N_EVAL} val images at "
        f"{PASCAL_EVAL} x {PASCAL_EVAL}): mIoU {res['mean_iou']:.6f}, pixel "
        f"acc {res['pixel_accuracy']:.6f}, {N_EVAL / secs:.3f} img/s; "
        f"launches {eval_counts}; written to {os.path.basename(out_dir)}; "
        f"on {smi}")
    return dict(small=small, runs=runs, dirs=dirs, names=names,
                img_dir=img_dir, agreement=agreement, vs_bf16=vs_bf16,
                counts={k: r["counts"] for k, r in runs.items()},
                eval_counts=eval_counts)


def program_frame(path: str) -> dict:
    """The size of a saved program's forward frame: its op nodes, and the
    locals and stack slots of the Python function ``torch.export`` made
    of it (what ``serving.export._roomy_call`` makes room for)."""
    exported = torch.export.load(os.path.join(path, "module.pt2"))
    code = type(exported.module()).forward.__code__
    return dict(nodes=sum(n.op == "call_function"
                          for n in exported.graph.nodes),
                locals=code.co_nlocals, stack=code.co_stacksize)


def msc_artifact_phase(tmp: str, msc: dict, dev, smi: str) -> dict:
    """The artifacts of Pascal's MSC ``final-group`` written through
    ``serve.main --export`` (bf16 fast at batch 2 with the normalization
    inside, static quant8 fast with its scales, ``--dynamic-batch``
    plain), served by ``serve.main --artifact`` in a fresh interpreter (the
    fast ones over the ``N_MSC`` images, the plain one over the first 8):
    launches (K2 once a map, K1 and K3 once a batch), labels against the
    run-dir serve's (>= 99.99%), export, save and load seconds, MB, img/s
    beside the run dir's; the program's frame against the roomy frame
    (``serving.export._roomy_call``): the enqueue ms through ``predict``
    and through the module alone at five call depths."""
    img_dir, names = msc["img_dir"], msc["names"]
    few = os.path.join(tmp, "msc_images_8")
    os.makedirs(few)
    for n in names[:N_CALIB]:
        os.symlink(os.path.join(img_dir, n), os.path.join(few, n))
    run_args = ["pascal_group", "final-group", "--results-root", tmp,
                "--batch", str(B), "--workers", "4"]
    arts = {}
    for name, flags in ARTIFACTS.items():
        path = os.path.join(tmp, f"msc_artifact_{name}")
        spans = {}
        restore = time_exports(spans)
        t0 = time.perf_counter()
        try:
            rec = serve.main([*run_args, "--input", few, "--export", path,
                              *flags])
        finally:
            restore()
        cli_s = time.perf_counter() - t0
        want = [None if name == "dynamic_batch" else B, PASCAL_EVAL,
                PASCAL_EVAL, 3]
        if rec["input"] != want:
            raise AssertionError(f"msc artifact {name}: {rec}")
        mb = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path)) / 2 ** 20
        arts[name] = dict(path=path, cli_s=cli_s,
                          export_s=spans["export_serving"][0],
                          save_s=spans["save_artifact"][0], mb=mb,
                          frame=program_frame(path))
        log(f"msc artifact {name}: serve --export {cli_s:.2f} s "
            f"(export_serving {arts[name]['export_s']:.2f} s, save_artifact "
            f"{arts[name]['save_s']:.2f} s), {mb:.1f} MB; program "
            f"{json.dumps(arts[name]['frame'])}; on {smi}")
        torch.cuda.empty_cache()

    plain_dir = os.path.join(tmp, "labels_msc_f32")
    torch.backends.cudnn.allow_tf32 = True
    try:
        serve.main([*run_args, "--input", few, "--output", plain_dir,
                    "--raw-output", "--no-fast"])
    finally:
        torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()

    out_dirs = {n: os.path.join(tmp, f"labels_msc_art_{n}") for n in arts}
    jobs = [(n, arts[n]["path"], few if n == "dynamic_batch" else img_dir,
             out_dirs[n]) for n in arts]
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", ARTIFACT_SERVE, json.dumps(jobs)], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=900)
    if proc.returncode:
        raise AssertionError(f"msc artifact serving failed (exit "
                             f"{proc.returncode}):\n{proc.stderr[-6000:]}")
    served = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"msc artifact: the fresh interpreter took "
        f"{time.perf_counter() - t0:.1f} s; model, config or JAX modules "
        f"imported: {served['modules']}")
    if served["modules"]:
        raise AssertionError(f"serving an artifact imported "
                             f"{served['modules']}")
    batches = 1 + math.ceil(N_MSC / B)
    refs = {"bf16": (msc["dirs"]["bf16"], names),
            "quant8": (msc["dirs"]["static"], names),
            "dynamic_batch": (plain_dir, names[:N_CALIB])}
    rates = {"bf16": msc["runs"]["bf16"]["img_per_s"],
             "quant8": msc["runs"]["static"]["img_per_s"]}
    for name, (want_dir, want_names) in refs.items():
        r = served[name]
        want = dict.fromkeys(kernels.WRAPPERS, 0)
        if name != "dynamic_batch":
            want.update(aspp=MSC_MAPS * batches, proto=batches,
                        upsample=batches)
        if name == "quant8":
            want.update({k: MSC_MAPS * v * batches
                         for k, v in PER_BATCH.items()})
        if r["counts"] != want or r["images"] != len(want_names):
            raise AssertionError(f"msc artifact {name}: launches "
                                 f"{r['counts']}, want {want}; record {r}")
        agreement, total = _agreement(out_dirs[name], want_dir, want_names)
        r.update(agreement=agreement, pixels=total)
        log(f"msc artifact {name}: loaded in {r['load_s']:.2f} s in a fresh "
            f"interpreter; labels equal to the run-dir serve's on "
            f"{100 * agreement:.4f}% of {total} pixels"
            f"{' (bit-equal)' if agreement == 1.0 else ''}; "
            f"{r['img_per_s']} img/s (run dir {rates.get(name, 'n/a')}), "
            f"device idle share {r['device_idle_share']}; launches "
            f"{r['counts']} on {smi}")
        if agreement < 0.9999:
            raise AssertionError(f"msc artifact {name}: labels agree on "
                                 f"{agreement} < 0.9999")
    # the roomy frame at three times the flagship's nodes
    x = torch.from_numpy(np.stack([np.load(os.path.join(img_dir, n))
                                   for n in names[:B]])).to(dev)
    model = load_artifact(arts["quant8"]["path"])
    depth = {"quant8": enqueue_by_depth(model, x, depths=(0, 7, 20))}
    del model
    torch.cuda.empty_cache()
    log(f"msc artifact: host ms to enqueue one static quant8 batch (the "
        f"largest program) at call depths 0, 7, 20, through predict (the "
        f"roomy frame) and through the program's module alone: "
        f"{json.dumps(depth)} on {smi}")
    return dict(exports=arts, served=served, by_depth=depth, counts={
        "bf16": served["bf16"]["counts"],
        "quant8": served["quant8"]["counts"]})


# ---------------------------------------------------------------------------
# COCO-Stuff training, evaluation and serving at full width
# ---------------------------------------------------------------------------
COCO_SIZES = [(480, 640), (640, 480), (427, 640), (480, 640), (640, 427)]
COCO_SPLITS = {"train": 20, "val": N_EVAL}
COCO_BATCH, COCO_CROP = 10, 321       # the configs' batch and window
# warm-up, joint, last layer: a phase's timing starts past its first 3
COCO_STEPS = (6, 8, 5)
COCO_GROUP_STEPS = (5, 5)
COCO_SINGLE_STEPS = 6                 # joint micro-steps of scaleproto_coco
COCO_CLASSES = 182
# the logit grids of COCO's image sizes (the stem's ceil-mode pool)
COCO_GRIDS = {(480, 640): (61, 81), (640, 480): (81, 61),
              (427, 640): (54, 81)}


def write_coco_root(root: str, seed: int) -> str:
    """COCO-Stuff's preprocessed layout at COCO's image sizes: uint8
    images and final labels (0 void, class c stored as c + 1, 1-182) in a
    seeded 4 x 6 grid of class blocks, each block a seeded colour of its
    class plus noise of +-40."""
    rng = np.random.default_rng(seed)
    palette = rng.integers(40, 216, (256, 3)).astype(np.int16)
    index = {}
    for split, n in COCO_SPLITS.items():
        img_dir = os.path.join(root, "img_with_margin_0", split)
        ann_dir = os.path.join(root, "annotations", split)
        os.makedirs(img_dir)
        os.makedirs(ann_dir)
        index[split] = [f"{split}_{i:03d}" for i in range(n)]
        for i, name in enumerate(index[split]):
            h, w = COCO_SIZES[i % len(COCO_SIZES)]
            grid = rng.integers(0, COCO_CLASSES + 1, (4, 6)).astype(np.uint8)
            label = np.ascontiguousarray(np.repeat(np.repeat(
                grid, -(-h // 4), 0), -(-w // 6), 1)[:h, :w])
            noise = rng.integers(-40, 41, (h, w, 3), dtype=np.int16)
            np.save(os.path.join(img_dir, name + ".npy"),
                    np.clip(palette[label] + noise, 0, 255).astype(np.uint8))
            np.save(os.path.join(ann_dir, name + ".npy"), label)
    with open(os.path.join(root, "all_images.json"), "w") as f:
        json.dump(index, f)
    return root


def check_proto_coco(gen, dev, smi: str) -> dict:
    """K1 at COCO-Stuff's banks over 182 classes on random features of
    the 480 x 640 grid (61 x 81, batch 1): the prototype phase's 2184
    (plain head, 4 scales of 546), the single-scale model's 2184 (1 scale)
    and the group phase's 2054 (2052 active: 4 scales of 513 and two
    dangling rows; 3 groups) grouped and plain; each against the plain
    head (rtol = atol = 1e-4) and at pushed prototypes against the float64
    head (``check_proto_rounding``); the packed head's chunks, steps and
    passes; wrapper ms and device ms (CUDA events around calls queued
    behind a device sleep) beside the plain head's ms."""
    out = {}
    for name, spec, grouped in (
            ("2184x4", ProtoSpec.equal_allocation(
                2184, 64, num_classes=COCO_CLASSES, num_scales=4), False),
            ("2184x1", ProtoSpec.equal_allocation(
                2184, 64, num_classes=COCO_CLASSES, num_scales=1), False),
            ("2054x4 group", ProtoSpec.equal_allocation(
                2054, 64, num_classes=COCO_CLASSES, num_scales=4,
                num_groups=3), True),
            ("2054x4 plain", ProtoSpec.equal_allocation(
                2054, 64, num_classes=COCO_CLASSES, num_scales=4), False)):
        c, d = spec.num_classes, spec.feature_depth
        feats = torch.rand((1, *COCO_GRIDS[(480, 640)], d), generator=gen,
                           device=dev).to(torch.bfloat16)
        protos = torch.rand((spec.num_prototypes, 64), generator=gen,
                            device=dev)
        if grouped:
            gw = torch.rand((c, 3, spec.max_protos_per_class),
                            generator=gen, device=dev) + 1e-3
            kw = dict(group_projection=gw / gw.sum(-1, keepdim=True),
                      last_layer_group=torch.randn(
                          (c * 3, c), generator=gen, device=dev) *
                      math.sqrt(2.0 / (c * 3)))
            last = None
        else:
            kw = {}
            last = torch.randn((spec.num_prototypes, c), generator=gen,
                               device=dev) * 0.5
        head = pack_head(protos, last, spec, **kw)
        got = kernels.fused_proto_logits(feats, protos, last, spec, **kw,
                                         head=head)
        want = proto_plain(feats, protos, last, spec, **kw)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        check_proto_rounding(gen, dev, feats, spec, kw, last)
        steps = head.steps.cpu().numpy()

        def k1():
            return kernels.fused_proto_logits(feats, protos, last, spec,
                                              **kw, head=head)

        out[name] = dict(
            prototypes=spec.num_prototypes,
            active=spec.num_active_prototypes,
            chunks=int(head.columns.shape[0]), steps=int(steps.shape[0]),
            passes=int((steps[:, 5] & OPEN > 0).sum()),
            max_abs_err=(got - want).abs().max().item(),
            ms=time_ms(k1), device_ms=queued_device_ms(k1),
            plain_ms=time_ms(lambda: proto_plain(feats, protos, last, spec,
                                                 **kw)))
    log(f"coco: K1 at COCO-Stuff's banks over {COCO_CLASSES} classes on 1 x "
        f"61 x 81 features, against the plain head (rtol = atol = 1e-4) and "
        f"the float64 head at pushed prototypes; packed chunks, steps, "
        f"passes; ms (CUDA-event medians of 10), device ms (queued): "
        f"{json.dumps(out)} on {smi}")
    return out


def check_upsample_coco(gen, dev) -> dict:
    """K3 from COCO's logit grids over 182 classes to its image sizes and
    the 321 / 513 inputs: labels equal to the plain version's wherever its
    top-two margin is >= 1e-5; the block plan (span, rows, columns)."""
    from scaleprotoseg_torch.kernels import upsample as kup
    out = {}
    cases = [(grid, size) for size, grid in COCO_GRIDS.items()] + \
        [((41, 41), (COCO_CROP, COCO_CROP)),
         ((TH, TW), (PASCAL_EVAL, PASCAL_EVAL))]
    for (h, w), (hh, ww) in cases:
        lg = torch.randn((1, h, w, COCO_CLASSES), generator=gen, device=dev)
        got = kernels.fused_upsample_argmax(lg, hh, ww)
        want = upsample_argmax_plain(lg, hh, ww)
        up = torch.einsum("oh,bhpc->bopc", torch.as_tensor(
            _bilinear_matrix(hh, h), device=dev), torch.einsum(
            "bhwc,pw->bhpc", lg, torch.as_tensor(_bilinear_matrix(ww, w),
                                                 device=dev)))
        top2 = torch.topk(up, 2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) >= 1e-5
        diff = got.int() != want.int()
        if got.dtype != torch.uint8 or int((diff & decided).sum()):
            raise AssertionError(f"upsample {h}x{w} -> {hh}x{ww} at "
                                 f"{COCO_CLASSES} classes: "
                                 f"{int((diff & decided).sum())} decided "
                                 "labels differ")
        out[f"{h}x{w}->{hh}x{ww}"] = dict(
            differ=int(diff.sum()), plan=kup.plan(h, w, hh, ww, COCO_CLASSES),
            ms=round(time_ms(lambda: kernels.fused_upsample_argmax(
                lg, hh, ww)), 4))
    log(f"coco: K3 at {COCO_CLASSES} classes, uint8 labels; labels that "
        f"differ from the plain version (none where the margin is >= "
        f"1e-5), the block plan (span, rows, columns) and ms: "
        f"{json.dumps(out)}")
    return out


def _coco_argv(config: str, name: str, data: str, tmp: str, gin,
               extra=()) -> list:
    argv = [config, name, "--gpu-recipe", "--data-root", data,
            "--results-root", tmp, *extra]
    for line in gin:
        argv += ["--gin", line]
    return argv


def coco_phase(tmp: str, dev, smi: str) -> dict:
    """COCO-Stuff at full depth and width (182 classes, ResNet-101):
    K1 at its banks, K3 at 182 classes; a synthetic COCO-Stuff root (20
    train, 8 val images of 480 x 640 and the like, final labels in class
    blocks); ``baseline_coco`` (the multiscale model) through
    ``train_wandb_multiscale.train --gpu-recipe`` at batch 10 on 321 crops
    (``push_artifacts=False``: the artifact pass at 2184 prototypes is
    timed by ``python3 chip_smoke.py coco-push-artifacts``): warm-up,
    joint, push (its dedup), last layer, K2's forward, pack and weight
    gradient 3 times a micro-step; one micro-step of the kernel path
    against the plain path; ``group_scaleproto_coco`` from its
    ``push_final``; ``scaleproto_coco`` (the single-scale model) through
    ``train_wandb.main``; ``run_evaluation`` of ``final-group`` at batch 1
    over the 8 val images (labels >= 99.9% equal to the plain path); and
    ``final-group`` served on 8 images of 480 x 640 (>= 99.9%)."""
    from scaleprotoseg_torch import (cli_common, finetune_wandb_group,
                                     train_wandb, train_wandb_multiscale)
    gen = torch.Generator(device=dev).manual_seed(17)
    out = dict(proto=check_proto_coco(gen, dev, smi),
               upsample=check_upsample_coco(gen, dev))
    torch.cuda.empty_cache()
    data = write_coco_root(os.path.join(tmp, "coco"), seed=18)
    val_batches = math.ceil(COCO_SPLITS["val"] / COCO_BATCH)

    # the prototype phase of the multiscale model
    gin = [f"train.warmup_steps = {COCO_STEPS[0]}",
           f"train.joint_steps = {COCO_STEPS[1]}",
           f"train.finetune_steps = {COCO_STEPS[2]}",
           f"Trainer.val_check_interval = {max(COCO_STEPS)}"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trained = train_wandb_multiscale.train(
        "baseline_coco", "coco_train", data_root=data,
        gin_overrides=gin, gpu_recipe=True, results_root=tmp,
        push_artifacts=False)
    counts = kernels.launch_counts()
    secs = time.perf_counter() - t0
    perf = {}
    for phase, steps in enumerate(COCO_STEPS):
        res = trained["phases"][phase]
        bwd = 0 if phase == 2 else MSC_MAPS * steps
        want = {"aspp": MSC_MAPS * (steps + res.validations * val_batches),
                "aspp_grad_pack": bwd, "aspp_grad_weight": bwd}
        if res.steps_done != steps or \
                not all(math.isfinite(v) for v in res.losses) or \
                res.launches != {**res.launches, **want}:
            raise AssertionError(f"coco phase {phase}: {res.steps_done} "
                                 f"steps, losses {res.losses}, launches "
                                 f"{res.launches}, want {want}")
        perf[phase] = p = res.perf
        log(f"coco train phase {phase}: {steps} micro-steps, "
            f"{res.validations} validations; launches {res.launches}; "
            f"losses first {res.losses[0]:.4f} last {res.losses[-1]:.4f}, "
            f"all finite; {p['img_per_s']} img/s, median step "
            f"{p['step_ms_median']} ms, device idle share "
            f"{p['device_idle_share']}, peak {p['peak_memory_mb']} MB; batch "
            f"{COCO_BATCH} at {COCO_CROP} x {COCO_CROP}, 2184 prototypes, "
            f"{COCO_CLASSES} classes, the pyramid, full depth, bf16 recipe; "
            f"on {smi}")
    push = trained["push"]
    out["push"] = dict(prototypes=int(push.winners.shape[0]),
                       matched=int((push.winners >= 0).sum()),
                       pruned=int(push.winners.shape[0] -
                                  push.kept.shape[0]),
                       kept=int(push.kept.shape[0]))
    log(f"coco: train_wandb_multiscale baseline_coco took {secs:.1f} s; "
        f"push (scan only, no artifacts): {json.dumps(out['push'])}; "
        f"launches {counts}")

    run = os.path.join(tmp, "coco_train")
    _, bindings = cli_common.load_config(os.path.join(run, "config.gin"))
    batch = next(iter(cli_common.make_loaders(bindings, COCO_BATCH, seed=5,
                                              data_root=data)[0]))
    step_cmp = pascal_step_check(bindings, os.path.join(
        run, "checkpoints", "nopush_last"), batch, dev)
    log(f"coco: one micro-step at batch {COCO_BATCH}, kernel path vs plain "
        f"path: {json.dumps(step_cmp)} on {smi}")
    if not (step_cmp["loss_abs_err"] <= 1e-3
            and step_cmp["aspp_grad_rel_l2"] <= 2e-2
            and step_cmp["proto_grad_rel_l2"] <= 2e-2
            and step_cmp["launches"] == dict.fromkeys(TRAINING_KERNELS,
                                                      MSC_MAPS)):
        raise AssertionError(f"coco kernel vs plain micro-step {step_cmp}")
    out["step_cmp"] = step_cmp
    torch.cuda.empty_cache()

    # the group phase from push_final
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    group = finetune_wandb_group.main(_coco_argv(
        "group_scaleproto_coco", "coco_group", data, tmp,
        [f"train.warmup_steps = {COCO_GROUP_STEPS[0]}",
         f"train.joint_steps = {COCO_GROUP_STEPS[1]}",
         f"Trainer.val_check_interval = {max(COCO_GROUP_STEPS)}"],
        ["--start-checkpoint", trained["final"]]))
    group_counts = kernels.launch_counts()
    for phase, steps in enumerate(COCO_GROUP_STEPS):
        res = group["phases"][phase]
        want = MSC_MAPS * (steps + res.validations * val_batches)
        if res.steps_done != steps or res.launches["aspp"] != want or \
                not all(math.isfinite(v) for v in res.losses):
            raise AssertionError(f"coco group phase {phase}: "
                                 f"{res.steps_done} steps, K2 "
                                 f"{res.launches['aspp']} (want {want})")
        p = res.perf
        log(f"coco group phase {phase}: {steps} micro-steps; launches "
            f"{res.launches}; losses first {res.losses[0]:.4f} last "
            f"{res.losses[-1]:.4f}; {p['img_per_s']} img/s, median step "
            f"{p['step_ms_median']} ms, device idle share "
            f"{p['device_idle_share']}; on {smi}")
    gmodel, gspec = load_model(os.path.join(tmp, "coco_group"),
                               group["final"] + ".pth", device=dev)
    glw = gmodel.group_weights()[1]
    if tuple(glw.shape) != (COCO_CLASSES * 3, COCO_CLASSES):
        raise AssertionError(f"coco group head {tuple(glw.shape)}")
    log(f"coco group: final-group after {time.perf_counter() - t0:.1f} s; "
        f"{gspec.num_prototypes} prototypes ({gspec.num_active_prototypes} "
        f"active), group last layer {tuple(glw.shape)}")
    del gmodel
    torch.cuda.empty_cache()

    # the single-scale model
    kernels.reset_launch_counts()
    single = train_wandb.main(_coco_argv(
        "scaleproto_coco", "coco_single", data, tmp,
        ["train.warmup_steps = 0",
         f"train.joint_steps = {COCO_SINGLE_STEPS}",
         "train.finetune_steps = 0", "train.push_proto = False",
         f"Trainer.val_check_interval = {COCO_SINGLE_STEPS}"]))
    single_counts = kernels.launch_counts()
    res = single["phases"][1]
    want = {"aspp": MSC_MAPS * (COCO_SINGLE_STEPS +
                                res.validations * val_batches),
            "aspp_grad_pack": MSC_MAPS * COCO_SINGLE_STEPS,
            "aspp_grad_weight": MSC_MAPS * COCO_SINGLE_STEPS}
    if res.steps_done != COCO_SINGLE_STEPS or \
            res.launches != {**res.launches, **want} or \
            not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"coco single: {res.steps_done} steps, "
                             f"launches {res.launches}, want {want}")
    p = res.perf
    log(f"coco single (scaleproto_coco, summed ASPP, 2184 prototypes of 1 "
        f"scale): {COCO_SINGLE_STEPS} joint micro-steps; launches "
        f"{res.launches}; losses {[round(v, 4) for v in res.losses]}; "
        f"{p['img_per_s']} img/s, median step {p['step_ms_median']} ms; on "
        f"{smi}")

    # evaluation of final-group, batch 1, against the plain path
    names = sorted(p_[:-4] for p_ in os.listdir(
        os.path.join(data, "annotations", "val")))
    kernels.reset_launch_counts()
    evm.SegEvaluator = RecordingEvaluator
    t0 = time.perf_counter()
    try:
        res = evm.run_evaluation("coco_group", "final-group", batch_size=1,
                                 data_type="coco", data_root=data,
                                 results_root=tmp)
    finally:
        evm.SegEvaluator = SegEvaluator
    secs = time.perf_counter() - t0
    eval_counts = kernels.launch_counts()
    ev = RecordingEvaluator.last
    grun = os.path.join(tmp, "coco_group")
    model, _ = load_model(grun, os.path.join(grun, "checkpoints",
                                             "final-group.pth"),
                          dtype=torch.bfloat16, fast=False, device=dev)
    plain_labels(model)             # K2 and the int8 convs made plain

    @torch.inference_mode()
    def plain_eval(xn, h, w):
        logits = model(xn).logits
        return upsample_argmax_plain(logits.float().contiguous(), h, w)

    agree = total = 0
    cm = np.zeros((COCO_CLASSES, COCO_CLASSES), np.int64)
    for name, pred in zip(names, (p_ for b_ in ev.preds for p_ in b_)):
        img = np.load(os.path.join(data, "img_with_margin_0", "val",
                                   name + ".npy"))
        ann = eval_targets(np.load(os.path.join(
            data, "annotations", "val", name + ".npy")), "coco")
        x = torch.from_numpy(evm.prepare_image(img, "coco"))[None].to(dev)
        want = plain_eval(x, *ann.shape)[0].cpu().numpy()
        agree += int((pred == want).sum())
        total += pred.size
        t = ann.astype(np.int64) - 1
        valid = t >= 0
        cm += np.bincount(t[valid] * COCO_CLASSES + pred[valid],
                          minlength=COCO_CLASSES ** 2).reshape(
                              COCO_CLASSES, COCO_CLASSES)
    if not np.array_equal(ev.cm, cm):
        raise AssertionError("coco eval: confusion matrix differs from the "
                             "host bincount")
    agreement = agree / total
    want = {"upsample": len(ev.preds), "aspp": MSC_MAPS * (len(ev.preds) +
                                                           N_SAMPLES)}
    log(f"coco eval: mIoU {res['mean_iou']:.6f}, pixel acc "
        f"{res['pixel_accuracy']:.6f}, {len(names) / secs:.3f} img/s "
        f"({len(names)} images at batch 1, the samples included); confusion "
        f"matrix equal to the host bincount; labels agree with the plain "
        f"path on {100 * agreement:.4f}% of {total} pixels; launches "
        f"{eval_counts} on {smi}")
    if eval_counts != {**eval_counts, **want} or agreement < 0.999:
        raise AssertionError(f"coco eval: agreement {agreement}, launches "
                             f"{eval_counts}, want {want}")
    out["eval"] = dict(miou=res["mean_iou"], agreement=agreement,
                       img_per_s=len(names) / secs, counts=eval_counts)
    del model
    torch.cuda.empty_cache()

    out["serve"] = serve_checkpoint(tmp, "coco_group", "final-group", dev,
                                    smi, "coco_serving", size=(480, 640))
    if out["serve"]["agreement"] < 0.999:
        raise AssertionError(f"coco serving agreement "
                             f"{out['serve']['agreement']} < 0.999")
    out.update(counts=counts, group_counts=group_counts,
               single_counts=single_counts, perf=perf)
    return out


def coco_push_artifacts() -> None:
    """``python3 chip_smoke.py coco-push-artifacts``: push of a
    full-depth ``baseline_coco`` model (seeded weights, 2184 prototypes,
    182 classes) over the synthetic COCO-Stuff train split, timed without
    and with its artifacts (the pass ``chip_smoke.py``'s COCO phase leaves
    out); prints the seconds, the files and the last line."""
    from scaleprotoseg_torch import cli_common, train_wandb_multiscale
    from scaleprotoseg_torch.push.push import push_prototypes
    smi = device_phase()
    log(smi)
    dev = torch.device("cuda")
    build_phase()
    with tempfile.TemporaryDirectory() as tmp:
        data = write_coco_root(os.path.join(tmp, "coco"), seed=18)
        _, bindings = cli_common.load_config("baseline_coco")
        model, spec = train_wandb_multiscale.build_model(bindings, 0)
        model = model.to(dev).eval()
        times = {}
        for artifacts in (False, True):
            loader = cli_common.make_push_loader(bindings, data_root=data)
            pdir = os.path.join(tmp, f"prototypes_{artifacts}")
            t0 = time.perf_counter()
            res = push_prototypes(model, spec, loader, prototypes_dir=pdir,
                                  save_artifacts=artifacts,
                                  cls2name=dict(enumerate(evm.class_names(
                                      "coco", COCO_CLASSES))), log=log)
            torch.cuda.synchronize()
            times[artifacts] = time.perf_counter() - t0
            files = sum(len(f) for _, _, f in os.walk(pdir))
            log(f"coco push over {COCO_SPLITS['train']} train images of "
                f"COCO sizes, artifacts {artifacts}: {times[artifacts]:.1f} "
                f"s; {int(res.kept.shape[0])} of "
                f"{int(res.winners.shape[0])} prototypes kept; {files} "
                f"files; on {smi}")
            model.load_state_dict(
                train_wandb_multiscale.build_model(bindings, 0)[0]
                .state_dict())
    log(f"coco push: the artifact pass took {times[True] - times[False]:.1f}"
        f" s of {times[True]:.1f} s at 2184 prototypes on {smi}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# ADE20K: the 1800 / 150 bank, mixed sizes, the short-side-512 protocol
# ---------------------------------------------------------------------------
# ADE's image sizes: landscape, portrait, square, one upscaled at eval, one
# downscaled, one halved exactly under the multiple of 64
ADE_SIZES = [(512, 683), (683, 512), (512, 512), (384, 512), (768, 1024),
             (1024, 1536)]
ADE_SPLITS = {"train": 16, "val": N_EVAL}
ADE_CROP = 512                        # the configs' window, batch B
# warm-up, joint, last layer: a phase's timing starts past its first 3
ADE_STEPS = (6, 8, 5)
ADE_GROUP_STEPS = (5, 5)
ADE_SINGLE_STEPS = 6                  # joint micro-steps of baseline_ade
ADE_CLASSES, ADE_PROTOS = 150, 1800
ADE_CANVAS = (683, 683)
ADE_SERVE_SIZES = [(512, 683), (683, 512), (512, 512), (384, 512),
                   (683, 683), (480, 640), (600, 450), (640, 683)]


def logit_grid(h: int, w: int) -> tuple:
    """The output-stride-8 grid of an h x w input (the stem's ceil-mode
    pool): 512 -> 65, 683 -> 86, 704 -> 89, 768 -> 97."""
    return h // 8 + 1, w // 8 + 1


def write_ade_root(root: str, seed: int) -> str:
    """ADE20K's preprocessed layout at ADE's image sizes: uint8 images and
    final labels (0 void, class c stored as c + 1, 1-150) in a seeded 4 x
    6 grid of class blocks framed by 8 void pixels, each block a seeded
    colour of its class plus noise of +-40."""
    rng = np.random.default_rng(seed)
    palette = rng.integers(40, 216, (256, 3)).astype(np.int16)
    index = {}
    for split, n in ADE_SPLITS.items():
        img_dir = os.path.join(root, "img_with_margin_0", split)
        ann_dir = os.path.join(root, "annotations", split)
        os.makedirs(img_dir)
        os.makedirs(ann_dir)
        index[split] = [f"{split}_{i:03d}" for i in range(n)]
        for i, name in enumerate(index[split]):
            h, w = ADE_SIZES[i % len(ADE_SIZES)]
            grid = rng.integers(1, ADE_CLASSES + 1, (4, 6)).astype(np.uint8)
            bh, bw = -(-h // 4), -(-w // 6)
            label = np.repeat(np.repeat(grid, bh, 0), bw, 1)[:h, :w].copy()
            rows, cols = np.arange(h) % bh, np.arange(w) % bw
            label[(rows < 8) | (rows >= bh - 8)] = 0
            label[:, (cols < 8) | (cols >= bw - 8)] = 0
            noise = rng.integers(-40, 41, (h, w, 3), dtype=np.int16)
            np.save(os.path.join(img_dir, name + ".npy"),
                    np.clip(palette[label] + noise, 0, 255).astype(np.uint8))
            np.save(os.path.join(ann_dir, name + ".npy"), label)
    with open(os.path.join(root, "all_images.json"), "w") as f:
        json.dump(index, f)
    return root


def check_proto_ade(gen, dev, smi: str) -> dict:
    """K1 at ADE20K's bank over 150 classes on random features of the
    512 x 683 eval input's grid at the multiple of 64 (512 x 704: 65 x 89,
    batch 1): ``scaleproto_ade``'s plain head (1800 over 4 scales of 450),
    ``baseline_ade``'s (1800 on 1 scale) and ``group_scaleproto_ade``'s
    group head (3 groups); each against the plain head (rtol = atol =
    1e-4) and at pushed prototypes against the float64 head
    (``check_proto_rounding``, ``pushed_bound``); the packed head's
    chunks, steps and passes; wrapper ms, and device ms beside the plain
    head's (CUDA events around calls queued behind a device sleep)."""
    out = {}
    grid = logit_grid(*evm.ade_eval_shape(512, 683, evm.ADE_SHAPE_MULTIPLE))
    for name, spec, grouped in (
            ("1800x4", ProtoSpec.equal_allocation(
                ADE_PROTOS, 64, num_classes=ADE_CLASSES, num_scales=4),
             False),
            ("1800x1", ProtoSpec.equal_allocation(
                ADE_PROTOS, 64, num_classes=ADE_CLASSES, num_scales=1),
             False),
            ("1800x4 group", ProtoSpec.equal_allocation(
                ADE_PROTOS, 64, num_classes=ADE_CLASSES, num_scales=4,
                num_groups=3), True)):
        c, d = spec.num_classes, spec.feature_depth
        feats = torch.rand((1, *grid, d), generator=gen, device=dev) \
            .to(torch.bfloat16)
        protos = torch.rand((spec.num_prototypes, 64), generator=gen,
                            device=dev)
        if grouped:
            gw = torch.rand((c, 3, spec.max_protos_per_class),
                            generator=gen, device=dev) + 1e-3
            kw = dict(group_projection=gw / gw.sum(-1, keepdim=True),
                      last_layer_group=torch.randn(
                          (c * 3, c), generator=gen, device=dev) *
                      math.sqrt(2.0 / (c * 3)))
            last = None
        else:
            kw = {}
            last = torch.randn((spec.num_prototypes, c), generator=gen,
                               device=dev) * 0.5
        head = pack_head(protos, last, spec, **kw)
        got = kernels.fused_proto_logits(feats, protos, last, spec, **kw,
                                         head=head)
        want = proto_plain(feats, protos, last, spec, **kw)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        pushed = check_proto_rounding(gen, dev, feats, spec, kw, last)
        steps = head.steps.cpu().numpy()

        def k1():
            return kernels.fused_proto_logits(feats, protos, last, spec,
                                              **kw, head=head)

        def plain():
            return proto_plain(feats, protos, last, spec, **kw)

        out[name] = dict(
            prototypes=spec.num_prototypes,
            chunks=int(head.columns.shape[0]), steps=int(steps.shape[0]),
            passes=int((steps[:, 5] & OPEN > 0).sum()),
            max_abs_err=(got - want).abs().max().item(),
            pushed=[list(r) for r in pushed],
            ms=time_ms(k1), device_ms=queued_device_ms(k1),
            plain_ms=time_ms(plain), plain_device_ms=queued_device_ms(plain))
    log(f"ade: K1 at ADE20K's bank ({ADE_PROTOS} prototypes, {ADE_CLASSES} "
        f"classes) on 1 x {grid[0]} x {grid[1]} features, against the plain "
        f"head (rtol = atol = 1e-4) and the float64 head at pushed "
        f"prototypes ((kernel, plain, bound) per draw); packed chunks, "
        f"steps, passes; ms (CUDA-event medians of 10), device ms (queued) "
        f"beside the plain head's: {json.dumps(out)} on {smi}")
    return out


def check_upsample_ade(gen, dev, smi: str) -> dict:
    """K3 at 150 classes from the grids of ADE's eval inputs (the multiple
    of 64 and the exact sizes) to its image sizes: labels equal to the
    plain version's wherever its top-two margin is >= 1e-5; the block
    plan; wrapper and device ms beside ``F.interpolate`` + ``argmax``'s."""
    from scaleprotoseg_torch.kernels import upsample as kup
    out = {}
    cases = sorted({(logit_grid(*evm.ade_eval_shape(h, w, m)), (h, w))
                    for h, w in ADE_SIZES
                    for m in (evm.ADE_SHAPE_MULTIPLE, None)})
    for (h, w), (hh, ww) in cases:
        lg = torch.randn((1, h, w, ADE_CLASSES), generator=gen, device=dev)
        got = kernels.fused_upsample_argmax(lg, hh, ww)
        want = upsample_argmax_plain(lg, hh, ww)
        up = torch.einsum("oh,bhpc->bopc", torch.as_tensor(
            _bilinear_matrix(hh, h), device=dev), torch.einsum(
            "bhwc,pw->bhpc", lg, torch.as_tensor(_bilinear_matrix(ww, w),
                                                 device=dev)))
        top2 = torch.topk(up, 2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) >= 1e-5
        diff = got.int() != want.int()
        if got.dtype != torch.uint8 or int((diff & decided).sum()):
            raise AssertionError(f"upsample {h}x{w} -> {hh}x{ww} at "
                                 f"{ADE_CLASSES} classes: "
                                 f"{int((diff & decided).sum())} decided "
                                 "labels differ")
        del up, top2, decided

        def k3():
            return kernels.fused_upsample_argmax(lg, hh, ww)

        def library():
            return F.interpolate(lg.permute(0, 3, 1, 2), size=(hh, ww),
                                 mode="bilinear", align_corners=False) \
                .argmax(1)

        out[f"{h}x{w}->{hh}x{ww}"] = dict(
            differ=int(diff.sum()), plan=kup.plan(h, w, hh, ww, ADE_CLASSES),
            ms=round(time_ms(k3), 4), device_ms=queued_device_ms(k3),
            library_ms=round(time_ms(library), 4),
            library_device_ms=queued_device_ms(library))
    log(f"ade: K3 at {ADE_CLASSES} classes, uint8 labels; labels that differ "
        f"from the plain version (none where the margin is >= 1e-5), the "
        f"block plan (span, rows, columns), ms and device ms beside "
        f"F.interpolate + argmax's: {json.dumps(out)} on {smi}")
    return out


def ade_eval(tmp: str, data: str, multiple, dev, smi: str) -> dict:
    """``run_evaluation`` of ``ade_group``'s ``final-group`` over the 8 val
    images at batch 1 with ``shape_multiple`` ``multiple`` (None: the
    default of 64; 0: the exact short-side-512 sizes): the confusion matrix
    against a host bincount of the predictions, the labels against the
    plain path (>= 99% of pixels, >= 99.9% of those decided beyond the
    upsample's fp32 rounding: ``decided_labels``), K3 once a batch and K2
    once a batch and a sample render; img/s; the K3 plans built and, over
    the split's
    distinct (grid, label size) pairs, the host ms an image that building
    ``plan`` and ``_device_taps`` anew costs (the caches cleared)."""
    from scaleprotoseg_torch.kernels import upsample as kup
    names = sorted(p_[:-4] for p_ in os.listdir(
        os.path.join(data, "annotations", "val")))
    kup.plan.cache_clear()
    kernels.reset_launch_counts()
    evm.SegEvaluator = RecordingEvaluator
    t0 = time.perf_counter()
    try:
        res = evm.run_evaluation("ade_group", "final-group", batch_size=1,
                                 data_type="ade", data_root=data,
                                 results_root=tmp, shape_multiple=multiple)
    finally:
        evm.SegEvaluator = SegEvaluator
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    plans = kup.plan.cache_info().misses
    ev = RecordingEvaluator.last
    grun = os.path.join(tmp, "ade_group")
    model, _ = load_model(grun, os.path.join(grun, "checkpoints",
                                             "final-group.pth"),
                          dtype=torch.bfloat16, fast=False, device=dev)
    plain_labels(model)             # K2 made plain

    @torch.inference_mode()
    def plain_logits(xn):
        return model(xn).logits.float().contiguous()

    m = evm.ADE_SHAPE_MULTIPLE if multiple is None else multiple or None
    agree = total = decided_agree = decided = 0
    cm = np.zeros((ADE_CLASSES, ADE_CLASSES), np.int64)
    pairs = set()
    for name, pred in zip(names, (p_ for b_ in ev.preds for p_ in b_)):
        img = np.load(os.path.join(data, "img_with_margin_0", "val",
                                   name + ".npy"))
        ann = eval_targets(np.load(os.path.join(
            data, "annotations", "val", name + ".npy")), "ade")
        x = torch.from_numpy(evm.prepare_image(img, "ade", m))[None].to(dev)
        pairs.add((logit_grid(*x.shape[1:3]), ann.shape))
        lg = plain_logits(x)
        want = upsample_argmax_plain(lg, *ann.shape)[0].cpu().numpy()
        sure = decided_labels(lg, *ann.shape)[0].cpu().numpy()
        del lg
        agree += int((pred == want).sum())
        total += pred.size
        decided_agree += int((pred == want)[sure].sum())
        decided += int(sure.sum())
        t = ann.astype(np.int64) - 1
        valid = t >= 0
        cm += np.bincount(t[valid] * ADE_CLASSES + pred[valid],
                          minlength=ADE_CLASSES ** 2).reshape(
                              ADE_CLASSES, ADE_CLASSES)
    del model
    if not np.array_equal(ev.cm, cm):
        raise AssertionError(f"ade eval (multiple {m}): confusion matrix "
                             "differs from the host bincount")
    agreement = agree / total
    decided_agreement = decided_agree / decided
    kup.plan.cache_clear()
    kup._device_taps.cache_clear()
    t1 = time.perf_counter()
    for (h, w), (hh, ww) in sorted(pairs):
        kup.plan(h, w, hh, ww, ADE_CLASSES)
        kup._device_taps(hh, h, torch.device(dev))
        kup._device_taps(ww, w, torch.device(dev))
    torch.cuda.synchronize()
    cache_ms = (time.perf_counter() - t1) * 1e3 / len(names)
    want = {"upsample": len(ev.preds), "aspp": len(ev.preds) + N_SAMPLES}
    log(f"ade eval (shape multiple {m}): mIoU {res['mean_iou']:.6f}, pixel "
        f"acc {res['pixel_accuracy']:.6f}, {len(names) / secs:.3f} img/s "
        f"({len(names)} images at batch 1, the load and sample renders "
        f"included); eval inputs {sorted({g for g, _ in pairs})} as grids; "
        f"confusion matrix equal to the host bincount; labels agree with the "
        f"plain path on {100 * agreement:.4f}% of {total} pixels, on "
        f"{100 * decided_agreement:.4f}% of the {100 * decided / total:.3f}% "
        f"decided beyond the upsample's fp32 rounding; K3 plans built "
        f"{plans} for {len(pairs)} (grid, label size) pairs, built anew "
        f"{cache_ms:.3f} host ms an image; launches {counts} on {smi}")
    if counts != {**counts, **want} or agreement < 0.99 or \
            decided_agreement < 0.999:
        raise AssertionError(f"ade eval (multiple {m}): agreement "
                             f"{agreement}, decided {decided_agreement}, "
                             f"launches {counts}, want {want}")
    return dict(miou=res["mean_iou"], pixel_accuracy=res["pixel_accuracy"],
                agreement=agreement, decided_agreement=decided_agreement,
                img_per_s=len(names) / secs,
                plans=plans, cache_ms_per_image=cache_ms, counts=counts)


def ade_phase(tmp: str, dev, smi: str) -> dict:
    """ADE20K at full depth and width (150 classes, 1800 prototypes,
    ResNet-101): K2 at the 512 crop (batch 2) and at an eval map, forward
    and backward; K1 at its bank (plain, single-scale, grouped); K3 at 150
    classes to ADE's sizes; a synthetic ADE20K root (16 train, 8 val images
    of ADE's sizes, final labels in class blocks framed by void);
    ``scaleproto_ade`` through ``train_wandb_multiscale.train
    --gpu-recipe`` at batch 2 on 512 crops (scales 0.5-2, ``iter_size`` 5;
    ``push_artifacts=False``): 6 warm-up, 8 joint, push at batch 1 over the
    mixed sizes, 5 last-layer micro-steps, K2's forward once a micro-step
    and a validation batch, its backward once a micro-step; one
    micro-step of the kernel path against the plain path;
    ``group_scaleproto_ade`` from its ``push_final`` (5 + 5); 6 joint
    micro-steps of ``baseline_ade`` through ``train_wandb.main``;
    ``run_evaluation`` of ``final-group`` with the short-side-512
    protocol at the default multiple of 64 and at 0 (``ade_eval``); and
    ``final-group`` served through ``serve.main --canvas 683 683`` on 8
    images of mixed sizes no larger than it (>= 99% equal to the plain
    path, >= 99.9% where decided beyond the fp32 rounding of the head and
    the upsample; K1 at the pushed bank).  The synthetic ``final-group``
    saturates its group head (logits up to ~2e6): below those roundings
    K1 / K3 and their plain versions break ties apart."""
    from scaleprotoseg_torch import (cli_common, finetune_wandb_group,
                                     train_wandb, train_wandb_multiscale)
    gen = torch.Generator(device=dev).manual_seed(19)
    eval_grid = logit_grid(*evm.ade_eval_shape(512, 683,
                                               evm.ADE_SHAPE_MULTIPLE))
    out = dict(aspp=check_aspp_pyramid(
        gen, dev, smi, shapes=((B, *logit_grid(ADE_CROP, ADE_CROP)),
                               (1, *eval_grid)),
        tag="ade: K2 at the 512 crop and the 512 x 704 eval input"),
        proto=check_proto_ade(gen, dev, smi),
        upsample=check_upsample_ade(gen, dev, smi))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    data = write_ade_root(os.path.join(tmp, "ade"), seed=20)
    log(f"ade: {ADE_SPLITS} images of ADE's sizes {ADE_SIZES} written in "
        f"{time.perf_counter() - t0:.1f} s")
    val_batches = math.ceil(ADE_SPLITS["val"] / B)

    # the prototype phase of the multiscale model
    gin = [f"train.warmup_steps = {ADE_STEPS[0]}",
           f"train.joint_steps = {ADE_STEPS[1]}",
           f"train.finetune_steps = {ADE_STEPS[2]}",
           f"Trainer.val_check_interval = {max(ADE_STEPS)}"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trained = train_wandb_multiscale.train(
        "scaleproto_ade", "ade_train", data_root=data, gin_overrides=gin,
        gpu_recipe=True, results_root=tmp, push_artifacts=False)
    counts = kernels.launch_counts()
    secs = time.perf_counter() - t0
    perf = {}
    for phase, steps in enumerate(ADE_STEPS):
        res = trained["phases"][phase]
        bwd = 0 if phase == 2 else steps
        want = {"aspp": steps + res.validations * val_batches,
                "aspp_grad_pack": bwd, "aspp_grad_weight": bwd}
        if res.steps_done != steps or \
                not all(math.isfinite(v) for v in res.losses) or \
                res.launches != {**res.launches, **want}:
            raise AssertionError(f"ade phase {phase}: {res.steps_done} "
                                 f"steps, losses {res.losses}, launches "
                                 f"{res.launches}, want {want}")
        perf[phase] = p = res.perf
        log(f"ade train phase {phase}: {steps} micro-steps, "
            f"{res.validations} validations; launches {res.launches}; "
            f"losses first {res.losses[0]:.4f} last {res.losses[-1]:.4f}, "
            f"all finite; {p['img_per_s']} img/s, median step "
            f"{p['step_ms_median']} ms, device idle share "
            f"{p['device_idle_share']}, peak {p['peak_memory_mb']} MB; batch "
            f"{B} at {ADE_CROP} x {ADE_CROP} (scales 0.5-2), {ADE_PROTOS} "
            f"prototypes, {ADE_CLASSES} classes, full depth, bf16 recipe; on "
            f"{smi}")
    push = trained["push"]
    out["push"] = dict(prototypes=int(push.winners.shape[0]),
                       matched=int((push.winners >= 0).sum()),
                       pruned=int(push.winners.shape[0] -
                                  push.kept.shape[0]),
                       kept=int(push.kept.shape[0]))
    log(f"ade: train_wandb_multiscale scaleproto_ade took {secs:.1f} s; "
        f"push at batch 1 over {ADE_SPLITS['train']} images of mixed sizes "
        f"(scan only, no artifacts): {json.dumps(out['push'])}; launches "
        f"{counts}")

    run = os.path.join(tmp, "ade_train")
    _, bindings = cli_common.load_config(os.path.join(run, "config.gin"))
    batch = next(iter(cli_common.make_loaders(bindings, B, seed=5,
                                              data_root=data)[0]))
    step_cmp = pascal_step_check(bindings, os.path.join(
        run, "checkpoints", "nopush_last"), batch, dev)
    log(f"ade: one micro-step at batch {B} on {ADE_CROP} crops, kernel path "
        f"vs plain path: {json.dumps(step_cmp)} on {smi}")
    if not (step_cmp["loss_abs_err"] <= 1e-3
            and step_cmp["aspp_grad_rel_l2"] <= 2e-2
            and step_cmp["proto_grad_rel_l2"] <= 2e-2
            and step_cmp["launches"] == dict.fromkeys(TRAINING_KERNELS, 1)):
        raise AssertionError(f"ade kernel vs plain micro-step {step_cmp}")
    out["step_cmp"] = step_cmp
    torch.cuda.empty_cache()

    # the group phase from push_final
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    group = finetune_wandb_group.main(_coco_argv(
        "group_scaleproto_ade", "ade_group", data, tmp,
        [f"train.warmup_steps = {ADE_GROUP_STEPS[0]}",
         f"train.joint_steps = {ADE_GROUP_STEPS[1]}",
         f"Trainer.val_check_interval = {max(ADE_GROUP_STEPS)}"],
        ["--start-checkpoint", trained["final"]]))
    group_counts = kernels.launch_counts()
    for phase, steps in enumerate(ADE_GROUP_STEPS):
        res = group["phases"][phase]
        want = steps + res.validations * val_batches
        if res.steps_done != steps or res.launches["aspp"] != want or \
                not all(math.isfinite(v) for v in res.losses):
            raise AssertionError(f"ade group phase {phase}: "
                                 f"{res.steps_done} steps, K2 "
                                 f"{res.launches['aspp']} (want {want})")
        p = res.perf
        log(f"ade group phase {phase}: {steps} micro-steps; launches "
            f"{res.launches}; losses first {res.losses[0]:.4f} last "
            f"{res.losses[-1]:.4f}; {p['img_per_s']} img/s, median step "
            f"{p['step_ms_median']} ms, device idle share "
            f"{p['device_idle_share']}; on {smi}")
    gmodel, gspec = load_model(os.path.join(tmp, "ade_group"),
                               group["final"] + ".pth", device=dev)
    glw = gmodel.group_weights()[1]
    if tuple(glw.shape) != (ADE_CLASSES * 3, ADE_CLASSES):
        raise AssertionError(f"ade group head {tuple(glw.shape)}")
    log(f"ade group: final-group after {time.perf_counter() - t0:.1f} s; "
        f"{gspec.num_prototypes} prototypes, group last layer "
        f"{tuple(glw.shape)}")
    del gmodel
    torch.cuda.empty_cache()

    # the single-scale baseline
    kernels.reset_launch_counts()
    single = train_wandb.main(_coco_argv(
        "baseline_ade", "ade_single", data, tmp,
        ["train.warmup_steps = 0", f"train.joint_steps = {ADE_SINGLE_STEPS}",
         "train.finetune_steps = 0", "train.push_proto = False",
         f"Trainer.val_check_interval = {ADE_SINGLE_STEPS}"]))
    single_counts = kernels.launch_counts()
    res = single["phases"][1]
    want = {"aspp": ADE_SINGLE_STEPS + res.validations * val_batches,
            "aspp_grad_pack": ADE_SINGLE_STEPS,
            "aspp_grad_weight": ADE_SINGLE_STEPS}
    if res.steps_done != ADE_SINGLE_STEPS or \
            res.launches != {**res.launches, **want} or \
            not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"ade single: {res.steps_done} steps, launches "
                             f"{res.launches}, want {want}")
    p = res.perf
    log(f"ade single (baseline_ade, summed ASPP, {ADE_PROTOS} prototypes of "
        f"1 scale): {ADE_SINGLE_STEPS} joint micro-steps; launches "
        f"{res.launches}; losses {[round(v, 4) for v in res.losses]}; "
        f"{p['img_per_s']} img/s, median step {p['step_ms_median']} ms; on "
        f"{smi}")
    torch.cuda.empty_cache()

    # the eval protocol at the default multiple and exact, then serving
    out["eval"] = ade_eval(tmp, data, None, dev, smi)
    out["eval_exact"] = ade_eval(tmp, data, 0, dev, smi)
    torch.cuda.empty_cache()
    out["serve"] = serve_checkpoint(tmp, "ade_group", "final-group", dev,
                                    smi, "ade_serving", size=ADE_CANVAS,
                                    sizes=ADE_SERVE_SIZES)
    if out["serve"]["decided_agreement"] < 0.999:
        raise AssertionError(f"ade serving agreement "
                             f"{out['serve']['decided_agreement']} < 0.999 "
                             "where decided")
    out.update(counts=counts, group_counts=group_counts,
               single_counts=single_counts, perf=perf)
    return out


# ---------------------------------------------------------------------------
# EM / ISBI-2012: UNet-ASPP at 512 x 512, trainable BatchNorm
# ---------------------------------------------------------------------------
EM_SIZE = 512                         # the frames, crops and logit grid
EM_SPLITS = {"train": 20, "val": 10}
EM_STEPS = (20, 5)                    # joint, last layer (no warm-up)
EM_GROUP_STEPS = 10                   # the group phase: joint only
EM_SINGLE_STEPS = 6                   # joint micro-steps of baseline_em
EM_STEP_CROP = 128                    # the card-vs-CPU micro-step's crop
EM_BANKS = {"24x4": (24, 4, 0), "24x4 group": (24, 4, 3),
            "20x1": (20, 1, 0)}       # prototypes, scales, groups
EM_PATH_KERNELS = ("proto", "upsample")   # K2: below KERNEL_MIN_C


def write_em_root(root: str, seed: int) -> str:
    """ISBI-2012's preprocessed layout: 512 x 512 grayscale frames stored
    as RGB and their labels (``EM_RGB_2_ID``: 1 membrane, 2 cell), seeded
    Voronoi cells of 48 seeds whose borders (within 1.5 pixels of the
    bisector, on a 128 x 128 grid scaled by 4) are membrane; gray 170 in a
    cell, 70 on a membrane, noise of 25."""
    rng = np.random.default_rng(seed)
    g = EM_SIZE // 4
    grid = np.stack(np.mgrid[:g, :g], -1).reshape(-1, 2).astype(np.float32)
    index = {}
    for split, n in EM_SPLITS.items():
        img_dir = os.path.join(root, "img_with_margin_0", split)
        ann_dir = os.path.join(root, "annotations", split)
        os.makedirs(img_dir)
        os.makedirs(ann_dir)
        index[split] = [f"{split}_{i:03d}" for i in range(n)]
        for name in index[split]:
            seeds = rng.random((48, 2), np.float32) * g
            d = np.sqrt(((grid[:, None] - seeds[None]) ** 2).sum(-1))
            near = np.partition(d, 1, axis=1)[:, :2]
            small = np.where(near[:, 1] - near[:, 0] < 1.5, 1, 2)
            label = np.repeat(np.repeat(small.reshape(g, g), 4, 0), 4, 1) \
                .astype(np.uint8)
            gray = np.where(label == 2, 170.0, 70.0) + \
                rng.normal(0.0, 25.0, label.shape)
            gray = np.clip(gray, 0, 255).astype(np.uint8)
            np.save(os.path.join(img_dir, name + ".npy"),
                    np.repeat(gray[..., None], 3, -1))
            np.save(os.path.join(ann_dir, name + ".npy"), label)
    with open(os.path.join(root, "all_images.json"), "w") as f:
        json.dump(index, f)
    return root


def check_proto_em(gen, dev, smi: str) -> dict:
    """K1 on EM's grid (2 x 512 x 512 pixels, 134 M feature elements at 4
    scales) at ``scaleproto_em``'s bank (24 over 4 scales, 2 classes),
    its group head (3 groups a class) and ``baseline_em``'s (20 on 1
    scale): against the plain head (rtol = atol = 1e-4) and at pushed
    prototypes against the float64 head (``check_proto_rounding``); the
    packed chunks and steps; wrapper ms, device ms (CUDA events around
    calls queued behind a device sleep: the profiler's sessions this late
    in the script can come back empty) beside the plain head's, and the
    matmul chain's ms; the bound from the call's bytes and operations (the
    cross term as 3 bf16 passes, the rest fp32)."""
    out = {}
    n = B * EM_SIZE * EM_SIZE
    for name, (p, scales, g) in EM_BANKS.items():
        spec = ProtoSpec.equal_allocation(p, 64, num_classes=2,
                                          num_scales=scales, num_groups=g)
        c, a, d = 2, spec.num_active_prototypes, spec.feature_depth
        feats = torch.rand((B, EM_SIZE, EM_SIZE, d), generator=gen,
                           device=dev).to(torch.bfloat16)
        protos = torch.rand((p, 64), generator=gen, device=dev)
        if g:
            gw = torch.rand((c, g, spec.max_protos_per_class), generator=gen,
                            device=dev) + 1e-3
            kw = dict(group_projection=gw / gw.sum(-1, keepdim=True),
                      last_layer_group=torch.randn(
                          (c * g, c), generator=gen, device=dev) *
                      math.sqrt(2.0 / (c * g)))
            last = None
        else:
            kw = {}
            last = torch.randn((p, c), generator=gen, device=dev) * 0.5
        head = pack_head(protos, last, spec, **kw)
        got = kernels.fused_proto_logits(feats, protos, last, spec, **kw,
                                         head=head)
        want = proto_plain(feats, protos, last, spec, **kw)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        err = (got - want).abs().max().item()
        del want
        pushed = check_proto_rounding(gen, dev, feats, spec, kw, last)
        steps = head.steps.cpu().numpy()
        pd = torch.zeros((d, a), device=dev)
        mt = torch.zeros((d, a), device=dev)
        for s, (lo, hi) in enumerate(spec.scale_bounds):
            pd[s * 64:(s + 1) * 64, lo:hi] = protos[lo:hi].t()
            mt[s * 64:(s + 1) * 64, lo:hi] = 1.0
        pn = (protos[:a] ** 2).sum(-1)
        if g:
            gw_dense = torch.zeros((a, c * g), device=dev)
            for cls in range(c):
                idx = spec.class_proto_index[cls]
                idx = idx[idx >= 0]
                gw_dense[idx, cls * g:(cls + 1) * g] = \
                    kw["group_projection"][cls, :, :len(idx)].t()

        def library():
            xf = feats.reshape(-1, d).float()
            dist = torch.relu((xf * xf) @ mt - 2.0 * (xf @ pd) + pn)
            act = torch.log((dist + 1.0) / (dist + EPSILON))
            if g:
                return torch.exp(act @ gw_dense) @ kw["last_layer_group"]
            return act @ last[:a]

        def k1():
            return kernels.fused_proto_logits(feats, protos, last, spec,
                                              **kw, head=head)

        def plain():
            return proto_plain(feats, protos, last, spec, **kw)

        cross = n * a * 2 * 64
        head_ops = a * g * 2 + c * g + c * g * c * 2 if g else a * c * 2
        rest = n * (2 * d + a * 6 + head_ops)
        t_ops = (3 * cross / PEAK_BF16_FLOPS + rest / PEAK_FP32_FLOPS) * 1e3
        weights = [kw["group_projection"], kw["last_layer_group"]] if g \
            else [last]
        t_bytes = nbytes(feats, protos, *weights, got) / PEAK_BYTES_PER_S \
            * 1e3
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")
        out[name] = dict(
            prototypes=p, scales=scales, groups=g,
            chunks=int(head.columns.shape[0]), steps=int(steps.shape[0]),
            max_abs_err=err, pushed=[list(r) for r in pushed],
            ms=time_ms(k1), device_ms=queued_device_ms(k1),
            plain_ms=time_ms(plain), plain_device_ms=queued_device_ms(plain),
            library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)
        del feats, got
        torch.cuda.empty_cache()
    log(f"em: K1 on EM's grid ({B} x {EM_SIZE} x {EM_SIZE} pixels, 2 "
        f"classes) at its banks, against the plain head (rtol = atol = "
        f"1e-4) and the float64 head at pushed prototypes ((kernel, plain, "
        f"bound) per draw); packed chunks and steps; ms (CUDA-event "
        f"medians of 10), device ms (queued) beside the plain head's and "
        f"the matmul chain's ms; bound: {json.dumps(out)} on "
        f"{smi}")
    return out


def check_upsample_em(gen, dev, smi: str) -> dict:
    """K3 at EM's 2 classes from the 512 x 512 logit grid to 512 x 512
    (the identity size): labels equal to the plain version's wherever its
    top-two margin is >= 1e-5; the block plan; wrapper and device ms
    (queued) beside the plain version's and ``F.interpolate`` +
    ``argmax``'s; the bound."""
    from scaleprotoseg_torch.kernels import upsample as kup
    h = w = EM_SIZE
    lg = torch.randn((B, h, w, 2), generator=gen, device=dev)
    got = kernels.fused_upsample_argmax(lg, h, w)
    want = upsample_argmax_plain(lg, h, w)
    m = torch.as_tensor(_bilinear_matrix(h, h), device=dev)
    up = torch.einsum("oh,bhpc->bopc", m, torch.einsum("bhwc,pw->bhpc", lg,
                                                       m))
    top2 = torch.topk(up, 2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) >= 1e-5
    diff = got.int() != want.int()
    if got.dtype != torch.uint8 or int((diff & decided).sum()):
        raise AssertionError(f"em upsample: {int((diff & decided).sum())} "
                             "decided labels differ")
    del up, top2, m

    def k3():
        return kernels.fused_upsample_argmax(lg, h, w)

    def library():
        return F.interpolate(lg.permute(0, 3, 1, 2), size=(h, w),
                             mode="bilinear", align_corners=False).argmax(1)

    flops = B * 2 * (h * w * 3 + h * w * 4)
    b_ms, b_by = bound(nbytes(lg, got), flops, PEAK_FP32_FLOPS)
    out = dict(differ=int(diff.sum()), near_ties=int((~decided).sum()),
               plan=kup.plan(h, w, h, w, 2), max_abs_err=float(
                   (got.int() - want.int()).abs()[decided].max()),
               ms=time_ms(k3), device_ms=queued_device_ms(k3),
               plain_ms=time_ms(lambda: upsample_argmax_plain(lg, h, w)),
               library_ms=time_ms(library),
               library_device_ms=queued_device_ms(library),
               bound_ms=b_ms, bound_by=b_by)
    log(f"em: K3 at 2 classes, {B} x {h} x {w} -> {h} x {w} (scale 1), "
        f"uint8 labels; labels that differ from the plain version (none "
        f"where the margin is >= 1e-5), the block plan, ms and device ms "
        f"beside the plain version's and F.interpolate + argmax's; bound: "
        f"{json.dumps(out)} on {smi}")
    return out


def _bn_tensors(sd: dict, suffixes) -> dict:
    return {k: v for k, v in sd.items() if k.endswith(suffixes)}


def check_em_bn(stem: str, moved: bool) -> dict:
    """Every BN of checkpoint ``stem``: running statistics finite and, as
    ``moved`` says, moved from their init (mean 0, variance 1) or still
    there; affine parameters bit-equal to their init (weight 1, bias 0):
    no phase trains them."""
    sd, _ = load_checkpoint(stem)
    stats = _bn_tensors(sd, ("running_mean", "running_var"))
    affine = _bn_tensors(sd, (".bn.weight", ".bn.bias"))
    if len(stats) != 36 or len(affine) != 36:
        raise AssertionError(f"em BN: {len(stats)} statistics, "
                             f"{len(affine)} affine tensors")
    init = {k: float(k.endswith(("running_var", ".bn.weight")))
            for k in (*stats, *affine)}
    for k, v in stats.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"em BN: {k} not finite")
        if moved == bool((v == init[k]).all()):
            raise AssertionError(f"em BN: {k} moved={not moved}")
    for k, v in affine.items():
        if not bool((v == init[k]).all()):
            raise AssertionError(f"em BN: {k} changed")
    var = torch.cat([v.flatten() for k, v in stats.items()
                     if k.endswith("running_var")])
    return dict(statistics=len(stats), moved=moved,
                var_range=[var.min().item(), var.max().item()])


def em_micro_step(model, batch, dev) -> tuple:
    """(loss, every gradient flattened, every running statistic after the
    step) of one ``train_bn`` micro-step of ``model`` on ``batch``, every
    parameter trainable, the prototype phase's loss weights."""
    from scaleprotoseg_torch.train.steps import LossWeights, compute_losses
    model.zero_grad(set_to_none=True)
    for p in model.parameters():
        p.requires_grad_(True)
    x = torch.from_numpy(batch[0]).to(dev)
    t = torch.from_numpy(batch[1]).to(dev)
    loss, _ = compute_losses(model, model(x, train_bn=True), t,
                             LossWeights(crs_ent=1.0, l1=1e-4, kld=0.25))
    loss.backward()
    grads = torch.cat([p.grad.flatten().cpu() for _, p in
                       model.named_parameters() if p.grad is not None])
    stats = torch.cat([v.flatten().cpu() for k, v in
                       model.state_dict().items() if "running_" in k])
    return loss.item(), grads, stats


def em_step_check(bindings, stem: str, batch, dev) -> dict:
    """One ``train_bn`` micro-step from ``stem`` on a ``EM_STEP_CROP``
    crop of ``batch``: the card's, float32 with TF32 off, against the
    CPU's (the plain versions): loss within 1e-3, the gradients within
    2e-2 relative L2, the running statistics within 1e-3; and the bf16
    recipe's step on the card beside them (measured only)."""
    from scaleprotoseg_torch import train_wandb_multiscale
    sd, meta = load_checkpoint(stem)
    spec = ProtoSpec.from_meta(meta["spec"])
    k = EM_STEP_CROP
    crop = (np.ascontiguousarray(batch[0][:, :k, :k]),
            np.ascontiguousarray(batch[1][:, :k, :k]))
    res = {}
    for where, dtype in (("cpu", None), (dev, None), (dev, torch.bfloat16)):
        model, _ = train_wandb_multiscale.build_model(bindings, 0, spec)
        model.load_state_dict(sd, strict=True)
        if dtype is not None:
            model.set_compute_dtype(dtype)
        t0 = time.perf_counter()
        res[where, dtype] = em_micro_step(model.to(where), crop, where)
        res[where, dtype] += (time.perf_counter() - t0,)
        del model
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    (lc, gc, sc, tc), (lg, gg, sg, tg), (lb, gb, sb, _) = res.values()
    out = dict(crop=[B, k, k], loss_cpu=lc, loss_card=lg,
               loss_abs_err=abs(lg - lc), grad_rel_l2=rel(gg, gc),
               stats_max_abs_err=(sg - sc).abs().max().item(),
               cpu_s=tc, card_s=tg, bf16_loss=lb,
               bf16_loss_abs_err=abs(lb - lc), bf16_grad_rel_l2=rel(gb, gc),
               bf16_stats_max_abs_err=(sb - sc).abs().max().item())
    torch.cuda.empty_cache()
    return out


def em_eval(tmp: str, data: str, dev, smi: str) -> dict:
    """``run_evaluation`` of ``em_group``'s ``final-group`` over the 10 val
    frames at batch 2 (the full-image protocol, on the card: bf16 and K3;
    eval reads the model's forward, whose distances its purity curve
    needs, so K1 is not on this path): the confusion matrix against a host
    bincount of the predictions, the labels against the plain path (the
    same forward, K3 by its plain version; >= 99.9% of pixels, or of those
    decided beyond the upsample's fp32 rounding), K3 once a batch and K2
    never; mIoU, pixel accuracy and img/s."""
    names = sorted(p_[:-4] for p_ in os.listdir(
        os.path.join(data, "annotations", "val")))
    kernels.reset_launch_counts()
    evm.SegEvaluator = RecordingEvaluator
    t0 = time.perf_counter()
    try:
        res = evm.run_evaluation("em_group", "final-group", batch_size=B,
                                 data_type="em", data_root=data,
                                 results_root=tmp)
    finally:
        evm.SegEvaluator = SegEvaluator
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    ev = RecordingEvaluator.last
    grun = os.path.join(tmp, "em_group")
    model, _ = load_model(grun, os.path.join(grun, "checkpoints",
                                             "final-group.pth"),
                          dtype=torch.bfloat16, fast=False, device=dev)
    preds = [p_ for b_ in ev.preds for p_ in b_]
    agree = decided_agree = decided = 0
    cm = np.zeros((2, 2), np.int64)
    for i in range(0, len(names), B):
        imgs = [np.load(os.path.join(data, "img_with_margin_0", "val",
                                     n + ".npy")) for n in names[i:i + B]]
        xn = torch.from_numpy(np.stack([evm.prepare_image(im, "em")
                                        for im in imgs])).to(dev)
        with torch.inference_mode():
            lg = model(xn).logits.float().contiguous()
        want = upsample_argmax_plain(lg, EM_SIZE, EM_SIZE).cpu().numpy()
        sure = decided_labels(lg, EM_SIZE, EM_SIZE).cpu().numpy()
        del lg
        for j, n in enumerate(names[i:i + B]):
            pred = preds[i + j]
            same = pred == want[j]
            agree += int(same.sum())
            decided_agree += int(same[sure[j]].sum())
            decided += int(sure[j].sum())
            t = eval_targets(np.load(os.path.join(
                data, "annotations", "val", n + ".npy")), "em") \
                .astype(np.int64) - 1
            valid = t >= 0
            cm += np.bincount(t[valid] * 2 + pred[valid],
                              minlength=4).reshape(2, 2)
    del model
    total = len(names) * EM_SIZE * EM_SIZE
    agreement = agree / total
    decided_agreement = decided_agree / max(decided, 1)
    batches = math.ceil(len(names) / B)
    log(f"em eval: mIoU {res['mean_iou']:.6f}, pixel acc "
        f"{res['pixel_accuracy']:.6f}, {len(names) / secs:.3f} img/s "
        f"({len(names)} frames at batch {B}, the load and sample renders "
        f"included); confusion matrix equal to the host bincount: "
        f"{np.array_equal(ev.cm, cm)}; labels agree with the plain path on "
        f"{100 * agreement:.4f}% of {total} pixels, on "
        f"{100 * decided_agreement:.4f}% of the {100 * decided / total:.3f}% "
        f"decided beyond the upsample's fp32 rounding; launches {counts} "
        f"on {smi}")
    if not np.array_equal(ev.cm, cm):
        raise AssertionError("em eval: confusion matrix differs from the "
                             "host bincount")
    if counts["aspp"] or counts["upsample"] != batches or \
            max(agreement, decided_agreement) < 0.999:
        raise AssertionError(f"em eval: agreement {agreement}, decided "
                             f"{decided_agreement}, launches {counts}")
    return dict(miou=res["mean_iou"], pixel_accuracy=res["pixel_accuracy"],
                agreement=agreement, decided_agreement=decided_agreement,
                img_per_s=len(names) / secs, counts=counts)


def _em_phase_record(tag: str, res, steps: int) -> dict:
    """A trainer phase's checks (its micro-steps, finite losses, K2 never
    launched) and its numbers, logged."""
    k2 = {k: res.launches[k] for k in TRAINING_KERNELS}
    if res.steps_done != steps or any(k2.values()) or \
            not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"{tag}: {res.steps_done} steps, K2 {k2}, "
                             f"losses {res.losses}")
    p = res.perf
    log(f"{tag}: {steps} micro-steps, {res.validations} validations; "
        f"launches {res.launches}; losses first {res.losses[0]:.4f} last "
        f"{res.losses[-1]:.4f}, all finite; {p['img_per_s']} img/s, median "
        f"step {p['step_ms_median']} ms, device idle share "
        f"{p['device_idle_share']}, peak {p['peak_memory_mb']} MB")
    return dict(p, losses=[res.losses[0], res.losses[-1]])


def em_phase(tmp: str, dev, smi: str) -> dict:
    """EM / ISBI-2012 at full width (UNet-ASPP of base 64 with a concat
    ASPP of 4 x 64, 2 classes, 512 x 512 frames and crops): K1 and K3 at
    EM's shapes; a synthetic EM root (20 train, 10 val frames);
    ``scaleproto_em`` through ``train_wandb_multiscale.train
    --gpu-recipe`` at batch 2 (20 joint micro-steps, push at full width
    without the artifact pass, 5 last-layer), trainable BN (its statistics
    moved and finite, its affine parameters untouched), the log lines of
    the knobs the backbone turns off; the card's float32 micro-step
    against the CPU's; ``group_scaleproto_em`` from its ``push_final`` (10
    joint micro-steps; the backbone frozen, its statistics moving on);
    ``baseline_em`` (6 joint, its BN frozen: no ``freeze_type``); the eval
    of ``final-group`` over the 10 val frames and ``serve.main`` on them;
    ``serve --quant8-static`` refused by name; K2 never launched."""
    from scaleprotoseg_torch import (cli_common, finetune_wandb_group,
                                     train_wandb, train_wandb_multiscale)
    gen = torch.Generator(device=dev).manual_seed(23)
    out = dict(proto=check_proto_em(gen, dev, smi),
               upsample=check_upsample_em(gen, dev, smi))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    data = write_em_root(os.path.join(tmp, "em"), seed=24)
    log(f"em: {EM_SPLITS} frames of {EM_SIZE} x {EM_SIZE} written in "
        f"{time.perf_counter() - t0:.1f} s")

    # the prototype phase: joint (warm-up 0), push, last layer
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trained = train_wandb_multiscale.train(
        "scaleproto_em", "em_train", data_root=data, gin_overrides=[
            f"train.joint_steps = {EM_STEPS[0]}",
            f"train.finetune_steps = {EM_STEPS[1]}",
            f"Trainer.val_check_interval = {EM_STEPS[0]}"],
        gpu_recipe=True, results_root=tmp, push_artifacts=False)
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    if sorted(trained["phases"]) != [1, 2]:
        raise AssertionError(f"em: phases {sorted(trained['phases'])}")
    perf = {phase: _em_phase_record(f"em train phase {phase}",
                                    trained["phases"][phase], steps)
            for phase, steps in zip((1, 2), EM_STEPS)}
    run = os.path.join(tmp, "em_train")
    with open(os.path.join(run, "train.log")) as f:
        knobs = [line.strip() for line in f if "train.fast_aspp" in line
                 or "GPU recipe knobs" in line]
    if not any("disabled for UNet-ASPP" in line for line in knobs) or \
            not any("train_bn=True" in line for line in knobs):
        raise AssertionError(f"em: knob lines {knobs}")
    push = trained["push"]
    out["push"] = dict(prototypes=int(push.winners.shape[0]),
                       matched=int((push.winners >= 0).sum()),
                       pruned=int(push.winners.shape[0] -
                                  push.kept.shape[0]))
    out["bn"] = check_em_bn(trained["final"], moved=True)
    log(f"em: train_wandb_multiscale scaleproto_em took {secs:.1f} s; push "
        f"over {EM_SPLITS['train']} frames at full width (scan only): "
        f"{json.dumps(out['push'])}; BN of push_final: {json.dumps(out['bn'])}"
        f" (affine bit-equal to init); knobs {knobs}; launches {counts}")

    _, bindings = cli_common.load_config(os.path.join(run, "config.gin"))
    batch = next(iter(cli_common.make_loaders(bindings, B, seed=5,
                                              data_root=data)[0]))
    step = em_step_check(bindings, os.path.join(run, "checkpoints",
                                                "nopush_last"), batch, dev)
    log(f"em: one train_bn micro-step, the card's float32 against the "
        f"CPU's (and the bf16 recipe's beside them): {json.dumps(step)} on "
        f"{smi}")
    if not (step["loss_abs_err"] <= 1e-3 and step["grad_rel_l2"] <= 2e-2
            and step["stats_max_abs_err"] <= 1e-3):
        raise AssertionError(f"em card vs CPU micro-step {step}")
    out["step_cmp"] = step

    # the group phase: joint only, the backbone frozen
    kernels.reset_launch_counts()
    group = finetune_wandb_group.main(_coco_argv(
        "group_scaleproto_em", "em_group", data, tmp,
        [f"train.joint_steps = {EM_GROUP_STEPS}",
         f"Trainer.val_check_interval = {EM_GROUP_STEPS}"],
        ["--start-checkpoint", trained["final"]]))
    group_counts = kernels.launch_counts()
    if sorted(group["phases"]) != [1]:
        raise AssertionError(f"em group: phases {sorted(group['phases'])}")
    perf["group"] = _em_phase_record("em group phase 1", group["phases"][1],
                                     EM_GROUP_STEPS)
    before, _ = load_checkpoint(trained["final"])
    after, _ = load_checkpoint(group["final"])
    for k, v in before.items():
        if k.startswith("features.") and "num_batches" not in k and \
                torch.equal(after[k], v) == ("running_" in k):
            raise AssertionError(f"em group: {k} "
                                 f"{'unmoved' if 'running_' in k else 'moved'}")
    out["group_bn"] = check_em_bn(group["final"], moved=True)

    # the single-scale baseline: frozen BN
    kernels.reset_launch_counts()
    single = train_wandb.main(_coco_argv(
        "baseline_em", "em_single", data, tmp,
        [f"train.joint_steps = {EM_SINGLE_STEPS}",
         "train.finetune_steps = 0", "train.push_proto = False",
         f"Trainer.val_check_interval = {EM_SINGLE_STEPS}"]))
    single_counts = kernels.launch_counts()
    perf["single"] = _em_phase_record("em single (baseline_em)",
                                      single["phases"][1], EM_SINGLE_STEPS)
    out["single_bn"] = check_em_bn(single["final"], moved=False)
    torch.cuda.empty_cache()

    # eval and serving of final-group over the val frames; int8 refused
    out["eval"] = em_eval(tmp, data, dev, smi)
    torch.cuda.empty_cache()
    val = os.path.join(data, "img_with_margin_0", "val")
    out["serve"] = serve_checkpoint(tmp, "em_group", "final-group", dev,
                                    smi, "em_serving",
                                    size=(EM_SIZE, EM_SIZE), frames=val,
                                    uses=EM_PATH_KERNELS)
    if out["serve"]["counts"]["aspp"] or max(
            out["serve"]["agreement"],
            out["serve"]["decided_agreement"]) < 0.999:
        raise AssertionError(f"em serving: {out['serve']}")
    try:
        serve.main(["em_group", "final-group", "--input", val,
                    "--quant8-static", "--raw-output", "--results-root", tmp,
                    "--output", os.path.join(tmp, "em_q8")])
    except ValueError as e:
        if "'unet_aspp'" not in str(e):
            raise
        log(f"em: serve --quant8-static refused by name: {e}")
    else:
        raise AssertionError("em: serve --quant8-static was not refused")
    for path, c in (("training", counts), ("group", group_counts),
                    ("single", single_counts)):
        if any(c[k] for k in TRAINING_KERNELS):
            raise AssertionError(f"em {path}: K2 launched {c}")
    out.update(counts=counts, group_counts=group_counts,
               single_counts=single_counts, perf=perf)
    return out


# ---------------------------------------------------------------------------
# the preprocessing slice: raw files -> the CLIs -> the card
# ---------------------------------------------------------------------------
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_fixtures", "codecs")
# Each pooled CLI gets 128 jobs, so that every one of its 8 workers takes
# two chunks of 8 and its rate is the pool's, not its start-up's.  The
# first PREP_DISTINCT files of a split are written; the rest are hard
# links to them.
PREP_CITY = (("train", 126), ("val", 2))  # 2048 x 1024 images per split
PREP_JPEG_SPLITS = {"pascal": (("train_aug", 96), ("train", 12),
                               ("val", 12), ("test", 8)),
                    "ade": (("training", 116), ("validation", 12)),
                    "coco": (("train2017", 116), ("val2017", 12))}
PREP_JPEG = {"pascal": "pascal_420.jpg", "ade": "ade_progressive.jpg",
             "coco": "coco_444.jpg"}
PREP_PARTS = {"city": 8, "pascal": 16}  # panoptic-parts TIFFs (serial CLIs)
PREP_DISTINCT = 4
PREP_STEPS = 3                           # joint micro-steps on the card
PREP_EM_FRAMES = 30                      # ISBI-2012's volume


def png_filtered(pixels: np.ndarray) -> bytes:
    """An 8-bit gray or RGB PNG whose scanline r uses filter r % 5 (none,
    sub, up, average, Paeth), as PIL's adaptive encoder mixes them;
    ``codecs.encode_png`` writes filter 0 only."""
    a = pixels if pixels.ndim == 3 else pixels[..., None]
    h, w, c = a.shape
    raw = a.reshape(h, w * c).astype(np.int16)
    zeros = np.zeros((h, c), np.int16)
    up = np.vstack([np.zeros((1, w * c), np.int16), raw[:-1]])
    left = np.hstack([zeros, raw[:, :-c]])
    upleft = np.hstack([zeros, up[:, :-c]])
    enc = raw.copy()
    enc[1::5] -= left[1::5]
    enc[2::5] -= up[2::5]
    enc[3::5] -= (left[3::5] + up[3::5]) // 2
    lf, u, ul = left[4::5], up[4::5], upleft[4::5]
    p = lf + u - ul
    pa, pb, pc = np.abs(p - lf), np.abs(p - u), np.abs(p - ul)
    enc[4::5] -= np.where((pa <= pb) & (pa <= pc), lf,
                          np.where(pb <= pc, u, ul))
    kind = np.arange(h) % 5
    rows = np.hstack([kind[:, None], enc % 256]).astype(np.uint8)
    header = np.array([w, h], ">u4").tobytes() + bytes([8, 2 if c == 3
                                                        else 0, 0, 0, 0])
    return (b"\x89PNG\r\n\x1a\n" + codecs._chunk(b"IHDR", header) +
            codecs._chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) +
            codecs._chunk(b"IEND", b""))


def write_tiff(path: str, pages) -> None:
    """A little-endian multi-page TIFF of 2-D uint8 or int32 pages, one
    uncompressed strip each: the ISBI volume's and the panoptic-parts
    labels' layout."""
    out = bytearray(b"II*\x00\x00\x00\x00\x00")
    prev = 4                      # where the previous IFD offset goes
    for page in pages:
        page = np.ascontiguousarray(page)
        h, w = page.shape
        data_at = len(out)
        out += page.astype("<" + page.dtype.str[1:]).tobytes()
        if len(out) % 2:
            out += b"\x00"
        ifd_at = len(out)
        out[prev:prev + 4] = ifd_at.to_bytes(4, "little")
        bits = page.dtype.itemsize * 8
        fmt = 2 if page.dtype.kind == "i" else 1
        tags = [(256, 4, w), (257, 4, h), (258, 3, bits), (259, 3, 1),
                (262, 3, 1), (273, 4, data_at), (277, 3, 1), (278, 4, h),
                (279, 4, page.nbytes), (339, 3, fmt)]
        out += len(tags).to_bytes(2, "little")
        for tag, typ, value in tags:
            out += tag.to_bytes(2, "little") + typ.to_bytes(2, "little")
            out += (1).to_bytes(4, "little") + value.to_bytes(4, "little")
        prev = len(out)
        out += b"\x00\x00\x00\x00"
    with open(path, "wb") as f:
        f.write(bytes(out))


def check_fixtures() -> dict:
    """Every committed fixture decoded by ``codecs`` on this machine
    (which has no PIL) to the SHA-256, mode, dtype and shape of PIL's
    decode in the manifest; ms per decode of each file."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    ms = {}
    for name, want in sorted(manifest.items()):
        path = os.path.join(FIXTURES, name)
        mode, a, _ = codecs.read_image(path)
        got = dict(mode=mode, dtype=str(a.dtype), shape=list(a.shape),
                   sha256=hashlib.sha256(a.tobytes()).hexdigest())
        if got != want:
            raise AssertionError(f"fixture {name}: {got}, want {want}")
        # the host clock: a decode runs no device work
        ms[name] = enqueue_ms(lambda: codecs.read_image(path), 1, 5)
    log(f"preprocess: {len(manifest)} fixtures decoded to PIL's hashes; ms "
        f"per decode {json.dumps({k: round(v, 3) for k, v in ms.items()})}")
    return ms


def _write_or_link(path: str, k: int, first: list, write) -> str:
    """``write(path)`` for the first ``PREP_DISTINCT`` files of a split
    (recorded in ``first``), else a hard link to one of them; returns the
    written file the path holds."""
    if k < PREP_DISTINCT:
        write(path)
        first.append(path)
        return path
    src = first[k % len(first)]
    os.link(src, path)
    return src


def write_raw_trees(raw: str, seed: int) -> dict:
    """The datasets' raw downloads at their own sizes: Cityscapes PNGs at
    2048 x 1024 (filtered with all five filters), Pascal, ADE20K and COCO
    from the JPEG fixtures with gray label PNGs (one Pascal label the
    palette fixture), the ISBI stacks (30 frames of 512 x 512) and 32-bit
    panoptic-parts TIFFs; past ``PREP_DISTINCT`` files a split, hard links
    to them.  Returns what each CLI must reproduce."""
    rng = np.random.default_rng(seed)
    lut = preprocess._city_lut()
    cats = [0] + [next(k for k, v in CITYSCAPES_19_EVAL_CATEGORIES.items()
                       if v == c) for c in range(1, 20)]
    official = [int(np.flatnonzero(lut == k)[0]) for k in cats]
    palette = rng.integers(48, 208, (256, 3)).astype(np.int16)
    want = {"city": {}}
    bh, bw = HEIGHT // 4, WIDTH // 5 + 1
    for split, n in PREP_CITY:
        gt = os.path.join(raw, "city", "gtFine", split, "zurich")
        img = os.path.join(raw, "city", "leftImg8bit", split, "zurich")
        os.makedirs(gt)
        os.makedirs(img)
        pairs = []
        for i in range(n):
            # ids unique over the splits, as Cityscapes' are
            stem = f"zurich_{len(want['city']):06d}_000019"
            if i >= PREP_DISTINCT:
                first, label, image = pairs[i % len(pairs)]
                os.link(os.path.join(gt, first + "_gtFine_labelIds.png"),
                        os.path.join(gt, stem + "_gtFine_labelIds.png"))
                os.link(os.path.join(img, first + "_leftImg8bit.png"),
                        os.path.join(img, stem + "_leftImg8bit.png"))
                want["city"][stem] = (split, label, image, first)
                continue
            grid = rng.permutation(official).reshape(4, 5)
            label = np.repeat(np.repeat(grid, bh, 0), bw, 1)[:HEIGHT, :WIDTH]
            label = label.astype(np.uint8)
            noise = rng.integers(-16, 17, (HEIGHT, WIDTH, 3), np.int16)
            image = np.clip(palette[lut[label]] + noise, 0, 255) \
                .astype(np.uint8)
            with open(os.path.join(gt, stem + "_gtFine_labelIds.png"),
                      "wb") as f:
                f.write(png_filtered(label))
            with open(os.path.join(img, stem + "_leftImg8bit.png"),
                      "wb") as f:
                f.write(png_filtered(image))
            pairs.append((stem, lut[label], image))
            want["city"][stem] = (split, lut[label], image, stem)
    for ds, splits in PREP_JPEG_SPLITS.items():
        with open(os.path.join(FIXTURES, PREP_JPEG[ds]), "rb") as f:
            jpeg = f.read()
        h, w = codecs.decode(jpeg)[1].shape[:2]
        root = os.path.join(raw, ds)
        want[ds] = {}
        for split, n in splits:
            ids = [f"{split}_{i:04d}" for i in range(n)]
            if ds == "pascal":
                img_dir = os.path.join(root, "JPEGImages")
                lab_dir = os.path.join(root, "SegmentationClassAug")
                lists = os.path.join(root, "ImageSets", "SegmentationAug")
                for d in (img_dir, lab_dir, lists):
                    os.makedirs(d, exist_ok=True)
                with open(os.path.join(lists, split + ".txt"), "w") as f:
                    f.writelines(f"/JPEGImages/{i}.jpg "
                                 f"/SegmentationClassAug/{i}.png\n"
                                 for i in ids)
            else:
                img_dir = os.path.join(root, "images", split)
                lab_dir = os.path.join(root, "annotations", split)
                os.makedirs(img_dir)
                os.makedirs(lab_dir)
            first = []
            for k, i in enumerate(ids):
                with open(os.path.join(img_dir, i + ".jpg"), "wb") as f:
                    f.write(jpeg)
                if split == "test":
                    want[ds][i] = None
                    continue

                def write_label(path, k=k):
                    if ds == "pascal" and k == 0:
                        with open(os.path.join(FIXTURES, "palette.png"),
                                  "rb") as src, open(path, "wb") as f:
                            f.write(src.read())
                        return
                    label = rng.integers(0, 256, (h // 25 + 1, w // 25 + 1))
                    label = np.repeat(np.repeat(label, 25, 0), 25,
                                      1)[:h, :w].astype(np.uint8)
                    codecs.write_png(path, label)
                want[ds][i] = _write_or_link(os.path.join(lab_dir, i + ".png"),
                                             k, first, write_label)
    em = os.path.join(raw, "em")
    os.makedirs(em)
    frames = rng.integers(0, 256, (PREP_EM_FRAMES, 512, 512), np.uint8)
    cells = rng.integers(0, 2, (PREP_EM_FRAMES, 512, 512)).astype(np.uint8)
    write_tiff(os.path.join(em, "train-volume.tif"), frames)
    write_tiff(os.path.join(em, "train-labels.tif"), cells * 255)
    want["em"] = (frames, cells + 1)
    uids = np.array([0, 7, 24, 26_001, 24_012, 2_400_105, 2_612_399],
                    np.int32)
    want["parts"] = {}
    for ds, size in (("city", (HEIGHT, WIDTH)), ("pascal", (375, 500))):
        d = os.path.join(raw, ds, "gtFinePanopticParts", "val", "zurich") \
            if ds == "city" else os.path.join(
                raw, ds, "pascal_panoptic_parts", "labels", "val")
        os.makedirs(d)
        first, written = [], {}
        for i in range(PREP_PARTS[ds]):
            name = (f"zurich_{i:06d}_000019_gtFinePanopticParts.tif"
                    if ds == "city" else f"val_{i:04d}.tif")

            def write_parts(path):
                written[path] = rng.choice(uids, size=size).astype(np.int32)
                write_tiff(path, [written[path]])
            src = _write_or_link(os.path.join(d, name), i, first,
                                 write_parts)
            want["parts"][(ds, name.split("_gtFine")[0].split(".")[0])] = \
                written[src]
    return want


def run_cli(module: str, args, images: int, env=None) -> dict:
    """``python -m scaleprotoseg_torch.data.<module> ARGS`` in a fresh
    interpreter: the wall seconds (interpreter start included) and the
    seconds the CLI reports for its own work (listing, pool start, every
    file written), each with its images/s."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m",
                          f"scaleprotoseg_torch.data.{module}", *args],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, **(env or {})},
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    if res.returncode:
        raise AssertionError(f"{module} exited {res.returncode}:\n"
                             f"{res.stdout}\n{res.stderr}")
    said = res.stdout.strip().splitlines()[-1]
    m = re.fullmatch(rf".*: {images} (?:images|frames).* in ([0-9.]+) s "
                     r"\([0-9.]+ images/s\)", said)
    if m is None:
        raise AssertionError(f"{module}: {said!r}, want {images} images")
    own = float(m.group(1))
    return dict(images=images, seconds=secs, img_per_s=images / secs,
                cli_seconds=own, cli_img_per_s=images / own)


def check_prep_outputs(out: dict, want: dict) -> None:
    """Each CLI's outputs against the raw trees it read: index, labels
    through their tables, images equal to the decoded sources."""
    from scaleprotoseg_torch.constants import COCO_LUT, EM_VAL_SIZE
    city = out["city"]
    with open(os.path.join(city, "all_images.json")) as f:
        index = json.load(f)
    pngs = {}
    for stem, (split, label, image, first) in want["city"].items():
        if stem not in index[split]:
            raise AssertionError(f"cityscapes: {stem} not in {split}")
        ann = np.load(os.path.join(city, "annotations", split, stem + ".npy"))
        img = np.load(os.path.join(city, "img_with_margin_0", split,
                                   stem + ".npy"))
        path = os.path.join(city, "img_with_margin_0", split, stem + ".png")
        # a link's PNG is byte-equal to its source's, decoded once
        with open(path, "rb") as f:
            data = f.read()
        if first == stem:
            pngs[stem] = data
            same = np.array_equal(codecs.decode(data)[1], image)
        else:
            same = data == pngs[first]
        if not (same and np.array_equal(ann, label)
                and np.array_equal(img, image)):
            raise AssertionError(f"cityscapes {stem}: outputs differ")
    if sum(map(len, index.values())) != len(want["city"]):
        raise AssertionError(f"cityscapes index {index}")
    labels = {}
    for ds in PREP_JPEG_SPLITS:
        image = codecs.read_rgb(os.path.join(FIXTURES, PREP_JPEG[ds]))
        with open(os.path.join(out[ds], "all_images.json")) as f:
            index = json.load(f)
        if sum(map(len, index.values())) != len(want[ds]):
            raise AssertionError(f"{ds} index {index}")
        splits = {"training": "train", "validation": "val",
                  "train2017": "train", "val2017": "val"}
        for i, lab_path in want[ds].items():
            split = splits.get(i.rsplit("_", 1)[0], i.rsplit("_", 1)[0])
            if i not in index[split]:
                raise AssertionError(f"{ds}: {i} not in {split}")
            img = np.load(os.path.join(out[ds], "img_with_margin_0", split,
                                       i + ".npy"))
            if not np.array_equal(img, image):
                raise AssertionError(f"{ds} {i}: image differs")
            if lab_path is None:
                continue
            ann = np.load(os.path.join(out[ds], "annotations", split,
                                       i + ".npy"))
            if lab_path not in labels:
                labels[lab_path] = COCO_LUT[codecs.read_l(lab_path)] \
                    if ds == "coco" else codecs.read_rgb(lab_path)[:, :, 0]
            if not np.array_equal(ann, labels[lab_path]):
                raise AssertionError(f"{ds} {i}: label differs")
    frames, labels = want["em"]
    with open(os.path.join(out["em"], "all_images.json")) as f:
        index = json.load(f)
    val = np.random.RandomState(42).choice(PREP_EM_FRAMES, EM_VAL_SIZE,
                                           replace=False).tolist()
    if index["val"] != [str(i) for i in val] or len(index["train"]) != \
            PREP_EM_FRAMES - EM_VAL_SIZE:
        raise AssertionError(f"em split {index}")
    for split, ids in index.items():
        for i in ids:
            img = np.load(os.path.join(out["em"], "img_with_margin_0", split,
                                       i + ".npy"))
            ann = np.load(os.path.join(out["em"], "annotations", split,
                                       i + ".npy"))
            if not (np.array_equal(img, np.repeat(frames[int(i)][..., None],
                                                  3, 2))
                    and np.array_equal(ann, labels[int(i)])):
                raise AssertionError(f"em frame {i} differs")
    for (ds, stem), uids in want["parts"].items():
        for kind, arr in zip(("SIDS", "IIDS", "PIDS"), decode_uids(uids)):
            got = np.load(os.path.join(out[ds], f"annotations_{kind}", "val",
                                       stem + ".npy"))
            if not np.array_equal(got, arr):
                raise AssertionError(f"{ds} parts {stem} {kind} differ")


def preprocess_phase(tmp: str, dev, smi: str) -> dict:
    """The preprocessing slice on the card's machine, which has no PIL:
    the fixtures decoded to PIL's hashes, ms per decode at the datasets'
    sizes, raw trees of every dataset through the eight CLIs (each in a
    fresh interpreter at n_jobs 8: images/s), their outputs against the
    raw files; then the preprocessed Cityscapes data on the card (joint
    micro-steps, ``run_evaluation`` of its val images) and ``serve.main``
    of raw ``.png`` / ``.jpg`` inputs writing PNGs, against the serve of
    their ``.npy`` mirrors."""
    from scaleprotoseg_torch import cli_common
    from scaleprotoseg_torch.train.runner import module_hparams
    from scaleprotoseg_torch.train.steps import compute_losses
    t_phase = time.perf_counter()
    fixture_ms = check_fixtures()
    t0 = time.perf_counter()
    raw = os.path.join(tmp, "raw")
    want = write_raw_trees(raw, seed=31)
    log(f"preprocess: raw trees written in {time.perf_counter() - t0:.1f} s")
    city_stem = next(iter(want["city"]))
    city_img = os.path.join(raw, "city", "leftImg8bit", "train", "zurich",
                            city_stem + "_leftImg8bit.png")
    city_lab = os.path.join(raw, "city", "gtFine", "train", "zurich",
                            city_stem + "_gtFine_labelIds.png")
    em_tif = codecs.TiffFile(os.path.join(raw, "em", "train-volume.tif"))
    decode_ms = {
        "png_rgb_2048x1024": enqueue_ms(
            lambda: codecs.read_image(city_img), 1, 5),
        "png_label_2048x1024": enqueue_ms(
            lambda: codecs.read_image(city_lab), 1, 5),
        "jpeg_500x375": fixture_ms["pascal_420.jpg"],
        "tiff_page_512x512": enqueue_ms(lambda: em_tif.page(7), 1, 5)}
    log(f"preprocess: host ms per decode {json.dumps(decode_ms)} on {smi}")

    out = {ds: os.path.join(tmp, "prep", ds) for ds in
           ("city", "pascal", "ade", "coco", "em")}
    counts = {"city": sum(n for _, n in PREP_CITY),
              **{ds: sum(n for _, n in s)
                 for ds, s in PREP_JPEG_SPLITS.items()},
              "em": PREP_EM_FRAMES}
    clis = {}
    for ds, module in (("city", "preprocess_cityscapes"),
                       ("pascal", "preprocess_pascal"),
                       ("ade", "preprocess_ade"), ("coco", "preprocess_coco"),
                       ("em", "preprocess_em")):
        clis[module] = run_cli(module, ["8", "--source",
                                        os.path.join(raw, ds), "--target",
                                        out[ds]], counts[ds])
    for module, ds in (("preprocess_part_cityscapes", "city"),
                       ("preprocess_part_pascal", "pascal")):
        clis[module] = run_cli(module, ["--source", os.path.join(raw, ds),
                                        "--target", out[ds]],
                               PREP_PARTS[ds])
    pascal_npy = os.path.join(out["pascal"], "img_with_margin_0")
    before = {(s, f): np.load(os.path.join(pascal_npy, s, f))
              for s in os.listdir(pascal_npy)
              for f in os.listdir(os.path.join(pascal_npy, s))
              if f.endswith(".npy")}
    clis["img_to_numpy"] = run_cli("img_to_numpy", ["pascal"],
                                   counts["pascal"],
                                   env={"DATA_PATH_PASCAL": out["pascal"]})
    if len(before) != counts["pascal"] or any(
            not np.array_equal(a, np.load(os.path.join(pascal_npy, *k)))
            for k, a in before.items()):
        raise AssertionError("img_to_numpy changed a Pascal mirror")
    check_prep_outputs(out, want)
    log("preprocess: CLIs in a fresh interpreter each (the pooled ones at "
        "n_jobs 8, chunks of 8; cli_seconds: the CLI's own report, the "
        "pool's start included, the interpreter's not) " + json.dumps(
            {m: {k: round(v, 3) for k, v in r.items()}
             for m, r in clis.items()}) + f"; every output equal to its raw "
        f"source; on {smi}")

    # onto the card: the preprocessed Cityscapes root in the port's
    # dataset, a few joint micro-steps and the eval of its val images
    run = write_run(tmp, seed=9, dev=dev)
    sd, meta = load_checkpoint(os.path.join(run, "checkpoints",
                                            "push_final"))
    spec = ProtoSpec.from_meta(meta["spec"])
    _, bindings = cli_common.load_config("group_scaleproto_cityscapes")
    weights = module_hparams(bindings, "group")["weights"]
    model, _ = construct_ppnet(
        "group", "deeplabv2_resnet101_multiscale", num_classes=19,
        bindings=bindings, spec=spec)
    model.load_state_dict(sd, strict=True)
    model.set_compute_dtype(torch.bfloat16)
    model.features.base.aspp.fast = True
    model.to(dev).train()
    loader = cli_common.make_loaders(bindings, B, seed=5,
                                     data_root=out["city"], log=log)[0]
    kernels.reset_launch_counts()
    losses = []
    for _, batch in zip(range(PREP_STEPS), loader):
        model.zero_grad(set_to_none=True)
        x = torch.from_numpy(batch[0]).to(dev)
        t = torch.from_numpy(batch[1]).to(dev)
        loss, _ = compute_losses(model, model(x), t, weights)
        loss.backward()
        losses.append(loss.item())
    train_counts = kernels.launch_counts()
    del model
    torch.cuda.empty_cache()
    want_train = {k: PREP_STEPS for k in TRAINING_KERNELS}
    if len(losses) != PREP_STEPS or not all(map(math.isfinite, losses)) or \
            train_counts != {**train_counts, **want_train}:
        raise AssertionError(f"preprocess micro-steps: losses {losses}, "
                             f"launches {train_counts}")
    kernels.reset_launch_counts()
    res = evm.run_evaluation("city_flagship", "push_final", batch_size=B,
                             data_root=out["city"], results_root=tmp)
    eval_counts = kernels.launch_counts()
    # eval's forward runs K2 and K3; K1 runs on the serving path below
    if not math.isfinite(res["mean_iou"]) or \
            min(eval_counts[k] for k in ("aspp", "upsample")) < 1:
        raise AssertionError(f"preprocess eval: {res['mean_iou']} "
                             f"{eval_counts}")
    log(f"preprocess: {PREP_STEPS} joint micro-steps on the preprocessed "
        f"Cityscapes train split (losses {[round(v, 4) for v in losses]}, "
        f"launches {train_counts}); eval of its {dict(PREP_CITY)['val']} "
        f"val images: mIoU {res['mean_iou']:.6f}, launches {eval_counts}")

    # serve: raw .png / .jpg inputs, PNGs written without PIL, against the
    # serve of the .npy mirrors the CLIs wrote
    raw_in, npy_in = os.path.join(tmp, "serve_raw"), os.path.join(
        tmp, "serve_npy")
    os.makedirs(raw_in)
    os.makedirs(npy_in)
    pairs = []
    for k, (stem, (split, *_)) in enumerate(list(want["city"].items())[:2]):
        pairs.append((os.path.join(raw, "city", "leftImg8bit", split,
                                   "zurich", stem + "_leftImg8bit.png"),
                      os.path.join(out["city"], "img_with_margin_0", split,
                                   stem + ".npy"), f"city_{k}"))
    for ds, split in (("pascal", "train_aug"), ("ade", "training")):
        i = f"{split}_0001"
        jpg = os.path.join(raw, ds, "JPEGImages" if ds == "pascal" else
                           os.path.join("images", split), i + ".jpg")
        pairs.append((jpg, os.path.join(out[ds], "img_with_margin_0",
                                        "train_aug" if ds == "pascal"
                                        else "train", i + ".npy"), ds))
    for src, mirror, name in pairs:
        ext = os.path.splitext(src)[1]
        os.symlink(src, os.path.join(raw_in, name + ext))
        os.symlink(mirror, os.path.join(npy_in, name + ".npy"))
    served = {}
    for tag, src_dir, extra in (("raw", raw_in, []),
                                ("npy", npy_in, ["--raw-output"])):
        kernels.reset_launch_counts()
        served[tag] = serve.main(["city_flagship", "push_final", "--input",
                                  src_dir, "--output",
                                  os.path.join(tmp, f"labels_{tag}"),
                                  "--batch", str(B), "--results-root", tmp,
                                  "--canvas", str(HEIGHT), str(WIDTH),
                                  *extra])
        served[tag]["counts"] = kernels.launch_counts()
    for _, _, name in pairs:
        png = read_png(os.path.join(tmp, "labels_raw", name + ".png"))
        npy = np.load(os.path.join(tmp, "labels_npy", name + ".npy"))
        if png.dtype != np.uint8 or not np.array_equal(png, npy):
            raise AssertionError(f"serve {name}: the .png / .jpg input's "
                                 "labels differ from its .npy mirror's")
    serve_counts = served["raw"]["counts"]
    if min(serve_counts[k] for k in SERVING_KERNELS) < 1:
        raise AssertionError(f"preprocess serve: launches {serve_counts}")
    secs = time.perf_counter() - t_phase
    log(f"preprocess: serve.main of {len(pairs)} raw .png / .jpg inputs "
        f"(--canvas {HEIGHT} {WIDTH}) wrote PNG labels equal to the serve "
        f"of their .npy mirrors; launches {serve_counts}; the phase took "
        f"{secs:.1f} s on {smi}")
    return dict(clis=clis, decode_ms=decode_ms, fixture_ms=fixture_ms,
                counts=train_counts, eval_counts=eval_counts,
                serve_counts=serve_counts, seconds=secs)


def main() -> None:
    if sys.argv[1:] == ["coco-push-artifacts"]:
        return coco_push_artifacts()
    t_start = time.perf_counter()
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

    spans = {"kernels": time.perf_counter() - t_start}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        spans[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return out

    served = timed("serving", serving_phase, dev, smi)
    trained = timed("training", training_phase, dev, smi)
    with tempfile.TemporaryDirectory() as tmp:
        pascal = timed("pascal", pascal_phase, tmp, dev, smi)
        msc = timed("msc_quant8", msc_quant8_phase, tmp, dev, smi)
        msc_art = timed("msc_artifact", msc_artifact_phase, tmp, msc, dev,
                        smi)
    with tempfile.TemporaryDirectory() as tmp:
        coco = timed("coco", coco_phase, tmp, dev, smi)
    with tempfile.TemporaryDirectory() as tmp:
        ade = timed("ade", ade_phase, tmp, dev, smi)
    with tempfile.TemporaryDirectory() as tmp:
        em = timed("em", em_phase, tmp, dev, smi)
    with tempfile.TemporaryDirectory() as tmp:
        prep = timed("preprocess", preprocess_phase, tmp, dev, smi)
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
                      "resumed_training":
                          data_run["relaunch_launches"][name],
                      "data_training": data_run["launches"][name],
                      **{f"knob_{k}": r["launches"][name]
                         for k, r in trained["knobs"]["runs"].items()},
                      "pascal_training": pascal["counts"][name],
                      "pascal_group_training": pascal["group_counts"][name],
                      "pascal_eval": pascal["eval"]["counts"][name],
                      "pascal_eval_test": pascal["eval_test"]["counts"][name],
                      "pascal_serving": pascal["serve"]["counts"][name],
                      "msc_serving": msc["counts"]["bf16"][name],
                      "msc_quant8_serving": msc["counts"]["static"][name],
                      "msc_quant8_dynamic": msc["counts"]["dynamic"][name],
                      "msc_eval_quant8": msc["eval_counts"][name],
                      "msc_artifact_serving":
                          msc_art["counts"]["bf16"][name],
                      "msc_artifact_quant8":
                          msc_art["counts"]["quant8"][name],
                      "coco_training": coco["counts"][name],
                      "coco_group_training": coco["group_counts"][name],
                      "coco_single_training": coco["single_counts"][name],
                      "coco_eval": coco["eval"]["counts"][name],
                      "coco_serving": coco["serve"]["counts"][name],
                      "ade_training": ade["counts"][name],
                      "ade_group_training": ade["group_counts"][name],
                      "ade_single_training": ade["single_counts"][name],
                      "ade_eval": ade["eval"]["counts"][name],
                      "ade_eval_exact": ade["eval_exact"]["counts"][name],
                      "ade_serving": ade["serve"]["counts"][name],
                      "em_training": em["counts"][name],
                      "em_group_training": em["group_counts"][name],
                      "em_single_training": em["single_counts"][name],
                      "em_eval": em["eval"]["counts"][name],
                      "em_serving": em["serve"]["counts"][name],
                      "preprocess_training": prep["counts"][name],
                      "preprocess_eval": prep["eval_counts"][name],
                      "preprocess_serving": prep["serve_counts"][name]}
               for name in results}
    # the Pascal slice's own paths: K2's forward and backward in its
    # training, K1 and K3 in its test export and serving
    for name, where in (*((k, "pascal_training") for k in TRAINING_KERNELS),
                        ("proto", "pascal_eval_test"),
                        ("upsample", "pascal_eval_test"),
                        ("proto", "pascal_serving"),
                        ("upsample", "pascal_serving"),
                        # this slice's: the MSC model in static quant8 and
                        # as an artifact, COCO-Stuff's training, eval and
                        # serving
                        *((k, w) for k in (*SERVING_KERNELS, *QUANT_KERNELS)
                          for w in ("msc_quant8_serving",
                                    "msc_artifact_quant8")),
                        *((k, w) for k in SERVING_KERNELS
                          for w in ("msc_artifact_serving", "coco_serving")),
                        *((k, w) for k in TRAINING_KERNELS
                          for w in ("coco_training", "coco_single_training")),
                        ("aspp", "coco_group_training"),
                        ("int8_absmax", "msc_quant8_dynamic"),
                        ("upsample", "coco_eval"),
                        # ADE20K's training, eval at both multiples and
                        # serving through the canvas
                        *((k, w) for k in TRAINING_KERNELS
                          for w in ("ade_training", "ade_single_training")),
                        ("aspp", "ade_group_training"),
                        ("upsample", "ade_eval"),
                        ("upsample", "ade_eval_exact"),
                        *((k, "ade_serving") for k in SERVING_KERNELS),
                        # EM's eval and serving at 512 x 512 (its training
                        # and K2 run none: em_phase holds them at 0)
                        ("upsample", "em_eval"),
                        *((k, "em_serving") for k in EM_PATH_KERNELS),
                        # the preprocessed Cityscapes data on the card, and
                        # serve of raw .png / .jpg inputs
                        *((k, "preprocess_training")
                          for k in TRAINING_KERNELS),
                        ("aspp", "preprocess_eval"),
                        ("upsample", "preprocess_eval"),
                        *((k, "preprocess_serving")
                          for k in SERVING_KERNELS)):
        if by_path[name][where] < 1:
            raise AssertionError(f"{name} never launched on {where}")
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
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all; seconds "
        f"by phase (build and kernel checks first) "
        f"{json.dumps({k: round(v, 1) for k, v in spans.items()})} on {smi}")
    log(smi)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
