#!/usr/bin/env python3
"""Smoke run of the PyTorch port's YOLOv4 serving, deployment and
training paths, of the YOLOv1.5, v2 and v3 families, of the ResNet,
MobileNetV2 and factory backbones and the classifiers, of YOLOv1.5's
int8 serving and the reference-weight converter, and of the parallel
layer's data-parallel, pipeline, tensor-parallel and spatially
partitioned paths, on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--batch 8] [--size 416]
                          [--requests 2] [--train-batch 32] [--steps 3]

Phases (each raises on failure, so the exit code is nonzero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels of tf2_yolo_tpu_torch/csrc, one nvcc each,
     all started together;
  3. check each kernel against its plain PyTorch version on the card at
     YOLOv4@416 layer shapes, bf16 and f32 (TF32 off for the plain
     versions), printing each shape's launch plan (route: tensor cores
     for bf16, CUDA cores for f32 and the shapes without 16-byte rows;
     tile config, grid, shared memory): conv + statistics (the stem, Ci
     = 3, and a ragged stem-like shape through the small-Ci kernel; and
     at the serving batch the flax-SAME geometries of YOLOv1.5 and the
     v2 UNet: the 7x7 stride-2 stem at 448^2 on the small-Ci kernel, the
     14^2 1024->1024 3x3 stride 2 and the 26^2 1024->512 2x2; at both
     batches the geometries of the ResNets and MobileNetV2: the ResNet
     stem's 7x7 stride 2 after a pad of 3 and MobileNetV2's 3x3 stride-2
     SAME stem on the small-Ci kernel, four 1x1 stride-2 convs on the
     ring, MobileNetV2's 1x1 convs of Ci 16, 24 and 144 on the CUDA
     cores; and the depthwise library call at MobileNetV2's largest
     depthwise shape, timed against its bound), the
     fused GEMM forward and backward, and the fused 3x3 conv forward and
     backward (with two ragged shapes) at the serving and the training
     batch (and again at the halved batch if phase 7 had to fall back),
     greedy NMS (its lattice words held to ``suppression_words_plain``;
     N=8 and 32 at K=128, 64 at K=256 (a chunk of phase 13), N=8 at
     K=1024 and one image at MAX_K, IoU and DIoU) and Soft-NMS at the
     same cells (its transposed lattice words held to
     ``soft_overlap_words_plain``; keep mismatches outside the band where
     the plain decayed confidence lies within 4 eps conf_threshold of it,
     at sigma 0.3 and 0.5, and at sigma 0.005 on coincident boxes, whose
     decay underflows to 0; the NMS kernels timed launched alone in a
     CUDA graph); time each, the tensor-core
     kernels also launched alone and beside the CUDA-core instance on
     the same bf16 inputs, with the
     one-call PyTorch equivalent where there is one (``F.conv2d``,
     ``torch.matmul`` or ``aten.convolution_backward`` on the activated
     input: a yardstick only; the port never calls it); the probe layer
     of ``tools/bench_packed_probe.py`` the same way, and its chain of
     four layers driven once with its counters read; the int8 conv
     (kernel Q: a quantize pass, then the ``wgmma`` conv) against
     ``conv_int8_plain`` at six YOLOv4 shapes (the stem on the gather
     route, a 52^2 1x1, four 3x3 layers, split over K at the serving
     batch where the tiles alone leave SMs idle, one of stride 2) at the
     serving batch and at 32, bf16 and f32 (and the served stem's f32
     image to bf16), equal bit for bit, Q, its quantize pass and its
     conv launch timed alone beside the first kernel (quantizing in its
     prologue, kept for this column), K1 and, at the 1x1 shape,
     ``torch._int_mm``; then hand each tensor-core route (Q's ring and
     gather routes and its int8 weights too) a contiguous view that
     starts one element past a 16-byte boundary and expect the
     ValueError,
     with no launch counted;
  4. serve ``--requests`` batches of ``--batch`` images through
     ``make_serving_fn`` in bf16 with greedy NMS, then one with Soft-NMS
     (``nms_mode=2``), with launch counters proving that every conv (107
     ConvBN + 3 head convs) and every NMS ran the kernels (the kernel of
     its mode, once a request), every conv on the tensor cores, and no
     fused kernel ran;
  5. in f32 on the same weights, compare the head logits and outputs of
     the kernel route with the plain route, then the NMS kernels (greedy
     IoU and DIoU, Soft-NMS) with the plain NMS on the same decoded rows;
  6. time both serving routes per request;
  7. train ``--steps`` steps of ``YoloV4(packed=3)`` in bf16 at batch
     ``--train-batch`` (halved once if it does not fit, which is printed
     and makes phase 3 run again at that batch) through
     ``make_train_step`` with Adam 1e-3 and synthetic labels, with launch
     counters proving that the five 3x3 convs of the backbone's stages
     1-2 ran the fused conv kernels (5 forwards, 5 backwards), every 1x1
     ConvBN of the backbone the fused GEMM kernels (43 forwards; 52
     backwards, one per input operand) and every other conv the conv
     kernel (62); every one of them on the tensor cores (the five fused
     convs both ways, the 43 fused GEMM forwards and 52 backward
     operands, the 62 convs); loss and gradients finite, running
     statistics moved. Then one step of ``YoloV4(packed=True)`` (stages
     1-2 on the plain path: 32 fused GEMM forwards and 35 backward
     operands, 78 convs, all on the tensor cores) the same way;
  8. one f32 step of ``packed=3`` at batch 2 on the kernel route and on
     the plain route from the same state: loss, every gradient, every
     updated parameter;
  9. time ``packed=3`` on both routes and ``packed=True`` on the kernel
     route per step, in turns, with the launch counters of every timed
     run held to those of phase 7 (none on the plain route);
 10. drive the user's path: ``yolov4.Yolo(416^2, 3 classes)`` ->
     ``create_model(packed=3, bf16, seed)`` -> ``compile("adam",
     yolo.loss(), yolo.metrics("obj+iou+recall0.5"))`` -> ``fit`` of 32
     in-memory uint8 images (labels encoded by the port's
     ``encode_to_grid`` / ``down2xlabel`` from seeded boxes) for 2 epochs
     at batch 16, with 8 validation images, EarlyStopping,
     ReduceLROnPlateau, CSVLogger and a checkpoint each epoch; then a
     ``resume=True`` fit that must skip both epochs, ``evaluate``,
     ``predict`` (equal, bit for bit, to the module in eval mode on the
     same batch, and uint8 equal to float / 255), a ``save_weights`` /
     ``load_weights`` round trip, and one step of sgd, rmsprop, adamw,
     ``accumulate_steps=2`` (no update after the first) and
     ``ema_decay=0.999``. Launch counters: phase 7's per train step, 110
     convs per evaluate / predict batch, all on the tensor cores. Then
     ``prefetch=2`` against the inline feed: the same batches bit for
     bit with a train step between them, and one epoch of ``fit`` from
     one saved state with each feed within two inline runs' spread. Last,
     ms/step through ``fit`` (inline feed and ``prefetch=2``) against the
     same train step called directly on batches already on the card, and
     the feed alone, in turns: the engine's host cost;
 11. deployment, on phase 4's weights: the f32 head outputs of the
     BN-folded model against the unfolded one's within phase 5's
     bounds, and a folded bf16 request's launches (110 convs, one NMS);
     ``calibrate_int8`` on two seeded batches, then int8 serving at gates
     256 and 0 (61 and 107 int8 launches a request, all on the tensor
     cores, and as many quantize passes, beside 110 minus those conv
     launches and one NMS), as a
     sanity check the confidence field of its sorted rows within
     max(0.15, the JAX package's own int8 bound; twice the bf16 rows'
     distance from the f32 rows') of the bf16 rows'; the kernel route
     against the plain route: at gate 0 the head logits (the int8 chain
     is exact on both, so only the three bf16 head convs differ), at
     gate 256 layer by layer on the kernel route's own inputs (each
     Int8ConvBN equal bit for bit, each K1 conv within its bf16 bound),
     and the whole programs' head logits printed beside; a gate-256
     request with the wrappers through their custom ops against the
     same request calling the implementations directly, in turns; then
     ``Yolo.export_model`` with buckets [1, ``--batch``], folded and int8
     at gate 256, ``load_serving``, and each loaded program's (rows,
     keep) equal bit for bit to ``make_serving_fn``'s at the batch and at
     3 (padded into the bucket), with the same launches; last, ms/request
     of unfolded, folded, int8 at 256, int8 at 0, the loaded folded
     artifact and a copy of it without export's dtype asserts (outputs
     and launches held equal) in turns at the serving batch and at
     ``bench_infer.py``'s
     32 (chunked through the artifact's largest bucket), and the seconds
     the export and the load took;
 12. the frozen-statistics BatchNorm backward (``scope="backbone"``):
     which ConvBNs it freezes (17 at ``packed=True``: the stem and stages
     1-2; none at ``packed=3``, whose backbone runs in packed regions,
     as the JAX package's), one f32 step at batch 2 of ``packed=True``
     and one of ``packed=3`` on the kernel route against the plain route
     as phase 8 holds them, the
     frozen step's gradients against the exact step's (the 17 frozen
     conv kernels move, the rest stay within noise), and ms/step of
     exact BN against the frozen backward at the training batch in bf16
     for ``packed=True`` and ``packed=3``, in turns, with phase 7's
     launches a step;
 13. device-side evaluation on phase 4's network: 64 seeded uint8
     images through ``engine.Model.predict`` at batch 32, labels from
     seeded boxes (and the top predictions, moved) through
     ``encode_to_grid``, a confidence threshold that leaves each image
     at most 250 candidates (printed; the saturation warning must not
     fire); then ``create_score_mat`` (precision modes 0-2) and
     ``PRfunc`` (``max_per_img`` 100, ``get_map`` in all four modes)
     with ``device=True`` (decode, the NMS kernel, matching on the card,
     ``device_max_boxes`` 256: one chunk of N=64, K=256) against
     ``device=False`` (the host path), for greedy, Soft and DIoU NMS:
     the kept boxes of each image equal but for Soft-NMS boxes whose
     decayed f32 confidence lies within (4 + 16 decays) eps of the
     threshold (the host decays in f64); the tables, the swept
     detections and the PR curves at the end of each group of equal f32
     confidences equal, and the whole curves and maps too where no two
     detections tie (the host ranks f64 products, the device f32 ones, both
     with NumPy's unstable argsort); a box kept by one path only is excused
     (and counted) where the other path keeps a box of the same image and
     class with a bit-equal f32 joint confidence that overlaps it at or
     above the NMS threshold (an exact tie, which the card breaks by index
     and the host by its unstable sort); K4 (modes 1, 3) or S (mode 2)
     launched once a chunk; the best-GT argmax on the card the first of tied
     maxima; ms of each path for the 64 images and of the chunk's NMS alone;
 14. the other families, each through its facade (``yolov3.Yolo`` ...
     ``create_model(dtype=bf16, seed)``) at full width, bf16, BN
     calibrated as phase 4's: YOLOv3 (Darknet-53) at 416^2 with
     ``DEFAULT_ANCHORS``, the slice's main path: 1 + 3 served batches of
     ``--batch`` (timed), the f32 model on the same weights served on the
     kernel and the plain route (head outputs within phase 5's bounds,
     kept rows found in the other route's), 1 + 3 Adam steps at batch 32
     on the facade's v3 loss list (timed; the loss falls), one f32 step
     at batch 2 on both routes by phase 8's rule (the leaves of the
     layers before the last activation input within 1e-4 of its kink
     held to 0.05: the routes' rounding may put it on the other side);
     then YOLOv3 tiny, YOLOv2 with DarkNet-19 and with the UNet at
     416^2 and YOLOv1.5 at 448^2: one served batch on both routes the
     same way and one bf16 step at batch 16 with a finite loss. The conv
     kernel's launches are the tree's conv count (ConvBN, ConvActBN and
     head convs, counted from the tree) a request and a step, and the
     NMS kernel's one a request; ms/request and ms/step of YOLOv3;
 15. the backbones, each through its facade at full width, bf16, BN
     calibrated as phase 4's, widths and depths uncut, new draws on a
     generator of their own: YOLOv4 with ResNet-50 at 416^2, the slice's
     main path, as phase 14's main path (1 + 3 requests of ``--batch``, 1 +
     3 Adam steps at batch 32, Adam 1e-4, the f32 routes) and also a
     BN-folded request and an int8 request at gate 256 as phase 11 holds
     them (the neck's ConvBNs on Q); YOLOv3 with ResNet-101 v2, YOLOv2 with
     MobileNetV2 (its depthwise convs counted apart) and YOLOv3 with a
     backbone factory (a ResNet-50 v1): one request and one step of 16 each;
     YOLOv4 with ResNet-152: one request; the csp_darknet53 (1000 classes,
     448^2) and darknet19 (416^2) classifiers: one step of 16 each. The conv
     kernel's launches are the tree's convs a request and a step, those on
     the tensor cores as their plans say;
 16. YOLOv1.5's SAME geometries on kernel Q and the converter, new draws
     on a generator of their own: (a) Q against ``conv_int8_plain`` at
     the 7x7 stride-2 SAME stem (448^2, the gather route, K = 147 padded
     to 160) and the 14^2 1024->1024 3x3 stride-2 SAME conv (the ring) at
     the serving batch and at 32, bf16 and f32 (and the served stem's f32
     image to bf16), equal bit for bit, timed as phase 3 times Q, beside
     K1 alone; (b) YOLOv1.5 at 448^2 through its facade, bf16, BN
     calibrated, ``calibrate_int8`` on two seeded batches, then
     ``make_serving_fn(quant=)`` at gates 0 and 256: the int8 ConvBNs by
     gate (23 at 0), Q's launches at the two SAME geometries counted
     (the stem at gate 0, the stride 2 at both), the kernel route held
     to the plain route by phase 11's rule, and ms/request of int8 at
     both gates and of bf16; (c) the reference-weight round trip of
     YOLOv4, YOLOv3 and YOLOv1.5 in memory on the card:
     ``convert.export_reference_weights`` of a model, the matching
     ``convert_*`` from the dict into a fresh model of another seed,
     the state_dicts and one served request equal bit for bit. The
     native reader is not driven here: the card's machine has no
     ``jpeglib.h``, ``png.h``, libjpeg or libpng to build it against;
 17. the parallel paths (YOLOv4 ``packed=3`` at 416^2, new draws from
     ``--seed`` + 17 for (b) and (c)): (a) a process group of one
     process (nccl through a HashStore, no socket) and ``set_bn_group``:
     phase 7's bf16 step at batch 32 against the same step without a
     group, the loss and the running statistics bit for bit, the
     gradients bit for bit or within twice the spread of two ungrouped
     runs (the fused kernels' dW adds with f32 atomics); (b) two
     processes on the one card (this script with ``--dp-child``, gloo
     over CUDA tensors through a FileStore in a temporary directory, 180
     s for both, killed on any failure), each on 16 of the same 32 rows
     of an f32 step, against one process on all 32: the loss by phase 8's
     bound, the gradients and the running statistics' step by its probe
     rule, the two processes' statistics and gradients equal, each
     process's K1/K2/K3 launches those of one step; (c)
     ``split_yolov4(n_stages=3)`` on cuda:0 x 3, f32 batch 16: ``run``
     bit for bit the eval forward, the frozen-statistics
     ``value_and_grad`` at microbatch 8 against the gradient-accumulated
     single program and train mode at microbatch 16 against the single
     train step by the probe rule, with their launches;
     ``merged_variables`` into a fresh YoloV4 and a save / load in a
     temporary directory bit for bit. ms/step of each beside the card;
 18. tensor parallelism and PP x DP (new draws from ``--seed`` + 18): K1
     at two of the slices that YOLOv4's sharded layers take at n_model 2
     (td1_pre2's 13^2 512->512 3x3 and stage3.pre's 52^2 256->64 1x1) at
     batch 16 against its plain version, timed as phase 3 times it; (a)
     two processes on the one card (this script with ``--tp-child``, gloo
     over CUDA tensors through a FileStore), ``engine.Model(YoloV4(
     packed=False), bf16).compile("adam", n_model=2)`` and ``fit`` of one
     step of the same 16 rows in both, against one process without tensor
     parallelism on the same weights and rows: the loss by phase 8's
     bound and the running statistics' step by its probe rule; the
     gathered gradients, leaf by leaf, bit for bit the unsliced bf16
     step's or, in rel L2 to the unsliced f32 step on the same weights
     and rows, within max(4 x the unsliced bf16 step's, 1e-3) (in bf16
     the probe itself moves most gradients past phase 8's 0.3 cap); the
     whole (unsliced) leaves and their Adam moments equal on both
     processes bit for bit, 110 K1 launches a step in each, all on the
     tensor cores (each sliced shape's plan and the wrapper's count of
     its launches printed), and the collectives counted: one channel
     gather and one cotangent all-reduce a sliced layer, on the model
     group; then ms/step of both beside the unsliced step. An f32 step
     of a fresh model (batch 4) on the same grid holds the gathered
     gradients, the loss and the statistics' step to phase 8's probe
     rule; (b) the checkpoint the two processes save (gathered,
     process 0 writes) restored into an unsliced YoloV4: its eval heads
     bit for bit the sliced model's, or within the rel L2 of the plain
     route to the kernel route; (c) ``split_yolov4(n_stages=2)`` of an f32
     ``packed=3`` YOLOv4, stage meshes of ranks {0, 1} and {2, 3} (this
     script four times with ``--pp-child``): ``run`` at microbatch 8 bit
     for bit the eval forward of the same rows, the frozen-statistics
     ``value_and_grad`` against the gradient-accumulated single program
     by the probe rule, each process's K1/K2/K3 launches, ms/step beside
     the single program's;
 19. spatial partitioning and the last tensor-parallel layer kinds (new
     draws from ``--seed`` + 19): K1 at three row slabs of (a)'s step
     (a stage-1 3x3 of the 208^2 level, 104 rows and one fetched, top
     pad 0; bu2_dn's darknet stride 2 on rows 13..25 of 26, an odd first
     row; the stem's rows 0..208 of 416 with the image's top pad, on the
     small-Ci route) at batch 16 against its plain version, timed as
     phase 3 times it; (a) two processes on the one card (this script
     with ``--space-child``, gloo), ``YoloV4(packed=False)`` bf16 at
     batch 16 under ``set_spatial_parallel`` on a ``(data 1, space 2)``
     grid (``make_mesh_spatial``; the 13^2 level splits 7 + 6), the
     gathered eval heads of 2 images and one step of the spatial train
     step (``make_train_step(mesh=)``), each process on its image rows
     of the same 16 images, against one process on the whole images and
     the same weights: loss, running statistics' step and eval heads bit
     for bit or, in rel L2 to the whole f32 model's, within min(0.3,
     max(4 x the whole bf16 model's, 1e-3)) (the precision rule,
     capped); the gradients by the same rule (a bias whose exact
     gradient is 0 measured over its layer's kernel or scale gradient)
     where the whole bf16 step's own distance leaves the limit under the
     cap: the random nets' bf16 steps are chaotic, their gradients 0.8-1.4
     in median rel L2 from the f32 step's, so the leaves at the cap are
     counted and printed with their distance to the whole bf16 step's,
     and every leaf is held by an f32 step at batch 4 by phase 8's probe
     rule; the row messages (forward fetches and backward
     returns: count, largest, elements; every message at most the 6 rows
     of SPP's window), 110 K1 launches a step in each process, all on
     the tensor cores, those at slab geometries counted, and ms/step
     beside the whole model's; (b) the same two processes on a ``(data
     1, model 2)`` grid: YOLOv4 with ResNet-50 and YOLOv2 with
     MobileNetV2 and with the UNet, bf16 at batch 8, one Adam step of a
     linear loss each, sliced at the default gate against unsliced by
     the same rules (the loss's distance over the sum of its terms'
     magnitudes: they have both signs), and an f32 step at batch 2 each
     by phase 8's probe rule, with the sliced leaves and the K1 launches
     of the sliced convs.

Weights are random, from ``--seed``: conv kernels drawn with the port's
HE_NORMAL from a seeded ``torch.Generator``. With BN at its init
statistics the 107-layer stack then has no scale control (its head
logits run to ~1e3 and every confidence saturates), so each BN's running
statistics are set to the batch statistics of its conv output on a
separate seeded calibration batch, as a trained network's BN holds
them. The confidence threshold is then the one that ~64 of each image's
lattice points pass on that calibration batch.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the per-kernel JSON summary. The build log and a JSON record of
every measurement go to ``--log-dir`` (default ``build/chip_smoke/``).
"""

import argparse
import collections
import contextlib
import copy
import ctypes
import functools
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from tf2_yolo_tpu_torch import convert as convert_mod
from tf2_yolo_tpu_torch import engine, yolov1_5, yolov2, yolov3, yolov4
from tf2_yolo_tpu_torch.data import encode_to_grid
from tf2_yolo_tpu_torch.export import (calibrate_int8, folded_copy,
                                       load_serving, make_serving_fn)
from tf2_yolo_tpu_torch.models import YoloV2, YoloV4, use_plain_route
from tf2_yolo_tpu_torch.models import layers as layers_mod
from tf2_yolo_tpu_torch import models as models_mod
from tf2_yolo_tpu_torch.models import ResNet
from tf2_yolo_tpu_torch.models.layers import (BNState, Conv, ConvActBN,
                                              ConvBN, DepthwiseConv,
                                              Int8ConvBN, glorot_uniform_,
                                              he_normal_, set_bn_stats_sg,
                                              set_spatial_parallel,
                                              set_tensor_parallel)
from tf2_yolo_tpu_torch.ops import nms as nms_ops
from tf2_yolo_tpu_torch.ops.decode import decode_multi_level
from tf2_yolo_tpu_torch.ops.evalmatch import match_pred_arrays
from tf2_yolo_tpu_torch.ops.kernels import _build
from tf2_yolo_tpu_torch.ops.kernels import conv_bn as conv_mod
from tf2_yolo_tpu_torch.ops.kernels import conv_int8 as int8_mod
from tf2_yolo_tpu_torch.ops.kernels import fused_conv3x3 as conv3_mod
from tf2_yolo_tpu_torch.ops.kernels import fused_gemm as gemm_mod
from tf2_yolo_tpu_torch.ops.kernels import nms as nms_mod
from tf2_yolo_tpu_torch.ops.kernels.conv_bn import (conv_bn_stats,
                                                    conv_bn_stats_plain)
from tf2_yolo_tpu_torch.ops.kernels.conv_int8 import (conv_int8,
                                                      conv_int8_plain)
from tf2_yolo_tpu_torch.ops.kernels.fused_conv3x3 import fused_conv3x3
from tf2_yolo_tpu_torch.ops.kernels.fused_gemm import (act_and_grad,
                                                       fused_gemm)
from tf2_yolo_tpu_torch.ops.kernels.nms import (nms_keep, nms_keep_plain,
                                                soft_nms_keep,
                                                soft_nms_keep_plain,
                                                soft_nms_scan_plain,
                                                soft_overlap_words_plain,
                                                suppression_words_plain)
from tf2_yolo_tpu_torch.ops.nms import _sorted_by_conf, apply_nms_device
from tf2_yolo_tpu_torch.ops.losses import wrap_yolo_loss_v4
from tf2_yolo_tpu_torch.parallel import (PipelineExecutor, create_train_state,
                                         distributed_initialize,
                                         distributed_shutdown, make_mesh,
                                         make_mesh_spatial, make_optimizer,
                                         make_train_step,
                                         process_batch_slice,
                                         restore_checkpoint, save_checkpoint,
                                         spatial_sharding, split_yolov4,
                                         tensor_parallel_shardings)
from tf2_yolo_tpu_torch.parallel.collectives import (gather_state_dict,
                                                     recording,
                                                     sharded_dims)
from tf2_yolo_tpu_torch.parallel.multihost import default_group
from tf2_yolo_tpu_torch.parallel.spatial import split_rows
from tf2_yolo_tpu_torch.parallel.train import TrainState
from tf2_yolo_tpu_torch.tools import bench_packed_probe as probe
from tf2_yolo_tpu_torch.tools.train_profile import (ANCHORS, CLASSES,
                                                    card_line, make_training,
                                                    timed_steps)
from tf2_yolo_tpu_torch.utils.measurement import (PRfunc, _decode_pair,
                                                  create_score_mat,
                                                  decode_batch_device)
from tf2_yolo_tpu_torch.utils.tools import decode as host_decode
from tf2_yolo_tpu_torch.utils.tools import down2xlabel

ROOT = os.path.dirname(os.path.abspath(__file__))
CONVS_PER_FORWARD = 110          # 107 ConvBN + 3 head convs
# one packed training step: the 1x1 ConvBNs of stages 3-5 (cross, pre,
# post, out and one squeeze per block; blocks = 8, 8, 4)
GEMMS_PER_STEP = 3 * 4 + 8 + 8 + 4
# the backward counts one per input operand, and each stage's ``out``
# reads two (the concat of post and cross)
GEMM_BWD_INPUTS_PER_STEP = GEMMS_PER_STEP + 3
CONVS_PER_STEP = CONVS_PER_FORWARD - GEMMS_PER_STEP
# launches of one training step by backbone route. packed=3 moves the 16
# ConvBNs of stages 1-2 (blocks = 1, 2) off the conv kernel: 5 of them
# 3x3 (two ``down``, three ``expand``) onto the fused conv, 11 of them
# 1x1 onto the fused GEMM, whose sum-GEMMs read 1, 2 or 3 terms
# (backward operands, stage 1: cross 1, pre 1, squeeze 1, post 2, out 2;
# stage 2: cross 1, pre 1, squeezes 1 + 2, post 3, out 2)
# Every bf16 kernel of a training step and a request runs on the tensor
# cores: the stem (Ci = 3) through the conv's small-Ci kernel.
TRAIN_LAUNCHES = {
    1: dict(fused_conv3x3_fwd=0, fused_conv3x3_fwd_tc=0,
            fused_conv3x3_bwd=0, fused_conv3x3_bwd_tc=0,
            fused_gemm_fwd=GEMMS_PER_STEP,
            fused_gemm_fwd_tc=GEMMS_PER_STEP,
            fused_gemm_bwd=GEMM_BWD_INPUTS_PER_STEP,
            fused_gemm_bwd_tc=GEMM_BWD_INPUTS_PER_STEP,
            conv_bn_stats=CONVS_PER_STEP,
            conv_bn_stats_tc=CONVS_PER_STEP),
    3: dict(fused_conv3x3_fwd=5, fused_conv3x3_fwd_tc=5,
            fused_conv3x3_bwd=5, fused_conv3x3_bwd_tc=5,
            fused_gemm_fwd=GEMMS_PER_STEP + 5 + 6,
            fused_gemm_fwd_tc=GEMMS_PER_STEP + 5 + 6,
            fused_gemm_bwd=GEMM_BWD_INPUTS_PER_STEP + 7 + 10,
            fused_gemm_bwd_tc=GEMM_BWD_INPUTS_PER_STEP + 7 + 10,
            conv_bn_stats=CONVS_PER_STEP - 16,
            conv_bn_stats_tc=CONVS_PER_STEP - 16),
}

# H100 SXM data sheet: device memory rate and dense peak rates (int8:
# operations of the s8 tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}


def bound_ms(nbytes, flops, dtype):
    """Least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

# (name, H, W, Ci, Co, k, stride): YOLOv4@416 layers, checked at the
# serving batch and at the training batch (whose statistics sum four
# times the rows): the layers that carry the conv time (the 3x3 s1
# expands of stages 3-5 and the neck) and the ragged edges of the tiles
# (13^2 rows that end inside a tile, N = 24 in a 32-wide tile, and a
# stem-like 9 x 7 image whose edges fall inside the small-Ci kernel's
# 8 x 16 pixel tile)
CONV_SHAPES = [
    ("stem 416^2 3->32 3x3s1", 416, 416, 3, 32, 3, 1),
    ("ragged stem 9x7 3->24 3x3s1", 9, 7, 3, 24, 3, 1),
    ("stage1.down 416^2 32->64 3x3s2", 416, 416, 32, 64, 3, 2),
    ("stage3.pre 52^2 256->128 1x1", 52, 52, 256, 128, 1, 1),
    ("stage3.block.expand 52^2 128->128 3x3s1", 52, 52, 128, 128, 3, 1),
    ("td1_pre1 13^2 1024->512 1x1", 13, 13, 1024, 512, 1, 1),
    ("td1_pre2 13^2 512->1024 3x3s1", 13, 13, 512, 1024, 3, 1),
    ("stage4.block.expand 26^2 256->256 3x3s1", 26, 26, 256, 256, 3, 1),
    ("td2.conv2 26^2 256->512 3x3s1", 26, 26, 256, 512, 3, 1),
    ("stage3.down 104^2 128->256 3x3s2", 104, 104, 128, 256, 3, 2),
    ("head3 52^2 256->24 1x1", 52, 52, 256, 24, 1, 1),
]
# The flax-SAME geometries of YOLOv1.5 and the v2 UNet (name, H, W, Ci,
# Co, k, stride, padding "same"), checked at the serving batch: the
# DarknetV1 stem (pad 2 above, 3 below; the small-Ci kernel), its 14^2
# -> 7^2 stride 2 (pad 0 above, 1 below) and the UNet decoder's 2x2
# (pad 0 above, 1 below)
SAME_CONV_SHAPES = [
    ("v1 stem 448^2 3->64 7x7s2 SAME", 448, 448, 3, 64, 7, 2, "same"),
    ("v1 14^2 1024->1024 3x3s2 SAME", 14, 14, 1024, 1024, 3, 2, "same"),
    ("unet 26^2 1024->512 2x2s1 SAME", 26, 26, 1024, 512, 2, 1, "same"),
]
# The geometries of the ResNets and MobileNetV2 (name, H, W, Ci, Co, k,
# stride, padding), checked at the serving and the
# training batch: the ResNet stem (pad 3, then 7x7 stride-2 VALID) and
# MobileNetV2's stem (3x3 stride-2 SAME, pad 0 on top) on the small-Ci
# kernel; the 1x1 stride-2 convs of the ResNets' first blocks (v1's conv1
# and every projection) on the ring; and MobileNetV2's 1x1 convs of Ci
# 16, 24 and 144, which fail the ring's Ci % 32 test and take the CUDA
# cores
BACKBONE_CONV_SHAPES = [
    ("resnet stem 416^2 3->64 7x7s2 pad3", 416, 416, 3, 64, 7, 2, 3),
    ("mobilenet stem 416^2 3->32 3x3s2 SAME", 416, 416, 3, 32, 3, 2,
     "same"),
    ("resnet 104^2 256->128 1x1s2", 104, 104, 256, 128, 1, 2, "same"),
    ("resnet 104^2 256->512 1x1s2", 104, 104, 256, 512, 1, 2, "same"),
    ("resnet 52^2 512->1024 1x1s2", 52, 52, 512, 1024, 1, 2, "same"),
    ("resnet 26^2 1024->2048 1x1s2", 26, 26, 1024, 2048, 1, 2, "same"),
    ("mobilenet 208^2 16->96 1x1", 208, 208, 16, 96, 1, 1, "same"),
    ("mobilenet 104^2 24->144 1x1", 104, 104, 24, 144, 1, 1, "same"),
    ("mobilenet 104^2 144->24 1x1", 104, 104, 144, 24, 1, 1, "same"),
]
# MobileNetV2's largest depthwise conv (block 2: 208^2, 96 channels,
# stride 2), the library's grouped conv on the port's path
DEPTHWISE_SHAPE = ("mobilenet block2 dw 208^2 96 3x3s2", 208, 208, 96, 2)
# Tolerances of kernel against plain, same inputs on the card.
# y: f32 sums of up to 9*Ci products in another order (4.6e3 terms at
# most): 1e-4 of the output's scale in f32; in bf16 both round the f32
# sum to 8 bits, and a sum that differs in its last f32 bits can round
# to the neighbouring bf16 value: 1/128 relative (2 bf16 ulps) plus 1e-3
# of scale.
# s1, s2 against the plain version's: the y differences and the plain
# version's own f32 summation, relative to sum|y| and sum(y^2): 1e-5 in
# f32, and in bf16 the share of rounding flips, bounded by 1/128.
# s1, s2 against f64 sums of the kernel's OWN y (its summation alone:
# f32 partials of 64 terms, f64 atomics, one rounding to f32): 2e-6 in
# either dtype, at any batch.
SUM_TOL = 2e-6
TOL = {torch.float32: dict(y_rel=1e-4, y_scale=1e-4, s_rel=1e-5),
       torch.bfloat16: dict(y_rel=2 ** -7, y_scale=1e-3, s_rel=2 ** -7)}
# greedy: the serving batch, bench_infer.py's batch 32, a chunk of the
# device evaluation (64 images of 256 candidates, phase 13), a large K,
# and one image at the largest K; Soft-NMS the same, at a confidence
# threshold that deletes some decayed boxes and keeps others, at two
# sigmas, then coincident boxes at a sigma whose decay underflows
NMS_CASES = [(8, 128), (32, 128), (64, 256), (8, 1024), (1, nms_mod.MAX_K)]
SOFT_CASES = [(n, k, sigma, False) for n, k in NMS_CASES
              for sigma in (0.3, 0.5)] + [(8, 128, 0.005, True)]
SOFT_CONF = 0.2


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def forward_errors(outs, plain, tol):
    """A kernel's (y, s1, s2) against its plain version's under ``tol``
    (keys y_rel, y_scale, s_rel), and s1, s2 against f64 sums of the
    kernel's own y. The last axis is the channel axis; sums are relative
    to sum|y| and sum y^2 of the channel."""
    (y, s1, s2), (yp, s1p, s2p) = outs, plain
    yf = y.float().reshape(-1, y.shape[-1])
    ypf = yp.float().reshape(yf.shape)
    err = (yf - ypf).abs()
    scale = ypf.abs().max().item()
    y_ok = bool((err <= tol["y_rel"] * ypf.abs()
                 + tol["y_scale"] * max(1.0, scale)).all())
    abs_sum = ypf.abs().sum(0).clamp(min=1e-30)
    sq_sum = (ypf * ypf).sum(0).clamp(min=1e-30)
    yd = yf.double()
    own = max(((s1 - yd.sum(0)).abs() / abs_sum).max().item(),
              ((s2 - (yd * yd).sum(0)).abs() / sq_sum).max().item())
    return dict(max_abs_err=err.max().item(), y_scale=scale, y_ok=y_ok,
                s1_rel_err=((s1 - s1p).abs() / abs_sum).max().item(),
                s2_rel_err=((s2 - s2p).abs() / sq_sum).max().item(),
                sum_rel_err=own)


def forward_line(r, tol):
    return (f"max|dy| {r['max_abs_err']:.3e} (|y| <= {r['y_scale']:.3g}; "
            f"bound {tol['y_rel']:.3g}*|y| + {tol['y_scale']:.0e}*scale) "
            f"s1 rel {r['s1_rel_err']:.2e} s2 rel {r['s2_rel_err']:.2e} "
            f"(bound {tol['s_rel']:.2e}), to f64 sums of its own y "
            f"{r['sum_rel_err']:.2e} (bound {SUM_TOL:.0e})")


def forward_ok(r, tol):
    """(y within its bound, statistics within theirs)."""
    return r["y_ok"], (max(r["s1_rel_err"], r["s2_rel_err"]) <= tol["s_rel"]
                       and r["sum_rel_err"] <= SUM_TOL)


def backward_errors(grads, grads_p, n_dx, tol, what):
    """The first ``n_dx`` gradients (dx, in the compute dtype) elementwise:
    1 ulp relative to the value plus y_scale of max|dx|; the others (dW,
    da, db) by relative L2. Returns (dx ok, max|d|/max|dx|, rel L2)."""
    dx_err, dx_ok, red_err = 0.0, True, 0.0
    for i, (g, gp) in enumerate(zip(grads, grads_p)):
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite gradient")
        if i < n_dx:
            gf, gpf = g.float(), gp.float()
            d = (gf - gpf).abs()
            top = gpf.abs().max().item()
            dx_ok &= bool((d <= tol["y_rel"] * gpf.abs()
                           + tol["y_scale"] * top).all())
            dx_err = max(dx_err, d.max().item() / max(top, 1e-30))
        else:
            red_err = max(red_err, rel_l2(g, gp))
    return dx_ok, dx_err, red_err


def backward_line(dx_err, red_err, tol):
    return (f"dx max|d|/max|dx| {dx_err:.2e} (bound {tol['y_rel']:.3g}*|dx| "
            f"+ {tol['y_scale']:.0e}*max|dx|); dW/da/db rel L2 "
            f"{red_err:.2e} (bound {tol['red_rel']:.0e})")


def rel_l2(a, b):
    return ((a.float() - b.float()).norm()
            / b.float().norm().clamp(min=1e-30)).item()


def plan_line(plan):
    return (f"{plan.route} config {plan.config} grid {plan.grid} smem "
            f"{plan.smem_bytes}")


def gemm_bwd_plan_line(plan):
    if plan.route != "tc":
        return plan.route
    return (f"tc dx config {plan.dx_config} grid {plan.dx_grid} smem "
            f"{plan.dx_smem}, dW config {plan.dw_config} grid "
            f"{plan.dw_grid} smem {plan.dw_smem} rows {plan.dw_rows}")


def bwd_plan_line(plan):
    return (f"{plan.route} dx config {plan.dx_config} grid {plan.dx_grid} "
            f"smem {plan.dx_smem}, dW grid {plan.dw_grid} smem "
            f"{plan.dw_smem}")


def phase_build(log_dir):
    t0 = time.perf_counter()
    _build.build_libraries([conv_mod.SOURCE, nms_mod.SOURCE,
                            gemm_mod.SOURCE, conv3_mod.SOURCE,
                            int8_mod.SOURCE])
    conv_mod._launcher()
    int8_mod._library()
    nms_mod._ready(torch.cuda.current_device())
    gemm_mod._library()
    conv3_mod._library()
    seconds = time.perf_counter() - t0
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "kernel_build.log"), "w") as f:
        for src, info in _build.build_info.items():
            f.write(f"== {src}: {info['seconds']:.2f} s\n{info['log']}\n")
    for src, info in _build.build_info.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  built {src} in {info['seconds']:.2f} s; ptxas: "
              f"{' | '.join(regs[:4])}")
    print(f"phase 2: kernels built in {seconds:.2f} s")
    return seconds


def conv_library_call(x, w, b, stride, padding="darknet"):
    """The one PyTorch call that computes the conv kernel's y: F.conv2d
    in the working dtype on a channels_last view of the NHWC tensor (no
    copy), weights laid out beforehand; where the geometry's pad is not
    symmetric (the darknet stride-2 pad, SAME's larger pad below) the
    input is padded beforehand. A yardstick only."""
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    pad = conv_mod._pads(x.shape[1], x.shape[2], w.shape[0], stride,
                         padding)
    if stride == 2 and padding == "darknet":
        pad = (1, 0, 1, 0)
    if not isinstance(pad, int):
        xc = F.pad(xc, pad).contiguous(memory_format=torch.channels_last)
        pad = 0
    return lambda: F.conv2d(xc, wc, b, stride=stride, padding=pad)


def cuda_core_conv_call(x, w, b, stride, padding="darknet"):
    """The conv's CUDA-core kernel on the same bf16 inputs, launched with
    the CUDA-core plan (64 x 64 tiles) where the wrapper's plan takes the
    tensor cores: the design before them, timed in the same call. Not
    counted (a comparison launch)."""
    n, h, wd, ci = x.shape
    k, co = w.shape[0], w.shape[-1]
    g = conv_mod.conv_geometry(h, wd, k, stride, padding)
    grid = (-(-n * g.ho * g.wo // 64), -(-co // 64))
    y = torch.empty(n, g.ho, g.wo, co, dtype=x.dtype, device=x.device)
    launch = conv_mod._launcher()

    def run():
        err = launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                     None, None, n, h, wd, ci, co, *g, k, stride,
                     conv_mod._DTYPE_CODES[x.dtype], 0, -1, *grid, 0,
                     torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"CUDA-core conv launch failed: cudaError {err}")
    return run


def cuda_core_conv3_call(x, w, affine, stride):
    """The fused conv's CUDA-core forward on the same bf16 inputs, as
    :func:`cuda_core_conv_call` does for the conv."""
    n, h, wd, k = x.shape
    co = w.shape[-1]
    m = n * (h // stride) * (wd // stride)
    grid = (-(-m // 64), -(-co // 64), 1)
    a, b = (None, None) if affine is None else (
        affine[0].float().contiguous(), affine[1].float().contiguous())
    y = torch.empty(n, h // stride, wd // stride, co, dtype=x.dtype,
                    device=x.device)
    s = torch.zeros(2, co, dtype=torch.float64, device=x.device)
    launch = conv3_mod._library().fused_conv3x3_fwd_launch

    def run():
        err = launch(x.data_ptr(), w.data_ptr(), conv3_mod._ptr(a),
                     conv3_mod._ptr(b), y.data_ptr(), s[0].data_ptr(),
                     s[1].data_ptr(), n, h, wd, k, co, stride,
                     conv3_mod._DTYPE_CODES[x.dtype],
                     conv3_mod._ACT_CODES["mish"], -1, *grid, 0,
                     torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"CUDA-core fused conv launch failed: cudaError "
                        f"{err}")
    return run


def gemm_launch_call(xs, ws, affines, act, route, raw_stats=False):
    """The fused GEMM forward's kernel of ``route`` ("tc": the plan's
    tensor-core config; "cuda_core": the CUDA-core instance) on the same
    inputs through its C entry, with the outputs and the ctypes arguments
    made beforehand: the kernel's own time, without the wrapper's host
    work (checks, plan, allocation), when launched back to back. Not
    counted (a comparison launch)."""
    m, n, ks = xs[0].shape[0], ws[0].shape[1], [x.shape[1] for x in xs]
    aas = [None if aff is None else aff[0].float().contiguous()
           for aff in affines]
    bbs = [None if aff is None else aff[1].float().contiguous()
           for aff in affines]
    y = torch.empty(m, n, dtype=xs[0].dtype, device="cuda")
    s = torch.zeros(2, n, dtype=torch.float64, device="cuda")
    lib = gemm_mod._library()
    args = (gemm_mod._ptr_array(xs), gemm_mod._ptr_array(ws),
            gemm_mod._ptr_array(aas), gemm_mod._ptr_array(bbs),
            (ctypes.c_int * len(xs))(*ks), len(xs), y.data_ptr(),
            s[0].data_ptr(), s[1].data_ptr(), m, n)
    stream = torch.cuda.current_stream().cuda_stream
    act_code = gemm_mod._ACT_CODES[act]
    if route == "tc":
        plan = gemm_mod._tc_plan(m, ks, n, xs[0].dtype)
        check(plan.route == "tc", f"gemm {ks}->{n}: no tensor-core plan")
        launch = lambda: lib.fused_gemm_fwd_tc_launch(
            *args, act_code, int(raw_stats), plan.config, *plan.grid,
            plan.smem_bytes, stream)
    else:
        launch = lambda: lib.fused_gemm_fwd_launch(
            *args, gemm_mod._DTYPE_CODES[xs[0].dtype], act_code,
            int(raw_stats), stream)

    def run():
        err = launch()
        check(err == 0, f"{route} gemm launch failed: cudaError {err}")
    run.keep = (xs, ws, aas, bbs, y, s)          # alive while run is
    return run


def gemm_library_call(xs, ws, affines, act):
    """torch.matmul of the ACTIVATED inputs, concatenated along K (the
    kernel's contraction), by the weights stacked the same way, both made
    beforehand. A yardstick only."""
    gs = [x if aff is None else
          act_and_grad(x.float() * aff[0] + aff[1], act)[0].to(x.dtype)
          for x, aff in zip(xs, affines)]
    g = torch.cat(gs, 1) if len(gs) > 1 else gs[0]
    w = torch.cat(ws, 0) if len(ws) > 1 else ws[0]
    return lambda: torch.matmul(g, w)


def gemm_bwd_launch_call(xs, ws, affines, y, cts, act, route):
    """The fused GEMM backward's kernels of ``route`` ("tc": the ds1
    table, dx and dW of the plan, all inputs in one call; "cuda_core":
    the CUDA-core dx and dW per input) on the same inputs through their
    C entry, with outputs and arguments made beforehand, as
    :func:`gemm_launch_call`. dW, da and db accumulate over repeated
    runs (timing only); not counted."""
    m, n, ks = y.shape[0], y.shape[1], [x.shape[1] for x in xs]
    aas = [None if aff is None else aff[0].float().contiguous()
           for aff in affines]
    bbs = [None if aff is None else aff[1].float().contiguous()
           for aff in affines]
    dy = cts[0].contiguous()
    ds1, ds2 = cts[1].float().contiguous(), cts[2].float().contiguous()
    dxs = [torch.empty_like(x) for x in xs]
    dws = [torch.zeros(k, n, dtype=torch.float32, device="cuda")
           for k in ks]
    dab = torch.zeros(2, sum(ks), dtype=torch.float64, device="cuda")
    lib = gemm_mod._library()
    stream = torch.cuda.current_stream().cuda_stream
    act_code = gemm_mod._ACT_CODES[act]
    if route == "tc":
        plan = gemm_mod._tc_bwd_plan(m, ks, n, xs[0].dtype)
        check(plan.route == "tc", f"gemm {ks}->{n}: no tensor-core "
                                  "backward plan")
        ctab = torch.empty(sum(ks), dtype=torch.float32, device="cuda")
        ptrs = gemm_mod._ptr_array
        args = (ptrs(xs), ptrs(ws), ptrs(aas), ptrs(bbs),
                (ctypes.c_int * len(xs))(*ks), len(xs), y.data_ptr(),
                dy.data_ptr(), ds1.data_ptr(), ds2.data_ptr(),
                ctab.data_ptr(), ptrs(dxs), ptrs(dws), dab[0].data_ptr(),
                dab[1].data_ptr(), m, n, act_code, plan.dx_config,
                *plan.dx_grid, plan.dx_smem, plan.dw_config, *plan.dw_grid,
                plan.dw_smem, plan.dw_rows, stream)
        launch = lambda: lib.fused_gemm_bwd_tc_launch(*args)
        keep = (ctab,)
    else:
        offs = [sum(ks[:i]) for i in range(len(ks))]
        per_input = [
            (x.data_ptr(), w.data_ptr(), conv3_mod._ptr(a),
             conv3_mod._ptr(b), y.data_ptr(), dy.data_ptr(),
             ds1.data_ptr(), ds2.data_ptr(), dx.data_ptr(), dw.data_ptr(),
             dab[0, off:].data_ptr(), dab[1, off:].data_ptr(), m,
             x.shape[1], n, gemm_mod._DTYPE_CODES[x.dtype], act_code,
             stream)
            for x, w, a, b, dx, dw, off in zip(xs, ws, aas, bbs, dxs, dws,
                                               offs)]
        launch = lambda: max(lib.fused_gemm_bwd_launch(*a)
                             for a in per_input)
        keep = ()

    def run():
        err = launch()
        check(err == 0, f"{route} gemm backward launch failed: cudaError "
                        f"{err}")
    run.keep = (aas, bbs, dy, ds1, ds2, dxs, dws, dab, keep)
    return run


def gemm_bwd_library_call(xs, ws, affines, y, cts, act):
    """``aten.convolution_backward`` (dx and dW, bf16, channels_last) of
    the 1x1 conv on the ACTIVATED inputs, concatenated along K, with the
    folded cotangent dyt = T(dy + ds1 + 2 y ds2), all made beforehand:
    the GEMM core of the fused backward, as :func:`conv_bwd_library_call`
    is of the fused 3x3 conv's. The rows are one image of M x 1 pixels. A
    yardstick only."""
    gs = [x if aff is None else
          act_and_grad(x.float() * aff[0] + aff[1], act)[0].to(x.dtype)
          for x, aff in zip(xs, affines)]
    g = torch.cat(gs, 1) if len(gs) > 1 else gs[0]
    w = torch.cat(ws, 0) if len(ws) > 1 else ws[0]
    dy, ds1, ds2 = cts
    dyt = (dy.float() + ds1 + 2.0 * y.float() * ds2).to(y.dtype)
    m, k = g.shape
    xc = g.view(1, m, 1, k).permute(0, 3, 1, 2)
    wc = w.t().contiguous().view(w.shape[1], k, 1, 1)
    go = dyt.view(1, m, 1, -1).permute(0, 3, 1, 2)
    return lambda: torch.ops.aten.convolution_backward(
        go, xc, wc, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
        [True, True, False])


def conv3_bwd_launch_call(x, wt, affine, y, cts, stride, route):
    """The fused conv's backward kernels of ``route`` ("tc": the ds1
    table, dx and dW of the plan; "cuda_core": the CUDA-core dx and dW)
    on the same bf16 inputs through their C entry, with outputs and
    arguments made beforehand, as :func:`gemm_launch_call`. dW, da and
    db accumulate over repeated runs (timing only); not counted."""
    n, h, wd, k = x.shape
    co = y.shape[-1]
    a, b = (None, None) if affine is None else (
        affine[0].float().contiguous(), affine[1].float().contiguous())
    dy = cts[0].contiguous()
    ds1, ds2 = cts[1].float().contiguous(), cts[2].float().contiguous()
    dx = torch.empty_like(x)
    dw = torch.zeros(3, 3, k, co, dtype=torch.float32, device="cuda")
    dab = torch.zeros(2, k, dtype=torch.float64, device="cuda")
    ctab = torch.empty(9 * k, dtype=torch.float32, device="cuda")
    lib = conv3_mod._library()
    ptr = conv3_mod._ptr
    head = (x.data_ptr(), wt.data_ptr(), ptr(a), ptr(b), y.data_ptr(),
            dy.data_ptr(), ds1.data_ptr(), ds2.data_ptr())
    tail = (dx.data_ptr(), dw.data_ptr(),
            None if a is None else dab[0].data_ptr(),
            None if a is None else dab[1].data_ptr(), n, h, wd, k, co,
            stride)
    stream = torch.cuda.current_stream().cuda_stream
    act = conv3_mod._ACT_CODES["mish"]
    if route == "tc":
        plan = conv3_mod._tc_bwd_plan(n, h, wd, k, co, stride, x.dtype)
        check(plan.route == "tc", f"conv3x3 {tuple(x.shape)}: no "
                                  "tensor-core plan")
        launch = lambda: lib.fused_conv3x3_bwd_tc_launch(
            *head, ctab.data_ptr(), *tail, act, plan.dx_config,
            *plan.dx_grid, plan.dx_smem, *plan.dw_grid[:2], plan.dw_smem,
            stream)
    else:
        launch = lambda: lib.fused_conv3x3_bwd_launch(
            *head, *tail, conv3_mod._DTYPE_CODES[x.dtype], act, stream)

    def run():
        err = launch()
        check(err == 0, f"{route} conv3x3 backward launch failed: "
                        f"cudaError {err}")
    run.keep = (a, b, dy, ds1, ds2, dx, dw, dab, ctab)
    return run


def conv_bwd_library_call(g_in, wt, dyt, stride):
    """``aten.convolution_backward`` (dx and dW, bf16, channels_last) of
    the conv on the ACTIVATED input with the folded cotangent dyt =
    T(T(dy + 2 y ds2) + ds1): the GEMM core of the fused backward, as
    F.conv2d is of the forward (the stride-2 input padded on top and
    left beforehand). A yardstick only."""
    xc = g_in.permute(0, 3, 1, 2)
    wc = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    pad = 1
    if stride == 2:
        xc = F.pad(xc, (1, 0, 1, 0)).contiguous(
            memory_format=torch.channels_last)
        pad = 0
    go = dyt.permute(0, 3, 1, 2)
    return lambda: torch.ops.aten.convolution_backward(
        go, xc, wc, None, [stride, stride], [pad, pad], [1, 1], False,
        [0, 0], 1, [True, True, False])


def phase_conv_checks(gen, n, shapes=None):
    """Every conv shape at batch ``n`` (``CONV_SHAPES``, the darknet
    geometries, unless ``shapes`` says otherwise; a shape's optional
    eighth field is its ``padding``), statistics on, against the plain version; all shapes are
    printed before a failure raises."""
    results, failed = [], []
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[dtype]
        for shape in shapes or CONV_SHAPES:
            name, h, w, ci, co, k, stride = shape[:7]
            pad = shape[7] if len(shape) > 7 else "darknet"
            x = torch.randn(n, h, w, ci, generator=gen, device="cuda")
            wt = torch.empty(k, k, ci, co, device="cuda")
            he_normal_(wt, gen)
            b = 0.1 * torch.randn(co, generator=gen, device="cuda")
            x, wt, b = x.to(dtype), wt.to(dtype), b.to(dtype)
            plan = conv_mod._tc_plan(n, h, w, ci, co, k, stride, dtype, pad)
            before = conv_bn_stats.launches, conv_bn_stats.tc_launches
            y, s1, s2 = conv_bn_stats(x, wt, b, stride, want_stats=True,
                                      padding=pad)
            check((conv_bn_stats.launches, conv_bn_stats.tc_launches)
                  == (before[0] + 1, before[1] + (plan.route == "tc")),
                  f"conv {name}: the wrapper did not launch its kernel")
            yp, s1p, s2p = conv_bn_stats_plain(x, wt, b, stride, True, pad)
            torch.cuda.synchronize()
            fwd = forward_errors((y, s1, s2), (yp, s1p, s2p), tol)
            ms = cuda_ms(lambda: conv_bn_stats(x, wt, b, stride, False,
                                               padding=pad), 5)
            plain_ms = cuda_ms(
                lambda: conv_bn_stats_plain(x, wt, b, stride, False, pad), 5)
            flop = 2.0 * y.numel() * k * k * ci
            # the pixels of x that the conv reads: all of them where the
            # window covers the stride, else (a 1x1 stride-2 conv) only
            # the N * Ho * Wo pixels at the window's corner
            x_read = x.numel() if k >= stride else y.numel() // co * ci
            nbytes = (x_read + wt.numel() + b.numel() + y.numel()) \
                * x.element_size()
            bound, bound_by = bound_ms(nbytes, flop, dtype)
            library_ms = cuda_ms(
                conv_library_call(x, wt, b, stride, pad), 5)
            cc_ms = None
            if plan.route == "tc":
                cc_ms = cuda_ms(
                    cuda_core_conv_call(x, wt, b, stride, pad), 5)
            r = dict(shape=name, batch=n, padding=pad,
                     dtype=str(dtype).replace("torch.", ""), **fwd, ms=ms,
                     plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                     library_ms=library_ms,
                     kernel_tflops=flop / ms / 1e9, bound_share=bound / ms,
                     route=plan.route, config=plan.config,
                     cuda_core_ms=cc_ms)
            results.append(r)
            print(f"  conv {r['dtype']:8s} b{n:<2d} {name:40s} "
                  f"[{plan_line(plan)}] {forward_line(r, tol)} | "
                  f"kernel {ms:.3f} ms ({r['kernel_tflops']:.2f} TFLOP/s, "
                  f"{bound / ms:.1%} of bound) plain {plain_ms:.3f} ms, "
                  f"F.conv2d channels_last {library_ms:.3f} ms, bound "
                  f"{bound:.4f} ms ({bound_by})"
                  + ("" if cc_ms is None
                     else f", CUDA-core kernel {cc_ms:.3f} ms"))
            y_ok, s_ok = forward_ok(r, tol)
            if not y_ok:
                failed.append(f"{name} b{n} {r['dtype']}: y")
            if not s_ok:
                failed.append(f"{name} b{n} {r['dtype']}: statistics")
            del x, y, yp
    check(not failed, f"conv outside the bound: {failed}")
    return results


# (name, H, W, Ci, Co, k, stride): YOLOv4@416 ConvBNs that the int8
# program quantizes: the stem (a gate of 0 only; Ci = 3, the gather
# route), a 1x1 and four 3x3 layers of the deep stages (the 26^2
# 256->256 expand runs 8 times a request, the 52^2 down is the stride-2
# route); at the serving batch the 13^2 and 26^2 256->256 layers split K
INT8_SHAPES = [
    ("stem 416^2 3->32 3x3s1", 416, 416, 3, 32, 3, 1),
    ("stage3.pre 52^2 256->128 1x1", 52, 52, 256, 128, 1, 1),
    ("td1_pre2 13^2 512->1024 3x3s1", 13, 13, 512, 1024, 3, 1),
    ("td2.conv2 26^2 256->512 3x3s1", 26, 26, 256, 512, 3, 1),
    ("stage4.block.expand 26^2 256->256 3x3s1", 26, 26, 256, 256, 3, 1),
    ("stage4.down 52^2 256->512 3x3s2", 52, 52, 256, 512, 3, 2),
]
# Phase 16: Q at flax's SAME geometries, YOLOv1.5's two (name, H, W, Ci,
# Co, k, stride, padding): the DarknetV1 stem (pad 2 above and left, 3
# below and right; the gather route, K = 147 padded to 160) and the 14^2
# -> 7^2 stride 2 (pad 0 above, 1 below; the ring)
INT8_SAME_SHAPES = [
    ("v1 stem 448^2 3->64 7x7s2 SAME", 448, 448, 3, 64, 7, 2, "same"),
    ("v1 14^2 1024->1024 3x3s2 SAME", 14, 14, 1024, 1024, 3, 2, "same"),
]


def int8_plan_line(plan):
    return (f"{plan.route} config {plan.config} grid {plan.grid} split "
            f"{plan.splits} stages {plan.stages} kp {plan.kp} smem "
            f"{plan.smem_bytes}")


def phase_int8_checks(gen, n, shapes=None):
    """Kernel Q against ``conv_int8_plain`` at each INT8_SHAPES shape (or
    ``shapes``, whose entries may add a padding: phase 16) at batch
    ``n``, bf16 -> bf16 and f32 -> f32 (and the served stem's f32
    image -> bf16): equal bit for bit (int32 sums are exact and the
    epilogue has no FMA contraction), on the route, tile, split and ring
    that ``_plan`` picks. Times, each launched alone in a CUDA graph (so
    that the wrapper's host work does not show): Q (``ms``: its two
    launches), the quantize pass alone, the conv launch alone on the
    pass's output (replayed, so its split-K counters must clear
    themselves: its output is held equal too), the first kernel
    (``conv_int8_before_launch``, quantizing in its prologue; also held
    equal; at the geometries it takes, those of INT8_SHAPES) and K1
    (``conv_bn_stats``, bf16, no statistics) at the same shape; Q
    through its wrapper and through the wrapper's implementation
    without the custom op (its dispatch cost), the plain version, and for
    the 1x1 shape the one-call yardstick ``torch._int_mm`` on the same
    int8 operands alone."""
    results, failed = [], []
    bf, f32 = torch.bfloat16, torch.float32
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for name, h, w, ci, co, k, stride, *rest in shapes or INT8_SHAPES:
        padding = rest[0] if rest else "darknet"
        first_kernel = not rest
        kern = torch.empty(k, k, ci, co, device="cuda")
        he_normal_(kern, gen)
        wq8, sw = int8_mod.quantize_weights(kern)
        wq = int8_mod.weight_layout(wq8)
        t = 0.1 * torch.randn(co, generator=gen, device="cuda")
        plan = int8_mod._plan(n, h, w, ci, co, k, stride, padding)
        dtypes = [(bf, bf), (f32, f32)] + ([(f32, bf)] if ci == 3 else [])
        for in_dt, out_dt in dtypes:
            x = torch.randn(n, h, w, ci, generator=gen,
                            device="cuda").to(in_dt)
            sx = float((x.float().abs().amax() / 127.0).item())
            c = ((sx * sw) * (0.5 + torch.rand(co, generator=gen,
                                               device="cuda"))).contiguous()
            before = (conv_int8.launches, conv_int8.tc_launches,
                      conv_int8.quant_launches)
            y = conv_int8(x, wq, c, t, sx, k, stride, out_dt,
                          padding=padding)
            check((conv_int8.launches, conv_int8.tc_launches,
                   conv_int8.quant_launches)
                  == (before[0] + 1, before[1] + 1, before[2] + 1),
                  f"int8 {name}: the wrapper did not launch its kernels")
            yp = conv_int8_plain(x, wq, c, t, sx, k, stride, out_dt,
                                 padding)
            torch.cuda.synchronize()
            equal = torch.equal(y, yp)
            err = (y.float() - yp.float()).abs().max().item()
            ms = graph_ms(lambda: conv_int8(x, wq, c, t, sx, k, stride,
                                            out_dt, padding=padding))
            # the two launches apart, on scratch of the same plan
            xq, ws, counters = int8_mod._buffers(x, plan, co, k, stride,
                                                 padding)
            y_conv = torch.empty_like(y)
            int8_mod._quantize_launch(x, sx, xq, counters, k, stride, plan,
                                      stream(), padding)
            quant_ms = graph_ms(lambda: int8_mod._quantize_launch(
                x, sx, xq, None, k, stride, plan, stream(), padding))
            conv_ms = graph_ms(lambda: int8_mod._conv_launch(
                xq, wq, c, t, y_conv, ws, counters, k, stride, plan,
                stream(), padding))
            y_before = before_ms = None
            if first_kernel:
                y_before = int8_mod._before_forward(x, wq, c, t, sx, k,
                                                    stride, out_dt)
                before_ms = graph_ms(lambda: int8_mod._before_forward(
                    x, wq, c, t, sx, k, stride, out_dt))
            torch.cuda.synchronize()
            conv_equal = torch.equal(y_conv, yp)
            before_equal = y_before is None or torch.equal(y_before, yp)
            wrapper_ms = cuda_ms(lambda: conv_int8(
                x, wq, c, t, sx, k, stride, out_dt, padding=padding), 20)
            # the same launches without the custom op's dispatch
            direct_ms = cuda_ms(lambda: int8_mod._impl(
                x, wq, c, t, sx, k, stride, out_dt, padding), 20)
            plain_ms = cuda_ms(lambda: conv_int8_plain(
                x, wq, c, t, sx, k, stride, out_dt, padding), 2)
            m = y.numel() // co
            ops = 2.0 * m * co * k * k * ci
            nbytes = (x.numel() * x.element_size() + wq.numel() + 8 * co
                      + y.numel() * y.element_size())
            bound, bound_by = bound_ms(nbytes, ops, torch.int8)
            k1_ms = library_ms = None
            if in_dt == bf:
                kb, bb = kern.to(bf), torch.zeros(co, dtype=bf,
                                                  device="cuda")
                k1_ms = graph_ms(lambda: conv_bn_stats(
                    x, kb, bb, stride, False, padding=padding))
            if k == 1:
                xm = int8_mod.quantize_int8_plain(x, sx).reshape(m, ci)
                wt = wq[:, :ci].t().contiguous()
                library_ms = graph_ms(lambda: torch._int_mm(xm, wt))
            r = dict(shape=name, batch=n, dtype=f"{in_dt} -> {out_dt}"
                     .replace("torch.", ""), equal=equal,
                     conv_equal=conv_equal, before_equal=before_equal,
                     max_abs_err=err, ms=ms, quant_ms=quant_ms,
                     conv_ms=conv_ms, before_ms=before_ms,
                     wrapper_ms=wrapper_ms, direct_ms=direct_ms,
                     plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                     library_ms=library_ms, k1_bf16_ms=k1_ms,
                     tops=ops / ms / 1e9, bound_share=bound / ms,
                     route=plan.route, config=plan.config,
                     grid=list(plan.grid), splits=plan.splits,
                     stages=plan.stages, padding=str(padding))
            results.append(r)
            print(f"  int8 {r['dtype']:20s} b{n:<2d} {name:40s} "
                  f"[{int8_plan_line(plan)}] equal {equal} (max|d| "
                  f"{err:.3g}; the conv launch replayed alone {conv_equal}"
                  + ("" if y_before is None
                     else f", the first kernel {before_equal}")
                  + f") | Q alone {ms:.4f} ms "
                  f"({r['tops']:.1f} TOP/s, {bound / ms:.1%} of bound): "
                  f"quantize pass {quant_ms:.4f} + conv {conv_ms:.4f} ms; "
                  + ("" if before_ms is None else
                     f"before (the first kernel) {before_ms:.4f} ms; ")
                  + f"through "
                  f"the wrapper {wrapper_ms:.3f} ms (without the custom op "
                  f"{direct_ms:.3f} ms), plain {plain_ms:.3f} ms, bound "
                  f"{bound:.4f} ms ({bound_by})"
                  + ("" if k1_ms is None
                     else f", K1 bf16 alone {k1_ms:.4f} ms")
                  + ("" if library_ms is None
                     else f", torch._int_mm {library_ms:.4f} ms"))
            if not (equal and conv_equal and before_equal):
                failed.append(f"{name} b{n} {r['dtype']}")
            del x, y, yp, xq, ws, counters, y_conv, y_before
    check(not failed, f"int8 kernel differs from its plain version: "
          f"{failed}")
    return results


def sorted_boxes(gen, n, k, n_box, classes=3):
    """(n, k, 8) rows [x,y,w,h,conf,cls,prob,valid] in clusters, sorted
    by joint confidence, the first n_box valid."""
    rows = torch.rand(n, k, 7, generator=gen, device="cuda")
    rows[..., :2] = 0.5 + 0.15 * torch.randn(n, k, 2, generator=gen,
                                             device="cuda")
    rows[..., 2:4] = rows[..., 2:4] * 0.3 + 0.05
    rows[..., 5] = torch.randint(0, classes, (n, k), generator=gen,
                                 device="cuda").float()
    valid = torch.zeros(n, k, dtype=torch.bool, device="cuda")
    valid[:, :n_box] = True
    rows, valid = _sorted_by_conf(rows, valid)
    return torch.cat([rows, valid[..., None].float()], -1).contiguous()


def graph_ms(fn, reps=20, iters=5):
    """Device time of one ``fn()`` launched alone: ``reps`` calls captured
    in a CUDA graph, replayed ``iters`` times between CUDA events, so
    that the host's time per call (ctypes, allocation) does not show."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * reps)
    del graph
    return ms


def phase_nms_checks(gen):
    """Greedy NMS against the plain version (keep masks, and the lattice
    in scratch against ``suppression_words_plain``), timed launched alone
    and through the wrapper."""
    results = []
    for n, k in NMS_CASES:
        boxes = sorted_boxes(gen, n, k, n_box=k * 3 // 4)
        for mode in (1, 2):
            plan = nms_mod._plan(n, k)
            keep_p = nms_keep_plain(boxes, 0.45, mode)
            keep, lattice = nms_mod._launch(boxes, 0.45, mode, plan)
            torch.cuda.synchronize()
            mismatches = int((keep != keep_p).sum())
            words_p = suppression_words_plain(boxes, 0.45, mode)
            word_mismatches = int((lattice != words_p).sum())
            del words_p, lattice
            check(mismatches == 0 and word_mismatches == 0,
                  f"nms K={k} mode {mode}: {mismatches} keep, "
                  f"{word_mismatches} word mismatches")
            ms = graph_ms(lambda: nms_mod._launch(boxes, 0.45, mode, plan))
            wrapper_ms = cuda_ms(lambda: nms_keep(boxes, 0.45, mode), 10)
            iters = 2 if k <= 1024 else 1
            plain_ms = cuda_ms(lambda: nms_keep_plain(boxes, 0.45, mode),
                               iters)
            # least work: each box read and each flag written once; a
            # greedy pass needs an overlap (about 25 f32 operations) of
            # every kept box with every valid box after it
            valid_after = boxes[..., 7].flip(1).cumsum(1).flip(1) \
                - boxes[..., 7]
            pairs = float((keep * valid_after).sum())
            bound, bound_by = bound_ms(boxes.numel() * 4 + keep.numel() * 4,
                                       25.0 * pairs, torch.float32)
            r = dict(n=n, k=k, iou_mode=mode, plan=plan._asdict(),
                     mismatches=mismatches, word_mismatches=word_mismatches,
                     max_abs_err=(keep - keep_p).abs().max().item(),
                     kept=int(keep.sum()), valid=int(boxes[..., 7].sum()),
                     ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                     bound_ms=bound, bound_by=bound_by,
                     bound_share=bound / ms)
            results.append(r)
            print(f"  nms N={n} K={k} {'IoU' if mode == 1 else 'DIoU'}: "
                  f"{plan.words} words a row, lattice grid "
                  f"{plan.lattice_grid}, scan smem {plan.smem_bytes}; kept "
                  f"{r['kept']} of {r['valid']}; 0 mismatches (bound 0)")
            print(f"    alone {ms:.4f} ms | wrapper {wrapper_ms:.4f} ms | "
                  f"plain {plain_ms:.3f} ms (no one-call equivalent) | "
                  f"bound {bound:.2e} ms ({bound_by}), share "
                  f"{bound / ms:.2e}")
            check(0 < r["kept"] < r["valid"], "nms: degenerate test rows")
    return results


def coincident_boxes(gen, n, k):
    """(n, k, 8) sorted rows: half of them random, the other half their
    copies at 0.9 of the confidence (IoU 1 with the original)."""
    rows = torch.rand(n, k // 2, 7, generator=gen, device="cuda")
    rows[..., :2] = 0.5 + 0.15 * torch.randn(n, k // 2, 2, generator=gen,
                                             device="cuda")
    rows[..., 2:4] = rows[..., 2:4] * 0.3 + 0.05
    rows[..., 5] = torch.randint(0, 3, (n, k // 2), generator=gen,
                                 device="cuda").float()
    copies = rows.clone()
    copies[..., 4] *= 0.9
    rows = torch.cat([rows, copies], 1)
    valid = torch.ones(n, k, dtype=torch.bool, device="cuda")
    rows, valid = _sorted_by_conf(rows, valid)
    return torch.cat([rows, valid[..., None].float()], -1).contiguous()


def soft_band(boxes, keep, nms_threshold, conf_threshold, sigma):
    """Kernel keep against the plain scan: mismatches outside and inside
    the band where the plain decayed confidence lies within
    4 eps_f32 * conf_threshold of the threshold (expf against the plain
    version's exp may round either way there), and the band's size."""
    valid, deleted, conf = soft_nms_scan_plain(boxes, nms_threshold,
                                               conf_threshold, sigma)
    keep_p = (valid & ~deleted).float()
    band = valid & ((conf - conf_threshold).abs()
                    <= 4 * torch.finfo(torch.float32).eps * conf_threshold)
    differ = keep != keep_p
    return dict(mismatches_outside=int((differ & ~band).sum()),
                mismatches_in_band=int((differ & band).sum()),
                in_band=int(band.sum()),
                max_abs_err=(keep - keep_p).abs().max().item(),
                kept=int(keep.sum()), kept_plain=int(keep_p.sum()),
                valid=int(valid.sum()), deleted_plain=int(deleted.sum()),
                zero_conf=int((valid & (conf == 0)).sum()))


def phase_soft_checks(gen):
    """Soft-NMS: the kernel against the plain scan at each case (keep
    masks, and the transposed lattice in scratch against
    ``soft_overlap_words_plain``), timed launched alone and through the
    wrapper."""
    results = []
    for n, k, sigma, coincident in SOFT_CASES:
        boxes = (coincident_boxes(gen, n, k) if coincident
                 else sorted_boxes(gen, n, k, n_box=k * 3 // 4))
        plan = nms_mod._plan(n, k)
        keep, lattice = nms_mod._soft_launch(boxes, 0.45, SOFT_CONF, sigma,
                                             plan)
        torch.cuda.synchronize()
        words_p = soft_overlap_words_plain(boxes, 0.45)
        word_mismatches = int((lattice != words_p).sum())
        overlaps = sum(int(((words_p >> b) & 1).sum()) for b in range(64))
        del words_p, lattice
        r = dict(n=n, k=k, sigma=sigma, coincident=coincident,
                 conf_threshold=SOFT_CONF, plan=plan._asdict(),
                 word_mismatches=word_mismatches, overlaps=overlaps,
                 **soft_band(boxes, keep, 0.45, SOFT_CONF, sigma))
        r["ms"] = graph_ms(lambda: nms_mod._soft_launch(
            boxes, 0.45, SOFT_CONF, sigma, plan))
        r["wrapper_ms"] = cuda_ms(
            lambda: soft_nms_keep(boxes, 0.45, SOFT_CONF, sigma), 10)
        r["plain_ms"] = cuda_ms(lambda: soft_nms_keep_plain(
            boxes, 0.45, SOFT_CONF, sigma), 2 if k <= 1024 else 1)
        # least work: an IoU (about 25 f32 operations) for every valid,
        # same-class pair i < j, and a decay (exp, about 10 more) for
        # each such pair that overlaps
        v = boxes[..., 7] != 0
        same = ((boxes[:, :, None, 5] == boxes[:, None, :, 5])
                & v[:, :, None] & v[:, None, :]).triu(diagonal=1)
        ops = 25.0 * float(same.sum()) + 10.0 * overlaps
        del same
        r["bound_ms"], r["bound_by"] = bound_ms(
            boxes.numel() * 4 + keep.numel() * 4, ops, torch.float32)
        r["bound_share"] = r["bound_ms"] / r["ms"]
        results.append(r)
        print(f"  soft-nms N={n} K={k} sigma {sigma}"
              f"{' coincident' if coincident else ''}: kept {r['kept']} "
              f"of {r['valid']} (plain deleted {r['deleted_plain']}, "
              f"{r['zero_conf']} decayed to 0, {overlaps} overlapping "
              f"pairs); {r['mismatches_outside']} mismatches outside the "
              f"band (bound 0), {r['mismatches_in_band']} inside, "
              f"{r['in_band']} boxes in the band; {word_mismatches} word "
              f"mismatches (bound 0) | alone "
              f"{r['ms']:.4f} ms, wrapper {r['wrapper_ms']:.4f} ms, "
              f"plain {r['plain_ms']:.3f} ms (no one-call equivalent) "
              f"| bound {r['bound_ms']:.2e} ms ({r['bound_by']}), "
              f"share {r['bound_share']:.2e}")
        check(r["mismatches_outside"] == 0 and word_mismatches == 0,
              f"soft-nms N={n} K={k} sigma {sigma}: "
              f"{r['mismatches_outside']} keep, {word_mismatches} word "
              f"mismatches")
        check(0 < r["kept"] < r["valid"] and r["deleted_plain"] > 0,
              "soft-nms: degenerate test rows")
        # every copy's decay by its original underflows to 0
        check(not coincident or r["zero_conf"] >= n * (k // 2),
              "soft-nms: coincident rows did not underflow")
    return results


# (name, rows per image, [K_i], N, prologue per input, act, equal weights)
# at the training batch: the 1x1 ConvBNs of the packed stages
GEMM_SHAPES = [
    ("stage3.pre 52^2 256->128 prologue", 52 * 52, [256], 128, [True],
     "mish", False),
    ("stage3.post 52^2 128->128 activated", 52 * 52, [128], 128, [False],
     "mish", False),
    ("stage3.out 52^2 128+128->256 prologue", 52 * 52, [128, 128], 256,
     [True, True], "mish", False),
    ("stage5.cross 13^2 1024->512 prologue", 13 * 13, [1024], 512, [True],
     "mish", False),
    ("sum of 3 terms 13^2 512->512", 13 * 13, [512, 512, 512], 512,
     [True, True, False], "mish", True),
    ("stage1.squeeze 208^2 64->32 prologue", 208 * 208, [64], 32, [True],
     "mish", False),
    ("stage1.post 208^2 sum of 2 terms 64->64", 208 * 208, [64, 64], 64,
     [True, True], "mish", True),
    ("stage2.post 104^2 sum of 3 terms 64->64", 104 * 104, [64, 64, 64],
     64, [True, True, True], "mish", True),
    ("stage2.out 104^2 64+64->128 prologue", 104 * 104, [64, 64], 128,
     [True, True], "mish", False),
    ("ragged M=1237 96->72 leaky", None, [96], 72, [True], "leaky", False),
    ("ragged M=1237 96+40->72 linear", None, [96, 40], 72, [True, False],
     "linear", False),
]
# Tolerances of the fused GEMM kernels against their plain versions.
# y: as the conv (f32 sums in another order; in bf16 a sum that differs
# in its last f32 bits can round to the neighbouring bf16 value, 1 ulp).
# s1, s2: relative to sum|y| and sum y^2 (the plain version's f32
# summation, plus the share of rounding flips in bf16), and against f64
# sums of the kernel's own y within SUM_TOL, as the conv's. dx: 1 ulp of
# the dtype relative to the value plus y_scale of max|dx| (dg is a sum
# of three products that may cancel). dW, da, db: relative L2 to their
# norms; sums of M products in another order (for dW a random-walk error
# of about eps * sqrt(M) ~ 2e-5 at M = 86528) and, in bf16, operands that
# flip by one ulp.
GEMM_TOL = {torch.float32: dict(y_rel=1e-4, y_scale=1e-4, s_rel=1e-5,
                                red_rel=2e-3),
            torch.bfloat16: dict(y_rel=2 ** -7, y_scale=1e-3, s_rel=2 ** -7,
                                 red_rel=2e-3)}


def gemm_case(gen, dtype, m, ks, n, pattern, equal_w):
    xs = [torch.randn(m, k, generator=gen, device="cuda").to(dtype)
          for k in ks]
    ws = [(torch.randn(k, n, generator=gen, device="cuda")
           / (sum(ks) ** 0.5)).to(dtype) for k in ks]
    if equal_w:
        ws = [ws[0]] * len(ks)
    affines = []
    for k, on in zip(ks, pattern):
        a = 1.0 + 0.2 * torch.randn(k, generator=gen, device="cuda")
        b = 0.1 * torch.randn(k, generator=gen, device="cuda")
        affines.append((a, b) if on else None)
    dy = (1e-3 * torch.randn(m, n, generator=gen, device="cuda")).to(dtype)
    ds1 = 1e-3 * torch.randn(n, generator=gen, device="cuda")
    ds2 = 1e-4 * torch.randn(n, generator=gen, device="cuda")
    return xs, ws, affines, (dy, ds1, ds2)


def gemm_run(xs, ws, affines, act, dtype, cts, plain):
    """Forward and backward through the public wrapper; returns
    (y, s1, s2) and the gradients of every x, w, a, b."""
    xs = [x.detach().requires_grad_() for x in xs]
    ws = [w.detach().requires_grad_() for w in ws]
    affines = [None if aff is None else
               tuple(t.detach().requires_grad_() for t in aff)
               for aff in affines]
    outs = fused_gemm(xs, ws, affines, act=act, dtype=dtype, plain=plain)
    leaves = xs + ws + [t for aff in affines if aff is not None
                        for t in aff]
    grads = torch.autograd.grad(outs, leaves, cts, retain_graph=True)
    return outs, leaves, grads


def phase_gemm_checks(gen, batch):
    """Every fused GEMM shape at batch ``batch`` (the ragged rows at
    their own M), forward and backward, against the plain versions,
    printing each shape's forward and backward plans. Forward times: the
    wrapper (``ms``), the routed kernel launched alone (``launch_ms``),
    the CUDA-core instance on the same bf16 inputs (``cuda_core_ms``)
    and torch.matmul of the activated inputs (``library_ms``). Backward
    times: through autograd and the wrapper (``bwd_ms``), the routed
    kernels launched alone (``bwd_launch_ms``), the CUDA-core kernels on
    the same bf16 inputs (``bwd_cuda_core_ms``) and
    ``aten.convolution_backward`` on the activated inputs with the
    folded cotangent (``bwd_library_ms``)."""
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        tol = GEMM_TOL[dtype]
        size = torch.finfo(dtype).bits // 8
        for name, rows, ks, n, pattern, act, equal_w in GEMM_SHAPES:
            m = 1237 if rows is None else batch * rows
            xs, ws, affines, cts = gemm_case(gen, dtype, m, ks, n, pattern,
                                             equal_w)
            plan = gemm_mod._tc_plan(m, ks, n, dtype)
            bplan = gemm_mod._tc_bwd_plan(m, ks, n, dtype)
            fwd0, bwd0 = fused_gemm.launches, fused_gemm.bwd_launches
            tc0, btc0 = fused_gemm.tc_launches, fused_gemm.bwd_tc_launches
            (y, s1, s2), leaves, grads = gemm_run(
                xs, ws, affines, act, dtype, cts, plain=False)
            check(fused_gemm.launches == fwd0 + 1
                  and fused_gemm.bwd_launches == bwd0 + len(ks)
                  and fused_gemm.tc_launches == tc0 + (plan.route == "tc")
                  and fused_gemm.bwd_tc_launches
                  == btc0 + len(ks) * (bplan.route == "tc"),
                  f"gemm {name}: the wrapper did not launch its kernels")
            (yp, s1p, s2p), _, grads_p = gemm_run(
                xs, ws, affines, act, dtype, cts, plain=True)
            torch.cuda.synchronize()
            fwd = forward_errors((y, s1, s2), (yp, s1p, s2p), tol)
            dx_ok, dx_err, red_err = backward_errors(
                grads, grads_p, len(xs), tol, f"gemm {name}")
            k_sum = sum(ks)
            k_pro = sum(k for k, on in zip(ks, pattern) if on)
            flops = 2.0 * m * k_sum * n
            fwd_bytes = (m * k_sum + k_sum * n + m * n) * size \
                + 8 * k_pro + 8 * n
            # backward: x, w, a, b, dy, ds1, ds2 in; dx (T), dW, da, db
            # (f32) out; two products (dx and dW) of the forward's size.
            # y is not counted: the function can recompute it from x, so
            # the port's read of the stored y is its own cost
            bwd_bytes = (2 * m * k_sum + k_sum * n + m * n) * size \
                + 4 * k_sum * n + 16 * k_pro + 8 * n
            fb, fby = bound_ms(fwd_bytes, flops, dtype)
            bb, bby = bound_ms(bwd_bytes, 2 * flops, dtype)
            run = lambda plain: fused_gemm(xs, ws, affines, act=act,
                                           dtype=dtype, plain=plain)
            ms = cuda_ms(lambda: run(False), 5)
            launch_ms = cuda_ms(
                gemm_launch_call(xs, ws, affines, act, plan.route), 20)
            cc_ms = None
            if plan.route == "tc":
                cc_ms = cuda_ms(
                    gemm_launch_call(xs, ws, affines, act, "cuda_core"), 5)
            library_ms = cuda_ms(gemm_library_call(xs, ws, affines, act),
                                 20)
            plain_ms = cuda_ms(lambda: run(True), 5)
            outs_k = gemm_run(xs, ws, affines, act, dtype, cts, False)
            outs_p = gemm_run(xs, ws, affines, act, dtype, cts, True)
            bwd = lambda o: torch.autograd.grad(o[0], o[1], cts,
                                                retain_graph=True)
            bwd_ms = cuda_ms(lambda: bwd(outs_k), 5)
            bwd_plain_ms = cuda_ms(lambda: bwd(outs_p), 5)
            del outs_k, outs_p
            y = y.detach()
            bwd_launch_ms = cuda_ms(gemm_bwd_launch_call(
                xs, ws, affines, y, cts, act, bplan.route), 10)
            bwd_cc_ms = None
            if bplan.route == "tc":
                bwd_cc_ms = cuda_ms(gemm_bwd_launch_call(
                    xs, ws, affines, y, cts, act, "cuda_core"), 3)
            bwd_library_ms = cuda_ms(gemm_bwd_library_call(
                xs, ws, affines, y, cts, act), 10)
            r = dict(shape=name, m=m, batch=batch,
                     dtype=str(dtype).replace("torch.", ""),
                     **fwd, dx_rel_to_max=dx_err, red_rel_l2=red_err,
                     ms=ms, launch_ms=launch_ms, plain_ms=plain_ms,
                     bound_ms=fb, bound_by=fby, library_ms=library_ms,
                     cuda_core_ms=cc_ms, route=plan.route,
                     config=plan.config, bwd_ms=bwd_ms,
                     bwd_plain_ms=bwd_plain_ms, bwd_bound_ms=bb,
                     bwd_bound_by=bby,
                     fwd_tflops=flops / launch_ms / 1e9,
                     bound_share=fb / launch_ms,
                     bwd_tflops=2 * flops / bwd_ms / 1e9,
                     bwd_route=bplan.route, bwd_launch_ms=bwd_launch_ms,
                     bwd_cuda_core_ms=bwd_cc_ms,
                     bwd_library_ms=bwd_library_ms,
                     bwd_launch_tflops=2 * flops / bwd_launch_ms / 1e9,
                     bwd_bound_share=bb / bwd_launch_ms)
            results.append(r)
            print(f"  gemm {r['dtype']:8s} {name:38s} M={m} "
                  f"[{plan_line(plan)}; backward {gemm_bwd_plan_line(bplan)}]"
                  f": {forward_line(r, tol)}; "
                  f"{backward_line(dx_err, red_err, tol)} | fwd kernel "
                  f"{launch_ms:.3f} ms ({r['fwd_tflops']:.2f} TFLOP/s, "
                  f"{fb / launch_ms:.1%} of bound), through the wrapper "
                  f"{ms:.3f}"
                  + ("" if cc_ms is None
                     else f", CUDA-core kernel {cc_ms:.3f}")
                  + f", plain {plain_ms:.3f}, torch.matmul on the "
                  f"activated input {library_ms:.3f}, bound {fb:.4f} "
                  f"({fby}) | bwd kernels {bwd_launch_ms:.3f} ms "
                  f"({r['bwd_launch_tflops']:.2f} TFLOP/s, "
                  f"{bb / bwd_launch_ms:.1%} of bound), through autograd "
                  f"{bwd_ms:.3f}"
                  + ("" if bwd_cc_ms is None
                     else f", CUDA-core kernels {bwd_cc_ms:.3f}")
                  + f", plain {bwd_plain_ms:.3f}, convolution_backward on "
                  f"the activated input {bwd_library_ms:.3f}, bound "
                  f"{bb:.4f} ({bby})")
            y_ok, s_ok = forward_ok(r, tol)
            check(y_ok, f"gemm {name} {dtype}: y outside the bound")
            check(s_ok, f"gemm {name} {dtype}: statistics outside the bound")
            check(dx_ok, f"gemm {name} {dtype}: dx outside the bound")
            check(red_err <= tol["red_rel"],
                  f"gemm {name} {dtype}: dW/da/db outside the bound")
    return results


# (name, H, W, K, N, stride, prologue): the five fused 3x3 convs of one
# packed=3 training step (the two ``expand`` convs of stage 2 share one
# shape), the stem's shape, K = 3, without a prologue, and two shapes
# whose edges fall inside the tensor-core kernels' tiles (16-wide pixel
# tiles that overhang, K = 48 and N = 72 inside the dW kernel's 32 x 64
# channel blocks, a K = 16 input without a prologue)
CONV3_SHAPES = [
    ("stage1.down 416^2 32->64 s2 prologue", 416, 416, 32, 64, 2, True),
    ("stage1.block1.expand 208^2 32->64 s1 prologue", 208, 208, 32, 64, 1,
     True),
    ("stage2.down 208^2 64->128 s2 prologue", 208, 208, 64, 128, 2, True),
    ("stage2.block.expand 104^2 64->64 s1 prologue", 104, 104, 64, 64, 1,
     True),
    ("stem shape 416^2 3->32 s1 as it is", 416, 416, 3, 32, 1, False),
    ("ragged 26x22 48->72 s2 prologue", 26, 22, 48, 72, 2, True),
    ("ragged 9x11 16->24 s1 as it is", 9, 11, 16, 24, 1, False),
]


def conv3_case(gen, dtype, n, h, w, k, co, stride, prologue):
    x = torch.randn(n, h, w, k, generator=gen, device="cuda").to(dtype)
    wt = (torch.randn(3, 3, k, co, generator=gen, device="cuda")
          / (9 * k) ** 0.5).to(dtype)
    affine = None
    if prologue:
        affine = (1.0 + 0.2 * torch.randn(k, generator=gen, device="cuda"),
                  0.1 * torch.randn(k, generator=gen, device="cuda"))
    ho, wo = h // stride, w // stride
    dy = (1e-3 * torch.randn(n, ho, wo, co, generator=gen,
                             device="cuda")).to(dtype)
    ds1 = 1e-3 * torch.randn(co, generator=gen, device="cuda")
    ds2 = 1e-4 * torch.randn(co, generator=gen, device="cuda")
    return x, wt, affine, (dy, ds1, ds2)


def conv3_run(x, wt, affine, stride, dtype, cts, plain):
    """Forward and backward through the public wrapper; returns
    (y, s1, s2), the leaves and their gradients (x, w, then a, b)."""
    x = x.detach().requires_grad_()
    wt = wt.detach().requires_grad_()
    if affine is not None:
        affine = tuple(t.detach().requires_grad_() for t in affine)
    outs = fused_conv3x3(x, wt, affine, stride=stride, act="mish",
                         dtype=dtype, plain=plain)
    leaves = [x, wt] + list(affine or ())
    grads = torch.autograd.grad(outs, leaves, cts, retain_graph=True)
    return outs, leaves, grads


def phase_conv3_checks(gen, n):
    """The fused 3x3 conv, forward and backward, at every shape at batch
    ``n`` against its plain versions, with the tolerances of the fused
    GEMM (``GEMM_TOL``: the same kinds of sums, over 9K products for y,
    at most 9N for dx and B*Ho*Wo for dW, da, db), printing each shape's
    forward and backward plans. Backward times: through autograd and the
    wrapper (``bwd_ms``), the routed kernels launched alone
    (``bwd_launch_ms``), the CUDA-core kernels on the same bf16 inputs
    (``bwd_cuda_core_ms``) and ``aten.convolution_backward`` on the
    activated input with the folded cotangent (``bwd_library_ms``)."""
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        tol = GEMM_TOL[dtype]
        size = torch.finfo(dtype).bits // 8
        for name, h, w, k, co, stride, prologue in CONV3_SHAPES:
            x, wt, affine, cts = conv3_case(gen, dtype, n, h, w, k, co,
                                            stride, prologue)
            plan = conv3_mod._tc_plan(n, h, w, k, co, stride, dtype)
            bplan = conv3_mod._tc_bwd_plan(n, h, w, k, co, stride, dtype)
            fwd0, bwd0 = fused_conv3x3.launches, fused_conv3x3.bwd_launches
            tc0 = fused_conv3x3.tc_launches
            btc0 = fused_conv3x3.tc_bwd_launches
            (y, s1, s2), _, grads = conv3_run(x, wt, affine, stride, dtype,
                                              cts, plain=False)
            check(fused_conv3x3.launches == fwd0 + 1
                  and fused_conv3x3.bwd_launches == bwd0 + 1
                  and fused_conv3x3.tc_launches
                  == tc0 + (plan.route == "tc")
                  and fused_conv3x3.tc_bwd_launches
                  == btc0 + (bplan.route == "tc"),
                  f"conv3x3 {name}: the wrapper did not launch its kernels")
            (yp, s1p, s2p), _, grads_p = conv3_run(x, wt, affine, stride,
                                                   dtype, cts, plain=True)
            torch.cuda.synchronize()
            fwd = forward_errors((y, s1, s2), (yp, s1p, s2p), tol)
            dx_ok, dx_err, red_err = backward_errors(
                grads, grads_p, 1, tol, f"conv3x3 {name}")
            ho, wo = h // stride, w // stride
            m = n * ho * wo
            flops = 2.0 * m * 9 * k * co
            k_pro = k if prologue else 0
            fwd_bytes = (x.numel() + wt.numel() + y.numel()) * size \
                + 8 * k_pro + 8 * co
            # backward: x, w, a, b, dy, ds1, ds2 in; dx (T), dW, da, db
            # (f32) out; two products of the forward's size. The stored
            # y is not counted (the function can recompute it from x)
            bwd_bytes = (2 * x.numel() + wt.numel() + y.numel()) * size \
                + 4 * wt.numel() + 16 * k_pro + 8 * co
            fb, fby = bound_ms(fwd_bytes, flops, dtype)
            bb, bby = bound_ms(bwd_bytes, 2 * flops, dtype)
            run = lambda plain: fused_conv3x3(x, wt, affine, stride=stride,
                                              dtype=dtype, plain=plain)
            ms = cuda_ms(lambda: run(False), 5)
            cc_ms = None
            if plan.route == "tc":
                cc_ms = cuda_ms(cuda_core_conv3_call(x, wt, affine, stride),
                                5)
            plain_ms = cuda_ms(lambda: run(True), 3)
            outs_k = conv3_run(x, wt, affine, stride, dtype, cts, False)
            bwd_ms = cuda_ms(lambda: torch.autograd.grad(
                outs_k[0], outs_k[1], cts, retain_graph=True), 5)
            del outs_k
            outs_p = conv3_run(x, wt, affine, stride, dtype, cts, True)
            bwd_plain_ms = cuda_ms(lambda: torch.autograd.grad(
                outs_p[0], outs_p[1], cts, retain_graph=True), 3)
            del outs_p
            y = y.detach()
            bwd_launch_ms = cuda_ms(conv3_bwd_launch_call(
                x, wt, affine, y, cts, stride, bplan.route), 10)
            bwd_cc_ms = None
            if bplan.route == "tc":
                bwd_cc_ms = cuda_ms(conv3_bwd_launch_call(
                    x, wt, affine, y, cts, stride, "cuda_core"), 3)
            # the one-call yardstick computes the conv without the
            # prologue: both it and the kernel take the activated input
            g_in = x
            if prologue:
                g_in = act_and_grad(x.float() * affine[0] + affine[1],
                                    "mish")[0].to(dtype)
            bare_ms = cuda_ms(lambda: fused_conv3x3(
                g_in, wt, None, stride=stride, dtype=dtype), 5)
            library_ms = cuda_ms(conv_library_call(g_in, wt, None, stride),
                                 5)
            dy, ds1, ds2 = cts
            dyt = ((dy.float() + y.float() * (2.0 * ds2)).to(dtype).float()
                   + ds1).to(dtype)
            bwd_library_ms = cuda_ms(
                conv_bwd_library_call(g_in, wt, dyt, stride), 5)
            del g_in, dyt
            r = dict(shape=name, batch=n,
                     dtype=str(dtype).replace("torch.", ""), **fwd,
                     dx_rel_to_max=dx_err, red_rel_l2=red_err, ms=ms,
                     plain_ms=plain_ms,
                     bound_ms=fb, bound_by=fby, bare_ms=bare_ms,
                     library_ms=library_ms, bwd_ms=bwd_ms,
                     bwd_plain_ms=bwd_plain_ms, bwd_bound_ms=bb,
                     bwd_bound_by=bby, fwd_tflops=flops / ms / 1e9,
                     bwd_tflops=2 * flops / bwd_ms / 1e9,
                     bound_share=fb / ms, route=plan.route,
                     config=plan.config, cuda_core_ms=cc_ms,
                     bwd_route=bplan.route, bwd_launch_ms=bwd_launch_ms,
                     bwd_cuda_core_ms=bwd_cc_ms,
                     bwd_library_ms=bwd_library_ms,
                     bwd_launch_tflops=2 * flops / bwd_launch_ms / 1e9,
                     bwd_bound_share=bb / bwd_launch_ms)
            results.append(r)
            print(f"  conv3x3 {r['dtype']:8s} b{n:<2d} {name:46s} "
                  f"[{plan_line(plan)}; backward {bwd_plan_line(bplan)}] "
                  f"{forward_line(r, tol)}; "
                  f"{backward_line(dx_err, red_err, tol)} | fwd {ms:.3f} ms "
                  f"({r['fwd_tflops']:.2f} TFLOP/s, {fb / ms:.1%} of bound) "
                  + ("" if cc_ms is None
                     else f"CUDA-core kernel {cc_ms:.3f} ")
                  + f"plain {plain_ms:.3f} "
                  f"bound {fb:.4f} ({fby}); on the activated input: kernel "
                  f"{bare_ms:.3f} F.conv2d channels_last {library_ms:.3f}"
                  f" | bwd kernels {bwd_launch_ms:.3f} ms "
                  f"({r['bwd_launch_tflops']:.2f} TFLOP/s, "
                  f"{bb / bwd_launch_ms:.1%} of bound), through autograd "
                  f"{bwd_ms:.3f}"
                  + ("" if bwd_cc_ms is None
                     else f", CUDA-core kernels {bwd_cc_ms:.3f}")
                  + f", plain {bwd_plain_ms:.3f}, convolution_backward on "
                  f"the activated input {bwd_library_ms:.3f}, bound "
                  f"{bb:.4f} ({bby})")
            y_ok, s_ok = forward_ok(r, tol)
            check(y_ok, f"conv3x3 {name} {dtype}: y outside the bound")
            check(s_ok,
                  f"conv3x3 {name} {dtype}: statistics outside the bound")
            check(dx_ok, f"conv3x3 {name} {dtype}: dx outside the bound")
            check(red_err <= tol["red_rel"],
                  f"conv3x3 {name} {dtype}: dW/da/db outside the bound")
            del x, wt, y, yp, grads, grads_p, cts
    return results


def misaligned(gen, shape, dtype=torch.bfloat16):
    """A contiguous tensor of ``shape`` on the card that starts one
    element past a 16-byte boundary (a view into a larger buffer)."""
    numel = int(np.prod(shape))
    base = torch.randn(numel + 1, generator=gen, device="cuda").to(dtype)
    view = base[1:].view(shape)
    check(view.is_contiguous() and view.data_ptr() % 16 != 0,
          "misaligned view")
    return view


def all_counters():
    return (conv_bn_stats.launches, conv_bn_stats.tc_launches,
            conv_int8.launches, conv_int8.tc_launches,
            conv_int8.quant_launches,
            *fused_counters().values())


def phase_alignment_checks(gen):
    """Each tensor-core route handed one contiguous but misaligned tensor
    (16-byte loads and ``cp.async`` copies would fault on it) must raise
    ValueError before it launches anything: the int8 conv's input on its
    ring and gather routes (the quantize pass reads 16-byte chunks) and
    its int8 weights, the conv (ring and small-Ci kernels), the fused
    GEMM forward and backward, the fused 3x3 conv forward and backward.
    Any other outcome fails the phase."""
    bf = torch.bfloat16
    rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                     device="cuda").to(bf)
    f32 = lambda *shape: 1e-3 * torch.randn(*shape, generator=gen,
                                            device="cuda")
    gx, gw = rnd(200, 64), rnd(64, 64)
    gy = torch.empty(200, 64, dtype=bf, device="cuda")
    cx = rnd(1, 9, 11, 16)
    cw = rnd(3, 3, 16, 8)
    cy = torch.empty(1, 9, 11, 8, dtype=bf, device="cuda")
    qw = int8_mod.weight_layout(int8_mod.quantize_weights(
        f32(3, 3, 32, 32))[0])
    qw3 = int8_mod.weight_layout(int8_mod.quantize_weights(
        f32(3, 3, 3, 32))[0])
    qc, qt = f32(32) + 1e-2, f32(32)
    cases = [
        ("conv_int8 ring, x", lambda: conv_int8(
            misaligned(gen, (2, 13, 13, 32)), qw, qc, qt, 0.1, 3, 1, bf)),
        ("conv_int8 gather, x", lambda: conv_int8(
            misaligned(gen, (2, 9, 7, 3)), qw3, qc, qt, 0.1, 3, 1, bf)),
        ("conv_int8, int8 weights", lambda: conv_int8(
            rnd(2, 13, 13, 32), misaligned(gen, qw.shape, torch.int8), qc,
            qt, 0.1, 3, 1, bf)),
        ("conv_bn_stats tc, x", lambda: conv_bn_stats(
            misaligned(gen, (2, 13, 13, 32)), rnd(3, 3, 32, 32), rnd(32),
            1)),
        ("conv_bn_stats small-Ci tc, w", lambda: conv_bn_stats(
            rnd(2, 9, 7, 3), misaligned(gen, (3, 3, 3, 32)), rnd(32), 1)),
        ("fused_gemm forward tc, x", lambda: fused_gemm(
            [misaligned(gen, (200, 64))], [gw], [None])),
        ("fused_gemm backward tc, dy", lambda: gemm_mod._backward_cuda(
            [gx], [gw], [None], [None], gy, misaligned(gen, (200, 64)),
            f32(64), f32(64), "mish")),
        ("fused_conv3x3 forward tc, x", lambda: fused_conv3x3(
            misaligned(gen, (1, 9, 11, 16)), cw, None)),
        ("fused_conv3x3 backward tc, dy", lambda: conv3_mod._backward_cuda(
            cx, cw, None, None, cy, misaligned(gen, (1, 9, 11, 8)), f32(8),
            f32(8), 1, "mish")),
    ]
    raised = []
    for name, run in cases:
        before = all_counters()
        try:
            run()
        except ValueError as e:
            check("aligned" in str(e), f"{name}: {e}")
            check(all_counters() == before, f"{name}: counted a launch")
            raised.append(name)
            print(f"  misaligned {name}: ValueError ({e})")
            continue
        raise RuntimeError(f"misaligned {name}: no ValueError")
    torch.cuda.synchronize()
    return raised


def phase_probe_checks(gen, n):
    """The probe layer (the fused GEMM forward with the statistics of the
    unrounded product) against its plain version at the probe's shape,
    208^2 x 64 -> 64 at batch ``n``; then the probe's chain of four
    layers, driven as the tool drives it, with the counter set to 0 just
    before and read just after."""
    results = []
    m, c = n * probe.H * probe.W, probe.C
    for dtype in (torch.bfloat16, torch.float32):
        tol = GEMM_TOL[dtype]
        xs, ws, affines, _ = gemm_case(gen, dtype, m, [c], c, [True], False)
        x, w, (a, b) = xs[0], ws[0], affines[0]
        plan = gemm_mod._tc_plan(m, [c], c, dtype)
        before = probe.probe_layer.launches, probe.probe_layer.tc_launches
        y, s1, s2 = probe.probe_layer(x, w, a, b)
        check((probe.probe_layer.launches, probe.probe_layer.tc_launches)
              == (before[0] + 1, before[1] + (plan.route == "tc")),
              "probe: the wrapper did not launch its kernel")
        yp, s1p, s2p = probe.probe_layer_plain(x, w, a, b)
        torch.cuda.synchronize()
        yf, ypf = y.float(), yp.float()
        err = (yf - ypf).abs()
        scale = ypf.abs().max().item()
        y_ok = bool((err <= tol["y_rel"] * ypf.abs()
                     + tol["y_scale"] * max(1.0, scale)).all())
        # the sums are of the f32 product, which is no output: they are
        # held to the plain version's (f32 sums of another f32 product),
        # in f32's bound for either dtype
        s_tol = GEMM_TOL[torch.float32]["s_rel"]
        s1_rel = ((s1 - s1p).abs() / ypf.abs().sum(0)).max().item()
        s2_rel = ((s2 - s2p).abs() / (ypf * ypf).sum(0)).max().item()
        size = x.element_size()
        bound, bound_by = bound_ms((2 * m * c + c * c) * size + 16 * c,
                                   2.0 * m * c * c, dtype)
        ms = cuda_ms(lambda: probe.probe_layer(x, w, a, b), 5)
        launch_ms = cuda_ms(gemm_launch_call(
            [x], [w], [(a, b)], "mish", plan.route, raw_stats=True), 20)
        cc_ms = None
        if plan.route == "tc":
            cc_ms = cuda_ms(gemm_launch_call(
                [x], [w], [(a, b)], "mish", "cuda_core", raw_stats=True), 5)
        plain_ms = cuda_ms(lambda: probe.probe_layer_plain(x, w, a, b), 3)
        r = dict(shape=f"208^2 {c}->{c} prologue", m=m,
                 dtype=str(dtype).replace("torch.", ""),
                 max_abs_err=err.max().item(), y_scale=scale,
                 s1_rel_err=s1_rel, s2_rel_err=s2_rel, ms=ms,
                 launch_ms=launch_ms, cuda_core_ms=cc_ms, route=plan.route,
                 plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                 tflops=2.0 * m * c * c / launch_ms / 1e9,
                 bound_share=bound / launch_ms)
        results.append(r)
        print(f"  probe {r['dtype']:8s} M={m} [{plan_line(plan)}]: max|dy| "
              f"{r['max_abs_err']:.3e}"
              f" (|y| <= {scale:.3g}; bound {tol['y_rel']:.3g}*|y| + "
              f"{tol['y_scale']:.0e}*scale) s1 rel {s1_rel:.2e} s2 rel "
              f"{s2_rel:.2e} (bound {s_tol:.0e}) | kernel {launch_ms:.3f} ms "
              f"({r['tflops']:.2f} TFLOP/s, {bound / launch_ms:.1%} of "
              f"bound), through the wrapper {ms:.3f}"
              + ("" if cc_ms is None else f", CUDA-core kernel {cc_ms:.3f}")
              + f", plain {plain_ms:.3f} ms, bound {bound:.4f} ({bound_by})")
        check(y_ok, f"probe {dtype}: y outside the bound")
        check(max(s1_rel, s2_rel) <= s_tol,
              f"probe {dtype}: statistics outside the bound")
        del x, w, y, yp, yf, ypf, err
    x, ws, aas, bbs = probe.make_case(0, n, 4)
    probe.probe_layer.launches = probe.probe_layer.tc_launches = 0
    y, s1, s2 = probe.fused_chain(x, ws, aas, bbs)
    torch.cuda.synchronize()
    launches = probe.probe_layer.launches
    tc_launches = probe.probe_layer.tc_launches
    check(launches == 4 and tc_launches == 4,
          f"probe chain launched {launches} kernels ({tc_launches} on the "
          "tensor cores), want 4 (4)")
    check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(s2).all())
          and y.shape == x.shape, "probe chain output")
    x4 = x.reshape(n, probe.H, probe.W, probe.C)
    chain = dict(
        launches=launches, tc_launches=tc_launches,
        fused_ms_per_layer=cuda_ms(
            lambda: probe.fused_chain(x, ws, aas, bbs), 3) / 4,
        eager_ms_per_layer=cuda_ms(
            lambda: probe.eager_chain(x4, ws, aas, bbs), 3) / 4)
    print(f"  probe chain b{n}, 4 layers, bf16: fused "
          f"{chain['fused_ms_per_layer']:.3f} ms/layer, eager conv1x1 + "
          f"BN-train + mish {chain['eager_ms_per_layer']:.3f} ms/layer")
    return results, chain


def calibrate_bn(model, images):
    """Set every BN's running mean/var to the batch statistics of what it
    normalises on ``images`` (its input: a ConvBN's conv output, a
    ConvActBN's activated conv output, a keras backbone BN's input),
    layer by layer in one eval forward."""
    def hook(bn, args):
        y = args[0].float()
        bn.mean.copy_(y.mean(dim=(0, 1, 2)))
        bn.var.copy_(y.var(dim=(0, 1, 2), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BNState)]
    try:
        with torch.inference_mode():
            model(images)
    finally:
        for h in handles:
            h.remove()


def joint_conf(outs):
    return torch.cat([
        (o.reshape(o.shape[0], -1, 5 + CLASSES)[..., 4:5]
         * o.reshape(o.shape[0], -1, 5 + CLASSES)[..., 5:]).reshape(
             o.shape[0], -1) for o in outs], dim=1)


def build_model(args, gen):
    model = YoloV4(ANCHORS, CLASSES, dtype=torch.bfloat16, generator=gen,
                   device="cuda").eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                he_normal_(m.kernel, gen)
    calib = torch.rand(args.batch, args.size, args.size, 3, generator=gen,
                       device="cuda")
    calibrate_bn(model, calib)
    with torch.inference_mode():
        joint = joint_conf(model(calib)).float()
    per_image = joint.shape[1]
    threshold = float(torch.quantile(joint[0], 1 - 64 / per_image))
    return model, threshold


def serve_stats(rows, keep, threshold):
    valid = (rows[..., 4] * rows[..., 6]) >= threshold
    return int(valid.sum()), int(keep.sum())


def phase_serve(args, model, threshold, images):
    serve = make_serving_fn(model, CLASSES, 4, threshold=threshold,
                            nms_mode=1, nms_threshold=0.45)
    serve_soft = make_serving_fn(model, CLASSES, 4, threshold=threshold,
                                 nms_mode=2, nms_threshold=0.45,
                                 nms_sigma=0.5)
    check(not getattr(model, "plain", False), "served on the plain route")
    conv_bn_stats.launches = conv_bn_stats.tc_launches = 0
    nms_keep.launches = soft_nms_keep.launches = 0
    reset_fused_counters()
    times, stats = [], []
    # request 0 warms up; the last one runs Soft-NMS
    for req in range(args.requests + 2):
        soft = req == args.requests + 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows, keep = (serve_soft if soft else serve)(
            images[1 if soft else req])
        torch.cuda.synchronize()
        if req and not soft:
            times.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(rows).all()), "non-finite served rows")
        check(rows.shape == (args.batch, 128, 7)
              and keep.shape == (args.batch, 128), "served shapes")
        stats.append(serve_stats(rows, keep, threshold))
    forwards = args.requests + 2
    greedy, soft_requests = args.requests + 1, 1
    conv_launches, nms_launches = conv_bn_stats.launches, nms_keep.launches
    soft_launches = soft_nms_keep.launches
    tc_launches = conv_bn_stats.tc_launches
    print(f"  launches in {forwards} requests ({greedy} greedy NMS, "
          f"{soft_requests} Soft-NMS): conv_bn_stats "
          f"{conv_launches} ({conv_launches / forwards:g} per forward, "
          f"want {CONVS_PER_FORWARD}), of them on the tensor cores "
          f"{tc_launches} ({tc_launches / forwards:g} per forward, want "
          f"{CONVS_PER_FORWARD}: all), nms_keep {nms_launches} "
          f"(want {greedy}), soft_nms_keep {soft_launches} (want "
          f"{soft_requests})")
    check(conv_launches == CONVS_PER_FORWARD * forwards,
          "not every conv of the forward ran the kernel")
    check(tc_launches == CONVS_PER_FORWARD * forwards,
          "not every bf16 conv ran on the tensor cores")
    check(nms_launches == greedy,
          "not every greedy request ran the NMS kernel, once")
    check(soft_launches == soft_requests,
          "not every Soft-NMS request ran the Soft-NMS kernel, once")
    fused = fused_counters()
    print(f"  fused kernels in {forwards} requests (want 0 each): "
          + ", ".join(f"{k} {v}" for k, v in fused.items()))
    check(not any(fused.values()), "a served request ran a fused kernel")
    for req, (valid, kept) in enumerate(stats):
        mode = "Soft-NMS" if req == forwards - 1 else "greedy"
        print(f"  request {req} ({mode}): valid {valid}, kept {kept}, "
              f"dropped {valid - kept}")
        check(0 < kept < valid, "degenerate detections")
    return dict(ms_per_request=times, conv_launches=conv_launches,
                conv_tc_launches=tc_launches,
                nms_launches=nms_launches, soft_nms_launches=soft_launches,
                forwards=forwards, greedy_requests=greedy,
                soft_requests=soft_requests, valid_kept=stats)


def head_logits(model, x):
    logits = {}
    handles = [getattr(model, f"head{i}").conv.register_forward_hook(
        lambda m, inp, out, i=i: logits.__setitem__(i, out[0].float()))
        for i in (1, 2, 3)]
    try:
        with torch.inference_mode():
            outs = model(x)
    finally:
        for h in handles:
            h.remove()
    return [logits[i] for i in (1, 2, 3)], outs


def phase_routes_f32(model16, images):
    model = YoloV4(ANCHORS, CLASSES, dtype=torch.float32,
                   device="cuda").eval()
    model.load_state_dict(model16.state_dict())
    plain = use_plain_route(copy.deepcopy(model))
    x = images[:2].contiguous()
    lk, ok = head_logits(model, x)
    lp, op = head_logits(plain, x)
    torch.cuda.synchronize()
    res = {}
    # The random 107-layer stack amplifies f32 rounding about 1e4-fold
    # (measured on the CPU: the same code with 1 vs 8 threads differs by
    # 7.6e-4 at 96^2; the port vs JAX by 4.8e-3 in the logits); bounds
    # as the CPU slice test's, relative to each tensor's scale.
    for i in range(3):
        scale = max(1.0, lp[i].abs().max().item())
        d_logit = (lk[i] - lp[i]).abs().max().item()
        d_out = (ok[i] - op[i]).abs()
        out_ok = bool((d_out <= 5e-3 + 2e-2 * op[i].abs()).all())
        res[f"head{i + 1}"] = dict(logit_max_abs_err=d_logit,
                                   logit_scale=scale,
                                   out_max_abs_err=d_out.max().item())
        print(f"  f32 head{i + 1}: logits max|d| {d_logit:.3e} (scale "
              f"{scale:.3g}, bound 2e-2*scale); outputs max|d| "
              f"{d_out.max().item():.3e} (bound 5e-3 + 2e-2*|out|)")
        check(d_logit <= 2e-2 * scale, f"head{i + 1} logits differ")
        check(out_ok and bool(torch.isfinite(ok[i]).all()),
              f"head{i + 1} outputs differ")
    joint = joint_conf(ok)
    threshold = float(torch.quantile(joint[0], 1 - 64 / joint.shape[1]))
    rows, valid = decode_multi_level(ok, class_num=CLASSES,
                                     threshold=threshold, max_boxes=128)
    rows, valid = _sorted_by_conf(rows, valid)
    boxes = torch.cat([rows, valid[..., None].float()], -1).contiguous()
    for mode in (1, 2):
        keep = nms_keep(boxes, 0.45, mode)
        keep_p = nms_keep_plain(boxes, 0.45, mode)
        mism = int((keep != keep_p).sum())
        res[f"nms_mode{mode}_mismatches"] = mism
        print(f"  f32 decoded rows, nms {'IoU' if mode == 1 else 'DIoU'}: "
              f"kernel vs plain {mism} mismatches (bound 0), kept "
              f"{int(keep.sum())} of {int(valid.sum())}")
        check(mism == 0, "NMS kernel differs on decoded rows")
    keep = soft_nms_keep(boxes, 0.45, threshold, 0.5)
    soft = soft_band(boxes, keep, 0.45, threshold, 0.5)
    res["soft_nms"] = soft
    print(f"  f32 decoded rows, Soft-NMS (sigma 0.5, conf_threshold = the "
          f"threshold): kernel vs plain {soft['mismatches_outside']} "
          f"mismatches outside the band (bound 0), "
          f"{soft['mismatches_in_band']} inside, {soft['in_band']} in the "
          f"band; kept {soft['kept']} of {soft['valid']}")
    check(soft["mismatches_outside"] == 0,
          "Soft-NMS kernel differs on decoded rows")
    return res


def phase_timing(args, model, threshold, images, card):
    plain = use_plain_route(copy.deepcopy(model))
    routes = {"kernel": make_serving_fn(model, CLASSES, 4,
                                        threshold=threshold),
              "plain": make_serving_fn(plain, CLASSES, 4,
                                       threshold=threshold)}
    times = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):   # in turns
        routes[name](images[0])
        for req in range(args.requests):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            routes[name](images[1 + req])
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for name, ts in times.items():
        ms = float(np.median(ts))
        out[name] = dict(ms_per_request=ms,
                         img_per_s=args.batch / (ms / 1e3), runs=ts)
        print(f"  {name:6s} route bf16 b{args.batch} {args.size}^2: "
              f"{ms:.2f} ms/request (median of {len(ts)}), "
              f"{out[name]['img_per_s']:.1f} img/s [{card}]")
    return out


def reset_fused_counters():
    fused_gemm.launches = fused_gemm.tc_launches = 0
    fused_gemm.bwd_launches = fused_gemm.bwd_tc_launches = 0
    fused_conv3x3.launches = fused_conv3x3.tc_launches = 0
    fused_conv3x3.bwd_launches = fused_conv3x3.tc_bwd_launches = 0


def fused_counters():
    return dict(fused_conv3x3_fwd=fused_conv3x3.launches,
                fused_conv3x3_fwd_tc=fused_conv3x3.tc_launches,
                fused_conv3x3_bwd=fused_conv3x3.bwd_launches,
                fused_conv3x3_bwd_tc=fused_conv3x3.tc_bwd_launches,
                fused_gemm_fwd=fused_gemm.launches,
                fused_gemm_fwd_tc=fused_gemm.tc_launches,
                fused_gemm_bwd=fused_gemm.bwd_launches,
                fused_gemm_bwd_tc=fused_gemm.bwd_tc_launches)


def reset_train_counters():
    conv_bn_stats.launches = conv_bn_stats.tc_launches = 0
    reset_fused_counters()


def train_counters():
    return dict(**fused_counters(), conv_bn_stats=conv_bn_stats.launches,
                conv_bn_stats_tc=conv_bn_stats.tc_launches)


def phase_train(args, packed, steps, batch):
    """One warm-up step and ``steps`` timed steps of ``YoloV4(packed)``
    on the kernel route, from ``batch`` down (halved once if it does not
    fit); the counters are set to 0 just before and read just after."""
    first = batch
    while True:
        torch.cuda.reset_peak_memory_stats()
        state, step, x, ys = make_training(args.seed, batch, args.size,
                                           torch.bfloat16, packed=packed)
        stats0 = {k: v.clone() for k, v in state.model.named_buffers()}
        reset_train_counters()
        try:
            _, warm = timed_steps(state, step, x, ys, 1)
            break
        except torch.cuda.OutOfMemoryError:
            fits = False         # free outside the handler: the
        if not fits:             # exception holds the step's tensors
            check(batch == first, f"batch {batch} does not fit")
            del state, step, x, ys, stats0
            torch.cuda.empty_cache()
            batch //= 2
            print(f"  FELL BACK: batch {first} does not fit; trying {batch} "
                  "(the kernel checks run again at that batch)")
    model = state.model
    no_grad = [n for n, p in model.named_parameters() if p.grad is None]
    check(not no_grad, f"parameters without a gradient: {no_grad[:5]}")
    bad = [n for n, p in model.named_parameters()
           if not bool(torch.isfinite(p.grad).all())]
    check(not bad, f"non-finite gradients after step 1: {bad[:5]}")
    still = [k for k, v in model.named_buffers()
             if torch.equal(v, stats0[k])]
    check(not still, f"running statistics did not move: {still[:5]}")
    times, losses = timed_steps(state, step, x, ys, steps)
    losses = warm + losses
    n_steps = steps + 1
    counts = train_counters()
    want = TRAIN_LAUNCHES[packed]
    peak = torch.cuda.max_memory_allocated()
    print(f"  packed={packed}, batch {batch}, bf16, {args.size}^2, seed "
          f"{args.seed}: losses {' '.join(f'{v:.4f}' for v in losses)}; "
          f"{len(stats0)} running statistics moved; peak memory "
          f"{peak / 2 ** 30:.2f} GiB")
    print(f"  launches in {n_steps} steps: "
          + ", ".join(f"{k} {v} (want {want[k]} a step)"
                      for k, v in counts.items()))
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(losses[-1] < losses[0], "the training loss did not fall")
    for k, v in counts.items():
        check(v == want[k] * n_steps,
              f"packed={packed}: {k} launched {v} times in {n_steps} steps, "
              f"want {want[k]} a step")
    return dict(packed=packed, batch=batch, losses=losses, ms_per_step=times,
                peak_bytes=peak, launches=counts, steps=n_steps,
                running_statistics=len(stats0)), (state, step, x, ys)


def phase_train_routes_f32(args, packed=3, scope=None):
    """One f32 step of ``YoloV4(packed)`` at batch 2 on both routes
    from the same state (with the frozen-statistics BatchNorm backward on
    the ConvBNs of ``scope`` when it is given, phase 12).

    The untrained YOLOv4 is chaotically conditioned: 107 BatchNorm + mish
    layers amplify a 1e-6 change of the input into about 5% relative L2
    in most gradient leaves on one and the same route (the JAX package's
    own packed-vs-plain test meets the same and calibrates by it). So the
    plain route runs twice, on x and on x + 1e-6, and the kernel route is
    held, leaf by leaf, to 5 times that measured noise, with a floor of
    1e-3 and a ceiling of 0.3. The leaves fall into two groups, read
    apart: chaotic ones (probe noise of 1e-2 and more, about 315 of 330)
    and well-conditioned ones (heads, last neck layers; noise 1e-7 to
    2e-3), whose ratio to so small a noise may be large under the floor.
    This check catches a route that goes wrong as a whole (a layer on the
    wrong weights, a missing cotangent term); a bound this wide would
    pass a slightly wrong kernel. The gate for each kernel's arithmetic
    is phase 3, and the per-module CPU tests of the port. Adam's first
    update is lr * g / (|g| + 1e-7), the sign of g: an
    element whose gradient lies within the noise of 0 may step the other
    way, 2 lr apart, so the updated parameters are bounded by 2 lr
    elementwise and, over all of them together, by twice the probe's
    distance (measured 1.39-1.44 times; unrelated directions give 5.6
    times)."""
    state, step, x, ys = make_training(args.seed, 2, args.size,
                                       torch.float32, packed=packed)
    if scope is not None:
        set_bn_stats_sg(state.model, True, scope)

    def plain_copy():
        return create_train_state(
            use_plain_route(copy.deepcopy(state.model)),
            make_optimizer("adam", 1e-3))

    plain_state, probe_state = plain_copy(), plain_copy()
    _, logs = step(state, x, ys)
    _, logs_p = step(plain_state, x, ys)
    _, logs_e = step(probe_state, x + 1e-6, ys)
    torch.cuda.synchronize()
    loss, loss_p = float(logs["loss"]), float(logs_p["loss"])
    loss_rel = abs(loss - loss_p) / abs(loss_p)
    loss_noise = abs(float(logs_e["loss"]) - loss_p) / abs(loss_p)
    plain_params = dict(plain_state.model.named_parameters())
    probe_params = dict(probe_state.model.named_parameters())
    grad_rel, grad_noise, failed = {}, {}, []
    apart = noise = upd_abs = 0.0
    for name, p in state.model.named_parameters():
        q, e = plain_params[name], probe_params[name]
        grad_rel[name] = rel_l2(p.grad, q.grad)
        grad_noise[name] = rel_l2(e.grad, q.grad)
        if grad_rel[name] > min(0.3, max(5 * grad_noise[name], 1e-3)):
            failed.append(name)
        d = p.detach() - q.detach()
        upd_abs = max(upd_abs, d.abs().max().item())
        apart += float(d.square().sum())
        noise += float((e.detach() - q.detach()).square().sum())
    worst = max(grad_rel, key=grad_rel.get)
    g_med = float(np.median(list(grad_rel.values())))
    n_med = float(np.median(list(grad_noise.values())))
    groups = {}
    for label, keys in (
            ("chaotic", [k for k in grad_rel if grad_noise[k] >= 1e-2]),
            ("well_conditioned",
             [k for k in grad_rel if grad_noise[k] < 1e-2])):
        groups[label] = dict(
            leaves=len(keys),
            rel_l2_max=max((grad_rel[k] for k in keys), default=0.0),
            ratio_max=max((grad_rel[k] / max(grad_noise[k], 1e-30)
                           for k in keys), default=0.0))
    apart, noise = apart ** 0.5, noise ** 0.5
    print(f"  f32 b2 one step: loss kernel {loss:.6f} plain {loss_p:.6f} "
          f"(rel {loss_rel:.2e}; probe {loss_noise:.2e}; bound 1e-5 + 4 x "
          f"probe); gradient rel L2 per leaf: median {g_med:.2e} (probe "
          f"{n_med:.2e}), max {grad_rel[worst]:.2e} at {worst} (probe "
          f"{grad_noise[worst]:.2e}); bound per leaf min(0.3, max(5 x "
          f"probe, 1e-3)); "
          + "; ".join(f"{g['leaves']} {label} leaves: largest rel L2 "
                      f"{g['rel_l2_max']:.2e}, largest ratio to probe "
                      f"{g['ratio_max']:.2f}"
                      for label, g in groups.items())
          + f"; updated parameters max|d| {upd_abs:.2e} (bound 2.1e-3 = "
          f"2 lr), distance over all "
          f"{apart:.3e} (probe {noise:.3e}; bound 2 x probe)")
    check(np.isfinite(loss) and loss_rel <= 1e-5 + 4 * loss_noise,
          "route losses differ")
    check(not failed, f"route gradients differ at {failed[:5]}")
    check(upd_abs <= 2.1e-3 and apart <= 2 * noise,
          "route updates differ")
    return dict(loss=loss, loss_plain=loss_p, loss_rel=loss_rel,
                loss_rel_probe=loss_noise, grad_rel_l2_median=g_med,
                grad_rel_l2_median_probe=n_med,
                grad_rel_l2_max=grad_rel[worst], grad_groups=groups,
                param_max_abs_diff=upd_abs,
                update_distance=apart, update_distance_probe=noise,
                grad_rel_l2={k: (grad_rel[k], grad_noise[k])
                             for k in grad_rel})


def phase_train_timing(args, handles3, handles1, card):
    """ms/step of packed=3 on both routes and of packed=True on the
    kernel route, all at the batch packed=3 trained at, in turns."""
    batch = handles3[2].shape[0]
    check(handles1[2].shape[0] == batch, "the two routes trained at "
          "different batches")
    runs = {"packed=3 kernel": handles3,
            "packed=3 plain": make_training(args.seed, batch, args.size,
                                            torch.bfloat16, plain=True,
                                            packed=3),
            "packed=1 kernel": handles1}
    timed_steps(*runs["packed=3 plain"], 1)      # warm-up
    times = {name: [] for name in runs}
    order = list(runs)
    # the counters per timed run: the kernel routes' launches per step,
    # none on the plain route
    want = {"packed=3 kernel": TRAIN_LAUNCHES[3],
            "packed=3 plain": dict.fromkeys(TRAIN_LAUNCHES[3], 0),
            "packed=1 kernel": TRAIN_LAUNCHES[1]}
    for name in order + order[::-1]:
        reset_train_counters()
        times[name] += timed_steps(*runs[name], args.steps)[0]
        counts = train_counters()
        check(all(v == want[name][k] * args.steps
                  for k, v in counts.items()),
              f"{name}: launches in {args.steps} timed steps {counts}, "
              f"want {want[name]} a step")
    out = {}
    for name, ts in times.items():
        ms = float(np.median(ts))
        out[name] = dict(ms_per_step=ms, img_per_s=batch / (ms / 1e3),
                         runs=ts)
        print(f"  {name:15s} route bf16 b{batch} {args.size}^2: "
              f"{ms:.2f} ms/step (median of {len(ts)}), "
              f"{out[name]['img_per_s']:.1f} img/s [{card}]")
    return out


def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


FACADE_TRAIN = 32                # phase 10: images trained, a batch of
FACADE_BATCH = 16                # 16, so 2 steps an epoch
FACADE_VAL = 8                   # validation images, one eval batch
FACADE_SPEC = "obj+iou+recall0.5"


def facade_data(seed, n, size):
    """``n`` random uint8 images and their label pyramids (coarse to
    fine) from seeded boxes, encoded by the port's ``encode_to_grid``
    and ``down2xlabel`` as its readers do."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8)
    fine = np.zeros((n, size // 8, size // 8, 5 + CLASSES))
    for i in range(n):
        k = rng.randint(1, 6)
        xy = rng.uniform(0, size * 0.8, (k, 2))
        wh = rng.uniform(size * 0.05, size * 0.2, (k, 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, size - 1)], axis=1)
        encode_to_grid(boxes, rng.randint(0, CLASSES, k), (size, size),
                       fine.shape[1:3], CLASSES, out=fine[i])
    mid = down2xlabel(fine)
    return images, [down2xlabel(mid), mid, fine]


def conv_counters():
    return dict(conv_bn_stats=conv_bn_stats.launches,
                conv_bn_stats_tc=conv_bn_stats.tc_launches)


def phase_facade(args, card, device="cuda"):
    """Phase 10: the user's path, ``yolov4.Yolo`` -> ``create_model`` ->
    ``compile`` -> ``fit`` -> ``evaluate`` -> ``predict``, at full width
    on the card, with launch counters set to 0 just before each call and
    read just after."""
    yolo = yolov4.Yolo(input_shape=(args.size, args.size, 3),
                       class_names=["a", "b", "c"])
    model = yolo.create_model(anchors=ANCHORS, pretrained_body=None,
                              dtype=torch.bfloat16, packed=3,
                              seed=args.seed, device=device)
    check(next(model.module.parameters()).device.type == device,
          "the model is not on the card")
    n = FACADE_TRAIN + FACADE_VAL
    images, labels = facade_data(args.seed, n, args.size)
    x, y = images[:FACADE_TRAIN], [v[:FACADE_TRAIN] for v in labels]
    xv, yv = images[FACADE_TRAIN:], [v[FACADE_TRAIN:] for v in labels]
    loss, metrics = yolo.loss(), yolo.metrics(FACADE_SPEC)
    model.compile("adam", loss=loss, metrics=metrics, learning_rate=1e-3)
    out = {}
    steps = 2 * FACADE_TRAIN // FACADE_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, csv = os.path.join(tmp, "ckpt"), os.path.join(tmp, "log.csv")
        callbacks = [engine.EarlyStopping(patience=3),
                     engine.ReduceLROnPlateau(patience=3),
                     engine.CSVLogger(csv)]
        reset_train_counters()
        hist = model.fit(x, y, epochs=2, batch_size=FACADE_BATCH,
                         seed=args.seed, verbose=0,
                         validation_data=(xv, yv), callbacks=callbacks,
                         checkpoint_dir=ckpt, checkpoint_every=1,
                         checkpoint_keep=1)
        sync(device)
        counts = train_counters()
        # a step's launches as phase 7's, and one eval batch (110 convs)
        # of the validation data after each epoch
        want = {k: v * steps for k, v in TRAIN_LAUNCHES[3].items()}
        want["conv_bn_stats"] += 2 * CONVS_PER_FORWARD
        want["conv_bn_stats_tc"] += 2 * CONVS_PER_FORWARD
        logs = {k: v for k, v in hist.items() if k != "epoch_time"}
        print(f"  fit: 2 epochs x {steps // 2} steps of {FACADE_BATCH}, "
              f"bf16 packed=3, {args.size}^2: "
              + ", ".join(f"{k} {' '.join(f'{v:.4f}' for v in vs)}"
                          for k, vs in logs.items()))
        print("  launches in fit: " + ", ".join(
            f"{k} {v} (want {want[k]})" for k, v in counts.items()))
        check(len(hist["loss"]) == 2, "fit did not run two epochs")
        check(all(np.isfinite(v) for vs in logs.values() for v in vs),
              "non-finite loss or metric in fit")
        check(counts == want, f"fit launches {counts}, want {want}")
        check(len(open(csv).read().splitlines()) == 3,
              "CSVLogger did not write two rows")
        out["fit"] = dict(history=logs, launches=counts)

        reset_train_counters()
        again = model.fit(x, y, epochs=2, batch_size=FACADE_BATCH,
                          seed=args.seed, verbose=0, checkpoint_dir=ckpt,
                          resume=True)
        check(again["loss"] == [] and model._state.step == steps
              and sum(train_counters().values()) == 0,
              "fit(resume=True) did not skip the two epochs trained")

        reset_train_counters()
        ev = model.evaluate(xv, yv, batch_size=FACADE_VAL, verbose=0)
        sync(device)
        ev_counts = conv_counters()
        reset_train_counters()
        pred = model.predict(xv, batch_size=FACADE_VAL)
        sync(device)
        pred_counts = conv_counters()
        print("  evaluate: " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in ev.items())
              + f"; launches evaluate {ev_counts}, predict {pred_counts} "
              f"(want {CONVS_PER_FORWARD} each, all tc)")
        check(all(np.isfinite(v) for v in ev.values()),
              "non-finite evaluate logs")
        for c in (ev_counts, pred_counts):
            check(c == dict(conv_bn_stats=CONVS_PER_FORWARD,
                            conv_bn_stats_tc=CONVS_PER_FORWARD),
                  f"evaluate/predict launches {c}")
        model.module.eval()
        with torch.inference_mode():
            direct = model.module(torch.from_numpy(xv).to(device).float()
                                  * model.input_rescale)
        same = [np.array_equal(p, d.float().cpu().numpy())
                for p, d in zip(pred, direct)]
        scaled = model.predict(xv.astype(np.float32) * np.float32(1 / 255),
                               batch_size=FACADE_VAL)
        same_u8 = [np.array_equal(p, s) for p, s in zip(pred, scaled)]
        print(f"  predict: shapes {[p.shape for p in pred]}, equal to "
              f"model(x) in eval mode {same}, uint8 equal to float / 255 "
              f"{same_u8}")
        check(all(np.isfinite(p).all() for p in pred), "non-finite predict")
        check(all(same), "predict differs from model(x) in eval mode")
        check(all(same_u8), "uint8 predict differs from float / 255")

        path = os.path.join(tmp, "weights.pt")
        saved = {k: v.clone() for k, v in model.variables.items()}
        model.save_weights(path)
        with torch.no_grad():
            for p in model.module.parameters():
                p.zero_()
        model.load_weights(path)
        check(all(torch.equal(v, saved[k])
                  for k, v in model.variables.items()),
              "load_weights did not restore the saved weights")
        out["evaluate"], out["predict_equal"] = ev, same
        out["evaluate_predict_launches"] = {
            k: ev_counts[k] + pred_counts[k] for k in ev_counts}

    out["optimizers"] = facade_optimizers(model, loss, x, y)
    out["prefetch"] = facade_prefetch(model, loss, x, y, device)
    out["timing"] = facade_timing(args, model, loss, metrics, x, y, card,
                                  device)
    return out


def facade_optimizers(model, loss, x, y):
    """One step of each other optimizer chain through fit (two for
    accumulate_steps=2: no update after the first)."""
    out = {}
    xb, yb = x[:FACADE_BATCH], [v[:FACADE_BATCH] for v in y]
    for name, kw in (("sgd", {}), ("rmsprop", {}), ("adamw", {}),
                     ("adam", dict(accumulate_steps=2)),
                     ("adam", dict(ema_decay=0.999))):
        label = name + "".join(f" {k}={v}" for k, v in kw.items())
        model.compile(name, loss=loss, learning_rate=1e-3, **kw)
        before = [p.detach().clone() for p in model.module.parameters()]

        def moved():
            return sum(not torch.equal(b, p) for b, p in
                       zip(before, model.module.parameters()))
        hist = model.fit(xb, yb, epochs=1, batch_size=FACADE_BATCH,
                         verbose=0)
        first = moved()
        if kw.get("accumulate_steps"):
            check(first == 0, f"{label}: parameters moved on mini-step 1")
            hist = model.fit(xb, yb, epochs=1, batch_size=FACADE_BATCH,
                             verbose=0)
        n_moved = moved()
        print(f"  {label}: loss {hist['loss'][0]:.4f}, parameters moved "
              f"{n_moved} of {len(before)}")
        check(np.isfinite(hist["loss"][0]), f"{label}: non-finite loss")
        # the frozen anchors (3 heads) stay; an update below the ulp of
        # its parameter may leave a small leaf in place
        check(n_moved >= 0.9 * len(before), f"{label}: parameters unmoved")
        out[label] = dict(loss=hist["loss"][0], moved=n_moved,
                          moved_after_first=first)
    return out


def facade_prefetch(model, loss, x, y, device):
    """``prefetch=2`` against the inline feed on the card. First the
    batches themselves, bit for bit, with a train step on the consumer's
    stream after each (a batch read before its copy lands, or memory
    reused while a copy is in flight, shows as a batch that differs).
    Then one epoch of ``fit`` from one saved state with each feed: the
    loss within the spread of two inline runs (the kernels' atomics make
    runs differ) or 1e-3 of it."""
    model.compile("adam", loss=loss, learning_rate=1e-3)
    model._ensure_state()
    step = make_train_step(loss)
    batch = FACADE_BATCH // 2
    fed = {}
    for prefetch in (0, 2):
        got = []
        pairs = model._iterate(x, y, batch, True, np.random.RandomState(3))
        for xb, yb in model._feed(pairs, prefetch=prefetch):
            got.append([xb.clone()] + [v.clone() for v in yb])
            step(model._state, xb, yb)
        fed[prefetch] = got
    sync(device)
    same = len(fed[0]) == len(fed[2]) == FACADE_TRAIN // batch and all(
        all(torch.equal(a, b) for a, b in zip(u, v))
        for u, v in zip(fed[0], fed[2]))

    saved = {k: v.clone() for k, v in model.variables.items()}
    losses = {}
    for name, prefetch in (("inline", 0), ("prefetch=2", 2),
                           ("inline again", 0)):
        model.set_variables(saved)          # and a fresh optimizer
        hist = model.fit(x, y, epochs=1, batch_size=FACADE_BATCH, seed=5,
                         verbose=0, prefetch=prefetch)
        losses[name] = hist["loss"][0]
    spread = abs(losses["inline again"] - losses["inline"])
    diff = abs(losses["prefetch=2"] - losses["inline"])
    bound = max(spread, 1e-3 * abs(losses["inline"]))
    print(f"  prefetch=2: {len(fed[2])} batches of {batch} equal to the "
          f"inline feed's {same}; one epoch's loss inline "
          f"{losses['inline']:.6f} / {losses['inline again']:.6f}, "
          f"prefetch=2 {losses['prefetch=2']:.6f} (|d| {diff:.3g}, "
          f"bound {bound:.3g})")
    check(same, "prefetch=2 fed other batches than the inline feed")
    check(diff <= bound, "fit(prefetch=2) differs from the inline fit by "
          f"{diff}, more than {bound}")
    return dict(batches_equal=same, losses=losses, diff=diff, bound=bound)


def facade_timing(args, model, loss, metrics, x, y, card, device):
    """ms/step of fit (inline feed, and prefetch=2) against the same
    train step called directly on batches already on the card, in
    turns: the engine's host cost."""
    model.compile("adam", loss=loss, metrics=metrics, learning_rate=1e-3)
    model._ensure_state()
    steps = 2 * FACADE_TRAIN // FACADE_BATCH      # two epochs a run
    on_card = [(torch.from_numpy(x[i:i + FACADE_BATCH]).to(device),
                tuple(torch.from_numpy(v[i:i + FACADE_BATCH]).float()
                      .to(device) for v in y))
               for i in range(0, FACADE_TRAIN, FACADE_BATCH)]
    names = model._metric_names
    step = make_train_step(loss, metrics, names)

    def feed():
        """fit's feed alone: slicing, pinning and copying two epochs."""
        rng = np.random.RandomState(0)
        for _ in range(2):
            for _ in model._feed(model._iterate(x, y, FACADE_BATCH, True,
                                                rng)):
                pass

    def direct():
        for _ in range(2):
            for xb, yb in on_card:
                step(model._state, xb, yb)

    runs = {"fit": lambda: model.fit(x, y, epochs=2,
                                     batch_size=FACADE_BATCH, verbose=0),
            "fit prefetch=2": lambda: model.fit(
                x, y, epochs=2, batch_size=FACADE_BATCH, verbose=0,
                prefetch=2),
            "make_train_step": direct, "feed alone": feed}
    times = {k: [] for k in runs}
    order = list(runs)
    for name in (order + order[::-1]) * 2 + order:
        sync(device)
        t0 = time.perf_counter()
        runs[name]()
        sync(device)
        times[name].append((time.perf_counter() - t0) * 1e3 / steps)
    out = {k: dict(ms_per_step=float(np.median(v)), runs=v)
           for k, v in times.items()}
    engine_ms = out["fit"]["ms_per_step"] - out["make_train_step"][
        "ms_per_step"]
    print(f"  ms/step bf16 b{FACADE_BATCH} {args.size}^2 packed=3 (median of "
          f"5 turns of {steps} steps): fit {out['fit']['ms_per_step']:.2f}, fit prefetch=2 "
          f"{out['fit prefetch=2']['ms_per_step']:.2f}, make_train_step "
          f"direct {out['make_train_step']['ms_per_step']:.2f}, the feed "
          f"alone {out['feed alone']['ms_per_step']:.2f}; engine host cost "
          f"{engine_ms:.2f} ms/step [{card}]")
    return out


# int8 ConvBNs of YOLOv4@416 by gate: min(Ci, Co) >= 256, and all 107
DEPLOY_INT8 = {256: 61, 0: 107}
# The JAX package's own int8 check (tests/test_quant.py:85): the
# confidence field of the sorted int8 rows within 0.15 of the float ones,
# on its small init-statistics network. The random 416^2 network here
# amplifies rounding chaotically (phase 5), so the bound is that or twice
# the distance at which bf16 rounding alone puts the bf16 rows from the
# f32 rows of the same weights and images, whichever is larger.
INT8_CONF_BOUND = 0.15
DEPLOY_BIG_BATCH = 32            # bench_infer.py's batch
DISPATCH_REPS = 10               # requests a turn of the dispatch A/B
DEPLOY_REPS = 5                  # requests a turn of each timed variant


def reset_serve_counters():
    conv_bn_stats.launches = conv_bn_stats.tc_launches = 0
    conv_int8.launches = conv_int8.tc_launches = 0
    conv_int8.quant_launches = 0
    nms_keep.launches = soft_nms_keep.launches = 0
    reset_fused_counters()


def serve_counters():
    return dict(conv_bn_stats=conv_bn_stats.launches,
                conv_bn_stats_tc=conv_bn_stats.tc_launches,
                conv_int8=conv_int8.launches,
                conv_int8_tc=conv_int8.tc_launches,
                conv_int8_quant=conv_int8.quant_launches,
                nms_keep=nms_keep.launches,
                soft_nms_keep=soft_nms_keep.launches,
                fused=sum(fused_counters().values()))


def want_serve(int8_convs):
    """A greedy request's launches with ``int8_convs`` ConvBNs on Q (its
    conv launch and its quantize pass each): the rest of the 110 convs on
    K1, every one on the tensor cores, one NMS kernel, no fused kernel."""
    k1 = CONVS_PER_FORWARD - int8_convs
    return dict(conv_bn_stats=k1, conv_bn_stats_tc=k1, conv_int8=int8_convs,
                conv_int8_tc=int8_convs, conv_int8_quant=int8_convs,
                nms_keep=1, soft_nms_keep=0, fused=0)


def counted(serve, x):
    """``serve(x)`` with the counters set to 0 just before and read just
    after: ((rows, keep), counters)."""
    torch.cuda.synchronize()
    reset_serve_counters()
    out = serve(x)
    torch.cuda.synchronize()
    return out, serve_counters()


def head_bound_check(lk, lp, ok, op, what):
    """Phase 5's bounds on head logits and outputs; returns the errors."""
    res = {}
    for i in range(3):
        scale = max(1.0, lp[i].abs().max().item())
        d_logit = (lk[i] - lp[i]).abs().max().item()
        d_out = (ok[i] - op[i]).abs()
        out_ok = bool((d_out <= 5e-3 + 2e-2 * op[i].abs()).all())
        res[f"head{i + 1}"] = dict(logit_max_abs_err=d_logit,
                                   logit_scale=scale,
                                   out_max_abs_err=d_out.max().item())
        print(f"  {what} head{i + 1}: logits max|d| {d_logit:.3e} (scale "
              f"{scale:.3g}, bound 2e-2*scale); outputs max|d| "
              f"{d_out.max().item():.3e} (bound 5e-3 + 2e-2*|out|)")
        check(d_logit <= 2e-2 * scale and out_ok
              and bool(torch.isfinite(ok[i]).all()),
              f"{what}: head{i + 1} outside the bound")
    return res


def layer_routes(program, x):
    """Every conv of one served request, kernel route against the plain
    route on the input the kernel route gave it (captured as the request
    runs): each ``Int8ConvBN`` (Q, then the activation) equal bit for
    bit, each K1 conv within the conv's bf16 bound (``TOL``). Returns
    counts and the largest K1 error."""
    tol = TOL[torch.bfloat16]
    res = dict(int8_layers=0, int8_equal=0, k1_layers=0, k1_within=0,
               k1_max_abs_err=0.0)

    def hook(m, args, out):
        m.plain = True
        try:
            ref = m.forward(*args)
        finally:
            m.plain = False
        if isinstance(m, Int8ConvBN):
            res["int8_layers"] += 1
            res["int8_equal"] += int(torch.equal(out, ref))
            return
        y, yp = out[0].float(), ref[0].float()
        err = (y - yp).abs()
        bound = tol["y_rel"] * yp.abs() + tol["y_scale"] * max(
            1.0, yp.abs().max().item())
        res["k1_layers"] += 1
        res["k1_within"] += int(bool((err <= bound).all()))
        res["k1_max_abs_err"] = max(res["k1_max_abs_err"],
                                    err.max().item())

    handles = [m.register_forward_hook(hook) for m in program.modules()
               if isinstance(m, (Int8ConvBN, Conv))]
    try:
        with torch.inference_mode():
            program(x)
    finally:
        for h in handles:
            h.remove()
    return res


@contextlib.contextmanager
def direct_wrappers():
    """``conv_int8`` and ``nms_keep`` as the model and the NMS layer call
    them, but calling their implementations directly instead of through
    their custom ops: the same launches without the dispatcher, for the
    A/B of the ops' host cost only."""
    def conv(x, wq, c, t, sx, ksize, stride, out_dtype, plain=False,
             padding="darknet"):
        if plain:
            return conv_int8_plain(x, wq, c, t, sx, ksize, stride, out_dtype,
                                   padding)
        return int8_mod._impl(x, wq, c, t, sx, ksize, stride, out_dtype,
                              padding)

    saved = layers_mod.conv_int8, nms_ops.nms_keep
    layers_mod.conv_int8, nms_ops.nms_keep = conv, nms_mod._nms_keep_impl
    try:
        yield
    finally:
        layers_mod.conv_int8, nms_ops.nms_keep = saved


def dispatch_cost(serve, x, reps):
    """ms/request of ``serve(x)`` with the wrappers through their custom
    ops (as shipped) and calling the implementations directly, in turns
    (op, direct, direct, op; ``reps`` requests each), with each way's
    launches."""
    times, launches = {}, {}
    for way in ("custom op", "direct", "direct", "custom op"):
        ctx = direct_wrappers() if way == "direct" else contextlib.nullcontext()
        with ctx:
            _, launches[way] = counted(serve, x)
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                serve(x)
                torch.cuda.synchronize()
                times.setdefault(way, []).append(
                    (time.perf_counter() - t0) * 1e3)
    check(launches["custom op"] == launches["direct"],
          f"dispatch A/B: launches differ {launches}")
    return {way: dict(ms_per_request=float(np.median(ts)), runs=ts)
            for way, ts in times.items()}


def without_metadata_asserts(served):
    """A copy of a loaded artifact without the ``aten._assert_tensor_metadata``
    nodes that ``torch.export`` puts before each dtype cast: a measurement
    of their host cost only."""
    served = copy.deepcopy(served)
    target = torch.ops.aten._assert_tensor_metadata.default
    for gm in served._fns.values():
        for node in list(gm.graph.nodes):
            if node.op == "call_function" and node.target is target:
                gm.graph.erase_node(node)
        gm.recompile()
    return served


def phase_deploy(args, model, threshold, images, card):
    """Phase 11: the deployment path at 416^2, 3 classes, bf16, on phase
    4's weights: BN folding, static-scale int8 at gates 256 and 0, the
    serving artifact through ``Yolo.export_model`` and ``load_serving``,
    and ms/request of every variant in turns."""
    x = images[1]
    out = {}
    # 1. folded. The f32 head outputs against the unfolded model's, both
    # on the kernel route (phase 5's bounds: the fold's f32 rounding
    # through the random stack); then the bf16 programs' launches.
    m32 = YoloV4(ANCHORS, CLASSES, dtype=torch.float32, device="cuda").eval()
    m32.load_state_dict(model.state_dict())
    lk, ok = head_logits(m32, x[:2])
    lf, of = head_logits(folded_copy(m32), x[:2])
    torch.cuda.synchronize()
    out["folded_f32"] = head_bound_check(lf, lk, of, ok,
                                         "f32 folded vs unfolded")
    rows_32, _ = make_serving_fn(m32, CLASSES, 4, threshold=threshold)(x)
    del m32, lk, ok, lf, of
    serves = {"unfolded": make_serving_fn(model, CLASSES, 4,
                                          threshold=threshold),
              "folded": make_serving_fn(folded_copy(model), CLASSES, 4,
                                        threshold=threshold)}
    (rows_b, keep_b), _ = counted(serves["unfolded"], x)
    bf16_d = (rows_b[..., 4] - rows_32[..., 4]).abs().max().item()
    conf_bound = max(INT8_CONF_BOUND, 2 * bf16_d)
    print(f"  confidence field of the sorted bf16 rows against the f32 "
          f"rows' (same weights and images): max|d| {bf16_d:.4f}; the "
          f"int8 bound max({INT8_CONF_BOUND}, 2 x that) = {conf_bound:.4f}")
    out.update(bf16_vs_f32_conf_max_abs_diff=bf16_d,
               int8_conf_bound=conf_bound)
    for name in ("unfolded", "folded"):
        _, cnt = counted(serves[name], x)
        print(f"  {name} request: launches {cnt}")
        check(cnt == want_serve(0), f"{name}: launches {cnt}, want "
              f"{want_serve(0)}")
    # 2. int8: calibrated on two seeded batches, gates 256 and 0
    g = torch.Generator(device="cuda").manual_seed(args.seed + 11)
    calib = [torch.rand(args.batch, args.size, args.size, 3, generator=g,
                        device="cuda") for _ in range(2)]
    t0 = time.perf_counter()
    quant = calibrate_int8(model, calib)
    calib_s = time.perf_counter() - t0
    scales = [v for stage in quant["quant"].values()
              for v in _tree_leaves(stage)]
    check(len(scales) == 107 and all(float(v) > 0 for v in scales),
          "calibration: want 107 positive scales")
    int8_launches = int8_tc = int8_quant = 0
    out["int8"] = {}
    for gate, n_q in DEPLOY_INT8.items():
        serve = make_serving_fn(model, CLASSES, 4, threshold=threshold,
                                quant=quant, int8_min_channels=gate)
        check(sum(isinstance(m, Int8ConvBN)
                  for m in serve.program.modules()) == n_q,
              f"gate {gate}: want {n_q} int8 ConvBNs")
        (rows_q, keep_q), cnt = counted(serve, x)
        int8_launches += cnt["conv_int8"]
        int8_tc += cnt["conv_int8_tc"]
        int8_quant += cnt["conv_int8_quant"]
        check(cnt == want_serve(n_q), f"int8 gate {gate}: launches {cnt}, "
              f"want {want_serve(n_q)}")
        conf_d = (rows_q[..., 4] - rows_b[..., 4]).abs().max().item()
        valid, kept = serve_stats(rows_q, keep_q, threshold)
        out["int8"][gate] = dict(launches=cnt, conf_max_abs_diff=conf_d,
                                 valid=valid, kept=kept,
                                 valid_kept_bf16=serve_stats(
                                     rows_b, keep_b, threshold))
        print(f"  int8 gate {gate}: {n_q} ConvBNs on Q; launches {cnt}; "
              f"sanity check, confidence field of the sorted rows against "
              f"bf16 max|d| {conf_d:.4f} (bound {conf_bound:.4f}); valid {valid} kept "
              f"{kept} (bf16: {out['int8'][gate]['valid_kept_bf16']})")
        check(bool(torch.isfinite(rows_q).all()) and conf_d <= conf_bound,
              f"int8 gate {gate} rows")
        serves[f"int8 gate {gate}"] = serve
    check(not any(isinstance(m, Int8ConvBN) for m in model.modules()),
          "make_serving_fn changed the caller's model")
    # gate 0, kernel route against the plain route: every quantized
    # ConvBN's output is exact on both (phase 3: equal bit for bit), so
    # the two differ only in the three bf16 head convs (K1 against the
    # plain conv): the conv's bf16 bound on the logits
    plain = use_plain_route(copy.deepcopy(model))
    sp = make_serving_fn(plain, CLASSES, 4, threshold=threshold,
                         quant=quant, int8_min_channels=0)
    lq, _ = head_logits(serves["int8 gate 0"].program.model, x)
    lp, _ = head_logits(sp.program.model, x)
    torch.cuda.synchronize()
    tol = TOL[torch.bfloat16]
    route = {}
    for i in range(3):
        scale = max(1.0, lp[i].abs().max().item())
        d = (lq[i] - lp[i]).abs()
        ok_i = bool((d <= tol["y_rel"] * lp[i].abs()
                     + tol["y_scale"] * scale).all())
        route[f"head{i + 1}"] = dict(logit_max_abs_err=d.max().item(),
                                     logit_scale=scale)
        print(f"  int8 gate 0 kernel vs plain route head{i + 1}: logits "
              f"max|d| {d.max().item():.3e} (scale {scale:.3g}; bound "
              f"{tol['y_rel']:.3g}*|l| + {tol['y_scale']:.0e}*scale)")
        check(ok_i, f"int8 routes differ at head{i + 1}")
    out["int8_gate0_routes"] = route
    # gate 256, kernel route against the plain route: layer by layer, on
    # the inputs of the kernel route's request
    lr = layer_routes(serves["int8 gate 256"].program.model, x)
    print(f"  int8 gate 256 kernel vs plain route, layer by layer: "
          f"{lr['int8_equal']}/{lr['int8_layers']} Int8ConvBN outputs equal "
          f"bit for bit, {lr['k1_within']}/{lr['k1_layers']} K1 convs "
          f"within {tol['y_rel']:.3g}*|y| + {tol['y_scale']:.0e}*scale "
          f"(max|d| {lr['k1_max_abs_err']:.3e})")
    check(lr["int8_layers"] == DEPLOY_INT8[256] == lr["int8_equal"]
          and lr["k1_layers"] == CONVS_PER_FORWARD - DEPLOY_INT8[256]
          == lr["k1_within"], "int8 gate 256: a layer's routes differ")
    # and as whole programs (each route on its own inputs)
    sp = make_serving_fn(plain, CLASSES, 4, threshold=threshold,
                         quant=quant, int8_min_channels=256)
    lq, _ = head_logits(serves["int8 gate 256"].program.model, x)
    lp, _ = head_logits(sp.program.model, x)
    torch.cuda.synchronize()
    whole = {}
    for i in range(3):
        scale = max(1.0, lp[i].abs().max().item())
        d = (lq[i] - lp[i]).abs()
        whole[f"head{i + 1}"] = dict(
            logit_max_abs_err=d.max().item(), logit_scale=scale,
            within_tol=bool((d <= tol["y_rel"] * lp[i].abs()
                             + tol["y_scale"] * scale).all()))
        print(f"  int8 gate 256 kernel vs plain route as whole programs "
              f"head{i + 1}: logits max|d| {d.max().item():.3e} (scale "
              f"{scale:.3g}; within {tol['y_rel']:.3g}*|l| + "
              f"{tol['y_scale']:.0e}*scale: "
              f"{whole[f'head{i + 1}']['within_tol']})")
    out["int8_gate256_routes"] = dict(layers=lr, whole=whole)
    del plain, sp, lq, lp
    # the custom ops' host cost: a gate-256 request through the ops
    # against the same request calling the implementations directly
    dc = dispatch_cost(serves["int8 gate 256"], x, DISPATCH_REPS)
    out["dispatch_ab"] = dc
    print(f"  int8 gate 256 b{x.shape[0]} request, wrappers through their "
          f"custom ops {dc['custom op']['ms_per_request']:.3f} ms, calling "
          f"the implementations directly {dc['direct']['ms_per_request']:.3f}"
          f" ms (median of {len(dc['direct']['runs'])}, in turns; "
          f"{DEPLOY_INT8[256] + 1} op calls a request) [{card}]")
    # 3. the artifact, through the facade
    yolo = yolov4.Yolo(input_shape=(args.size, args.size, 3),
                       class_names=["a", "b", "c"])
    yolo.create_model(anchors=ANCHORS, pretrained_body=None,
                      dtype=torch.bfloat16, device="cuda")
    module = yolo.model.module
    module.load_state_dict(model.state_dict())
    buckets = [1, args.batch]
    arts = {"folded": {}, "int8 gate 256": dict(
        int8_calibration=calib, int8_min_channels=256)}
    loaded, art = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (kind, kw) in enumerate(arts.items()):
            path = os.path.join(tmp, f"yolov4_{i}.tysrv")
            t0 = time.perf_counter()
            yolo.export_model(path, batch_size=buckets, threshold=threshold,
                              **kw)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded[kind] = load_serving(path)
            load_s = time.perf_counter() - t0
            art[kind] = dict(export_s=export_s, load_s=load_s,
                             mib=os.path.getsize(path) / 2 ** 20,
                             meta_int8=loaded[kind].meta["int8"])
            print(f"  artifact {kind}: buckets {buckets}, export "
                  f"{export_s:.2f} s, load {load_s:.2f} s, "
                  f"{art[kind]['mib']:.1f} MiB")
    wants = {"folded": make_serving_fn(folded_copy(module), CLASSES, 4,
                                       threshold=threshold),
             "int8 gate 256": make_serving_fn(
                 module, CLASSES, 4, threshold=threshold,
                 quant=calibrate_int8(module, calib),
                 int8_min_channels=256)}
    for kind, want_fn in wants.items():
        for xb in (x, x[:3]):
            (rl, kl), cl = counted(loaded[kind], xb)
            (rw, kw), cw = counted(want_fn, xb)
            int8_launches += cl["conv_int8"] + cw["conv_int8"]
            int8_tc += cl["conv_int8_tc"] + cw["conv_int8_tc"]
            int8_quant += cl["conv_int8_quant"] + cw["conv_int8_quant"]
            print(f"  loaded {kind} b{xb.shape[0]}: equal to "
                  f"make_serving_fn {torch.equal(rl, rw)} / "
                  f"{torch.equal(kl, kw)}; launches {cl} (make_serving_fn "
                  f"{cw})")
            check(torch.equal(rl, rw) and torch.equal(kl, kw),
                  f"loaded {kind} b{xb.shape[0]} differs")
            check(cl == cw == want_serve(
                DEPLOY_INT8[256] if "int8" in kind else 0),
                  f"loaded {kind}: launches {cl}, make_serving_fn {cw}")
    out["artifact"] = art
    del wants, yolo, module
    # 4. ms/request in turns, at the serving batch and at bench_infer's
    # (and a copy of the loaded folded artifact without export's dtype
    # asserts, for the asserts' host cost)
    no_asserts = without_metadata_asserts(loaded["folded"])
    (ra, ka), ca = counted(no_asserts, x)
    (rl, kl), cl = counted(loaded["folded"], x)
    check(torch.equal(ra, rl) and torch.equal(ka, kl) and ca == cl,
          "the loaded artifact without its asserts differs")
    variants = dict(serves, **{"loaded artifact (folded)": loaded["folded"],
                               "loaded, asserts dropped": no_asserts})
    big = torch.rand(DEPLOY_BIG_BATCH, args.size, args.size, 3, generator=g,
                     device="cuda")
    times = {}
    for xb in (x, big):
        b = xb.shape[0]
        order = list(variants)
        for name in order + order[::-1]:
            fn = variants[name]
            fn(xb)
            for _ in range(DEPLOY_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(xb)
                torch.cuda.synchronize()
                times.setdefault((name, b), []).append(
                    (time.perf_counter() - t0) * 1e3)
    out["times"] = {}
    for (name, b), ts in times.items():
        ms = float(np.median(ts))
        out["times"][f"{name} b{b}"] = dict(
            ms_per_request=ms, img_per_s=b / (ms / 1e3), runs=ts)
        print(f"  {name:26s} bf16 b{b:<2d} {args.size}^2: {ms:.2f} "
              f"ms/request (median of {len(ts)}), {b / (ms / 1e3):.1f} "
              f"img/s [{card}]")
    out.update(calibrate_s=calib_s, int8_launches=int8_launches,
               int8_tc_launches=int8_tc, int8_quant_launches=int8_quant)
    return out


def _tree_leaves(node):
    if hasattr(node, "items"):
        return [v for child in node.values() for v in _tree_leaves(child)]
    return [node]


def phase_bn_sg(args, card, batch):
    """Phase 12: the frozen-statistics BatchNorm backward
    (``set_bn_stats_sg``, ``scope="backbone"``)."""
    out = {}
    # which ConvBNs it freezes: those whose forward runs in train mode
    # with bn_sg (the packed regions read their parameters without
    # calling them, as the JAX package's keep exact BN)
    frozen = {}
    for packed in (1, 3):
        m = set_bn_stats_sg(YoloV4(ANCHORS, CLASSES, device="cuda",
                                   packed=packed), True, "backbone")
        ran = set()
        hooks = [c.register_forward_pre_hook(
            lambda mod, a, name=name: ran.add(name) if mod.bn_sg else None)
            for name, c in m.named_modules() if isinstance(c, ConvBN)]
        with torch.no_grad():
            m.train()(torch.rand(2, args.size, args.size, 3,
                                 device="cuda"))
        for h in hooks:
            h.remove()
        frozen[packed] = sorted(ran)
        del m
    print(f"  scope='backbone' freezes {len(frozen[1])} ConvBNs at "
          f"packed=True (the stem and stages 1-2: "
          f"{len(frozen[1]) * 3} leaves, conv kernel, BN scale and bias) "
          f"and {len(frozen[3])} at packed=3")
    check(len(frozen[1]) == 17 and not frozen[3],
          "the frozen ConvBNs are not the JAX package's")
    # 1. the check at packed=True, where it acts: kernel route against
    # plain route (phase 8's probe-bounded check), then the frozen step
    # against the exact one on the kernel route from one state
    out["routes_f32"] = phase_train_routes_f32(args, packed=1,
                                               scope="backbone")
    # and at packed=3, where it freezes nothing: the step is phase 8's
    out["routes_f32_packed3"] = phase_train_routes_f32(args, packed=3,
                                                       scope="backbone")
    state, step, x, ys = make_training(args.seed, 2, args.size,
                                       torch.float32, packed=1)
    exact = create_train_state(copy.deepcopy(state.model),
                               make_optimizer("adam", 1e-3))
    set_bn_stats_sg(state.model, True, "backbone")
    step(state, x, ys)
    step(exact, x, ys)
    torch.cuda.synchronize()
    grads = dict(exact.model.named_parameters())
    rel = {k: rel_l2(p.grad, grads[k].grad)
           for k, p in state.model.named_parameters()}
    kernels = [f"{n}.conv.kernel" for n in frozen[1]]
    inside = tuple(f"{n}." for n in frozen[1])
    others = [k for k in rel if not k.startswith(inside)]
    med_k = float(np.median([rel[k] for k in kernels]))
    med_o = float(np.median([rel[k] for k in others]))
    max_o = max(rel[k] for k in others)
    print(f"  frozen against exact step, f32 b2 packed=True: gradient rel "
          f"L2 of the 17 frozen conv kernels median {med_k:.3e}; of the "
          f"{len(others)} leaves outside them median {med_o:.3e}, largest "
          f"{max_o:.3e}")
    check(med_k > 10 * max(med_o, 1e-9),
          "the frozen statistics term did not change the gradients")
    out["frozen_vs_exact"] = dict(kernels_median=med_k, others_median=med_o,
                                  others_max=max_o, frozen=frozen)
    del state, step, x, ys, exact
    torch.cuda.empty_cache()
    # 2. ms/step, exact BN against scope="backbone", bf16, in turns
    runs = {}
    for packed in (1, 3):
        for scope in (None, "backbone"):
            h = make_training(args.seed, batch, args.size, torch.bfloat16,
                              packed=packed)
            set_bn_stats_sg(h[0].model, scope is not None, scope)
            timed_steps(*h, 1)                 # warm-up
            runs[(packed, scope)] = h
    times = {name: [] for name in runs}
    order = list(runs)
    for name in order + order[::-1]:
        reset_train_counters()
        times[name] += timed_steps(*runs[name], args.steps)[0]
        counts = train_counters()
        want = TRAIN_LAUNCHES[name[0]]
        check(all(v == want[k] * args.steps for k, v in counts.items()),
              f"bn_sg {name}: launches {counts}, want {want} a step")
    out["times"] = {}
    for (packed, scope), ts in times.items():
        ms = float(np.median(ts))
        key = f"packed={packed} {'backbone' if scope else 'exact'}"
        out["times"][key] = dict(ms_per_step=ms,
                                 img_per_s=batch / (ms / 1e3), runs=ts)
        print(f"  {key:26s} bf16 b{batch} {args.size}^2: {ms:.2f} ms/step "
              f"(median of {len(ts)}), {batch / (ms / 1e3):.1f} img/s "
              f"[{card}]")
    return out


EVAL_IMAGES = 64                 # phase 13: one chunk of the device path
EVAL_PREDICT_BATCH = 32
EVAL_MAX_BOXES = 256             # device_max_boxes: K of the NMS kernels
EVAL_CANDIDATES = 250            # the most candidates an image may have
EVAL_MAX_PER_IMG = 100
EVAL_NAMES = ["a", "b", "c"]
MAP_MODES = ("voc2007", "voc2012", "area", "smootharea")


def eval_labels(rng, preds, threshold, size):
    """The finest label grid of each image (what ``create_score_mat``
    decodes as ``y_trues``), encoded by the port's ``encode_to_grid``
    from seeded boxes: 1-5 random boxes, and the image's three most
    confident predictions moved by up to 3 pixels, so that the curves
    have hits and misses."""
    n, grid = len(preds[0]), preds[-1].shape[1]
    out = np.zeros((n, grid, grid, 5 + CLASSES))
    for i in range(n):
        rows = host_decode(*[p[i] for p in preds], class_num=CLASSES,
                           threshold=threshold, version=4)
        rows = rows[np.argsort(-rows[:, 4] * rows[:, 6], kind="stable")[:3]]
        xy = rows[:, :2] * size + rng.uniform(-3, 3, (len(rows), 2))
        half = np.minimum(rows[:, 2:4], 0.5) * size / 2
        k = rng.randint(1, 6)
        rxy = rng.uniform(0, size * 0.8, (k, 2))
        boxes = np.concatenate([
            np.concatenate([xy - half, xy + half], 1),
            np.concatenate([rxy, rxy + rng.uniform(size * 0.05, size * 0.2,
                                                   (k, 2))], 1)])
        labels = np.concatenate([rows[:, 5].astype(int),
                                 rng.randint(0, CLASSES, k)])
        encode_to_grid(np.clip(boxes, 0, size - 1), labels, (size, size),
                       (grid, grid), CLASSES, out=out[i])
    return out


def row_index(rows, values=None):
    """{(w, h, conf, class, prob): [(x, y, value), ...]} of decoded rows.
    Both paths copy those five fields unchanged from the f32 predictions;
    x and y the host path computes in f64 and the device path in f32, so
    they are matched within ``XY_TOL``."""
    out = {}
    for i, r in enumerate(rows):
        key = tuple(float(v) for v in r[[2, 3, 4, 5, 6]])
        out.setdefault(key, []).append(
            (float(r[0]), float(r[1]), None if values is None else values[i]))
    return out


XY_TOL = 1e-5


def find_row(index, key, x, y):
    """The entry of ``index`` for the row (key, x, y), or None."""
    for entry in index.get(key, ()):
        if abs(entry[0] - x) <= XY_TOL and abs(entry[1] - y) <= XY_TOL:
            return entry
    return None


def kept_set_differences(dev_rows, host_rows):
    """Per image, the boxes one path keeps and the other does not, as
    (image, key, x, y)."""
    diff = []
    for img, (d, h) in enumerate(zip(dev_rows, host_rows)):
        for mine, other in ((row_index(d), row_index(h)),
                            (row_index(h), row_index(d))):
            for key, entries in mine.items():
                for x, y, _ in entries:
                    if find_row(other, key, x, y) is None:
                        diff.append((img, key, x, y))
    return diff


def box_overlap(a, b, diou):
    """IoU (DIoU where ``diou``) of two [x, y, w, h] centre boxes, in
    f64."""
    ax0, ay0, ax1, ay1 = a[0] - a[2] / 2, a[1] - a[3] / 2, \
        a[0] + a[2] / 2, a[1] + a[3] / 2
    bx0, by0, bx1, by1 = b[0] - b[2] / 2, b[1] - b[3] / 2, \
        b[0] + b[2] / 2, b[1] + b[3] / 2
    inter = max(0.0, min(ax1, bx1) - max(ax0, bx0)) \
        * max(0.0, min(ay1, by1) - max(ay0, by0))
    union = a[2] * a[3] + b[2] * b[3] - inter
    iou = inter / union if union > 0 else 0.0
    if not diou:
        return iou
    diag = (max(ax1, bx1) - min(ax0, bx0)) ** 2 \
        + (max(ay1, by1) - min(ay0, by0)) ** 2
    dist = (a[0] - b[0]) ** 2 + (a[1] - b[1]) ** 2
    return iou - (dist / diag if diag > 0 else 0.0)


def tie_excused(diff, dev_rows, host_rows, nms_mode, nms_threshold):
    """The entries of ``kept_set_differences`` that are exact ties: the
    box kept by one path only, and the other path keeping a box of the
    same image and class whose f32 joint confidence equals its own bit
    for bit and that overlaps it at or above ``nms_threshold`` (IoU; DIoU
    in mode 3). At such a tie the card keeps the lower index and the host
    whichever box NumPy's unstable argsort puts first. Returns (excused,
    the rest)."""
    excused, rest = [], []
    for img, key, x, y in diff:
        dev = np.asarray(dev_rows[img], np.float64).reshape(-1, 7)
        host = np.asarray(host_rows[img], np.float64).reshape(-1, 7)
        other = host if find_row(row_index(dev), key, x, y) else dev
        w, h, conf, cls, prob = key
        joint = np.float32(conf) * np.float32(prob)
        same = (other[:, 5] == cls) & (
            other[:, 4].astype(np.float32) * other[:, 6].astype(np.float32)
            == joint)
        tie = any(box_overlap((x, y, w, h), r[:4], nms_mode == 3)
                  >= nms_threshold for r in other[same])
        (excused if tie else rest).append((img, key, x, y))
    return excused, rest


def cap_ties(dev_rows, cap):
    """(image, class) groups whose ``cap``-th and next joint confidences
    are equal: there the host path's unstable NumPy argsort and the
    device path's tie-break may keep different rows."""
    ties = 0
    for rows in dev_rows:
        for c in range(CLASSES):
            joint = np.sort((rows[:, 4] * rows[:, 6])[rows[:, 5] == c])[::-1]
            ties += int(len(joint) > cap and joint[cap - 1] == joint[cap])
    return ties


def curves_equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(
        a.precisions + a.recalls, b.precisions + b.recalls))


def conf_hit_sorted(rows):
    """Detection rows (conf, gt_id, hit) as sorted (f32 conf, hit) pairs."""
    conf = rows[:, 0].astype(np.float32)
    return np.stack([conf, rows[:, 2]], 1)[np.lexsort((rows[:, 2], conf))]


def sweep_parity(dev_det, host_det, dev_gts, host_gts, dev_pr, host_pr):
    """How the two paths' PR sweeps compare. The host path's joint
    confidence is the f64 product of the f32 conf and prob, the device
    path's their f32 product (in the JAX package too), the f64 one
    rounded. So the two rank the same detections, but inside a group of
    equal f32 confidences the device path's order is what NumPy's
    unstable argsort makes of its row order, and the running counts
    inside the group may pass through other values; at the group's end
    they cannot differ. Returns (the GT counts, and each class's
    detections as (f32 confidence, hit) multisets, equal; the curves
    equal at the end of every group and at the terminal point; the
    detections that share their f32 confidence with another)."""
    same_rows = list(dev_gts) == list(host_gts)
    at_ends, tied = True, 0
    for c, (d, h) in enumerate(zip(dev_det, host_det)):
        same_rows &= d.shape == h.shape and np.array_equal(
            conf_hit_sorted(d), conf_hit_sorted(h))
        conf = np.sort(d[:, 0].astype(np.float32))[::-1]
        ends = np.flatnonzero(np.append(conf[1:] != conf[:-1], True))
        ends = np.append(ends, len(conf))           # the terminal point
        tied += len(conf) - len(np.unique(conf))
        for a, b in ((dev_pr.precisions[c], host_pr.precisions[c]),
                     (dev_pr.recalls[c], host_pr.recalls[c])):
            at_ends &= len(a) == len(b) and np.array_equal(a[ends], b[ends])
    return same_rows, at_ends, tied


def frames_equal(a, b):
    import pandas as pd
    try:
        pd.testing.assert_frame_equal(a, b)
    except AssertionError:
        return False
    return True


def phase_eval(args, model, card, device="cuda"):
    """Phase 13: device-side evaluation of 64 images at full width.
    Phase 4's network predicts them through ``engine.Model.predict``;
    ``create_score_mat`` (precision modes 0-2) and ``PRfunc`` (``get_map``
    in all four modes) run on the card (``device=True``: decode, the NMS
    kernel of the mode, matching) and on the host (``device=False``), for
    greedy, Soft and DIoU NMS, and must agree: the kept boxes equal but
    for Soft-NMS boxes in the band; the tables, the swept detections and
    the curves at the end of each group of equal confidences equal; the
    curves at every point and the maps equal where no two detections
    tie (see ``sweep_parity``).
    ``device="cpu"`` rehearses the phase on the plain versions, with no
    launch counted and nothing timed on a card."""
    import pandas  # noqa: F401  (the tables; fail here if it is missing)

    on_card = device == "cuda"
    wrapped = engine.Model(model, (args.size, args.size, 3), device=device)
    rng = np.random.RandomState(args.seed + 13)
    images = rng.randint(0, 256, (EVAL_IMAGES, args.size, args.size, 3)
                         ).astype(np.uint8)
    conv_bn_stats.launches = 0
    t0 = time.perf_counter()
    preds = wrapped.predict(images, batch_size=EVAL_PREDICT_BATCH)
    predict_ms = (time.perf_counter() - t0) * 1e3
    check(conv_bn_stats.launches == on_card * CONVS_PER_FORWARD
          * EVAL_IMAGES // EVAL_PREDICT_BATCH, "device evaluation: predict "
          f"did not run the conv kernel ({conv_bn_stats.launches} launches)")
    # the threshold that leaves each image at most EVAL_CANDIDATES
    # candidates: no image reaches device_max_boxes
    joint = np.concatenate([
        (p.reshape(EVAL_IMAGES, -1, 5 + CLASSES)[..., 4:5]
         * p.reshape(EVAL_IMAGES, -1, 5 + CLASSES)[..., 5:]).reshape(
             EVAL_IMAGES, -1) for p in preds], axis=1)
    kth = np.sort(joint, axis=1)[:, -EVAL_CANDIDATES]
    threshold = float(np.nextafter(kth.max(), np.float32(1)))
    candidates = (joint >= np.float32(threshold)).sum(axis=1)
    check(candidates.max() < EVAL_MAX_BOXES,
          "device evaluation: an image reaches the candidate cap")
    y_trues = eval_labels(rng, preds, threshold, args.size)
    print(f"  predicted {EVAL_IMAGES} images of {args.size}^2 at batch "
          f"{EVAL_PREDICT_BATCH} in {predict_ms:.1f} ms; conf_threshold "
          f"{threshold:.6f}: {int(candidates.min())}-"
          f"{int(candidates.max())} candidates an image (median "
          f"{int(np.median(candidates))}), {int(y_trues[..., 4].sum())} "
          "GT boxes")

    # the best-GT argmax on the card at an exact tie: three equal GTs,
    # the first of them must win, as on the CPU
    t_rows = torch.rand(EVAL_IMAGES, 8, 7, generator=torch.Generator(
        ).manual_seed(args.seed))
    t_rows[..., 5] = 0
    t_rows[:, 5], t_rows[:, 6] = t_rows[:, 2], t_rows[:, 2]
    t_valid = torch.ones(EVAL_IMAGES, 8, dtype=torch.bool)
    p_rows = t_rows[:, [2, 6, 0, 1]].clone()
    p_valid = torch.ones(EVAL_IMAGES, 4, dtype=torch.bool)
    got = match_pred_arrays(t_rows.to(device), t_valid.to(device),
                            p_rows.to(device), p_valid.to(device), 0.5)
    want = match_pred_arrays(t_rows, t_valid, p_rows, p_valid, 0.5)
    check(all(torch.equal(got[k].cpu(), want[k]) for k in want)
          and bool((got["best_gt"][:, :2] == 2).all()),
          "device evaluation: best GT on the card differs at a tie")

    out = dict(threshold=threshold, predict_ms=predict_ms,
               conv_launches=conv_bn_stats.launches,
               candidates=candidates.tolist(), modes={})
    for nms_mode in (1, 2, 3):
        kw = dict(class_names=EVAL_NAMES, conf_threshold=threshold,
                  nms_mode=nms_mode, nms_threshold=0.45, nms_sigma=0.5,
                  iou_threshold=0.5, version=4,
                  device_max_boxes=EVAL_MAX_BOXES)
        runs, times = {}, {}
        for path in (True, False):
            on = (True if on_card else device) if path else False
            nms_keep.launches = soft_nms_keep.launches = 0
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                mats = [create_score_mat(y_trues, *preds, device=on,
                                         precision_mode=m, **kw)
                        for m in (0, 1, 2)]
                sync(device)
                t1 = time.perf_counter()
                pr = PRfunc(y_trues, *preds, device=on,
                            max_per_img=EVAL_MAX_PER_IMG, **kw)
                sync(device)
                t2 = time.perf_counter()
            check(not [w for w in caught if "max_boxes" in str(w.message)],
                  "device evaluation: the saturation warning fired")
            launches = (nms_keep.launches, soft_nms_keep.launches)
            want = (0, 0) if not (on_card and path) else \
                (0, 4) if nms_mode == 2 else (4, 0)
            check(launches == want, f"device evaluation, nms_mode "
                  f"{nms_mode}, device={on}: NMS launches {launches}, "
                  f"want {want} (one a chunk)")
            if path:
                out.setdefault("nms_launches", 0)
                out.setdefault("soft_nms_launches", 0)
                out["nms_launches"] += launches[0]
                out["soft_nms_launches"] += launches[1]
            runs[path] = (mats, pr, [pr.get_map(m) for m in MAP_MODES])
            times[path] = dict(score_mat_ms=(t1 - t0) * 1e3 / 3,
                               prfunc_ms=(t2 - t1) * 1e3)
        # the kept boxes of each image on both paths
        _, dev_p = decode_batch_device(
            y_trues, preds, CLASSES, threshold, nms_mode, 0.45, 0.5, 4,
            EVAL_MAX_BOXES, device=True if on_card else device)
        host_p = [_decode_pair(y_trues[i], [p[i] for p in preds], CLASSES,
                               threshold, nms_mode, 0.45, 0.5, 4)[1]
                  for i in range(EVAL_IMAGES)]
        diff = kept_set_differences(dev_p, host_p)
        ties, unexcused = tie_excused(diff, dev_p, host_p, nms_mode, 0.45)
        # the chunk's NMS alone on the card, on its own decoded rows
        p_rows, p_valid = decode_multi_level(
            [torch.as_tensor(p, device=device) for p in preds],
            class_num=CLASSES, threshold=threshold,
            max_boxes=EVAL_MAX_BOXES, version=4)
        rows_s, valid_s = _sorted_by_conf(p_rows, p_valid)
        boxes = torch.cat([rows_s, valid_s[..., None].float()],
                          -1).contiguous()
        plan = nms_mod._plan(*boxes.shape[:2])
        in_band = outside = 0
        if nms_mode == 2:
            def launch():
                if not on_card:              # the wrapper's plain version
                    return soft_nms_keep(boxes, 0.45, threshold, 0.5), None
                return nms_mod._soft_launch(boxes, 0.45, threshold, 0.5,
                                            plan)
            band = soft_band(boxes, launch()[0], 0.45, threshold, 0.5)
            check(band["mismatches_outside"] == 0, "device evaluation: "
                  "Soft-NMS kernel differs from the plain scan")
            # host (f64) against device (f32): a box counts as in the band
            # when its f32 decayed confidence lies within
            # (4 + 16 decays) eps of the threshold
            valid, _, conf = soft_nms_scan_plain(boxes, 0.45, threshold,
                                                 0.5)
            words = soft_overlap_words_plain(boxes, 0.45)
            decays = sum(((words >> b) & 1) for b in range(64)).sum(-1)
            eps = float(np.finfo(np.float32).eps)
            index = [row_index(boxes[img][valid[img]].cpu().numpy(), list(
                zip(conf[img][valid[img]].tolist(),
                    decays[img][valid[img]].tolist())))
                for img in range(boxes.shape[0])]
            for img, key, x, y in unexcused:
                entry = find_row(index[img], key, x, y)
                if entry is not None and abs(entry[2][0] - threshold) <= \
                        (4 + 16 * entry[2][1]) * eps * threshold:
                    in_band += 1
                else:
                    outside += 1
        else:
            iou_mode = 1 if nms_mode == 1 else 2

            def launch():
                if not on_card:
                    return nms_keep(boxes, 0.45, iou_mode), None
                return nms_mod._launch(boxes, 0.45, iou_mode, plan)
            check(torch.equal(launch()[0], nms_keep_plain(boxes, 0.45,
                                                          iou_mode)),
                  "device evaluation: greedy kernel differs from plain")
            outside = len(unexcused)
        nms_alone_ms = nms_wrapper_ms = float("nan")     # not on a card
        if on_card:
            nms_alone_ms = graph_ms(launch)
            nms_wrapper_ms = cuda_ms(lambda: apply_nms_device(
                p_rows, p_valid, nms_mode=nms_mode, nms_threshold=0.45,
                conf_threshold=threshold, nms_sigma=0.5), 10)
        (dmats, dpr, dmaps), (hmats, hpr, hmaps) = runs[True], runs[False]
        # the detections each path's PRfunc sweeps (again, uncounted)
        collect = (y_trues, preds, CLASSES, threshold, nms_mode, 0.45, 0.5,
                   0.5, EVAL_MAX_PER_IMG, 4)
        dev_gts, dev_det = PRfunc._collect_device(
            *collect, EVAL_MAX_BOXES, torch.device(device))
        host_gts, host_det = PRfunc._collect_host(*collect)
        same_rows, at_ends, tied = sweep_parity(
            dev_det, host_det, dev_gts, host_gts, dpr, hpr)
        equal = dict(
            tables=all(frames_equal(a, b) for a, b in zip(dmats, hmats)),
            detections=same_rows, curves_at_tie_ends=at_ends,
            curves=curves_equal(dpr, hpr),
            maps=all(frames_equal(a, b) for a, b in zip(dmaps, hmaps)))
        map_diff = max(float((a["ap"] - b["ap"]).abs().max())
                       for a, b in zip(dmaps, hmaps))
        cap_tie = cap_ties(dev_p, EVAL_MAX_PER_IMG)
        r = dict(nms_mode=nms_mode, equal=equal, kept_differ=len(diff),
                 kept_differ_tie_excused=len(ties),
                 kept_differ_in_band=in_band,
                 kept_differ_outside_band=outside, cap_ties=cap_tie,
                 tied_detections=tied, map_max_abs_diff=map_diff,
                 kept_device=int(sum(len(p) for p in dev_p)),
                 kept_host=int(sum(len(p) for p in host_p)),
                 map_area=float(dmaps[2].loc["mAP", "ap"]),
                 map_area_host=float(hmaps[2].loc["mAP", "ap"]),
                 device=times[True], host=times[False],
                 nms_alone_ms=nms_alone_ms, nms_wrapper_ms=nms_wrapper_ms,
                 chunk=list(boxes.shape[:2]))
        out["modes"][nms_mode] = r
        name = {1: "greedy (K4)", 2: "Soft (S)", 3: "DIoU (K4)"}[nms_mode]
        print(f"  nms_mode {nms_mode}, {name}: kept {r['kept_device']} "
              f"boxes on the card, {r['kept_host']} on the host; "
              f"{len(diff)} differ, {len(ties)} of them excused as exact "
              f"ties, {in_band} in the band, {outside} "
              f"outside (bound 0); {cap_tie} ties at the cap; equal: "
              + ", ".join(f"{k} {v}" for k, v in equal.items())
              + f"; {tied} detections share their f32 confidence; mAP (area) "
              f"{r['map_area']:.6f} card, {r['map_area_host']:.6f} host, "
              f"APs differ by at most {map_diff:.2e}")
        print(f"    ms for {EVAL_IMAGES} images, device | host: "
              f"create_score_mat {times[True]['score_mat_ms']:.1f} | "
              f"{times[False]['score_mat_ms']:.1f}, PRfunc "
              f"{times[True]['prfunc_ms']:.1f} | "
              f"{times[False]['prfunc_ms']:.1f}; NMS a chunk "
              f"(N={boxes.shape[0]}, K={boxes.shape[1]}): alone "
              f"{nms_alone_ms:.4f} ms, through apply_nms_device "
              f"{nms_wrapper_ms:.4f} ms")
        check(outside == 0, f"device evaluation, nms_mode {nms_mode}: "
              f"{outside} kept boxes differ outside the band")
        check(cap_tie == 0, "device evaluation: a tie at the max_per_img "
              "cap, where the paths may keep different rows")
        # the tables always; the swept detections and the curves at the
        # end of each group of equal f32 confidences always; the curves at
        # every point and the maps where no two detections tie; all of it
        # but where Soft-NMS boxes in the band or exact ties are kept by
        # one path only
        must = ["tables", "detections", "curves_at_tie_ends"] + (
            ["curves", "maps"] if tied == 0 else [])
        check(in_band > 0 or ties or all(equal[k] for k in must),
              f"device evaluation, nms_mode {nms_mode}: the device path's "
              f"results differ from the host path's: {equal}")
        check(0 < r["map_area"] < 1, "device evaluation: degenerate mAP")
    out["card"] = card
    return out


# ---------------------------------------------------------------- phase 14
# The other families, each through its facade at full width: (name,
# facade module, input size, create_model keyword arguments). YOLOv3 with
# Darknet-53 is the slice's main path; the tiny body takes 2 x 3 of the
# default anchors.
FAMILY_RUNS = [
    ("yolov3", yolov3, 416, dict(pretrained_body=None)),
    ("yolov3 tiny", yolov3, 416, dict(
        backbone="tiny_darknet", anchors=yolov3.DEFAULT_ANCHORS[3:],
        pretrained_body=None)),
    ("yolov2 darknet", yolov2, 416, {}),
    ("yolov2 unet", yolov2, 416, dict(backbone="unet")),
    ("yolov1.5", yolov1_5, 448, {}),
]
FAMILY_NAMES = ["a", "b", "c"]
FAMILY_REQUESTS = 3              # timed requests of the main path
FAMILY_STEPS = 3                 # timed steps of the main path
FAMILY_TRAIN_BATCH = 32          # the main path's training batch
OTHER_TRAIN_BATCH = 16           # the other families'
# an activation input nearer its kink (leaky, relu) than this may fall on
# either side of it on the two routes, whose f32 forwards differ by
# rounding: the leaves of the layers before it are then held to
# KINK_BOUND (tests/helpers_families.py measured the effect, 1e-2)
NEAR_KINK = 1e-4
KINK_BOUND = 0.05


def family_model(mod, size, kw, dtype, seed):
    """(facade, module) of ``mod.Yolo`` at ``size``^2, built on the card
    in ``dtype`` from ``seed`` (HE_NORMAL kernels)."""
    yolo = mod.Yolo(input_shape=(size, size, 3), class_names=FAMILY_NAMES)
    m = yolo.create_model(dtype=dtype, seed=seed, device="cuda", **kw)
    return yolo, m.module


def family_loss(yolo):
    losses = yolo.loss(binary_weight=1) if yolo.version == 1 \
        else yolo.loss()
    return losses if isinstance(losses, list) else [losses]


def family_labels(yolo, batch, rng):
    """Synthetic labels of the facade's layout, coarse level first: four
    boxes per image and level."""
    levels = getattr(yolo, "fpn_layers", 1)
    ys = []
    for level in range(levels):
        g = yolo.grid_shape[0] * 2 ** level
        y = np.zeros((batch, g, g, 5 + len(FAMILY_NAMES)), np.float32)
        for b in range(batch):
            for _ in range(4):
                gy, gx = rng.randint(0, g, 2)
                y[b, gy, gx, :5] = [*rng.rand(2), 0.2, 0.3, 1.0]
                y[b, gy, gx, 5 + rng.randint(len(FAMILY_NAMES))] = 1.0
        ys.append(torch.from_numpy(y).cuda())
    return tuple(ys)


def as_outputs(outs):
    return list(outs) if isinstance(outs, (list, tuple)) else [outs]


def family_joint(outs, version):
    c = len(FAMILY_NAMES)
    joint = []
    for o in as_outputs(outs):
        n = o.shape[0]
        if version == 1:
            b = (o.shape[-1] - c) // 5
            conf = o[..., :5 * b].reshape(*o.shape[:3], b, 5)[..., 4:5]
            joint.append((conf * o[..., None, 5 * b:]).reshape(n, -1))
        else:
            r = o.reshape(n, -1, 5 + c)
            joint.append((r[..., 4:5] * r[..., 5:]).reshape(n, -1))
    return torch.cat(joint, dim=1)


def conv_count(model):
    """The convs of a tree (ConvBN, ConvActBN and head convs): the
    conv kernel's launches of one forward."""
    return sum(isinstance(m, Conv) for m in model.modules())


def conv_routes(model):
    """The convs of a tree by the route of their bf16 plan ("tc", the
    ring and the small-Ci kernel, or "cuda_core"): the plan depends on
    the channels and the geometry, not on H and W."""
    routes = {"tc": 0, "cuda_core": 0}
    for m in model.modules():
        if isinstance(m, Conv):
            k, _, ci, co = m.kernel.shape
            routes[conv_mod._tc_plan(1, 64, 64, ci, co, k, m.stride,
                                     torch.bfloat16, m.padding).route] += 1
    return routes


def reset_family_counters():
    conv_bn_stats.launches = conv_bn_stats.tc_launches = 0
    conv_bn_stats.by_geometry.clear()
    nms_keep.launches = soft_nms_keep.launches = 0
    layers_mod.depthwise_conv.calls = 0
    reset_fused_counters()


def family_counters():
    return dict(conv_bn_stats=conv_bn_stats.launches,
                conv_bn_stats_tc=conv_bn_stats.tc_launches,
                nms_keep=nms_keep.launches,
                by_geometry=dict(conv_bn_stats.by_geometry),
                depthwise_calls=layers_mod.depthwise_conv.calls,
                fused=fused_counters())


def kept_match(rows_a, keep_a, rows_b, keep_b, tol):
    """Kept rows of route a found in route b's kept rows of the same
    image (same class, the other fields within ``tol``), and the kept
    count of each."""
    found = total = 0
    for i in range(rows_a.shape[0]):
        a = rows_a[i][keep_a[i]]
        b = rows_b[i][keep_b[i]]
        total += a.shape[0]
        if not a.shape[0] or not b.shape[0]:
            continue
        d = (a[:, None, :] - b[None, :, :]).abs()
        same = (d[..., 5] == 0) & (d.amax(-1) <= tol)
        found += int(same.any(dim=1).sum())
    return found, total, int(keep_b.sum())


def family_routes_f32(yolo_mod, size, kw, model16, images, threshold,
                      version, probe=False):
    """The f32 model on the same weights, kernel route against the plain
    route: head outputs within phase 5's bounds, relative to scale, and
    the served rows that each route keeps. ``probe`` (phase 15's
    ResNet-101 v2 and ResNet-152) also runs the plain route on the
    images moved up by one f32 ulp, and takes a level whose difference
    stays within 4 times that probe's as within its bound: the ResNets'
    BN eps of 1.001e-5 lets a channel of
    small variance gain up to 316x, and the deeper ones amplify f32
    rounding beyond phase 5's bound (``tests/helpers_families.py``
    measured the same against JAX)."""
    _, model = family_model(yolo_mod, size, kw, torch.float32, 0)
    model.load_state_dict(model16.state_dict())
    model.eval()
    plain = use_plain_route(copy.deepcopy(model))
    moved = torch.nextafter(images, torch.full_like(images, 2.0))
    with torch.inference_mode():
        ok, op = as_outputs(model(images)), as_outputs(plain(images))
        oe = as_outputs(plain(moved)) if probe else op
    torch.cuda.synchronize()
    errs, noises = [], []
    for i, (a, b, e) in enumerate(zip(ok, op, oe)):
        d = (a - b).abs()
        errs.append(d.max().item())
        noises.append((e - b).abs().max().item())
        check(bool(torch.isfinite(a).all())
              and (bool((d <= 5e-3 + 2e-2 * b.abs()).all())
                   or (probe and errs[-1] <= 4 * noises[-1])),
              f"level {i}: kernel and plain outputs differ: max|d| "
              f"{errs[-1]:.3e}, probe {noises[-1]:.3e}")
    serve = functools.partial(make_serving_fn, class_num=len(FAMILY_NAMES),
                              version=version, threshold=threshold)
    rows, keep = serve(model)(images)
    rows_p, keep_p = serve(plain)(images)
    found, kept, kept_p = kept_match(rows, keep, rows_p, keep_p, 5e-3)
    res = dict(out_max_abs_err=errs, kept=kept, kept_plain=kept_p,
               kept_found=found)
    if probe:
        rows_e, keep_e = serve(plain)(moved)
        res.update(out_probe_max_abs_diff=noises,
                   kept_probe_found=kept_match(rows_e, keep_e, rows_p,
                                               keep_p, 5e-3)[0],
                   kept_probe=int(keep_e.sum()))
    return res


def family_train_routes_f32(yolo, model16, x, ys):
    """One f32 step at batch 2 on both routes from the same state, and a
    probe of the plain route on x + 1e-6: phase 8's rule per leaf,
    min(0.3, max(5 x probe, 1e-3)), with the leaves before the last
    layer whose activation input lies within NEAR_KINK of its kink held
    to max(5 x probe, KINK_BOUND) instead."""
    model = copy.deepcopy(model16).float()
    for m in model.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float32
    model.train()
    kinks = {}

    def leaky_in(name, out):
        o = out.detach()
        kinks[name] = float(torch.where(o >= 0, o, -10 * o).min())

    def relu_in(name, out):
        kinks[name] = float(out[0].detach().abs().min())

    def bn_out(name, out):
        # a keras block's BN output feeds relu or relu6 (kinks 0 and 6)
        o = out.detach()
        near = float(torch.minimum(o.abs(), (o - 6).abs()).min())
        kinks[name] = min(kinks.get(name, near), near)

    handles = []
    paired = {n for n, m in model.named_modules()
              if isinstance(m, (ConvBN, ConvActBN))}
    for name, m in model.named_modules():
        if isinstance(m, ConvBN) and m.act == "leaky":
            handles.append(m.register_forward_hook(
                lambda mod, i, out, name=name: leaky_in(name, out)))
        elif isinstance(m, ConvActBN):
            handles.append(m.conv.register_forward_hook(
                lambda mod, i, out, name=name: relu_in(name, out)))
        elif isinstance(m, BNState) and \
                name.rpartition(".")[0] not in paired:
            handles.append(m.register_forward_hook(
                lambda mod, i, out, name=name.rpartition(".")[0]:
                bn_out(name, out)))
    states = {}
    for route in ("kernel", "plain", "probe"):
        mm = model if route == "kernel" else use_plain_route(
            copy.deepcopy(model))
        states[route] = create_train_state(mm, make_optimizer("adam", 1e-3))
    step = make_train_step(family_loss(yolo))
    _, logs = step(states["kernel"], x, ys)
    for h in handles:
        h.remove()
    _, logs_p = step(states["plain"], x, ys)
    _, logs_e = step(states["probe"], x + 1e-6, ys)
    torch.cuda.synchronize()
    loss, loss_p = float(logs["loss"]), float(logs_p["loss"])
    loss_rel = abs(loss - loss_p) / abs(loss_p)
    loss_noise = abs(float(logs_e["loss"]) - loss_p) / abs(loss_p)
    order = list(kinks)
    near = [i for i, n in enumerate(order) if kinks[n] < NEAR_KINK]
    upstream = set(order[:near[-1] + 1]) if near else set()
    plain_p = dict(states["plain"].model.named_parameters())
    probe_p = dict(states["probe"].model.named_parameters())
    worst, failed, n_kink = 0.0, [], 0
    for name, p in states["kernel"].model.named_parameters():
        q, e = plain_p[name], probe_p[name]
        if p.grad is None and q.grad is None:
            continue
        rel, noise = rel_l2(p.grad, q.grad), rel_l2(e.grad, q.grad)
        # the v4 anchors take their gradient from the loss alone, where a
        # box that crosses the ignore threshold moves it by a step
        # (tests/helpers_families.py)
        if name.rsplit(".", 2)[0] in upstream or name.endswith("anchors"):
            n_kink += 1
            bound = max(5 * noise, KINK_BOUND)
        else:
            bound = min(0.3, max(5 * noise, 1e-3))
        worst = max(worst, rel)
        if rel > bound:
            failed.append((name, rel, noise))
    check(np.isfinite(loss) and loss_rel <= 1e-5 + 4 * loss_noise,
          f"route losses differ: {loss} against {loss_p}")
    check(not failed, f"route gradients differ at {failed[:5]}")
    return dict(loss=loss, loss_plain=loss_p, loss_rel=loss_rel,
                loss_rel_probe=loss_noise, grad_rel_l2_max=worst,
                near_kink_layers=len(near), leaves_near_kink=n_kink)


def family_run(args, name, mod, size, kw, main, card, train=True,
               deploy=False, lr=1e-3, probe=False):
    """Serve and train one family on the card (see phases 14 and 15):
    ``train=False`` serves only; ``deploy`` adds the main path's folded
    and int8 requests (:func:`backbone_deploy`); ``lr`` is Adam's rate;
    ``probe`` bounds the f32 routes by a probe as well
    (:func:`family_routes_f32`)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    yolo, model = family_model(mod, size, kw, torch.bfloat16, args.seed)
    model.eval()
    version, convs = yolo.version, conv_count(model)
    routes_tc = conv_routes(model)["tc"]
    dws = sum(isinstance(m, DepthwiseConv) for m in model.modules())
    calib = torch.rand(args.batch, size, size, 3, generator=gen,
                       device="cuda")
    calibrate_bn(model, calib)
    with torch.inference_mode():
        joint = family_joint(model(calib), version).float()
    threshold = float(torch.quantile(
        joint[0], max(0.0, 1 - 64 / joint.shape[1])))
    images = [torch.rand(args.batch, size, size, 3, generator=gen,
                         device="cuda")
              for _ in range(1 + (FAMILY_REQUESTS if main else 0))]
    serve = make_serving_fn(model, len(FAMILY_NAMES), version,
                            threshold=threshold)
    reset_family_counters()
    times = []
    for req, x in enumerate(images):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rows, keep = serve(x)
        torch.cuda.synchronize()
        if req:
            times.append((time.perf_counter() - t1) * 1e3)
        check(bool(torch.isfinite(rows).all()) and int(keep.sum()) > 0,
              f"{name}: degenerate served rows")
    served = family_counters()
    n_req = len(images)
    check(served["conv_bn_stats"] == convs * n_req,
          f"{name}: {served['conv_bn_stats']} conv launches in {n_req} "
          f"requests, want {convs} a request")
    check(served["conv_bn_stats_tc"] == routes_tc * n_req
          and served["depthwise_calls"] == dws * n_req,
          f"{name}: {served['conv_bn_stats_tc']} tensor-core conv launches "
          f"and {served['depthwise_calls']} depthwise calls in {n_req} "
          f"requests, want {routes_tc} and {dws} a request")
    check(served["nms_keep"] == n_req,
          f"{name}: the NMS kernel did not run once a request")
    check(not any(served["fused"].values()),
          f"{name}: a served request ran a fused kernel")
    routes = family_routes_f32(mod, size, kw, model, images[0], threshold,
                               version, probe)
    # with the probe: or as many as the probe's rows found in the plain
    # route's, less 2% of the rows kept and at least 90% of the probe's
    check((routes["kept_found"] >= 0.95 * routes["kept"]
           or (probe and routes["kept_found"]
               >= max(routes["kept_probe_found"] - 0.02 * routes["kept"],
                      0.9 * routes["kept_probe_found"])))
          and routes["kept_plain"] <= 1.05 * routes["kept"],
          f"{name}: the routes keep other rows: {routes}")
    del serve
    deployed = backbone_deploy(args, mod, size, kw, model, threshold,
                               images[0], convs) if deploy else None
    res = dict(version=version, size=size, convs=convs,
               convs_tc=routes_tc, depthwise=dws, threshold=threshold,
               serve_launches=served, requests=n_req, routes_f32=routes,
               ms_per_request=times, deploy=deployed)
    if not train:
        del model
        torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t0
        print(f"  {name} {size}^2: {convs} convs ({routes_tc} on the "
              f"tensor cores); served {n_req} x b{args.batch}: conv "
              f"launches {served['conv_bn_stats']} (tensor cores "
              f"{served['conv_bn_stats_tc']}), nms_keep "
              f"{served['nms_keep']}, by geometry {served['by_geometry']}; "
              f"f32 routes: outputs max|d| "
              f"{', '.join(f'{e:.2e}' for e in routes['out_max_abs_err'])}"
              f", kept {routes['kept']} (plain {routes['kept_plain']}), "
              f"found in plain {routes['kept_found']} "
              f"[{res['seconds']:.1f} s]")
        return res

    batch = FAMILY_TRAIN_BATCH if main else OTHER_TRAIN_BATCH
    rng = np.random.RandomState(args.seed)
    _, tmodel = family_model(mod, size, kw, torch.bfloat16, args.seed)
    state = create_train_state(tmodel, make_optimizer("adam", lr))
    step = make_train_step(family_loss(yolo))
    x = torch.rand(batch, size, size, 3, generator=gen, device="cuda")
    ys = family_labels(yolo, batch, rng)
    reset_family_counters()
    step_ms, losses = timed_steps(state, step, x, ys,
                                  1 + (FAMILY_STEPS if main else 0))
    trained = family_counters()
    n_steps = len(losses)
    check(all(np.isfinite(losses)), f"{name}: non-finite training loss")
    check(trained["conv_bn_stats"] == convs * n_steps
          and trained["conv_bn_stats_tc"] == routes_tc * n_steps
          and trained["depthwise_calls"] == dws * n_steps,
          f"{name}: {trained['conv_bn_stats']} conv launches "
          f"({trained['conv_bn_stats_tc']} on the tensor cores) and "
          f"{trained['depthwise_calls']} depthwise calls in {n_steps} "
          f"steps, want {convs} ({routes_tc}) and {dws} a step")
    if main:
        check(losses[-1] < losses[0], f"{name}: the loss did not fall")
    train_routes = None
    if main:
        train_routes = family_train_routes_f32(
            yolo, tmodel, x[:2].float().contiguous(),
            tuple(y[:2] for y in ys))
    del state, step, tmodel, model
    torch.cuda.empty_cache()
    res.update(train_launches=trained, steps=n_steps, train_batch=batch,
               losses=losses, train_routes_f32=train_routes,
               ms_per_step=step_ms[1:] if main else step_ms,
               seconds=time.perf_counter() - t0)
    print(f"  {name} {size}^2: {convs} convs ({routes_tc} on the tensor "
          f"cores, {dws} depthwise); served {n_req} x b"
          f"{args.batch}: conv launches {served['conv_bn_stats']} (tensor "
          f"cores {served['conv_bn_stats_tc']}), nms_keep "
          f"{served['nms_keep']}, by geometry {served['by_geometry']}; "
          f"f32 routes: outputs max|d| "
          f"{', '.join(f'{e:.2e}' for e in routes['out_max_abs_err'])} "
          f"(bound 5e-3 + 2e-2|out|), kept {routes['kept']} (plain "
          f"{routes['kept_plain']}), found in plain {routes['kept_found']}; "
          f"train b{batch} bf16 {n_steps} step(s): losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}, conv launches "
          f"{trained['conv_bn_stats']} (tensor cores "
          f"{trained['conv_bn_stats_tc']}) [{res['seconds']:.1f} s]")
    if main:
        tr = train_routes
        print(f"  {name}: {float(np.median(times)):.2f} ms/request (b"
              f"{args.batch}, median of {len(times)}), "
              f"{float(np.median(res['ms_per_step'])):.2f} ms/step (b"
              f"{batch}, median of {len(res['ms_per_step'])}) [{card}]; "
              f"f32 b2 step, kernel vs plain: loss rel {tr['loss_rel']:.2e}"
              f" (probe {tr['loss_rel_probe']:.2e}), gradient rel L2 max "
              f"{tr['grad_rel_l2_max']:.2e}, {tr['near_kink_layers']} "
              f"layers near a kink, {tr['leaves_near_kink']} leaves before "
              "them")
    return res


def phase_families(args, card):
    """Phase 14: each family of FAMILY_RUNS at full width in bf16."""
    t0 = time.perf_counter()
    out = {}
    for name, mod, size, kw in FAMILY_RUNS:
        out[name] = family_run(args, name, mod, size, kw,
                               name == FAMILY_RUNS[0][0], card)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 14 took {out['seconds']:.1f} s")
    return out


def geometry_launches(families, key):
    """Launches of one conv geometry (``conv_bn.geometry_key`` without
    its route) in phase 14's served requests and training steps."""
    total = 0
    for name, _, _, _ in FAMILY_RUNS:
        for run in ("serve_launches", "train_launches"):
            total += sum(v for k, v in
                         families[name][run]["by_geometry"].items()
                         if k.rsplit(" ", 1)[0] == key)
    return total


# ---------------------------------------------------------------- phase 15
def resnet50_factory(**kw):
    """A user backbone factory (``create_model(backbone=callable)``,
    called with ``dtype``, ``generator`` and ``device``): a ResNet-50
    v1, whose module states its taps' channels in ``out_channels``."""
    return ResNet(depth=50, **kw)


# The backbones the facades take beside the darknets, each through its
# facade at full width, widths and depths uncut: (name, facade module,
# input size, create_model keyword arguments, what runs, probe). YOLOv4
# with ResNet-50 is the slice's main path ("main": 1 + 3 requests of the
# serving batch and 1 + 3 Adam steps at batch 32, both routes in f32, the
# folded and the int8 request); "both" one request and one step of 16;
# "serve" one request. ``probe`` (the deep ResNets only) lets the f32
# routes' check take the plain route's own probe as its bound where it
# exceeds phase 5's (:func:`family_routes_f32`); the others, the main
# path among them, are held to phase 5's bounds alone.
BACKBONE_RUNS = [
    ("yolov4 resnet50", yolov4, 416, dict(
        backbone="resnet50", anchors=ANCHORS, pretrained_body=None), "main",
     False),
    ("yolov3 resnet101v2", yolov3, 416, dict(
        backbone="resnet101v2", pretrained_body=None), "both", True),
    ("yolov2 mobilenet", yolov2, 416, dict(backbone="mobilenet"), "both",
     False),
    ("yolov3 factory (resnet50)", yolov3, 416, dict(
        backbone=resnet50_factory, pretrained_body=None), "both", False),
    ("yolov4 resnet152", yolov4, 416, dict(
        backbone="resnet152", anchors=ANCHORS, pretrained_body=None),
     "serve", True),
]
# Adam's rate on the backbones: at 1e-3 the random YOLOv4 with ResNet-50
# (BN eps 1.001e-5) overshoots on the same batch (f32 on the CPU, 416^2,
# batch 4, 5 steps: loss 507.89 733.67 282.91 301.76 574.95); at 1e-4 it
# falls step by step (507.89 478.56 443.90 418.78 389.34)
BACKBONE_LR = 1e-4
# the classifier functions, one bf16 step of 16 each: (function of
# ``models``, input size, keyword arguments)
CLASSIFIER_RUNS = [("csp_darknet53", 448, dict(weights=None,
                                                class_num=1000)),
                   ("darknet19", 416, {})]


def backbone_deploy(args, mod, size, kw, model, threshold, x, convs):
    """The main path's deployment requests, held as phase 11 holds them:
    the f32 BN-folded model's head logits and outputs against the
    unfolded model's within phase 5's bounds (the fold's rule for the
    ResNet scopes, eps 1.001e-5, included); a folded bf16 request's
    launches; ``calibrate_int8`` on two seeded batches and a request at
    gate 256: every calibrated ConvBN (the neck's: the ResNet's convs are
    no ConvBNs) of min(Ci, Co) >= 256 on Q, the rest on K1, its rows'
    confidence field within phase 11's bound of the bf16 rows', and the
    kernel route against the plain route layer by layer."""
    out = {}
    _, m32 = family_model(mod, size, kw, torch.float32, 0)
    m32.load_state_dict(model.state_dict())
    m32.eval()
    lk, ok = head_logits(m32, x[:2])
    lf, of = head_logits(folded_copy(m32), x[:2])
    torch.cuda.synchronize()
    out["folded_f32"] = head_bound_check(lf, lk, of, ok,
                                         "f32 folded vs unfolded")
    rows_32, _ = make_serving_fn(m32, CLASSES, 4, threshold=threshold)(x)
    del m32, lk, ok, lf, of
    (rows_b, keep_b), _ = counted(
        make_serving_fn(model, CLASSES, 4, threshold=threshold), x)

    def want(n_q):
        return dict(conv_bn_stats=convs - n_q, conv_bn_stats_tc=convs - n_q,
                    conv_int8=n_q, conv_int8_tc=n_q, conv_int8_quant=n_q,
                    nms_keep=1, soft_nms_keep=0, fused=0)

    _, cnt = counted(make_serving_fn(folded_copy(model), CLASSES, 4,
                                     threshold=threshold), x)
    print(f"  folded request: launches {cnt}")
    check(cnt == want(0), f"folded: launches {cnt}, want {want(0)}")
    out["folded_launches"] = cnt
    g = torch.Generator(device="cuda").manual_seed(args.seed + 15)
    calib = [torch.rand(args.batch, size, size, 3, generator=g,
                        device="cuda") for _ in range(2)]
    quant = calibrate_int8(model, calib)
    convbns = [m for m in model.modules()
               if isinstance(m, ConvBN) and m.bn is not None]
    scales = [v for stage in quant["quant"].values()
              for v in _tree_leaves(stage)]
    check(len(scales) == len(convbns) and all(float(v) > 0 for v in scales),
          f"calibration: want {len(convbns)} positive scales")
    n_q = sum(min(m.conv.kernel.shape[2:]) >= 256 for m in convbns)
    serve = make_serving_fn(model, CLASSES, 4, threshold=threshold,
                            quant=quant, int8_min_channels=256)
    check(sum(isinstance(m, Int8ConvBN) for m in serve.program.modules())
          == n_q, f"gate 256: want {n_q} int8 ConvBNs")
    (rows_q, keep_q), cnt = counted(serve, x)
    check(cnt == want(n_q), f"int8 gate 256: launches {cnt}, want "
          f"{want(n_q)}")
    bf16_d = (rows_b[..., 4] - rows_32[..., 4]).abs().max().item()
    conf_bound = max(INT8_CONF_BOUND, 2 * bf16_d)
    conf_d = (rows_q[..., 4] - rows_b[..., 4]).abs().max().item()
    check(bool(torch.isfinite(rows_q).all()) and conf_d <= conf_bound,
          f"int8 gate 256 rows: confidence max|d| {conf_d} > {conf_bound}")
    lr = layer_routes(serve.program.model, x)
    tol = TOL[torch.bfloat16]
    print(f"  int8 gate 256: {n_q} of {len(convbns)} ConvBNs on Q; "
          f"launches {cnt}; confidence field against bf16 max|d| "
          f"{conf_d:.4f} (bound {conf_bound:.4f}); kernel vs plain route "
          f"layer by layer: {lr['int8_equal']}/{lr['int8_layers']} "
          f"Int8ConvBN equal bit for bit, {lr['k1_within']}/"
          f"{lr['k1_layers']} K1 convs within {tol['y_rel']:.3g}*|y| + "
          f"{tol['y_scale']:.0e}*scale (max|d| {lr['k1_max_abs_err']:.3e})")
    check(lr["int8_layers"] == n_q == lr["int8_equal"]
          and lr["k1_layers"] == convs - n_q == lr["k1_within"],
          "int8 gate 256: a layer's routes differ")
    out.update(int8_convbns=n_q, int8_launches=cnt,
               int8_conf_max_abs_diff=conf_d, int8_conf_bound=conf_bound,
               int8_layer_routes=lr, kept_int8=int(keep_q.sum()),
               kept_bf16=int(keep_b.sum()))
    return out


def classifier_run(args, fn_name, size, kw):
    """One bf16 training step of 16 of a classifier function through
    ``make_train_step`` (a cross-entropy of its softmax, Adam): a
    finite loss, and the conv kernel's launches the tree's convs, on the
    tensor cores where their plan says."""
    t0 = time.perf_counter()
    model = getattr(models_mod, fn_name)(
        input_shape=(size, size, 3), seed=args.seed, dtype=torch.bfloat16,
        device="cuda", **kw)
    module = model.module
    convs, routes_tc = conv_count(module), conv_routes(module)["tc"]
    classes = model.output_shapes[-1]
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 15)
    x = torch.rand(OTHER_TRAIN_BATCH, size, size, 3, generator=gen,
                   device="cuda")
    y = F.one_hot(torch.randint(0, classes, (OTHER_TRAIN_BATCH,),
                                generator=gen, device="cuda"),
                  classes).float()
    state = create_train_state(module, make_optimizer("adam",
                                                      BACKBONE_LR))
    step = make_train_step([lambda t, p: -(t * torch.log(
        p.float().clamp(min=1e-12))).sum(-1).mean()])
    reset_family_counters()
    step_ms, losses = timed_steps(state, step, x, (y,), 1)
    cnt = family_counters()
    check(all(np.isfinite(losses)), f"{fn_name}: non-finite loss")
    check(cnt["conv_bn_stats"] == convs
          and cnt["conv_bn_stats_tc"] == routes_tc,
          f"{fn_name}: {cnt['conv_bn_stats']} conv launches "
          f"({cnt['conv_bn_stats_tc']} on the tensor cores), want {convs} "
          f"({routes_tc})")
    del state, step, model, module
    torch.cuda.empty_cache()
    res = dict(size=size, classes=classes, convs=convs, convs_tc=routes_tc,
               launches=cnt, losses=losses, ms_per_step=step_ms,
               seconds=time.perf_counter() - t0)
    print(f"  {fn_name} {size}^2, {classes} classes: {convs} convs "
          f"({routes_tc} on the tensor cores); one bf16 step of "
          f"{OTHER_TRAIN_BATCH}: loss {losses[0]:.4f}, conv launches "
          f"{cnt['conv_bn_stats']} (tensor cores "
          f"{cnt['conv_bn_stats_tc']}), by geometry {cnt['by_geometry']} "
          f"[{res['seconds']:.1f} s]")
    return res


def phase_depthwise(gen, n):
    """The depthwise library call on the port's path
    (``layers.depthwise_conv``, ``F.conv2d(groups=C)``) at
    ``DEPTHWISE_SHAPE`` in bf16 at batch ``n``: its ms and its bound,
    and its output against the same call in f32 (bf16's bound)."""
    name, h, w, c, stride = DEPTHWISE_SHAPE
    x = torch.randn(n, h, w, c, generator=gen, device="cuda")
    k = torch.empty(3, 3, 1, c, device="cuda")
    glorot_uniform_(k, gen)
    xb, kb = x.to(torch.bfloat16), k.to(torch.bfloat16)
    y = layers_mod.depthwise_conv(xb, kb, stride)
    yf = layers_mod.depthwise_conv(xb.float(), kb.float(), stride)
    tol = TOL[torch.bfloat16]
    err = (y.float() - yf).abs()
    check(bool((err <= tol["y_rel"] * yf.abs() + tol["y_scale"]
                * max(1.0, yf.abs().max().item())).all()),
          "depthwise conv outside bf16's bound")
    ms = cuda_ms(lambda: layers_mod.depthwise_conv(xb, kb, stride), 5)
    nbytes = (xb.numel() + kb.numel() + y.numel()) * 2
    bound, bound_by = bound_ms(nbytes, 2.0 * y.numel() * 9, torch.bfloat16)
    print(f"  depthwise (library, F.conv2d groups=C) bf16 b{n} {name}: "
          f"{ms:.3f} ms, bound {bound:.4f} ms ({bound_by}, {bound / ms:.1%} "
          f"of it); max|d| against f32 {err.max().item():.3e}")
    return dict(shape=name, batch=n, ms=ms, bound_ms=bound,
                bound_by=bound_by, bound_share=bound / ms,
                max_abs_err=err.max().item())


def phase_backbones(args, card):
    """Phase 15: each run of BACKBONE_RUNS and CLASSIFIER_RUNS in bf16."""
    t0 = time.perf_counter()
    out = {}
    for name, mod, size, kw, runs, probe in BACKBONE_RUNS:
        out[name] = family_run(args, name, mod, size, kw, runs == "main",
                               card, train=runs != "serve",
                               deploy=runs == "main", lr=BACKBONE_LR,
                               probe=probe)
    for fn_name, size, kw in CLASSIFIER_RUNS:
        out[fn_name] = classifier_run(args, fn_name, size, kw)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 15 took {out['seconds']:.1f} s")
    return out


def backbone_launches(backbones, key):
    """Launches in phase 15's requests and steps of the geometry keys
    (``conv_bn.geometry_key``) equal to ``key`` or to ``key`` and a
    route."""
    total = 0
    for res in backbones.values():
        if not isinstance(res, dict):
            continue
        for run in ("serve_launches", "train_launches", "launches"):
            total += sum(v for k, v in res.get(run, {}).get(
                "by_geometry", {}).items()
                if k == key or k.rsplit(" ", 1)[0] == key)
    return total


# ---------------------------------------------------------------- phase 16
# YOLOv1.5 served int8 (448^2, the slice's main path): its 23 ConvBNs by
# gate (all at 0; those of min(Ci, Co) >= 256 at 256), and Q's launches a
# request at YOLOv1.5's two SAME geometries by gate (the stem only at 0)
V1_SIZE = 448
V1_INT8_REPS = 3                 # timed requests a turn, two turns each
V1_GEOMETRIES = {0: {"7x7s2 same gather": 1, "3x3s2 same ring": 1},
                 256: {"7x7s2 same gather": 0, "3x3s2 same ring": 1}}
# the convert round trip: (name, facade, input size, create_model
# keyword arguments, converter)
CONVERT_RUNS = [
    ("yolov4", yolov4, 416, dict(anchors=ANCHORS.tolist(),
                                 pretrained_body=None),
     lambda h5w, state: convert_mod.convert_yolov4(h5w, CLASSES)),
    ("yolov3", yolov3, 416, dict(pretrained_body=None),
     lambda h5w, state: convert_mod.convert_yolov3(h5w, CLASSES)),
    ("yolov1.5", yolov1_5, 448, {},
     lambda h5w, state: convert_mod.convert_yolov1_positional(
         h5w, state, CLASSES, 2)),
]


def reset_int8_counters():
    reset_serve_counters()
    conv_int8.by_geometry.clear()


def int8_counted(serve, x):
    """``serve(x)`` with every counter set to 0 just before and read just
    after; Q's launches by geometry beside."""
    torch.cuda.synchronize()
    reset_int8_counters()
    out = serve(x)
    torch.cuda.synchronize()
    return out, dict(serve_counters(),
                     by_geometry=dict(conv_int8.by_geometry))


def v1_head_logits(model, x):
    """The v1 head conv's output (f32) of one eval forward."""
    logits = []
    handle = model.head.conv.register_forward_hook(
        lambda m, inp, out: logits.append(out[0].float()))
    try:
        with torch.inference_mode():
            model(x)
    finally:
        handle.remove()
    return logits[0]


def phase_v1_int8(args, card):
    """Phase 16b: YOLOv1.5 at 448^2 through its facade, bf16, random
    weights from the seed, BN calibrated as phase 4's; ``calibrate_int8``
    on two seeded batches, then ``make_serving_fn(quant=)`` at gates 0
    and 256: every calibrated ConvBN of min(Ci, Co) >= gate on Q, the
    rest and the head on K1, one NMS; Q's launches at the two SAME
    geometries counted (the stem at gate 0, the 14^2 stride 2 at both);
    the kernel route against the plain route by phase 11's rule (gate 0:
    the head logits, every int8 layer being exact on both routes; gate
    256: layer by layer); ms/request of int8 at both gates and of bf16."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 16)
    yolo, model = family_model(yolov1_5, V1_SIZE, {}, torch.bfloat16,
                               args.seed)
    model.eval()
    convbns = [m for m in model.modules()
               if isinstance(m, ConvBN) and m.bn is not None]
    convs = conv_count(model)
    check(len(convbns) == 23 and convs == 24,
          f"YOLOv1.5: {len(convbns)} ConvBNs, {convs} convs; want 23, 24")
    calibrate_bn(model, torch.rand(args.batch, V1_SIZE, V1_SIZE, 3,
                                   generator=gen, device="cuda"))
    x = torch.rand(args.batch, V1_SIZE, V1_SIZE, 3, generator=gen,
                   device="cuda")
    with torch.inference_mode():
        joint = family_joint(model(x), 1).float()
    threshold = float(torch.quantile(
        joint[0], max(0.0, 1 - 16 / joint.shape[1])))
    calib = [torch.rand(args.batch, V1_SIZE, V1_SIZE, 3, generator=gen,
                        device="cuda") for _ in range(2)]
    quant = calibrate_int8(model, calib)
    scales = list(_tree_leaves(quant["quant"]))
    check(len(scales) == 23 and all(float(v) > 0 for v in scales),
          "YOLOv1.5 calibration: want 23 positive scales")
    plain = use_plain_route(copy.deepcopy(model))
    tol = TOL[torch.bfloat16]
    out, serves = dict(threshold=threshold), {
        "bf16": make_serving_fn(model, CLASSES, 1, threshold=threshold)}
    (rows_b, keep_b), cnt_b = int8_counted(serves["bf16"], x)
    check(cnt_b["conv_bn_stats"] == convs and cnt_b["conv_int8"] == 0
          and cnt_b["conv_bn_stats_tc"] == conv_routes(model)["tc"]
          and cnt_b["nms_keep"] == 1, f"YOLOv1.5 bf16 request: {cnt_b}")
    launches = dict(conv_int8=0, conv_int8_tc=0, conv_int8_quant=0)
    geometry = collections.Counter()
    for gate in (0, 256):
        n_q = sum(min(m.conv.kernel.shape[2:]) >= gate for m in convbns)
        serve = make_serving_fn(model, CLASSES, 1, threshold=threshold,
                                quant=quant, int8_min_channels=gate)
        check(sum(isinstance(m, Int8ConvBN) for m in serve.program.modules())
              == n_q, f"YOLOv1.5 gate {gate}: want {n_q} int8 ConvBNs")
        (rows_q, keep_q), cnt = int8_counted(serve, x)
        # the K1 convs left (the head's 13 channels take the CUDA cores)
        # by their plans' routes; Q's launches at the SAME geometries
        want = dict(conv_bn_stats=convs - n_q,
                    conv_bn_stats_tc=conv_routes(serve.program)["tc"],
                    conv_int8=n_q, conv_int8_tc=n_q, conv_int8_quant=n_q,
                    nms_keep=1, soft_nms_keep=0, fused=0)
        same = {k: cnt["by_geometry"].get(k, 0)
                for k in V1_GEOMETRIES[gate]}
        check({k: cnt[k] for k in want} == want
              and same == V1_GEOMETRIES[gate],
              f"YOLOv1.5 int8 gate {gate}: launches {cnt}, want {want} and "
              f"{V1_GEOMETRIES[gate]}")
        for k in launches:
            launches[k] += cnt[k]
        geometry.update(cnt["by_geometry"])
        check(bool(torch.isfinite(rows_q).all()) and int(keep_q.sum()) > 0,
              f"YOLOv1.5 int8 gate {gate}: degenerate rows")
        sp = make_serving_fn(plain, CLASSES, 1, threshold=threshold,
                             quant=quant, int8_min_channels=gate)
        res = dict(int8_convbns=n_q, launches=cnt,
                   kept=int(keep_q.sum()), kept_bf16=int(keep_b.sum()))
        if gate == 0:
            lq = v1_head_logits(serve.program.model, x)
            lp = v1_head_logits(sp.program.model, x)
            torch.cuda.synchronize()
            scale = max(1.0, lp.abs().max().item())
            d = (lq - lp).abs()
            ok = bool((d <= tol["y_rel"] * lp.abs()
                       + tol["y_scale"] * scale).all())
            res.update(logit_max_abs_err=d.max().item(), logit_scale=scale)
            print(f"  YOLOv1.5 int8 gate 0: {n_q} ConvBNs on Q; launches "
                  f"{cnt}; kernel vs plain route head logits max|d| "
                  f"{d.max().item():.3e} (scale {scale:.3g}; bound "
                  f"{tol['y_rel']:.3g}*|l| + {tol['y_scale']:.0e}*scale)")
            check(ok, "YOLOv1.5 int8 gate 0: the routes' head logits differ")
        else:
            lr = layer_routes(serve.program.model, x)
            res.update(layer_routes=lr)
            print(f"  YOLOv1.5 int8 gate 256: {n_q} ConvBNs on Q; launches "
                  f"{cnt}; kernel vs plain route layer by layer: "
                  f"{lr['int8_equal']}/{lr['int8_layers']} Int8ConvBN equal "
                  f"bit for bit, {lr['k1_within']}/{lr['k1_layers']} K1 "
                  f"convs within the bf16 bound (max|d| "
                  f"{lr['k1_max_abs_err']:.3e})")
            check(lr["int8_layers"] == n_q == lr["int8_equal"]
                  and lr["k1_layers"] == convs - n_q == lr["k1_within"],
                  "YOLOv1.5 int8 gate 256: a layer's routes differ")
        out[f"gate{gate}"] = res
        serves[f"int8 gate {gate}"] = serve
    del plain
    times = {}
    for name in list(serves) + list(serves)[::-1]:
        serves[name](x)
        for _ in range(V1_INT8_REPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            serves[name](x)
            torch.cuda.synchronize()
            times.setdefault(name, []).append(
                (time.perf_counter() - t1) * 1e3)
    out["ms_per_request"] = {k: float(np.median(v)) for k, v in times.items()}
    out["runs"] = times
    for name, ms in out["ms_per_request"].items():
        print(f"  YOLOv1.5 {name:12s} b{args.batch} {V1_SIZE}^2: {ms:.2f} "
              f"ms/request (median of {len(times[name])}) [{card}]")
    out.update(launches, by_geometry=dict(geometry), convs=convs,
               convs_tc=conv_routes(model)["tc"],
               seconds=time.perf_counter() - t0)
    del serves, model
    torch.cuda.empty_cache()
    return out


def phase_convert(args):
    """Phase 16c: the reference-weight round trip in memory on the card,
    no h5py: ``convert.export_reference_weights`` of a model on the card
    (random weights from the seed, BN calibrated), the matching
    ``convert_*`` from that dict, merged into a fresh model of another
    seed on the card: the state_dicts equal bit for bit, and so are one
    served request's (rows, keep) of the two."""
    out = {}
    for i, (name, mod, size, kw, converter) in enumerate(CONVERT_RUNS):
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 160 + i)
        yolo, src = family_model(mod, size, kw, torch.bfloat16, args.seed)
        _, dst = family_model(mod, size, kw, torch.bfloat16, args.seed + 1)
        calibrate_bn(src.eval(), torch.rand(2, size, size, 3, generator=gen,
                                            device="cuda"))
        kw_export = {"bbox_num": 2} if yolo.version == 1 else {}
        h5w = convert_mod.export_reference_weights(
            src, yolo.version, CLASSES, **kw_export)
        before = sum(not torch.equal(a, b) for a, b in zip(
            src.state_dict().values(), dst.state_dict().values()))
        state = convert_mod.merge_into_variables(
            dst.state_dict(), *converter(h5w, dst.state_dict()))
        dst.load_state_dict(state, strict=True)
        src_state, dst_state = src.state_dict(), dst.state_dict()
        differ = [k for k in src_state
                  if not torch.equal(src_state[k], dst_state[k])]
        x = torch.rand(args.batch, size, size, 3, generator=gen,
                       device="cuda")
        with torch.inference_mode():
            joint = family_joint(src.eval()(x), yolo.version).float()
        threshold = float(torch.quantile(
            joint[0], max(0.0, 1 - 16 / joint.shape[1])))
        rows_s, keep_s = make_serving_fn(src, CLASSES, yolo.version,
                                         threshold=threshold)(x)
        rows_d, keep_d = make_serving_fn(dst.eval(), CLASSES, yolo.version,
                                         threshold=threshold)(x)
        torch.cuda.synchronize()
        equal = torch.equal(rows_s, rows_d) and torch.equal(keep_s, keep_d)
        out[name] = dict(layers=len(h5w), tensors=len(src_state),
                         differing_before=before, differing_after=len(differ),
                         served_equal=equal, kept=int(keep_s.sum()),
                         seconds=time.perf_counter() - t0)
        print(f"  convert {name}: {len(h5w)} reference layers from the card "
              f"-> {len(src_state)} tensors ({before} differed before, "
              f"{len(differ)} after); one request of {args.batch} x "
              f"{size}^2 equal bit for bit {equal} (kept "
              f"{int(keep_s.sum())}) [{out[name]['seconds']:.1f} s]")
        check(before > 0 and not differ and equal and int(keep_s.sum()) > 0,
              f"convert {name}: round trip differs: {differ[:5]}")
        del src, dst, state, src_state, dst_state
        torch.cuda.empty_cache()
    return out


def phase_v1_same(args, card):
    """Phase 16: kernel Q at YOLOv1.5's SAME geometries (a), YOLOv1.5
    served int8 (b), the convert round trip (c). The native reader's
    phase is left out: the card's machine has neither ``jpeglib.h`` nor
    ``png.h`` nor libjpeg and libpng to build ``native/loader.cpp``
    against (README.md)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 16)
    q_same = []
    for n in (args.batch, DEPLOY_BIG_BATCH):
        q_same += phase_int8_checks(gen, n, INT8_SAME_SHAPES)
    out = dict(q_same=q_same, v1_int8=phase_v1_int8(args, card),
               convert=phase_convert(args))
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 16 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 17

PAR_BATCH = 32                 # (a), (b): phase 7's training batch
PIPE_BATCH, PIPE_MICRO = 16, 8  # (c)
CHILD_TIMEOUT_S = 180          # for both children of (b) together
PROBE_EPS = 1e-6


def v4_losses(size):
    """The three v4 level losses of ``make_training``, coarse first."""
    return [wrap_yolo_loss_v4(((size // 32) * 2 ** lvl,) * 2, 3, CLASSES,
                              ANCHORS[3 * lvl:3 * lvl + 3])
            for lvl in range(3)]


def grads_of(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def buffers_of(model):
    return {n: b.detach().clone() for n, b in model.named_buffers()}


def probe_rule(got, ref, probe, floor=1e-3, scales=None):
    """Phase 8's rule, leaf by leaf: rel L2 to the reference within
    min(0.3, max(5 x the probe's (the reference on the input moved by
    1e-6), ``floor``)); ``scales`` as in :func:`precision_rule`. Returns
    (worst leaf, its rel L2, its probe, the leaves that fail)."""
    rel = {k: leaf_distance(got, ref, k, scales) for k in ref}
    noise = {k: leaf_distance(probe, ref, k, scales) for k in ref}
    failed = [k for k in ref if rel[k] > min(0.3, max(5 * noise[k], floor))]
    worst = max(rel, key=rel.get)
    return worst, rel[worst], noise[worst], failed


def precision_rule(got, ref, truth, floor=1e-3, cap=None, scales=None):
    """Phase 18(a)'s rule for the bf16 gradients, leaf by leaf: ``got``
    bit for bit ``ref`` (the unsliced bf16 step) or, in rel L2 to
    ``truth`` (the unsliced f32 step on the same weights and batch),
    within max(4 x ``ref``'s, ``floor``): tensor parallelism may round
    differently, not worse. With ``cap`` (phase 19), never more than
    ``cap``. ``scales`` (:func:`zero_grad_leaves`) measures a leaf's
    distance over the scale given there instead of over its own norm.
    Returns (the leaves bit for bit, the worst leaf by got's distance
    over its limit, that distance, ref's, the leaves that fail, the
    leaves whose limit is the cap)."""
    equal, ratio, dist, capped = 0, {}, {}, []
    for k in ref:
        if torch.equal(got[k], ref[k]):
            equal += 1
            continue
        dist[k] = (leaf_distance(got, truth, k, scales),
                   leaf_distance(ref, truth, k, scales))
        limit = max(4 * dist[k][1], floor)
        if cap is not None and limit > cap:
            limit = cap
            capped.append(k)
        ratio[k] = dist[k][0] / limit
    if not ratio:
        return equal, None, 0.0, 0.0, [], []
    worst = max(ratio, key=ratio.get)
    return (equal, worst, *dist[worst],
            [k for k, r in ratio.items() if r > 1], capped)


def rule_line(res, n=1, train=False):
    """One line of :func:`precision_rule`'s result over ``n`` leaves;
    with ``train`` (:func:`train_failures`) the leaves at the cap that
    lie outside are named apart."""
    equal, worst, d, d_ref, failed, capped = res
    line = f"bit for bit {equal}/{n}"
    if worst is not None:
        line += (f", the rest in rel L2 to the f32 result within min("
                 f"{RULE_CAP}, max(4 x the whole bf16 result's, 1e-3)): "
                 f"worst {d:.2e} at {worst} (whole {d_ref:.2e}), "
                 f"{len(capped)} at the cap")
        if train:
            held = train_failures(res)
            line += (f" ({len(failed) - len(held)} of them outside: beyond "
                     f"the bf16 reference's reach), {len(held)} outside "
                     "below it")
            failed = held
        else:
            line += f", {len(failed)} outside"
        if failed:
            line += f": {failed[:3]}"
    return line


def train_failures(res):
    """The leaves of a train-mode bf16 step that fail
    :func:`precision_rule`, but those at the cap: the random nets' bf16
    steps are chaotic (the whole bf16 step's gradients lie 0.8-1.4 in
    median rel L2 from the f32 step's, and their gradients through the
    eval forward still 0.3-0.4), and a leaf whose whole bf16 result is
    that far cannot tell a wrong result from rounding. Every leaf is
    held by the f32 steps (phase 8's probe rule, capped)."""
    capped = set(res[5])
    return [k for k in res[4] if k not in capped]


def to_whole(got, ref):
    """The median and largest rel L2 of ``got``'s leaves to ``ref``'s
    (the whole bf16 step's), printed beside the rule: how far slicing or
    partitioning moves a bf16 step by itself."""
    rel = sorted(rel_l2(got[k], ref[k]) for k in ref)
    return (f"rel L2 to the whole bf16 step's median "
            f"{rel[len(rel) // 2]:.2e}, largest {rel[-1]:.2e}")


def zero_grad_leaves(truth):
    """{bias leaf: the gradient norm of its layer's kernel or scale} for
    each bias of ``truth`` (an f32 step's gradients) whose exact gradient
    is 0 (a BatchNorm after it, or after the linear layer it feeds, takes
    a constant out): its norm there is rounding, at most 1e-5 of that
    other norm, as the CPU tests tell such a leaf. A rel L2 to such a
    leaf measures only rounding, so the rules measure its distance over
    that other norm."""
    out = {}
    for k, t in truth.items():
        base = k[:-len("bias")]
        other = truth.get(base + "kernel", truth.get(base + "scale"))
        if not k.endswith("bias") or other is None:
            continue
        norm = other.float().norm().item()
        if t.float().norm().item() <= 1e-5 * norm:
            out[k] = norm
    return out


def leaf_distance(got, want, k, scales=None):
    """rel L2 of ``got[k]`` to ``want[k]``, or, for a leaf of ``scales``,
    the norm of their difference over the scale given there."""
    if scales and k in scales:
        return ((got[k].float() - want[k].float()).norm().item()
                / max(scales[k], 1e-30))
    return rel_l2(got[k], want[k])


def stats_deltas(after, before):
    """What one step added to each running statistic (momentum 0.99:
    0.01 x the batch statistic)."""
    return {k: after[k] - before[k] for k in after}


def parallel_world1(args, card):
    """(a) A process group of one process (nccl through a HashStore, no
    socket) and ``set_bn_group``: phase 7's bf16 step at batch 32, held to
    the same step without a group: the loss and the running statistics
    bit for bit, each gradient leaf bit for bit or, in rel L2, within
    max(4 times the distance of two ungrouped runs, 1e-3): dW of the
    fused kernels adds with f32 atomics, whose order changes from run to
    run, and the all-reduce's autograd node changes the order in which
    autograd adds a tensor's incoming gradients; the chaotic backward
    grows those last bits to 1.2e-4 in some leaves (measured; 283 of 330
    leaves were bit for bit)."""
    runs = {}
    for name in ("ungrouped", "ungrouped again", "grouped"):
        grouped = name == "grouped"
        if grouped:
            distributed_initialize(device="cuda:0", backend="nccl",
                                   timeout_s=60)
        try:
            group = default_group() if grouped else None
            state, step, x, ys = make_training(
                args.seed, PAR_BATCH, args.size, torch.bfloat16, packed=3,
                group=group)
            reset_train_counters()
            _, logs = step(state, x, ys)
            torch.cuda.synchronize()
            counts = train_counters()
            runs[name] = dict(loss=float(logs["loss"]),
                              grads=grads_of(state.model),
                              stats=buffers_of(state.model), counts=counts)
            runs[name]["ms"] = timed_steps(state, step, x, ys, 3)[0]
        finally:
            if grouped:
                distributed_shutdown()
        del state, step, x, ys
    base, again, grp = (runs[k] for k in ("ungrouped", "ungrouped again",
                                          "grouped"))
    equal, spread_ok = 0, []
    for k, g in grp["grads"].items():
        a, a2 = base["grads"][k], again["grads"][k]
        if torch.equal(g, a):
            equal += 1
            continue
        d, spread = rel_l2(g, a), rel_l2(a2, a)
        spread_ok.append((k, d, spread, d <= max(4 * spread, 1e-3)))
    stats_equal = all(torch.equal(grp["stats"][k], v)
                      for k, v in base["stats"].items())
    bad = [s for s in spread_ok if not s[3]]
    ms = {k: float(np.median(r["ms"])) for k, r in runs.items()}
    print(f"  (a) nccl group of 1 (HashStore), bf16 b{PAR_BATCH}: loss "
          f"{grp['loss']:.6f} grouped / {base['loss']:.6f} / "
          f"{again['loss']:.6f} ungrouped twice (bit for bit: "
          f"{grp['loss'] == base['loss']}); running statistics "
          f"bit for bit: {stats_equal}; gradient leaves bit for bit "
          f"{equal}/{len(base['grads'])}, the rest within max(4 x the "
          f"rel L2 of two ungrouped runs, 1e-3): {len(spread_ok) - len(bad)}"
          f"/{len(spread_ok)} (largest {max((d for _, d, _, _ in spread_ok), default=0.0):.2e}); "
          f"launches {grp['counts']}")
    print(f"  (a) ms/step {ms['grouped']:.2f} grouped, {ms['ungrouped']:.2f} "
          f"ungrouped [{card}]")
    check(grp["loss"] == base["loss"], "(a) the grouped loss differs")
    check(stats_equal, "(a) the grouped running statistics differ")
    check(not bad, f"(a) grouped gradients outside the spread: {bad[:3]}")
    check(all(grp["counts"][k] == v for k, v in TRAIN_LAUNCHES[3].items()),
          f"(a) launches {grp['counts']}, want {TRAIN_LAUNCHES[3]}")
    return dict(loss=grp["loss"], loss_ungrouped=base["loss"],
                grads_bit_equal=equal, grads_in_spread=len(spread_ok),
                stats_bit_equal=stats_equal, launches=grp["counts"],
                ms_per_step=ms)


def one_process_step(seed, size, eps=0.0):
    """The f32 step of ``make_training`` on all PAR_BATCH rows (images
    moved by ``eps``): loss, gradients, running statistics before and
    after."""
    state, step, x, ys = make_training(seed, PAR_BATCH, size, torch.float32,
                                       packed=3)
    before = buffers_of(state.model)
    _, logs = step(state, x + eps, ys)
    out = dict(loss=float(logs["loss"]), grads=grads_of(state.model),
               deltas=stats_deltas(buffers_of(state.model), before))
    del state, step, x, ys
    return out


def dp_child(rank, store, out_dir, seed, size):
    """One of (b)'s two processes: gloo over CUDA tensors through the
    FileStore ``store``, the f32 ``packed=3`` step of ``make_training``
    on this process's 16 of its 32 rows; writes ``dp_<rank>.pt``."""
    distributed_initialize(num_processes=2, process_id=rank, backend="gloo",
                           device="cuda:0", store=store, timeout_s=60)
    try:
        state, step, x, ys = make_training(seed, PAR_BATCH, size,
                                           torch.float32, packed=3,
                                           group=default_group())
        sl = process_batch_slice(PAR_BATCH)
        xs, yss = x[sl].contiguous(), tuple(y[sl] for y in ys)
        before = buffers_of(state.model)
        reset_train_counters()
        _, logs = step(state, xs, yss)
        torch.cuda.synchronize()
        out = dict(loss=float(logs["loss"]), counts=train_counters(),
                   stats=buffers_of(state.model),
                   deltas=stats_deltas(buffers_of(state.model), before))
        grads = grads_of(state.model)
        out["grad_sums"] = {k: g.double().sum().item()
                            for k, g in grads.items()}
        if rank == 0:
            out["grads"] = grads
        out["ms"] = timed_steps(state, step, xs, yss, 2)[0]
        torch.save(out, os.path.join(out_dir, f"dp_{rank}.pt"))
    finally:
        distributed_shutdown()
    return 0


def parallel_two_processes(args, card):
    """(b) Two processes on the one card (``dp_child``), each on 16 of
    the same 32 rows, held to one process on all 32: the loss by phase
    8's bound, the running statistics' step and the gradients by its
    probe rule; both processes' running statistics and gradients equal
    bit for bit; K1, K2 and K3 launched in each process as in one step."""
    seed = args.seed + 17
    ref = one_process_step(seed, args.size)
    probe = one_process_step(seed, args.size, PROBE_EPS)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-child",
             str(rank), os.path.join(tmp, "store"), tmp, "--seed",
             str(args.seed), "--size", str(args.size)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in (0, 1)]
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        try:
            for rank, p in enumerate(procs):
                try:
                    log, _ = p.communicate(
                        timeout=max(deadline - time.monotonic(), 1))
                except subprocess.TimeoutExpired:
                    raise RuntimeError(f"(b) process {rank} did not end in "
                                       f"{CHILD_TIMEOUT_S} s")
                check(p.returncode == 0, f"(b) process {rank} exited "
                      f"{p.returncode}:\n{log[-3000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        r0, r1 = (torch.load(os.path.join(tmp, f"dp_{rank}.pt"),
                             map_location="cuda", weights_only=False)
                  for rank in (0, 1))
    loss_rel = abs(r0["loss"] - ref["loss"]) / abs(ref["loss"])
    loss_noise = abs(probe["loss"] - ref["loss"]) / abs(ref["loss"])
    g = probe_rule(r0["grads"], ref["grads"], probe["grads"])
    s = probe_rule(r0["deltas"], ref["deltas"], probe["deltas"], floor=1e-4)
    same_stats = all(torch.equal(v, r1["stats"][k])
                     for k, v in r0["stats"].items())
    same_grads = r0["grad_sums"] == r1["grad_sums"]
    ms = [float(np.median(r["ms"])) for r in (r0, r1)]
    print(f"  (b) 2 processes, gloo, FileStore, f32 b16 each against 1 "
          f"process b{PAR_BATCH}: loss {r0['loss']:.6f} / {ref['loss']:.6f} "
          f"(rel {loss_rel:.2e}; probe {loss_noise:.2e}; bound 1e-5 + 4 x "
          f"probe); gradients worst {g[1]:.2e} at {g[0]} (probe {g[2]:.2e}), "
          f"{len(g[3])} outside min(0.3, max(5 x probe, 1e-3)); running "
          f"statistics' step worst {s[1]:.2e} at {s[0]} (probe {s[2]:.2e}), "
          f"{len(s[3])} outside; the processes' statistics equal {same_stats}, "
          f"gradients equal {same_grads}")
    print(f"  (b) launches in each process's step: {r0['counts']} / "
          f"{r1['counts']}; ms/step {ms[0]:.2f} / {ms[1]:.2f} (two processes "
          f"sharing the card) [{card}]")
    check(loss_rel <= 1e-5 + 4 * loss_noise, "(b) the losses differ")
    check(not g[3], f"(b) gradients differ at {g[3][:5]}")
    check(not s[3], f"(b) running statistics differ at {s[3][:5]}")
    check(same_stats and same_grads, "(b) the two processes differ")
    for r in (r0, r1):
        check(all(r["counts"][k] == v for k, v in TRAIN_LAUNCHES[3].items()
                  if not k.endswith("_tc")),
              f"(b) launches {r['counts']}, want {TRAIN_LAUNCHES[3]}")
    launches = {k: r0["counts"][k] + r1["counts"][k] for k in r0["counts"]}
    return dict(loss=r0["loss"], loss_one_process=ref["loss"],
                loss_rel=loss_rel, loss_rel_probe=loss_noise,
                grad_worst=g[:3], stats_worst=s[:3], launches=launches,
                ms_per_step=ms)


def pipeline_launches(counts, n_forward, n_backward):
    """The K1 / K2 / K3 launches of ``n_forward`` train-mode forwards and
    ``n_backward`` backwards of ``packed=3`` (phase 7's per step)."""
    per = TRAIN_LAUNCHES[3]
    want = dict(conv_bn_stats=n_forward * per["conv_bn_stats"],
                fused_gemm_fwd=n_forward * per["fused_gemm_fwd"],
                fused_conv3x3_fwd=n_forward * per["fused_conv3x3_fwd"],
                fused_gemm_bwd=n_backward * per["fused_gemm_bwd"],
                fused_conv3x3_bwd=n_backward * per["fused_conv3x3_bwd"])
    return all(counts[k] == v for k, v in want.items()), want


def parallel_pipeline(args, card):
    """(c) ``split_yolov4(n_stages=3)`` of an f32 ``packed=3`` YOLOv4 on
    ["cuda:0"] x 3, batch 16: ``run`` equal bit for bit to the whole
    model's eval forward (at the batch and at microbatch 8), the
    frozen-statistics ``value_and_grad`` at microbatch 8 against the
    gradient-accumulated single-program step and train mode at
    microbatch 16 against the single train step, both by phase 8's probe
    rule; ``merged_variables`` into a fresh YoloV4 and a save / load in
    a temporary directory, bit for bit."""
    seed = args.seed + 17
    state, _, x, ys = make_training(seed, PIPE_BATCH, args.size,
                                    torch.float32, packed=3)
    model = state.model
    del state
    losses = v4_losses(args.size)

    def loss_fn(out, *y):
        return sum(lf(t, o) for lf, t, o in zip(losses, y, out))

    start = {k: v.clone() for k, v in model.state_dict().items()}
    halves = [slice(0, PIPE_MICRO), slice(PIPE_MICRO, PIPE_BATCH)]

    def single(train, eps=0.0):
        """The single program from ``start``: gradients (and the
        statistics' step), then ``start`` again."""
        model.load_state_dict(start)
        model.zero_grad(set_to_none=True)
        model.train(train)
        for sl in ([slice(None)] if train else halves):
            n = 1 if train else len(halves)
            (loss_fn(model(x[sl] + eps), *(y[sl] for y in ys)) / n
             ).backward()
        out = dict(grads=grads_of(model),
                   deltas=stats_deltas(buffers_of(model), start_buffers))
        model.load_state_dict(start)
        return out

    start_buffers = buffers_of(model)
    model.eval()
    with torch.no_grad():
        whole = model(x)
        whole_mb = [torch.cat(o) for o in zip(*(model(x[sl])
                                                for sl in halves))]
    refs = {mode: (single(mode == "train"),
                   single(mode == "train", PROBE_EPS))
            for mode in ("frozen", "train")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single(True)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3

    stages, params, train_stages = split_yolov4(model, 3, with_train=True)
    pipe = PipelineExecutor(stages, params, devices=["cuda:0"] * 3,
                            train_stages=train_stages)
    reset_train_counters()
    run_equal = (all(torch.equal(a, b) for a, b in zip(pipe.run(x), whole))
                 and all(torch.equal(a, b) for a, b in
                         zip(pipe.run(x, PIPE_MICRO), whole_mb)))
    run_convs = conv_bn_stats.launches
    out = {}
    for mode, micro in (("frozen", PIPE_MICRO), ("train", PIPE_BATCH)):
        model.load_state_dict(start)
        reset_train_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = pipe.value_and_grad(loss_fn, train=mode == "train")(
            x, *ys, microbatch=micro)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = train_counters()
        got = {k: t for g in grads for k, t in g.items()}
        ref, probe = refs[mode]
        g = probe_rule(got, ref["grads"], probe["grads"])
        deltas = stats_deltas(buffers_of(model), start_buffers)
        s = (probe_rule(deltas, ref["deltas"], probe["deltas"], floor=1e-4)
             if mode == "train" else None)
        out[mode] = dict(loss=float(loss), grad_worst=g[:3],
                         grads_failed=g[3], launches=counts, ms=ms,
                         stats_worst=s[:3] if s else None,
                         stats_failed=s[3] if s else [],
                         stats_equal=all(torch.equal(deltas[k], v)
                                         for k, v in ref["deltas"].items()))
    # train mode at microbatch 16: two forwards (fill, recompute) and one
    # backward; frozen statistics: eval forwards on the conv kernel only
    train_ok, train_want = pipeline_launches(out["train"]["launches"], 2, 1)
    frozen_convs = out["frozen"]["launches"]["conv_bn_stats"]
    fresh = YoloV4(ANCHORS, CLASSES, dtype=torch.float32,
                   generator=torch.Generator(device="cuda").manual_seed(1))
    fresh.load_state_dict(pipe.merged_variables(), strict=True)
    fresh.eval()
    with torch.no_grad():
        merged_equal = all(torch.equal(a, b) for a, b in
                           zip(fresh(x), pipe.run(x)))
    trained = [{k: v.clone() for k, v in m.state_dict().items()}
               for m in pipe.params]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pp_") as tmp:
        pipe.save(os.path.join(tmp, "pipe.pt"))
        for m in pipe.params:
            for v in m.state_dict().values():
                v.zero_()
        pipe.load(os.path.join(tmp, "pipe.pt"))
    saved_equal = all(torch.equal(v, t[k]) for m, t in zip(pipe.params,
                                                           trained)
                      for k, v in m.state_dict().items())
    print(f"  (c) 3 stages on cuda:0 x 3, f32 b{PIPE_BATCH}: run equal to "
          f"the eval forward bit for bit {run_equal} ({run_convs} conv "
          f"launches: 3 x {CONVS_PER_FORWARD}); merged into a fresh YoloV4 "
          f"{merged_equal}; save / load {saved_equal}")
    for mode in ("frozen", "train"):
        r = out[mode]
        print(f"  (c) {mode} statistics, microbatch "
              f"{PIPE_MICRO if mode == 'frozen' else PIPE_BATCH}: loss "
              f"{r['loss']:.6f}; gradients worst {r['grad_worst'][1]:.2e} at "
              f"{r['grad_worst'][0]} (probe {r['grad_worst'][2]:.2e}), "
              f"{len(r['grads_failed'])} outside; running statistics equal "
              f"to the single step's {r['stats_equal']}; launches "
              f"{r['launches']}; {r['ms']:.1f} ms")
    print(f"  (c) ms/step train mode: pipeline {out['train']['ms']:.1f}, "
          f"single program {single_ms:.1f} [{card}]")
    check(run_equal, "(c) run differs from the eval forward")
    check(run_convs == 3 * CONVS_PER_FORWARD, f"(c) run launched {run_convs}")
    check(merged_equal and saved_equal, "(c) merge or save/load differs")
    for mode in ("frozen", "train"):
        check(not out[mode]["grads_failed"], f"(c) {mode} gradients differ "
              f"at {out[mode]['grads_failed'][:5]}")
    check(not out["train"]["stats_failed"], "(c) train-mode running "
          f"statistics differ at {out['train']['stats_failed'][:5]}")
    check(out["frozen"]["stats_equal"], "(c) frozen mode moved statistics")
    check(frozen_convs == 4 * CONVS_PER_FORWARD,
          f"(c) frozen mode launched {frozen_convs} convs, want "
          f"{4 * CONVS_PER_FORWARD}")
    check(train_ok, f"(c) train launches {out['train']['launches']}, want "
          f"{train_want}")
    launches = {k: out["frozen"]["launches"][k] + out["train"]["launches"][k]
                for k in out["train"]["launches"]}
    launches["conv_bn_stats"] += run_convs
    return dict(run_equal=run_equal, merged_equal=merged_equal,
                saved_equal=saved_equal, launches=launches,
                single_train_ms=single_ms,
                **{mode: {k: v for k, v in r.items()
                          if k not in ("grads_failed", "stats_failed")}
                   for mode, r in out.items()})


def phase_parallel(args, card):
    """Phase 17: (a), (b) and (c); every process group is left and
    every child process ended on every path."""
    t0 = time.perf_counter()
    try:
        world1 = parallel_world1(args, card)
        torch.cuda.empty_cache()
        two = parallel_two_processes(args, card)
        torch.cuda.empty_cache()
        pipe = parallel_pipeline(args, card)
    finally:
        distributed_shutdown()
    seconds = time.perf_counter() - t0
    print(f"  phase 17 took {seconds:.1f} s")
    launches = {k: world1["launches"].get(k, 0) + two["launches"].get(k, 0)
                + pipe["launches"].get(k, 0) for k in world1["launches"]}
    return dict(world1=world1, two_processes=two, pipeline=pipe,
                launches=launches, seconds=seconds)



# ---------------------------------------------------------------- phase 18

TP_BATCH = 16                  # (a): both processes take the same 16 rows
TP_F32_BATCH = 4               # (a)'s f32 step, the gradients' check
TP_EVAL_ROWS = 2               # (b): rows of the eval forwards compared
PP_BATCH, PP_MICRO = 16, 8     # (c)
PP_RANKS = ([0, 1], [2, 3])    # (c): the stage meshes
# K1 at two of the slices that YOLOv4's sharded layers take at n_model 2
# (name, H, W, Ci, Co / 2, k, stride), at (a)'s batch
TP_CONV_SHAPES = [
    ("td1_pre2 13^2 512->512 3x3s1 (1024 / 2)", 13, 13, 512, 512, 3, 1),
    ("stage3.pre 52^2 256->64 1x1 (128 / 2)", 52, 52, 256, 64, 1, 1),
]


def start_children(flag, n, args, tmp):
    """This script ``n`` times with ``flag RANK STORE DIR`` (a FileStore
    in ``tmp``)."""
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(rank),
         os.path.join(tmp, "store"), tmp, "--seed", str(args.seed),
         "--size", str(args.size)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(n)]


def finish_children(procs, flag, tmp, what, started):
    """Wait for :func:`start_children`'s processes, CHILD_TIMEOUT_S from
    ``started`` for all of them, and load what each wrote; every child is
    killed on any failure (also of the caller, who calls this in a
    ``finally``-guarded block)."""
    deadline = started + CHILD_TIMEOUT_S
    try:
        for rank, p in enumerate(procs):
            try:
                log, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"{what} process {rank} did not end in "
                                   f"{CHILD_TIMEOUT_S} s")
            check(p.returncode == 0, f"{what} process {rank} exited "
                  f"{p.returncode}:\n{log[-3000:]}")
    finally:
        kill_children(procs)
    return [torch.load(os.path.join(tmp, f"{flag[2:]}_{rank}.pt"),
                       map_location="cuda", weights_only=False)
            for rank in range(len(procs))]


def kill_children(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def wait_for_file(path, what):
    """Poll for ``path`` (written by the parent), CHILD_TIMEOUT_S at
    most."""
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    while not os.path.exists(path):
        check(time.monotonic() < deadline, f"{what}: no {path}")
        time.sleep(0.05)


class StepCapture:
    """``fit``'s first step: its loss, launches, collectives (the log of
    ``records`` up to the step's end), gradients and running statistics,
    the sliced ones gathered over the model group."""

    def __init__(self, records):
        self.records, self.out = records, None

    def on_train_batch_end(self, batch, logs, m):
        if self.out is not None:
            return
        torch.cuda.synchronize()
        mod = m.module
        self.out = dict(loss=float(logs["loss"]), counts=train_counters(),
                        by_shape=dict(conv_bn_stats.by_shape),
                        records=list(self.records))
        self.out.update(grads=gather_state_dict(mod, grads_of(mod)),
                        stats=gather_state_dict(mod, buffers_of(mod)))


def tp_training(args, n_model, dtype, eps=0.0, batch=TP_BATCH):
    """(a)'s step through the user's path: the YOLOv4 of
    ``make_training`` (``packed=False``, ``dtype``, ``batch``) in
    ``engine.Model``, ``compile("adam", n_model=...)`` and ``fit`` of one
    step on the images moved by ``eps``. Returns (model, x on the card,
    ys, the first step's capture, the sliced layers' K1 shapes: the keys
    of ``conv_bn_stats.by_shape``)."""
    state, _, x, ys = make_training(args.seed + 18, batch, args.size, dtype,
                                    packed=False)
    model = engine.Model(state.model, (args.size, args.size, 3))
    del state
    before = buffers_of(model.module)
    model.compile("adam", loss=v4_losses(args.size), learning_rate=1e-3,
                  n_model=n_model)
    shapes = set()

    def seen(mod, inputs):
        n, h, w, ci = inputs[0].shape
        k, _, _, co = mod.conv.kernel.shape
        shapes.add((n, h, w, ci, co, k, mod.conv.stride, mod.conv.padding))

    hooks = [m.register_forward_pre_hook(seen)
             for m in model.module.modules()
             if isinstance(m, ConvBN) and m.tp is not None]
    reset_train_counters()
    conv_bn_stats.by_shape.clear()
    with recording() as records:
        cap = StepCapture(records)
        model.fit((x + eps).cpu().numpy(), [y.cpu().numpy() for y in ys],
                  epochs=1, batch_size=batch, shuffle=False, verbose=0,
                  callbacks=[cap])
    for h in hooks:
        h.remove()
    cap.out["deltas"] = stats_deltas(cap.out["stats"], before)
    return model, x, ys, cap.out, shapes


def tp_child(rank, store, out_dir, args):
    """One of (a)'s two processes: gloo over CUDA tensors through the
    FileStore ``store``, the ``(data 1, model 2)`` grid of
    ``compile(n_model=2)``. The bf16 step of :func:`tp_training` on the
    same 16 rows as the other process, a timed step after it, then (b):
    the checkpoint (gathered, process 0 writes) and the sliced model's
    eval forward of TP_EVAL_ROWS images; then the f32 step of a fresh
    model. Writes ``tp-child_<rank>.pt``."""
    t0 = time.perf_counter()
    distributed_initialize(num_processes=2, process_id=rank, backend="gloo",
                           device="cuda:0", store=store, timeout_s=60)
    try:
        model, x, ys, out, shapes = tp_training(args, 2, torch.bfloat16)
        times = {"bf16 step": time.perf_counter() - t0}
        mesh = model.mesh
        dims = sharded_dims(model.module)
        out["records"] = [dict(kind=r.kind, dim=r.dim, numel=r.numel,
                               axis="model" if r.group is mesh.model_group
                               else "other") for r in out["records"]]
        out["sharded"] = dims
        out["shapes"] = sorted(shapes)
        local = model.module.state_dict()
        out["local_numel"] = sum(v.numel() for v in local.values())
        moments = model._state.optimizer.state_dict()["state"]
        names = [n for n, _ in model.module.named_parameters()]
        out["replicated"] = {
            k: hashlib.sha1(v.cpu().numpy().tobytes()).hexdigest()
            for k, v in local.items() if k not in dims}
        out["replicated_moments"] = {
            names[i]: {k: hashlib.sha1(v.cpu().numpy().tobytes()).hexdigest()
                       for k, v in st.items()}
            for i, st in moments.items() if names[i] not in dims}
        # the parent computes its references while this step ran; the
        # timed step waits until the card is this pair's alone
        wait_for_file(os.path.join(out_dir, "go"), "(a)")
        times["go"] = time.perf_counter() - t0
        out["ms"] = timed_steps(model._state, model._train_step, x, ys, 1)[0]
        ckpt = save_checkpoint(os.path.join(out_dir, "ckpt"), model._state)
        times["checkpoint"] = time.perf_counter() - t0
        model.module.eval()
        with torch.no_grad():
            heads = model.module(x[:TP_EVAL_ROWS])
        out["ckpt"], out["heads"] = ckpt, [h.float() for h in heads]
        del model, x, ys, local, heads
        torch.cuda.empty_cache()
        f32 = tp_training(args, 2, torch.float32, batch=TP_F32_BATCH)[3]
        out["f32"] = {k: f32[k] for k in ("loss", "grads", "deltas")}
        times["f32 step"] = time.perf_counter() - t0
        out["times"] = times
        if rank != 0:
            for key in ("grads", "deltas", "stats", "heads", "f32"):
                out.pop(key)
        torch.save(out, os.path.join(out_dir, f"tp-child_{rank}.pt"))
    finally:
        distributed_shutdown()
    return 0


def pp_child(rank, store, out_dir, args):
    """One of (c)'s four processes: ``split_yolov4(n_stages=2)`` of the
    f32 ``packed=3`` YOLOv4 of ``make_training`` on the stage meshes
    PP_RANKS (gloo over CUDA tensors, stage transfers through the host):
    ``run`` and the frozen-statistics ``value_and_grad`` at microbatch
    PP_MICRO, each process on its PP_MICRO / 2 rows of a microbatch, with
    their launches and times; writes ``pp-child_<rank>.pt``."""
    # started with (a)'s children: the card is (c)'s after "start"
    wait_for_file(os.path.join(out_dir, "start"), "(c)")
    t0 = time.perf_counter()
    distributed_initialize(num_processes=4, process_id=rank, backend="gloo",
                           device="cuda:0", store=store, timeout_s=60)
    try:
        state, _, x, ys = make_training(args.seed + 18, PP_BATCH, args.size,
                                        torch.float32, packed=3)
        model = state.model
        del state
        meshes = [make_mesh(ranks=r) for r in PP_RANKS]
        stages, params = split_yolov4(model, 2)
        pipe = PipelineExecutor(stages, params, meshes=meshes)
        losses = v4_losses(args.size)

        def loss_fn(out, *y):
            return sum(lf(t, o) for lf, t, o in zip(losses, y, out))

        step = pipe.value_and_grad(loss_fn, train=False)
        reset_train_counters()
        run = pipe.run(x, PP_MICRO)
        torch.cuda.synchronize()
        out = dict(stage=pipe.stage, run_counts=train_counters(),
                   convs=sum(isinstance(m, Conv)
                             for m in params[pipe.stage].modules()))
        times = {"run": time.perf_counter() - t0}
        wait_for_file(os.path.join(out_dir, "go"), "(c)")
        reset_train_counters()
        torch.cuda.synchronize()
        times["go"] = time.perf_counter() - t0
        loss, grads = step(x, *ys, microbatch=PP_MICRO)
        torch.cuda.synchronize()
        times["step"] = time.perf_counter() - t0
        out.update(ms=(times["step"] - times["go"]) * 1e3, loss=float(loss),
                   times=times, counts=train_counters(),
                   grads={k: v.clone() for k, v in grads[pipe.stage].items()})
        if rank != meshes[pipe.stage].ranks[0]:
            out.pop("grads")
        if rank == 0:
            out["run"] = run
        torch.save(out, os.path.join(out_dir, f"pp-child_{rank}.pt"))
    finally:
        distributed_shutdown()
    return 0


def tp_conv_checks(args):
    """K1 at TP_CONV_SHAPES, (a)'s batch, against its plain version, as
    phase 3 checks and times it, on a generator of its own."""
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 18)
    return phase_conv_checks(gen, TP_BATCH, TP_CONV_SHAPES)


def unsliced_reference(args):
    """(a)'s bf16 step without tensor parallelism, then the same model's
    next step timed, before any child process starts."""
    model, x, ys, out, _ = tp_training(args, 1, torch.bfloat16)
    out["ms"] = timed_steps(model._state, model._train_step, x, ys, 1)[0]
    del model, x, ys
    torch.cuda.empty_cache()
    return out


def tensor_parallel_run(args, card, ref):
    """(a) and (b): see the module docstring; ``ref`` is
    :func:`unsliced_reference`'s."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        # the children start (they take seconds to reach the card) while
        # this process computes the other references; they time their
        # step after the "go" file
        procs = start_children("--tp-child", 2, args, tmp)
        started = time.monotonic()
        try:
            refs = {}
            for dtype, name, eps, batch in (
                    (torch.bfloat16, "probe", PROBE_EPS, TP_BATCH),
                    (torch.float32, "truth", 0.0, TP_BATCH),
                    (torch.float32, "ref", 0.0, TP_F32_BATCH),
                    (torch.float32, "probe", PROBE_EPS, TP_F32_BATCH)):
                refs[dtype, name] = tp_training(args, 1, dtype, eps,
                                                batch)[3]
                torch.cuda.empty_cache()
            t_refs = time.perf_counter() - t0
            open(os.path.join(tmp, "go"), "w").close()
            r0, r1 = finish_children(procs, "--tp-child", tmp, "(a)",
                                     started)
        finally:
            kill_children(procs)
        t_children = time.perf_counter() - t0
        probe = refs[torch.bfloat16, "probe"]
        truth = refs[torch.float32, "truth"]
        ref32 = refs[torch.float32, "ref"]
        probe32 = refs[torch.float32, "probe"]
        # (b): the gathered checkpoint into an unsliced model
        state, _, x, _ = make_training(args.seed + 18, TP_BATCH, args.size,
                                       torch.bfloat16, packed=False)
        fresh = YoloV4(ANCHORS, CLASSES, dtype=torch.bfloat16,
                       generator=torch.Generator(device="cuda").manual_seed(1))
        del state
        restore_checkpoint(r0["ckpt"], TrainState(
            fresh, make_optimizer("adam", 1e-3)(fresh)))
    fresh.eval()
    with torch.no_grad():
        heads = [h.float() for h in fresh(x[:TP_EVAL_ROWS])]
        use_plain_route(fresh)
        plain = [h.float() for h in fresh(x[:TP_EVAL_ROWS])]
    bit_equal = all(torch.equal(a, b) for a, b in zip(r0["heads"], heads))
    sharded_rel = max(rel_l2(a, b) for a, b in zip(r0["heads"], heads))
    plain_rel = max(rel_l2(a, b) for a, b in zip(plain, heads))
    del fresh, x
    torch.cuda.empty_cache()

    def loss_rels(got, want, noisy):
        return (abs(got - want) / abs(want), abs(noisy - want) / abs(want))

    loss_rel, loss_noise = loss_rels(r0["loss"], ref["loss"], probe["loss"])
    g = precision_rule(r0["grads"], ref["grads"], truth["grads"])
    st = probe_rule(r0["deltas"], ref["deltas"], probe["deltas"], floor=1e-4)
    f32 = r0["f32"]
    loss32 = loss_rels(f32["loss"], ref32["loss"], probe32["loss"])
    g32 = probe_rule(f32["grads"], ref32["grads"], probe32["grads"])
    st32 = probe_rule(f32["deltas"], ref32["deltas"], probe32["deltas"],
                      floor=1e-4)
    same_leaves = r0["replicated"] == r1["replicated"]
    same_moments = r0["replicated_moments"] == r1["replicated_moments"]
    dims = r0["sharded"]
    units = len({k.rsplit(".", 2)[0] for k in dims})
    gathers = [r for r in r0["records"] if r["kind"] == "all_gather"]
    reduces = [r for r in r0["records"] if r["kind"] == "all_reduce"]
    structure_ok = (all(r["axis"] == "model" for r in r0["records"])
                    and all(r["dim"] == 3 for r in gathers)
                    and len(gathers) == len(reduces) == units)
    moved = sum(r["numel"] for r in r0["records"])
    whole = sum(v.numel() for v in ref["stats"].values()) + sum(
        v.numel() for v in ref["grads"].values())
    print(f"  (a) {len(dims)} leaves of {units} layers sliced at n_model 2 "
          f"(tp_min_channels 128); K1 plans of the sliced shapes at b"
          f"{TP_BATCH}:")
    for key in r0["shapes"]:
        n, h, w, ci, co, k, stride, pad = key
        plan = conv_mod._tc_plan(n, h, w, ci, co, k, stride, torch.bfloat16,
                                 pad)
        print(f"    {h}^2 {ci}->{co} {k}x{k}s{stride} x{r0['by_shape'][key]}"
              f": [{plan_line(plan)}]")
    print(f"  (a) 2 processes, gloo, (data 1, model 2), bf16 b{TP_BATCH} "
          f"against 1 process: loss {r0['loss']:.6f} / {ref['loss']:.6f} "
          f"(rel {loss_rel:.2e}; probe {loss_noise:.2e}); running "
          f"statistics' step worst {st[1]:.2e} at {st[0]} (probe "
          f"{st[2]:.2e}), {len(st[3])} outside; gradients bit for bit "
          f"{g[0]}/{len(ref['grads'])}, the rest in rel L2 to the f32 step "
          f"within max(4 x the unsliced bf16 step's, 1e-3): worst "
          f"{g[2]:.2e} at {g[1]} (unsliced {g[3]:.2e}), {len(g[4])} "
          f"outside; the whole leaves equal on both processes "
          f"{same_leaves}, their Adam moments {same_moments}")
    print(f"  (a) f32 b{TP_F32_BATCH}, the same grid: loss {f32['loss']:.6f} / "
          f"{ref32['loss']:.6f} (rel {loss32[0]:.2e}; probe "
          f"{loss32[1]:.2e}); gradients worst {g32[1]:.2e} at {g32[0]} "
          f"(probe {g32[2]:.2e}), {len(g32[3])} outside; running "
          f"statistics' step worst {st32[1]:.2e} at {st32[0]} (probe "
          f"{st32[2]:.2e}), {len(st32[3])} outside")
    print(f"  (a) bf16 launches in each process's step: K1 "
          f"{r0['counts']['conv_bn_stats']} / {r1['counts']['conv_bn_stats']}"
          f", on the tensor cores {r0['counts']['conv_bn_stats_tc']} / "
          f"{r1['counts']['conv_bn_stats_tc']}; collectives: {len(gathers)} "
          f"channel gathers and {len(reduces)} cotangent all-reduces on the "
          f"model group, {moved / 1e6:.1f} M elements; this process holds "
          f"{r0['local_numel'] / 1e6:.2f} M of the model's "
          f"{whole / 1e6:.2f} M parameters and statistics")
    ms = [float(np.median(r["ms"])) for r in (r0, r1)]
    ref_ms = float(np.median(ref["ms"]))
    print(f"  (a) the references took {t_refs:.1f} s, the children ended "
          f"at {t_children:.1f} s (process 0 from its start: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in r0["times"].items())
          + f"), (b) at {time.perf_counter() - t0:.1f} s")
    print(f"  (a) ms/step bf16 {ms[0]:.2f} / {ms[1]:.2f} (two processes "
          f"sharing the card, gloo through the host) against {ref_ms:.2f} "
          f"unsliced [{card}]")
    print(f"  (b) the gathered checkpoint in an unsliced model: eval heads "
          f"bit for bit {bit_equal} (rel L2 {sharded_rel:.2e}; the plain "
          f"route's {plain_rel:.2e})")
    check(loss_rel <= 1e-5 + 4 * loss_noise, "(a) the bf16 losses differ")
    check(not st[3], f"(a) bf16 running statistics differ at {st[3][:5]}")
    check(not g[4], f"(a) bf16 gradients differ at {g[4][:5]}")
    check(loss32[0] <= 1e-5 + 4 * loss32[1], "(a) the f32 losses differ")
    check(not g32[3], f"(a) f32 gradients differ at {g32[3][:5]}")
    check(not st32[3], f"(a) f32 running statistics differ at {st32[3][:5]}")
    check(same_leaves and same_moments,
          "(a) the whole leaves differ between the processes")
    check(structure_ok, f"(a) collectives {r0['records'][:6]}")
    for r in (r0, r1):
        check(r["counts"]["conv_bn_stats"] == CONVS_PER_FORWARD
              and r["counts"]["conv_bn_stats_tc"] == CONVS_PER_FORWARD,
              f"(a) launches {r['counts']}, want {CONVS_PER_FORWARD} on "
              "the tensor cores")
    check(bit_equal or sharded_rel <= plain_rel,
          "(b) the restored model's heads differ")
    # the wrapper's own count of each shape's launches, in both processes
    by_shape = {s[0]: sum(c for r in (r0, r1)
                          for (n, h, w, ci, co, k, st_, _), c
                          in r["by_shape"].items()
                          if (h, w, ci, co, k, st_) == tuple(s[1:7]))
                for s in TP_CONV_SHAPES}
    return dict(loss=r0["loss"], loss_one_process=ref["loss"],
                loss_rel=loss_rel, loss_rel_probe=loss_noise,
                grads_bit_equal=g[0], grad_worst=g[1:4],
                grads_outside=len(g[4]),
                stats_worst=st[:3], f32_loss_rel=loss32,
                f32_grad_worst=g32[:3], f32_stats_worst=st32[:3],
                replicated_equal=same_leaves, moments_equal=same_moments,
                sliced_leaves=len(dims), sliced_layers=units,
                gathers=len(gathers), reduces=len(reduces),
                collective_elements=moved,
                local_numel=r0["local_numel"], whole_numel=whole,
                launches=r0["counts"]["conv_bn_stats"]
                + r1["counts"]["conv_bn_stats"],
                launches_by_shape=by_shape,
                ms_per_step=ms, unsliced_ms_per_step=ref_ms,
                checkpoint_bit_equal=bit_equal,
                checkpoint_rel=sharded_rel, plain_rel=plain_rel)


def pp_dp_run(args, card, procs, tmp, started):
    """(c): see the module docstring. ``procs`` were started at the
    phase's start in ``tmp`` (their imports overlap (a)); they take the
    card at the "start" file, compute this process's references while
    they set up and run ``run``, and time their step after "go"; this
    process times its own after they end."""
    t0 = time.perf_counter()
    open(os.path.join(tmp, "start"), "w").close()
    state, _, x, ys = make_training(args.seed + 18, PP_BATCH,
                                    args.size, torch.float32,
                                    packed=3)
    model = state.model
    del state
    losses = v4_losses(args.size)

    def loss_fn(out, *y):
        return sum(lf(t, o) for lf, t, o in zip(losses, y, out))

    model.eval()
    rows = PP_MICRO // len(PP_RANKS[0])
    with torch.no_grad():
        # the rows each process runs, one launch a chunk as there
        chunks = [torch.cat(o) for o in zip(*(
            model(x[i:i + rows]) for i in range(0, PP_BATCH, rows)))]
        whole = model(x)
    halves = [slice(0, PP_MICRO), slice(PP_MICRO, PP_BATCH)]

    def single(eps=0.0):
        model.zero_grad(set_to_none=True)
        for sl in halves:
            (loss_fn(model(x[sl] + eps), *(y[sl] for y in ys)) / 2
             ).backward()
        return grads_of(model)

    ref, probe = single(), single(PROBE_EPS)
    t_refs = time.perf_counter() - t0
    open(os.path.join(tmp, "go"), "w").close()
    res = finish_children(procs, "--pp-child", tmp, "(c)", started)
    t_children = time.perf_counter() - t0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    single()
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t1) * 1e3
    model.zero_grad(set_to_none=True)
    del model
    torch.cuda.empty_cache()
    run = res[0]["run"]
    run_equal = all(torch.equal(a, b) for a, b in zip(run, chunks))
    run_whole = max(rel_l2(a, b) for a, b in zip(run, whole))
    got = {k: v for r in res if "grads" in r for k, v in r["grads"].items()}
    g = probe_rule(got, ref, probe)
    counts_ok = all(
        r["run_counts"]["conv_bn_stats"] == 2 * r["convs"]
        and r["counts"]["conv_bn_stats"] == 4 * r["convs"]
        and not any(v for k, v in r["counts"].items()
                    if not k.startswith("conv_bn_stats"))
        for r in res)
    ms = [r["ms"] for r in res]
    print(f"  (c) 2 stages x 2 processes (ranks {PP_RANKS[0]} | "
          f"{PP_RANKS[1]}), f32 b{PP_BATCH}, microbatch {PP_MICRO} ({rows} "
          f"rows a process): run equal to the eval forward of the same "
          f"rows bit for bit {run_equal} (rel L2 {run_whole:.2e} to the "
          f"forward of all {PP_BATCH} rows at once); frozen-statistics loss "
          f"{res[0]['loss']:.6f} on every process "
          f"{len({r['loss'] for r in res}) == 1}; gradients worst {g[1]:.2e} "
          f"at {g[0]} (probe {g[2]:.2e}), {len(g[3])} outside")
    print(f"  (c) launches (run; value_and_grad) by process: "
          + "; ".join(f"stage {r['stage']}: K1 "
                      f"{r['run_counts']['conv_bn_stats']}, "
                      f"{r['counts']['conv_bn_stats']} "
                      f"({r['convs']} convs), K2/K3 "
                      f"{sum(v for k, v in r['counts'].items() if not k.startswith('conv_bn_stats'))}"
                      for r in res))
    print(f"  (c) the references took {t_refs:.1f} s, the children ended "
          f"at {t_children:.1f} s (process 0 from \"start\": "
          + ", ".join(f"{k} {v:.1f} s" for k, v in res[0]["times"].items())
          + ")")
    print(f"  (c) ms/step frozen statistics: {' / '.join(f'{v:.1f}' for v in ms)}"
          f" by process, single program {single_ms:.1f} [{card}]")
    check(run_equal, "(c) run differs from the eval forward")
    check(len({r["loss"] for r in res}) == 1, "(c) the losses differ")
    check(not g[3], f"(c) gradients differ at {g[3][:5]}")
    check(counts_ok, "(c) launches " + str([(r["run_counts"], r["counts"])
                                            for r in res]))
    return dict(run_equal=run_equal, run_rel_whole=run_whole,
                loss=res[0]["loss"], grad_worst=g[:3],
                launches=sum(r["run_counts"]["conv_bn_stats"]
                             + r["counts"]["conv_bn_stats"] for r in res),
                ms_per_step=ms, single_ms=single_ms)


def phase_tensor_parallel(args, card):
    """Phase 18: K1 at the sliced shapes, (a) + (b), (c); every child
    process ended on every path."""
    t0 = time.perf_counter()
    convs = tp_conv_checks(args)
    ref = unsliced_reference(args)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pp_") as tmp:
        # (c)'s four children start now and wait for their "start" file:
        # their imports overlap (a), which they leave the card to
        procs = start_children("--pp-child", 4, args, tmp)
        started = time.monotonic()
        try:
            tp = tensor_parallel_run(args, card, ref)
            torch.cuda.empty_cache()
            pp = pp_dp_run(args, card, procs, tmp, started)
        finally:
            kill_children(procs)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    print(f"  phase 18 took {seconds:.1f} s")
    return dict(conv=convs, tensor_parallel=tp, pp_dp=pp,
                launches=tp["launches"] + pp["launches"], seconds=seconds)


# ---------------------------------------------------------------- phase 19
SPACE_BATCH = 16               # (a): both processes take the same 16 rows
SPACE_F32_BATCH = 4            # (a)'s f32 step, the probe rule
SPACE_EVAL_ROWS = 2            # (a): rows of the gathered eval heads
TP19_BATCH = 8                 # (b)
TP19_F32_BATCH = 2             # (b)'s f32 steps, the probe rule
# the most phase 19's rel L2 rules allow, as phase 8's probe rule
RULE_CAP = 0.3
TP19_FAMILIES = ("v4_resnet50", "v2_mobilenet", "v2_unet")
# K1 at three of the row slabs of (a)'s step (name, H, W, Ci, Co, k,
# stride, explicit geometry), at (a)'s batch: process 1's slab of the
# 208^2 level for a stage-1 3x3 (its 104 rows and the one above, top pad
# 0), process 1's slab of bu2_dn (rows 13..25 of 26: an odd first row,
# the darknet stride 2 without its pad) and process 0's stem slab (rows
# 0..208 of 416, the image's top pad; the small-Ci route)
SLAB_CONV_SHAPES = [
    ("slab 3x3s1 208^2 rows 103..207 32->64 (104 + 1, pad 0)", 105, 208,
     32, 64, 3, 1, conv_mod.Geometry(104, 208, 0, 1)),
    ("slab 3x3s2 darknet 26^2 rows 13..25 256->512", 13, 26, 256, 512, 3,
     2, conv_mod.Geometry(6, 13, 0, 1)),
    ("slab stem 416^2 rows 0..208 3->32 (pad 1)", 209, 416, 3, 32, 3, 1,
     conv_mod.Geometry(208, 416, 1, 1)),
]


def space_run(args, dtype, batch, mesh=None, eps=0.0, eval_rows=0):
    """(a)'s step: the YOLOv4 of ``make_training`` (``packed=False``,
    ``dtype``, ``batch``, Adam 1e-3, the v4 losses), spatially
    partitioned over ``mesh`` (``set_spatial_parallel``, the spatial
    step) or whole, one step on the images moved by ``eps``; first, with
    ``eval_rows``, the eval heads of that many images (gathered). Returns
    (state, step, the step's input, ys, the capture: loss, launches,
    K1 shapes, row messages, gradients, running statistics' step)."""
    state, _, x, ys = make_training(args.seed + 19, batch, args.size, dtype,
                                    packed=False)
    model = state.model
    step = make_train_step(v4_losses(args.size), mesh=mesh)
    cut = (lambda t: t) if mesh is None else spatial_sharding(mesh)
    if mesh is not None:
        set_spatial_parallel(model, mesh, (args.size, args.size))
    out = {}
    if eval_rows:
        model.eval()
        with torch.no_grad():
            out["heads"] = [h.float() for h in model(cut(x[:eval_rows]))]
    xin = cut(x + eps)
    before = buffers_of(model)
    reset_train_counters()
    conv_bn_stats.by_shape.clear()
    with recording() as records:
        _, logs = step(state, xin, ys)
    torch.cuda.synchronize()
    out.update(loss=float(logs["loss"]), counts=train_counters(),
               by_shape=dict(conv_bn_stats.by_shape),
               records=[(r.kind, r.dim, r.numel, r.rows) for r in records],
               grads=grads_of(model),
               deltas=stats_deltas(buffers_of(model), before))
    return state, step, xin, ys, out


def tp19_model(name, dtype, seed, batch=TP19_BATCH):
    """(b)'s network ``name`` (YOLOv4 with ResNet-50, YOLOv2 with
    MobileNetV2 or the UNet; bf16 or f32, 3 classes) from ``seed``, on
    the card, with ``batch`` images and the linear loss's cotangents."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if name == "v4_resnet50":
        model = YoloV4(ANCHORS, CLASSES, dtype=dtype, generator=gen,
                       backbone="resnet50")
    else:
        model = YoloV2(ANCHORS[:5], CLASSES, dtype=dtype, generator=gen,
                       backbone=name[3:])
    x = torch.rand(batch, 416, 416, 3, generator=gen, device="cuda")
    with torch.no_grad():
        shapes = [h.shape for h in as_outputs(model.eval()(x[:1]))]
    cts = [torch.randn(batch, *s[1:], generator=gen, device="cuda")
           for s in shapes]
    return model, x, cts


def tp19_run(name, dtype, seed, mesh=None, batch=TP19_BATCH, eps=0.0):
    """(b): one Adam step of ``name`` on the linear loss, on ``batch``
    images moved by ``eps``, sliced over ``mesh``'s model axis (the
    default gate of 128) or whole. Returns the loss, its scale (the sum
    of its terms' magnitudes: the terms have both signs), the gathered
    gradients, launches, the sliced leaves and the launches of the
    sliced convs (K1 at their slices' Co / 2)."""
    model, x, cts = tp19_model(name, dtype, seed, batch)
    sliced, hooks, calls = {}, [], [0]
    if mesh is not None:
        set_tensor_parallel(model, mesh,
                            tensor_parallel_shardings(model, mesh))
        sliced = sharded_dims(model)

        def count(mod, args):
            calls[0] += 1

        hooks = [m.register_forward_pre_hook(count)
                 for n, m in model.named_modules()
                 if isinstance(m, Conv) and f"{n}.kernel" in sliced]
    state = create_train_state(model, make_optimizer("adam", 1e-3))
    scale = []

    def linear(ct, out):
        scale.append(float((out * ct).abs().sum().detach()) / out.shape[0])
        return (out * ct).sum() / out.shape[0]

    step = make_train_step([linear] * len(cts))
    reset_train_counters()
    _, logs = step(state, x + eps, tuple(cts))
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    grads = grads_of(model)
    if mesh is not None:
        grads = gather_state_dict(model, grads)
    return dict(loss=float(logs["loss"]), scale=sum(scale), grads=grads,
                counts=train_counters(), sliced=len(sliced),
                launches_at_slice=calls[0])


def space_child(rank, store, out_dir, args):
    """One of phase 19's two processes: gloo over CUDA tensors through
    the FileStore ``store``. (a) the ``(data 1, space 2)`` grid: the
    gathered eval heads and the bf16 step of :func:`space_run` on the
    same 16 images as the other process, its image rows by the split,
    then a timed step after the parent's "go" and the f32 step; (b) the
    ``(data 1, model 2)`` grid: :func:`tp19_run` of each family. Writes
    ``space-child_<rank>.pt``."""
    t0 = time.perf_counter()
    distributed_initialize(num_processes=2, process_id=rank, backend="gloo",
                           device="cuda:0", store=store, timeout_s=60)
    try:
        mesh = make_mesh_spatial(1, 2)
        state, step, xin, ys, out = space_run(
            args, torch.bfloat16, SPACE_BATCH, mesh,
            eval_rows=SPACE_EVAL_ROWS)
        out["rows"] = tuple(xin.shape)
        times = {"bf16 step": time.perf_counter() - t0}
        wait_for_file(os.path.join(out_dir, "go"), "19(a)")
        out["ms"] = timed_steps(state, step, xin, ys, 2)[0]
        times["timed"] = time.perf_counter() - t0
        del state, step, xin, ys
        torch.cuda.empty_cache()
        f32 = space_run(args, torch.float32, SPACE_F32_BATCH, mesh)[4]
        out["f32"] = {k: f32[k] for k in ("loss", "grads", "deltas")}
        times["f32 step"] = time.perf_counter() - t0
        del f32
        torch.cuda.empty_cache()
        tmesh = make_mesh(n_model=2)
        out["tp"] = {name: tp19_run(name, torch.bfloat16, args.seed + 19,
                                    tmesh)
                     for name in TP19_FAMILIES}
        times["tp"] = time.perf_counter() - t0
        out["tp_f32"] = {name: tp19_run(name, torch.float32, args.seed + 19,
                                        tmesh, TP19_F32_BATCH)
                         for name in TP19_FAMILIES}
        times["tp f32"] = time.perf_counter() - t0
        out["times"] = times
        if rank != 0:
            for key in ("grads", "deltas", "heads", "f32"):
                out.pop(key)
            for r in (*out["tp"].values(), *out["tp_f32"].values()):
                r.pop("grads")
        torch.save(out, os.path.join(out_dir, f"space-child_{rank}.pt"))
    finally:
        distributed_shutdown()
    return 0


def space_references(args):
    """(a) and (b)'s references in one process, on the same weights and
    images: the whole model's bf16 step (and its eval heads) and the f32
    step on them (the precision rule's truth); the f32 step at
    SPACE_F32_BATCH and its probe; each family's bf16 and f32 step, and
    its f32 step at TP19_F32_BATCH and that step's probe. The
    whole bf16 model's next steps are timed later (``refs["timer"]``),
    when the card is this process's alone."""
    refs = {}
    for key, dtype, batch, eps in (
            ("bf16", torch.bfloat16, SPACE_BATCH, 0.0),
            ("truth", torch.float32, SPACE_BATCH, 0.0),
            ("f32", torch.float32, SPACE_F32_BATCH, 0.0),
            ("probe", torch.float32, SPACE_F32_BATCH, PROBE_EPS)):
        run = space_run(args, dtype, batch, eps=eps,
                        eval_rows=SPACE_EVAL_ROWS if batch == SPACE_BATCH
                        else 0)
        refs[key] = run[4]
        if key == "bf16":
            refs["timer"] = functools.partial(timed_steps, *run[:4], 2)
        del run
        torch.cuda.empty_cache()
    for name in TP19_FAMILIES:
        refs[name] = {dt: tp19_run(name, dtype, args.seed + 19,
                                   batch=batch, eps=eps)
                      for dt, dtype, batch, eps in (
                          ("bf16", torch.bfloat16, TP19_BATCH, 0.0),
                          ("truth", torch.float32, TP19_BATCH, 0.0),
                          ("f32", torch.float32, TP19_F32_BATCH, 0.0),
                          ("probe", torch.float32, TP19_F32_BATCH,
                           PROBE_EPS))}
        torch.cuda.empty_cache()
    return refs


def row_messages(records):
    """(count, largest in rows, elements) of the row messages of one
    process's step, forward (fetches) and backward (returns)."""
    rows = [r for r in records if r[0].startswith("row_")]
    return (len(rows), max((r[3] for r in rows), default=0),
            sum(r[2] for r in rows))


def slab_launches(results):
    """K1's launches at an explicit (slab) geometry in both processes'
    step, and those at each of SLAB_CONV_SHAPES."""
    total = sum(c for r in results for key, c in r["by_shape"].items()
                if isinstance(key[7], conv_mod.Geometry))
    each = {s[0]: sum(r["by_shape"].get(
        (SPACE_BATCH, *s[1:8]), 0) for r in results)
        for s in SLAB_CONV_SHAPES}
    return total, each


def phase_spatial(args, card):
    """Phase 19: K1 at SLAB_CONV_SHAPES, (a) spatial partitioning and (b)
    tensor parallelism of the remaining layer kinds; every child process
    ended on every path."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 19)
    convs = phase_conv_checks(gen, SPACE_BATCH, SLAB_CONV_SHAPES)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_space_") as tmp:
        procs = start_children("--space-child", 2, args, tmp)
        started = time.monotonic()
        try:
            refs = space_references(args)
            t_refs = time.perf_counter() - t0
            open(os.path.join(tmp, "go"), "w").close()
            r0, r1 = finish_children(procs, "--space-child", tmp, "19",
                                     started)
        finally:
            kill_children(procs)
    t_children = time.perf_counter() - t0
    ref_ms = float(np.median(refs.pop("timer")()[0]))
    torch.cuda.empty_cache()
    ref, truth = refs["bf16"], refs["truth"]
    rule = functools.partial(precision_rule, cap=RULE_CAP)
    loss = rule({"loss": torch.tensor(r0["loss"])},
                {"loss": torch.tensor(ref["loss"])},
                {"loss": torch.tensor(truth["loss"])})
    zeros = zero_grad_leaves(truth["grads"])
    g = rule(r0["grads"], ref["grads"], truth["grads"], scales=zeros)
    st = rule(r0["deltas"], ref["deltas"], truth["deltas"])
    heads = rule(dict(enumerate(r0["heads"])), dict(enumerate(ref["heads"])),
                 dict(enumerate(truth["heads"])))
    f32 = r0["f32"]
    loss32 = (abs(f32["loss"] - refs["f32"]["loss"]),
              abs(refs["probe"]["loss"] - refs["f32"]["loss"]))
    g32 = probe_rule(f32["grads"], refs["f32"]["grads"],
                     refs["probe"]["grads"],
                     scales=zero_grad_leaves(refs["f32"]["grads"]))
    st32 = probe_rule(f32["deltas"], refs["f32"]["deltas"],
                      refs["probe"]["deltas"], floor=1e-4)
    msgs = [row_messages(r["records"]) for r in (r0, r1)]
    gathers = [[c for c in r["records"] if c[0] == "all_gather"]
               for r in (r0, r1)]
    slabs, slab_each = slab_launches((r0, r1))
    ms = [float(np.median(r["ms"])) for r in (r0, r1)]
    level = args.size // 32
    print(f"  (a) 2 processes, gloo, (data 1, space 2), YOLOv4 packed=False "
          f"bf16 b{SPACE_BATCH} {args.size}^2: image rows "
          f"{r0['rows'][1]} + {r1['rows'][1]}, the {level}^2 level "
          + " + ".join(str(hi - lo) for lo, hi in split_rows(level, 2)))
    print(f"  (a) against 1 process: loss {r0['loss']:.6f} / "
          f"{ref['loss']:.6f} ({rule_line(loss)}); running statistics' "
          f"step {rule_line(st, len(ref['deltas']))}; gathered eval heads "
          f"of {SPACE_EVAL_ROWS} images {rule_line(heads, 3)}")
    print(f"  (a) the train step's gradients ({len(zeros)} biases of exact "
          f"gradient 0 over their layer's scale): "
          f"{rule_line(g, len(ref['grads']), train=True)}; "
          f"{to_whole(r0['grads'], ref['grads'])}")
    print(f"  (a) f32 b{SPACE_F32_BATCH}, phase 8's probe rule: loss "
          f"{f32['loss']:.6f} / "
          f"{refs['f32']['loss']:.6f} (|diff| {loss32[0]:.2e}, probe "
          f"{loss32[1]:.2e}); gradients worst {g32[1]:.2e} at {g32[0]} "
          f"(probe {g32[2]:.2e}), {len(g32[3])} outside; running "
          f"statistics' step worst {st32[1]:.2e} at {st32[0]} (probe "
          f"{st32[2]:.2e}), {len(st32[3])} outside")
    print(f"  (a) row messages a step (forward fetches and backward "
          f"returns) by process: " + "; ".join(
              f"{n} messages, largest {mx} rows, {el / 1e6:.2f} M elements"
              for n, mx, el in msgs)
          + f"; heads' all-gathers {len(gathers[0])} / {len(gathers[1])}")
    print(f"  (a) K1 launches a step: {r0['counts']['conv_bn_stats']} / "
          f"{r1['counts']['conv_bn_stats']}, on the tensor cores "
          f"{r0['counts']['conv_bn_stats_tc']} / "
          f"{r1['counts']['conv_bn_stats_tc']}; {slabs} at slab geometries "
          f"in both; at the checked slabs: {slab_each}")
    print(f"  (a) ms/step bf16 {ms[0]:.2f} / {ms[1]:.2f} (two processes "
          f"sharing the card, rows through the host) against {ref_ms:.2f} "
          f"whole [{card}]")
    tp_res = {}
    for name in TP19_FAMILIES:
        got, got32 = r0["tp"][name], r0["tp_f32"][name]
        want, tru = refs[name]["bf16"], refs[name]["truth"]
        want32, probe32 = refs[name]["f32"], refs[name]["probe"]
        fzeros = zero_grad_leaves(tru["grads"])
        tg = rule(got["grads"], want["grads"], tru["grads"], scales=fzeros)
        # the linear loss's terms have both signs: over their scale
        tl = rule({"loss": torch.tensor(got["loss"])},
                  {"loss": torch.tensor(want["loss"])},
                  {"loss": torch.tensor(tru["loss"])},
                  scales={"loss": tru["scale"]})
        fg = probe_rule(got32["grads"], want32["grads"], probe32["grads"],
                        scales=zero_grad_leaves(want32["grads"]))
        fl = probe_rule({"loss": torch.tensor(got32["loss"])},
                        {"loss": torch.tensor(want32["loss"])},
                        {"loss": torch.tensor(probe32["loss"])},
                        scales={"loss": want32["scale"]})
        tp_res[name] = dict(
            loss=got["loss"], loss_whole=want["loss"],
            loss_outside=len(tl[4]), grads_bit_equal=tg[0],
            grad_worst=tg[1:4], grads_outside=len(train_failures(tg)),
            grads_capped=len(tg[5]), zero_grad_biases=len(fzeros),
            f32_loss=(got32["loss"], want32["loss"], fl[1], fl[2]),
            f32_loss_outside=len(fl[3]), f32_grad_worst=fg[:3],
            f32_grads_outside=len(fg[3]), sliced_leaves=got["sliced"],
            launches=sum(r["tp"][name]["counts"]["conv_bn_stats"]
                         + r["tp_f32"][name]["counts"]["conv_bn_stats"]
                         for r in (r0, r1)),
            launches_at_slice=got["launches_at_slice"]
            + r1["tp"][name]["launches_at_slice"],
            tensor_cores=got["counts"]["conv_bn_stats_tc"]
            + r1["tp"][name]["counts"]["conv_bn_stats_tc"])
        print(f"  (b) {name} bf16 b{TP19_BATCH} at n_model 2: "
              f"{got['sliced']} leaves sliced; loss {got['loss']:.6f} / "
              f"{want['loss']:.6f} (over the terms' scale "
              f"{tru['scale']:.4g}: {rule_line(tl)}); gradients "
              f"({len(fzeros)} biases of exact gradient 0 over their "
              f"layer's scale) {rule_line(tg, len(want['grads']), True)}; "
              f"{to_whole(got['grads'], want['grads'])}; K1 "
              f"launches {got['counts']['conv_bn_stats']} / "
              f"{r1['tp'][name]['counts']['conv_bn_stats']} "
              f"({got['counts']['conv_bn_stats_tc']} on the tensor cores), "
              f"{tp_res[name]['launches_at_slice']} of both processes' at a "
              f"slice's Co / 2")
        print(f"  (b) {name} f32 b{TP19_F32_BATCH}, phase 8's probe rule: "
              f"loss {got32['loss']:.6f} / {want32['loss']:.6f} (|diff| "
              f"over the terms' scale {fl[1]:.2e}, probe {fl[2]:.2e}); "
              f"gradients "
              f"worst {fg[1]:.2e} at {fg[0]} (probe {fg[2]:.2e}), "
              f"{len(fg[3])} outside" + (f": {fg[3][:3]}" if fg[3] else ""))
    seconds = time.perf_counter() - t0
    print(f"  the references took {t_refs:.1f} s, the children ended at "
          f"{t_children:.1f} s (process 0 from its start: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in r0["times"].items())
          + f"); phase 19 took {seconds:.1f} s")
    check(not loss[4], "19(a) the bf16 losses differ")
    check(not train_failures(g), f"19(a) bf16 gradients differ at "
          f"{train_failures(g)[:5]}")
    check(not st[4], f"19(a) bf16 running statistics differ at {st[4][:5]}")
    check(not heads[4], "19(a) the gathered eval heads differ")
    check(loss32[0] <= 1e-5 * abs(refs["f32"]["loss"]) + 4 * loss32[1],
          "19(a) the f32 losses differ")
    check(not g32[3], f"19(a) f32 gradients differ at {g32[3][:5]}")
    check(not st32[3], f"19(a) f32 running statistics differ at "
          f"{st32[3][:5]}")
    for r, (n, mx, _) in zip((r0, r1), msgs):
        check(n > 0 and mx <= 6, f"19(a) row messages {n}, largest {mx}")
        check(r["counts"]["conv_bn_stats"] == CONVS_PER_FORWARD
              and r["counts"]["conv_bn_stats_tc"] == CONVS_PER_FORWARD,
              f"19(a) launches {r['counts']}, want {CONVS_PER_FORWARD} on "
              "the tensor cores")
    check(all(len(gs) == 3 and all(c[1] == 1 for c in gs)
              for gs in gathers), "19(a) the heads' gathers")
    check(all(v > 0 for v in slab_each.values()),
          f"19(a) the checked slabs were not launched: {slab_each}")
    for name, r in tp_res.items():
        check(not r["loss_outside"] and not r["grads_outside"],
              f"19(b) {name}: the sliced bf16 step differs")
        check(not r["f32_loss_outside"] and not r["f32_grads_outside"],
              f"19(b) {name}: the sliced f32 step differs")
        check(r["sliced_leaves"] > 0 and r["launches_at_slice"] > 0,
              f"19(b) {name}: nothing sliced")
    return dict(conv=convs, loss=r0["loss"], loss_whole=ref["loss"],
                grads_bit_equal=g[0], grad_worst=g[1:4],
                grads_capped=len(g[5]), zero_grad_biases=len(zeros),
                stats_bit_equal=st[0], heads_bit_equal=heads[0],
                f32_loss=loss32, f32_grad_worst=g32[:3],
                f32_stats_worst=st32[:3], row_messages=msgs,
                slab_launches=slabs, slab_launches_by_shape=slab_each,
                launches=r0["counts"]["conv_bn_stats"]
                + r1["counts"]["conv_bn_stats"]
                + sum(r["launches"] for r in tp_res.values()),
                ms_per_step=ms, whole_ms_per_step=ref_ms,
                tensor_parallel=tp_res, seconds=seconds)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=416)
    p.add_argument("--requests", type=int, default=2)
    p.add_argument("--train-batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--log-dir",
                   default=os.path.join(ROOT, "build", "chip_smoke"))
    p.add_argument("--dp-child", nargs=3, metavar=("RANK", "STORE", "DIR"),
                   help="run one process of phase 17's (b) and exit")
    p.add_argument("--tp-child", nargs=3, metavar=("RANK", "STORE", "DIR"),
                   help="run one process of phase 18's (a) and exit")
    p.add_argument("--pp-child", nargs=3, metavar=("RANK", "STORE", "DIR"),
                   help="run one process of phase 18's (c) and exit")
    p.add_argument("--space-child", nargs=3,
                   metavar=("RANK", "STORE", "DIR"),
                   help="run one process of phase 19 and exit")
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    # every process, the children too: f32 library convs and matmuls
    # without TF32, as the plain versions and the references take them
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.dp_child:
        rank, store, out_dir = args.dp_child
        return dp_child(int(rank), store, out_dir, args.seed + 17, args.size)
    for child, flag in ((tp_child, args.tp_child), (pp_child, args.pp_child),
                        (space_child, args.space_child)):
        if flag:
            rank, store, out_dir = flag
            return child(int(rank), store, out_dir, args)
    t_start = time.perf_counter()
    card = card_line()
    print(f"phase 1: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(card)

    build_s = phase_build(args.log_dir)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    print("phase 3: kernels against their plain versions")
    conv_res = phase_conv_checks(gen, args.batch)
    conv_res += phase_conv_checks(gen, args.train_batch)
    # their own generator: the draws of the phases after them stay those
    # the script made before these shapes were added
    same_res = phase_conv_checks(
        torch.Generator(device="cuda").manual_seed(args.seed + 3),
        args.batch, SAME_CONV_SHAPES)
    # the backbones' geometries, also on a generator of their own
    backbone_gen = torch.Generator(device="cuda").manual_seed(args.seed + 15)
    backbone_res = []
    for n in (args.batch, args.train_batch):
        backbone_res += phase_conv_checks(backbone_gen, n,
                                          BACKBONE_CONV_SHAPES)
    depthwise_res = [phase_depthwise(backbone_gen, n)
                     for n in (args.batch, args.train_batch)]
    nms_res = phase_nms_checks(gen)
    soft_res = phase_soft_checks(gen)
    gemm_res = phase_gemm_checks(gen, args.batch)
    gemm_res += phase_gemm_checks(gen, args.train_batch)
    probe_res, probe_chain = phase_probe_checks(gen, args.train_batch)
    conv3_res = phase_conv3_checks(gen, args.batch)
    conv3_res += phase_conv3_checks(gen, args.train_batch)
    int8_res = phase_int8_checks(gen, args.batch)
    int8_res += phase_int8_checks(gen, DEPLOY_BIG_BATCH)
    aligned = phase_alignment_checks(gen)

    print(f"phase 4: serving {args.requests} requests of {args.batch} x "
          f"{args.size}^2 in bf16 (HE_NORMAL kernels, seed {args.seed}, "
          "calibrated BN statistics)")
    model, threshold = build_model(args, gen)
    images = [torch.rand(args.batch, args.size, args.size, 3,
                         generator=gen, device="cuda")
              for _ in range(args.requests + 1)]
    with torch.inference_mode():
        joint = joint_conf(model(images[0])).float()
    qs = torch.quantile(joint[0], torch.tensor(
        [0.0, 0.5, 0.99, 1.0], device="cuda")).tolist()
    print(f"  joint confidence, image 0: min {qs[0]:.4f} median "
          f"{qs[1]:.4f} p99 {qs[2]:.4f} max {qs[3]:.4f}; threshold "
          f"{threshold:.4f}")
    served = phase_serve(args, model, threshold, images)
    torch.cuda.synchronize()

    print("phase 5: f32 kernel route against plain route, same weights")
    routes = phase_routes_f32(model, images[0])

    print("phase 6: ms/request, both routes")
    timing = phase_timing(args, model, threshold, images, card)

    print(f"phase 7: training {args.steps} steps (after one warm-up) of "
          "YoloV4(packed=3), then 1 step of YoloV4(packed=True), Adam "
          "1e-3, synthetic labels")
    trained, handles3 = phase_train(args, 3, args.steps, args.train_batch)
    trained1, handles1 = phase_train(args, 1, 1, trained["batch"])
    check(trained1["batch"] == trained["batch"],
          "packed=True did not fit at the batch packed=3 trained at")
    if trained["batch"] != args.train_batch:
        print(f"  kernels again at the batch trained, {trained['batch']}")
        conv_res += phase_conv_checks(gen, trained["batch"])
        gemm_res += phase_gemm_checks(gen, trained["batch"])
        conv3_res += phase_conv3_checks(gen, trained["batch"])

    print("phase 8: one f32 training step of packed=3, kernel route against "
          "plain route, same state")
    train_routes = phase_train_routes_f32(args)

    print("phase 9: ms/step, packed=3 on both routes and packed=True")
    train_timing = phase_train_timing(args, handles3, handles1, card)
    del handles3, handles1
    torch.cuda.empty_cache()

    print(f"phase 10: the facade, yolov4.Yolo -> create_model(packed=3, "
          f"bf16) -> compile -> fit -> evaluate -> predict at "
          f"{args.size}^2")
    facade = phase_facade(args, card)

    print(f"phase 11: deployment at {args.size}^2 on phase 4's weights: BN "
          "folding, int8 at gates 256 and 0, the serving artifact, "
          "ms/request")
    deploy = phase_deploy(args, model, threshold, images, card)
    del images
    torch.cuda.empty_cache()

    print("phase 12: the frozen-statistics BatchNorm backward "
          "(scope='backbone')")
    bn_sg = phase_bn_sg(args, card, trained["batch"])

    print(f"phase 13: device evaluation of {EVAL_IMAGES} images at "
          f"{args.size}^2 on phase 4's network: create_score_mat and PRfunc "
          "on the card against the host, greedy, Soft and DIoU NMS")
    evaluation = phase_eval(args, model, card)
    del model
    torch.cuda.empty_cache()

    print("phase 14: the other families through their facades, bf16, "
          "random weights from the seed: YOLOv3 at 416^2 (serve, train, "
          "f32 routes), then YOLOv3 tiny, YOLOv2 darknet and UNet at "
          "416^2, YOLOv1.5 at 448^2")
    families = phase_families(args, card)

    print("phase 15: the backbones through their facades, bf16, random "
          "weights from the seed: YOLOv4 with ResNet-50 at 416^2 (serve, "
          "train, f32 routes, folded and int8 requests), YOLOv3 with "
          "ResNet-101 v2 and with a backbone factory, YOLOv2 with "
          "MobileNetV2, YOLOv4 with ResNet-152 (a request), and the "
          "csp_darknet53 and darknet19 classifiers (a step each)")
    backbones = phase_backbones(args, card)

    print(f"phase 16: kernel Q at YOLOv1.5's SAME geometries (b{args.batch} "
          f"and b{DEPLOY_BIG_BATCH}); YOLOv1.5 at {V1_SIZE}^2 served int8 at "
          "gates 0 and 256; the reference-weight round trip of YOLOv4, "
          "YOLOv3 and YOLOv1.5 on the card")
    v1_same = phase_v1_same(args, card)

    print(f"phase 17: the parallel paths, YOLOv4 packed=3 at {args.size}^2: "
          "(a) a process group of one (nccl, HashStore) against phase 7's "
          "step, (b) two processes on the card (gloo, FileStore) against "
          "one, (c) a 3-stage pipeline against the single program")
    parallel = phase_parallel(args, card)

    print(f"phase 18: tensor parallelism and PP x DP, YOLOv4 at "
          f"{args.size}^2: K1 at two sliced shapes; (a) packed=False bf16 "
          f"b{TP_BATCH} on a (data 1, model 2) grid of two processes against "
          "one, (b) its gathered checkpoint in an unsliced model, (c) 2 "
          f"stages x 2 processes, f32 b{PP_BATCH}, against the single "
          "program")
    tp_phase = phase_tensor_parallel(args, card)

    print(f"phase 19: spatial partitioning and the remaining tensor-parallel "
          f"layers: K1 at three row slabs; (a) YOLOv4 packed=False bf16 "
          f"b{SPACE_BATCH} at {args.size}^2 on a (data 1, space 2) grid of "
          f"two processes against one, (b) YOLOv4-ResNet-50, "
          f"YOLOv2-MobileNetV2 and YOLOv2-UNet bf16 b{TP19_BATCH} at "
          "n_model 2 against n_model 1")
    space_phase = phase_spatial(args, card)

    def bf16_at(results, shape):
        return [r for r in results
                if r["dtype"] == "bfloat16" and r["shape"] == shape][-1]

    conv_at = bf16_at(conv_res, CONV_SHAPES[4][0])   # at the batch trained
    stem_at = bf16_at(conv_res, CONV_SHAPES[0][0])
    nms_at = [r for r in nms_res if r["k"] == 128 and r["iou_mode"] == 1][0]
    soft_at = [r for r in soft_res if r["k"] == 128 and r["sigma"] == 0.5][0]
    # the device evaluation's chunk, N=64 and K=256
    nms_chunk = [r for r in nms_res if r["k"] == EVAL_MAX_BOXES
                 and r["iou_mode"] == 1][0]
    soft_chunk = [r for r in soft_res if r["k"] == EVAL_MAX_BOXES
                  and r["sigma"] == 0.5][0]
    fwd_at = bf16_at(gemm_res, GEMM_SHAPES[1][0])
    bwd_at = bf16_at(gemm_res, GEMM_SHAPES[0][0])
    conv3_at = bf16_at(conv3_res, CONV3_SHAPES[0][0])
    def int8_bf16(shape, batch):
        return [r for r in int8_res if r["shape"] == shape
                and r["batch"] == batch
                and r["dtype"] == "bfloat16 -> bfloat16"][0]

    int8_at = int8_bf16(INT8_SHAPES[1][0], args.batch)
    int8_td1 = int8_bf16(INT8_SHAPES[2][0], DEPLOY_BIG_BATCH)
    int8_td2 = int8_bf16(INT8_SHAPES[3][0], DEPLOY_BIG_BATCH)

    def train_launches(name):
        """Launches in the packed=3 run, the packed=True run, the
        facade's fit (phase 10) and the parallel paths (phase 17), and
        all of them."""
        runs = (trained["launches"][name], trained1["launches"][name],
                facade["fit"]["launches"][name],
                parallel["launches"][name])
        return dict(launches=sum(runs), launches_training_packed3=runs[0],
                    launches_training_packed1=runs[1],
                    launches_facade_fit=runs[2], launches_parallel=runs[3])
    def family_launches(counter):
        """Launches of ``counter`` in phase 14's requests and steps."""
        return sum(families[name][run][counter]
                   for name, _, _, _ in FAMILY_RUNS
                   for run in ("serve_launches", "train_launches"))

    def backbone_counts(counter):
        """Launches of ``counter`` in phase 15's requests and steps."""
        return sum(res[run][counter] for res in backbones.values()
                   if isinstance(res, dict)
                   for run in ("serve_launches", "train_launches",
                               "launches") if run in res)

    # times, bounds and library times at one shape each (``at``); errors
    # are the largest over every shape and dtype checked; launches are
    # the counts of the serving and the training runs above
    kernels = [
        dict(name="conv_bn_stats", route="cuda",
             source="tf2_yolo_tpu_torch/csrc/conv_bn.cu",
             replaces="tf2_yolo_tpu/ops/pallas/conv_bn_kernel.py:114 "
                      "and :346",
             **{**train_launches("conv_bn_stats"),
                "launches": served["conv_launches"]
                + train_launches("conv_bn_stats")["launches"]
                + facade["evaluate_predict_launches"]["conv_bn_stats"]
                + evaluation["conv_launches"]
                + family_launches("conv_bn_stats")
                + backbone_counts("conv_bn_stats")
                + tp_phase["launches"] + space_phase["launches"]},
             launches_tensor_parallel=tp_phase["launches"],
             launches_spatial=space_phase["launches"],
             launches_families=family_launches("conv_bn_stats"),
             launches_backbones=backbone_counts("conv_bn_stats"),
             launches_serving=served["conv_launches"],
             launches_device_eval=evaluation["conv_launches"],
             launches_facade_evaluate_predict=facade[
                 "evaluate_predict_launches"]["conv_bn_stats"],
             launches_tc=served["conv_tc_launches"]
             + train_launches("conv_bn_stats_tc")["launches"]
             + facade["evaluate_predict_launches"]["conv_bn_stats_tc"],
             max_abs_err=max(r["max_abs_err"] for r in conv_res),
             at=f"{conv_at['shape']}, batch {conv_at['batch']}, bf16",
             ms=conv_at["ms"], plain_ms=conv_at["plain_ms"],
             bound_ms=conv_at["bound_ms"], bound_by=conv_at["bound_by"],
             library_ms=conv_at["library_ms"],
             tflops=conv_at["kernel_tflops"],
             bound_share=conv_at["bound_share"],
             cuda_core_ms=conv_at["cuda_core_ms"],
             # the stem's small-Ci kernel, at the batch trained
             stem_ms=stem_at["ms"], stem_plain_ms=stem_at["plain_ms"],
             stem_bound_ms=stem_at["bound_ms"],
             stem_library_ms=stem_at["library_ms"],
             stem_cuda_core_ms=stem_at["cuda_core_ms"]),
        # ``ms`` both launches alone (CUDA graph),
        # ``wrapper_ms`` through the wrapper; launches one a greedy request
        # and one a chunk of the device evaluation (modes 1 and 3);
        # ``chunk_*`` at the evaluation's chunk, N=64, K=256
        dict(name="nms_keep", route="cuda",
             source="tf2_yolo_tpu_torch/csrc/nms.cu",
             replaces="tf2_yolo_tpu/ops/pallas/nms_kernel.py:182",
             launches=served["nms_launches"] + evaluation["nms_launches"]
             + family_launches("nms_keep") + backbone_counts("nms_keep"),
             launches_serving=served["nms_launches"],
             launches_families=family_launches("nms_keep"),
             launches_backbones=backbone_counts("nms_keep"),
             launches_device_eval=evaluation["nms_launches"],
             launches_per_request=served["nms_launches"]
             / served["greedy_requests"],
             max_abs_err=max(r["max_abs_err"] for r in nms_res),
             at="N=8, K=128, IoU",
             ms=nms_at["ms"], wrapper_ms=nms_at["wrapper_ms"],
             plain_ms=nms_at["plain_ms"],
             bound_ms=nms_at["bound_ms"], bound_by=nms_at["bound_by"],
             bound_share=nms_at["bound_share"], library_ms=None,
             **{f"chunk_{k}": nms_chunk[k]
                for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms")}),
        # no Pallas counterpart: the JAX package's Soft-NMS is a lax.scan;
        # launches one a Soft-NMS request and one a chunk (mode 2)
        dict(name="soft_nms_keep", route="cuda",
             source="tf2_yolo_tpu_torch/csrc/nms.cu",
             replaces="tf2_yolo_tpu/ops/nms.py:108 (lax.scan, no Pallas "
                      "kernel)",
             launches=served["soft_nms_launches"]
             + evaluation["soft_nms_launches"],
             launches_serving=served["soft_nms_launches"],
             launches_device_eval=evaluation["soft_nms_launches"],
             launches_per_request=served["soft_nms_launches"]
             / served["soft_requests"],
             max_abs_err=max(r["max_abs_err"] for r in soft_res),
             mismatches_in_band=sum(r["mismatches_in_band"]
                                    for r in soft_res),
             at="N=8, K=128, sigma 0.5",
             ms=soft_at["ms"], wrapper_ms=soft_at["wrapper_ms"],
             plain_ms=soft_at["plain_ms"], bound_ms=soft_at["bound_ms"],
             bound_by=soft_at["bound_by"],
             bound_share=soft_at["bound_share"], library_ms=None,
             **{f"chunk_{k}": soft_chunk[k]
                for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms")}),
        # K2, K2', K3' and P: ``ms`` is the kernel launched alone (the
        # routed, tensor-core kernel), ``wrapper_ms`` the public wrapper
        # around it, ``cuda_core_ms`` the CUDA-core instance on the same
        # inputs; ``library_ms`` torch.matmul / convolution_backward on
        # the activated inputs
        dict(name="fused_gemm_fwd", route="cuda",
             source="tf2_yolo_tpu_torch/csrc/fused_gemm.cu",
             replaces="tf2_yolo_tpu/ops/pallas/packed_gemm.py:160",
             **train_launches("fused_gemm_fwd"),
             launches_tc=train_launches("fused_gemm_fwd_tc")["launches"],
             max_abs_err=max(r["max_abs_err"] for r in gemm_res),
             at=f"{fwd_at['shape']}, M={fwd_at['m']}, bf16",
             ms=fwd_at["launch_ms"], wrapper_ms=fwd_at["ms"],
             plain_ms=fwd_at["plain_ms"],
             bound_ms=fwd_at["bound_ms"], bound_by=fwd_at["bound_by"],
             library_ms=fwd_at["library_ms"], tflops=fwd_at["fwd_tflops"],
             bound_share=fwd_at["bound_share"],
             cuda_core_ms=fwd_at["cuda_core_ms"]),
        dict(name="fused_gemm_bwd", route="cuda",
             source="tf2_yolo_tpu_torch/csrc/fused_gemm.cu",
             replaces="tf2_yolo_tpu/ops/pallas/packed_gemm.py:272",
             **train_launches("fused_gemm_bwd"),
             launches_tc=train_launches("fused_gemm_bwd_tc")["launches"],
             max_abs_err=max(r["dx_rel_to_max"] for r in gemm_res),
             at=f"{bwd_at['shape']}, M={bwd_at['m']}, bf16",
             ms=bwd_at["bwd_launch_ms"], wrapper_ms=bwd_at["bwd_ms"],
             plain_ms=bwd_at["bwd_plain_ms"],
             bound_ms=bwd_at["bwd_bound_ms"],
             bound_by=bwd_at["bwd_bound_by"],
             library_ms=bwd_at["bwd_library_ms"],
             tflops=bwd_at["bwd_launch_tflops"],
             bound_share=bwd_at["bwd_bound_share"],
             cuda_core_ms=bwd_at["bwd_cuda_core_ms"]),
        # with the prologue no one PyTorch call computes the function;
        # ``bare_ms`` / ``bare_library_ms`` are the kernel and F.conv2d
        # (bf16, channels_last) on the activated input at the same shape
        dict(name="fused_conv3x3_fwd", route="cuda",
             source="tf2_yolo_tpu_torch/csrc/fused_conv3x3.cu",
             replaces="tf2_yolo_tpu/ops/pallas/packed_conv3x3.py:286",
             **train_launches("fused_conv3x3_fwd"),
             launches_tc=train_launches("fused_conv3x3_fwd_tc")["launches"],
             max_abs_err=max(r["max_abs_err"] for r in conv3_res),
             at=f"{conv3_at['shape']}, batch {conv3_at['batch']}, bf16",
             ms=conv3_at["ms"], plain_ms=conv3_at["plain_ms"],
             bound_ms=conv3_at["bound_ms"], bound_by=conv3_at["bound_by"],
             library_ms=None, bare_ms=conv3_at["bare_ms"],
             bare_library_ms=conv3_at["library_ms"],
             tflops=conv3_at["fwd_tflops"],
             bound_share=conv3_at["bound_share"],
             cuda_core_ms=conv3_at["cuda_core_ms"]),
        dict(name="fused_conv3x3_bwd", route="cuda",
             source="tf2_yolo_tpu_torch/csrc/fused_conv3x3.cu",
             replaces="tf2_yolo_tpu/ops/pallas/packed_conv3x3.py:643 "
                      "and :650",
             **train_launches("fused_conv3x3_bwd"),
             max_abs_err=max(r["dx_rel_to_max"] for r in conv3_res),
             launches_tc=train_launches("fused_conv3x3_bwd_tc")["launches"],
             at=f"{conv3_at['shape']}, batch {conv3_at['batch']}, bf16",
             ms=conv3_at["bwd_launch_ms"], wrapper_ms=conv3_at["bwd_ms"],
             plain_ms=conv3_at["bwd_plain_ms"],
             bound_ms=conv3_at["bwd_bound_ms"],
             bound_by=conv3_at["bwd_bound_by"],
             library_ms=conv3_at["bwd_library_ms"],
             tflops=conv3_at["bwd_launch_tflops"],
             bound_share=conv3_at["bwd_bound_share"],
             cuda_core_ms=conv3_at["bwd_cuda_core_ms"]),
        # Q: no Pallas counterpart (XLA's s8 x s8 -> s32 conv); launches
        # those of phase 11's counted requests (int8 gates 256 and 0,
        # the int8 artifact and make_serving_fn beside it), each with
        # one quantize pass (``quant_launches``); ``ms`` Q alone (CUDA
        # graph, both launches) at the 1x1 shape, whose yardstick is
        # torch._int_mm on the same int8 operands, ``before_ms`` the
        # first kernel there; the 3x3 td1_pre2 and td2.conv2 at
        # bench_infer.py's batch 32 beside it (no yardstick)
        dict(name="conv_int8", route="cuda",
             source="tf2_yolo_tpu_torch/csrc/conv_int8.cu",
             replaces="tf2_yolo_tpu/models/layers.py:389 "
                      "(ConvBN._quant_call, XLA conv_general_dilated s8 x "
                      "s8 -> s32, no Pallas kernel)",
             launches=deploy["int8_launches"],
             launches_tc=deploy["int8_tc_launches"],
             quant_launches=deploy["int8_quant_launches"],
             max_abs_err=max(r["max_abs_err"] for r in int8_res),
             at=f"{int8_at['shape']}, batch {int8_at['batch']}, bf16",
             ms=int8_at["ms"], quant_ms=int8_at["quant_ms"],
             conv_ms=int8_at["conv_ms"], before_ms=int8_at["before_ms"],
             wrapper_ms=int8_at["wrapper_ms"],
             plain_ms=int8_at["plain_ms"],
             bound_ms=int8_at["bound_ms"], bound_by=int8_at["bound_by"],
             library_ms=int8_at["library_ms"], tops=int8_at["tops"],
             bound_share=int8_at["bound_share"],
             k1_bf16_ms=int8_at["k1_bf16_ms"],
             **{f"{key}_b32_{field}": r[field]
                for key, r in (("td1_pre2", int8_td1),
                               ("td2_conv2", int8_td2))
                for field in ("ms", "before_ms", "bound_ms",
                              "k1_bf16_ms")}),
        # a tool's kernel, on no model path: its launches are those of
        # the probe's own chain of four layers
        dict(name="probe_layer", route="cuda",
             source="tf2_yolo_tpu_torch/csrc/fused_gemm.cu",
             replaces="tools/bench_packed_probe.py:70",
             launches=probe_chain["launches"],
             launches_tc=probe_chain["tc_launches"],
             max_abs_err=max(r["max_abs_err"] for r in probe_res),
             at=f"{probe_res[0]['shape']}, M={probe_res[0]['m']}, bf16",
             ms=probe_res[0]["launch_ms"], wrapper_ms=probe_res[0]["ms"],
             plain_ms=probe_res[0]["plain_ms"],
             bound_ms=probe_res[0]["bound_ms"],
             bound_by=probe_res[0]["bound_by"], library_ms=None,
             tflops=probe_res[0]["tflops"],
             bound_share=probe_res[0]["bound_share"],
             cuda_core_ms=probe_res[0]["cuda_core_ms"],
             eager_chain_ms_per_layer=probe_chain["eager_ms_per_layer"]),
    ]
    # the flax-SAME geometries (phase 3 at the serving batch, bf16), with
    # their launches on phase 14's paths (YOLOv1.5: the 7x7 stem and the
    # 3x3 stride 2; the UNet: its two 2x2 convs)
    for shape, key in zip(SAME_CONV_SHAPES,
                          ("7x7s2 same", "3x3s2 same", "2x2s1 same")):
        r = bf16_at(same_res, shape[0])
        kernels.append(dict(
            name=f"conv_bn_stats {key}", route="cuda",
            source="tf2_yolo_tpu_torch/csrc/conv_bn.cu",
            replaces="tf2_yolo_tpu/models/layers.py:419 (ConvBN nn.Conv "
                     "padding SAME, XLA; beside the Pallas conv3x3_stats, "
                     "ops/pallas/conv_bn_kernel.py:346)",
            launches=geometry_launches(families, key),
            max_abs_err=max(q["max_abs_err"] for q in same_res
                            if q["shape"] == shape[0]),
            at=f"{shape[0]}, batch {r['batch']}, bf16",
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            tflops=r["kernel_tflops"], bound_share=r["bound_share"],
            plan_route=r["route"], plan_config=r["config"],
            cuda_core_ms=r["cuda_core_ms"]))
    # K1 at the backbones' geometries (phase 3 at the serving batch,
    # bf16), with their launches on phase 15's paths: the ResNet stem, the
    # MobileNetV2 stem on the small-Ci kernel, the ResNets' 1x1 stride-2
    # convs on the ring, MobileNetV2's 1x1 convs of Ci 16, 24 and 144 on
    # the CUDA cores
    for shape, key, replaces in (
            (BACKBONE_CONV_SHAPES[0], "7x7s2 pad3",
             "tf2_yolo_tpu/models/resnet.py:140-143 (jnp.pad 3, nn.Conv "
             "7x7 stride 2 VALID, XLA)"),
            (BACKBONE_CONV_SHAPES[1], "3x3s2 same im2col",
             "tf2_yolo_tpu/models/mobilenet.py:85-87 (nn.Conv 3x3 stride 2 "
             "SAME, XLA)"),
            (BACKBONE_CONV_SHAPES[3], "1x1s2 same",
             "tf2_yolo_tpu/models/resnet.py:49-57, :95-97 (nn.Conv 1x1 "
             "stride 2, XLA)"),
            (BACKBONE_CONV_SHAPES[6], "1x1s1 same cuda_core",
             "tf2_yolo_tpu/models/mobilenet.py:46-58 (nn.Conv 1x1 of Ci 16, "
             "24, 144, XLA; beside the Pallas conv1x1_stats, "
             "ops/pallas/conv_bn_kernel.py:114)")):
        r = [q for q in backbone_res if q["shape"] == shape[0]
             and q["batch"] == args.batch and q["dtype"] == "bfloat16"][0]
        kernels.append(dict(
            name=f"conv_bn_stats {key}", route="cuda",
            source="tf2_yolo_tpu_torch/csrc/conv_bn.cu", replaces=replaces,
            launches=backbone_launches(backbones, key),
            max_abs_err=max(q["max_abs_err"] for q in backbone_res
                            if q["shape"] == shape[0]),
            at=f"{shape[0]}, batch {r['batch']}, bf16",
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            tflops=r["kernel_tflops"], bound_share=r["bound_share"],
            plan_route=r["route"], plan_config=r["config"],
            cuda_core_ms=r["cuda_core_ms"]))
    # Q at YOLOv1.5's SAME geometries (phase 16a, bf16 -> bf16, at the
    # serving batch and at 32), with their launches on phase 16b's int8
    # requests (the stem at gate 0, the 14^2 stride 2 at gates 0 and 256)
    for shape, key in zip(INT8_SAME_SHAPES, ("7x7s2 same gather",
                                             "3x3s2 same ring")):
        rs = {q["batch"]: q for q in v1_same["q_same"]
              if q["shape"] == shape[0]
              and q["dtype"] == "bfloat16 -> bfloat16"}
        r = rs[args.batch]
        kernels.append(dict(
            name=f"conv_int8 {key}", route="cuda",
            source="tf2_yolo_tpu_torch/csrc/conv_int8.cu",
            replaces="tf2_yolo_tpu/models/layers.py:389 (ConvBN._quant_call "
                     "with padding SAME, XLA conv_general_dilated s8 x s8 -> "
                     "s32, no Pallas kernel)",
            launches=v1_same["v1_int8"]["by_geometry"].get(key, 0),
            max_abs_err=max(q["max_abs_err"] for q in v1_same["q_same"]
                            if q["shape"] == shape[0]),
            at=f"{shape[0]}, batch {r['batch']}, bf16",
            ms=r["ms"], quant_ms=r["quant_ms"], conv_ms=r["conv_ms"],
            wrapper_ms=r["wrapper_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            tops=r["tops"], bound_share=r["bound_share"],
            k1_bf16_ms=r["k1_bf16_ms"], plan_route=r["route"],
            plan_config=r["config"], plan_splits=r["splits"],
            **{f"b{DEPLOY_BIG_BATCH}_{field}": rs[DEPLOY_BIG_BATCH][field]
               for field in ("ms", "bound_ms", "bound_by", "bound_share",
                             "k1_bf16_ms", "plain_ms")}))
    # K1 at two of the slices of YOLOv4's sharded layers at n_model 2
    # (phase 18, bf16, (a)'s batch), with their launches in (a)'s step in
    # both processes
    for shape in TP_CONV_SHAPES:
        r = bf16_at(tp_phase["conv"], shape[0])
        kernels.append(dict(
            name=f"conv_bn_stats n_model 2 {shape[0]}", route="cuda",
            source="tf2_yolo_tpu_torch/csrc/conv_bn.cu",
            replaces="tf2_yolo_tpu/ops/pallas/conv_bn_kernel.py:114 and "
                     ":346 (under tensor parallelism the JAX package runs "
                     "XLA convs: models/layers.py:52-57)",
            launches=tp_phase["tensor_parallel"]["launches_by_shape"][
                shape[0]],
            max_abs_err=max(q["max_abs_err"] for q in tp_phase["conv"]
                            if q["shape"] == shape[0]),
            at=f"{shape[0]}, batch {r['batch']}, bf16",
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            tflops=r["kernel_tflops"], bound_share=r["bound_share"],
            plan_route=r["route"], plan_config=r["config"],
            cuda_core_ms=r["cuda_core_ms"]))
    # K1 at three of the row slabs of spatial partitioning (phase 19,
    # bf16, (a)'s batch), with their launches in (a)'s step in both
    # processes
    for shape in SLAB_CONV_SHAPES:
        r = bf16_at(space_phase["conv"], shape[0])
        kernels.append(dict(
            name=f"conv_bn_stats {shape[0]}", route="cuda",
            source="tf2_yolo_tpu_torch/csrc/conv_bn.cu",
            replaces="tf2_yolo_tpu/ops/pallas/conv_bn_kernel.py:114 and "
                     ":346 (under spatial partitioning the JAX package runs "
                     "XLA convs on GSPMD's halo-exchanged shards: "
                     "models/layers.py:52-57)",
            launches=space_phase["slab_launches_by_shape"][shape[0]],
            max_abs_err=max(q["max_abs_err"] for q in space_phase["conv"]
                            if q["shape"] == shape[0]),
            at=f"{shape[0]}, batch {r['batch']}, bf16",
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            tflops=r["kernel_tflops"], bound_share=r["bound_share"],
            plan_route=r["route"], plan_config=r["config"],
            cuda_core_ms=r["cuda_core_ms"]))
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was never launched")
    seconds = time.perf_counter() - t_start
    record = dict(card=card, build_seconds=build_s, conv=conv_res,
                  nms=nms_res,
                  soft_nms=soft_res, gemm=gemm_res,
                  conv3x3=conv3_res,
                  probe=probe_res, probe_chain=probe_chain,
                  misaligned_raised=aligned, threshold=threshold,
                  served=served, routes_f32=routes, timing=timing,
                  trained=trained, trained_packed1=trained1,
                  train_routes_f32=train_routes,
                  train_timing=train_timing, facade=facade,
                  int8=int8_res, deploy=deploy, bn_sg=bn_sg,
                  device_eval=evaluation, conv_same=same_res,
                  families=families, conv_backbones=backbone_res,
                  depthwise=depthwise_res, backbones=backbones,
                  v1_same=v1_same, parallel=parallel,
                  tensor_parallel=tp_phase, spatial=space_phase,
                  kernels=kernels,
                  seconds=seconds)
    os.makedirs(args.log_dir, exist_ok=True)
    with open(os.path.join(args.log_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(f"all phases passed in {seconds:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
