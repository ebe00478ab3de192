#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: every hand-written kernel of the paths, from ``tpudet_torch/ops/
   csrc``, and the nvJPEG shim, one nvcc per source, all started
   together; the registers of each kernel (``cuobjdump -res-usage``) and
   the SASS instructions of its main loop per element (``cuobjdump
   -sass``); the CUDA context starts meanwhile, in a thread;
3. kernels: each kernel (mish forward and backward) against its plain
   PyTorch version on the card, in fp32, bf16 and fp16, at the largest
   shape of its path, at a ragged size and on special values, then timed
   against the plain version and the one PyTorch call that computes the
   same function; the letterbox kernel against its plain version, equal
   (every fixture's cv2 decode, a 1x1 source, an image at the canvas size
   and a failed decode into 640x640 and 416x320, uint8 and the server's
   float canvas), timed at the serving shape against the plain version,
   its byte bound and ``F.interpolate`` (not the same function);
4. inference: YOLOv4-l 640 (``configs/yolov4/yolov4l_coco_mosaic.py``,
   80 classes) built by the port's Config and builder, weights drawn from
   a seed in tpudet's layout (a torch generator on the card: tpudet's
   initializers, a fraction of numpy's time) and carried by
   ``flax_import``; a
   batch of 8 in bf16 through ``init_detector`` / ``Detector``; the launch
   counts of that one run; the card in fp32 against the same model on the
   CPU; bf16 against fp32; forward / decode / NMS / end-to-end times;
5. evaluation: 32 images in mixed sizes, made from the seed, through the
   port's ``CocoDataset`` (the config's test pipeline on the card),
   ``DetDataLoader`` and ``single_device_test`` at batch 8 in bf16, then
   ``coco_fast_bbox_eval``: the launch counts of that one run; the
   pipeline on the card against the CPU; the first batch in fp32 on the
   card against the CPU; the ground truth fed back as detections (map
   1.0); images/s over the whole flow and the per-stage ms of a batch;
6. training: the same config with ``compute_dtype='bfloat16'`` through
   ``init_trainer(...).step``: 3 optimizer steps of 72 images (6
   micro-batches of 12, fp32 master weights), the launch counts of every
   step, losses, step times, peak memory, the copies of an incoming
   gradient the backward wrapper had to make, then a profiled fourth
   step;
   one fp32 step (micro-batch 1, accumulation 2, 320^2, TF32 off) on the
   card against the same code on the CPU;
7. the training loop: ``train_detector`` on both train configs, bf16,
   2 micro-batches of 8 a step, data served from seeded arrays (a dataset subclass
   and an image-loading transform registered by this script, which
   serve images drawn from the seed without files): the host chain
   (``yolov4l_coco_mosaic.py``: Mosaic, affine chain, HSV, filter on the
   card through ``DetDataLoader``) for 3 steps across an epoch boundary,
   with a checkpoint and the EMA evaluation every epoch; a second call
   that resumes from the checkpoint (its state must equal the saved one)
   for a profiled 4th step; the device-aug config
   (``MosaicTileLoader``, ``device_mosaic_affine`` inside the step) for 2
   steps. Every step: 216 launches of each mish kernel, finite losses,
   params and EMA moved, its ms, the loader wait before it, peak memory.
   Then the host chain on the card against the CPU (geometry equal, HSV
   within 1 level on 99.9 % equal pixels) and its ms per image,
   ``device_mosaic_affine`` on the card against the CPU with the same
   draws (4 images, 640) and its ms per micro-batch, the checkpoint's
   save and load ms;
8. YOLOv5-l (``configs/yolov5/yolov5l_coco_mosaic.py``) at full width
   and depth: its weights drawn as in phase 4, written with
   ``save_variables`` (``CLASSES`` in the meta) and read back by path
   through ``init_detector(cfg, path)``; inference as in phase 4 (99
   launches per forward, one per BatchNorm site; fp32 against the CPU on
   1 image; the Focus stem's time); the test CLI
   (``tpudet_torch.tools.test.main``) over 16 seeded images served from
   arrays, its report against ``single_device_test`` +
   ``coco_fast_bbox_eval`` of the same weights; training as in phase 6
   (594 launches of each kernel per step, no copy of ``g``);
9. RetinaNet-R50-FPN (``configs/retinanet/retinanet_r50_fpn_1x_coco.py``,
   ResNet-50, FPN, RetinaHead) at full width and depth, no mish: inference
   bf16 at batch 8 on 1344^2 canvases through ``Detector`` (at least 4096
   candidates an image, forward / decode / NMS / e2e ms, device busy);
   fp32 on the card against the CPU on 1 image; the soft-NMS config,
   card against CPU; 3 bf16 ``init_trainer`` steps of 2 images at 1344;
   one fp32 step at 256, card against CPU, with the MaxIoU codes of its
   batch on both; ``train_detector`` on the shapes config (3 steps from
   seeded arrays, a checkpoint, the EMA evaluation), then the test CLI on
   its weights against the API. Every path: 0 mish launches;
10. serving: nvJPEG on every committed JPEG fixture against cv2's decode
   of it, within the limits of its chroma form, the truncated file
   refused; YOLOv4-l 640 (phase 4's weights written with
   ``save_variables``) behind ``ModelServer`` (bf16, batch 8, 10 ms batch
   delay, read back by path) and its HTTP front end on loopback: 256
   requests of the fixtures (half raw, half base64) from 16 client
   threads, every answer 200 and equal to a direct ``Detector`` call on
   the batch's canvases, 108 mish forward and 1 letterbox launch per
   batch, a truncated JPEG 400 and an unknown model 404; requests/s,
   latency, batch fill, decode and letterbox ms, a profiled batch, peak
   memory; then the fixtures as JPEG files through ``CocoDataset``
   (``LoadImageFromFile`` decoding on the card) -> ``DetDataLoader`` ->
   ``single_device_test``, each image after ``Resize`` against the same
   flow fed the committed cv2 decodes;
11. the two-stage family, no mish: Faster R-CNN R50-FPN
   (``configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py``, 80 classes) at
   full width and depth, weights drawn from the seed in tpudet's layout
   and carried by ``flax_import``: inference bf16 at batch 8 on 1344^2
   canvases through ``Detector`` (1000 proposals an image, finite
   detections; forward, RPN proposals, RoIAlign, bbox head, get_bboxes
   and e2e ms, device busy, RoIAlign's peak memory, beside phase 9's
   RetinaNet); fp32 on the card against the CPU on 1 image (the RPN's
   keeps, RoIAlign level codes, detections); ``rpn_r50_fpn_1x_coco.py``'s
   proposals and ``fast_rcnn_r50_fpn_1x_coco.py`` fed them, card against
   CPU; 3 bf16 ``init_trainer`` steps of 2 images at 1344 (the
   ``forward_train`` loss path) and one fp32 step at 256 card against
   CPU (sampled rois and labels, the four losses, the updated state);
   ``train_detector`` on the config for 3 steps from seeded arrays with a
   checkpoint, the EMA evaluation and a resumed 4th step, then the test
   CLI on its weights against the API. Every path: 0 mish launches;
12. Mask R-CNN R50-FPN (``configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py``,
   80 classes, 14 x 14 mask pooling, 28 x 28 masks) at full width and
   depth, no mish, weights as phase 11's with the mask logits redrawn:
   inference bf16 at batch 8 on 1344^2 canvases with each detection's
   mask pasted and RLE-encoded at 1333 x 800 on the card (e2e, bbox-only,
   forward, mask head, paste and RLE ms, device busy, peak memory); fp32
   on the card against the CPU on 1 image (detections, the matched
   masks' probabilities, the pasted pixels); seeded images with polygon
   gts through ``CocoDataset``, ``single_device_test(with_masks=True)``
   and ``coco_fast_segm_eval``, then the test CLI's ``--eval bbox segm``
   against the API; 3 bf16 ``init_trainer`` steps of 2 images at 1344
   with ``gt_frame_masks`` made by ``LoadAnnotations(with_mask=True)`` on
   the card, one fp32 step at 256 card against CPU; ``train_detector`` for
   2 steps and a resumed 3rd;
13. data-parallel training (``tpudet_torch/parallel``): (a) one fp32 step
   (TF32 off) of YOLOv4-l 640 on 2 micro-batches of 12 without a
   process group, then inside a one-rank NCCL group that the script
   opens, so that the synced path runs (SyncBN, the global loss
   counts, the flat gradient all-reduce): within phase 6's tolerance,
   the all-reduces counted; (b) two ranks on the one card, each a
   process, over gloo with CUDA tensors (6 images a micro-batch each,
   accumulation 2: the same micro-batches): the fp32 step within the
   same tolerance of (a)'s unsynced step, equal checksums, 216 launches
   of each mish kernel a rank, then bf16 steps timed ("gloo through the
   host on one card": step ms, the share in collectives, peak memory a
   rank); (c), in a thread, ``python -m tpudet_torch.tools.train`` with
   ``--num-processes 2`` for 1 step of the shapes recipe on the
   committed shapes set (only rank 0 writes ``latest_ema.msgpack``,
   which loads into the recipe's model; equal checksums), and beside it
   ``tpudet_torch.tools.test`` on the recipe's model drawn as in phase 4
   with 2 processes against 1 (equal reports). (c)'s processes and (b)'s
   ranks start first and run beside (a);
14. the other datasets, flip TTA, the image demo and the garbage
   recipe, YOLOv4-l 640 (phase 4's draw, BN statistics measured on the
   set as in phase 5): (a) the committed shapes val set written as VOC
   XML, a ``GarbageDataset`` json, a ``.circle`` folder and an LVIS json,
   every image through each dataset on the card bit-equal to
   ``CocoDataset``'s (and the same eval annotations), ``single_device_test``
   through ``VOCDataset`` equal to the one through ``CocoDataset``, then
   ``XMLDataset.evaluate`` mAP and recall; (b) flip TTA bf16 at batch 8
   (216 / 0 launches a batch), timed against the plain flow in turns,
   device busy, the merge NMS against the plain path's on candidates
   recorded from the flows; fp32 card vs CPU on 2 images (the merge's
   candidates in anchor order, the detections one-to-one); the test CLI
   with ``--tta --metrics bbox proposal_fast`` against the API; (c)
   ``image_demo.main`` in-process (108 / 0) and ``python -m
   tpudet_torch.demo.image_demo`` in a subprocess: the same lines, the
   same PNG, equal to the array that ``imshow_det_bboxes`` returned; (d)
   while that subprocess runs, ``train_detector`` on
   ``configs/garbage/yolov4l_garbage_mosaic.py`` over the shapes train
   set as a ``GarbageDataset`` json, 2 bf16 steps of 6 x 10 images (648 /
   648 launches a step), step ms and loader wait;
15. the exported program (``tpudet_torch/tools/export_program.py``,
   ``deployment_test.py``), YOLOv4-l 640 with phase 4's weights at batch
   8: (a) ``export_eval_artifact`` in fp32 and bf16 (``torch.export``:
   mish as the op ``tpudet::mish_fwd``, each NMS block walk a
   ``while_loop``; the bf16 one in a process beside the fp32 one),
   seconds and MB; (b) each ``.pt2`` loaded back: fp32
   (TF32 off, cuDNN deterministic) bit-equal to the live ``Detector`` on
   phase 4's batch and through ``single_device_test`` on the committed
   shapes val set, bf16 paired one-to-one; (c) an exported call: 108 / 0
   launches, 108 ``mish_fwd_kernel`` and no aten mish kernel under
   ``torch.profiler``; (d) ``python -m tpudet_torch.tools.
   deployment_test`` in a subprocess on the fp32 artifact (started once
   it is written, beside the bf16 export and (b)-(c)), its report equal
   to the test CLI's; (e) the exported call's ms and device busy
   against the live call's, the lane NMS's eager and ``while_loop``
   loops on recorded candidates;
16. ROADMAP.md's zoo rows a-c at full width and depth, no mish (0 / 0
   launches on every path), prediction layers redrawn from the seed:
   Cascade R-CNN R50-FPN (bf16 batch 8 on 1344^2, e2e ms and device
   busy; fp32 on the card against the CPU on 1 image of 640^2, the
   detections one-to-one; 2 bf16 steps of 2 images with peak memory;
   ``train_detector`` for 2 steps and the test CLI against the API); the
   GN+WS Faster R-CNN and the GN Mask R-CNN (one bf16 call of 8 on
   1344^2, 2 steps each); YOLOv3 Darknet-53 at 608 (bf16 batch 8 with e2e,
   forward, decode and NMS ms; 2 bf16 steps of 8; the test CLI; the fp32
   eval artifact bit-equal to the live call);
17. ROADMAP.md's zoo rows d, e and g at full width and depth, no mish
   (0 / 0 on every path), prediction layers, every DCN ``conv_offset``
   (fractional offsets of a few pixels, masks away from 0.5) and the
   attention's queries, keys, ``gamma`` and biases redrawn from the
   seed: the DCN Faster
   R-CNN R50 (bf16 batch 8 on 1344^2; fp32 on the card against the CPU on
   1 image of 640^2, detections one-to-one; 2 bf16 steps of 2; the
   deformable sampling's device ms at the path's own shapes, layer2's
   stride-2 block and a stride-1 block of each stage, and the 13 sites'
   summed ms against the call's device busy); the GCB Mask R-CNN r16
   (boxes at batch 8, 2 steps); the attention '1111' Faster R-CNN (batch
   8 with peak memory, fp32 card against CPU, its blocks on tpudet's init
   card against CPU (energies, top-2 gaps, output), 2 steps); SSD300
   (batch 8 on
   300^2, fp32 card against CPU, 2 steps, ``train_detector`` and the test
   CLI against the API) and SSD512 (batch 8 on 512^2); the RegNetX-3.2GF
   RetinaNet (batch 8 on 1344^2, 2 steps);
18. ROADMAP.md's zoo row f and row j's ATSS and VFNet at full width and
   depth, no mish (0 / 0 on every path), the prediction layers redrawn
   from the seed: GFL R50-FPN, ATSS R50-FPN, VFNet R50-FPN and LD (an
   R-18 student, the R-101 GFL teacher of its ``teacher_config``), each
   bf16 at batch 8 on 1344^2 (e2e, forward, decode and NMS ms, device
   busy, peak memory), fp32 on the card against the CPU on 1 image of
   640^2 (detections one-to-one, at least ATSS_MIN_PAIRS pairs), 2 bf16 steps of 2 (LD's fp32 teacher timed on the device
   within each); ``train_detector`` for 2 steps of LD; the test CLI on
   GFL against the API;
19. PAA (ROADMAP.md's row j) and zoo row h at full width and depth, no
   mish (0 / 0 on every path), the prediction layers and BFP's non-local
   block (``theta``, ``phi``, ``conv_out``) redrawn from the seed: PAA,
   the Libra RetinaNet (on 1408^2: its BFP needs integer level ratios),
   the Libra Faster R-CNN and the GRoIE Faster R-CNN, each bf16 at batch 8
   (e2e, forward, device busy, peak memory; decode and NMS ms, or the RoI
   extract's ms), fp32 on the card against the CPU on 1 image of 640^2;
   2 bf16 steps of 2 of those and of the GHM RetinaNet (PAA's positives
   and EM iterations a step); PAA's positive mask card against CPU on the
   same fp32 pred maps; the test CLI on PAA, ``train_detector`` on the
   Libra Faster R-CNN;
20. ROADMAP.md's zoo row i at full width and depth, no mish (0 / 0 on
   every path), the mask logits, YOLACT's heads and the zero-init leaves
   of SAC and RFP redrawn from the seed: Mask Scoring R-CNN, HTC, SCNet,
   PointRend, DetectoRS (SAC, RFP) and YOLACT, each bf16 at batch 8 on
   1344^2 with masks pasted and RLE'd at 1333 x 800 in the model's mask
   mode (PointRend's refine ms, YOLACT's fast NMS card equal to CPU, the
   SAC convs' share), fp32 on the card against the CPU on 1 image of
   640^2 (every mask mode's masks), 2 bf16 steps of 2; the test CLI
   ``--eval bbox segm`` on YOLACT;
21. ROADMAP.md's zoo row j's one-stage detectors at full width and depth,
   no mish (0 / 0 on every path), the prediction layers, NAS-FCOS's
   ``conv_offset``, the level scales and AutoAssign's prior redrawn from
   the seed: FCOS, NAS-FCOS, FoveaBox, AutoAssign, FSAF, FreeAnchor,
   YOLOF and the NAS-FPN RetinaNet (on 1280^2), each bf16 at batch 8 on
   1344^2 (e2e, forward, decode and NMS ms, device busy and kernels, peak
   memory; the GroupNorm share of AutoAssign and NAS-FCOS, NAS-FCOS's
   deformable sites), fp32 on the card against the CPU on 1 image of
   640^2 (at least ATSS_MIN_PAIRS pairs), 2 bf16 steps of 2 with peak
   memory (FSAF's and FreeAnchor's gradient clips from their configs);
   the test CLI on FCOS, ``train_detector`` on FSAF;
22. ROADMAP.md's zoo row j2a at full width and depth, no mish: RepPoints,
   SABL RetinaNet and Faster R-CNN, GA RetinaNet and Faster R-CNN, each
   bf16 at batch 8 on 1344^2 (decode and NMS or RPN proposal ms, the
   deformable and GroupNorm shares), fp32 on the card against the CPU on
   1 image of 640^2, 2 bf16 steps of 2; the test CLI on SABL RetinaNet,
   ``train_detector`` on GA Faster R-CNN;
23. ROADMAP.md's zoo row j2b at full width and depth, no mish:
   Double-Head R-CNN (its RoI bbox head's share of busy), Grid R-CNN
   (``refine_boxes`` ms on the call's detections; its refined boxes fp32
   card against CPU) and the Cascade RPN Faster R-CNN (proposal ms, the
   deformable share, peak memory), each bf16 at batch 8 on 1344^2, fp32
   on the card against the CPU on 1 image of 640^2, 2 bf16 steps of 2;
   the test CLI on Grid R-CNN, ``train_detector`` on the Cascade RPN
   Faster R-CNN; 2 bf16 steps each of Dynamic R-CNN and PISA, whose eval
   is Faster R-CNN's (a CPU test holds it bit for bit);
24. output: a ``kernels`` JSON line (with each kernel's share of its
   bound and its launches on every path), the whole run's seconds, the
   nvidia-smi line, and last ``{"ok": true, "device": {...}}``.

Phase 1 also prints which JPEG decoders (libjpeg, nvJPEG) the machine
holds. The script reads the fixtures from ``tests/torch_fixtures/jpeg``
and (phase 14) ``tests/torch_fixtures/shapes`` of the checkout.

Times come from CUDA events: warm-up, then the median of the timed runs.
Kernel times (and their plain and library counterparts) replay a CUDA
graph of the launches, so they hold device time only; end-to-end and step
times include the host.
"""
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

T_IMPORT = time.perf_counter()  # the script's clock: before torch's import

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, 'configs/yolov4/yolov4l_coco_mosaic.py')
SEED = 0
BATCH = 8
IMG = 640
MISH_PER_FORWARD = 108  # BN sites of YOLOv4-l, each followed by mish
# phase 8: YOLOv5-l, its weights read back by path from a msgpack whose
# meta names these classes; the fp32 card-vs-CPU check on 1 image; the
# test CLI over 16 seeded images, its report equal to the API's within
# REPORT_ATOL and its detection file's records within DET_ATOL (the same
# fp32 computation on the same card, so 0 is expected). The set's seed
# (SEED + 627) is one whose gts fall in all three scale buckets, so every
# value of the report is defined.
CONFIG_V5 = os.path.join(ROOT, 'configs/yolov5/yolov5l_coco_mosaic.py')
MISH_PER_FORWARD_V5 = 99  # BN sites of YOLOv5-l, each followed by mish
CHECKPOINT_CLASSES = ['rect', 'circle', 'triangle']
V5_FP32_IMAGES = 1
CLI_IMAGES = 16
CLI_SET_SEED = SEED + 627
REPORT_ATOL = 1e-6
DET_ATOL = 1e-4
# training: the config's samples_per_gpu 12, nominal batch 64 -> 6 micro-
# batches, 72 images per optimizer step; gts padded to the config's max_gts
TRAIN_STEPS = 3
MICRO_BATCH = 12
ACCUMULATION = 6
MAX_GTS = 120
# the fp32 card-vs-CPU step: micro-batch 1, accumulation 2 (the CPU's
# fp32 step of YOLOv4-l at 640 takes seconds an image)
CHECK_MICRO, CHECK_ACCUM, CHECK_IMG = 1, 2, 320

# phase 9: RetinaNet-R50-FPN (80 classes, strides 8-128, 9 anchors a cell):
# inference at batch 8 on 1344^2 canvases (the 1333x800 scale, padded to
# 32 and square, 338,454 anchors); the class logits of the random weights
# drawn N(RETINA_CLS_BIAS, RETINA_CLS_SPREAD^2), so that far more than
# RETINA_MIN_CANDIDATES (box, class) pairs an image clear score_thr 0.05
# and the nms_pre cap of 4096 binds (the blocked NMS, K > 1536); fp32 card
# vs CPU on 1 image, and the soft-NMS config; 3 bf16 train steps of 2
# images with up to RETINA_MAX_GTS gts; one fp32 step at 256 card vs CPU;
# train_detector on the shapes config for 3 steps of 8 images at 320 (24
# train, 8 val images from the seed), then the test CLI on its weights
CONFIG_RETINA = os.path.join(ROOT,
                             'configs/retinanet/retinanet_r50_fpn_1x_coco.py')
CONFIG_RETINA_SOFT = os.path.join(
    ROOT, 'configs/retinanet/retinanet_r50_fpn_softnms_1x_coco.py')
CONFIG_RETINA_SHAPES = os.path.join(
    ROOT, 'configs/shapes/retinanet_r50_shapes_320.py')
RETINA_IMG = 1344
RETINA_BATCH = 8
RETINA_FP32_IMAGES = 1
RETINA_MIN_CANDIDATES = 4096
RETINA_CLS_BIAS, RETINA_CLS_SPREAD, RETINA_REG_SPREAD = -4.0, 1.0, 0.3
RETINA_TRAIN_STEPS = 3
RETINA_TRAIN_BATCH = 2
RETINA_MAX_GTS = 120
RETINA_CHECK_IMG = 256
SHAPES_TRAIN_IMAGES, SHAPES_VAL_IMAGES, SHAPES_STEPS = 24, 8, 3

CONFIG_FRCNN = os.path.join(
    ROOT, 'configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py')
CONFIG_RPN = os.path.join(ROOT, 'configs/rpn/rpn_r50_fpn_1x_coco.py')
CONFIG_FAST = os.path.join(ROOT, 'configs/fast_rcnn/fast_rcnn_r50_fpn_1x_coco.py')
FRCNN_IMG, FRCNN_BATCH, FRCNN_FP32_IMAGES = 1344, 8, 1
FRCNN_PART_IMG = 640  # RPN and FastRCNN, card against CPU
FRCNN_RPN_CLS_SPREAD, FRCNN_RPN_REG_SPREAD = 2.0, 0.3
FRCNN_CLS_SPREAD, FRCNN_REG_SPREAD = 2.0, 1.0
FRCNN_TRAIN_STEPS, FRCNN_TRAIN_BATCH, FRCNN_CHECK_IMG = 3, 2, 256
FRCNN_LOSSES = ('loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'loss_bbox')
FRCNN_LOOP_IMAGES, FRCNN_LOOP_VAL_IMAGES, FRCNN_LOOP_STEPS = 6, 4, 3
# card against CPU in fp32: the share of proposals, detections or sampled
# roi slots allowed to differ (a score near-tie or an IoU at the NMS
# threshold flips under rounding), and, when a sampled slot differs, the
# losses' and the state's tolerances in place of STEP_LOSS_RTOL and
# STEP_TREE_TOL
FRCNN_KEEP_SHARE = 0.01
FRCNN_FLIP_LOSS_RTOL, FRCNN_FLIP_TREE_TOL = 5e-2, 0.5

# phase 12: Mask R-CNN R50-FPN (80 classes, 14 x 14 mask pooling, 28 x 28
# masks): inference bf16 at batch 8 on 1344^2 canvases, each detection
# pasted and RLE-encoded at 1333 x 800; the fp32 card against the CPU on
# 1 image; the segm evaluation and the test CLI; training
CONFIG_MRCNN = os.path.join(ROOT,
                            'configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py')
MRCNN_IMG, MRCNN_BATCH, MRCNN_FP32_IMAGES = 1344, 8, 1
MRCNN_ORI = (800, 1333, 3)
# conv_logits redrawn so that the mask logits spread by about this many
# units (tpudet's N(0, 0.001^2) puts every probability at 0.5 +- 1e-3)
MASK_LOGIT_SPREAD = 4.0
# fp32 card (TF32 off) against the CPU on the matched detections: the mask
# probabilities within MRCNN_PROB_ATOL; of the pasted pixels at most
# MRCNN_PIXEL_SHARE may differ, each only where the CPU's resampled
# probability lies within MRCNN_PIXEL_BAND of the threshold
MRCNN_PROB_ATOL, MRCNN_PIXEL_SHARE, MRCNN_PIXEL_BAND = 1e-3, 1e-4, 1e-3
MASK_THR = 0.5
MRCNN_EVAL_IMAGES = 8
MRCNN_LOSSES = FRCNN_LOSSES + ('loss_mask',)
MRCNN_LOOP_IMAGES, MRCNN_LOOP_VAL_IMAGES, MRCNN_LOOP_STEPS = 4, 2, 2

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# bytes: the least the card's memory moves in one access
SECTOR_BYTES = 32
# mish per element, the one-exp rational form: min, exp, add, mul, add,
# reciprocal, mul, times x
MISH_OPS_PER_ELEMENT = 8
# its gradient: the forward's t (7), x*u, u+1, mul, times 4, two times r,
# add t, times g
MISH_BWD_OPS_PER_ELEMENT = 15

# fp32: <= 2 ulp; bf16 / fp16: <= 1 ulp of the output type. The kernels
# and their plain versions take the same rounded fp32 steps and round once
# to the output type; they differ only where the card's expf and
# PyTorch's exp would. The backward is judged in ulps of the gradient's
# scale, max(|dx|, |g|): mish' crosses zero at x ~ -1.1924.
ULP_TOL = {'float32': 2, 'bfloat16': 1, 'float16': 1}
# at a main path's own bf16 inputs (normal draws, no special values) the
# kernels and their plain versions agree exactly: 0 ulp on YOLOv4-l's 108
# shapes and layouts on the H100
MAIN_PATH_ULP_TOL = 0
# card fp32 (TF32 off) against the CPU, per pred map: max |delta| <=
# 1e-3 * max |ref| (the two sum the convs in other orders)
FP32_PRED_TOL = 1e-3
# card bf16 against fp32 on the CPU, per pred map: bf16 keeps 8 bits of
# significand, and the rounding compounds through ~120 layers to a few
# percent of max |ref| on these random weights
BF16_PRED_TOL = 1e-1
# BatchNorm scale of the random weights. At 1 (tpudet's init) mish works
# far from its linear part and the random network is chaotic: a rounding
# difference at the stem doubles at every stage, and bf16 and fp32 pred
# maps differ by as much as they are large. At 0.25 the same rounding
# stays at a few percent, as in a trained network.
BN_SCALE = 0.25
# the evaluation set's letterbox puts flat canvas beside the image; at
# 0.25 the random network's response at those edges runs away (pred
# logits to 80, scores of exactly 1.0, boxes under 0.05 px wide, where
# IoU cannot tell a 0.005 px rounding from a miss); at 0.1 the logits
# stay within 8 spreads
EVAL_BN_SCALE = 0.1
MATCH_IOU = 0.99
# a box narrower or lower than 1 px matches one whose corners lie within
# this many px instead (IoU is ill-conditioned there)
MATCH_CORNER_PX = 0.02
# card fp32 (TF32 off) train step against the CPU: the loss to rtol 1e-4;
# params, BN statistics, EMA and momentum buffers within 5e-3 of the
# largest change the step made to them (sums run in other orders)
STEP_LOSS_RTOL = 1e-4
STEP_TREE_TOL = 5e-3
# evaluation: 32 images cycling through these (h, w), 2-6 gts each, one
# crowd gt and one gt of a category outside the 80 classes
EVAL_IMAGES = 32
EVAL_SIZES = [(480, 640), (640, 480), (720, 1280), (333, 500), (1280, 1280)]
EVAL_TIMED_RUNS = 2
EVAL_FP32_IMAGES = 4  # card against CPU, the CPU's share of the phase
# the test pipeline on the card against the CPU: the same integer ops, so
# 0 expected; at most 1 uint8 level after Normalize
PIPELINE_TOL = 1 / 255
# the training loop (train_detector): 32 training images and 8 val images
# in EVAL_SIZES, 2 steps of 16 per epoch (LOOP_ACCUMULATION micro-batches
# of LOOP_MICRO_BATCH: the loop's steps are host-bound, a micro-batch's
# launches cost more than its images, and phase 6 keeps the full 6 x 12
# step); the host chain runs 3 steps (so it crosses an epoch boundary),
# then resumes for a 4th; the device-aug config runs 2
LOOP_TRAIN_IMAGES = 32
LOOP_MICRO_BATCH, LOOP_ACCUMULATION = 8, 2
LOOP_VAL_IMAGES = 8
LOOP_STEPS = 3
DEVICE_AUG_STEPS = 2
# the host chain on the card against the CPU over this many images; its
# ms per image over HOST_TIMED_IMAGES; the HSV step rounds the same in
# both (cv2's arithmetic in torch ops), so equal is expected; the
# tolerance: 99.9 % of pixels equal, all within 1 uint8 level
HOST_CHECK_IMAGES = 4
HOST_TIMED_IMAGES = 8
HSV_EQUAL_SHARE = 0.999
# device_mosaic_affine card vs CPU: 4 images, image within 1e-4
# (normalized), boxes within 1e-3 px
DEVICE_AUG_CHECK = 4
AUG_IMG_TOL = 1e-4
AUG_BOX_TOL = 1e-3

# phase 10: serving. The committed JPEG fixtures (tpudet_torch/tools/
# jpeg_fixtures.py) and cv2's decode of each; nvJPEG against that decode
# per chroma form: (mean |delta| at most, a band of levels, the share of
# values within the band at least). PERF.md predicted 99 % within 8 levels
# on the 4:2:0 forms; the H100 measured 98.54 % on rgb_123x457.jpg and
# 98.72 % on rgb_96x128.jpg (nvJPEG's chroma upsampling at the shapes'
# edges, up to 41 levels), so the 4:2:0 assert stands at 98.5 %
FIXTURES = os.path.join(ROOT, 'tests/torch_fixtures/jpeg')
DECODE_LIMITS = {'444': (1.0, 2, 0.99), 'gray': (1.0, 2, 0.99),
                 '420': (2.0, 8, 0.985), 'progressive': (2.0, 8, 0.985),
                 'restart': (2.0, 8, 0.985)}
# the letterbox kernel against its plain version: every fixture into these
# (out_h, out_w) canvases, with a 1x1 source and an image at the canvas
# size; equal (0 levels, float canvas 0 ulp)
LETTERBOX_SIZES = [(640, 640), (416, 320)]
SERVE_NORM = (114.0, 255.0)  # tpudet's server: (RGB - 114) / 255
# the served run: requests of the fixtures, cycled, from client threads
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_DELAY_MS = 256, 16, 10.0


def log(*args):
    """Print a line headed by the seconds since the script was imported,
    in one write (phase 13 logs from two threads)."""
    sys.stdout.write(' '.join([f'[{time.perf_counter() - T_IMPORT:6.1f} s]']
                              + [str(a) for a in args]) + '\n')
    sys.stdout.flush()


def nvidia_smi():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# 16-byte vector of each element type, in elements
PER_VECTOR = {'BF16': 8, 'F16': 8, 'F32': 4}


def _kernel_name(mangled):
    """``mish_fwd_kernel<BF16>``, ``letterbox_kernel<float>`` and the
    like, from a mangled name."""
    lb = re.search(r'letterbox_kernelILb([01])E', mangled)
    if lb:
        out = 'float' if lb.group(1) == '1' else 'uint8'
        return f'letterbox_kernel<{out}>'
    kind = re.search(r'(mish_(?:fwd|bwd)_kernel)', mangled)
    if not kind:
        return mangled
    dtype = next((t for t in ('BF16', 'F16', 'F32') if t in mangled), '?')
    pitched = ', pitched' if 'Lb1E' in mangled else ''
    return f'{kind.group(1)}<{dtype}{pitched}>'


def res_usage(tool, library):
    """Registers, stack and local memory of every kernel function in
    ``library``, as ``cuobjdump -res-usage`` reports them."""
    proc = subprocess.run([tool, '-res-usage', str(library)],
                          capture_output=True, text=True, timeout=120,
                          check=True)
    out, func = {}, None
    for line in proc.stdout.splitlines():
        line = line.strip()
        if line.startswith('Function '):
            func = _kernel_name(line[len('Function '):].rstrip(':'))
        elif func and line.startswith('REG:'):
            f = dict(t.split(':', 1) for t in line.split() if ':' in t)
            out[func] = {'registers': int(f['REG']), 'stack': f.get('STACK'),
                         'local': f.get('LOCAL')}
            func = None
    return out


def sass(tool, library):
    """``cuobjdump -sass`` of ``library``."""
    return subprocess.run([tool, '-sass', str(library)], capture_output=True,
                          text=True, timeout=120, check=True).stdout


def sass_main_loops(tool, library):
    """The main loop of every kernel function in ``library``: of the
    loops in its SASS (a label and a later branch back to it), the one
    with the most 16-byte stores, then the longest. Its static
    instructions, per element (instructions over stores times elements a
    vector), and its MUFU operations, 16-byte loads and stores. Static
    counts: a slow path placed inside the loop's range counts, one
    called out of it does not."""
    funcs, name = {}, None
    for line in sass(tool, library).splitlines():
        m = re.match(r'\s*Function : (\S+)', line)
        if m:
            name = m.group(1)
            funcs[name] = ([], {})
            continue
        if name is None:
            continue
        ins, at = funcs[name]
        m = re.match(r'\s*(\.L_x_\d+):', line)
        if m:
            at[m.group(1)] = len(ins)
            continue
        m = re.match(r'\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;', line)
        if m:
            at[int(m.group(1), 16)] = len(ins)
            ins.append(m.group(2))
    out = {}
    for mangled, (ins, at) in funcs.items():
        loops = []
        for i, op in enumerate(ins):
            # a branch back to a label (.L_x_N) or an address (0x...)
            m = re.search(
                r'BRA(?:\.\w+)*\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))', op)
            if not m:
                continue
            start = at.get(m.group(1)) if m.group(1) else at.get(
                int(m.group(2), 16))
            if start is not None and start <= i:
                body = ins[start:i + 1]
                stores = sum('STG.E.128' in o for o in body)
                loops.append((stores, len(body), body))
        if not loops:
            continue
        stores, length, body = max(loops, key=lambda t: t[:2])
        key = _kernel_name(mangled)
        per = PER_VECTOR.get(key.split('<')[-1].split(',')[0].rstrip('>'))
        row = {'instructions': length, 'stores_128': stores,
               'loads_128': sum('LDG' in o and '.128' in o for o in body)}
        for op in ('EX2', 'RCP', 'LG2', 'TANH'):
            row[f'mufu_{op.lower()}'] = sum(f'MUFU.{op}' in o for o in body)
        if stores and per:
            row['per_element'] = length / (stores * per)
        out[key] = row
    return out


def kernel_resources(build, names):
    """Log the registers, stack and local memory of every kernel function
    in the built libraries (``cuobjdump -res-usage``) and the static SASS
    of each one's main loop (``cuobjdump -sass``)."""
    tool = os.path.join(os.path.dirname(build._nvcc()), 'cuobjdump')
    if not os.path.exists(tool):
        log('kernel resources: not measured (no cuobjdump beside nvcc)')
        return
    for name in names:
        lib = build.library_path(name)
        for func, res in res_usage(tool, lib).items():
            log(f'resources {func}: registers {res["registers"]}, stack '
                f'{res["stack"]}, local {res["local"]}')
        for func, loop in sass_main_loops(tool, lib).items():
            log(f'sass main loop {func}: ' + json.dumps(loop))


def cuda_ms(fn, warmup=3, runs=5):
    """Median ms of ``fn()`` over ``runs`` timed calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, runs=20):
    """Median ms of one replay of a CUDA graph of ``fn()``: the device
    time of its kernels without the host's launch gaps (a small launch
    takes the GPU less time than the Python wrapper takes the host)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # lazy initialisation stays out of the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, runs=runs)
    del graph
    torch.cuda.empty_cache()
    return ms


MANTISSA = {'float32': 23, 'float16': 10, 'bfloat16': 7}
MIN_EXP = {'float32': -126, 'float16': -14, 'bfloat16': -126}


def ulp_error(got, ref, dtype, scale=None):
    """max |got - ref| in ulps of ``dtype`` at ``max(|ref|, |scale|)`` over
    finite values; non-finite values must agree exactly. Returns (ulps,
    max abs err)."""
    import torch
    fin = torch.isfinite(ref)
    same = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
    if not bool(same[~fin].all()):
        raise AssertionError(f'{dtype}: non-finite outputs disagree')
    g, r = got[fin].double(), ref[fin].double()
    mag = r.abs()
    if scale is not None:
        mag = torch.maximum(mag, scale[fin].double().abs())
    mag = torch.clamp_min(mag, 2.0 ** MIN_EXP[dtype])
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - MANTISSA[dtype])
    diff = (g - r).abs()
    return float((diff / ulp).max()), float(diff.max())


def special_values(n, dtype, device):
    import torch
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(n, generator=gen, device=device) * 4
    # then either side of the threshold 20, mish's zero of slope, and the
    # range where u = e^x is subnormal
    sp = torch.tensor([0., -0., 8., -8., 20., -20., 88., -88., 1e4, -1e4,
                       float('inf'), float('-inf'), float('nan'), 19.99,
                       20.01, -1.1924, -87., -90., -100., -104.],
                      device=device)
    x[:len(sp)] = sp
    return x.to(dtype)


def check_mish_kernel(torch, mish):
    """Kernel vs plain on the card: three dtypes, the stem shape and a
    ragged size. Returns (max abs err, stem-shape times)."""
    worst_abs = 0.0
    stem = {}
    for name in ('float32', 'bfloat16', 'float16'):
        dtype = getattr(torch, name)
        # fp32 at a smaller stem-like shape: the same special values, the
        # path's own dtype (bf16) at full size
        big = ((BATCH, 32, IMG, IMG) if name != 'float32' else
               (2, 32, IMG // 2, IMG // 2))
        for shape in (big, (1000003,)):
            n = 1
            for s in shape:
                n *= s
            x = special_values(n, dtype, 'cuda').reshape(shape)
            got = mish.mish_cuda(x)
            ref = mish.mish_reference(x)
            torch.cuda.synchronize()
            ulps, err = ulp_error(got, ref, name)
            worst_abs = max(worst_abs, err)
            log(f'mish {name} {tuple(shape)}: {ulps:.3f} ulp '
                f'(tolerance {ULP_TOL[name]}), max abs err {err:.3e}')
            if ulps > ULP_TOL[name]:
                raise AssertionError(f'mish kernel {name} {shape}: {ulps} '
                                     f'ulp > {ULP_TOL[name]}')
            if len(shape) == 4:
                nbytes = 2 * x.numel() * x.element_size()
                stem[name] = dict(
                    ms=graph_ms(lambda: mish.mish_cuda(x)),
                    plain_ms=graph_ms(lambda: mish.mish_reference(x)),
                    library_ms=graph_ms(
                        lambda: torch.nn.functional.mish(x)),
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
                log(f'mish {name} stem shape: ' + json.dumps(stem[name]))
            del x, got, ref
    return worst_abs, stem


def check_mish_bwd_kernel(torch, mish):
    """Backward kernel vs plain on the card: three dtypes, the largest
    shape of the training path (a micro-batch of 12 at the stem,
    channels_last) and a ragged size, special values in x and in the
    incoming gradient g. Returns (max abs err, stem-shape times)."""
    worst_abs = 0.0
    stem = {}
    for name in ('float32', 'bfloat16', 'float16'):
        dtype = getattr(torch, name)
        for shape in ((MICRO_BATCH, 32, IMG, IMG), (1000003,)):
            n = 1
            for s in shape:
                n *= s
            x = special_values(n, dtype, 'cuda').reshape(shape)
            gen = torch.Generator(device='cuda').manual_seed(SEED + 1)
            g = torch.randn(n, generator=gen, device='cuda') + 1
            g[20:22] = torch.tensor([float('nan'), float('inf')])
            g = g.to(dtype).reshape(shape)
            if len(shape) == 4:
                x = x.contiguous(memory_format=torch.channels_last)
                g = g.contiguous(memory_format=torch.channels_last)
            got = mish.mish_backward_cuda(x, g)
            ref = mish.mish_backward_reference(x, g)
            torch.cuda.synchronize()
            ulps, err = ulp_error(got, ref, name, scale=g)
            worst_abs = max(worst_abs, err)
            log(f'mish_bwd {name} {tuple(shape)}: {ulps:.3f} ulp of the '
                f'gradient\'s scale (tolerance {ULP_TOL[name]}), max abs err '
                f'{err:.3e}')
            if ulps > ULP_TOL[name]:
                raise AssertionError(f'mish backward kernel {name} {shape}: '
                                     f'{ulps} ulp > {ULP_TOL[name]}')
            if len(shape) == 4:
                nbytes = 3 * x.numel() * x.element_size()
                stem[name] = dict(
                    ms=graph_ms(lambda: mish.mish_backward_cuda(x, g)),
                    plain_ms=graph_ms(
                        lambda: mish.mish_backward_reference(x, g)),
                    library_ms=graph_ms(
                        lambda: torch.ops.aten.mish_backward(g, x)),
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
                log(f'mish_bwd {name} stem shape: ' + json.dumps(stem[name]))
            del x, g, got, ref
            torch.cuda.empty_cache()
    return worst_abs, stem


def make_variables(torch, cfg, img, bn_scale=BN_SCALE):
    """tpudet variables for a YOLO config from a seed, in three
    steps:

    - tpudet's init, with every BatchNorm scale at ``bn_scale``;
    - BatchNorm statistics measured on ``img``, the smoke's own batch:
      tpudet's init leaves BN an identity and activations grow layer by
      layer, while statistics of other images let near-constant channels
      blow up;
    - the head's pred convs drawn wider. With tpudet's N(0, 0.01) pred
      convs and prior biases every score stays near 1e-5, under score_thr
      0.001; here the objectness and class logits spread by about 3 around
      the priors, so real detections flow through the NMS.
    """
    import numpy as np
    from torch import nn
    from tpudet_torch.models.builder import build_detector
    from tpudet_torch.utils.flax_import import (leaf_table,
                                                load_flax_variables,
                                                random_flax_variables)
    with torch.device('cuda'):
        model = build_detector(cfg['model'])
    tree = random_flax_variables(model, seed=SEED, device='cuda')
    for path, (key, _) in leaf_table(model).items():
        if path[-1] == 'scale':
            node = tree['params']
            for p in path[1:-1]:
                node = node[p]
            node['scale'] = np.full_like(node['scale'], bn_scale)
    load_flax_variables(model, tree)
    model.to('cuda', memory_format=torch.channels_last)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None  # cumulative: stats of this batch exactly
    feats = []
    hooks = [model.bbox_head.register_forward_pre_hook(
        lambda mod, args: feats.extend(args[0]))]
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(img).cuda())
    for h in hooks:
        h.remove()
    rng = np.random.RandomState(SEED + 2)
    sd = {k: v.detach().float().cpu().numpy()
          for k, v in model.state_dict().items()}
    for path, (key, is_kernel) in leaf_table(model).items():
        if path[0] == 'batch_stats':
            node = tree['batch_stats']
            for p in path[1:-1]:
                node = node[p]
            node[path[-1]] = sd[key]
    attrib = model.bbox_head.num_attrib
    for i, f in enumerate(feats):
        rms = float(f.float().pow(2).mean().sqrt())
        kernel = tree['params']['bbox_head'][f'conv_pred{i}']['kernel']
        # logit spread: 3 for objectness and classes, 0.5 for the box
        # (x, y, w, h), so that boxes keep sizes near their anchors'
        spread = np.where(np.arange(kernel.shape[3]) % attrib < 4, 0.5, 3.0)
        std = spread / (np.sqrt(kernel.shape[2]) * rms)
        tree['params']['bbox_head'][f'conv_pred{i}']['kernel'] = (
            rng.randn(*kernel.shape) * std).astype(np.float32)
    del model
    torch.cuda.empty_cache()
    return tree


def images(batch, seed):
    """Normalized images as tpudet's test pipeline makes them: pixels
    in [0, 255], (x - 114) / 255, (B, H, W, 3)."""
    import numpy as np
    px = np.random.RandomState(seed).randint(0, 256, (batch, IMG, IMG, 3))
    return ((px - 114.0) / 255.0).astype(np.float32)


def _iou(a, b):
    import numpy as np
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=-1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=-1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                              1e-6)


def detection_pairs(ref, got, image, iou_min):
    """Greedy one-to-one matching of ``got``'s valid detections to
    ``ref``'s on one image: same label, IoU >= iou_min. Returns the pairs
    as (ref slot, got slot)."""
    import numpy as np
    rv = np.nonzero(ref.valid[image].cpu().numpy())[0]
    gv = np.nonzero(got.valid[image].cpu().numpy())[0]
    if not (len(rv) and len(gv)):
        return []
    rb = ref.bboxes[image].float().cpu().numpy()[rv]
    gb = got.bboxes[image].float().cpu().numpy()[gv]
    rl = ref.labels[image].cpu().numpy()[rv]
    gl = got.labels[image].cpu().numpy()[gv]
    ok = (_iou(rb, gb) >= iou_min) & (rl[:, None] == gl[None, :])
    used = np.zeros(len(gv), bool)
    pairs = []
    for r in range(len(rv)):
        cand = np.nonzero(ok[r] & ~used)[0]
        if len(cand):
            used[cand[0]] = True
            pairs.append((int(rv[r]), int(gv[cand[0]])))
    return pairs


def match_detections(ref, got, image, iou_min):
    """``detection_pairs`` counted: (matched, n_ref, n_got, the largest
    box delta of the matches in px)."""
    pairs = detection_pairs(ref, got, image, iou_min)
    rb = ref.bboxes[image].float().cpu()
    gb = got.bboxes[image].float().cpu()
    gap = max([float((rb[r] - gb[g]).abs().max()) for r, g in pairs]
              or [0.0])
    return (len(pairs), int(ref.valid[image].sum()),
            int(got.valid[image].sum()), gap)


def pred_map_error(got, ref):
    """Per level, max |got - ref| / max |ref| (both moved to the CPU)."""
    return [float((g.float().cpu() - r.float().cpu()).abs().max()
                  / r.float().abs().max()) for g, r in zip(got, ref)]


def run_slice(torch, config=CONFIG, name='YOLOv4-l',
              sites=MISH_PER_FORWARD, fp32_images=1, weights_dir=None):
    """Inference of ``config`` at batch 8, bf16, through ``init_detector``
    / ``Detector``: its launch counts (every count at 0 just before the
    one call), the card in fp32 against the CPU on ``fp32_images``
    images, bf16 against fp32, times and a profile. The weights come from
    ``make_variables``; with ``weights_dir`` they are written there with
    ``save_variables`` (``CLASSES`` in the meta) and every detector reads
    them back by path. Returns (weights tree, launches, mish output
    shapes, weights path or None)."""
    from tpudet_torch.apis import init_detector
    from tpudet_torch.config import Config
    from tpudet_torch.core.nms import batched_class_lane_nms
    from tpudet_torch.models.layers import BatchNormAct, ConvModule
    from tpudet_torch.ops import mish
    from tpudet_torch.utils.checkpoint import save_variables

    cfg = Config.fromfile(config)
    img_np = images(BATCH, SEED + 1)
    t0 = time.perf_counter()
    tree = make_variables(torch, cfg, img_np)
    log(f'weights: seed {SEED} on the card, tpudet layout, '
        f'{time.perf_counter() - t0:.1f} s')
    path = None
    if weights_dir is not None:
        path = os.path.join(weights_dir, 'weights.msgpack')
        t0 = time.perf_counter()
        save_variables(path, tree, meta=dict(CLASSES=CHECKPOINT_CLASSES))
        log(f'weights written to a msgpack of '
            f'{os.path.getsize(path) / 2**20:.1f} MiB in '
            f'{time.perf_counter() - t0:.2f} s')

    def load(device, dtype):
        if path is None:
            return init_detector(cfg, variables=tree, device=device,
                                 dtype=dtype)
        return init_detector(cfg, path, device=device, dtype=dtype)

    det = load('cuda', torch.bfloat16)
    if path is not None:
        log(f'CLASSES read back from the checkpoint: {list(det.CLASSES)}')
        if list(det.CLASSES) != CHECKPOINT_CLASSES:
            raise AssertionError('CLASSES did not come from the checkpoint')
    n_params = sum(p.numel() for p in det.model.parameters())
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d)
               for m in det.model.modules())
    log(f'{name}: {n_params / 1e6:.2f} M parameters, {n_bn} BatchNorm '
        f'sites, bf16 on {torch.cuda.get_device_name(0)}')
    mish_shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: mish_shapes.append(tuple(out.shape)))
        for m in det.model.modules()
        if isinstance(m, (ConvModule, BatchNormAct)) and m.act is not None]
    img = torch.from_numpy(img_np).cuda()

    # the inference path, once, with every kernel count at 0 just before
    mish.mish_cuda.launches = 0
    mish.mish_backward_cuda.launches = 0
    res = det(img)
    torch.cuda.synchronize()
    launches = {'mish_fwd': mish.mish_cuda.launches,
                'mish_bwd': mish.mish_backward_cuda.launches}
    for h in hooks:
        h.remove()
    log(f'inference path launches: {json.dumps(launches)}')
    if launches['mish_bwd']:
        raise AssertionError('the inference path launched a backward')
    if not launches['mish_fwd'] == len(mish_shapes) == n_bn == sites:
        raise AssertionError(f'mish kernel launched {launches["mish_fwd"]} '
                             f'times in one forward, not {sites} (BN '
                             f'sites {n_bn})')
    shapes = {'bboxes': (BATCH, 300, 4), 'scores': (BATCH, 300),
              'labels': (BATCH, 300), 'valid': (BATCH, 300)}
    for k, want in shapes.items():
        t = getattr(res, k)
        if tuple(t.shape) != want:
            raise AssertionError(f'{k}: shape {tuple(t.shape)} != {want}')
    if not (torch.isfinite(res.bboxes).all() and
            torch.isfinite(res.scores).all()):
        raise AssertionError('non-finite detections')
    n_valid = [int(v) for v in res.valid.sum(1)]
    log(f'bf16 batch {BATCH}: valid detections per image {n_valid}')
    if sum(n_valid) == 0:
        raise AssertionError('no valid detection')

    # card fp32 (TF32 off) against the same model on the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f'fp32 reference: cudnn.allow_tf32='
        f'{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32='
        f'{torch.backends.cuda.matmul.allow_tf32}')
    det32 = load('cuda', torch.float32)
    cpu32 = load('cpu', torch.float32)
    few = img[:fp32_images]
    with torch.inference_mode():
        pm_ref = cpu32.model(few.cpu())
        res_ref = cpu32.model.get_bboxes(pm_ref)
        pm32 = det32.model(few)
        res32 = det32.model.get_bboxes(pm32)
    err32 = pred_map_error(pm32, pm_ref)
    log(f'fp32 card vs CPU pred maps over {fp32_images} images, '
        f'max|d|/max|ref| per level: {err32} (tolerance {FP32_PRED_TOL})')
    if max(err32) > FP32_PRED_TOL:
        raise AssertionError('fp32 card pred maps differ from the CPU')
    for i in range(fp32_images):
        matched, n_ref, n_got, _ = match_detections(res_ref, res32, i,
                                                 MATCH_IOU)
        log(f'fp32 card vs CPU detections, image {i}: {matched} matched of '
            f'{n_ref} / {n_got} (label and IoU >= {MATCH_IOU})')
        if not (matched == n_ref == n_got and n_ref > 0):
            raise AssertionError('fp32 card detections differ from the CPU')
    del det32
    torch.cuda.empty_cache()

    # bf16 card (the first images of the batch run) against fp32 on the CPU
    with torch.inference_mode():
        pm16 = [p[:fp32_images] for p in det.forward(img)]
    err16 = pred_map_error(pm16, pm_ref)
    m16, n_ref16, n_got16, _ = match_detections(res_ref, res, 0, 0.5)
    log(f'bf16 card vs fp32 CPU pred maps, max|d|/max|ref| per level: '
        f'{err16} (tolerance {BF16_PRED_TOL}); detections of image 0 '
        f'matched at IoU 0.5 and label: {m16} of {n_ref16} / {n_got16}')
    if max(err16) > BF16_PRED_TOL:
        raise AssertionError('bf16 pred maps too far from fp32')

    # times per batch of 8, bf16; everything warmed up first; the stem
    # (the first backbone module) alone, on the permuted bf16 batch the
    # forward gives it
    model = det.model
    cfg_t = dict(model.test_cfg)
    stem = getattr(model.backbone, model.backbone.stage_names[0][0])
    stem_in = img.to(torch.bfloat16).permute(0, 3, 1, 2)
    with torch.inference_mode():
        for _ in range(5):
            det(img)
        pm = model(img)
        bbox, scores = model.get_bboxes(pm, with_nms=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = {
            'stem_ms': cuda_ms(lambda: stem(stem_in), runs=5),
            'e2e_ms': cuda_ms(lambda: det(img), runs=5),
            'forward_ms': cuda_ms(lambda: model(img), runs=5),
            'decode_ms': cuda_ms(
                lambda: model.get_bboxes(pm, with_nms=False), runs=5),
            'nms_ms': cuda_ms(lambda: batched_class_lane_nms(
                bbox, scores, cfg_t['score_thr'],
                cfg_t['nms']['iou_threshold'], cfg_t['max_per_img'],
                lane_pre=cfg_t['lane_pre'], class_pre=cfg_t['class_pre']),
                runs=5),
        }
        t0 = time.perf_counter()
        model(img)
        times['forward_host_ms'] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    times['img_per_s'] = BATCH / times['e2e_ms'] * 1e3
    times['peak_mem_gib'] = torch.cuda.max_memory_allocated() / 2**30
    log(f'{name} bf16 batch {BATCH} x {IMG}^2: ' + json.dumps(times))
    with torch.inference_mode():
        prof = profile_device(torch, lambda: det(img), 'e2e call')
    if prof:
        log(f'{name} inference: device busy {prof[1]:.3f} ms per call of '
            f'{BATCH}')
    del det, model, cpu32, stem
    torch.cuda.empty_cache()
    return tree, launches, mish_shapes, path


def device_events(prof):
    """(name, start us, end us) of every device activity (kernels, copies,
    sets) that ``prof`` recorded, read from the profiler's own results:
    ``prof.events()`` first parses every record into Python objects, which
    took seconds a profile of ~10^4 kernels on the H100."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and
            not getattr(e, 'is_hidden_event', lambda: False)()]


def profile_device(torch, fn, label, calls=2, top=15):
    """torch.profiler over ``calls`` calls of ``fn``: the device's busy
    share of the wall time and the kernels that take it, by name. Returns
    (wall ms, device busy ms, device activities) per call, or None without
    device activity. Only the device's activity is traced: the busy share
    needs no host op event. The line logged gives the profile's own
    seconds beyond the calls."""
    from torch.profiler import ProfilerActivity, profile
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    kernels = device_events(prof)
    overhead_s = time.perf_counter() - t_prof - wall_ms * calls / 1e3
    if not kernels:
        log(f'profile {label}: the profiler recorded no device activity; '
            f'device busy share not measured')
        return None
    spans = sorted((a, b) for _, a, b in kernels)
    busy, end = 0.0, float('-inf')
    for a, b in spans:  # union of kernel intervals, us
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for name, a, b in kernels:
        t = by_name.setdefault(name, [0.0, 0])
        t[0] += (b - a) / 1e3 / calls
        t[1] += 1
    busy_ms = busy / 1e3 / calls
    log(f'profile per {label}: wall {wall_ms:.3f} ms, device busy '
        f'{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %), '
        f'{len(kernels) // calls} kernels; the profile\'s own {overhead_s:.1f} '
        f's')
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        log(f'  {ms:8.3f} ms  {n // calls:5d}x  {name[:100]}')
    return wall_ms, busy_ms, len(kernels) // calls


def eval_set(seed, n=EVAL_IMAGES, classes=None):
    """A set of ``n`` images from a numpy seed: (h, w, 3) BGR uint8 images
    of textured filled rectangles on a noise floor, and a COCO dict whose
    gts are the rectangles (categories 1-K named as ``classes``, COCO's 80
    by default, category 91 outside them). Image 0 holds a crowd gt, image
    1 a gt of category 91. Other classes change the categories only: the
    draws are the same."""
    import numpy as np
    from tpudet_torch.data import COCO_CLASSES
    classes = COCO_CLASSES if classes is None else classes
    rng = np.random.RandomState(seed)
    arrays, images, anns = {}, [], []
    for i in range(n):
        h, w = EVAL_SIZES[i % len(EVAL_SIZES)]
        img = rng.randint(60, 196, (h, w, 3)).astype(np.uint8)
        for j in range(rng.randint(2, 7)):
            bw = rng.randint(w // 16, w // 2)
            bh = rng.randint(h // 16, h // 2)
            x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
            img[y:y + bh, x:x + bw] = np.clip(
                rng.randint(0, 256, 3) + rng.randint(-24, 25, (bh, bw, 3)),
                0, 255)
            # the same draws for any classes: 1-80, folded onto K
            cat = 91 if (i, j) == (1, 0) else 1 + (
                int(rng.randint(1, 81)) - 1) % len(classes)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=cat, bbox=[x, y, bw, bh],
                             area=float(bw * bh),
                             iscrowd=int((i, j) == (0, 0))))
        arrays[i + 1] = img
        images.append(dict(id=i + 1, file_name=f'{i:04d}.jpg', width=w,
                           height=h))
    cats = [dict(id=k + 1, name=n) for k, n in enumerate(classes)]
    cats.append(dict(id=91, name='unicorn'))
    return arrays, dict(images=images, annotations=anns, categories=cats)


def array_dataset(cfg, arrays, coco, device, tmp, classes=None):
    """The port's ``CocoDataset`` (of ``classes``, COCO's by default) over
    images held in memory: each array goes into ``results['img']`` and the
    config's test pipeline runs from its second transform on, as
    ``inference_detector`` does for an array."""
    import numpy as np
    from tpudet_torch.data import CocoDataset

    class ArrayCocoDataset(CocoDataset):

        def __getitem__(self, idx):
            results = self.prepare_input(idx)
            img = arrays[self.data_infos[idx]['id']]
            results.update(
                img=img, img_shape=img.shape, ori_shape=img.shape,
                pad_shape=img.shape, scale_factor=np.ones(4, np.float32),
                img_fields=['img'], bbox_fields=[],
                filename=self.data_infos[idx]['filename'])
            for t in self.pipeline.transforms[1:]:
                results = t(results)
            return results

    path = os.path.join(tmp, f'ann_{len(coco["images"])}.json')
    with open(path, 'w') as f:
        json.dump(coco, f)
    test = cfg['data']['test']
    return ArrayCocoDataset(ann_file=path, pipeline=test['pipeline'],
                            classes=classes, test_mode=True, device=device)


def match_per_class(ref, got, iou_min, score_atol=None):
    """Greedy one-to-one matching of two images' per-class (n, 5) arrays
    within each class: IoU >= iou_min or, for a reference box under 1 px
    wide or high, corners within MATCH_CORNER_PX; given ``score_atol``,
    scores within it too. Returns (matched, n_ref, n_got, matched by
    corners)."""
    import numpy as np
    matched = n_ref = n_got = by_corner = 0
    for r, g in zip(ref, got):
        n_ref, n_got = n_ref + len(r), n_got + len(g)
        if not (len(r) and len(g)):
            continue
        by_iou = _iou(r[:, :4], g[:, :4]) >= iou_min
        thin = (r[:, 2:4] - r[:, :2]).min(1) < 1
        near = np.abs(r[:, None, :4] - g[None, :, :4]).max(-1) <= \
            MATCH_CORNER_PX
        ok = by_iou | (thin[:, None] & near)
        if score_atol is not None:
            ok &= np.abs(r[:, None, 4] - g[None, :, 4]) <= score_atol
        used = np.zeros(len(g), bool)
        for i in range(len(r)):
            cand = np.nonzero(ok[i] & ~used)[0]
            if len(cand):
                used[cand[0]] = True
                matched += 1
                by_corner += int(not by_iou[i, cand[0]])
    return matched, n_ref, n_got, by_corner


def check_eval_pipeline(torch, cfg, arrays, coco, tmp):
    """The test pipeline on the card against the same pipeline on the
    CPU, over the first batch's images."""
    import numpy as np
    card = array_dataset(cfg, arrays, coco, 'cuda', tmp)
    cpu = array_dataset(cfg, arrays, coco, 'cpu', tmp)
    worst = 0.0
    for i in range(BATCH):
        a, b = card[i], cpu[i]
        for k in ('img_shape', 'pad_shape'):
            if a[k] != b[k]:
                raise AssertionError(f'image {i}: {k} {a[k]} != {b[k]}')
        if not np.array_equal(a['scale_factor'], b['scale_factor']):
            raise AssertionError(f'image {i}: scale_factor differs')
        if a['img'].device.type != 'cuda':
            raise AssertionError('the pipeline did not run on the card')
        worst = max(worst, float((a['img'].cpu() - b['img']).abs().max()))
    log(f'test pipeline, card vs CPU over {BATCH} images: max |delta| '
        f'{worst:.3e} (tolerance {PIPELINE_TOL:.3e}, one uint8 level)')
    if worst > PIPELINE_TOL:
        raise AssertionError('the test pipeline on the card differs from '
                             'the CPU')
    return worst


def check_eval_fp32(torch, cfg, tree, arrays, coco, tmp):
    """The first EVAL_FP32_IMAGES images through ``single_device_test`` in
    fp32 on the card (TF32 off) and on the CPU: detections one-to-one per
    image and class at IoU >= MATCH_IOU."""
    from tpudet_torch.apis import init_detector, single_device_test
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    first = dict(coco, images=coco['images'][:EVAL_FP32_IMAGES])
    out = {}
    for device in ('cuda', 'cpu'):
        det = init_detector(cfg, variables=tree, device=device,
                            dtype=torch.float32)
        ds = array_dataset(cfg, arrays, first, device, tmp)
        t0 = time.perf_counter()
        out[device] = single_device_test(det.model, ds, batch_size=BATCH,
                                         img_size=IMG, progress=False)
        log(f'fp32 eval batch on {device}: '
            f'{time.perf_counter() - t0:.1f} s')
        del det
        torch.cuda.empty_cache()
    total = [0, 0, 0, 0]
    for i, (r, g) in enumerate(zip(out['cpu'], out['cuda'])):
        m = match_per_class(r, g, MATCH_IOU)
        total = [a + b for a, b in zip(total, m)]
        if not m[0] == m[1] == m[2]:
            raise AssertionError(f'fp32 eval image {i}: {m[0]} matched of '
                                 f'{m[1]} / {m[2]}')
    log(f'fp32 eval batch, card vs CPU: {total[0]} detections matched of '
        f'{total[1]} / {total[2]} (per class, IoU >= {MATCH_IOU}; '
        f'{total[3]} boxes under 1 px by corners within '
        f'{MATCH_CORNER_PX} px)')
    if total[1] == 0:
        raise AssertionError('no detection in the fp32 eval batch')


def eval_stage_times(torch, det, ds, arrays):
    """ms of each stage for the first batch of 8, each alone: the
    pipeline and collate (host clock to a synchronize, the copies
    included), the copy of the batch's uint8 images to the card (CUDA
    events), forward, decode and NMS (CUDA events), the per-class split
    (host clock; it waits for the NMS output)."""
    from tpudet_torch.apis import nms_result_to_per_class
    from tpudet_torch.core.nms import batched_class_lane_nms
    from tpudet_torch.data import DetDataLoader
    loader = DetDataLoader(ds, batch_size=BATCH, max_gts=1, img_size=IMG,
                           shuffle=False, drop_last=False)
    idx = list(range(BATCH))
    host = [arrays[ds.data_infos[i]['id']] for i in idx]

    def pipeline():
        loader._collate([ds[i] for i in idx])

    def host_ms(fn, runs=5):
        fn()
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    batch = loader._collate([ds[i] for i in idx])
    model, cfg_t = det.model, dict(det.model.test_cfg)
    img = batch['img']
    sf = torch.as_tensor(batch['scale_factor'], device='cuda')
    with torch.inference_mode():
        pm = model(img)
        bbox, scores = model.get_bboxes(pm, scale_factors=sf,
                                        with_nms=False)
        res = model.get_bboxes(pm, scale_factors=sf)
        times = {
            'pipeline_ms': host_ms(pipeline),
            'copy_ms': cuda_ms(lambda: [torch.from_numpy(a).to('cuda')
                                        for a in host], runs=5),
            'copy_bytes': sum(a.nbytes for a in host),
            'forward_ms': cuda_ms(lambda: model(img), runs=5),
            'decode_ms': cuda_ms(lambda: model.get_bboxes(
                pm, scale_factors=sf, with_nms=False), runs=5),
            'nms_ms': cuda_ms(lambda: batched_class_lane_nms(
                bbox, scores, cfg_t['score_thr'],
                cfg_t['nms']['iou_threshold'], cfg_t['max_per_img'],
                lane_pre=cfg_t['lane_pre'], class_pre=cfg_t['class_pre']),
                runs=5),
            'per_class_ms': host_ms(lambda: nms_result_to_per_class(
                res, model.bbox_head.num_classes)),
        }
    return times


def run_eval(torch):
    """YOLOv4-l 640 bf16 over the evaluation set: ``CocoDataset`` ->
    ``DetDataLoader`` -> ``single_device_test`` at batch 8 ->
    ``coco_fast_bbox_eval``, once with every kernel count at 0 just
    before; then the card-vs-CPU checks, the ground-truth check, timed
    runs of the whole flow, per-stage times and a profiled run. Returns
    the launches per batch.

    The weights are drawn as for the other phases, with the BatchNorm
    statistics measured on the set's first batch and the BatchNorm scale
    at ``EVAL_BN_SCALE``: statistics of random pixels leave these images'
    flat regions far outside the network's range (pred logits with a
    spread in the thousands, boxes of zero size, scores of 1.0)."""
    import tempfile

    import numpy as np
    from tpudet_torch.apis import init_detector, single_device_test
    from tpudet_torch.config import Config
    from tpudet_torch.data import DetDataLoader
    from tpudet_torch.evaluation import coco_fast_bbox_eval
    from tpudet_torch.ops import mish

    cfg = Config.fromfile(CONFIG)
    arrays, coco = eval_set(SEED + 300)
    n_gts = len(coco['annotations'])
    batches = -(-EVAL_IMAGES // BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        ds = array_dataset(cfg, arrays, coco, 'cuda', tmp)
        first = DetDataLoader(ds, batch_size=BATCH, img_size=IMG)._collate(
            [ds[i] for i in range(BATCH)])['img'].cpu().numpy()
        tree = make_variables(torch, cfg, first, bn_scale=EVAL_BN_SCALE)
        det = init_detector(cfg, variables=tree, device='cuda',
                            dtype=torch.bfloat16)
        log(f'evaluation set: {len(ds)} images, {n_gts} gts, sizes '
            f'{EVAL_SIZES} (h, w); {batches} batches of {BATCH}, bf16')

        # the flow once, every count at 0 just before
        mish.mish_cuda.launches = 0
        mish.mish_backward_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = single_device_test(det.model, ds, batch_size=BATCH,
                                     img_size=IMG, progress=False)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {'mish_fwd': mish.mish_cuda.launches,
                    'mish_bwd': mish.mish_backward_cuda.launches}
        log(f'eval flow launches over {batches} batches: '
            f'{json.dumps(launches)}')
        if launches != {'mish_fwd': batches * MISH_PER_FORWARD,
                        'mish_bwd': 0}:
            raise AssertionError(f'eval flow launches {launches}, not '
                                 f'{MISH_PER_FORWARD} forward per batch')
        if len(results) != EVAL_IMAGES:
            raise AssertionError(f'{len(results)} results, not '
                                 f'{EVAL_IMAGES}')
        n_det = n_flat = 0
        for per_cls in results:
            if len(per_cls) != 80:
                raise AssertionError('a result without 80 classes')
            for a in per_cls:
                if a.ndim != 2 or a.shape[1] != 5 or \
                        not np.isfinite(a).all():
                    raise AssertionError('a malformed or non-finite result')
                n_det += len(a)
                n_flat += int((np.prod(a[:, 2:4] - a[:, :2], 1) <= 0).sum())
        annos = [ds.get_ann_info_test(i) for i in range(len(ds))]
        t0 = time.perf_counter()
        report = coco_fast_bbox_eval(results, annos, classes=ds.CLASSES)
        eval_s = time.perf_counter() - t0
        log(f'fast-bbox on {n_det} detections, {n_flat} of them boxes of '
            f'no area ({eval_s:.3f} s, random weights): '
            + json.dumps(report))
        if not math.isfinite(report['map']):
            raise AssertionError('a non-finite map')

        # the ground truth fed back as detections
        gt_dets = []
        for a in annos:
            keep = ~a['gt_attrs']['ignore']
            gt_dets.append([np.concatenate(
                [a['gt_bboxes'][keep & (a['gt_labels'] == c)],
                 np.ones((int((keep & (a['gt_labels'] == c)).sum()), 1),
                         np.float32)], 1) for c in range(80)])
        gt_report = coco_fast_bbox_eval(gt_dets, annos, classes=ds.CLASSES)
        log('fast-bbox of the ground truth as detections: '
            + json.dumps(gt_report))
        if gt_report['map'] != 1.0:
            raise AssertionError('the ground truth does not give map 1.0')

        # timed runs of the whole flow, host included
        walls = []
        for _ in range(EVAL_TIMED_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            single_device_test(det.model, ds, batch_size=BATCH, img_size=IMG,
                               progress=False)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        log('eval flow, bf16 batch 8: ' + json.dumps(dict(
            first_run_s=first_s, timed_runs_s=walls,
            img_per_s=[EVAL_IMAGES / w for w in walls],
            eval_s=eval_s)))
        stages = eval_stage_times(torch, det, ds, arrays)
        log('eval batch stages (first batch, each alone): '
            + json.dumps(stages))
        prof = profile_device(
            torch, lambda: single_device_test(det.model, ds,
                                              batch_size=BATCH,
                                              img_size=IMG, progress=False),
            'eval run', calls=1, top=20)
        if prof:
            log(f'eval run: device busy {prof[1] / batches:.3f} ms per batch '
                f'of {BATCH}, wall {prof[0] / batches:.3f} ms per batch')
        del det, ds
        torch.cuda.empty_cache()

        check_eval_pipeline(torch, cfg, arrays, coco, tmp)
        check_eval_fp32(torch, cfg, tree, arrays, coco, tmp)
    return {k: v // batches for k, v in launches.items()}


def train_batch(n, seed, size=IMG):
    """A training batch from a numpy seed: ``n`` images of ``size``^2 random
    pixels,
    normalized as the train pipeline does, and 1-20 gts per image padded
    to MAX_GTS. Each gt takes the shape of one of the 9 anchors (level and
    anchor drawn uniformly) scaled by e^U(-0.7, 0.7) per side, so targets
    land on all three levels; labels 0-79."""
    import numpy as np
    from tpudet_torch.models.dense_heads.yolocsp_head import \
        DEFAULT_BASE_SIZES
    rng = np.random.RandomState(seed)
    px = rng.randint(0, 256, (n, size, size, 3), dtype=np.uint8)
    img = (px.astype(np.float32) - 114.0) / 255.0
    anchors = np.asarray(DEFAULT_BASE_SIZES, np.float32).reshape(-1, 2)
    boxes = np.zeros((n, MAX_GTS, 4), np.float32)
    valid = np.zeros((n, MAX_GTS), bool)
    for i in range(n):
        k = rng.randint(1, 21)
        wh = anchors[rng.randint(0, len(anchors), k)] * np.exp(
            rng.uniform(-0.7, 0.7, (k, 2)))
        wh = np.minimum(wh, size - 2.0)
        c = rng.uniform(wh / 2, size - wh / 2)
        boxes[i, :k] = np.concatenate([c - wh / 2, c + wh / 2], -1)
        valid[i, :k] = True
    labels = rng.randint(0, 80, (n, MAX_GTS)).astype(np.int64)
    return dict(img=img, gt_bboxes=boxes, gt_labels=labels, gt_valid=valid)


def tree_gap(a, b):
    """max |a - b| over the leaves of two nested dicts of arrays."""
    import numpy as np
    if isinstance(a, dict):
        return max([tree_gap(a[k], b[k]) for k in a] or [0.0])
    return float(np.abs(np.asarray(a, np.float64) -
                        np.asarray(b, np.float64)).max())


def record_gradient_layouts(torch, model, sites):
    """Hooks that append ``(shape, x strides, g strides)`` to ``sites`` for
    every mish output's incoming gradient ``g`` (the ``g`` its backward
    kernel reads; ``x`` shares the output's strides). Returns the module
    hooks, for removal."""
    from tpudet_torch.models.layers import BatchNormAct, ConvModule

    def hook(mod, args, out):
        if out.requires_grad:
            shape, stride = tuple(out.shape), out.stride()
            out.register_hook(
                lambda g: sites.append((shape, stride, g.stride())))
    return [m.register_forward_hook(hook) for m in model.modules()
            if isinstance(m, (ConvModule, BatchNormAct))
            and m.act is not None]


def run_training(torch, tree, config=CONFIG, name='YOLOv4-l',
                 mish_sites=MISH_PER_FORWARD):
    """``config`` at 640, full width and depth, bf16 compute with fp32
    master weights, through ``init_trainer(...).step``: TRAIN_STEPS
    optimizer steps of 72 images, each with its launch counts (every count
    set to 0 just before the step and read just after) and the copies of
    ``g`` the backward wrapper made, then one profiled step. The first
    step records the layouts of the gradients the backward kernel reads.
    Returns the launch counts of a step and the layouts of one
    micro-batch."""
    from tpudet_torch.apis import init_trainer
    from tpudet_torch.config import Config
    from tpudet_torch.ops import mish
    cfg = Config.fromfile(config)
    cfg['compute_dtype'] = 'bfloat16'
    trainer = init_trainer(cfg, variables=tree, device='cuda',
                           max_steps=TRAIN_STEPS + 1)
    if (trainer.accumulation, cfg['data']['samples_per_gpu']) != (
            ACCUMULATION, MICRO_BATCH):
        raise AssertionError(f'accumulation {trainer.accumulation} x '
                             f'{cfg["data"]["samples_per_gpu"]}, not '
                             f'{ACCUMULATION} x {MICRO_BATCH}')
    model = trainer.model
    if model.dtype != torch.bfloat16 or any(
            p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError('not bf16 compute with fp32 master weights')
    images = ACCUMULATION * MICRO_BATCH
    log(f'training: {name} {IMG}^2, {images} images per optimizer step '
        f'({ACCUMULATION} x {MICRO_BATCH}), bf16 compute, fp32 master '
        f'weights, warm-up {trainer.opt_cfg.warmup_iters} steps')
    p0 = {k: v.detach().clone() for k, v in trainer.state.params.items()}
    e0 = {k: v.clone() for k, v in trainer.state.ema_params.items()}
    per_step = []
    sites = []
    for step in range(TRAIN_STEPS):
        batch = train_batch(images, SEED + 100 + step)
        hooks = record_gradient_layouts(torch, model, sites) if step == 0 \
            else []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mish.mish_cuda.launches = 0
        mish.mish_backward_cuda.launches = 0
        mish.mish_backward_cuda.g_copies = 0
        mish.mish_backward_cuda.g_pitched = 0
        t0 = time.perf_counter()
        metrics = trainer.step(batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = {'mish_fwd': mish.mish_cuda.launches,
                    'mish_bwd': mish.mish_backward_cuda.launches}
        g_reads = {'g_copies': mish.mish_backward_cuda.g_copies,
                   'g_pitched': mish.mish_backward_cuda.g_pitched}
        for h in hooks:
            h.remove()
        m = {k: float(v) for k, v in metrics.items()}
        row = dict(step=step, **m, step_ms=step_s * 1e3,
                   img_per_s=images / step_s,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                   launches=launches, **g_reads)
        log(f'{name} train step: ' + json.dumps(row))
        per_step.append(row)
        want = ACCUMULATION * mish_sites
        if launches != {'mish_fwd': want, 'mish_bwd': want}:
            raise AssertionError(f'step {step}: launches {launches}, not '
                                 f'{want} each')
        if g_reads['g_copies']:
            raise AssertionError(f'step {step}: the backward copied g '
                                 f'{g_reads["g_copies"]} times')
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f'step {step}: non-finite {bad}')
    moved = max(float((trainer.state.params[k].detach() - v).abs().max())
                for k, v in p0.items())
    ema_moved = max(float((trainer.state.ema_params[k] - v).abs().max())
                    for k, v in e0.items())
    log(f'after {TRAIN_STEPS} steps: params moved by {moved:.3e}, EMA by '
        f'{ema_moved:.3e} (max |delta|)')
    if not (moved > 0 and ema_moved > 0):
        raise AssertionError('params or EMA did not move')
    batch = train_batch(images, SEED + 100 + TRAIN_STEPS)
    profile_device(torch, lambda: trainer.step(batch), f'{name} train step',
                   calls=1, top=25)
    del trainer, p0, e0
    torch.cuda.empty_cache()
    if len(sites) != want:
        raise AssertionError(f'{len(sites)} gradient layouts recorded in a '
                             f'step, not {want}')
    return per_step[-1]['launches'], sites[:mish_sites]


def fp32_step(torch, tree, cfg, batch, device='cuda'):
    """One fp32 optimizer step through ``init_trainer`` from ``tree``:
    ``(metrics, mish launches, state before, state after)``, states as
    tpudet's numpy trees."""
    from tpudet_torch.apis import init_trainer
    from tpudet_torch.ops import mish
    from tpudet_torch.utils.flax_import import train_state_to_flax
    trainer = init_trainer(cfg, variables=tree, device=device, max_steps=1)
    init = train_state_to_flax(trainer.state, trainer.model)
    torch.cuda.synchronize()
    mish.mish_cuda.launches = 0
    mish.mish_backward_cuda.launches = 0
    t0 = time.perf_counter()
    metrics = {k: float(v) for k, v in trainer.step(batch).items()}
    torch.cuda.synchronize()
    metrics['step_ms'] = (time.perf_counter() - t0) * 1e3
    launches = {'mish_fwd': mish.mish_cuda.launches,
                'mish_bwd': mish.mish_backward_cuda.launches}
    state = train_state_to_flax(trainer.state, trainer.model)
    del trainer
    torch.cuda.empty_cache()
    return metrics, launches, init, state


STATE_PARTS = ('params', 'batch_stats', 'ema_params', 'ema_batch_stats',
               'momentum_buf')


def _part(state, name):
    return state.opt_state.momentum_buf if name == 'momentum_buf' \
        else getattr(state, name)


def check_step_against(label, metrics, state, ref_metrics, ref_state, init):
    """Phase 6's card tolerance: the loss to STEP_LOSS_RTOL, every part
    of the state within STEP_TREE_TOL of the update the reference step
    made to it."""
    rel = abs(metrics['loss'] - ref_metrics['loss']) / abs(
        ref_metrics['loss'])
    log(f'{label}: loss {metrics["loss"]:.6f} vs {ref_metrics["loss"]:.6f} '
        f'(rel {rel:.3e}, tolerance {STEP_LOSS_RTOL}), grad_norm '
        f'{metrics["grad_norm"]:.6f} vs {ref_metrics["grad_norm"]:.6f}, '
        f'step ms {metrics["step_ms"]:.1f} vs {ref_metrics["step_ms"]:.1f}')
    if not rel <= STEP_LOSS_RTOL:
        raise AssertionError(f'{label}: the loss differs')
    gaps = {}
    for name in STATE_PARTS:
        got, ref, start = (_part(s, name) for s in (state, ref_state, init))
        diff, upd = tree_gap(got, ref), tree_gap(ref, start)
        gaps[name] = diff / upd
        if not (upd > 0 and diff <= STEP_TREE_TOL * upd):
            raise AssertionError(f'{label} {name}: max |delta| {diff:.3e}, '
                                 f'update {upd:.3e}')
    log(f'{label}: state within ' + json.dumps(
        {k: f'{v:.2e}' for k, v in gaps.items()}) + f' of the update '
        f'(tolerance {STEP_TREE_TOL})')


def check_train_step_cpu(torch, tree, config=CONFIG):
    """One fp32 optimizer step (CHECK_MICRO x CHECK_ACCUM) of
    ``config`` at CHECK_IMG through ``init_trainer`` on the card (TF32 off)
    and on the CPU, from the same variables and batch."""
    from tpudet_torch.config import Config
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.fromfile(config)
    cfg['data'] = dict(cfg['data'], samples_per_gpu=CHECK_MICRO)
    cfg['nominal_batch_size'] = CHECK_MICRO * CHECK_ACCUM
    batch = train_batch(CHECK_MICRO * CHECK_ACCUM, SEED + 200, CHECK_IMG)
    mc, _, init, sc = fp32_step(torch, tree, cfg, batch, 'cuda')
    mr, _, _, sr = fp32_step(torch, tree, cfg, batch, 'cpu')
    log('fp32 step on the card: ' + json.dumps(mc))
    check_step_against('fp32 step, card vs CPU', mc, sc, mr, sr, init)


def draw_strided(torch, gen, shape, stride):
    """bf16 normal draws laid out at ``stride`` (a channel slice of a
    concat's gradient keeps the concat's pitch)."""
    span = 1 + sum((n - 1) * s for n, s in zip(shape, stride))
    return torch.randn(span, generator=gen, device='cuda').to(
        torch.bfloat16).as_strided(shape, stride)


def main_path_fwd_err(mish, x, label):
    """The forward kernel against its plain version on one main-path
    input; fails past MAIN_PATH_ULP_TOL. Returns the max abs err."""
    ulps, err = ulp_error(mish.mish_cuda(x).float(),
                          mish.mish_reference(x).float(), 'bfloat16')
    if ulps > MAIN_PATH_ULP_TOL:
        raise AssertionError(f'mish kernel at {label} {tuple(x.shape)}: '
                             f'{ulps} ulp > {MAIN_PATH_ULP_TOL}')
    return err


def main_path_bwd_err(mish, x, g, label):
    """The backward kernel against its plain version on one main-path
    layout, in ulps of the gradient's scale; fails past
    MAIN_PATH_ULP_TOL. Returns the max abs err."""
    ulps, err = ulp_error(mish.mish_backward_cuda(x, g).float(),
                          mish.mish_backward_reference(x, g).float(),
                          'bfloat16', scale=g.float())
    if ulps > MAIN_PATH_ULP_TOL:
        raise AssertionError(f'mish backward kernel at {label} '
                             f'{tuple(x.shape)}, g strides {g.stride()}: '
                             f'{ulps} ulp > {MAIN_PATH_ULP_TOL}')
    return err


def check_mish_main_path(torch, mish, shapes, sites, label):
    """Both kernels against their plain versions at a main path's own
    inputs, one site at a time: the forward on the bf16 channels_last
    output shapes of one inference call (``shapes``), the backward on the
    (shape, x strides, g strides) layouts of one training micro-batch
    (``sites``), pitched g included. Returns the max abs err of each."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 4)
    fwd = max(main_path_fwd_err(mish, torch.randn(
        s, generator=gen, device='cuda').to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last), label) for s in shapes)
    mish.mish_backward_cuda.g_copies = 0
    mish.mish_backward_cuda.g_pitched = 0
    bwd = max(main_path_bwd_err(mish, draw_strided(torch, gen, shape, xst),
                                draw_strided(torch, gen, shape, gst), label)
              for shape, xst, gst in sites)
    pitched = mish.mish_backward_cuda.g_pitched
    copies = mish.mish_backward_cuda.g_copies
    log(f'{label} kernels against plain at the main path\'s inputs: '
        f'mish_fwd over {len(shapes)} shapes, max abs err {fwd:.3e}; '
        f'mish_bwd over {len(sites)} layouts ({pitched} with g at a pitch, '
        f'{copies} copied), max abs err {bwd:.3e} (tolerance '
        f'{MAIN_PATH_ULP_TOL} ulp)')
    if copies:
        raise AssertionError(f'{label}: the backward copied g {copies} times')
    torch.cuda.empty_cache()
    return {'mish_fwd': fwd, 'mish_bwd': bwd}


def time_mish_bwd_main_path(torch, mish, sites):
    """The backward kernel over the 108 sites of one bf16 micro-batch of
    12, x and g in the layouts the training step gave them (``sites``:
    shape, x strides, g strides): kernel, plain version and
    ``aten.mish_backward``, each as one CUDA graph of 108 launches; bound
    from bytes and operations."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 3)
    xs = [draw_strided(torch, gen, shape, xst) for shape, xst, _ in sites]
    gs = [draw_strided(torch, gen, shape, gst) for shape, _, gst in sites]
    n = sum(x.numel() for x in xs)
    bytes_ms = 3 * n * 2 / HBM_BYTES_PER_S * 1e3
    ops_ms = n * MISH_BWD_OPS_PER_ELEMENT / FP32_FLOPS * 1e3
    errs = [main_path_bwd_err(mish, x, g, 'YOLOv4-l')
            for x, g in zip(xs, gs)]

    def over_all(fn):
        return lambda: [fn(x, g) for x, g in zip(xs, gs)]

    out = dict(
        elements=n, max_abs_err=max(errs),
        ms=graph_ms(over_all(mish.mish_backward_cuda)),
        plain_ms=graph_ms(over_all(mish.mish_backward_reference)),
        library_ms=graph_ms(over_all(
            lambda x, g: torch.ops.aten.mish_backward(g, x))),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by='bytes' if bytes_ms >= ops_ms else 'operations')
    log(f'mish_bwd over one bf16 micro-batch of {MICRO_BATCH} (108 '
        f'launches): ' + json.dumps(out))
    del xs, gs
    torch.cuda.empty_cache()
    return out


def time_mish_main_path(torch, mish, shapes):
    """The mish kernel over the 108 shapes of one bf16 forward at batch
    8 (channels_last, as the main path lays them out): kernel, plain
    version and F.mish, each as one CUDA graph of 108 launches; bound
    from bytes and operations."""
    xs = [torch.randn(s, device='cuda', dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last) for s in shapes]
    n = sum(x.numel() for x in xs)
    bytes_ms = 2 * n * 2 / HBM_BYTES_PER_S * 1e3
    ops_ms = n * MISH_OPS_PER_ELEMENT / FP32_FLOPS * 1e3
    errs = [main_path_fwd_err(mish, x, 'YOLOv4-l') for x in xs]

    def over_all(fn):
        return lambda: [fn(x) for x in xs]

    out = dict(
        elements=n, max_abs_err=max(errs),
        ms=graph_ms(over_all(mish.mish_cuda)),
        plain_ms=graph_ms(over_all(mish.mish_reference)),
        library_ms=graph_ms(over_all(torch.nn.functional.mish)),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by='bytes' if bytes_ms >= ops_ms else 'operations')
    log('mish over one bf16 forward (108 launches): ' + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# 8. the training loop: train_detector on both train configs


def register_array_data():
    """Register, in the port's registries, a ``CocoDataset`` whose images
    are arrays in ``ARRAYS[ann_file]`` (by image id) and a transform that
    takes the place of ``LoadImageFromFile`` for them: the card's machine
    has no image decoder. The package itself gains no such feature."""
    import numpy as np
    from tpudet_torch.data import CocoDataset
    from tpudet_torch.registry import DATASETS, PIPELINES

    class ArrayCocoDataset(CocoDataset):

        def prepare_input(self, idx):
            results = super().prepare_input(idx)
            results['img_array'] = ARRAYS[self.ann_file][
                self.data_infos[idx]['id']]
            return results

    class LoadImageFromArray:

        def __init__(self, **kwargs):
            pass

        def __call__(self, results):
            img = results.pop('img_array')
            results.update(
                filename=results['img_info']['filename'],
                ori_filename=results['img_info']['filename'], img=img,
                img_shape=img.shape, ori_shape=img.shape, pad_shape=img.shape,
                scale_factor=np.ones(4, np.float32), img_fields=['img'],
                bbox_fields=[])
            return results

    DATASETS.register_module(module=ArrayCocoDataset, force=True)
    PIPELINES.register_module(module=LoadImageFromArray, force=True)


ARRAYS = {}  # ann_file -> {image id: BGR uint8 array}


def _from_arrays(pipeline):
    """``pipeline`` with every ``LoadImageFromFile`` replaced by
    ``LoadImageFromArray``, nested pipelines included."""
    out = []
    for t in pipeline:
        t = dict(t)
        if t['type'] == 'LoadImageFromFile':
            t = dict(type='LoadImageFromArray')
        for k in ('individual_pipeline', 'transforms'):
            if k in t:
                t[k] = _from_arrays(t[k])
        out.append(t)
    return out


def loop_config(config, tmp):
    """The config with its train and val sets made from the seed
    (``eval_set``: LOOP_TRAIN_IMAGES and LOOP_VAL_IMAGES images in mixed
    sizes) and served from arrays; bf16 compute, a checkpoint, an
    evaluation and a log line every epoch."""
    from tpudet_torch.config import Config
    cfg = Config.fromfile(config)
    sets = {}
    for name, seed, n in (('train', SEED + 400, LOOP_TRAIN_IMAGES),
                          ('val', SEED + 500, LOOP_VAL_IMAGES)):
        arrays, coco = eval_set(seed, n)
        path = os.path.join(tmp, f'{name}.json')
        with open(path, 'w') as f:
            json.dump(coco, f)
        ARRAYS[path] = arrays
        sets[name] = path
    data = cfg['data']
    cfg['data'] = dict(
        data,
        train=dict(type='ArrayCocoDataset', ann_file=sets['train'],
                   pipeline=_from_arrays(data['train']['pipeline'])),
        val=dict(type='ArrayCocoDataset', ann_file=sets['val'],
                 pipeline=_from_arrays(data['val']['pipeline']),
                 test_mode=True))
    cfg['data']['samples_per_gpu'] = LOOP_MICRO_BATCH
    cfg['nominal_batch_size'] = LOOP_ACCUMULATION * LOOP_MICRO_BATCH
    cfg['compute_dtype'] = 'bfloat16'
    cfg['checkpoint_config'] = dict(interval=1)
    cfg['evaluation'] = dict(interval=1, metric='fast-bbox')
    cfg['log_config'] = dict(interval=1)
    return cfg


class LoopProbe:
    """Instruments ``train_detector`` while it runs: ``Trainer.step`` is
    wrapped to set every kernel count to 0 just before the step and read
    it just after (a synchronize at both ends), with the step's wall time,
    peak memory, metrics and how far params and EMA moved; the loaders'
    iterators are wrapped to time each wait for a batch. Steps whose
    number is in ``profile_at`` run under ``profile_device``. With
    ``record_start``, the first step of each trainer records its state as
    it starts (``train_state_to_flax``)."""

    def __init__(self, torch, profile_at=(), record_start=False):
        from tpudet_torch.apis import train as train_mod
        from tpudet_torch.data import loader as loader_mod
        self.torch, self.profile_at = torch, set(profile_at)
        self.record_start = record_start
        self.train_mod, self.loader_mod = train_mod, loader_mod
        self.rows, self.waits, self.trainers = [], [], []
        self.start_states = []

    def __enter__(self):
        probe, torch = self, self.torch
        from tpudet_torch.ops import mish
        from tpudet_torch.utils.flax_import import train_state_to_flax
        trainer_cls = self.train_mod.Trainer
        self.saved = [(trainer_cls, 'step', trainer_cls.step)]
        orig_step = trainer_cls.step

        def step(trainer, batch):
            if trainer not in probe.trainers:
                probe.trainers.append(trainer)
                if probe.record_start:
                    probe.start_states.append(train_state_to_flax(
                        trainer.state, trainer.model))
            number = int(trainer.state.step) + 1
            p0 = [v.detach().clone() for v in trainer.state.params.values()]
            e0 = [v.clone() for v in trainer.state.ema_params.values()]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mish.mish_cuda.launches = 0
            mish.mish_backward_cuda.launches = 0
            out = []
            t0 = time.perf_counter()
            prof = None
            if number in probe.profile_at:
                prof = profile_device(
                    torch, lambda: out.append(orig_step(trainer, batch)),
                    f'train_detector step {number}', calls=1, top=25)
            else:
                out.append(orig_step(trainer, batch))
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            launches = {'mish_fwd': mish.mish_cuda.launches,
                        'mish_bwd': mish.mish_backward_cuda.launches}
            moved = max(float((v.detach() - a).abs().max()) for v, a in zip(
                trainer.state.params.values(), p0))
            ema_moved = max(float((v - a).abs().max()) for v, a in zip(
                trainer.state.ema_params.values(), e0))
            row = dict(step=number, **{k: float(v) for k, v in
                                       out[0].items()},
                       step_ms=step_ms,
                       profiled=number in probe.profile_at,
                       loader_wait_ms=probe.waits[-1] if probe.waits
                       else None,
                       peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                       launches=launches, params_moved=moved,
                       ema_moved=ema_moved)
            if prof:
                row['device_busy_ms'], row['profiled_wall_ms'] = prof[1], \
                    prof[0]
            log('train_detector step: ' + json.dumps(row))
            probe.rows.append(row)
            return out[0]

        trainer_cls.step = step
        for cls in (self.loader_mod.DetDataLoader,
                    self.loader_mod.MosaicTileLoader):
            orig = cls.__dict__['__iter__']
            self.saved.append((cls, '__iter__', orig))
            cls.__iter__ = self._timed(orig)
        return self

    def _timed(self, orig):
        waits = self.waits

        def iterate(loader):
            inner = orig(loader)
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(inner)
                    except StopIteration:
                        return
                    waits.append((time.perf_counter() - t0) * 1e3)
                    yield batch
            finally:
                inner.close()
        return iterate

    def __exit__(self, *exc):
        for cls, name, orig in self.saved:
            setattr(cls, name, orig)
        return False


def check_loop_rows(rows, want_steps, accumulation=LOOP_ACCUMULATION):
    """Every step launched each mish kernel ``accumulation`` x 108 times,
    kept its losses finite and moved the params and the EMA."""
    want = accumulation * MISH_PER_FORWARD
    if [r['step'] for r in rows] != want_steps:
        raise AssertionError(f'steps {[r["step"] for r in rows]}, not '
                             f'{want_steps}')
    for r in rows:
        if r['launches'] != {'mish_fwd': want, 'mish_bwd': want}:
            raise AssertionError(f'step {r["step"]}: launches '
                                 f'{r["launches"]}, not {want} each')
        bad = [k for k in ('loss', 'loss_cls', 'loss_conf', 'loss_bbox',
                           'grad_norm') if not math.isfinite(r[k])]
        if bad:
            raise AssertionError(f'step {r["step"]}: non-finite {bad}')
        if not (r['params_moved'] > 0 and r['ema_moved'] > 0):
            raise AssertionError(f'step {r["step"]}: params or EMA did not '
                                 f'move')


def loop_summary(rows, images_per_step):
    """Step ms, loader wait and images/s over the steps that ran without
    the profiler."""
    timed = [r for r in rows if not r['profiled']]
    wall_s = sum(r['step_ms'] + (r['loader_wait_ms'] or 0)
                 for r in timed) / 1e3
    return dict(
        steps=len(timed), step_ms=[r['step_ms'] for r in timed],
        loader_wait_ms=[r['loader_wait_ms'] for r in timed],
        img_per_s=len(timed) * images_per_step / wall_s,
        img_per_s_in_steps=len(timed) * images_per_step / sum(
            r['step_ms'] for r in timed) * 1e3,
        peak_mem_gib=max(r['peak_mem_gib'] for r in rows),
        device_busy_ms=[r['device_busy_ms'] for r in rows
                        if 'device_busy_ms' in r],
        profiled_wall_ms=[r['profiled_wall_ms'] for r in rows
                          if 'profiled_wall_ms' in r])


def check_host_chain(torch, cfg):
    """The host train chain (the config's train pipeline) on the card
    against the same code on the CPU, both datasets' generators seeded
    alike: geometry exact (the chain without its HSV step: image bytes and
    boxes equal), the whole chain within the HSV tolerance. Then its ms
    per image on the card."""
    import numpy as np
    from tpudet_torch.data import build_dataset
    train = cfg['data']['train']
    no_hsv = dict(train, pipeline=[
        t for t in train['pipeline']
        if t['type'] != 'HueSaturationValueJitter'])
    worst = {}
    for name, ds_cfg in (('geometry', no_hsv), ('with_hsv', train)):
        card, cpu = (build_dataset(ds_cfg, dict(device=d))
                     for d in ('cuda', 'cpu'))
        card.set_rng_seed(SEED)
        cpu.set_rng_seed(SEED)
        diff_max, equal, n_px = 0.0, 0, 0
        for i in range(HOST_CHECK_IMAGES):
            a, b = card[i], cpu[i]
            if a['img'].device.type != 'cuda':
                raise AssertionError('the train chain did not run on the '
                                     'card')
            if not (np.array_equal(a['gt_bboxes'], b['gt_bboxes']) and
                    np.array_equal(a['gt_labels'], b['gt_labels'])):
                raise AssertionError(f'{name} image {i}: boxes differ')
            d = (a['img'].cpu() - b['img']).abs()
            diff_max = max(diff_max, float(d.max()))
            equal += int((d == 0).all(-1).sum())
            n_px += d.shape[0] * d.shape[1]
        worst[name] = dict(max_abs=diff_max, equal_share=equal / n_px)
    log(f'host train chain, card vs CPU over {HOST_CHECK_IMAGES} images: '
        + json.dumps(worst) + ' (geometry: equal; with HSV: max 1/255, '
        f'{HSV_EQUAL_SHARE} equal)')
    if worst['geometry']['max_abs'] != 0.0:
        raise AssertionError('the train chain\'s geometry differs on the '
                             'card')
    if worst['with_hsv']['max_abs'] > (1 + 1e-6) / 255 or \
            worst['with_hsv']['equal_share'] < HSV_EQUAL_SHARE:
        raise AssertionError('the train chain\'s HSV step differs on the '
                             'card')
    card = build_dataset(train, dict(device='cuda'))
    card.set_rng_seed(SEED)
    card[0]
    times = []
    for i in range(HOST_TIMED_IMAGES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card[i]
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f'host train chain on the card: {statistics.median(times):.2f} ms '
        f'per image (median of {HOST_TIMED_IMAGES}, host clock, '
        f'synchronized)')
    return statistics.median(times), worst


def _near_threshold(boxes, area0, out, aug):
    """Boxes whose filter quantities lie within 1e-4 (relative) of a
    threshold of the device aug's filter."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    area = w * h
    vis = area / (out * out) / area0.clamp_min(1e-12)
    ar = (w / (h + 1e-16)).maximum(h / (w + 1e-16))
    near = lambda x, t: (x - t).abs() <= 1e-4 * max(t, 1)  # noqa: E731
    return (near(area, aug['min_area']) | near(vis, aug['min_visibility'])
            | near(w, aug['min_size']) | near(h, aug['min_size'])
            | near(ar, aug['max_aspect_ratio']))


def check_device_aug(torch, cfg):
    """``device_mosaic_affine`` in fp32 on the card against the CPU with
    the same draws, on a tile batch of DEVICE_AUG_CHECK images made by
    ``MosaicTileLoader`` (tiles of 640, out 640); then the ms of one
    micro-batch of MICRO_BATCH images on the card, draws included."""
    from tpudet_torch.data import MosaicTileLoader, build_dataset
    from tpudet_torch.data.device_aug import (DeviceAug,
                                              device_mosaic_affine,
                                              params_to)
    data = cfg['data']
    ds = build_dataset(data['train'], dict(device='cuda'))
    aug_cfg = dict(data['device_aug'])
    augment = DeviceAug(out_size=data['train_img_size'], **aug_cfg)

    def tile_batch(n):
        loader = MosaicTileLoader(ds, n, tile_size=data['train_img_size'],
                                  max_gts_per_tile=data['max_gts'] // 4)
        it = iter(loader)
        try:
            return next(it)
        finally:
            it.close()

    b = tile_batch(DEVICE_AUG_CHECK)
    aff, gains = augment.draw(b['aug_seed'], b['tiles'].shape[2])
    out = {}
    for device in ('cuda', 'cpu'):
        t = {k: torch.as_tensor(b[k]).to(device) for k in (
            'tiles', 'tile_hw', 'gt_bboxes', 'gt_valid', 'gt_labels')}
        out[device] = device_mosaic_affine(
            t['tiles'], t['tile_hw'], t['gt_bboxes'], t['gt_valid'],
            t['gt_labels'], params_to(aff, device), gains.to(device),
            **augment.apply_kwargs)
    card = {k: v.cpu() for k, v in out['cuda'].items()}
    ref = out['cpu']
    img_err = float((card['img'] - ref['img']).abs().max())
    box_err = float((card['gt_bboxes'] - ref['gt_bboxes']).abs().max())
    s = b['tiles'].shape[2]
    hw = torch.as_tensor(b['tile_hw']).float()
    q = torch.arange(4)
    x1 = torch.where(q % 2 == 0, s - hw[..., 1], float(s))
    y1 = torch.where(q < 2, s - hw[..., 0], float(s))
    cb = torch.as_tensor(b['gt_bboxes']) + torch.stack(
        [x1, y1, x1, y1], -1)[:, :, None]
    area0 = ((cb[..., 2] - cb[..., 0]) * (cb[..., 3] - cb[..., 1])
             / (4 * s * s)).reshape(len(cb), -1)
    off = card['gt_valid'] != ref['gt_valid']
    unexplained = int((off & ~_near_threshold(
        ref['gt_bboxes'], area0, aff.out, aug_cfg)).sum())
    log(f'device_mosaic_affine fp32, card vs CPU, {DEVICE_AUG_CHECK} images '
        f'of {s} -> {aff.out}: image max |delta| {img_err:.3e} (tolerance '
        f'{AUG_IMG_TOL}), boxes {box_err:.3e} px (tolerance '
        f'{AUG_BOX_TOL}), validity differs on {int(off.sum())} of '
        f'{off.numel()} gts ({unexplained} not at a threshold); '
        f'{int(ref["gt_valid"].sum())} valid')
    if img_err > AUG_IMG_TOL or box_err > AUG_BOX_TOL or unexplained:
        raise AssertionError('device aug on the card differs from the CPU')

    micro = tile_batch(MICRO_BATCH)
    micro = {k: v if k in ('tiles', 'aug_seed') else
             torch.as_tensor(v).cuda() for k, v in micro.items()}
    augment(micro)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        augment(micro)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    aug_ms = statistics.median(times)
    prof = profile_device(torch, lambda: augment(micro),
                          f'device aug of a micro-batch of {MICRO_BATCH}',
                          calls=3, top=10)
    log(f'device aug, micro-batch of {MICRO_BATCH}: {aug_ms:.2f} ms (median '
        f'of 5, host clock, synchronized, draws included)')
    return aug_ms, prof, dict(img=img_err, boxes=box_err)


def run_train_loop(torch, tree):
    """``train_detector`` at full width and depth, bf16, LOOP_ACCUMULATION
    micro-batches of LOOP_MICRO_BATCH a step: the host chain on ``yolov4l_coco_mosaic.py`` for LOOP_STEPS
    steps across an epoch boundary (checkpoint and EMA evaluation at each
    epoch's end), then a second call that resumes from the checkpoint
    (its restored state must equal the saved one) and takes one profiled
    step; then the device-aug config for DEVICE_AUG_STEPS steps. Every
    step's launch counts are read (``LoopProbe``). Then the host chain and
    the device aug on the card against the CPU, and the checkpoint's save
    and load times. Returns the launches of a step and the numbers."""
    import tempfile

    from tpudet_torch.apis import train_detector
    from tpudet_torch.utils.checkpoint import (load_train_state,
                                               save_train_state)
    from tpudet_torch.utils.flax_import import train_state_to_flax
    register_array_data()
    images = LOOP_ACCUMULATION * LOOP_MICRO_BATCH
    numbers = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = loop_config(CONFIG, tmp)
        work = os.path.join(tmp, 'host_chain')
        with LoopProbe(torch) as first:
            t0 = time.perf_counter()
            train_detector(cfg, work, max_steps=LOOP_STEPS, device='cuda',
                           variables=tree)
            first_s = time.perf_counter() - t0
        check_loop_rows(first.rows, list(range(1, LOOP_STEPS + 1)))
        trainer = first.trainers[0]
        if trainer.accumulation != LOOP_ACCUMULATION or \
                trainer.model.dtype != torch.bfloat16:
            raise AssertionError(f'not {LOOP_ACCUMULATION} bf16 '
                                 f'micro-batches per step')
        saved = train_state_to_flax(trainer.state, trainer.model)
        with LoopProbe(torch, profile_at=[LOOP_STEPS + 1],
                       record_start=True) as resumed:
            train_detector(cfg, work, max_steps=LOOP_STEPS + 1,
                           device='cuda', variables=tree)
        check_loop_rows(resumed.rows, [LOOP_STEPS + 1])
        gaps = {k: tree_gap(getattr(saved, k), getattr(
            resumed.start_states[0], k)) for k in (
                'params', 'batch_stats', 'ema_params', 'ema_batch_stats')}
        gaps['momentum_buf'] = tree_gap(
            saved.opt_state.momentum_buf,
            resumed.start_states[0].opt_state.momentum_buf)
        gaps['step'] = abs(int(saved.step) - int(
            resumed.start_states[0].step))
        log(f'resumed state against the saved one, max |delta|: '
            + json.dumps(gaps))
        if any(gaps.values()):
            raise AssertionError('the resumed state differs from the saved '
                                 'one')
        with open(os.path.join(work, 'train.log')) as f:
            lines = f.read().splitlines()
        evals = [line for line in lines if ' - eval: ' in line]
        log(f'train.log: {len(lines)} lines, {len(evals)} evaluations; '
            f'ckpts {sorted(os.listdir(os.path.join(work, "ckpts")))}; '
            f'last eval: {evals[-1].split(" - ")[-1] if evals else None}')
        if len(evals) != 3 or not os.path.isfile(
                os.path.join(work, 'latest_ema.msgpack')):
            raise AssertionError('an evaluation or the EMA export is missing')

        # checkpoint I/O of the flagship's state
        ck = os.path.join(tmp, 'ck')
        t0 = time.perf_counter()
        save_train_state(ck, trainer.state, trainer.model, 99)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        load_train_state(ck, trainer.model, trainer.opt_cfg, 99)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        size = os.path.getsize(os.path.join(ck, '99', 'train_state.msgpack'))
        log(f'checkpoint of the train state: {size / 2**20:.1f} MiB, save '
            f'{save_ms:.0f} ms, load {load_ms:.0f} ms')
        numbers['checkpoint'] = dict(mib=size / 2**20, save_ms=save_ms,
                                     load_ms=load_ms)
        del trainer, saved, first.trainers[:], resumed.trainers[:]
        torch.cuda.empty_cache()
        numbers['host_chain'] = dict(
            loop_summary(first.rows + resumed.rows, images),
            train_detector_s=first_s)
        log('train_detector, host chain: ' + json.dumps(
            numbers['host_chain']))
        pipe_ms, _ = check_host_chain(torch, cfg)
        numbers['host_chain']['pipeline_ms_per_image'] = pipe_ms

        aug_cfg = loop_config(CONFIG.replace('.py', '_deviceaug.py'), tmp)
        with LoopProbe(torch, profile_at=[DEVICE_AUG_STEPS]) as aug:
            t0 = time.perf_counter()
            train_detector(aug_cfg, os.path.join(tmp, 'device_aug'),
                           max_steps=DEVICE_AUG_STEPS, device='cuda',
                           variables=tree)
            aug_s = time.perf_counter() - t0
        check_loop_rows(aug.rows, list(range(1, DEVICE_AUG_STEPS + 1)))
        del aug.trainers[:]
        torch.cuda.empty_cache()
        numbers['device_aug'] = dict(loop_summary(aug.rows, images),
                                     train_detector_s=aug_s)
        log('train_detector, device aug: ' + json.dumps(
            numbers['device_aug']))
        aug_ms, prof, errs = check_device_aug(torch, aug_cfg)
        numbers['device_aug'].update(ms_per_micro_batch=aug_ms,
                                     card_vs_cpu=errs)
        if prof:
            numbers['device_aug']['busy_ms_per_micro_batch'] = prof[1]
        ARRAYS.clear()
    log('training loop numbers: ' + json.dumps(numbers))
    return first.rows[-1]['launches'], numbers


# ---------------------------------------------------------------------------
# 8. YOLOv5-l: inference from a checkpoint path, the test CLI, training


def run_cli_eval(torch, config, path, img_size=IMG,
                 mish_per_forward=MISH_PER_FORWARD_V5, classes=None):
    """``tpudet_torch.tools.test.main`` on ``config`` with the weights at
    ``path``, over CLI_IMAGES seeded images (categories named as
    ``classes``, COCO's by default) served from arrays (a config file
    written here points the test set at them), on ``img_size`` canvases,
    every kernel count at 0 just before the call; then
    ``single_device_test`` and ``coco_fast_bbox_eval`` on
    ``init_detector(config, path)`` in fp32 over the same set: the reports
    agree within REPORT_ATOL, every value finite, and the detections the
    CLI wrote (``--format-out``) match the API's (``results2json``) record
    by record. Returns the launches per batch."""
    import tempfile

    from tpudet_torch.apis import init_detector, single_device_test
    from tpudet_torch.config import Config
    from tpudet_torch.data import build_dataset
    from tpudet_torch.evaluation import coco_fast_bbox_eval
    from tpudet_torch.ops import mish
    from tpudet_torch.tools import test as cli
    register_array_data()
    batches = -(-CLI_IMAGES // BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        arrays, coco = eval_set(CLI_SET_SEED, CLI_IMAGES, classes)
        ann = os.path.join(tmp, 'cli.json')
        with open(ann, 'w') as f:
            json.dump(coco, f)
        ARRAYS[ann] = arrays
        pipeline = _from_arrays(Config.fromfile(config)['data']['test'][
            'pipeline'])
        cfg_file = os.path.join(tmp, 'cli_config.py')
        with open(cfg_file, 'w') as f:
            f.write(f'_base_ = {config!r}\n'
                    f"data = dict(test=dict(type='ArrayCocoDataset', "
                    f'ann_file={ann!r}, pipeline={pipeline!r}))\n')
        mish.mish_cuda.launches = 0
        mish.mish_backward_cuda.launches = 0
        t0 = time.perf_counter()
        report = cli.main([cfg_file, path, '--batch-size', str(BATCH),
                           '--img-size', str(img_size), '--format-out',
                           os.path.join(tmp, 'cli')])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = {'mish_fwd': mish.mish_cuda.launches,
                    'mish_bwd': mish.mish_backward_cuda.launches}
        log(f'test CLI over {CLI_IMAGES} images in {batches} batches, fp32: '
            f'{cli_s:.2f} s, launches {json.dumps(launches)}')
        if launches != {'mish_fwd': batches * mish_per_forward,
                        'mish_bwd': 0}:
            raise AssertionError(f'test CLI launches {launches}, not '
                                 f'{mish_per_forward} forward per batch')
        cfg = Config.fromfile(cfg_file)
        det = init_detector(cfg, path, device='cuda', dtype=torch.float32)
        ds = build_dataset({**cfg['data']['test'], 'test_mode': True},
                           dict(device=det.device))
        results = single_device_test(det.model, ds, batch_size=BATCH,
                                     img_size=img_size, progress=False)
        ref = coco_fast_bbox_eval(
            results, [ds.get_ann_info_test(i) for i in range(len(ds))],
            classes=ds.CLASSES)
        if not all(math.isfinite(v) for d in (report, ref)
                   for v in d.values()):
            raise AssertionError(f'a non-finite value in the reports: '
                                 f'{report} {ref}')
        gap = max(abs(report[k] - v) for k, v in ref.items())
        log(f'test CLI report: {json.dumps(report)}; single_device_test + '
            f'coco_fast_bbox_eval: {json.dumps(ref)}; max |delta| '
            f'{gap:.3e} (tolerance {REPORT_ATOL})')
        if list(report) != list(ref) or not gap <= REPORT_ATOL:
            raise AssertionError('the test CLI report differs from the API')
        with open(os.path.join(tmp, 'cli.bbox.json')) as f:
            got = json.load(f)
        with open(ds.results2json(results, os.path.join(tmp, 'api'))[
                'bbox']) as f:
            want = json.load(f)
        keys = ('image_id', 'category_id')
        if len(got) != len(want) or any(
                [g[k] for k in keys] != [w[k] for k in keys]
                for g, w in zip(got, want)):
            raise AssertionError('the test CLI wrote other detections')
        box_gap = max([abs(a - b) for g, w in zip(got, want)
                       for a, b in zip(g['bbox'], w['bbox'])] or [0.0])
        score_gap = max([abs(g['score'] - w['score'])
                         for g, w in zip(got, want)] or [0.0])
        log(f'test CLI detections against the API\'s: {len(got)} records, '
            f'box max |delta| {box_gap:.3e} px, score {score_gap:.3e} '
            f'(tolerance {DET_ATOL})')
        if not (len(got) and box_gap <= DET_ATOL and score_gap <= DET_ATOL):
            raise AssertionError('the test CLI detections differ from the '
                                 'API\'s')
        del det, ds
        ARRAYS.pop(ann)
        torch.cuda.empty_cache()
    return {k: v // batches for k, v in launches.items()}


def run_yolov5(torch):
    """YOLOv5-l 640 at full width and depth: inference through
    ``init_detector(cfg, checkpoint_path)`` (fp32 on the card against the
    CPU on V5_FP32_IMAGES images), evaluation through the test CLI, then
    TRAIN_STEPS bf16 steps of 72 images and one fp32 step on the card
    against the CPU; then each kernel against its plain version at the
    shapes and gradient layouts those paths gave it. Returns the launches
    of an inference call and of a train step, and each kernel's max abs
    err at those inputs."""
    import tempfile
    from tpudet_torch.ops import mish

    name = 'YOLOv5-l'
    with tempfile.TemporaryDirectory() as tmp:
        tree, infer_launches, mish_shapes, path = run_slice(
            torch, CONFIG_V5, name, MISH_PER_FORWARD_V5,
            fp32_images=V5_FP32_IMAGES, weights_dir=tmp)
        cli_launches = run_cli_eval(torch, CONFIG_V5, path)
    if cli_launches != infer_launches:
        raise AssertionError(f'test CLI launches {cli_launches} per batch, '
                             f'inference {infer_launches}')
    train_launches, grad_sites = run_training(torch, tree, CONFIG_V5, name,
                                              MISH_PER_FORWARD_V5)
    check_train_step_cpu(torch, tree, CONFIG_V5)
    errs = check_mish_main_path(torch, mish, mish_shapes, grad_sites, name)
    return infer_launches, train_launches, errs


# ---------------------------------------------------------------------------
# 9. RetinaNet-R50-FPN: inference, soft-NMS, training, train_detector, CLI


def jpeg_libraries(build):
    """Whether a JPEG decoder's header and library are on the machine:
    ``jpeglib.h``, ``libjpeg.so*``, ``nvjpeg.h``, ``libnvjpeg.so*`` under
    the CUDA toolkit beside ``nvcc``, the system paths and the ``nvidia``
    wheels beside torch. Returns {name: [paths]}."""
    import glob
    import site
    cuda = os.path.dirname(os.path.dirname(build._nvcc()))
    dirs = [os.path.join(cuda, 'include'), os.path.join(cuda, 'lib64')]
    dirs += glob.glob(os.path.join(cuda, 'targets', '*', 'include'))
    dirs += glob.glob(os.path.join(cuda, 'targets', '*', 'lib'))
    dirs += ['/usr/include', '/usr/include/x86_64-linux-gnu',
             '/usr/lib/x86_64-linux-gnu', '/usr/lib64', '/usr/lib',
             '/usr/local/include', '/usr/local/lib']
    for sp in site.getsitepackages():
        dirs += glob.glob(os.path.join(sp, 'nvidia', '*', 'include'))
        dirs += glob.glob(os.path.join(sp, 'nvidia', '*', 'lib'))
    return {name: sorted({p for d in dirs
                          for p in glob.glob(os.path.join(d, name))})
            for name in ('jpeglib.h', 'libjpeg.so*', 'nvjpeg.h',
                         'libnvjpeg.so*')}


def retina_norm(cfg):
    """(mean, std) of the config's Normalize."""
    import numpy as np
    for t in cfg['data']['test']['pipeline']:
        for u in [t] + list(t.get('transforms', [])):
            if u['type'] == 'Normalize':
                return (np.asarray(u['mean'], np.float32),
                        np.asarray(u['std'], np.float32))
    raise KeyError('no Normalize in the test pipeline')


def retina_images(cfg, n, size, seed):
    """``n`` images of random pixels on ``size`` squares, normalized as the
    config's pipeline does, (n, size, size, 3) fp32."""
    import numpy as np
    mean, std = retina_norm(cfg)
    px = np.random.RandomState(seed).randint(0, 256, (n, size, size, 3))
    # each channel's 256 values normalized once, in float64 as the
    # elementwise (px - mean) / std, then looked up: the same fp32 numbers
    # in about a third of the host's time
    lut = ((np.arange(256)[:, None] - mean) / std).astype(np.float32)
    return lut[px, np.arange(3)]


def redrawn_variables(torch, cfg, img, layers, seed, measure_bn=False,
                      run=None):
    """tpudet's init for ``cfg``'s model (``random_flax_variables`` from
    the seed, drawn on the card) with the prediction layers ``layers``
    (module path -> (spread, bias)) redrawn from ``RandomState(seed)``: kernels
    N(0, (spread / (sqrt(fan_in) * rms))^2), rms that of the layer's input
    over all its calls in a forward of ``img``, so that the outputs spread
    by about ``spread`` around ``bias``. With ``measure_bn`` the forward
    runs in train mode and the BatchNorm statistics are those of ``img``
    (one cumulative pass); otherwise in eval mode with tpudet's identity
    BatchNorm. ``run(model, img)`` replaces the forward (a mask head runs
    only when asked for masks)."""
    import numpy as np
    from torch import nn
    from tpudet_torch.models.builder import build_detector
    from tpudet_torch.utils.flax_import import (leaf_table,
                                                load_flax_variables,
                                                random_flax_variables)
    with torch.device('cuda'):
        model = build_detector(cfg['model'])
    tree = random_flax_variables(model, seed=SEED, device='cuda')
    load_flax_variables(model, tree)
    model.to('cuda', memory_format=torch.channels_last)
    if measure_bn:
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
                m.momentum = None  # cumulative: stats of this batch exactly
    sums = {path: [0.0, 0] for path in layers}

    def hook(path):
        def record(mod, args):
            sums[path][0] += float(args[0].float().pow(2).sum())
            sums[path][1] += args[0].numel()
        return record
    hooks = [model.get_submodule('.'.join(path)).register_forward_pre_hook(
        hook(path)) for path in layers]
    model.train(measure_bn)
    with torch.no_grad():
        (run or (lambda m, x: m(x)))(model, torch.from_numpy(img).cuda())
    for h in hooks:
        h.remove()
    if measure_bn:
        sd = {k: v.detach().float().cpu().numpy()
              for k, v in model.state_dict().items()}
        for path, (key, _) in leaf_table(model).items():
            if path[0] == 'batch_stats':
                node = tree['batch_stats']
                for p in path[1:-1]:
                    node = node[p]
                node[path[-1]] = sd[key]
    rng = np.random.RandomState(seed)
    for path, (spread, bias) in layers.items():
        if not sums[path][0]:  # an empty or all-zero input (SSD512's
            continue           # 0 x 0 level, a ReLU map of 2 x 2 zeros)
        node = tree['params']
        for p in path:
            node = node[p]
        rms = math.sqrt(sums[path][0] / sums[path][1])
        fan_in = int(np.prod(node['kernel'].shape[:-1]))
        std = spread / (math.sqrt(fan_in) * rms)
        node['kernel'] = (rng.randn(*node['kernel'].shape) * std).astype(
            np.float32)
        if 'bias' in node:
            node['bias'] = np.full_like(node['bias'], bias)
    del model
    torch.cuda.empty_cache()
    return tree


def retina_variables(torch, cfg, img, measure_bn=False):
    """tpudet variables for a RetinaNet config from the seed:
    tpudet's init (``random_flax_variables``: BatchNorm an identity) with
    the two prediction convs redrawn. With tpudet's N(0, 0.01^2) kernels
    and the 0.01 prior every class score sits near 0.01, under score_thr
    0.05, and no NMS runs; here the class logits spread by
    RETINA_CLS_SPREAD around RETINA_CLS_BIAS and the deltas by
    RETINA_REG_SPREAD, the kernels scaled by the rms of each conv's input
    on ``img`` over all levels.

    With ``measure_bn`` the BatchNorm statistics are those of ``img``
    (train mode, one cumulative pass), for a model that trains: the
    running statistics then start where the batch statistics are, and a
    few steps leave the head's input, and so the scores, where they were.
    Otherwise eval mode with tpudet's identity BatchNorm: the residual
    stages grow the activations, but bf16 stays within a few percent of
    fp32 (with statistics of the batch, bf16 strayed 20-60 % from fp32 on
    these weights)."""
    return redrawn_variables(
        torch, cfg, img,
        {('bbox_head', 'retina_cls'): (RETINA_CLS_SPREAD, RETINA_CLS_BIAS),
         ('bbox_head', 'retina_reg'): (RETINA_REG_SPREAD, 0.0)},
        SEED + 2, measure_bn)


def retina_train_batch(cfg, n, size, seed):
    """A training batch from a numpy seed: ``n`` images of random pixels
    normalized as the config's pipeline, 1-20 gts per image padded to
    RETINA_MAX_GTS, sides from e^U(log 12, log(0.7 size)) so targets land
    on every level, labels 0-79."""
    import numpy as np
    rng = np.random.RandomState(seed)
    img = retina_images(cfg, n, size, seed)
    boxes = np.zeros((n, RETINA_MAX_GTS, 4), np.float32)
    valid = np.zeros((n, RETINA_MAX_GTS), bool)
    for i in range(n):
        k = rng.randint(1, 21)
        wh = np.exp(rng.uniform(np.log(12), np.log(0.7 * size), (k, 2)))
        c = rng.uniform(wh / 2, size - wh / 2)
        boxes[i, :k] = np.concatenate([c - wh / 2, c + wh / 2], -1)
        valid[i, :k] = True
    labels = rng.randint(0, 80, (n, RETINA_MAX_GTS)).astype(np.int64)
    return dict(img=img, gt_bboxes=boxes, gt_labels=labels, gt_valid=valid)


def meta_gflop(cfg, size):
    """GFLOP (a multiply-add counts 2) of one forward of the config's model
    on a ``size`` square image, counted by ``torch.utils.flop_counter`` on
    PyTorch's meta device: no weights, no time."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from tpudet_torch.models.builder import build_detector
    with torch.device('meta'):
        model = build_detector(cfg['model']).eval()
        counter = FlopCounterMode(display=False)
        with counter:
            model(torch.zeros(1, size, size, 3))
    return counter.get_total_flops() / 1e9


def retina_featmap_sizes(model, size):
    """The (H, W) of each pyramid level on a ``size`` square: the stride-2
    extra convs round up."""
    return [(-(-size // s),) * 2 for s in model.bbox_head.strides]


def _mish_counts(mish):
    return {'mish_fwd': mish.mish_cuda.launches,
            'mish_bwd': mish.mish_backward_cuda.launches}


def _zero_counts(mish):
    mish.mish_cuda.launches = 0
    mish.mish_backward_cuda.launches = 0


def _flat_levels(preds):
    """RetinaNet's (cls levels, reg levels) as one list of maps."""
    return [p for part in preds for p in part]


def run_retina_inference(torch, mish):
    """RetinaNet-R50-FPN bf16, batch 8, on RETINA_IMG canvases through
    ``init_detector`` / ``Detector``: its launch counts (every count at 0
    just before the one call), the (box, class) candidates over score_thr
    per image (at least RETINA_MIN_CANDIDATES, so the nms_pre cap of 4096
    binds and the blocked NMS runs), forward / decode / NMS / e2e times,
    peak memory and a profile; then fp32 on the card against the CPU on
    RETINA_FP32_IMAGES images (TF32 off), bf16 against fp32, and the
    soft-NMS config (``retinanet_r50_fpn_softnms_1x_coco.py``) on the same
    weights, card against CPU. Returns (weights tree, launches, the bf16
    times)."""
    from tpudet_torch.apis import init_detector
    from tpudet_torch.config import Config
    from tpudet_torch.core.nms import batched_nms
    from tpudet_torch.models.dense_heads import retina_head as head_mod

    cfg = Config.fromfile(CONFIG_RETINA)
    img_np = retina_images(cfg, RETINA_BATCH, RETINA_IMG, SEED + 900)
    t0 = time.perf_counter()
    tree = retina_variables(torch, cfg, img_np)
    log(f'RetinaNet weights: seed {SEED} on the card, tpudet\'s init, '
        f'class logits N({RETINA_CLS_BIAS}, {RETINA_CLS_SPREAD}^2), deltas '
        f'spread {RETINA_REG_SPREAD}; {time.perf_counter() - t0:.1f} s')
    det = init_detector(cfg, variables=tree, device='cuda',
                        dtype=torch.bfloat16)
    model, cfg_t = det.model, dict(det.model.test_cfg)
    n_params = sum(p.numel() for p in model.parameters())
    n_anchors = sum(len(a) for a in model.bbox_head.anchor_generator
                    .grid_anchors(retina_featmap_sizes(model, RETINA_IMG)))
    log(f'RetinaNet-R50-FPN: {n_params / 1e6:.2f} M parameters, '
        f'{model.bbox_head.num_classes} classes, {n_anchors} anchors at '
        f'{RETINA_IMG}^2, bf16; {meta_gflop(cfg, RETINA_IMG):.1f} GFLOP an '
        f'image at {RETINA_IMG}^2, {meta_gflop(cfg, RETINA_CHECK_IMG):.2f} at '
        f'{RETINA_CHECK_IMG}^2 (meta device)')
    img = torch.from_numpy(img_np).cuda()

    _zero_counts(mish)
    res = det(img)
    torch.cuda.synchronize()
    launches = _mish_counts(mish)
    log(f'RetinaNet inference path launches: {json.dumps(launches)}')
    if any(launches.values()):
        raise AssertionError('the RetinaNet path launched a mish kernel')
    want = (RETINA_BATCH, cfg_t['max_per_img'])
    if tuple(res.scores.shape) != want or tuple(res.bboxes.shape) != \
            want + (4,):
        raise AssertionError(f'detections of shape {tuple(res.bboxes.shape)}'
                             f', not {want + (4,)}')
    if not (torch.isfinite(res.bboxes).all() and
            torch.isfinite(res.scores).all()):
        raise AssertionError('non-finite detections')
    n_valid = [int(v) for v in res.valid.sum(1)]
    # what the head hands batched_nms: the per-level top nms_pre anchors,
    # decoded; then decode alone (NMS replaced by nothing) and NMS alone
    nms_call = []
    with torch.inference_mode():
        pm = model(img)
        head_mod.batched_nms = lambda *a, **k: nms_call.append((a, k))
        try:
            model.get_bboxes(pm)
        finally:
            head_mod.batched_nms = batched_nms
    (bbox, scores, *nms_args), nms_kw = nms_call[0]
    cand = [int(c) for c in (scores > cfg_t['score_thr']).sum((1, 2))]
    log(f'RetinaNet bf16 batch {RETINA_BATCH}: {bbox.shape[1]} anchors an '
        f'image after the per-level top {cfg_t["nms_pre"]}, (box, class) '
        f'candidates over score_thr {cfg_t["score_thr"]} per image {cand}, '
        f'nms_pre {nms_kw["nms_pre"]}; valid detections per image {n_valid}')
    if min(cand) < RETINA_MIN_CANDIDATES or min(n_valid) < want[1] or \
            nms_kw['nms_pre'] != 4096:
        raise AssertionError(f'fewer than {RETINA_MIN_CANDIDATES} candidates, '
                             f'an image without {want[1]} detections or '
                             f'another cap')

    # times per batch of 8, everything warmed up first
    def decode():
        head_mod.batched_nms = lambda *a, **k: None
        try:
            model.get_bboxes(pm)
        finally:
            head_mod.batched_nms = batched_nms
    with torch.inference_mode():
        for _ in range(3):
            det(img)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = {
            'e2e_ms': cuda_ms(lambda: det(img), runs=5),
            'forward_ms': cuda_ms(lambda: model(img), runs=5),
            'decode_ms': cuda_ms(decode, runs=5),
            'nms_ms': cuda_ms(lambda: batched_nms(bbox, scores, *nms_args,
                                                  **nms_kw), runs=5),
        }
    times['img_per_s'] = RETINA_BATCH / times['e2e_ms'] * 1e3
    times['peak_mem_gib'] = torch.cuda.max_memory_allocated() / 2**30
    log(f'RetinaNet-R50-FPN bf16 batch {RETINA_BATCH} x {RETINA_IMG}^2: '
        + json.dumps(times))
    with torch.inference_mode():
        prof = profile_device(torch, lambda: det(img), 'RetinaNet e2e call')
    if prof:
        log(f'RetinaNet inference: device busy {prof[1]:.3f} ms per call of '
            f'{RETINA_BATCH}')

    # card fp32 (TF32 off) against the same model on the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det32 = init_detector(cfg, variables=tree, device='cuda',
                          dtype=torch.float32)
    cpu32 = init_detector(cfg, variables=tree, device='cpu',
                          dtype=torch.float32)
    few = img[:RETINA_FP32_IMAGES]
    t0 = time.perf_counter()
    with torch.inference_mode():
        pm_ref = cpu32.model(few.cpu())
        res_ref = cpu32.model.get_bboxes(pm_ref)
        cpu_s = time.perf_counter() - t0
        pm32 = det32.model(few)
        res32 = det32.model.get_bboxes(pm32)
        pm16 = [p[:RETINA_FP32_IMAGES] for p in _flat_levels(pm)]
    err32 = pred_map_error(_flat_levels(pm32), _flat_levels(pm_ref))
    err16 = pred_map_error(pm16, _flat_levels(pm_ref))
    log(f'RetinaNet fp32 card vs CPU ({cpu_s:.1f} s on the CPU) pred maps, '
        f'max|d|/max|ref| per map (5 class, 5 delta levels): {err32} '
        f'(tolerance {FP32_PRED_TOL}); bf16 card vs fp32 CPU: {err16} '
        f'(tolerance {BF16_PRED_TOL})')
    if max(err32) > FP32_PRED_TOL:
        raise AssertionError('fp32 card pred maps differ from the CPU')
    if max(err16) > BF16_PRED_TOL:
        raise AssertionError('bf16 pred maps too far from fp32')
    for i in range(RETINA_FP32_IMAGES):
        matched, n_ref, n_got, _ = match_detections(res_ref, res32, i,
                                                 MATCH_IOU)
        log(f'RetinaNet fp32 card vs CPU detections, image {i}: {matched} '
            f'matched of {n_ref} / {n_got} (label and IoU >= {MATCH_IOU})')
        if not (matched == n_ref == n_got and n_ref > 0):
            raise AssertionError('fp32 card detections differ from the CPU')
    del det32, cpu32

    # the soft-NMS config on the same weights: the card's Detector call
    # against the CPU model's get_bboxes of its pred maps
    soft_cfg = Config.fromfile(CONFIG_RETINA_SOFT)
    soft = init_detector(soft_cfg, variables=tree, device='cuda',
                         dtype=torch.float32)
    soft_cpu = init_detector(soft_cfg, variables=tree, device='cpu',
                             dtype=torch.float32)
    with torch.inference_mode():
        got = soft(few)
        ref = soft_cpu.model.get_bboxes(pm_ref)
    torch.cuda.synchronize()
    for i in range(RETINA_FP32_IMAGES):
        matched, n_ref, n_got, _ = match_detections(ref, got, i, MATCH_IOU)
        gap = float('inf')
        if n_ref == n_got:  # the picks in order: their decayed scores
            gap = float((ref.scores[i][ref.valid[i]] - got.scores[i].cpu()[
                got.valid[i].cpu()]).abs().max())
        log(f'RetinaNet soft-NMS ({soft_cfg["model"]["test_cfg"]["nms"]}) '
            f'card vs CPU, image {i}: {matched} matched of {n_ref} / {n_got}, '
            f'decayed scores in pick order max |delta| {gap:.3e} (tolerance '
            f'{DET_ATOL})')
        if not (matched == n_ref == n_got and n_ref > 0 and gap <= DET_ATOL):
            raise AssertionError('soft-NMS on the card differs from the CPU')
    del soft, soft_cpu, det, model, pm, pm32, pm_ref, bbox, scores, nms_call
    torch.cuda.empty_cache()
    return tree, launches, times


def assignment_differences(torch, anchors, gt_bboxes, gt_valid):
    """The MaxIoU codes of one batch on the card against the CPU: the
    anchors whose codes differ, each explained when its max IoU lies
    within 1 fp32 ulp of neg_iou_thr 0.4 or pos_iou_thr 0.5, or one of its
    IoUs within 1 ulp of its gt's max (a tie). Returns (differing,
    explained, max IoU gap card vs CPU)."""
    import numpy as np
    from tpudet_torch.core.assigners import max_iou_assign_batch
    from tpudet_torch.core.bbox import bbox_overlaps
    out = {}
    for dev in ('cuda', 'cpu'):
        a = torch.from_numpy(anchors).to(dev)
        g = torch.from_numpy(gt_bboxes).to(dev)
        v = torch.from_numpy(gt_valid).to(dev)
        codes = max_iou_assign_batch(a, g, v, 0.5, 0.4, 0.0, True)
        ious = torch.where(v[:, None, :], bbox_overlaps(a[None], g), -1.)
        out[dev] = (codes.cpu().numpy(), ious.cpu().numpy())
    gap = float(np.abs(out['cuda'][1] - out['cpu'][1]).max())
    codes, ious = out['cpu']
    diff = np.argwhere(out['cuda'][0] != codes)
    explained = 0
    for b, i in diff:
        row = ious[b, i]
        gt_max = ious[b].max(0)
        near = lambda x, t: abs(x - t) <= np.spacing(np.float32(t))  # noqa
        explained += int(near(row.max(), 0.4) or near(row.max(), 0.5) or any(
            near(row[j], gt_max[j]) for j in np.nonzero(gt_valid[b])[0]))
    return len(diff), explained, gap


def run_retina_training(torch, tree):
    """RetinaNet-R50-FPN at RETINA_IMG, bf16 compute with fp32 master
    weights, through ``init_trainer(...).step``: RETINA_TRAIN_STEPS steps
    of RETINA_TRAIN_BATCH images (the config's samples_per_gpu, no
    accumulation), each with its launch counts, then a profiled step; then
    one fp32 step at RETINA_CHECK_IMG at the full lr on the card against
    the CPU (loss and grad_norm to STEP_LOSS_RTOL, the updated state to
    STEP_TREE_TOL x its update) with the assignment codes of its batch on
    both.
    Returns the launches of a step."""
    import numpy as np
    from tpudet_torch.apis import init_trainer
    from tpudet_torch.config import Config
    from tpudet_torch.ops import mish
    from tpudet_torch.utils.flax_import import train_state_to_flax
    cfg = Config.fromfile(CONFIG_RETINA)
    cfg['compute_dtype'] = 'bfloat16'
    trainer = init_trainer(cfg, variables=tree, device='cuda',
                           max_steps=RETINA_TRAIN_STEPS + 1)
    if (trainer.accumulation, cfg['data']['samples_per_gpu']) != (
            1, RETINA_TRAIN_BATCH):
        raise AssertionError('not one micro-batch of 2 per step')
    log(f'RetinaNet training: {RETINA_IMG}^2, {RETINA_TRAIN_BATCH} images '
        f'per step, 1-20 gts each, bf16 compute, fp32 master weights, '
        f'SGD momentum {trainer.opt_cfg.momentum} nesterov '
        f'{trainer.opt_cfg.nesterov}, warm-up {trainer.opt_cfg.warmup_iters}')
    p0 = {k: v.detach().clone() for k, v in trainer.state.params.items()}
    launches = None
    for step in range(RETINA_TRAIN_STEPS):
        batch = retina_train_batch(cfg, RETINA_TRAIN_BATCH, RETINA_IMG,
                                   SEED + 1000 + step)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(mish)
        t0 = time.perf_counter()
        metrics = trainer.step(batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = _mish_counts(mish)
        m = {k: float(v) for k, v in metrics.items()}
        row = dict(step=step, **m, step_ms=step_s * 1e3,
                   img_per_s=RETINA_TRAIN_BATCH / step_s,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                   launches=launches)
        log('RetinaNet train step: ' + json.dumps(row))
        if any(launches.values()):
            raise AssertionError('the RetinaNet train step launched mish')
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f'step {step}: non-finite {bad}')
    moved = max(float((trainer.state.params[k].detach() - v).abs().max())
                for k, v in p0.items())
    log(f'after {RETINA_TRAIN_STEPS} steps: params moved by {moved:.3e}')
    if not moved > 0:
        raise AssertionError('params did not move')
    batch = retina_train_batch(cfg, RETINA_TRAIN_BATCH, RETINA_IMG,
                               SEED + 1000 + RETINA_TRAIN_STEPS)
    prof = profile_device(torch, lambda: trainer.step(batch),
                          'RetinaNet train step', calls=1, top=20)
    if prof:
        log(f'RetinaNet train step: device busy {prof[1]:.3f} ms of '
            f'{prof[0]:.3f} ms wall')
    del trainer, p0
    torch.cuda.empty_cache()

    # one fp32 step at RETINA_CHECK_IMG, card (TF32 off) against the CPU,
    # at the config's full lr: its warm-up starts at 1e-3 of it, an update
    # near the params' fp32 ulp, which would hide the backward
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.fromfile(CONFIG_RETINA)
    cfg['custom_hooks'] = [
        dict(h, lr_weight_warmup_ratio=1.0, lr_bias_warmup_ratio=1.0,
             momentum_warmup_ratio=1.0)
        if h.get('type') == 'DetailedLinearWarmUpHook' else h
        for h in cfg.get('custom_hooks', [])]
    batch = retina_train_batch(cfg, RETINA_TRAIN_BATCH, RETINA_CHECK_IMG,
                               SEED + 1100)
    out = {}
    for device in ('cuda', 'cpu'):
        trainer = init_trainer(cfg, variables=tree, device=device,
                               max_steps=1)
        init = train_state_to_flax(trainer.state, trainer.model)
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in trainer.step(batch).items()}
        if device == 'cuda':
            torch.cuda.synchronize()
        log(f'RetinaNet fp32 step at {RETINA_CHECK_IMG} on {device}: '
            f'{time.perf_counter() - t0:.1f} s, ' + json.dumps(metrics))
        out[device] = (metrics, train_state_to_flax(trainer.state,
                                                    trainer.model))
        model = trainer.model
        del trainer
        torch.cuda.empty_cache()
    (mc, sc), (mr, sr) = out['cuda'], out['cpu']
    rel = abs(mc['loss'] - mr['loss']) / abs(mr['loss'])
    grel = abs(mc['grad_norm'] - mr['grad_norm']) / abs(mr['grad_norm'])
    log(f'RetinaNet fp32 step, card vs CPU: loss rel diff {rel:.3e}, '
        f'grad_norm {mc["grad_norm"]:.6f} vs {mr["grad_norm"]:.6f} (rel diff '
        f'{grel:.3e}), lr {mc["lr"]:.3e} (tolerance {STEP_LOSS_RTOL})')
    if not rel <= STEP_LOSS_RTOL:
        raise AssertionError('RetinaNet fp32 card loss differs from the CPU')
    if not grel <= STEP_LOSS_RTOL:
        raise AssertionError('RetinaNet fp32 card grad_norm differs from the '
                             'CPU')
    for name, got, ref, start in (
            ('params', sc.params, sr.params, init.params),
            ('batch_stats', sc.batch_stats, sr.batch_stats,
             init.batch_stats),
            ('ema_params', sc.ema_params, sr.ema_params, init.ema_params),
            ('ema_batch_stats', sc.ema_batch_stats, sr.ema_batch_stats,
             init.ema_batch_stats),
            ('momentum_buf', sc.opt_state.momentum_buf,
             sr.opt_state.momentum_buf, init.opt_state.momentum_buf)):
        diff, upd = tree_gap(got, ref), tree_gap(ref, start)
        log(f'RetinaNet fp32 step, card vs CPU {name}: max |delta| '
            f'{diff:.3e}, update {upd:.3e} (tolerance {STEP_TREE_TOL} x '
            f'update)')
        if not (upd > 0 and diff <= STEP_TREE_TOL * upd):
            raise AssertionError(f'RetinaNet fp32 card {name} differ from '
                                 f'the CPU')
    anchors = np.concatenate(model.bbox_head.anchor_generator.grid_anchors(
        retina_featmap_sizes(model, RETINA_CHECK_IMG)))
    n_diff, explained, iou_gap = assignment_differences(
        torch, anchors, batch['gt_bboxes'], batch['gt_valid'])
    log(f'RetinaNet assignment at {RETINA_CHECK_IMG}, card vs CPU: '
        f'{n_diff} of {RETINA_TRAIN_BATCH} x {len(anchors)} anchors differ, '
        f'{explained} of them within 1 ulp of 0.4, 0.5 or a gt\'s max IoU; '
        f'IoU max |delta| {iou_gap:.3e}')
    if explained != n_diff:
        raise AssertionError('an assignment differs away from a threshold '
                             'or a tie')
    return launches


def run_retina_shapes(torch):
    """``train_detector`` on ``configs/shapes/retinanet_r50_shapes_320.py``
    (3 classes, soft-NMS, the keep-ratio Resize / RandomFlip / Pad(32)
    host pipeline through ``DetDataLoader``) for SHAPES_STEPS bf16 steps
    of 8 images served from seeded arrays, a checkpoint and the EMA
    evaluation at the end; its weights are ``retina_variables`` of the val
    set's first batch, BatchNorm statistics measured. Every step's launch counts are read
    (``LoopProbe``). Then the test CLI on ``latest_ema.msgpack`` against
    ``single_device_test`` + ``coco_fast_bbox_eval``. Returns (launches of
    a step, launches of a CLI batch)."""
    import tempfile

    from tpudet_torch.apis import train_detector
    from tpudet_torch.config import Config
    from tpudet_torch.data import DetDataLoader
    register_array_data()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config.fromfile(CONFIG_RETINA_SHAPES)
        classes = list(cfg['data']['train']['classes'])
        sets = {}
        for name, seed, n in (('train', SEED + 1200, SHAPES_TRAIN_IMAGES),
                              ('val', SEED + 1300, SHAPES_VAL_IMAGES)):
            arrays, coco = eval_set(seed, n, classes)
            path = os.path.join(tmp, f'{name}.json')
            with open(path, 'w') as f:
                json.dump(coco, f)
            ARRAYS[path] = arrays
            sets[name] = (path, arrays, coco)
        data = cfg['data']
        cfg['data'] = dict(
            data,
            train=dict(type='ArrayCocoDataset', ann_file=sets['train'][0],
                       classes=classes,
                       pipeline=_from_arrays(data['train']['pipeline'])),
            val=dict(type='ArrayCocoDataset', ann_file=sets['val'][0],
                     classes=classes,
                     pipeline=_from_arrays(data['val']['pipeline']),
                     test_mode=True))
        cfg['compute_dtype'] = 'bfloat16'
        cfg['checkpoint_config'] = dict(interval=1)
        cfg['evaluation'] = dict(interval=1, metric='fast-bbox')
        cfg['log_config'] = dict(interval=1)
        size = cfg['data']['train_img_size']
        val = array_dataset(cfg, sets['val'][1], sets['val'][2], 'cuda',
                            tmp, classes=classes)
        first = DetDataLoader(val, batch_size=BATCH, img_size=size)._collate(
            [val[i] for i in range(BATCH)])['img'].cpu().numpy()
        tree = retina_variables(torch, cfg, first, measure_bn=True)
        work = os.path.join(tmp, 'shapes')
        with LoopProbe(torch, profile_at=[SHAPES_STEPS]) as probe:
            t0 = time.perf_counter()
            train_detector(cfg, work, max_steps=SHAPES_STEPS, device='cuda',
                           variables=tree)
            loop_s = time.perf_counter() - t0
        rows = probe.rows
        if [r['step'] for r in rows] != list(range(1, SHAPES_STEPS + 1)):
            raise AssertionError(f'steps {[r["step"] for r in rows]}')
        for r in rows:
            bad = [k for k in ('loss', 'loss_cls', 'loss_bbox', 'grad_norm')
                   if not math.isfinite(r[k])]
            if bad or any(r['launches'].values()) or not (
                    r['params_moved'] > 0 and r['ema_moved'] > 0):
                raise AssertionError(f'step {r["step"]}: non-finite {bad}, '
                                     f'launches {r["launches"]} or nothing '
                                     f'moved')
        with open(os.path.join(work, 'train.log')) as f:
            lines = f.read().splitlines()
        evals = [line for line in lines if ' - eval: ' in line]
        ckpts = sorted(os.listdir(os.path.join(work, 'ckpts')))
        log(f'RetinaNet shapes train_detector: {SHAPES_STEPS} steps in '
            f'{loop_s:.1f} s, ' + json.dumps(loop_summary(
                rows, cfg['data']['samples_per_gpu']))
            + f'; ckpts {ckpts}; last eval: '
            f'{evals[-1].split(" - ")[-1] if evals else None}')
        weights = os.path.join(work, 'latest_ema.msgpack')
        if len(evals) != 1 or ckpts != [str(SHAPES_STEPS)] or \
                not os.path.isfile(weights):
            raise AssertionError('a checkpoint, the evaluation or the EMA '
                                 'export is missing')
        del probe.trainers[:]
        torch.cuda.empty_cache()
        cli = run_cli_eval(torch, CONFIG_RETINA_SHAPES, weights,
                           img_size=size, mish_per_forward=0,
                           classes=classes)
        for path, _, _ in sets.values():
            ARRAYS.pop(path)
    return rows[-1]['launches'], cli


def run_retinanet(torch):
    """Phase 9: RetinaNet-R50-FPN at full width and depth. Returns each
    path's launches of each kernel (all 0: ResNet uses ReLU) and the
    inference times."""
    from tpudet_torch.ops import mish
    tree, infer, times = run_retina_inference(torch, mish)
    train = run_retina_training(torch, tree)
    loop, cli = run_retina_shapes(torch)
    return {name: {'retinanet_inference_forward': infer[name],
                   'retinanet_train_step': train[name],
                   'retinanet_train_detector_step': loop[name],
                   'retinanet_test_cli_batch': cli[name]}
            for name in ('mish_fwd', 'mish_bwd')}, times


# ---------------------------------------------------------------------------
# 11. the two-stage family: Faster R-CNN R50-FPN, RPN, FastRCNN


def two_stage_variables(torch, cfg, img, measure_bn=False):
    """tpudet variables for a two-stage config from the seed:
    ``redrawn_variables`` of the four prediction layers. At tpudet's init
    every objectness sits near 0.5 (N(0, 0.01^2) kernels: the proposals
    nearly tied) and every class probability near 1/81, under score_thr
    0.05 (no detection). Here objectness logits spread by
    FRCNN_RPN_CLS_SPREAD, RPN deltas by FRCNN_RPN_REG_SPREAD, RoI class
    logits by FRCNN_CLS_SPREAD and RoI deltas by FRCNN_REG_SPREAD, all
    around 0."""
    return redrawn_variables(
        torch, cfg, img,
        {('rpn_head', 'rpn_cls'): (FRCNN_RPN_CLS_SPREAD, 0.0),
         ('rpn_head', 'rpn_reg'): (FRCNN_RPN_REG_SPREAD, 0.0),
         ('roi_head', 'bbox_head', 'fc_cls'): (FRCNN_CLS_SPREAD, 0.0),
         ('roi_head', 'bbox_head', 'fc_reg'): (FRCNN_REG_SPREAD, 0.0)},
        SEED + 3, measure_bn)


def sub_tree(tree, parts):
    """The variables of the modules ``parts`` (``backbone``, ``neck``, a
    head) of a detector's tree, for a detector made of them."""
    return {c: {k: v for k, v in tree[c].items() if k in parts}
            for c in tree}


def as_detections(proposals, valid):
    """Proposals as an ``NMSResult`` of label 0, for ``match_detections``."""
    from tpudet_torch.core.nms import NMSResult
    zeros = valid.new_zeros(valid.shape, dtype=proposals.dtype)
    return NMSResult(proposals, zeros, zeros.long(), valid)


def run_frcnn_inference(torch, mish, retina_times):
    """Faster R-CNN R50-FPN bf16, batch 8, on FRCNN_IMG canvases through
    ``init_detector`` / ``Detector``: its launch counts (every count at 0
    just before the one call), 1000 proposals an image, finite detections;
    forward / RPN proposals / RoIAlign / bbox head / get_bboxes / e2e ms,
    RoIAlign's peak memory, a profile; then fp32 on the card against the
    CPU on FRCNN_FP32_IMAGES images (TF32 off): the RPN's keeps, level
    codes and the detections. ``retina_times`` (phase 9's) are printed
    beside the times. Returns (weights tree, launches)."""
    from tpudet_torch.apis import init_detector
    from tpudet_torch.config import Config
    from tpudet_torch.ops.roi_align import roi_levels

    cfg = Config.fromfile(CONFIG_FRCNN)
    img_np = retina_images(cfg, FRCNN_BATCH, FRCNN_IMG, SEED + 1400)
    t0 = time.perf_counter()
    tree = two_stage_variables(torch, cfg, img_np)
    log(f'Faster R-CNN weights: seed {SEED} on the card, tpudet\'s init with '
        f'objectness logits spread {FRCNN_RPN_CLS_SPREAD}, RPN deltas '
        f'{FRCNN_RPN_REG_SPREAD}, RoI class logits {FRCNN_CLS_SPREAD}, RoI '
        f'deltas {FRCNN_REG_SPREAD}; {time.perf_counter() - t0:.1f} s')
    det = init_detector(cfg, variables=tree, device='cuda',
                        dtype=torch.bfloat16)
    model = det.model
    rpn_cfg = model.test_cfg['rpn']
    n_params = sum(p.numel() for p in model.parameters())
    log(f'Faster R-CNN R50-FPN: {n_params / 1e6:.2f} M parameters, '
        f'{model.roi_head.num_classes} classes, bf16; '
        f'{meta_gflop_two_stage(cfg, FRCNN_IMG):.1f} GFLOP an image at '
        f'{FRCNN_IMG}^2 (meta device: backbone, neck and heads, 1000 rois)')
    img = torch.from_numpy(img_np).cuda()

    _zero_counts(mish)
    res = det(img)
    torch.cuda.synchronize()
    launches = _mish_counts(mish)
    log(f'Faster R-CNN inference path launches: {json.dumps(launches)}')
    if any(launches.values()):
        raise AssertionError('the Faster R-CNN path launched a mish kernel')
    with torch.inference_mode():
        out = model(img)
    n_props = [int(v) for v in out[1].sum(1)]
    n_valid = [int(v) for v in res.valid.sum(1)]
    levels = roi_levels(out[0], 4)[out[1]]
    log(f'Faster R-CNN bf16 batch {FRCNN_BATCH}: proposals per image '
        f'{n_props}, by RoIAlign level {[int((levels == k).sum()) for k in range(4)]}; '
        f'detections per image {n_valid} (max_per_img '
        f'{model.test_cfg["rcnn"]["max_per_img"]})')
    if n_props != [rpn_cfg['max_per_img']] * FRCNN_BATCH:
        raise AssertionError('not 1000 proposals an image')
    if not (torch.isfinite(res.bboxes).all() and
            torch.isfinite(res.scores).all() and min(n_valid) > 0):
        raise AssertionError('non-finite detections or an image without')

    # the stages alone, on the stages' own inputs, everything warmed up
    with torch.inference_mode():
        feats = model.extract_feat(img)
        rpn_preds = model.rpn_head(feats)
        props, _, valid = model.rpn_head.get_proposals(
            rpn_preds, img_shape=tuple(img.shape[1:3]),
            nms_pre=rpn_cfg['nms_pre'], max_num=rpn_cfg['max_per_img'],
            iou_thr=rpn_cfg['nms']['iou_threshold'])
        pooled = model.roi_head.extract(feats, props, valid)
        head_out = model.roi_head.bbox_head(pooled)
        for _ in range(3):
            det(img)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model.roi_head.extract(feats, props, valid)
        torch.cuda.synchronize()
        roi_align_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        torch.cuda.reset_peak_memory_stats()
        times = {
            'e2e_ms': cuda_ms(lambda: det(img), runs=5),
            'forward_ms': cuda_ms(lambda: model(img), runs=5),
            'backbone_neck_ms': cuda_ms(lambda: model.extract_feat(img),
                                        runs=5),
            'rpn_head_ms': cuda_ms(lambda: model.rpn_head(feats), runs=5),
            'rpn_proposals_ms': cuda_ms(lambda: model.rpn_head.get_proposals(
                rpn_preds, img_shape=tuple(img.shape[1:3]),
                nms_pre=rpn_cfg['nms_pre'], max_num=rpn_cfg['max_per_img'],
                iou_thr=rpn_cfg['nms']['iou_threshold']), runs=5),
            'roi_align_ms': cuda_ms(lambda: model.roi_head.extract(
                feats, props, valid), runs=5),
            'bbox_head_ms': cuda_ms(lambda: model.roi_head.bbox_head(pooled),
                                    runs=5),
            'get_bboxes_ms': cuda_ms(lambda: model.get_bboxes(
                (props, valid) + tuple(head_out)), runs=5),
        }
    times['img_per_s'] = FRCNN_BATCH / times['e2e_ms'] * 1e3
    times['peak_mem_gib'] = torch.cuda.max_memory_allocated() / 2**30
    times['roi_align_peak_gib'] = roi_align_peak
    log(f'Faster R-CNN R50-FPN bf16 batch {FRCNN_BATCH} x {FRCNN_IMG}^2: '
        + json.dumps(times))
    log(f'beside RetinaNet-R50-FPN at the same shape (phase 9): '
        + json.dumps(retina_times))
    with torch.inference_mode():
        prof = profile_device(torch, lambda: det(img), 'Faster R-CNN e2e call',
                              top=20)
        prof_align = profile_device(
            torch, lambda: model.roi_head.extract(feats, props, valid),
            'RoIAlign of 8 x 1000 rois', top=5)
    if prof:
        log(f'Faster R-CNN inference: device busy {prof[1]:.3f} ms per call '
            f'of {FRCNN_BATCH}; RoIAlign alone '
            f'{prof_align[1] if prof_align else float("nan"):.3f} ms busy')
    del feats, rpn_preds, props, valid, pooled, head_out, out, res
    torch.cuda.empty_cache()

    # card fp32 (TF32 off) against the same model on the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det32 = init_detector(cfg, variables=tree, device='cuda',
                          dtype=torch.float32)
    cpu32 = init_detector(cfg, variables=tree, device='cpu',
                          dtype=torch.float32)
    few = img[:FRCNN_FP32_IMAGES]
    t0 = time.perf_counter()
    with torch.inference_mode():
        out_ref = cpu32.model(few.cpu())
        res_ref = cpu32.model.get_bboxes(out_ref)
        cpu_s = time.perf_counter() - t0
        out32 = det32.model(few)
        res32 = det32.model.get_bboxes(out32)
    for i in range(FRCNN_FP32_IMAGES):
        m, n_ref, n_got, gap = match_detections(
            as_detections(*out_ref[:2]), as_detections(*out32[:2]),
            i, MATCH_IOU)
        same = ((out_ref[0][i] - out32[0][i].cpu()).abs().amax(-1)
                .le(MATCH_CORNER_PX) & out_ref[1][i] & out32[1][i].cpu())
        level_diff = int((roi_levels(out_ref[0][i][same], 4) != roi_levels(
            out32[0][i].cpu()[same], 4)).sum())
        dm, dn_ref, dn_got, dgap = match_detections(res_ref, res32, i,
                                                    MATCH_IOU)
        log(f'Faster R-CNN fp32 card vs CPU ({cpu_s:.1f} s on the CPU), image '
            f'{i}: RPN keeps {n_got} / {n_ref}, {n_ref - m} of the CPU\'s '
            f'without a match (IoU >= {MATCH_IOU}), {int(same.sum())} slots '
            f'equal to {MATCH_CORNER_PX} px, largest box delta of the matches '
            f'{gap:.3e} px; RoIAlign level codes that differ among the equal '
            f'slots {level_diff}; '
            f'detections {dm} matched of {dn_ref} / {dn_got} (label and IoU '
            f'>= {MATCH_IOU}), largest box delta {dgap:.3e} px')
        if not (n_ref - m <= FRCNN_KEEP_SHARE * n_ref and
                dn_ref - dm <= FRCNN_KEEP_SHARE * dn_ref and dn_ref > 0):
            raise AssertionError('fp32 card proposals or detections differ '
                                 'from the CPU')
    del det32, cpu32, det, model
    torch.cuda.empty_cache()
    return tree, launches


def meta_gflop_two_stage(cfg, size):
    """GFLOP (a multiply-add counts 2) of the backbone, neck, RPN head and
    the RoI head on 1000 rois of one ``size`` square image, counted on
    PyTorch's meta device (no weights, no time; the proposals' NMS and
    RoIAlign's gather are not counted)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from tpudet_torch.models.builder import build_detector
    with torch.device('meta'):
        model = build_detector(cfg['model']).eval()
        counter = FlopCounterMode(display=False)
        with counter:
            feats = model.extract_feat(torch.zeros(1, size, size, 3))
            model.rpn_head(feats)
            head = model.roi_head.bbox_head
            head(torch.zeros(1, 1000, 1, 1, head.shared_fc0.in_features))
    return counter.get_total_flops() / 1e9


def run_rpn_and_fast_rcnn(torch, mish, tree):
    """``rpn_r50_fpn_1x_coco.py`` on the Faster R-CNN weights' backbone,
    neck and RPN head: proposals of FRCNN_FP32_IMAGES images at
    FRCNN_PART_IMG, fp32, card against CPU; then
    ``fast_rcnn_r50_fpn_1x_coco.py`` on its backbone, neck and RoI head,
    fed the card's proposals on both devices: detections card against
    CPU. Returns each one's launches (every count at 0 just before)."""
    from tpudet_torch.apis import init_detector
    from tpudet_torch.config import Config
    launches = {}
    cfg_rpn = Config.fromfile(CONFIG_RPN)
    img = torch.from_numpy(retina_images(cfg_rpn, FRCNN_FP32_IMAGES,
                                         FRCNN_PART_IMG, SEED + 1500))
    rpn_tree = sub_tree(tree, ('backbone', 'neck', 'rpn_head'))
    rpn = init_detector(cfg_rpn, variables=rpn_tree, device='cuda',
                        dtype=torch.float32)
    rpn_cpu = init_detector(cfg_rpn, variables=rpn_tree, device='cpu',
                            dtype=torch.float32)
    _zero_counts(mish)
    got = rpn(img.cuda())
    torch.cuda.synchronize()
    launches['rpn_inference'] = _mish_counts(mish)
    with torch.inference_mode():
        ref = rpn_cpu(img)
    for i in range(FRCNN_FP32_IMAGES):
        m, n_ref, n_got, gap = match_detections(ref, got, i, MATCH_IOU)
        log(f'RPN ({CONFIG_RPN.split("/")[-1]}) fp32 at {FRCNN_PART_IMG}^2, '
            f'card vs CPU, image {i}: proposals {n_got} / {n_ref}, '
            f'{n_ref - m} of the CPU\'s without a match, largest box delta '
            f'{gap:.3e} px; launches {json.dumps(launches["rpn_inference"])}')
        if not (n_ref - m <= FRCNN_KEEP_SHARE * n_ref and n_ref > 0):
            raise AssertionError('RPN proposals on the card differ from the '
                                 'CPU')
    cfg_fast = Config.fromfile(CONFIG_FAST)
    fast_tree = sub_tree(tree, ('backbone', 'neck', 'roi_head'))
    fast = init_detector(cfg_fast, variables=fast_tree, device='cuda',
                         dtype=torch.float32)
    fast_cpu = init_detector(cfg_fast, variables=fast_tree, device='cpu',
                             dtype=torch.float32)
    props, valid = got.bboxes, got.valid
    _zero_counts(mish)
    with torch.inference_mode():
        out = fast.model(img.cuda(), props, valid)
        res = fast.model.get_bboxes(out)
    torch.cuda.synchronize()
    launches['fast_rcnn_inference'] = _mish_counts(mish)
    with torch.inference_mode():
        ref = fast_cpu.model.get_bboxes(fast_cpu.model(img, props.cpu(),
                                                       valid.cpu()))
    for i in range(FRCNN_FP32_IMAGES):
        m, n_ref, n_got, gap = match_detections(ref, res, i, MATCH_IOU)
        log(f'FastRCNN ({CONFIG_FAST.split("/")[-1]}) on those proposals, '
            f'card vs CPU, image {i}: detections {m} matched of {n_ref} / '
            f'{n_got}, largest box delta {gap:.3e} px; launches '
            f'{json.dumps(launches["fast_rcnn_inference"])}')
        if not (n_ref - m <= FRCNN_KEEP_SHARE * n_ref and n_ref > 0 and
                torch.isfinite(res.bboxes).all()):
            raise AssertionError('FastRCNN detections on the card differ '
                                 'from the CPU')
    if any(v for d in launches.values() for v in d.values()):
        raise AssertionError('RPN or FastRCNN launched a mish kernel')
    del rpn, rpn_cpu, fast, fast_cpu
    torch.cuda.empty_cache()
    return launches


def feed_card_proposals(rpn_head, own, device):
    """Record the train-time proposals that ``rpn_head.get_proposals``
    makes on ``device`` in ``own[device]``; on the CPU, hand the card's
    on in their place. A score near-tie or an IoU at the NMS threshold
    can flip under rounding and shift every later proposal's slot, and
    the fixed-priority sampler then takes other rois: with the same
    proposals the step holds the rest of the path to its tolerances."""
    orig = rpn_head.get_proposals

    def get_proposals(*args, **kwargs):
        res = tuple(t.detach() for t in orig(*args, **kwargs))
        own[device] = res
        if device == 'cpu':
            return tuple(t.cpu() for t in own['cuda'])
        return res
    rpn_head.get_proposals = get_proposals


class SampleRecorder:
    """Records what ``roi_head.sample_rois`` returns in each call."""

    def __init__(self, head):
        self.head, self.calls = head, []
        orig = head.sample_rois

        def sample_rois(*args, **kwargs):
            out = orig(*args, **kwargs)
            self.calls.append(tuple(t.detach().cpu() for t in out))
            return out
        head.sample_rois = sample_rois


def run_frcnn_training(torch, tree):
    """Faster R-CNN at FRCNN_IMG, bf16 compute with fp32 master weights,
    through ``init_trainer(...).step`` (the ``forward_train`` loss path):
    FRCNN_TRAIN_STEPS steps of the config's 2 images, each with its launch
    counts, then a profiled step; then one fp32 step at FRCNN_CHECK_IMG at
    the full lr on the card against the CPU: the RPN's train-time
    proposals (one-to-one), then, with the card's proposals fed to the
    CPU's step (``feed_card_proposals``), the sampled rois and labels
    (slots that differ), the four losses, grad_norm and the updated state.
    Returns the launches of a step."""
    from tpudet_torch.apis import init_trainer
    from tpudet_torch.config import Config
    from tpudet_torch.ops import mish
    from tpudet_torch.utils.flax_import import train_state_to_flax
    cfg = Config.fromfile(CONFIG_FRCNN)
    cfg['compute_dtype'] = 'bfloat16'
    trainer = init_trainer(cfg, variables=tree, device='cuda',
                           max_steps=FRCNN_TRAIN_STEPS + 1)
    if (trainer.accumulation, cfg['data']['samples_per_gpu']) != (
            1, FRCNN_TRAIN_BATCH):
        raise AssertionError('not one micro-batch of 2 per step')
    log(f'Faster R-CNN training: {FRCNN_IMG}^2, {FRCNN_TRAIN_BATCH} images '
        f'per step, 1-20 gts each, bf16 compute, fp32 master weights, the '
        f'forward_train loss path ({list(trainer.batch_keys)})')
    p0 = {k: v.detach().clone() for k, v in trainer.state.params.items()}
    launches = None
    for step in range(FRCNN_TRAIN_STEPS):
        batch = retina_train_batch(cfg, FRCNN_TRAIN_BATCH, FRCNN_IMG,
                                   SEED + 1600 + step)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(mish)
        t0 = time.perf_counter()
        metrics = trainer.step(batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = _mish_counts(mish)
        m = {k: float(v) for k, v in metrics.items()}
        row = dict(step=step, **m, step_ms=step_s * 1e3,
                   img_per_s=FRCNN_TRAIN_BATCH / step_s,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                   launches=launches)
        log('Faster R-CNN train step: ' + json.dumps(row))
        if any(launches.values()):
            raise AssertionError('the Faster R-CNN train step launched mish')
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad or set(FRCNN_LOSSES) - set(m):
            raise AssertionError(f'step {step}: non-finite {bad} or a loss '
                                 f'missing')
    moved = max(float((trainer.state.params[k].detach() - v).abs().max())
                for k, v in p0.items())
    log(f'after {FRCNN_TRAIN_STEPS} steps: params moved by {moved:.3e}')
    if not moved > 0:
        raise AssertionError('params did not move')
    batch = retina_train_batch(cfg, FRCNN_TRAIN_BATCH, FRCNN_IMG,
                               SEED + 1600 + FRCNN_TRAIN_STEPS)
    prof = profile_device(torch, lambda: trainer.step(batch),
                          'Faster R-CNN train step', calls=1, top=20)
    if prof:
        log(f'Faster R-CNN train step: device busy {prof[1]:.3f} ms of '
            f'{prof[0]:.3f} ms wall')
    del trainer, p0
    torch.cuda.empty_cache()

    # one fp32 step at FRCNN_CHECK_IMG, card (TF32 off) against the CPU,
    # at the config's full lr (its warm-up starts at 1e-3 of it)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.fromfile(CONFIG_FRCNN)
    cfg['custom_hooks'] = [
        dict(h, lr_weight_warmup_ratio=1.0, lr_bias_warmup_ratio=1.0,
             momentum_warmup_ratio=1.0)
        if h.get('type') == 'DetailedLinearWarmUpHook' else h
        for h in cfg.get('custom_hooks', [])]
    batch = retina_train_batch(cfg, FRCNN_TRAIN_BATCH, FRCNN_CHECK_IMG,
                               SEED + 1700)
    out, own = {}, {}
    for device in ('cuda', 'cpu'):
        trainer = init_trainer(cfg, variables=tree, device=device,
                               max_steps=1)
        rec = SampleRecorder(trainer.model.roi_head)
        feed_card_proposals(trainer.model.rpn_head, own, device)
        init = train_state_to_flax(trainer.state, trainer.model)
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in trainer.step(batch).items()}
        if device == 'cuda':
            torch.cuda.synchronize()
        log(f'Faster R-CNN fp32 step at {FRCNN_CHECK_IMG} on {device}: '
            f'{time.perf_counter() - t0:.1f} s, ' + json.dumps(metrics))
        out[device] = (metrics, train_state_to_flax(trainer.state,
                                                    trainer.model),
                       rec.calls[0])
        del trainer
        torch.cuda.empty_cache()
    (mc, sc, samp_c), (mr, sr, samp_r) = out['cuda'], out['cpu']
    for i in range(FRCNN_TRAIN_BATCH):
        m, n_ref, n_got, gap = match_detections(
            as_detections(own['cpu'][0], own['cpu'][2]),
            as_detections(own['cuda'][0], own['cuda'][2]), i, MATCH_IOU)
        log(f'Faster R-CNN fp32 step, the RPN\'s train-time proposals, card '
            f'vs CPU, image {i}: {n_got} / {n_ref}, {n_ref - m} of the '
            f'CPU\'s without a match, largest box delta {gap:.3e} px (the '
            f'CPU\'s step takes the card\'s)')
        if n_ref - m > FRCNN_KEEP_SHARE * n_ref:
            raise AssertionError('train-time proposals on the card differ '
                                 'from the CPU')
    rois_c, sampled_c, labels_c = samp_c[:3]
    rois_r, sampled_r, labels_r = samp_r[:3]
    slot_diff = int(((rois_c - rois_r).abs().amax(-1) > MATCH_CORNER_PX)
                    .logical_or(labels_c != labels_r)
                    .logical_or(sampled_c != sampled_r).sum())
    n_slots = int(sampled_r.numel())
    rel = {k: abs(mc[k] - mr[k]) / max(abs(mr[k]), 1e-12)
           for k in FRCNN_LOSSES + ('loss', 'grad_norm')}
    log(f'Faster R-CNN fp32 step, card vs CPU: sampled roi slots that '
        f'differ (box by > {MATCH_CORNER_PX} px, label or sampled) '
        f'{slot_diff} of {n_slots} ({int(sampled_r.sum())} sampled, '
        f'{int(samp_r[4].sum())} positive); relative loss differences '
        + json.dumps(rel))
    roi_tol = STEP_LOSS_RTOL if slot_diff == 0 else FRCNN_FLIP_LOSS_RTOL
    if slot_diff > FRCNN_KEEP_SHARE * n_slots or any(
            rel[k] > STEP_LOSS_RTOL for k in ('loss_rpn_cls',
                                              'loss_rpn_bbox')) or any(
            rel[k] > roi_tol for k in ('loss_cls', 'loss_bbox', 'loss',
                                       'grad_norm')):
        raise AssertionError('the fp32 step on the card differs from the '
                             'CPU')
    tree_tol = STEP_TREE_TOL if slot_diff == 0 else FRCNN_FLIP_TREE_TOL
    for name, got, ref, start in (
            ('params', sc.params, sr.params, init.params),
            ('batch_stats', sc.batch_stats, sr.batch_stats,
             init.batch_stats),
            ('ema_params', sc.ema_params, sr.ema_params, init.ema_params),
            ('momentum_buf', sc.opt_state.momentum_buf,
             sr.opt_state.momentum_buf, init.opt_state.momentum_buf)):
        diff, upd = tree_gap(got, ref), tree_gap(ref, start)
        log(f'Faster R-CNN fp32 step, card vs CPU {name}: max |delta| '
            f'{diff:.3e}, update {upd:.3e} (tolerance {tree_tol} x update)')
        if not (upd > 0 and diff <= tree_tol * upd):
            raise AssertionError(f'Faster R-CNN fp32 card {name} differ '
                                 f'from the CPU')
    return launches


def run_frcnn_loop(torch, tree):
    """``train_detector`` on ``faster_rcnn_r50_fpn_1x_coco.py`` (the host
    pipeline: keep-ratio Resize to 1333 x 800, RandomFlip, Pad(64), through
    ``DetDataLoader``) for FRCNN_LOOP_STEPS bf16 steps of 2 images served
    from seeded arrays, a checkpoint and the EMA evaluation; a second call
    resumes from the checkpoint for one more step (its state equal to the
    saved one); then the test CLI on ``latest_ema.msgpack`` against
    ``single_device_test`` + ``coco_fast_bbox_eval``. The weights are
    ``two_stage_variables`` of the val set's first batch, BatchNorm
    statistics measured. Returns (launches of a step, of a CLI batch)."""
    import tempfile

    from tpudet_torch.apis import train_detector
    from tpudet_torch.config import Config
    from tpudet_torch.data import DetDataLoader
    from tpudet_torch.utils.flax_import import train_state_to_flax
    register_array_data()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config.fromfile(CONFIG_FRCNN)
        sets = {}
        for name, seed, n in (('train', SEED + 1800, FRCNN_LOOP_IMAGES),
                              ('val', SEED + 1900, FRCNN_LOOP_VAL_IMAGES)):
            arrays, coco = eval_set(seed, n)
            path = os.path.join(tmp, f'{name}.json')
            with open(path, 'w') as f:
                json.dump(coco, f)
            ARRAYS[path] = arrays
            sets[name] = (path, arrays, coco)
        data = cfg['data']
        cfg['data'] = dict(
            data,
            train=dict(type='ArrayCocoDataset', ann_file=sets['train'][0],
                       pipeline=_from_arrays(data['train']['pipeline'])),
            val=dict(type='ArrayCocoDataset', ann_file=sets['val'][0],
                     pipeline=_from_arrays(data['val']['pipeline']),
                     test_mode=True))
        cfg['compute_dtype'] = 'bfloat16'
        cfg['log_config'] = dict(interval=1)
        size = cfg['data']['train_img_size']
        val = array_dataset(cfg, sets['val'][1], sets['val'][2], 'cuda', tmp)
        first = DetDataLoader(val, batch_size=2, img_size=size)._collate(
            [val[i] for i in range(2)])['img'].cpu().numpy()
        tree = two_stage_variables(torch, cfg, first, measure_bn=True)
        work = os.path.join(tmp, 'frcnn')
        with LoopProbe(torch, profile_at=[FRCNN_LOOP_STEPS]) as probe:
            t0 = time.perf_counter()
            train_detector(cfg, work, max_steps=FRCNN_LOOP_STEPS,
                           device='cuda', variables=tree)
            loop_s = time.perf_counter() - t0
        saved = train_state_to_flax(probe.trainers[0].state,
                                    probe.trainers[0].model)
        del probe.trainers[:]
        torch.cuda.empty_cache()
        with LoopProbe(torch, record_start=True) as resumed:
            train_detector(cfg, work, max_steps=FRCNN_LOOP_STEPS + 1,
                           device='cuda', variables=tree)
        rows = probe.rows + resumed.rows
        if [r['step'] for r in rows] != list(range(1, FRCNN_LOOP_STEPS + 2)):
            raise AssertionError(f'steps {[r["step"] for r in rows]}')
        for r in rows:
            bad = [k for k in ('loss',) + FRCNN_LOSSES + ('grad_norm',)
                   if not math.isfinite(r[k])]
            if bad or any(r['launches'].values()) or not (
                    r['params_moved'] > 0 and r['ema_moved'] > 0):
                raise AssertionError(f'step {r["step"]}: non-finite {bad}, '
                                     f'launches {r["launches"]} or nothing '
                                     f'moved')
        gap = tree_gap(resumed.start_states[0].params, saved.params)
        with open(os.path.join(work, 'train.log')) as f:
            lines = f.read().splitlines()
        evals = [line for line in lines if ' - eval: ' in line]
        ckpts = sorted(os.listdir(os.path.join(work, 'ckpts')), key=int)
        log(f'Faster R-CNN train_detector: {FRCNN_LOOP_STEPS} steps in '
            f'{loop_s:.1f} s, ' + json.dumps(loop_summary(
                probe.rows, cfg['data']['samples_per_gpu']))
            + f'; resumed state vs saved: max |delta| {gap:.3e}; ckpts '
            f'{ckpts}; last eval: '
            f'{evals[-1].split(" - ")[-1] if evals else None}')
        weights = os.path.join(work, 'latest_ema.msgpack')
        if gap != 0.0 or len(evals) != 2 or ckpts != [
                str(FRCNN_LOOP_STEPS), str(FRCNN_LOOP_STEPS + 1)] or \
                not os.path.isfile(weights):
            raise AssertionError('the resumed state, a checkpoint, the '
                                 'evaluation or the EMA export is wrong')
        del resumed.trainers[:]
        torch.cuda.empty_cache()
        cli = run_cli_eval(torch, CONFIG_FRCNN, weights, img_size=FRCNN_IMG,
                           mish_per_forward=0)
        for path, _, _ in sets.values():
            ARRAYS.pop(path)
    return rows[-1]['launches'], cli


def run_two_stage(torch, retina_times):
    """Phase 11: the two-stage family at full width and depth, its
    inference times printed beside ``retina_times``. Returns each path's
    launches of each kernel (all 0: ResNet, FPN and the heads use
    ReLU)."""
    from tpudet_torch.ops import mish
    tree, infer = run_frcnn_inference(torch, mish, retina_times)
    parts = run_rpn_and_fast_rcnn(torch, mish, tree)
    train = run_frcnn_training(torch, tree)
    loop, cli = run_frcnn_loop(torch, tree)
    return {name: {'faster_rcnn_inference_forward': infer[name],
                   'rpn_inference': parts['rpn_inference'][name],
                   'fast_rcnn_inference': parts['fast_rcnn_inference'][name],
                   'faster_rcnn_train_step': train[name],
                   'faster_rcnn_train_detector_step': loop[name],
                   'faster_rcnn_test_cli_batch': cli[name]}
            for name in ('mish_fwd', 'mish_bwd')}


# ---------------------------------------------------------------------------
# 12. Mask R-CNN R50-FPN: the mask head, the paste and RLEs, segm, training

def mask_variables(torch, cfg, img, measure_bn=False):
    """``two_stage_variables`` with ``conv_logits`` of the mask head redrawn
    too, so that the mask logits spread by MASK_LOGIT_SPREAD around 0 (its
    input measured over the masks of each image's first 100 proposals)."""
    def run(model, x):
        out = model(x)
        model.predict_masks(x, out[0][:, :100], out[1][:, :100])

    return redrawn_variables(
        torch, cfg, img,
        {('rpn_head', 'rpn_cls'): (FRCNN_RPN_CLS_SPREAD, 0.0),
         ('rpn_head', 'rpn_reg'): (FRCNN_RPN_REG_SPREAD, 0.0),
         ('roi_head', 'bbox_head', 'fc_cls'): (FRCNN_CLS_SPREAD, 0.0),
         ('roi_head', 'bbox_head', 'fc_reg'): (FRCNN_REG_SPREAD, 0.0),
         ('roi_head', 'mask_head', 'conv_logits'): (MASK_LOGIT_SPREAD, 0.0)},
        SEED + 5, measure_bn, run=run)


def run_mrcnn_inference(torch, mish):
    """Mask R-CNN R50-FPN bf16, batch 8, on MRCNN_IMG canvases: detections,
    each one's mask probabilities of its class (``predict_masks`` on the
    call's own features) and its RLE at 1333 x 800 (``masks_to_segm_
    results``: the paste and the run boundaries on the card), every count
    at 0 just before the one call; e2e, the bbox-only call, forward, mask
    head, paste and RLE ms, device busy, peak memory; then fp32 on the card
    against the CPU on MRCNN_FP32_IMAGES images (TF32 off): detections
    one-to-one, the mask probabilities of the matched ones, the pasted
    pixels. Returns (weights tree, launches, times)."""
    import numpy as np
    from tpudet_torch.apis import init_detector
    from tpudet_torch.apis.test import masks_to_segm_results, predict_masks
    from tpudet_torch.config import Config
    from tpudet_torch.core.mask import (decode_rle, encode_rle_batch,
                                        paste_masks)

    cfg = Config.fromfile(CONFIG_MRCNN)
    img_np = retina_images(cfg, MRCNN_BATCH, MRCNN_IMG, SEED + 2000)
    t0 = time.perf_counter()
    tree = mask_variables(torch, cfg, img_np)
    log(f'Mask R-CNN weights: seed {SEED} on the card, tpudet\'s init with '
        f'phase 11\'s four prediction layers redrawn and the mask logits '
        f'spread {MASK_LOGIT_SPREAD}; {time.perf_counter() - t0:.1f} s')
    det = init_detector(cfg, variables=tree, device='cuda',
                        dtype=torch.bfloat16)
    model = det.model
    nc = model.roi_head.num_classes
    n_params = sum(p.numel() for p in model.parameters())
    log(f'Mask R-CNN R50-FPN: {n_params / 1e6:.2f} M parameters, {nc} '
        f'classes, bf16, 14 x 14 mask pooling, 28 x 28 masks')
    img = torch.from_numpy(img_np).cuda()
    sf = torch.ones((MRCNN_BATCH, 4), device='cuda')
    h, w = MRCNN_ORI[:2]
    metas = [dict(ori_shape=MRCNN_ORI)] * MRCNN_BATCH

    def e2e():
        with torch.inference_mode():
            res, probs = predict_masks(model, img, sf)
            return res, probs, masks_to_segm_results(probs, res, metas, nc,
                                                     MASK_THR)

    torch.cuda.synchronize()
    _zero_counts(mish)
    res, probs, segm = e2e()
    torch.cuda.synchronize()
    launches = _mish_counts(mish)
    log(f'Mask R-CNN inference path launches: {json.dumps(launches)}')
    if any(launches.values()):
        raise AssertionError('the Mask R-CNN path launched a mish kernel')
    n_valid = [int(v) for v in res.valid.sum(1)]
    n_rle = [sum(len(c) for c in s) for s in segm]
    areas = [[decode_rle(r).sum() for c in s for r in c][:3] for s in segm]
    log(f'Mask R-CNN bf16 batch {MRCNN_BATCH}: detections per image '
        f'{n_valid}, RLEs per image {n_rle} at {w} x {h}; mask '
        f'probabilities min {float(probs.min()):.4f} max '
        f'{float(probs.max()):.4f} mean {float(probs.float().mean()):.4f}; '
        f'first areas {areas[0]}')
    if n_rle != n_valid or min(n_valid) == 0 or not bool(
            torch.isfinite(probs).all()) or any(
            sum(r['counts']) != h * w for s in segm for c in s for r in c):
        raise AssertionError('masks missing, non-finite or of the wrong size')

    with torch.inference_mode():
        feats = model.extract_feat(img)
        outputs = model.detect(feats, tuple(img.shape[1:3]))
        res = model.get_bboxes(outputs, scale_factors=sf)
        in_boxes = res.bboxes * sf[:, None, :]
        sel = [(probs[i][res.valid[i]], res.bboxes[i][res.valid[i]])
               for i in range(MRCNN_BATCH)]
        pasted = [paste_masks(p, b, h, w, MASK_THR) for p, b in sel]
        for _ in range(2):
            e2e()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = {
            'e2e_ms': cuda_ms(lambda: e2e(), warmup=1, runs=5),
            'bbox_only_e2e_ms': cuda_ms(lambda: det(img), runs=5),
            'forward_ms': cuda_ms(lambda: model(img), runs=5),
            'mask_head_ms': cuda_ms(lambda: model.roi_head.mask_forward(
                feats, in_boxes, res.valid), runs=5),
            'paste_ms': cuda_ms(lambda: [paste_masks(p, b, h, w, MASK_THR)
                                         for p, b in sel], runs=5),
            'rle_ms': cuda_ms(lambda: [encode_rle_batch(m) for m in pasted],
                              runs=5),
        }
    times['img_per_s'] = MRCNN_BATCH / times['e2e_ms'] * 1e3
    times['peak_mem_gib'] = torch.cuda.max_memory_allocated() / 2**30
    log(f'Mask R-CNN R50-FPN bf16 batch {MRCNN_BATCH} x {MRCNN_IMG}^2, masks '
        f'at {w} x {h}: ' + json.dumps(times))
    prof = profile_device(torch, e2e, 'Mask R-CNN e2e call with masks',
                          calls=2, top=20)
    if prof:
        times['device_busy_ms'], times['profiled_wall_ms'] = prof[1], prof[0]
        log(f'Mask R-CNN inference with masks: device busy {prof[1]:.3f} ms '
            f'of {prof[0]:.3f} ms per call of {MRCNN_BATCH}')
    del feats, outputs, res, probs, segm, pasted, sel, in_boxes
    torch.cuda.empty_cache()

    # card fp32 (TF32 off) against the same model on the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det32 = init_detector(cfg, variables=tree, device='cuda',
                          dtype=torch.float32)
    cpu32 = init_detector(cfg, variables=tree, device='cpu',
                          dtype=torch.float32)
    k = MRCNN_FP32_IMAGES
    t0 = time.perf_counter()
    with torch.inference_mode():
        res_ref, probs_ref = predict_masks(cpu32.model, img[:k].cpu(),
                                           sf[:k].cpu())
        cpu_s = time.perf_counter() - t0
        res32, probs32 = predict_masks(det32.model, img[:k], sf[:k])
    worst = dict(prob=0.0, pixels=0, total=0, outside_band=0)
    for i in range(k):
        pairs = detection_pairs(res_ref, res32, i, MATCH_IOU)
        n_ref = int(res_ref.valid[i].sum())
        r_idx = torch.tensor([r for r, _ in pairs], dtype=torch.long)
        g_idx = torch.tensor([g for _, g in pairs], dtype=torch.long)
        pr, pg = probs_ref[i][r_idx], probs32[i][g_idx.cuda()]
        gap = float((pr - pg.cpu()).abs().max()) if len(pairs) else 0.0
        boxes_r = res_ref.bboxes[i][r_idx]
        card = paste_masks(pg, boxes_r.cuda(), h, w, MASK_THR).cpu()
        ref = paste_masks(pr, boxes_r, h, w, MASK_THR)
        band = paste_masks(pr, boxes_r, h, w, MASK_THR - MRCNN_PIXEL_BAND) ^ \
            paste_masks(pr, boxes_r, h, w, MASK_THR + MRCNN_PIXEL_BAND)
        diff = card ^ ref
        worst['prob'] = max(worst['prob'], gap)
        worst['pixels'] += int(diff.sum())
        worst['total'] += int(ref.numel())
        worst['outside_band'] += int((diff & ~band).sum())
        log(f'Mask R-CNN fp32 card vs CPU ({cpu_s:.1f} s on the CPU), image '
            f'{i}: detections {len(pairs)} matched of {n_ref} / '
            f'{int(res32.valid[i].sum())} (label and IoU >= {MATCH_IOU}); '
            f'mask probabilities of the matched max |delta| {gap:.3e} '
            f'(tolerance {MRCNN_PROB_ATOL}); pasted pixels (the CPU\'s boxes) '
            f'that differ {int(diff.sum())} of {int(ref.numel())}, '
            f'{int((diff & ~band).sum())} of them with the probability '
            f'further than {MRCNN_PIXEL_BAND} from {MASK_THR}')
        if not (n_ref - len(pairs) <= FRCNN_KEEP_SHARE * n_ref and n_ref > 0
                and gap <= MRCNN_PROB_ATOL):
            raise AssertionError('fp32 card detections or mask probabilities '
                                 'differ from the CPU')
    times['fp32_prob_max_abs'] = worst['prob']
    times['fp32_pixel_share'] = worst['pixels'] / max(worst['total'], 1)
    if worst['pixels'] > MRCNN_PIXEL_SHARE * worst['total'] or \
            worst['outside_band']:
        raise AssertionError('fp32 card pasted pixels differ from the CPU')
    del det32, cpu32, det, model
    torch.cuda.empty_cache()
    return tree, launches, times


def with_polygons(coco):
    """``eval_set``'s COCO dict with a polygon segmentation for each gt:
    its rectangle, or every other one a diamond inside it."""
    for i, a in enumerate(coco['annotations']):
        x, y, bw, bh = a['bbox']
        if i % 2:
            poly = [x + bw / 2, y, x + bw, y + bh / 2, x + bw / 2, y + bh,
                    x, y + bh / 2]
        else:
            poly = [x, y, x + bw, y, x + bw, y + bh, x, y + bh]
        a['segmentation'] = [[float(v) for v in poly]]
    return coco


def run_mrcnn_eval(torch, mish, tree):
    """MRCNN_EVAL_IMAGES seeded images with polygon gts through
    ``CocoDataset`` (the config's test pipeline on the card),
    ``single_device_test(with_masks=True)`` (bf16) and
    ``coco_fast_segm_eval``, every count at 0 just before; then the test
    CLI (``--eval bbox segm``, fp32, the weights from a msgpack) against
    ``single_device_test`` + both reports of the same weights: the reports
    within REPORT_ATOL, its ``segm.json`` equal to ``results2json``'s.
    Returns the launches of the flow and of the CLI."""
    import tempfile

    from tpudet_torch.apis import init_detector, single_device_test
    from tpudet_torch.config import Config
    from tpudet_torch.evaluation import coco_fast_segm_eval
    register_array_data()
    cfg = Config.fromfile(CONFIG_MRCNN)
    with tempfile.TemporaryDirectory() as tmp:
        arrays, coco = eval_set(SEED + 2100, MRCNN_EVAL_IMAGES)
        coco = with_polygons(coco)
        det = init_detector(cfg, variables=tree, device='cuda',
                            dtype=torch.bfloat16)
        ds = array_dataset(cfg, arrays, coco, 'cuda', tmp)
        _zero_counts(mish)
        t0 = time.perf_counter()
        results, segms = single_device_test(det.model, ds, batch_size=BATCH,
                                            img_size=MRCNN_IMG,
                                            progress=False, with_masks=True)
        torch.cuda.synchronize()
        flow_s = time.perf_counter() - t0
        flow = _mish_counts(mish)
        annos = [ds.get_ann_info_test(i) for i in range(len(ds))]
        t0 = time.perf_counter()
        report = coco_fast_segm_eval(results, segms, annos,
                                     classes=ds.CLASSES)
        eval_s = time.perf_counter() - t0
        n = sum(len(c) for s in segms for c in s)
        log(f'Mask R-CNN evaluation, {len(ds)} images, bf16: flow '
            f'{flow_s:.2f} s ({len(ds) / flow_s:.1f} img/s), {n} RLEs, '
            f'segm eval {eval_s:.2f} s: {json.dumps(report)}; launches '
            f'{json.dumps(flow)}')
        if any(flow.values()) or not n or not all(
                math.isfinite(report[k]) for k in ('segm_map', 'segm_map50',
                                                   'segm_map75')):
            raise AssertionError('the segm flow launched mish, made no mask '
                                 'or reported a non-finite mAP')
        del det, ds
        torch.cuda.empty_cache()

        cli_launches = cli_segm_eval(torch, mish, CONFIG_MRCNN, tree,
                                     arrays, coco, tmp, MRCNN_IMG)
    return flow, cli_launches


def mask_areas(segm):
    """The pixel area of every RLE in ``segm`` (per image, per class lists
    of uncompressed RLEs: runs of 0s and 1s, 0s first)."""
    return [sum(r['counts'][1::2]) for s in segm for c in s for r in c]


def nonempty_share(areas, what):
    """The share of ``areas`` above 0, logged; fails when none is (a mask
    path that pastes nothing checks nothing)."""
    share = sum(a > 0 for a in areas) / max(len(areas), 1)
    log(f'{what}: {sum(a > 0 for a in areas)} of {len(areas)} pasted masks '
        f'non-empty ({share:.4f})')
    if not share:
        raise AssertionError(f'{what}: every pasted mask is empty')
    return share


def cli_segm_eval(torch, mish, config, tree, arrays, coco, tmp, img_size):
    """The test CLI (``--eval bbox segm``, fp32, ``tree`` from a msgpack)
    on ``config`` over the set ``arrays`` / ``coco`` against
    ``single_device_test`` + both reports of the same weights: the reports
    within REPORT_ATOL, its ``segm.json`` equal to ``results2json``'s.
    Returns the launches of the CLI."""
    from tpudet_torch.apis import init_detector, single_device_test
    from tpudet_torch.config import Config
    from tpudet_torch.data import build_dataset
    from tpudet_torch.evaluation import (coco_fast_bbox_eval,
                                         coco_fast_segm_eval)
    from tpudet_torch.tools import test as cli
    from tpudet_torch.utils.checkpoint import save_variables
    ann = os.path.join(tmp, 'segm.json')
    with open(ann, 'w') as f:
        json.dump(coco, f)
    ARRAYS[ann] = arrays
    weights = os.path.join(tmp, 'weights.msgpack')
    save_variables(weights, tree)
    pipeline = _from_arrays(Config.fromfile(config)['data']['test'][
        'pipeline'])
    cfg_file = os.path.join(tmp, 'segm_cli.py')
    with open(cfg_file, 'w') as f:
        f.write(f'_base_ = {config!r}\n'
                f"data = dict(test=dict(type='ArrayCocoDataset', "
                f'ann_file={ann!r}, pipeline={pipeline!r}))\n')
    _zero_counts(mish)
    t0 = time.perf_counter()
    got = cli.main([cfg_file, weights, '--batch-size', str(BATCH),
                    '--img-size', str(img_size), '--eval', 'bbox', 'segm',
                    '--format-out', os.path.join(tmp, 'cli')])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = _mish_counts(mish)
    cfg_cli = Config.fromfile(cfg_file)
    det = init_detector(cfg_cli, weights, device='cuda', dtype=torch.float32)
    ds = build_dataset({**cfg_cli['data']['test'], 'test_mode': True},
                       dict(device=det.device))
    results, segms = single_device_test(det.model, ds, batch_size=BATCH,
                                        img_size=img_size, progress=False,
                                        with_masks=True)
    annos = [ds.get_ann_info_test(i) for i in range(len(ds))]
    nonempty_share(mask_areas(segms),
                   f'test CLI on {os.path.basename(config)}')
    ref = dict(coco_fast_bbox_eval(results, annos, classes=ds.CLASSES),
               **coco_fast_segm_eval(results, segms, annos,
                                     classes=ds.CLASSES))
    gap = max(0.0 if math.isnan(got[k]) and math.isnan(v)
              else abs(got[k] - v) for k, v in ref.items())
    with open(os.path.join(tmp, 'cli.segm.json')) as f:
        cli_segm = json.load(f)
    with open(ds.results2json(results, os.path.join(tmp, 'api'),
                              segm_results=segms)['segm']) as f:
        api_segm = json.load(f)
    log(f'test CLI --eval bbox segm on {os.path.basename(config)} over '
        f'{len(ds)} images, fp32: {cli_s:.2f} s, launches '
        f'{json.dumps(cli_launches)}; report {json.dumps(got)}; the API\'s '
        f'max |delta| {gap:.3e} (tolerance {REPORT_ATOL}); segm.json '
        f'{len(cli_segm)} records, equal to results2json\'s: '
        f'{cli_segm == api_segm}')
    if list(got) != list(ref) or not gap <= REPORT_ATOL or \
            cli_segm != api_segm or not cli_segm or any(
                cli_launches.values()):
        raise AssertionError('the test CLI segm report or json differs '
                             'from the API')
    ARRAYS.pop(ann)
    del det, ds
    torch.cuda.empty_cache()
    return cli_launches


def mask_train_batch(torch, cfg, n, size, seed, device):
    """``retina_train_batch`` with each gt's polygon (a 12-gon inscribed in
    its box) rasterized into its gt frame by the port's
    ``LoadAnnotations(with_mask=True)`` on ``device``: ``gt_frame_masks``
    (n, RETINA_MAX_GTS, 28, 28)."""
    import numpy as np
    from tpudet_torch.data.pipelines import LoadAnnotations
    batch = retina_train_batch(cfg, n, size, seed)
    load = LoadAnnotations(with_mask=True, device=device)
    a = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    masks = torch.zeros((n, RETINA_MAX_GTS, 28, 28), device=device)
    for i in range(n):
        k = int(batch['gt_valid'][i].sum())
        boxes = batch['gt_bboxes'][i][:k]
        c, r = (boxes[:, :2] + boxes[:, 2:]) / 2, (boxes[:, 2:] -
                                                    boxes[:, :2]) / 2
        segs = [[np.stack([cx + rx * np.cos(a), cy + ry * np.sin(a)], 1)
                 .reshape(-1).tolist()] for (cx, cy), (rx, ry) in zip(c, r)]
        masks[i, :k] = load(dict(ann_info=dict(
            bboxes=boxes, labels=batch['gt_labels'][i][:k],
            masks=segs)))['gt_frame_masks']
    batch['gt_frame_masks'] = masks
    return batch


def run_mrcnn_training(torch, tree):
    """Mask R-CNN at MRCNN_IMG, bf16 compute with fp32 master weights,
    through ``init_trainer(...).step`` (the ``forward_train`` loss path,
    ``gt_frame_masks`` made on the card): FRCNN_TRAIN_STEPS steps of 2
    images, each with its launch counts, then a profiled step; then one
    fp32 step at FRCNN_CHECK_IMG on the card against the CPU with the
    card's proposals fed to the CPU: the gt-frame masks made on each
    device, the sampled slots, the five losses, grad_norm and the updated
    state. Returns the launches of a step."""
    from tpudet_torch.apis import init_trainer
    from tpudet_torch.config import Config
    from tpudet_torch.ops import mish
    from tpudet_torch.utils.flax_import import train_state_to_flax
    cfg = Config.fromfile(CONFIG_MRCNN)
    cfg['compute_dtype'] = 'bfloat16'
    trainer = init_trainer(cfg, variables=tree, device='cuda',
                           max_steps=FRCNN_TRAIN_STEPS + 1)
    log(f'Mask R-CNN training: {MRCNN_IMG}^2, {FRCNN_TRAIN_BATCH} images per '
        f'step, 1-20 gts each with gt-frame masks made on the card, bf16 '
        f'compute, fp32 master weights ({list(trainer.batch_keys)})')
    launches = None
    for step in range(FRCNN_TRAIN_STEPS):
        batch = mask_train_batch(torch, cfg, FRCNN_TRAIN_BATCH, MRCNN_IMG,
                                 SEED + 2200 + step, 'cuda')
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(mish)
        t0 = time.perf_counter()
        metrics = trainer.step(batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = _mish_counts(mish)
        m = {k: float(v) for k, v in metrics.items()}
        log('Mask R-CNN train step: ' + json.dumps(dict(
            step=step, **m, step_ms=step_s * 1e3,
            img_per_s=FRCNN_TRAIN_BATCH / step_s,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            launches=launches)))
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if any(launches.values()) or bad or set(MRCNN_LOSSES) - set(m):
            raise AssertionError(f'step {step}: mish launched, non-finite '
                                 f'{bad} or a loss missing')
    batch = mask_train_batch(torch, cfg, FRCNN_TRAIN_BATCH, MRCNN_IMG,
                             SEED + 2200 + FRCNN_TRAIN_STEPS, 'cuda')
    prof = profile_device(torch, lambda: trainer.step(batch),
                          'Mask R-CNN train step', calls=1, top=15)
    if prof:
        log(f'Mask R-CNN train step: device busy {prof[1]:.3f} ms of '
            f'{prof[0]:.3f} ms wall')
    del trainer
    torch.cuda.empty_cache()

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.fromfile(CONFIG_MRCNN)
    cfg['custom_hooks'] = [
        dict(h, lr_weight_warmup_ratio=1.0, lr_bias_warmup_ratio=1.0,
             momentum_warmup_ratio=1.0)
        if h.get('type') == 'DetailedLinearWarmUpHook' else h
        for h in cfg.get('custom_hooks', [])]
    batch = mask_train_batch(torch, cfg, FRCNN_TRAIN_BATCH, FRCNN_CHECK_IMG,
                             SEED + 2300, 'cuda')
    masks_cpu = mask_train_batch(torch, cfg, FRCNN_TRAIN_BATCH,
                                 FRCNN_CHECK_IMG, SEED + 2300,
                                 'cpu')['gt_frame_masks']
    if not torch.equal(batch['gt_frame_masks'].cpu(), masks_cpu):
        raise AssertionError('gt-frame masks made on the card differ from '
                             'the CPU\'s')
    out, own = {}, {}
    for device in ('cuda', 'cpu'):
        trainer = init_trainer(cfg, variables=tree, device=device,
                               max_steps=1)
        rec = SampleRecorder(trainer.model.roi_head)
        feed_card_proposals(trainer.model.rpn_head, own, device)
        init = train_state_to_flax(trainer.state, trainer.model)
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in trainer.step(batch).items()}
        if device == 'cuda':
            torch.cuda.synchronize()
        log(f'Mask R-CNN fp32 step at {FRCNN_CHECK_IMG} on {device}: '
            f'{time.perf_counter() - t0:.1f} s, ' + json.dumps(metrics))
        out[device] = (metrics, train_state_to_flax(trainer.state,
                                                    trainer.model),
                       rec.calls[0])
        del trainer
        torch.cuda.empty_cache()
    (mc, sc, samp_c), (mr, sr, samp_r) = out['cuda'], out['cpu']
    slot_diff = int(((samp_c[0] - samp_r[0]).abs().amax(-1) >
                     MATCH_CORNER_PX).logical_or(samp_c[2] != samp_r[2])
                    .logical_or(samp_c[1] != samp_r[1]).sum())
    rel = {k: abs(mc[k] - mr[k]) / max(abs(mr[k]), 1e-12)
           for k in MRCNN_LOSSES + ('loss', 'grad_norm')}
    log(f'Mask R-CNN fp32 step, card vs CPU (the card\'s proposals on both; '
        f'gt-frame masks equal): sampled slots that differ {slot_diff} of '
        f'{int(samp_r[1].numel())}; relative loss differences '
        + json.dumps(rel))
    if slot_diff or any(v > STEP_LOSS_RTOL for v in rel.values()):
        raise AssertionError('the fp32 Mask R-CNN step on the card differs '
                             'from the CPU')
    for name, got, ref, start in (
            ('params', sc.params, sr.params, init.params),
            ('ema_params', sc.ema_params, sr.ema_params, init.ema_params)):
        diff, upd = tree_gap(got, ref), tree_gap(ref, start)
        log(f'Mask R-CNN fp32 step, card vs CPU {name}: max |delta| '
            f'{diff:.3e}, update {upd:.3e} (tolerance {STEP_TREE_TOL} x '
            f'update)')
        if not (upd > 0 and diff <= STEP_TREE_TOL * upd):
            raise AssertionError(f'Mask R-CNN fp32 card {name} differ from '
                                 f'the CPU')
    return launches


def run_mrcnn_loop(torch, tree):
    """``train_detector`` on ``mask_rcnn_r50_fpn_1x_coco.py`` (the host
    pipeline with ``LoadAnnotations(with_mask=True)`` on the card, Resize
    to 1333 x 800, RandomFlip, Pad(64)) for MRCNN_LOOP_STEPS bf16 steps of
    2 images with polygon gts served from seeded arrays, a checkpoint and
    the EMA evaluation; a second call resumes for one more step (its state
    equal to the saved one). Returns the launches of a step."""
    import tempfile

    from tpudet_torch.apis import train_detector
    from tpudet_torch.config import Config
    from tpudet_torch.utils.flax_import import train_state_to_flax
    register_array_data()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config.fromfile(CONFIG_MRCNN)
        paths = {}
        for name, seed, n in (('train', SEED + 2400, MRCNN_LOOP_IMAGES),
                              ('val', SEED + 2500, MRCNN_LOOP_VAL_IMAGES)):
            arrays, coco = eval_set(seed, n)
            path = os.path.join(tmp, f'{name}.json')
            with open(path, 'w') as f:
                json.dump(with_polygons(coco), f)
            ARRAYS[path] = arrays
            paths[name] = path
        data = cfg['data']
        cfg['data'] = dict(
            data,
            train=dict(type='ArrayCocoDataset', ann_file=paths['train'],
                       pipeline=_from_arrays(data['train']['pipeline'])),
            val=dict(type='ArrayCocoDataset', ann_file=paths['val'],
                     pipeline=_from_arrays(data['val']['pipeline']),
                     test_mode=True))
        cfg['compute_dtype'] = 'bfloat16'
        cfg['log_config'] = dict(interval=1)
        work = os.path.join(tmp, 'mrcnn')
        with LoopProbe(torch) as probe:
            t0 = time.perf_counter()
            train_detector(cfg, work, max_steps=MRCNN_LOOP_STEPS,
                           device='cuda', variables=tree)
            loop_s = time.perf_counter() - t0
        saved = train_state_to_flax(probe.trainers[0].state,
                                    probe.trainers[0].model)
        del probe.trainers[:]
        torch.cuda.empty_cache()
        with LoopProbe(torch, record_start=True) as resumed:
            train_detector(cfg, work, max_steps=MRCNN_LOOP_STEPS + 1,
                           device='cuda', variables=tree)
        rows = probe.rows + resumed.rows
        if [r['step'] for r in rows] != list(range(1, MRCNN_LOOP_STEPS + 2)):
            raise AssertionError(f'steps {[r["step"] for r in rows]}')
        for r in rows:
            bad = [k for k in ('loss',) + MRCNN_LOSSES + ('grad_norm',)
                   if not math.isfinite(r[k])]
            if bad or any(r['launches'].values()) or not (
                    r['params_moved'] > 0 and r['ema_moved'] > 0):
                raise AssertionError(f'step {r["step"]}: non-finite {bad}, '
                                     f'launches {r["launches"]} or nothing '
                                     f'moved')
        gap = tree_gap(resumed.start_states[0].params, saved.params)
        ckpts = sorted(os.listdir(os.path.join(work, 'ckpts')), key=int)
        log(f'Mask R-CNN train_detector: {MRCNN_LOOP_STEPS} steps in '
            f'{loop_s:.1f} s, ' + json.dumps(loop_summary(
                probe.rows, cfg['data']['samples_per_gpu']))
            + f'; loss_mask {[round(r["loss_mask"], 5) for r in rows]}; '
            f'resumed state vs saved: max |delta| {gap:.3e}; ckpts {ckpts}')
        if gap != 0.0 or not os.path.isfile(
                os.path.join(work, 'latest_ema.msgpack')):
            raise AssertionError('the resumed state or the EMA export is '
                                 'wrong')
        del resumed.trainers[:]
        for path in paths.values():
            ARRAYS.pop(path)
        torch.cuda.empty_cache()
    return rows[-1]['launches']


def run_mask_rcnn(torch):
    """Phase 12: Mask R-CNN R50-FPN at full width and depth. Returns each
    path's launches of each kernel (all 0: ResNet, FPN and the heads use
    ReLU) and the inference times."""
    from tpudet_torch.ops import mish
    tree, infer, times = run_mrcnn_inference(torch, mish)
    flow, cli = run_mrcnn_eval(torch, mish, tree)
    train = run_mrcnn_training(torch, tree)
    loop = run_mrcnn_loop(torch, tree)
    return {name: {'mask_rcnn_inference_with_masks': infer[name],
                   'mask_rcnn_segm_eval_flow': flow[name],
                   'mask_rcnn_test_cli': cli[name],
                   'mask_rcnn_train_step': train[name],
                   'mask_rcnn_train_detector_step': loop[name]}
            for name in ('mish_fwd', 'mish_bwd')}, times


# ---------------------------------------------------------------------------
# 10. serving: nvJPEG, the letterbox kernel, ModelServer over HTTP


def load_fixtures():
    """The committed JPEG fixtures: [(name, bytes, form, cv2's decode or
    None)], in the manifest's order (the truncated file last)."""
    import numpy as np
    with open(os.path.join(FIXTURES, 'manifest.json')) as f:
        manifest = json.load(f)['fixtures']
    decoded = np.load(os.path.join(FIXTURES, 'decoded.npz'))
    out = []
    for name in sorted(manifest, key=lambda n: (n == 'truncated.jpg', n)):
        with open(os.path.join(FIXTURES, name), 'rb') as f:
            data = f.read()
        ref = decoded[name] if name in decoded.files else None
        out.append((name, data, manifest[name]['form'], ref))
    return out


def check_nvjpeg_decode(torch, jpeg, fixtures):
    """nvJPEG on every fixture against cv2's committed decode, against
    DECODE_LIMITS (all logged first, then any failure raised); the
    truncated file must be refused. Returns {name: stats}, ms an image
    from CUDA events around ``decode`` (the host's Huffman stage
    included)."""
    nv = jpeg.nvjpeg()
    log(f'nvJPEG {nv.version}, backend {nv.backend}')
    stats, failures = {}, []
    for name, data, form, ref in fixtures:
        got = jpeg.decode(data, device='cuda')
        torch.cuda.synchronize()
        if ref is None:
            header = jpeg.jpeg_info(data)
            # a header the port's walk refuses never reaches nvJPEG's
            # decode, which then leaves no status of its own
            row = dict(form=form, refused=got is None, header=header,
                       nvjpeg_info=nv.info(data),
                       status=None if header is None else nv.last_status)
            if got is not None:
                failures.append(f'{name}: decoded, want refused')
        elif got is None:
            row = dict(form=form, status=nv.last_status)
            failures.append(f'{name}: refused (nvjpegStatus_t '
                            f'{nv.last_status})')
        else:
            diff = (got.cpu().int() - torch.from_numpy(ref).int()).abs()
            mean_max, band, share_min = DECODE_LIMITS[form]
            per_channel = diff.float().mean(dim=(0, 1)).tolist()
            row = dict(form=form, shape=list(ref.shape),
                       max_abs=int(diff.max()), mean_abs=float(
                           diff.float().mean()),
                       mean_abs_bgr=per_channel,
                       equal_share=float((diff == 0).float().mean()),
                       within_band_share=float(
                           (diff <= band).float().mean()),
                       band=band, info=nv.info(data),
                       ms=cuda_ms(lambda: jpeg.decode(data, device='cuda'),
                                  warmup=2, runs=5))
            if row['mean_abs'] > mean_max or \
                    row['within_band_share'] < share_min:
                failures.append(f'{name}: mean {row["mean_abs"]:.3f} (limit '
                                f'{mean_max}), {row["within_band_share"]:.4f}'
                                f' within {band} (limit {share_min})')
        stats[name] = row
        log(f'nvJPEG {name}: ' + json.dumps(row))
    if failures:
        raise AssertionError('nvJPEG decode: ' + '; '.join(failures))
    check_decode_behind(torch, jpeg, fixtures)
    check_decode_letterbox(torch, jpeg, fixtures)
    return stats


def check_decode_behind(torch, jpeg, fixtures, rounds=3, queued=4):
    """Decodes queued behind other work on their stream equal the same
    decodes made one at a time on an idle card: ``queued`` 4096^2 matmuls
    go ahead of each decode, so the host runs ahead of the stream (as in a
    loader thread on a busy card). A decoder state reused before its last
    copies ran gave corrupt images here."""
    datas = [data for _, data, _, ref in fixtures if ref is not None]
    want = []
    for data in datas:
        want.append(jpeg.decode(data, device='cuda'))
        torch.cuda.synchronize()
    busy = torch.randn(4096, 4096, device='cuda')
    got = []
    t0 = time.perf_counter()
    for _ in range(rounds):
        for data in datas:
            for _ in range(queued):
                busy @ busy
            got.append(jpeg.decode(data, device='cuda'))
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    bad = [i % len(datas) for i, g in enumerate(got)
           if not torch.equal(g, want[i % len(datas)])]
    log(f'nvJPEG behind {queued} queued matmuls: {len(got)} decodes, host '
        f'{host_s:.3f} s of {wall_s:.3f} s, {len(bad)} differ from the '
        f'idle decodes')
    if bad:
        raise AssertionError(f'nvJPEG decodes queued behind other work '
                             f'differ from idle ones: fixtures {bad}')


def check_decode_letterbox(torch, jpeg, fixtures):
    """``decode_letterbox_batch`` and ``decode_letterbox`` at their default
    device over every fixture into the server's canvas, against the plain
    letterbox of nvJPEG's decodes: equal, the truncated file status 1 with
    a ``pad_val`` canvas."""
    import numpy as np
    from tpudet_torch.ops import letterbox as lb
    datas = [data for _, data, _, _ in fixtures]
    canvases, sf, status = jpeg.decode_letterbox_batch(datas, IMG, IMG, 114)
    ref, sf_ref = lb.letterbox_reference([jpeg.decode(d) for d in datas],
                                         IMG, IMG, 114, device='cuda')
    want = [int(r is None) for _, _, _, r in fixtures]
    one = [jpeg.decode_letterbox(d, IMG, IMG, 114) for d in datas]
    if not (torch.equal(canvases, ref) and np.array_equal(sf, sf_ref) and
            status.tolist() == want and
            all((o is None) == bool(w) for o, w in zip(one, want)) and
            all(torch.equal(o[0], ref[i]) for i, o in enumerate(one)
                if o is not None)):
        raise AssertionError(f'decode_letterbox(_batch) differ from the '
                             f'plain letterbox of the decodes: status '
                             f'{status.tolist()}, want {want}')
    log(f'decode_letterbox_batch of {len(datas)} fixtures on the default '
        f'device: equal to the plain letterbox, status {status.tolist()}')


def letterbox_cases(torch, fixtures, out_h, out_w):
    """The fixtures' cv2 decodes on the card, a 1x1 source, an image at
    the canvas size and a failed decode (None)."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 8)
    images = [torch.from_numpy(ref).cuda() for _, _, _, ref in fixtures
              if ref is not None]
    images.append(torch.randint(0, 256, (1, 1, 3), generator=gen,
                                device='cuda', dtype=torch.uint8))
    images.append(torch.randint(0, 256, (out_h, out_w, 3), generator=gen,
                                device='cuda', dtype=torch.uint8))
    images.append(None)
    return images


def letterbox_bytes(lb, images, out):
    """The bytes the letterbox of ``images`` into ``out`` must move: the
    canvas written once, and of each source image the SECTOR_BYTES sectors,
    as its buffer lies, that hold a pixel with a non-zero tap weight (rows
    and columns from the plain version's ``axis_taps``: a downscale by an
    integer factor needs one row and column in each step)."""
    import numpy as np

    def needed(src, dst):
        i0, i1, w1 = (t.numpy() for t in lb.axis_taps(src, dst))
        return np.unique(np.concatenate([i0[w1 != 32768], i1[w1 != 0]]))

    total = out.numel() * out.element_size()
    for img in images:
        h, w = img.shape[:2]
        nh, nw = lb.target_size(h, w, out.shape[1], out.shape[2])
        first = (img.data_ptr() % SECTOR_BYTES + needed(h, nh)[:, None] * 3 * w
                 + needed(w, nw)[None, :] * 3)
        sectors = np.unique(np.stack([first + k for k in range(3)]) //
                            SECTOR_BYTES)
        total += sectors.size * SECTOR_BYTES
    return total


def check_letterbox_kernel(torch, lb, fixtures):
    """The letterbox kernel against its plain version on the card: every
    fixture (a downscale, an upscale, the identity at 640, odd sizes, a
    1-pixel-high strip), a 1x1 source, an image at the canvas size and a
    failed decode, into each of LETTERBOX_SIZES: the uint8 canvas (BGR,
    pad 0), the uint8 canvas (RGB, pad 114) and the server's float canvas
    (RGB, (v - 114) / 255). Must be equal. Then timed at the serving shape
    (8 fixtures into the float canvas at 640): the kernel (a CUDA graph of
    the launch), the plain version (CUDA events: it is not capturable),
    F.interpolate (bilinear, float, per image: not the same function, so
    ``interpolate_ms`` beside a null ``library_ms``) and the byte bound
    (:func:`letterbox_bytes`). Returns a dict of the times and the max abs
    err."""
    worst = 0.0
    for out_h, out_w in LETTERBOX_SIZES:
        images = letterbox_cases(torch, fixtures, out_h, out_w)
        for kw in (dict(pad_val=0), dict(pad_val=114, to_rgb=True),
                   dict(pad_val=114, to_rgb=True, norm=SERVE_NORM)):
            got, sf = lb.letterbox(images, out_h, out_w, **kw)
            ref, sf_ref = lb.letterbox_reference(images, out_h, out_w, **kw)
            torch.cuda.synchronize()
            err = float((got.double() - ref.double()).abs().max())
            worst = max(worst, err)
            log(f'letterbox {len(images)} images into {(out_h, out_w)} '
                f'{kw}: max abs err {err}')
            if err != 0 or not (sf == sf_ref).all():
                raise AssertionError(f'letterbox kernel differs from its '
                                     f'plain version: {err} ({kw})')
    images = [torch.from_numpy(ref).cuda() for _, _, _, ref in fixtures
              if ref is not None][:BATCH]
    out = torch.empty((BATCH, IMG, IMG, 3), device='cuda')
    kw = dict(pad_val=114, to_rgb=True, norm=SERVE_NORM, out=out)
    sizes = [(img.shape[0], img.shape[1]) +
             lb.target_size(img.shape[0], img.shape[1], IMG, IMG)
             for img in images]
    floats = [img.permute(2, 0, 1)[None].float() for img in images]

    def interpolate():
        for (_, _, nh, nw), x in zip(sizes, floats):
            torch.nn.functional.interpolate(x, size=(nh, nw),
                                            mode='bilinear',
                                            align_corners=False)

    nbytes = letterbox_bytes(lb, images, out)
    timed = dict(
        images=[list(s) for s in sizes],
        ms=graph_ms(lambda: lb.letterbox(images, IMG, IMG, **kw)),
        host_ms=cuda_ms(lambda: lb.letterbox(images, IMG, IMG, **kw)),
        plain_ms=cuda_ms(lambda: lb.letterbox_reference(images, IMG, IMG,
                                                        **kw)),
        library_ms=None,
        interpolate_ms=graph_ms(interpolate),
        interpolate='F.interpolate bilinear per image, float32 NCHW: not '
                    'the same function (other rounding, no pad, no '
                    'normalisation); no PyTorch call computes the letterbox',
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by='bytes',
        max_abs_err=worst)
    timed['bound_share'] = timed['bound_ms'] / timed['ms']
    log('letterbox, 8 fixtures into the float canvas at 640: ' +
        json.dumps(timed))
    return timed


def _post(url, body, ctype):
    """(status, JSON answer) of one POST."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=body,
                                 headers={'Content-Type': ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _percentile(values, q):
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


def serve_requests(bodies, url):
    """SERVE_REQUESTS POSTs of ``bodies``, cycled, half raw and half
    base64 JSON, from SERVE_CLIENTS client threads. Returns (answers,
    latencies in s, wall s)."""
    import base64
    n = SERVE_REQUESTS
    answers, latency = [None] * n, [0.0] * n

    def client(k):
        for i in range(k, n, SERVE_CLIENTS):
            body = bodies[i % len(bodies)]
            if i % 2:
                payload = json.dumps(
                    {'data': base64.b64encode(body).decode()}).encode()
                ctype = 'application/json'
            else:
                payload, ctype = body, 'application/octet-stream'
            t = time.perf_counter()
            answers[i] = _post(url, payload, ctype)
            latency[i] = time.perf_counter() - t

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError('a serving client did not finish')
    return answers, latency, wall


class ServeProbe:
    """Records, in the server's dispatcher thread, each batch it runs: the
    requests' (h, w), the padded canvases and scale factors the model got,
    its four host outputs and each request's answer."""

    def __init__(self, server):
        from tpudet_torch.ops import jpeg
        self.server, self.batches = server, []
        self.infer, self.run_batch = server._infer, server._run_batch
        self.jpeg_info = jpeg.jpeg_info
        server._infer, server._run_batch = self._infer, self._run

    def _run(self, items):
        self.batches.append(dict(hw=[self.jpeg_info(b) for b, _, _ in items]))
        self.run_batch(items)
        self.batches[-1]['answers'] = [slot.get('result')
                                       for _, slot, _ in items]

    def _infer(self, imgs, sfs):
        out = self.infer(imgs, sfs)
        self.batches[-1].update(imgs=imgs.clone(), sfs=sfs.copy(), out=out)
        return out

    def close(self):
        self.server._infer, self.server._run_batch = self.infer, \
            self.run_batch


def check_served_batches(server, probe, answers):
    """Every served answer equals ``Detector`` called directly on the same
    padded batch of canvases (the same code and dtype on the same card:
    equal), formatted as the server formats it; the clients got exactly
    the answers the server made."""
    import numpy as np
    made = []
    for i, b in enumerate(probe.batches):
        direct = probe.infer(b['imgs'], b['sfs'])
        for name, got, want in zip(('bboxes', 'scores', 'labels', 'valid'),
                                   b['out'], direct):
            if not np.array_equal(got, want):
                raise AssertionError(f'served batch {i}: {name} differs '
                                     f'from a direct Detector call')
        for j, (hw, answer) in enumerate(zip(b['hw'], b['answers'])):
            want = server._format(*(o[j] for o in direct), hw)
            if answer != want:
                raise AssertionError(f'served batch {i}, request {j}: the '
                                     f'answer differs from the direct call')
            made.append(json.dumps(answer, sort_keys=True))
    got = [json.dumps(a, sort_keys=True) for _, a in answers]
    if sorted(got) != sorted(made):
        raise AssertionError('the clients got other answers than the '
                             'server made')
    return sum(len(a) for _, a in answers)


def run_serving(torch, tree, fixtures):
    """The serving path: YOLOv4-l 640 in bf16 behind ``ModelServer`` (batch
    8, 10 ms batch delay, weights read back by path) and its HTTP front end
    on loopback; SERVE_REQUESTS requests of the fixtures from
    SERVE_CLIENTS threads with every count at 0 just before; each answer
    against a direct ``Detector`` call on the batch's canvases; launches
    per batch; a truncated JPEG gets 400 and an unknown model 404; then
    requests/s, latency, batch fill, decode and letterbox ms, a profiled
    batch, peak memory. Returns (the served run's launches, its batches,
    the server's ``Detector``)."""
    import tempfile

    from tpudet_torch.data import COCO_CLASSES
    from tpudet_torch.ops import letterbox as lb
    from tpudet_torch.ops import mish
    from tpudet_torch.tools import serve
    from tpudet_torch.utils.checkpoint import save_variables

    bodies = [data for _, data, _, ref in fixtures if ref is not None]
    truncated = next(data for _, data, _, ref in fixtures if ref is None)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'weights.msgpack')
        save_variables(path, tree, meta=dict(CLASSES=list(COCO_CLASSES)))
        t0 = time.perf_counter()
        server = serve.ModelServer(CONFIG, path, batch=BATCH, img_size=IMG,
                                   max_batch_delay_ms=SERVE_DELAY_MS)
    log(f'ModelServer: YOLOv4-l from a msgpack path, bf16, batch {BATCH}, '
        f'{SERVE_DELAY_MS} ms delay, up in '
        f'{time.perf_counter() - t0:.2f} s')
    probe = ServeProbe(server)
    httpd = serve.ThreadingHTTPServer(('127.0.0.1', 0),
                                      serve.make_handler(server, 'yolov4l'))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f'http://127.0.0.1:{httpd.server_address[1]}/predictions/'
    try:
        # the served run, every count at 0 just before
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mish.mish_cuda.launches = 0
        mish.mish_backward_cuda.launches = 0
        lb.letterbox.launches = 0
        answers, latency, wall = serve_requests(bodies, base + 'yolov4l')
        counts = {'mish_fwd': mish.mish_cuda.launches,
                  'mish_bwd': mish.mish_backward_cuda.launches,
                  'letterbox': lb.letterbox.launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_batches = len(probe.batches)
        bad = [st for st, _ in answers if st != 200]
        if bad:
            raise AssertionError(f'{len(bad)} of {SERVE_REQUESTS} requests '
                                 f'not answered 200: {sorted(set(bad))}')
        log(f'served {SERVE_REQUESTS} requests in {n_batches} batches; '
            f'launches {json.dumps(counts)}')
        want = {'mish_fwd': MISH_PER_FORWARD * n_batches, 'mish_bwd': 0,
                'letterbox': n_batches}
        if counts != want:
            raise AssertionError(f'serving launches {counts}, want {want}')
        probe.close()
        n_det = check_served_batches(server, probe, answers)
        fill = [len(b['hw']) for b in probe.batches]
        stats = dict(
            requests=SERVE_REQUESTS, clients=SERVE_CLIENTS, wall_s=wall,
            requests_per_s=SERVE_REQUESTS / wall,
            latency_ms_p50=_percentile(latency, 0.5) * 1e3,
            latency_ms_p99=_percentile(latency, 0.99) * 1e3,
            latency_ms_max=max(latency) * 1e3,
            batches=n_batches, mean_fill=sum(fill) / n_batches / BATCH,
            fill_histogram={k: fill.count(k) for k in sorted(set(fill))},
            detections_over_score_thr=n_det, peak_mem_gib=peak)

        # errors: a truncated JPEG, an unknown model
        status, err = _post(base + 'yolov4l', truncated,
                            'application/octet-stream')
        if status != 400:
            raise AssertionError(f'a truncated JPEG got {status}: {err}')
        status, err = _post(base + 'nope', bodies[0],
                            'application/octet-stream')
        if status != 404:
            raise AssertionError(f'an unknown model got {status}: {err}')

        # one batch's stages, and one profiled batch
        batch = bodies[:BATCH]
        stats['decode_ms_per_image'] = cuda_ms(
            lambda: [server._decode(b) for b in batch], warmup=2,
            runs=5) / len(batch)
        decoded = [server._decode(b) for b in batch]
        canvas = torch.empty((BATCH, IMG, IMG, 3), device='cuda')
        stats['letterbox_ms_per_batch'] = cuda_ms(
            lambda: lb.letterbox(decoded, IMG, IMG, serve.PAD_VAL,
                                 to_rgb=True, norm=SERVE_NORM, out=canvas),
            runs=5)
        stats['infer_ms_per_batch'] = cuda_ms(
            lambda: server._infer(canvas, probe.batches[0]['sfs']),
            warmup=2, runs=5)

        def one_batch():
            items = [(b, {}, threading.Event()) for b in batch]
            server._run_batch(items)
            if any('result' not in slot for _, slot, _ in items):
                raise AssertionError('a profiled request got no result')

        stats['batch_ms'] = cuda_ms(one_batch, warmup=2, runs=5)
        prof = profile_device(torch, one_batch, 'served batch of 8',
                              calls=3)
        if prof:
            stats['profiled_batch_wall_ms'], stats['busy_ms'] = prof[:2]
            stats['busy_share'] = prof[1] / prof[0]
        log('serving: ' + json.dumps(stats))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        server.close()
    return counts, n_batches, server.detector


def run_files_flow(torch, detector, fixtures):
    """JPEG files on the card: the fixtures and a COCO annotation of their
    shapes through ``CocoDataset`` (the config's test pipeline, so
    ``LoadImageFromFile`` decodes with nvJPEG) -> ``DetDataLoader`` ->
    ``single_device_test``, with every count at 0 just before. Each image
    after the pipeline against the same pipeline fed the committed cv2
    decodes, within the decode limits of its form (levels of the canvas
    before ``Normalize``). Returns the launches per batch."""
    import tempfile

    import numpy as np
    from tpudet_torch.apis import single_device_test
    from tpudet_torch.config import Config
    from tpudet_torch.data import CocoDataset
    from tpudet_torch.ops import letterbox as lb
    from tpudet_torch.ops import mish

    cfg = Config.fromfile(CONFIG)
    with open(os.path.join(FIXTURES, 'manifest.json')) as f:
        manifest = json.load(f)
    classes = manifest['classes']
    decodable = [(name, form, ref) for name, _, form, ref in fixtures
                 if ref is not None]
    images, anns, arrays = [], [], {}
    for i, (name, _, ref) in enumerate(decodable):
        entry = manifest['fixtures'][name]
        images.append(dict(id=i + 1, file_name=name, height=ref.shape[0],
                           width=ref.shape[1]))
        for label, box in zip(entry['labels'], entry['bboxes']):
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=label + 1, bbox=box,
                             area=box[2] * box[3], iscrowd=0))
        arrays[i + 1] = ref
    coco = dict(images=images, annotations=anns, categories=[
        dict(id=k + 1, name=n) for k, n in enumerate(classes)])
    with tempfile.TemporaryDirectory() as tmp:
        ann_file = os.path.join(tmp, 'fixtures.json')
        with open(ann_file, 'w') as f:
            json.dump(coco, f)
        files = CocoDataset(ann_file=ann_file,
                            pipeline=cfg['data']['test']['pipeline'],
                            img_prefix=FIXTURES, classes=classes,
                            test_mode=True, device='cuda')
        cv2_decodes = array_dataset(cfg, arrays, coco, 'cuda', tmp,
                                    classes=classes)
        rows = {}
        for i, (name, form, _) in enumerate(decodable):
            a, b = files[i], cv2_decodes[i]
            if a['img_shape'] != b['img_shape'] or not (
                    a['scale_factor'] == b['scale_factor']).all():
                raise AssertionError(f'{name}: the file flow resized to '
                                     f'{a["img_shape"]}, not '
                                     f'{b["img_shape"]}')
            h, w = a['img_shape'][:2]
            levels = ((a['img'] - b['img'])[:h, :w].abs() * 255).round()
            mean_max, band, share_min = DECODE_LIMITS[form]
            rows[name] = dict(mean=float(levels.mean()),
                              max=float(levels.max()),
                              within_band=float((levels <= band).float()
                                                .mean()))
            if rows[name]['mean'] > mean_max or \
                    rows[name]['within_band'] < share_min:
                raise AssertionError(f'{name} after Resize: {rows[name]} '
                                     f'(limits {DECODE_LIMITS[form]})')
        log('files on the card after Resize, nvJPEG vs cv2 decodes (levels):'
            ' ' + json.dumps(rows))

        batches = -(-len(files) // BATCH)
        torch.cuda.synchronize()
        mish.mish_cuda.launches = 0
        mish.mish_backward_cuda.launches = 0
        lb.letterbox.launches = 0
        t0 = time.perf_counter()
        results = single_device_test(detector.model, files,
                                     batch_size=BATCH, img_size=IMG,
                                     progress=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {'mish_fwd': mish.mish_cuda.launches,
                    'mish_bwd': mish.mish_backward_cuda.launches,
                    'letterbox': lb.letterbox.launches}
        if launches['mish_fwd'] != MISH_PER_FORWARD * batches or \
                launches['mish_bwd'] or launches['letterbox']:
            raise AssertionError(f'file flow launches {launches}')
        if len(results) != len(files) or any(
                len(r) != 80 or any(not np.isfinite(a).all() for a in r)
                for r in results):
            raise AssertionError('a missing or non-finite file-flow result')
        log(f'files -> CocoDataset -> DetDataLoader -> single_device_test: '
            f'{len(files)} images in {wall:.3f} s '
            f'({len(files) / wall:.1f} img/s, first pass, bf16), launches '
            f'{json.dumps(launches)}')
    return {k: v // batches for k, v in launches.items()}


# ---------------------------------------------------------------------------
# phase 13: data-parallel training (tpudet_torch/parallel/mesh.py)

DIST_MICRO = 6  # per rank: 2 ranks x 6 = phase 6's micro-batch of 12
# the synced steps accumulate 2 of those micro-batches (phase 6 takes 6);
# over gloo each micro-batch's SyncBN sums cross the host
DIST_ACCUM = 2
DIST_BF16_STEPS = 1  # timed, after one untimed bf16 step
DIST_TIMEOUT_S = 300  # a rank's wait for the other at each collective
# the shapes recipe on the committed shapes set (paths from ROOT)
CONFIG_SHAPES = os.path.join(
    ROOT, 'docs/torch_train_runs/yolov4s_shapes_320_fixture.py')
DIST_CLI_STEPS = 1
DIST_CLI_TIMEOUT_S = 300


class AllReduceProbe:
    """``torch.distributed.all_reduce`` wrapped while the probe is open:
    the calls, their bytes and the host seconds each takes from a
    synchronized device to its result on the device (the card is
    synchronized before and after every call, so the time is the
    collective's alone; gloo synchronizes at each call anyway)."""

    def __init__(self, torch):
        self.torch = torch
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0
        self.largest = 0

    def __enter__(self):
        dist = self.torch.distributed
        self.real = dist.all_reduce

        def counted(tensor, *args, **kwargs):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.real(tensor, *args, **kwargs)
            self.torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            n = tensor.numel() * tensor.element_size()
            self.bytes += n
            self.largest = max(self.largest, n)
            return out
        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        self.torch.distributed.all_reduce = self.real

    def summary(self):
        return dict(all_reduces=self.calls, all_reduce_mb=self.bytes / 1e6,
                    largest_mb=self.largest / 1e6,
                    collective_ms=self.seconds * 1e3)


def rank_shard(batch, rank, world, micro):
    """Rank ``rank``'s loader batch whose micro-batch ``i`` is its slice
    of the single-process micro-batch ``i`` (``world * micro`` rows): the
    ranks together take the single-process step's micro-batches."""
    import numpy as np
    step = world * micro
    n = len(batch['img']) // step
    return {k: np.concatenate([v[i * step + rank * micro:
                                 i * step + (rank + 1) * micro]
                               for i in range(n)]) for k, v in batch.items()}


def dist_rank(rank, root, tree_path):
    """One of two ranks on the one card (gloo with CUDA tensors): the fp32
    step on this rank's shard of (a)'s DIST_ACCUM micro-batches, then
    1 + DIST_BF16_STEPS bf16 steps, timed. Writes its results to
    ``root/rank<r>.pkl``; a failure is written there too, and raised."""
    import datetime
    import pickle
    import traceback
    out = os.path.join(root, f'rank{rank}.pkl')
    try:
        import torch
        sys.path.insert(0, ROOT)
        from tpudet_torch.apis import init_trainer
        from tpudet_torch.config import Config
        from tpudet_torch.ops import mish
        from tpudet_torch.parallel import (close_distributed,
                                           init_distributed)
        from tpudet_torch.utils.checkpoint import load_variables
        from tpudet_torch.utils.flax_import import train_state_to_flax
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        device = init_distributed(
            f'file://{os.path.join(root, "rendezvous")}', 2, rank,
            backend='gloo', device='cuda',
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        tree, _ = load_variables(tree_path)
        cfg = Config.fromfile(CONFIG)
        cfg['data'] = dict(cfg['data'], samples_per_gpu=DIST_MICRO)
        cfg['nominal_batch_size'] = DIST_ACCUM * MICRO_BATCH
        trainer = init_trainer(cfg, variables=tree, device=device,
                               max_steps=2 + DIST_BF16_STEPS)
        if trainer.accumulation != DIST_ACCUM:
            raise AssertionError(f'accumulation {trainer.accumulation}')
        batch = rank_shard(train_batch(DIST_ACCUM * MICRO_BATCH,
                                       SEED + 100), rank, 2, DIST_MICRO)
        torch.cuda.synchronize()
        mish.mish_cuda.launches = 0
        mish.mish_backward_cuda.launches = 0
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in trainer.step(batch).items()}
        torch.cuda.synchronize()
        metrics['step_ms'] = (time.perf_counter() - t0) * 1e3
        launches = {'mish_fwd': mish.mish_cuda.launches,
                    'mish_bwd': mish.mish_backward_cuda.launches}
        state = train_state_to_flax(trainer.state, trainer.model)
        checksum = sum(float(p.detach().double().abs().sum())
                       for p in trainer.state.params.values())
        trainer.model.dtype = torch.bfloat16
        timed = []
        for step in range(1 + DIST_BF16_STEPS):
            batch = rank_shard(train_batch(DIST_ACCUM * MICRO_BATCH,
                                           SEED + 300 + step), rank, 2,
                               DIST_MICRO)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with AllReduceProbe(torch) as probe:
                t0 = time.perf_counter()
                m = trainer.step(batch)
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) * 1e3
            timed.append(dict(step_ms=step_ms, **probe.summary(),
                              loss=float(m['loss']),
                              peak_mem_gib=torch.cuda.max_memory_allocated()
                              / 2**30))
        close_distributed()
        result = dict(metrics=metrics, launches=launches, state=state,
                      checksum=checksum, bf16=timed, device=str(device))
    except BaseException:
        result = dict(error=traceback.format_exc())
    with open(out, 'wb') as f:
        pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
    if 'error' in result:
        raise SystemExit(1)


def start_dist_ranks(tree, root):
    """(b), started: two ranks on the one card over gloo, each a process
    of its own, from ``tree`` written under ``root``. Returns the
    processes and their start time."""
    import multiprocessing
    from tpudet_torch.utils.checkpoint import save_variables
    tree_path = os.path.join(root, 'tree.msgpack')
    save_variables(tree_path, tree)
    ctx = multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=dist_rank, args=(r, root, tree_path))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    return procs, t0


def stop_procs(procs):
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()


def run_dist_ranks(torch, started, root, ref):
    """(b), collected: the two ranks' fp32 step against the single-process
    step ``ref`` on the same micro-batches, equal checksums, DIST_ACCUM x
    108 launches of each mish kernel a rank, then the bf16 step's ms,
    collective share and peak memory per rank."""
    import pickle
    ref_metrics, ref_state, init = ref
    procs, t0 = started
    for p in procs:
        p.join(DIST_TIMEOUT_S + 120)
    stop_procs(procs)
    ranks = []
    for r, p in enumerate(procs):
        path = os.path.join(root, f'rank{r}.pkl')
        res = {}
        if os.path.exists(path):
            with open(path, 'rb') as f:
                res = pickle.load(f)
        if 'error' in res:
            raise AssertionError(f'rank {r} failed:\n{res["error"]}')
        if p.exitcode != 0 or 'state' not in res:
            raise AssertionError(f'rank {r} exited with {p.exitcode}')
        ranks.append(res)
    log(f'two ranks on one card (gloo through the host): '
        f'{time.perf_counter() - t0:.1f} s with start-up, beside (a) and '
        f'(c)')
    want = {'mish_fwd': DIST_ACCUM * MISH_PER_FORWARD,
            'mish_bwd': DIST_ACCUM * MISH_PER_FORWARD}
    for r, res in enumerate(ranks):
        if res['device'] != 'cuda:0':
            raise AssertionError(f'rank {r} ran on {res["device"]}')
        if res['launches'] != want:
            raise AssertionError(f'rank {r}: launches {res["launches"]}, '
                                 f'not {want}')
        check_step_against(f'gloo rank {r} fp32 step vs one process',
                           res['metrics'], res['state'], ref_metrics,
                           ref_state, init)
        for row in res['bf16']:
            row['collective_share'] = row['collective_ms'] / row['step_ms']
        log(f'gloo through the host on one card, rank {r} bf16 steps '
            f'(first untimed): ' + json.dumps(res['bf16']))
    if ranks[0]['checksum'] != ranks[1]['checksum']:
        raise AssertionError(f'checksums differ: {ranks[0]["checksum"]} vs '
                             f'{ranks[1]["checksum"]}')
    log(f'gloo ranks: final param checksum {ranks[0]["checksum"]:.9e} on '
        f'both')
    return [res['launches'] for res in ranks]


def run_dist_one_rank(torch, tree):
    """(a): one fp32 step (TF32 off) of YOLOv4-l 640 on DIST_ACCUM of
    phase 6's micro-batches without a process group, then the same step
    inside a
    one-rank NCCL group opened here, so that the synced path runs
    (SyncBN's function, ``global_sum``, the flat gradient all-reduce);
    the two within phase 6's card tolerance. Returns the unsynced step
    (the reference of (b)) and the synced step's launches."""
    import tempfile
    from tpudet_torch.config import Config
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.fromfile(CONFIG)
    cfg['nominal_batch_size'] = DIST_ACCUM * MICRO_BATCH
    batch = train_batch(DIST_ACCUM * MICRO_BATCH, SEED + 100)
    ref_metrics, _, init, ref_state = fp32_step(torch, tree, cfg, batch)
    with tempfile.TemporaryDirectory() as root:
        store = torch.distributed.FileStore(os.path.join(root, 'store'), 1)
        torch.distributed.init_process_group('nccl', store=store, rank=0,
                                             world_size=1)
        try:
            with AllReduceProbe(torch) as probe:
                metrics, launches, _, state = fp32_step(torch, tree, cfg,
                                                        batch)
        finally:
            torch.distributed.destroy_process_group()
    summary = probe.summary()
    log('NCCL one-rank step: ' + json.dumps(dict(launches=launches,
                                                  **summary)))
    n_params = sum(v.size for v in _leaves(init.params))
    if probe.largest != 4 * n_params:
        raise AssertionError(f'no flat fp32 gradient all-reduce of '
                             f'{n_params} params (largest '
                             f'{probe.largest} bytes)')
    want = DIST_ACCUM * MISH_PER_FORWARD
    if launches != {'mish_fwd': want, 'mish_bwd': want}:
        raise AssertionError(f'synced step: launches {launches}')
    check_step_against('NCCL one-rank step vs no group', metrics, state,
                       ref_metrics, ref_state, init)
    return (ref_metrics, ref_state, init), launches


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def run_dist_clis(torch, weights):
    """(c): the train CLI with two processes on the one card (gloo) for
    DIST_CLI_STEPS steps of the shapes recipe on the committed shapes set
    (CONFIG_SHAPES), 4 images a rank; only rank 0 writes
    ``latest_ema.msgpack``, which loads into the recipe's model, equal
    checksums; beside it the test CLI on ``weights`` (the recipe's model
    drawn by the caller) with two processes against one: equal
    reports."""
    import subprocess
    import tempfile

    from tpudet_torch.config import Config
    from tpudet_torch.models.builder import build_detector
    from tpudet_torch.utils.checkpoint import load_variables
    from tpudet_torch.utils.flax_import import load_flax_variables

    def start(cmds, env=None):
        return cmds, [subprocess.Popen([sys.executable, '-m'] + c, cwd=ROOT,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, env=env)
                      for c in cmds]

    def finish(started):
        cmds, procs = started
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=DIST_CLI_TIMEOUT_S)[0]
                            .decode(errors='replace'))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for c, p, out in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise AssertionError(f'{" ".join(c)} exited with '
                                     f'{p.returncode}:\n{out[-4000:]}')
        return outs

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dist = ['--num-processes', '2', '--dist-backend', 'gloo',
                '--dist-timeout', str(DIST_TIMEOUT_S)]
        train = start([
            ['tpudet_torch.tools.train', CONFIG_SHAPES, '--work-dir',
             f'{tmp}/w{r}', '--max-steps', str(DIST_CLI_STEPS),
             '--no-resume', '--coordinator', f'file://{tmp}/rdzv_train',
             '--process-id', str(r)] + dist +
            ['--cfg-options', 'data.samples_per_gpu=4'] for r in range(2)])
        test = ['tpudet_torch.tools.test', CONFIG_SHAPES, weights,
                '--img-size', '320']
        try:
            # TF32 off (NVIDIA_TF32_OVERRIDE), so the reports compare fp32
            # numerics. The equality flaked (map 9.10e-6 against 9.21e-6,
            # then 6.37e-7 against 7.01e-7 with TF32 off) while a decoder
            # state could be reused before its copies ran: on this busy
            # card the loaders' nvJPEG decodes came out corrupt
            # (check_decode_behind holds that fixed)
            tests = start([test + ['--out', f'{tmp}/two{r}.json',
                                   '--coordinator',
                                   f'file://{tmp}/rdzv_test', '--process-id',
                                   str(r)] + dist for r in range(2)] +
                          [test + ['--out', f'{tmp}/one.json']],
                          env=dict(os.environ, NVIDIA_TF32_OVERRIDE='0'))
        except BaseException:
            finish(train)
            raise
        try:
            finish(train)
        finally:
            outs = finish(tests)
        train_s = time.perf_counter() - t0
        checksums = []
        for r in range(2):
            with open(f'{tmp}/w{r}/train.log') as f:
                log_lines = f.read().splitlines()
            if not any(f'devices 2 global / 1 local, process {r}/2' in ln
                       for ln in log_lines):
                raise AssertionError(f'rank {r} did not join: {log_lines}')
            checksums.append([ln.split('checksum')[1] for ln in log_lines
                              if 'final param checksum' in ln])
        if checksums[0] != checksums[1] or len(checksums[0]) != 1:
            raise AssertionError(f'train CLI checksums {checksums}')
        if not os.path.exists(f'{tmp}/w0/latest_ema.msgpack') or \
                sorted(os.listdir(f'{tmp}/w1')) != ['train.log']:
            raise AssertionError(f'rank 1 wrote {os.listdir(f"{tmp}/w1")}')
        with torch.device('meta'):
            model = build_detector(Config.fromfile(CONFIG_SHAPES)['model'])
        load_flax_variables(model.to_empty(device='cpu'), load_variables(
            f'{tmp}/w0/latest_ema.msgpack')[0])  # strict: every leaf
        test_s = train_s
        with open(f'{tmp}/two0.json') as f:
            two = json.load(f)
        with open(f'{tmp}/one.json') as f:
            one = json.load(f)
        if os.path.exists(f'{tmp}/two1.json') or '"map"' in outs[1]:
            raise AssertionError('rank 1 of the test CLI wrote or printed')
        delta = max((abs(two[k] - one[k]) for k in one
                     if math.isfinite(one[k])), default=0.0)
        log(f'CLIs: train 2 x {DIST_CLI_STEPS} steps and, beside it, test 2 '
            f'+ 1 processes {test_s:.1f} s; train checksum '
            f'{checksums[0][0].strip()} on both, rank 0\'s EMA weights load '
            f'into the recipe\'s model; test report max delta {delta} ' +
            json.dumps(one))
        # equal, NaN (no gt of a size) where NaN
        if json.dumps(two, sort_keys=True) != json.dumps(one,
                                                         sort_keys=True):
            raise AssertionError(f'2-process report {two} != {one}')


def run_data_parallel(torch, tree):
    """Phase 13: (a) NCCL at world size 1, (b) two ranks on the card over
    gloo, (c) the CLIs' multi-process flags. (c) starts first, in a thread
    of its own, then (b)'s processes, and both run beside (a): the three
    share nothing but the card and the host (their step times are taken
    under that load); (b)'s ranks are checked against (a)'s step when
    both are done. Returns the mish launches of the synced steps by
    path."""
    import shutil
    import tempfile
    from tpudet_torch.config import Config
    from tpudet_torch.utils.checkpoint import save_variables
    root = tempfile.mkdtemp()
    t_clis, failed = time.perf_counter(), []
    shapes = os.path.join(root, 'shapes.msgpack')
    cfg = Config.fromfile(CONFIG_SHAPES)
    save_variables(shapes, make_variables(torch, cfg, images(2, SEED + 9)[
        :, :320, :320]))

    def clis():
        try:
            run_dist_clis(torch, shapes)
            log(f'(c) CLIs: {time.perf_counter() - t_clis:.1f} s from their '
                f'start, beside (a) and (b)')
        except BaseException as e:  # raised again below
            failed.append(e)
    cli_thread = threading.Thread(target=clis, name='phase 13 (c) CLIs')
    cli_thread.start()
    ranks = None
    try:
        ranks = start_dist_ranks(tree, root)
        t0 = time.perf_counter()
        ref, nccl_launches = run_dist_one_rank(torch, tree)
        log(f'(a) NCCL one rank: {time.perf_counter() - t0:.1f} s')
        t0 = time.perf_counter()
        rank_launches = run_dist_ranks(torch, ranks, root, ref)
        del ref
        log(f'(b) two gloo ranks: {time.perf_counter() - t0:.1f} s after '
            f'(a)')
    finally:
        if ranks is not None:
            stop_procs(ranks[0])
        cli_thread.join()
        shutil.rmtree(root, ignore_errors=True)
    if failed:
        raise failed[0]
    return {name: {'nccl_one_rank_step': nccl_launches[name],
                   'gloo_rank0_step': rank_launches[0][name],
                   'gloo_rank1_step': rank_launches[1][name]}
            for name in ('mish_fwd', 'mish_bwd')}


# ---------------------------------------------------------------------------
# phase 14: the other datasets, flip TTA, the image demo, the garbage
# recipe (tpudet_torch/data/custom.py, apis/test.py, visualization.py,
# demo/image_demo.py)

SHAPES = os.path.join(ROOT, 'tests/torch_fixtures/shapes')
SHAPES_CLASSES = ('rect', 'circle', 'triangle')
TTA_FP32_IMAGES = 2  # fp32 TTA card vs CPU: two forwards of YOLOv4-l
# fp32 TTA, card vs CPU: the merge's candidates, matched by anchor, boxes
# within TTA_BOX_ATOL px and scores within DET_ATOL; the head's objectness
# logits within TTA_LOGIT_ATOL, and an anchor that only one side keeps
# within it of the other side's cut. tests/test_torch_tta.py holds boxes
# to 1e-3 px at 128 px and a 64-channel neck; at 640 and full width the
# card's fp32 convolutions leave the logits 1.4e-4 and the boxes 3.1e-3
# px from the CPU's (NVIDIA H100, 2 images)
TTA_BOX_ATOL = 1e-2
TTA_LOGIT_ATOL = 1e-3
DEMO_IMAGE = os.path.join(SHAPES, 'val/images/000000.jpg')
CONFIG_GARBAGE = os.path.join(ROOT,
                              'configs/garbage/yolov4l_garbage_mosaic.py')
GARBAGE_MICRO = 10  # x ACCUMULATION = 60 images a step; the set holds 64
GARBAGE_STEPS = 2


def shapes_sets(tmp, pipeline):
    """The committed shapes val set (32 JPEGs, 3 classes) in every
    layout, each read by its dataset on the card in test mode: COCO,
    VOC XML, a ``GarbageDataset`` json, a ``.circle`` folder, LVIS."""
    from tpudet_torch.data import (CocoDataset, GarbageDataset, LVISDataset,
                                   TrafficSignDataset, VOCDataset)
    from tpudet_torch.tools import dataset_formats as formats
    ann = os.path.join(SHAPES, 'val.json')
    with open(ann) as f:
        coco = json.load(f)
    img_dir = os.path.join(SHAPES, 'val', 'images')
    common = dict(pipeline=pipeline, test_mode=True, device='cuda')
    voc = formats.write_voc(coco, img_dir, os.path.join(tmp, 'voc'))
    circle = formats.write_circle(coco, img_dir, os.path.join(tmp, 'circle'))
    return coco, {
        'coco': CocoDataset(ann_file=ann, img_prefix=img_dir,
                            classes=SHAPES_CLASSES, **common),
        'voc': VOCDataset(ann_file=voc, img_prefix=os.path.join(tmp, 'voc'),
                          classes=SHAPES_CLASSES, **common),
        'garbage': GarbageDataset(
            ann_file=formats.write_custom(coco, os.path.join(tmp, 'custom')),
            img_prefix=img_dir, classes=SHAPES_CLASSES, **common),
        'circle': TrafficSignDataset(ann_file=circle, img_prefix=circle,
                                     **common),
        'lvis': LVISDataset(
            ann_file=formats.write_lvis(coco, os.path.join(tmp, 'lvis')),
            img_prefix=img_dir, **common)}


def check_shapes_sets(torch, sets):
    """(a) Every image through every dataset: the pipeline's output on the
    card bit-equal to ``CocoDataset``'s (image, ``scale_factor``,
    ``img_shape``), the eval annotations equal (the boxes only for the
    one-class ``.circle`` layout)."""
    import numpy as np
    ref_ds = sets['coco']
    n = len(ref_ds)
    if any(len(ds) != n for ds in sets.values()) or n != 32:
        raise AssertionError(f'set lengths {[len(d) for d in sets.values()]}')
    t0 = time.perf_counter()
    for i in range(n):
        ref = ref_ds[i]
        ref_ann = ref_ds.get_ann_info_test(i)
        if ref['img'].device.type != 'cuda':
            raise AssertionError('the pipeline did not run on the card')
        for name, ds in sets.items():
            if name == 'coco':
                continue
            out = ds[i]
            if not torch.equal(out['img'], ref['img']) or \
                    out['img_shape'] != ref['img_shape'] or \
                    not np.array_equal(out['scale_factor'],
                                       ref['scale_factor']):
                raise AssertionError(f'{name} image {i}: the pipeline '
                                     f'output differs from CocoDataset\'s')
            ann = ds.get_ann_info_test(i)
            keys = ['gt_bboxes'] if name == 'circle' else ['gt_bboxes',
                                                           'gt_labels']
            same = all(np.array_equal(ann[k], ref_ann[k]) for k in keys)
            if name != 'circle':
                same = same and all(
                    np.array_equal(ann['gt_attrs'][k], ref_ann['gt_attrs'][k])
                    for k in ('ignore', 'iscrowd', 'area'))
            if not same:
                raise AssertionError(f'{name} image {i}: eval annotations '
                                     f'differ from CocoDataset\'s')
    log(f'datasets on the card, {n} images each, pipeline output and eval '
        f'annotations equal to CocoDataset\'s: {sorted(sets)} '
        f'({time.perf_counter() - t0:.1f} s)')


def shapes_config(cfg, path):
    """Write a config at ``path``: CONFIG with its test set the committed
    shapes val set (its classes, CONFIG's test pipeline)."""
    with open(path, 'w') as f:
        f.write(f'_base_ = {CONFIG!r}\n'
                f"data = dict(test=dict(type='CocoDataset', "
                f'ann_file={os.path.join(SHAPES, "val.json")!r}, '
                f'img_prefix={os.path.join(SHAPES, "val", "images")!r}, '
                f'classes={SHAPES_CLASSES!r}, '
                f'pipeline={cfg["data"]["test"]["pipeline"]!r}))\n')
    return path


def same_results(a, b):
    import numpy as np
    return len(a) == len(b) and all(
        len(x) == len(y) and all(np.array_equal(u, v) for u, v in zip(x, y))
        for x, y in zip(a, b))


def recording(module, name):
    """A context in which ``module.name`` runs as before and records each
    call as ``(args, kwargs, output)`` in the list it yields."""
    import contextlib

    @contextlib.contextmanager
    def context():
        fn, calls = getattr(module, name), []

        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((args, kwargs, out))
            return out

        setattr(module, name, recorded)
        try:
            yield calls
        finally:
            setattr(module, name, fn)
    return context()


def nms_ms(torch, fn, call):
    """ms of ``fn`` on the arguments of one recorded call."""
    args, kwargs, _ = call
    with torch.inference_mode():
        return cuda_ms(lambda: fn(*args, **kwargs), runs=5)


def compare_candidates(card, cpu):
    """The merge's candidates on the card and the CPU, matched by anchor:
    each side's recorded ``(ranks, nms call)``, ``ranks`` the head's
    objectness top-k ``(vals, idx)`` of each pass, the call's boxes and
    scores those passes' slots in that order. Over the anchors both sides
    keep, in anchor order: the max box, score and logit gaps; of those
    only one side keeps, their number and how far the highest lies over
    the other side's cut."""
    import numpy as np

    def host(side):
        ranks, (args, _, _) = side
        return ([(v.float().cpu().numpy(), i.cpu().numpy())
                 for (_, _, (v, i)) in ranks],
                args[0].float().cpu().numpy(), args[1].float().cpu().numpy())

    (c_ranks, c_box, c_score), (p_ranks, p_box, p_score) = host(card), \
        host(cpu)
    out = dict(anchors=0, same_order=True, box_gap=0.0, score_gap=0.0,
               logit_gap=0.0, one_side=0, over_cut=0.0)
    for p, ((cv, ci), (pv, pi)) in enumerate(zip(c_ranks, p_ranks)):
        k = ci.shape[1]
        for b in range(ci.shape[0]):
            out['same_order'] &= bool(np.array_equal(ci[b], pi[b]))
            _, jc, jp = np.intersect1d(ci[b], pi[b], assume_unique=True,
                                       return_indices=True)
            out['anchors'] += len(jc)
            sc, sp = p * k + jc, p * k + jp
            out['box_gap'] = max(out['box_gap'], float(
                np.abs(c_box[b, sc] - p_box[b, sp]).max()))
            out['score_gap'] = max(out['score_gap'], float(
                np.abs(c_score[b, sc] - p_score[b, sp]).max()))
            out['logit_gap'] = max(out['logit_gap'], float(
                np.abs(cv[b, jc] - pv[b, jp]).max()))
            for v, j, cut in ((cv[b], jc, pv[b, -1]), (pv[b], jp, cv[b, -1])):
                only = np.setdiff1d(np.arange(k), j)
                out['one_side'] += len(only)
                if len(only):
                    out['over_cut'] = max(out['over_cut'],
                                          float(v[only].max() - cut))
    return out


def check_tta_fp32(torch, cfg, tree, coco, tmp):
    """(b) fp32 (TF32 off, PyTorch's defaults again after it) flip TTA on
    the set's first TTA_FP32_IMAGES images, decoded on the card with
    nvJPEG and fed as arrays to the card and the CPU: the merge's
    candidates in anchor order (``compare_candidates``), the merge on the
    CPU's candidates run on both one-to-one, and the detections one-to-one
    per image and class by phase 5's ``match_per_class`` (IoU >=
    MATCH_IOU, a box under 1 px by its corners) with scores within
    DET_ATOL."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = tta_fp32(torch, cfg, tree, coco, tmp)
    finally:  # as a new process has them (the image demo's)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    c, merge, (paired, n_ref, n_got, by_corner) = \
        got['candidates'], got['merge_on_same_candidates'], \
        got['detections']
    log(f'fp32 TTA, card vs CPU: the merge\'s candidates, {c["anchors"]} '
        f'anchors kept on both (same order: {c["same_order"]}), in anchor '
        f'order: boxes within {c["box_gap"]:.3e} px (tolerance '
        f'{TTA_BOX_ATOL}), scores within {c["score_gap"]:.3e} ({DET_ATOL}), '
        f'objectness logits within {c["logit_gap"]:.3e} ({TTA_LOGIT_ATOL}); '
        f'{c["one_side"]} kept on one side, at most {c["over_cut"]:.3e} over '
        f'the other\'s cut ({TTA_LOGIT_ATOL}); the merge on the CPU\'s '
        f'candidates, card vs CPU: {merge[0]} paired of {merge[1]} / '
        f'{merge[2]}; the detections: {paired} paired of {n_ref} / {n_got} '
        f'(per class, IoU >= {MATCH_IOU} or {by_corner} under 1 px by '
        f'corners within {MATCH_CORNER_PX} px, scores within {DET_ATOL}); '
        f'{got["scores_over_0.999"]} of the CPU\'s scores over 0.999')
    if not (c['box_gap'] <= TTA_BOX_ATOL and c['score_gap'] <= DET_ATOL and
            c['logit_gap'] <= TTA_LOGIT_ATOL and
            c['over_cut'] <= TTA_LOGIT_ATOL and c['anchors'] > 0):
        raise AssertionError('fp32 TTA: the merge\'s candidates on the card '
                             'differ from the CPU\'s')
    if not merge[0] == merge[1] == merge[2] > 0:
        raise AssertionError('fp32 TTA: the merge of the same candidates '
                             'differs on the card')
    if not paired == n_ref == n_got > 0:
        raise AssertionError('fp32 TTA: the detections on the card differ '
                             'from the CPU\'s')
    return got


def tta_fp32(torch, cfg, tree, coco, tmp):
    """fp32 flip TTA through ``single_device_test`` on the card and the
    CPU, the head's objectness top-k and the merge's ``batched_nms``
    recorded on each; the numbers that ``check_tta_fp32`` holds."""
    from tpudet_torch.apis import (init_detector, nms_result_to_per_class,
                                   single_device_test)
    from tpudet_torch.apis import test as api_test
    from tpudet_torch.models.dense_heads import yolocsp_head
    from tpudet_torch.ops import jpeg
    first = dict(coco, images=coco['images'][:TTA_FP32_IMAGES])
    arrays = {}
    for im in first['images']:
        with open(os.path.join(SHAPES, 'val/images', im['file_name']),
                  'rb') as f:
            arrays[im['id']] = jpeg.decode_image(f.read(),
                                                 'cuda').cpu().numpy()
    out, recorded = {}, {}
    for device in ('cuda', 'cpu'):
        det = init_detector(cfg, variables=tree, device=device,
                            dtype=torch.float32)
        ds = array_dataset(cfg, arrays, first, device, tmp,
                           classes=SHAPES_CLASSES)
        t0 = time.perf_counter()
        with recording(yolocsp_head, 'topk_scores') as ranks, \
                recording(api_test, 'batched_nms') as merges:
            out[device] = single_device_test(det.model, ds,
                                             batch_size=TTA_FP32_IMAGES,
                                             img_size=IMG, progress=False,
                                             tta=True)
        log(f'fp32 TTA on {device}, {TTA_FP32_IMAGES} images: '
            f'{time.perf_counter() - t0:.1f} s')
        if len(ranks) != 2 or len(merges) != 1:
            raise AssertionError(f'fp32 TTA on {device}: {len(ranks)} '
                                 f'objectness top-k and {len(merges)} merges '
                                 f'for one batch, not 2 and 1')
        recorded[device] = (ranks, merges[0])
        del det
        torch.cuda.empty_cache()
    args, kwargs, _ = recorded['cpu'][1]
    same_in = [api_test.batched_nms(*(a.to(device) if torch.is_tensor(a)
                                      else a for a in args), **kwargs)
               for device in ('cpu', 'cuda')]
    merge = [match_per_class(r, g, MATCH_IOU) for r, g in zip(*(
        nms_result_to_per_class(res, 80) for res in same_in))]
    dets = [match_per_class(r, g, MATCH_IOU, DET_ATOL)
            for r, g in zip(out['cpu'], out['cuda'])]
    return {'candidates': compare_candidates(recorded['cuda'],
                                             recorded['cpu']),
            'merge_on_same_candidates': [sum(m[k] for m in merge)
                                         for k in range(3)],
            'detections': [sum(m[k] for m in dets) for k in range(4)],
            'scores_over_0.999': int(sum((a[:, 4] > 0.999).sum()
                                         for r in out['cpu'] for a in r))}


def run_tta(torch, cfg, tree, coco, ds, tmp):
    """(b) flip TTA, bf16, the set at batch 8 through
    ``single_device_test(tta=True)`` once with every count at 0 just
    before (216 / 0 launches a batch), the plain and the TTA flow timed in
    turns, each profiled once; the two NMS calls timed on a batch's own
    candidates, recorded from the flows (TTA's merge, one ``batched_nms``
    with ``nms_pre=4096``, and the plain path's
    ``batched_class_lane_nms``); fp32 card vs CPU; then the test CLI with
    ``--tta --metrics bbox proposal_fast`` against the API. Returns the
    launches a batch and the numbers."""
    import numpy as np
    from tpudet_torch.apis import init_detector, single_device_test
    from tpudet_torch.apis import test as api_test
    from tpudet_torch.core import nms
    from tpudet_torch.data import build_dataset
    from tpudet_torch.evaluation import (coco_fast_bbox_eval,
                                         coco_proposal_fast_eval)
    from tpudet_torch.models.dense_heads import yolocsp_head
    from tpudet_torch.ops import mish
    from tpudet_torch.tools import test as cli
    from tpudet_torch.utils.checkpoint import save_variables
    batches = -(-len(ds) // BATCH)
    det = init_detector(cfg, variables=tree, device='cuda',
                        dtype=torch.bfloat16)
    kw = dict(batch_size=BATCH, img_size=IMG, progress=False)
    torch.cuda.synchronize()
    mish.mish_cuda.launches = 0
    mish.mish_backward_cuda.launches = 0
    with recording(api_test, 'batched_nms') as merges:
        results = single_device_test(det.model, ds, tta=True, **kw)
    torch.cuda.synchronize()
    launches = {'mish_fwd': mish.mish_cuda.launches,
                'mish_bwd': mish.mish_backward_cuda.launches}
    log(f'TTA eval flow launches over {batches} batches: '
        f'{json.dumps(launches)}')
    if launches != {'mish_fwd': 2 * MISH_PER_FORWARD * batches,
                    'mish_bwd': 0}:
        raise AssertionError(f'TTA launches {launches}, not '
                             f'{2 * MISH_PER_FORWARD} forward per batch')
    n_det = sum(len(a) for r in results for a in r)
    if len(results) != len(ds) or any(
            len(r) != 80 or any(a.ndim != 2 or a.shape[1] != 5 or
                                not np.isfinite(a).all() for a in r)
            for r in results) or not n_det:
        raise AssertionError('a missing, malformed or non-finite TTA result')

    walls = {'plain': [], 'tta': []}
    for mode in ('plain', 'tta', 'tta', 'plain', 'plain', 'tta'):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single_device_test(det.model, ds, tta=mode == 'tta', **kw)
        torch.cuda.synchronize()
        walls[mode].append((time.perf_counter() - t0) * 1e3 / batches)
    numbers = dict(detections=n_det,
                   plain_ms_per_batch=walls['plain'],
                   tta_ms_per_batch=walls['tta'],
                   tta_over_plain=statistics.median(walls['tta']) /
                   statistics.median(walls['plain']))
    for mode in ('plain', 'tta'):
        prof = profile_device(
            torch, lambda: single_device_test(det.model, ds,
                                              tta=mode == 'tta', **kw),
            f'{mode} eval run', calls=1, top=12)
        if prof:
            numbers[f'{mode}_busy_ms_per_batch'] = prof[1] / batches
            numbers[f'{mode}_busy_share'] = prof[1] / prof[0]
    with recording(yolocsp_head, 'batched_class_lane_nms') as lanes:
        single_device_test(det.model, ds, **kw)
    numbers.update(
        tta_candidates=int(np.prod(merges[0][0][1].shape[1:])),
        tta_nms_ms=nms_ms(torch, nms.batched_nms, merges[0]),
        plain_nms_ms=nms_ms(torch, nms.batched_class_lane_nms, lanes[0]))
    del merges, lanes
    log('flip TTA against the plain eval flow, bf16 batch 8: '
        + json.dumps(numbers))
    del det
    torch.cuda.empty_cache()

    numbers['fp32_card_vs_cpu'] = check_tta_fp32(torch, cfg, tree, coco,
                                                 tmp)

    # the test CLI with both flags against the API, fp32
    ckpt = os.path.join(tmp, 'weights.msgpack')
    save_variables(ckpt, tree)
    cfg_file = shapes_config(cfg, os.path.join(tmp, 'tta_config.py'))
    t0 = time.perf_counter()
    report = cli.main([cfg_file, ckpt, '--batch-size', str(BATCH),
                       '--img-size', str(IMG), '--tta', '--metrics', 'bbox',
                       'proposal_fast'])
    cli_s = time.perf_counter() - t0
    api_det = init_detector(cfg_file, ckpt, device='cuda',
                            dtype=torch.float32)
    api_ds = build_dataset({**api_det.cfg['data']['test'],
                            'test_mode': True}, dict(device='cuda'))
    api = single_device_test(api_det.model, api_ds, tta=True, **kw)
    annos = [api_ds.get_ann_info_test(i) for i in range(len(api_ds))]
    ref = dict(coco_fast_bbox_eval(api, annos, classes=api_ds.CLASSES),
               **coco_proposal_fast_eval(api, annos))
    gap = max(abs(report[k] - v) for k, v in ref.items()
              if not (math.isnan(v) and math.isnan(report[k])))
    log(f'test CLI --tta --metrics bbox proposal_fast ({cli_s:.1f} s): '
        f'{json.dumps(report)}; the API: {json.dumps(ref)}; max |delta| '
        f'{gap:.3e} (tolerance {REPORT_ATOL})')
    if list(report) != list(ref) or not gap <= REPORT_ATOL or \
            'AR@1000' not in report:
        raise AssertionError('the test CLI --tta report differs from the '
                             'API\'s')
    numbers['cli_s'] = cli_s
    del api_det
    torch.cuda.empty_cache()
    return {k: v // batches for k, v in launches.items()}, ckpt, numbers


def run_image_demo(torch, ckpt, tmp):
    """(c) ``tpudet_torch.demo.image_demo`` on one shapes JPEG with
    ``--out-file x.png``: its ``main`` in-process with every count at 0
    just before (108 / 0 launches), then ``python -m`` in a subprocess,
    started here and left to run while the caller goes on (its start-up
    is seconds of host work). Returns (launches, ``finish``): ``finish()``
    waits for the subprocess and checks that the two printed the same
    lines and wrote the same PNG, equal to the array that the in-process
    ``imshow_det_bboxes`` returned; it returns the numbers."""
    import io
    from contextlib import redirect_stdout

    from tpudet_torch import visualization
    from tpudet_torch.demo import image_demo
    from tpudet_torch.ops import mish
    argv = [DEMO_IMAGE, CONFIG, ckpt, '--out-file']
    pngs = [os.path.join(tmp, f'demo_{how}.png')
            for how in ('in_process', 'subprocess')]
    lines = io.StringIO()
    # TF32 as a new process has it (PyTorch's defaults: on for cuDNN's
    # convolutions, off for matmuls); earlier phases turned it off
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with recording(visualization, 'imshow_det_bboxes') as drawn, \
                redirect_stdout(lines):
            torch.cuda.synchronize()
            mish.mish_cuda.launches = 0
            mish.mish_backward_cuda.launches = 0
            t0 = time.perf_counter()
            image_demo.main(argv + [pngs[0]])
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    launches = {'mish_fwd': mish.mish_cuda.launches,
                'mish_bwd': mish.mish_backward_cuda.launches}
    if launches != {'mish_fwd': MISH_PER_FORWARD, 'mish_bwd': 0}:
        raise AssertionError(f'image demo launches {launches}')
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, '-m', 'tpudet_torch.demo.image_demo'] + argv +
        [pngs[1]], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    def finish():
        import numpy as np
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        demo_s = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f'image_demo exited {proc.returncode}: '
                                 f'{err[-3000:]}')
        if out != lines.getvalue():
            raise AssertionError(f'image_demo printed other lines:\n'
                                 f'{out[-2000:]}\nnot, as in-process,\n'
                                 f'{lines.getvalue()[-2000:]}')
        kept = len(out.splitlines()) - 1
        written = [visualization.read_png(p) for p in pngs]
        if len(drawn) != 1 or not kept or not all(
                np.array_equal(w, drawn[0][2]) for w in written):
            raise AssertionError('the demo\'s PNGs differ from the array '
                                 'that imshow_det_bboxes returned')
        numbers = dict(detections_drawn=kept, main_s=main_s,
                       subprocess_s=demo_s,
                       png_bytes=os.path.getsize(pngs[1]))
        log(f'image_demo: main in-process and python -m in a subprocess '
            f'print the same {kept} lines and write the same PNG '
            f'{written[1].shape}, equal to imshow_det_bboxes\' array; ' +
            json.dumps(numbers))
        return numbers
    return launches, finish


def run_garbage_recipe(torch, tmp):
    """(d) ``train_detector`` on the garbage recipe (YOLOv4-l 640, 44
    classes, tpudet's init from the config's seed), its train and val sets
    the committed shapes sets written as ``GarbageDataset`` jsons, bf16,
    micro-batches of GARBAGE_MICRO x ACCUMULATION: GARBAGE_STEPS steps,
    each with the counts at 0 just before (``LoopProbe``)."""
    from tpudet_torch.apis import train_detector
    from tpudet_torch.config import Config
    from tpudet_torch.data import GarbageDataset, build_dataset
    from tpudet_torch.tools import dataset_formats as formats
    cfg = Config.fromfile(CONFIG_GARBAGE)
    data = dict(cfg['data'], samples_per_gpu=GARBAGE_MICRO)
    for split, name in (('train', 'train'), ('val', 'val'), ('test', 'val')):
        with open(os.path.join(SHAPES, f'{name}.json')) as f:
            coco = json.load(f)
        ann = formats.write_custom(coco, os.path.join(tmp, f'garbage_{name}'))
        data[split] = dict(data[split], ann_file=ann, img_prefix=os.path.join(
            SHAPES, name, 'images'))
    cfg['data'] = data
    cfg['nominal_batch_size'] = GARBAGE_MICRO * ACCUMULATION
    cfg['compute_dtype'] = 'bfloat16'
    cfg['log_config'] = dict(interval=1)
    train_set = build_dataset(data['train'], dict(device='cuda'))
    if type(train_set) is not GarbageDataset or len(train_set) != 64:
        raise AssertionError(f'the recipe built {type(train_set).__name__} '
                             f'of {len(train_set)} images')
    del train_set
    with LoopProbe(torch) as probe:
        t0 = time.perf_counter()
        train_detector(cfg, os.path.join(tmp, 'garbage'),
                       max_steps=GARBAGE_STEPS, device='cuda')
        wall = time.perf_counter() - t0
    check_loop_rows(probe.rows, list(range(1, GARBAGE_STEPS + 1)),
                    ACCUMULATION)
    if probe.trainers[0].accumulation != ACCUMULATION:
        raise AssertionError('not 6 micro-batches a step')
    del probe.trainers[:]
    torch.cuda.empty_cache()
    numbers = dict(loop_summary(probe.rows, GARBAGE_MICRO * ACCUMULATION),
                   train_detector_s=wall)
    log('train_detector, garbage recipe: ' + json.dumps(numbers))
    return probe.rows[-1]['launches'], numbers


def run_other_datasets(torch):
    """Phase 14: (a) the datasets, (b) flip TTA, (c) the image demo, (d)
    the garbage recipe. The YOLOv4-l weights are phase 5's draw: phase
    4's from seed 0, BN statistics measured on this set's first
    batch at EVAL_BN_SCALE. Returns the launches of each path."""
    import tempfile

    from tpudet_torch.apis import init_detector, single_device_test
    from tpudet_torch.config import Config
    from tpudet_torch.data import DetDataLoader
    cfg = Config.fromfile(CONFIG)
    launches, numbers = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        coco, sets = shapes_sets(tmp, cfg['data']['test']['pipeline'])
        check_shapes_sets(torch, sets)
        first = DetDataLoader(sets['coco'], batch_size=BATCH,
                              img_size=IMG)._collate(
            [sets['coco'][i] for i in range(BATCH)])['img'].cpu().numpy()
        tree = make_variables(torch, cfg, first, bn_scale=EVAL_BN_SCALE)
        det = init_detector(cfg, variables=tree, device='cuda',
                            dtype=torch.bfloat16)
        kw = dict(batch_size=BATCH, img_size=IMG, progress=False)
        by_coco = single_device_test(det.model, sets['coco'], **kw)
        by_voc = single_device_test(det.model, sets['voc'], **kw)
        if not same_results(by_voc, by_coco):
            raise AssertionError('single_device_test through VOCDataset '
                                 'differs from CocoDataset')
        numbers['voc'] = dict(sets['voc'].evaluate(by_voc, metric='mAP'),
                              **sets['voc'].evaluate(by_voc,
                                                     metric='recall'))
        log(f'single_device_test through VOCDataset equals CocoDataset\'s '
            f'(0 delta, {sum(len(a) for r in by_voc for a in r)} '
            f'detections); XMLDataset.evaluate mAP and recall (random '
            f'weights): {json.dumps(numbers["voc"])}')
        del det
        torch.cuda.empty_cache()
        numbers['datasets_s'] = time.perf_counter() - t0

        t0 = time.perf_counter()
        launches['tta_eval_batch'], ckpt, numbers['tta'] = run_tta(
            torch, cfg, tree, coco, sets['coco'], tmp)
        numbers['tta_s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        launches['image_demo_call'], demo = run_image_demo(torch, ckpt, tmp)
        # the garbage recipe runs while the demo's subprocess starts up
        launches['garbage_train_step'], numbers['garbage'] = \
            run_garbage_recipe(torch, tmp)
        numbers['garbage_s'] = time.perf_counter() - t0
        numbers['image_demo'] = demo()
        numbers['demo_and_garbage_s'] = time.perf_counter() - t0
    log('other datasets, TTA, demo, garbage recipe: ' + json.dumps(numbers))
    return {k: {path: v[k] for path, v in launches.items()}
            for k in ('mish_fwd', 'mish_bwd')}


# ---------------------------------------------------------------------------
# phase 15: the exported program (tpudet_torch/tools/export_program.py and
# deployment_test.py; mish as the registered ops tpudet::mish_fwd /
# mish_bwd; each NMS block walk a while_loop)

DEPLOY_TIMEOUT_S = 600
# the bf16 artifact's export, in a process of its own beside the fp32
# export: argv cfg, weights, out, batch, img size; prints seconds and bytes
EXPORT_BF16 = """
import json, sys, time
import torch
from tpudet_torch.apis import init_detector
from tpudet_torch.tools import export_program as ex
cfg, ckpt, out, batch, img = sys.argv[1:]
det = init_detector(cfg, ckpt, device='cuda', dtype=torch.bfloat16)
t0 = time.perf_counter()
n = ex.export_eval_artifact(det, out, batch=int(batch), img_size=int(img))
print(json.dumps({'export_s': time.perf_counter() - t0, 'bytes': n}))
"""


def kernel_launches_by_name(torch, fn):
    """torch.profiler over one call of ``fn``: {device kernel name:
    launches}, empty without device activity. The call is the active step
    of a profiler schedule, after a warm-up step: late in a whole run on
    the H100, a profile of the one call alone listed 100 of the 108 mish
    launches that the launch count read."""
    from torch.profiler import ProfilerActivity, profile, schedule
    events = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: events.extend(device_events(p))
                 ) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    counts = {}
    for name, _, _ in events:
        counts[name] = counts.get(name, 0) + 1
    return counts


PROFILE_ATTEMPTS = 3


def check_profiled_mish(torch, fn):
    """Raise unless torch.profiler sees one call of ``fn`` launch
    ``mish_fwd_kernel`` once a mish site and no other mish kernel; a
    profile with no device events fails too. A profile can lose kernel
    records (late in a whole run on the H100 one listed 101 of the 108
    launches that the launch count read) but never adds one, so up to
    PROFILE_ATTEMPTS profiles are taken until one lists every site; any
    other mish kernel in any of them fails."""
    seen = []
    for _ in range(PROFILE_ATTEMPTS):
        by_name = kernel_launches_by_name(torch, fn)
        ours = sum(n for k, n in by_name.items() if 'mish_fwd_kernel' in k)
        other = {k: n for k, n in by_name.items()
                 if 'mish' in k.lower() and 'mish_fwd_kernel' not in k}
        seen.append((ours, other, sum(by_name.values())))
        if not by_name or other or ours == MISH_PER_FORWARD:
            break
    log('profiler over one exported call: ' + '; '.join(
        f'{ours} mish_fwd_kernel, other mish kernels {other}, {n} device '
        f'events' for ours, other, n in seen))
    ours, other, n = seen[-1]
    if not n:
        raise AssertionError('the profiler saw no device events')
    if ours != MISH_PER_FORWARD or other:
        raise AssertionError('the profiled exported call did not run mish '
                             'through the kernel alone, once a site')


# where a call's host time goes: cProfile's self time, grouped by file.
# cProfile sees no C call under OpOverload.__call__, so an exported graph's
# ATen dispatch and launches count in graph_python and a live call's
# (torch.conv2d and the like) in c_calls: compare a call with itself from
# one reading to another, not the two calls' groups.
HOST_GROUPS = (
    ('input_checks', ('torch/export/', 'torch/_export/', 'torch/utils/_pytree')),
    ('while_loop', ('torch/_higher_order_ops/',)),
    ('graph_python', ('<eval_with_key', 'torch/fx/', 'torch/_ops.py',
                      'torch/nn/modules/')),
    ('op_dispatch', ('torch/_library/', 'torch/_dynamo/', 'torch/_compile',
                     'tpudet_torch/ops/')),
    ('port_python', ('tpudet_torch/',)),
)


def thread_ticks():
    """{thread id: (name, user + system CPU ticks)} of this process."""
    out = {}
    for tid in os.listdir('/proc/self/task'):
        try:
            with open(f'/proc/self/task/{tid}/stat') as f:
                stat = f.read()
        except OSError:  # the thread ended
            continue
        fields = stat[stat.rindex(')') + 2:].split()
        out[int(tid)] = (stat[stat.index('(') + 1:stat.rindex(')')],
                         int(fields[11]) + int(fields[12]))
    return out


def thread_events():
    """This thread's minor and major page faults and its voluntary and
    involuntary context switches, from /proc."""
    tid = threading.get_native_id()
    with open(f'/proc/self/task/{tid}/stat') as f:
        stat = f.read()
    fields = stat[stat.rindex(')') + 2:].split()
    out = {'minflt': int(fields[7]), 'majflt': int(fields[9])}
    with open(f'/proc/self/task/{tid}/status') as f:
        for line in f:
            key, _, value = line.partition(':')
            if key in ('voluntary_ctxt_switches',
                       'nonvoluntary_ctxt_switches'):
                out[key.split('_')[0]] = int(value)
    return out


def host_split(torch, fn, runs=5, top=8):
    """cProfile over ``runs`` calls of ``fn`` after a warm-up call: ms a
    call of self time in each of ``HOST_GROUPS``, in ``c_calls`` (ATen,
    launches, syncs and other builtins) and in ``other``, with their sum
    (``total``, the profiled wall); the ``top`` functions by self time;
    a call, the caching allocator's cudaMalloc calls and retries and the
    CPU ms of this thread and of the whole process, the garbage
    collector's passes and ms; the device's free and the allocator's
    reserved GB; the process's OS threads, torch's intra-op threads, the
    objects the collector tracks, and the other threads that took CPU
    meanwhile (name, ms a call); and, a call, this thread's page faults
    and context switches."""
    import cProfile
    import gc
    import pstats
    fn()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()
    collections = [0, 0.0, 0.0]  # passes, seconds, start of the current

    def on_gc(phase, _info):
        if phase == 'start':
            collections[2] = time.perf_counter()
        else:
            collections[0] += 1
            collections[1] += time.perf_counter() - collections[2]

    gc.callbacks.append(on_gc)
    ticks, events = thread_ticks(), thread_events()
    cpu = time.thread_time(), time.process_time()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(runs):
        fn()
    torch.cuda.synchronize()
    prof.disable()
    cpu = time.thread_time() - cpu[0], time.process_time() - cpu[1]
    events = {k: (v - events[k]) / runs for k, v in thread_events().items()}
    tick_ms = 1e3 / os.sysconf('SC_CLK_TCK') / runs
    others = sorted(
        ((n - ticks.get(tid, (name, 0))[1]) * tick_ms, name, tid)
        for tid, (name, n) in thread_ticks().items()
        if tid != threading.get_native_id())[::-1]
    gc.callbacks.remove(on_gc)
    after = torch.cuda.memory_stats()
    groups, rows = {}, []
    for (file, line, name), (_, _, tt, _, _) in pstats.Stats(
            prof).stats.items():
        group = 'c_calls' if file == '~' else next(
            (g for g, keys in HOST_GROUPS if any(k in file for k in keys)),
            'other')
        groups[group] = groups.get(group, 0.0) + tt * 1e3 / runs
        rows.append((tt * 1e3 / runs, f'{os.path.basename(file)}:{line}'
                                      f'({name})'))
    out = {g: groups.get(g, 0.0) for g, _ in HOST_GROUPS}
    out.update(c_calls=groups.get('c_calls', 0.0),
               other=groups.get('other', 0.0),
               total=sum(groups.values()),
               top=[[name, ms] for ms, name in sorted(rows)[::-1][:top]])
    for key in ('num_device_alloc', 'num_alloc_retries'):
        out[key] = (after.get(key, 0) - before.get(key, 0)) / runs
    out.update(cpu_thread_ms=cpu[0] * 1e3 / runs,
               cpu_process_ms=cpu[1] * 1e3 / runs,
               gc_passes=collections[0] / runs,
               gc_ms=collections[1] * 1e3 / runs,
               gc_objects=len(gc.get_objects()),
               free_gb=torch.cuda.mem_get_info()[0] / 1e9,
               reserved_gb=torch.cuda.memory_reserved() / 1e9,
               os_threads=len(os.listdir('/proc/self/task')),
               torch_threads=torch.get_num_threads(),
               busy_threads=[[name, ms] for ms, name, _ in others[:5]
                             if ms > 0], **events)
    return out


def export_lane_nms(torch, nms, call):
    """The lane NMS of one recorded ``batched_class_lane_nms`` call as an
    exported program (each block walk a ``while_loop``): ``(program,
    candidates)``, the candidates copied out of inference mode."""
    args, kwargs, _ = call
    cands = tuple(t.clone() for t in args[:2])

    class LaneNMS(torch.nn.Module):
        def forward(self, bbox, scores):
            return tuple(nms.batched_class_lane_nms(
                bbox, scores, *args[2:], **kwargs))

    return torch.export.export(LaneNMS(), cands).module(), cands


def cpu_ops(torch, fn):
    """{aten op: calls} of the ops that one call of ``fn`` dispatches with
    a CPU tensor among their arguments or results (a ``while_loop`` runs
    its body uncounted)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        supports_higher_order_operators = True

        def __init__(self):
            super().__init__()
            self.calls = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(t, torch.Tensor) and t.device.type == 'cpu'
                   for t in tree_leaves((args, kwargs, out))):
                self.calls[str(func)] = self.calls.get(str(func), 0) + 1
            return out

    with Count() as count:
        fn()
    return count.calls


def report_gap(a, b):
    """max |a - b| over two reports' values (0 where both are NaN), or inf
    if their keys differ."""
    if list(a) != list(b):
        return math.inf
    return max([0.0] + [abs(a[k] - b[k]) for k in a
                        if not (math.isnan(a[k]) and math.isnan(b[k]))])


def run_export(torch, tree):
    """Phase 15, YOLOv4-l 640 with phase 4's weights (written to a
    msgpack), batch 8: (a) ``export_eval_artifact`` in fp32 and in bf16
    (the bf16 one in a process of its own, beside the fp32 one), seconds
    and MB; (b) each ``.pt2`` loaded back and called on phase 4's
    batch: fp32 (TF32 off, cuDNN deterministic) bit-equal to the live
    ``Detector``, also through ``single_device_test`` on the shapes val
    set; bf16 paired one-to-one by ``match_per_class``; (c) one exported
    call with every count at 0 just before: 108 / 0 launches, no op on a
    host tensor, and under ``torch.profiler`` 108 ``mish_fwd_kernel`` and
    no aten mish kernel;
    (d) ``python -m tpudet_torch.tools.deployment_test`` in a subprocess
    on the fp32 artifact over the shapes val set (32 images, batch 8),
    started once that artifact is written (it runs beside the bf16 export
    and (b)-(c); its seconds are from its start to its end), its report
    equal to the test CLI's on the same msgpack (0 delta; both with
    PyTorch's TF32 defaults); (e) the exported call's ms and device busy
    against the live call's, in turns, where each call's host time goes
    (``host_split``), and the lane NMS on the candidates recorded from a
    live call, eager (host loop) against its exported program
    (``while_loop``). Returns the launches of an exported call."""
    import tempfile

    from tpudet_torch.apis import init_detector, single_device_test
    from tpudet_torch.apis.inference import nms_result_to_per_class
    from tpudet_torch.config import Config
    from tpudet_torch.core import nms
    from tpudet_torch.data import build_dataset
    from tpudet_torch.models.dense_heads import yolocsp_head
    from tpudet_torch.ops import mish
    from tpudet_torch.tools import deployment_test
    from tpudet_torch.tools import export_program as ex
    from tpudet_torch.tools import test as cli
    from tpudet_torch.utils.checkpoint import save_variables

    cfg = Config.fromfile(CONFIG)
    img = torch.from_numpy(images(BATCH, SEED + 1)).cuda()
    sf = torch.ones(BATCH, 4, device='cuda')
    hw = torch.full((BATCH, 2), float(IMG), device='cuda')
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    numbers = {}

    def stop(proc, log_file):  # on the way out, also after a failure
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log_file.close()

    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.ExitStack() as stack:
        ckpt = os.path.join(tmp, 'weights.msgpack')
        save_variables(ckpt, tree)
        cfg_file = shapes_config(cfg, os.path.join(tmp, 'export_config.py'))

        # (a) export, (b) load back; the bf16 export's process starts
        # first, (d)'s as soon as the fp32 artifact is written; both run
        # beside the rest of (a)-(c)
        dets, paths, programs = {}, {}, {}
        deployed_out = os.path.join(tmp, 'deployed.json')
        paths['bf16'] = os.path.join(tmp, 'yolov4l_bf16.pt2')
        bf16_log = open(os.path.join(tmp, 'export_bf16.log'), 'w+')
        bf16_export = subprocess.Popen(
            [sys.executable, '-c', EXPORT_BF16, cfg_file, ckpt,
             paths['bf16'], str(BATCH), str(IMG)], cwd=ROOT,
            stdout=bf16_log, stderr=subprocess.STDOUT)
        stack.callback(stop, bf16_export, bf16_log)
        for name, dtype in (('fp32', torch.float32),
                            ('bf16', torch.bfloat16)):
            dets[name] = init_detector(cfg_file, ckpt, device='cuda',
                                       dtype=dtype)
            if name == 'bf16':
                bf16_export.wait(timeout=DEPLOY_TIMEOUT_S)
                bf16_log.seek(0)
                out = bf16_log.read()
                if bf16_export.returncode:
                    raise AssertionError(f'the bf16 export exited '
                                         f'{bf16_export.returncode}: '
                                         f'{out[-3000:]}')
                done = json.loads([ln for ln in out.splitlines()
                                   if ln.startswith('{"export_s"')][-1])
                numbers['export_bf16_s'] = done['export_s']
                numbers['pt2_bf16_mb'] = done['bytes'] / 1e6
            else:
                paths[name] = os.path.join(tmp, f'yolov4l_{name}.pt2')
                t0 = time.perf_counter()
                n = ex.export_eval_artifact(dets[name], paths[name],
                                            batch=BATCH, img_size=IMG)
                numbers[f'export_{name}_s'] = time.perf_counter() - t0
                numbers[f'pt2_{name}_mb'] = n / 1e6
                t_deploy = time.perf_counter()
                deploy_log = open(os.path.join(tmp, 'deployed.log'), 'w+')
                deploy = subprocess.Popen(
                    [sys.executable, '-m',
                     'tpudet_torch.tools.deployment_test', cfg_file,
                     paths['fp32'], '--batch-size', str(BATCH),
                     '--img-size', str(IMG), '--out', deployed_out],
                    cwd=ROOT, stdout=deploy_log, stderr=subprocess.STDOUT)
                stack.callback(stop, deploy, deploy_log)
            t0 = time.perf_counter()
            programs[name] = torch.export.load(paths[name]).module()
            numbers[f'load_{name}_s'] = time.perf_counter() - t0
        log('exported eval artifacts: ' + json.dumps(numbers))

        def live(name):
            return dets[name](img, sf)

        def exported(name):
            with torch.inference_mode():
                return nms.NMSResult(*programs[name](img, sf, hw))

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        try:
            ref, got = live('fp32'), exported('fp32')
            same = {k: torch.equal(getattr(ref, k), getattr(got, k))
                    for k in ref._fields}
            n_valid = int(ref.valid.sum())
            log(f'fp32 exported call against the live Detector, TF32 off, '
                f'cuDNN deterministic: equal {json.dumps(same)}, '
                f'{n_valid} detections')
            if not all(same.values()) or not n_valid:
                raise AssertionError('the fp32 exported program differs '
                                     'from the live Detector')
            ds = build_dataset({**Config.fromfile(cfg_file)['data']['test'],
                                'test_mode': True}, dict(device='cuda'))
            kw = dict(batch_size=BATCH, img_size=IMG, progress=False)
            by_live = single_device_test(dets['fp32'].model, ds, **kw)
            by_artifact = single_device_test(
                dets['fp32'].model, ds, infer_fn=deployment_test.
                load_exported_infer_fn(paths['fp32'], BATCH, IMG), **kw)
            n_set = sum(len(a) for r in by_live for a in r)
            log(f'fp32 shapes val set ({len(ds)} images) through '
                f'single_device_test, the artifact against the live model: '
                f'equal {same_results(by_live, by_artifact)}, {n_set} '
                f'detections')
            if not same_results(by_live, by_artifact) or not n_set:
                raise AssertionError('the fp32 artifact\'s eval differs from '
                                     'the live model\'s')
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic) = flags

        ref16, got16 = live('bf16'), exported('bf16')
        numbers['bf16_bit_equal'] = all(
            torch.equal(getattr(ref16, k), getattr(got16, k))
            for k in ref16._fields)
        n_cls = dets['bf16'].model.bbox_head.num_classes
        pairs = [match_per_class(r, g, MATCH_IOU) for r, g in zip(
            nms_result_to_per_class(ref16, n_cls),
            nms_result_to_per_class(got16, n_cls))]
        matched, n_ref, n_got = (sum(p[i] for p in pairs) for i in range(3))
        log(f'bf16 exported call against the live Detector: {matched} of '
            f'{n_ref} / {n_got} detections paired (label, IoU >= '
            f'{MATCH_IOU}); bit-equal {numbers["bf16_bit_equal"]}')
        if not (matched == n_ref == n_got and n_ref):
            raise AssertionError('bf16 exported detections do not pair with '
                                 'the live Detector\'s')

        # (c) the launches of one exported call, counts at 0 just before
        torch.cuda.synchronize()
        mish.mish_cuda.launches = 0
        mish.mish_backward_cuda.launches = 0
        exported('bf16')
        torch.cuda.synchronize()
        launches = {'mish_fwd': mish.mish_cuda.launches,
                    'mish_bwd': mish.mish_backward_cuda.launches}
        host_ops = cpu_ops(torch, lambda: exported('bf16'))
        log(f'exported call launches {json.dumps(launches)}; ops on host '
            f'tensors {json.dumps(host_ops)}')
        if launches != {'mish_fwd': MISH_PER_FORWARD, 'mish_bwd': 0}:
            raise AssertionError('the exported call did not run mish through '
                                 'the kernel, once a site')
        if host_ops:
            raise AssertionError('the exported call runs ops on host tensors')
        check_profiled_mish(torch, lambda: exported('bf16'))

        # (d) the deployment CLI's subprocess against the test CLI
        deploy.wait(timeout=DEPLOY_TIMEOUT_S)
        numbers['deployment_cli_s'] = time.perf_counter() - t_deploy
        if deploy.returncode:
            deploy_log.seek(0)
            raise AssertionError(f'deployment_test exited '
                                 f'{deploy.returncode}: '
                                 f'{deploy_log.read()[-3000:]}')
        with open(deployed_out) as f:
            deployed = json.load(f)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            t0 = time.perf_counter()
            report = cli.main([cfg_file, ckpt, '--batch-size', str(BATCH),
                               '--img-size', str(IMG)])
            numbers['test_cli_s'] = time.perf_counter() - t0
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags[:2]
        gap = report_gap(deployed, report)
        log(f'deployment_test (subprocess, {numbers["deployment_cli_s"]:.1f}'
            f' s) report {json.dumps(deployed)}; the test CLI\'s '
            f'{json.dumps(report)}; max |delta| {gap:.3e}')
        if gap != 0:
            raise AssertionError('the deployed report differs from the test '
                                 'CLI\'s')

        # (e) times: the exported call against the live one, in turns
        calls = {'live': lambda: live('bf16'),
                 'exported': lambda: exported('bf16')}
        walls = {who: [] for who in calls}
        with torch.inference_mode():  # both calls ran in (b) and (c)
            for who in ('live', 'exported', 'exported', 'live'):
                walls[who].append(cuda_ms(calls[who], warmup=1, runs=5))
        numbers.update(live_e2e_ms=walls['live'],
                       exported_e2e_ms=walls['exported'])
        for who, fn in calls.items():
            prof = profile_device(torch, fn, f'{who} call', top=8)
            if prof:
                numbers[f'{who}_busy_ms'] = prof[1]
                numbers[f'{who}_busy_share'] = prof[1] / prof[0]

        # where the host time of each call goes, and the threads that
        # could hold the GIL meanwhile
        for who, fn in calls.items():
            numbers[f'{who}_host'] = host_split(torch, fn)
        numbers['threads'] = [t.name for t in threading.enumerate()]

        # the lane NMS, eager and exported, on a live call's candidates
        with recording(yolocsp_head, 'batched_class_lane_nms') as lanes:
            live('bf16')
        args, kwargs, want = lanes[0]
        t0 = time.perf_counter()
        lane_program, cands = export_lane_nms(torch, nms, lanes[0])
        numbers['nms_export_s'] = time.perf_counter() - t0
        nms_calls = {
            'eager': lambda: nms.batched_class_lane_nms(*args, **kwargs),
            'while_loop': lambda: lane_program(*cands)}
        nms_times = {who: [] for who in nms_calls}
        with torch.inference_mode():
            if not all(torch.equal(a, b) for a, b in
                       zip(nms_calls['while_loop'](), want)):
                raise AssertionError('the exported lane NMS differs from '
                                     'the eager one')
            for who in ('eager', 'while_loop', 'while_loop', 'eager'):
                nms_times[who].append(cuda_ms(nms_calls[who], runs=5))
        numbers.update(nms_eager_ms=nms_times['eager'],
                       nms_while_loop_ms=nms_times['while_loop'],
                       nms_scores_shape=list(args[1].shape))
        log('exported program, YOLOv4-l bf16 batch 8: ' + json.dumps(numbers))
        del dets, programs, lane_program, lanes
        torch.cuda.empty_cache()
    return {k: {'exported_eval_call': v} for k, v in launches.items()}


# ---------------------------------------------------------------------------
# 16. the zoo's rows a-c: Cascade R-CNN, GN and GN+WS, YOLOv3

CONFIG_CASCADE = os.path.join(
    ROOT, 'configs/cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py')
CONFIG_GN_WS = os.path.join(
    ROOT, 'configs/gn+ws/faster_rcnn_r50_fpn_gn_ws-all_1x_coco.py')
CONFIG_GN_MASK = os.path.join(
    ROOT, 'configs/gn/mask_rcnn_r50_fpn_gn-all_2x_coco.py')
CONFIG_V3 = os.path.join(ROOT,
                         'configs/yolo/yolov3_d53_mstrain-608_273e_coco.py')
ZOO_FP32_IMG = 640  # Cascade R-CNN, card against CPU
ZOO_TRAIN_STEPS = 2
ZOO_TIMED_RUNS = 3  # a zoo model's e2e and forward: the median of 3
# the prediction layers' redraw measures their inputs on the first 2 images
# of the batch (phase 20's ZOO_I_REDRAW_IMAGES), BatchNorm statistics on all
ZOO_REDRAW_IMAGES = 2
V3_IMG, V3_BATCH = 608, 8
V3_PRED_SPREAD = 2.0  # YOLOv3's pred convs: every attribute's logits
# phase 17's redraws: each DCN conv_offset's offsets (px) and mask logits;
# the attention's queries and keys and its gamma (a tenth of the block's
# output: identity BatchNorm does not hold 9 blocks' sums down); SSD's
# class logits (81 columns: a softmax over narrower logits leaves every
# class under score_thr 0.02) and deltas
DCN_OFFSET_SPREAD = 2.0
GA_QK_SPREAD, GA_GAMMA = 1.0, 0.1
# the attention blocks on tpudet's init, card against CPU in fp32: the
# energies within GA_ENERGY_RTOL of their largest |value| (fp32 rounding);
# at the queries whose softmax puts over GA_SETTLED on one key in every
# head, the attention's output (before gamma) within GA_OUT_RTOL of its
# largest |value|. A key's weight moves by up to its weight x twice the
# largest energy delta, so elsewhere the output is only logged
GA_ENERGY_RTOL, GA_SETTLED, GA_OUT_RTOL = 1e-5, 0.999, 1e-3
SSD_CLS_SPREAD, SSD_REG_SPREAD = 3.0, 0.3


def zoo_variables(torch, cfg, img, seed, measure_bn=False, extra=None,
                  run=None):
    """``redrawn_variables`` of every prediction layer of ``cfg``'s model:
    the RPN's and each RoI head's (``rpn_cls``, ``rpn_reg``, ``fc_cls``,
    ``fc_reg``, as ``two_stage_variables``), YOLOv3's ``conv_pred{i}``
    (logits spread by V3_PRED_SPREAD around 0), RetinaNet's
    (``retina_variables``' spreads) or SSD's ``cls_conv{i}`` /
    ``reg_conv{i}``; and every DCN's ``conv_offset`` (offsets and mask
    logits spread by DCN_OFFSET_SPREAD around 0: fractional offsets of a
    few pixels, some reaching outside the map, masks away from 0.5; tpudet
    inits it at 0), the attention's ``query_conv`` and ``key_conv`` (their
    outputs spread by GA_QK_SPREAD: on tpudet's init the stages' growing
    activations put the energies in the thousands, the softmax one-hot,
    and which key wins flips under fp32 rounding, card against CPU), its
    ``gamma`` (GA_GAMMA) and its ``key_content_bias`` and ``geom_bias``
    (N(0, 1 / qk_dim); all three start at 0 in tpudet); the ATSS
    family's class convs as RetinaNet's, ATSS's deltas and centerness,
    GFL's bin logits and VFNet's log-distances (phase 18's spreads; a KD
    teacher's layers, which the forward does not run, keep tpudet's init),
    and BFP's non-local ``theta`` and ``phi`` (outputs spread by
    BFP_QK_SPREAD, as the attention's queries and keys) and ``conv_out``
    (BFP_OUT_SPREAD; zero at tpudet's init, which leaves the block the
    identity and its softmax untested), drawn from ``RandomState(seed)``.
    ``extra`` (a regex of the module's dotted name -> (spread, bias))
    redraws more layers, mask heads' too, ``run(model, img)`` the forward
    that measures their inputs (``redrawn_variables``); a SAC's raw
    ``weight_diff`` (zero at tpudet's init) is drawn at SAC_DIFF_SCALE of
    its kernel's he-normal std."""
    import numpy as np
    from tpudet_torch.models.builder import build_detector
    spreads = {'rpn_cls': (FRCNN_RPN_CLS_SPREAD, 0.0),
               'rpn_reg': (FRCNN_RPN_REG_SPREAD, 0.0),
               'fc_cls': (FRCNN_CLS_SPREAD, 0.0),
               'fc_reg': (FRCNN_REG_SPREAD, 0.0),
               'retina_cls': (RETINA_CLS_SPREAD, RETINA_CLS_BIAS),
               'retina_reg': (RETINA_REG_SPREAD, 0.0),
               'conv_offset': (DCN_OFFSET_SPREAD, 0.0),
               'query_conv': (GA_QK_SPREAD, 0.0),
               'key_conv': (GA_QK_SPREAD, 0.0),
               'atss_cls': (RETINA_CLS_SPREAD, RETINA_CLS_BIAS),
               'atss_reg': (RETINA_REG_SPREAD, 0.0),
               'atss_centerness': (ATSS_CTR_SPREAD, 0.0),
               'gfl_cls': (RETINA_CLS_SPREAD, RETINA_CLS_BIAS),
               'gfl_reg': (GFL_BIN_SPREAD, 0.0),
               'vfnet_cls': (RETINA_CLS_SPREAD, RETINA_CLS_BIAS),
               'vfnet_reg': (VFNET_REG_SPREAD, 0.0),
               'vfnet_reg_refine': (VFNET_REG_SPREAD, 0.0),
               'theta': (BFP_QK_SPREAD, 0.0),
               'phi': (BFP_QK_SPREAD, 0.0),
               'conv_out': (BFP_OUT_SPREAD, 0.0)}
    with torch.device('meta'):
        model = build_detector(cfg['model'])
    ssd = type(getattr(model, 'bbox_head', None)).__name__ == 'SSDHead'
    layers = {}
    for name, _ in model.named_modules():
        leaf = name.split('.')[-1]
        hit = [v for k, v in (extra or {}).items() if re.search(k, name)]
        if hit:
            layers[tuple(name.split('.'))] = hit[0]
        elif leaf in spreads and 'mask_head' not in name:
            layers[tuple(name.split('.'))] = spreads[leaf]
        elif leaf.startswith('conv_pred'):
            layers[tuple(name.split('.'))] = (V3_PRED_SPREAD, 0.0)
        elif ssd and leaf.startswith(('cls_conv', 'reg_conv')):
            layers[tuple(name.split('.'))] = (
                SSD_CLS_SPREAD if leaf.startswith('cls') else SSD_REG_SPREAD,
                0.0)
    tree = redrawn_variables(torch, cfg, img, layers, seed, measure_bn,
                             run=run)
    rng = np.random.RandomState(seed + 1)

    def redraw(node):
        for k, v in node.items():
            if isinstance(v, dict):
                redraw(v)
            elif k == 'weight_diff':
                std = math.sqrt(2 / np.prod(v.shape[:-1]))
                node[k] = (rng.randn(*v.shape) * SAC_DIFF_SCALE * std
                           ).astype(np.float32)
            elif k == 'gamma':
                node[k] = np.full_like(v, GA_GAMMA)
            elif k in ('key_content_bias', 'geom_bias'):
                node[k] = (rng.randn(*v.shape) / math.sqrt(v.shape[-1])
                           ).astype(np.float32)
    redraw(tree['params'])
    return tree


def zoo_inference(torch, mish, config, name, seed, size=None, batch=None,
                  measure_bn=False, extra=None, leaves=None):
    """``config``'s model at full width and depth through ``init_detector``
    / ``Detector``, bf16, ``batch`` images on ``size`` squares, every count
    at 0 just before the one call (0 launches: the path has no mish);
    finite detections in every image; e2e and forward ms, device busy and
    kernels a call, peak memory; ``size`` and ``batch`` FRCNN_IMG and
    FRCNN_BATCH unless given. The weights are ``zoo_variables`` (with
    ``extra`` redraws, measured on ZOO_REDRAW_IMAGES of the batch unless
    ``measure_bn``), then ``leaves(tree)`` where given. Returns (weights
    tree, the Detector, the image batch, launches, times)."""
    from tpudet_torch.apis import init_detector
    from tpudet_torch.config import Config
    size, batch = size or FRCNN_IMG, batch or FRCNN_BATCH
    cfg = Config.fromfile(config)
    img_np = retina_images(cfg, batch, size, seed)
    deferred_checks_start()  # the last model's CPU check beside the draw
    t0 = time.perf_counter()
    tree = zoo_variables(
        torch, cfg, img_np if measure_bn else img_np[:ZOO_REDRAW_IMAGES],
        seed, measure_bn, extra=extra)
    if leaves is not None:
        leaves(tree)
    det = init_detector(cfg, variables=tree, device='cuda',
                        dtype=torch.bfloat16)
    model = det.model
    n_params = sum(p.numel() for p in model.parameters())
    log(f'{name}: {n_params / 1e6:.2f} M parameters, bf16, weights from '
        f'seed {SEED} on the card (prediction layers redrawn, numpy seed '
        f'{seed}) in '
        f'{time.perf_counter() - t0:.1f} s')
    img = torch.from_numpy(img_np).cuda()
    deferred_checks_join()  # before anything timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(mish)
    res = det(img)
    torch.cuda.synchronize()
    launches = _mish_counts(mish)
    n_valid = [int(v) for v in res.valid.sum(1)]
    log(f'{name} bf16 batch {batch} x {size}^2: launches '
        f'{json.dumps(launches)}, detections per image {n_valid}')
    if any(launches.values()):
        raise AssertionError(f'the {name} path launched a mish kernel')
    if not (torch.isfinite(res.bboxes).all() and
            torch.isfinite(res.scores).all() and min(n_valid) > 0):
        raise AssertionError(f'{name}: non-finite detections or an image '
                             f'without')
    # the counted call above warmed both paths (the forward is the call's
    # first part)
    with torch.inference_mode():
        times = {'e2e_ms': cuda_ms(lambda: det(img), warmup=0,
                                   runs=ZOO_TIMED_RUNS),
                 'forward_ms': cuda_ms(lambda: model(img), warmup=0,
                                       runs=ZOO_TIMED_RUNS)}
    times['img_per_s'] = batch / times['e2e_ms'] * 1e3
    times['peak_mem_gib'] = torch.cuda.max_memory_allocated() / 2**30
    with torch.inference_mode():
        prof = profile_device(torch, lambda: det(img), f'{name} e2e call',
                              calls=2, top=8)
    times['busy_ms'] = prof[1] if prof else None
    times['kernels'] = prof[2] if prof else None
    log(f'{name} bf16 batch {batch} x {size}^2: ' + json.dumps(times))
    return tree, det, img, launches, times


DEFERRED_CHECKS = []  # fp32 checks' CPU halves, queued for untimed work
RUNNING_CHECKS = []   # the thread running them


def deferred_checks_start():
    """Run the queued CPU halves of the fp32 checks in a thread: until
    ``deferred_checks_join`` the caller runs only untimed work (the next
    model's weight draw and build)."""
    if DEFERRED_CHECKS and not RUNNING_CHECKS:
        jobs = DEFERRED_CHECKS[:]
        DEFERRED_CHECKS.clear()
        RUNNING_CHECKS.append(beside(lambda: [job() for job in jobs]))


def deferred_checks_join():
    """Wait for the running CPU halves (raising a failed check's error)."""
    while RUNNING_CHECKS:
        RUNNING_CHECKS.pop()()


def deferred_checks_finish():
    """Run every queued CPU half to its end: a phase's checks all end in
    the phase."""
    deferred_checks_start()
    deferred_checks_join()


def beside(fn):
    """Start ``fn()`` in a thread; the returned callable waits for it and
    gives its result (or raises its exception)."""
    out = {}

    def run():
        try:
            out['value'] = fn()
        except BaseException as e:  # re-raised in the caller's thread
            out['error'] = e
    thread = threading.Thread(target=run, name='CPU reference')
    thread.start()

    def result():
        thread.join()
        if 'error' in out:
            raise out['error']
        return out['value']
    return result


def zoo_fp32_check(torch, cfg, tree, name, size, seed, min_pairs=1,
                   extra=None):
    """fp32 on the card (TF32 off) against the port's CPU call on
    FRCNN_FP32_IMAGES seeded images of ``size``^2: per image the
    detections pair one-to-one (label, IoU >= MATCH_IOU), all but
    FRCNN_KEEP_SHARE of the CPU's, and at least ``min_pairs`` pair. The
    card's call runs now; the CPU's and the comparison are queued
    (``deferred_checks_start``). ``extra``, a pair ``(fn(model, img,
    detections), check(card out, CPU out))``, runs ``fn`` on both sides'
    models with the card's detections and checks the two outputs. Returns
    the pairs per image, a list filled then."""
    from tpudet_torch.apis import init_detector
    few = torch.from_numpy(retina_images(cfg, FRCNN_FP32_IMAGES, size, seed))
    pairs = []

    def cpu_call():
        t0 = time.perf_counter()
        det = init_detector(cfg, variables=tree, device='cpu',
                            dtype=torch.float32)
        ref = det(few)
        if extra is not None:
            with torch.inference_mode():
                extra[1](extra_card, extra[0](det.model, few, got))
        return ref, time.perf_counter() - t0

    def compare(ref, cpu_s, got):
        for i in range(FRCNN_FP32_IMAGES):
            m, n_ref, n_got, gap = match_detections(ref, got, i, MATCH_IOU)
            log(f'{name} fp32 card vs CPU ({cpu_s:.1f} s on the CPU), image '
                f'{i} at {size}^2: detections {m} matched of {n_ref} / '
                f'{n_got} (label and IoU >= {MATCH_IOU}; at least '
                f'{min_pairs}), largest box delta {gap:.3e} px')
            if not (n_ref and n_ref - m <= FRCNN_KEEP_SHARE * n_ref and
                    m >= min_pairs):
                raise AssertionError(f'{name} fp32 detections on the card '
                                     f'differ from the CPU, or too few pair')
            pairs.append(m)

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        det = init_detector(cfg, variables=tree, device='cuda',
                            dtype=torch.float32)
        got = det(few.cuda())
        extra_card = None
        if extra is not None:
            with torch.inference_mode():
                extra_card = extra[0](det.model, few.cuda(), got).cpu()
        del det
        got = type(got)(*(t.cpu() for t in got))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.\
            allow_tf32 = flags
    DEFERRED_CHECKS.append(lambda: compare(*cpu_call(), got))
    torch.cuda.empty_cache()
    return pairs


def zoo_train_steps(torch, mish, config, tree, name, batch_fn,
                    steps=ZOO_TRAIN_STEPS, grad_clip=None, want=None):
    """``steps`` bf16 steps (fp32 master weights) of ``config``'s model
    through ``init_trainer(...).step`` on ``batch_fn(step)``, each with
    its launch counts (0), ms and peak memory; the losses finite and the
    params moved; the gradient clip the trainer took from the config is
    logged, and must be ``grad_clip`` where given; ``want`` names a metric
    that every step must report, finite and above 0. A KD detector's
    teacher forward is timed on the device within each step (its share of
    the step's wall logged), and it must stay fp32, in eval mode, with its
    BatchNorm statistics unchanged. Returns the launches of a step.
    """
    from tpudet_torch.apis import init_trainer
    from tpudet_torch.config import Config
    cfg = Config.fromfile(config)
    cfg['compute_dtype'] = 'bfloat16'
    trainer = init_trainer(cfg, variables=tree, device='cuda',
                           max_steps=steps + 1)
    clip = trainer.opt_cfg.grad_clip_norm
    if grad_clip is not None and clip != grad_clip:
        raise AssertionError(f'{name}: gradient clip {clip}, the config '
                             f'says {grad_clip}')
    p0 = {k: v.detach().clone() for k, v in trainer.state.params.items()}
    teacher = getattr(trainer.model, 'teacher_backbone', None)
    if teacher is not None:
        events = []
        forward = trainer.model.teacher_forward
        stats0 = {k: v.clone() for k, v in trainer.state.batch_stats.items()
                  if k.startswith('teacher_')}

        def timed(img):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = forward(img)
            ev[1].record()
            events.append(ev)
            return out
        trainer.model.teacher_forward = timed
    launches = None
    for step in range(steps):
        batch = batch_fn(step)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(mish)
        t0 = time.perf_counter()
        metrics = trainer.step(batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = _mish_counts(mish)
        m = {k: float(v) for k, v in metrics.items()}
        extra = {}
        if teacher is not None:
            t_ms = sum(a.elapsed_time(b) for a, b in events)
            # fp32 convs: TF32 or not (phase 4 turns it off for the rest
            # of the script) moves the teacher's ms several times
            extra = dict(teacher_ms=t_ms, teacher_share=t_ms / (step_s * 1e3),
                         teacher_tf32=torch.backends.cudnn.allow_tf32)
            events.clear()
        log(f'{name} train step: ' + json.dumps(dict(
            step=step, **m, step_ms=step_s * 1e3, grad_clip_norm=clip,
            img_per_s=len(batch['img']) / step_s,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            launches=launches, **extra)))
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if want is not None and not m.get(want, 0.0) > 0:
            bad.append(want)
        if bad or any(launches.values()) or not any(
                'loss' in k and k != 'loss' for k in m):
            raise AssertionError(f'{name} step {step}: non-finite {bad}, '
                                 f'launches {launches} or no loss')
    moved = max(float((trainer.state.params[k].detach() - v).abs().max())
                for k, v in p0.items())
    if not moved > 0:
        raise AssertionError(f'{name}: params did not move')
    if teacher is not None:
        same = all(torch.equal(trainer.state.batch_stats[k], v)
                   for k, v in stats0.items())
        fp32 = all(p.dtype == torch.float32 for k, p in
                   trainer.state.params.items() if k.startswith('teacher_'))
        log(f'{name} teacher after {steps} steps: BatchNorm statistics '
            f'unchanged {same} ({len(stats0)} tensors), fp32 {fp32}, eval '
            f'mode {not teacher.training}')
        if not (same and fp32 and stats0 and not teacher.training):
            raise AssertionError(f'{name}: the teacher was not kept frozen '
                                 f'in fp32')
    del trainer, p0
    torch.cuda.empty_cache()
    return launches


def zoo_loop_and_cli(torch, config, name, seed, cli=True):
    """``train_detector`` on ``config`` for ZOO_TRAIN_STEPS bf16 steps of
    the config's batch, FRCNN_LOOP_IMAGES seeded training images and
    FRCNN_LOOP_VAL_IMAGES for its evaluation, served from arrays through the
    config's own pipelines; then the test CLI on its ``latest_ema.msgpack``
    against the API (``run_cli_eval``; none without ``cli``, and its
    launches are then None). The weights are ``zoo_variables``
    of the val set's first batch, BatchNorm statistics measured, as phase
    11's loop takes them (from identity statistics two steps leave the
    scores under score_thr). Returns (launches of a step, of a CLI
    batch)."""
    import tempfile

    from tpudet_torch.apis import train_detector
    from tpudet_torch.config import Config
    from tpudet_torch.data import DetDataLoader
    register_array_data()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config.fromfile(config)
        sets = {}
        for part, seed, n in (('train', SEED + 2100, FRCNN_LOOP_IMAGES),
                              ('val', SEED + 2200, FRCNN_LOOP_VAL_IMAGES)):
            arrays, coco = eval_set(seed, n)
            path = os.path.join(tmp, f'{part}.json')
            with open(path, 'w') as f:
                json.dump(coco, f)
            ARRAYS[path] = arrays
            sets[part] = (path, arrays, coco)
        data = cfg['data']
        cfg['data'] = dict(
            data,
            train=dict(type='ArrayCocoDataset', ann_file=sets['train'][0],
                       pipeline=_from_arrays(data['train']['pipeline'])),
            val=dict(type='ArrayCocoDataset', ann_file=sets['val'][0],
                     pipeline=_from_arrays(data['val']['pipeline']),
                     test_mode=True))
        cfg['compute_dtype'] = 'bfloat16'
        cfg['log_config'] = dict(interval=1)
        img_size = cfg['data']['train_img_size']
        val = array_dataset(cfg, sets['val'][1], sets['val'][2], 'cuda', tmp)
        first = DetDataLoader(val, batch_size=2, img_size=img_size)._collate(
            [val[i] for i in range(2)])['img'].cpu().numpy()
        tree = zoo_variables(torch, cfg, first, seed, measure_bn=True)
        work = os.path.join(tmp, 'work')
        with LoopProbe(torch) as probe:
            t0 = time.perf_counter()
            train_detector(cfg, work, max_steps=ZOO_TRAIN_STEPS,
                           device='cuda', variables=tree)
            loop_s = time.perf_counter() - t0
        rows = probe.rows
        del probe.trainers[:]
        torch.cuda.empty_cache()
        with open(os.path.join(work, 'train.log')) as f:
            evals = [line for line in f.read().splitlines()
                     if ' - eval: ' in line]
        weights = os.path.join(work, 'latest_ema.msgpack')
        log(f'{name} train_detector: {ZOO_TRAIN_STEPS} steps in '
            f'{loop_s:.1f} s, ' + json.dumps(loop_summary(
                rows, cfg['data']['samples_per_gpu'])) + f'; last eval: '
            f'{evals[-1].split(" - ")[-1] if evals else None}')
        if [r['step'] for r in rows] != list(range(1, ZOO_TRAIN_STEPS + 1)) \
                or not evals or not os.path.isfile(weights) or any(
                    not math.isfinite(r['loss']) or any(r['launches'].values())
                    for r in rows):
            raise AssertionError(f'{name}: the steps, the evaluation or the '
                                 f'EMA export is wrong')
        cli = run_cli_eval(torch, config, weights, img_size=img_size,
                           mish_per_forward=0) if cli else None
        for path, _, _ in sets.values():
            ARRAYS.pop(path)
    return rows[-1]['launches'], cli


def run_cascade(torch, mish):
    """Cascade R-CNN R50-FPN (``configs/cascade_rcnn/cascade_rcnn_r50_fpn_
    1x_coco.py``): inference at batch 8 on 1344^2 in bf16; fp32 on the
    card (TF32 off) against the port's CPU call on FRCNN_FP32_IMAGES images
    of ZOO_FP32_IMG^2, detections one-to-one; bf16 train steps of 2
    images; ``train_detector`` and the test CLI. Returns launches by
    path."""
    from tpudet_torch.config import Config
    tree, det, _, infer, times = zoo_inference(
        torch, mish, CONFIG_CASCADE, 'Cascade R-CNN R50-FPN', SEED + 2000)
    del det
    torch.cuda.empty_cache()
    cfg = Config.fromfile(CONFIG_CASCADE)
    zoo_fp32_check(torch, cfg, tree, 'Cascade R-CNN', ZOO_FP32_IMG,
                   SEED + 2010)
    train = zoo_train_steps(
        torch, mish, CONFIG_CASCADE, tree, 'Cascade R-CNN',
        lambda step: retina_train_batch(cfg, FRCNN_TRAIN_BATCH, FRCNN_IMG,
                                        SEED + 2020 + step))
    loop, cli = zoo_loop_and_cli(torch, CONFIG_CASCADE, 'Cascade R-CNN',
                                 SEED + 2030)
    return times, {'cascade_rcnn_inference_forward': infer,
                   'cascade_rcnn_train_step': train,
                   'cascade_rcnn_train_detector_step': loop,
                   'cascade_rcnn_test_cli_batch': cli}


def run_gn_ws(torch, mish):
    """The GN+WS Faster R-CNN and the GN Mask R-CNN, R50-FPN: one bf16
    call at batch 8 on 1344^2 and bf16 train steps of 2 images each.
    Returns (times by model, launches by path)."""
    from tpudet_torch.config import Config
    times, launches = {}, {}
    for key, config, name, seed in (
            ('gn_ws_faster_rcnn', CONFIG_GN_WS, 'GN+WS Faster R-CNN',
             SEED + 2300),
            ('gn_mask_rcnn', CONFIG_GN_MASK, 'GN Mask R-CNN', SEED + 2400)):
        tree, det, _, infer, times[key] = zoo_inference(
            torch, mish, config, name, seed)
        del det
        torch.cuda.empty_cache()
        cfg = Config.fromfile(config)
        if 'mask' in key:
            def batch_fn(step, cfg=cfg, seed=seed):
                return mask_train_batch(torch, cfg, FRCNN_TRAIN_BATCH,
                                        FRCNN_IMG, seed + 10 + step, 'cuda')
        else:
            def batch_fn(step, cfg=cfg, seed=seed):
                return retina_train_batch(cfg, FRCNN_TRAIN_BATCH, FRCNN_IMG,
                                          seed + 10 + step)
        launches[f'{key}_inference_forward'] = infer
        launches[f'{key}_train_step'] = zoo_train_steps(
            torch, mish, config, tree, name, batch_fn)
    return times, launches


def run_yolov3(torch, mish):
    """YOLOv3 Darknet-53 at 608 (``configs/yolo/yolov3_d53_mstrain-608_273e_
    coco.py``), BatchNorm statistics measured on the batch: inference at
    batch 8 in bf16 with e2e, forward, decode and NMS ms (the NMS on the
    candidates one call gave it); bf16 train steps of the config's 8
    images; the test CLI on the weights; the fp32 eval artifact
    (``export_eval_artifact``) bit-equal to the live call, TF32 off and
    cuDNN deterministic. Returns (times, launches by path)."""
    import tempfile

    from tpudet_torch.apis import init_detector
    from tpudet_torch.config import Config
    from tpudet_torch.core import nms
    from tpudet_torch.models.dense_heads import yolov3_head
    from tpudet_torch.tools import export_program as ex
    from tpudet_torch.utils.checkpoint import save_variables
    tree, det, img, infer, times = zoo_inference(
        torch, mish, CONFIG_V3, 'YOLOv3 Darknet-53', SEED + 2500,
        size=V3_IMG, batch=V3_BATCH, measure_bn=True)
    model = det.model
    recorded = []
    orig = yolov3_head.batched_nms

    def record(*args, **kwargs):
        recorded.append((args, kwargs))
        return orig(*args, **kwargs)
    yolov3_head.batched_nms = record
    try:
        with torch.inference_mode():
            maps = model(img)
            det(img)
    finally:
        yolov3_head.batched_nms = orig
    args, kwargs = recorded[0]
    with torch.inference_mode():
        times['decode_ms'] = cuda_ms(lambda: model.bbox_head.get_bboxes(
            maps, with_nms=False), warmup=2, runs=5)
        times['nms_ms'] = cuda_ms(lambda: orig(*args, **kwargs), warmup=2,
                                  runs=5)
    times['nms_candidates'] = int((args[1] > args[2]).sum())
    log(f'YOLOv3 bf16 batch {V3_BATCH} x {V3_IMG}^2: ' + json.dumps(times))
    del det, model, maps, recorded, args, kwargs
    torch.cuda.empty_cache()

    cfg = Config.fromfile(CONFIG_V3)
    if cfg['data']['samples_per_gpu'] != V3_BATCH:
        raise AssertionError('not the config\'s batch of 8')
    train = zoo_train_steps(
        torch, mish, CONFIG_V3, tree, 'YOLOv3',
        lambda step: retina_train_batch(cfg, V3_BATCH, V3_IMG,
                                        SEED + 2510 + step))
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, 'yolov3.msgpack')
        save_variables(ckpt, tree)
        cli = run_cli_eval(torch, CONFIG_V3, ckpt, img_size=V3_IMG,
                           mish_per_forward=0)
        det32 = init_detector(cfg, ckpt, device='cuda', dtype=torch.float32)
        path = os.path.join(tmp, 'yolov3_fp32.pt2')
        t0 = time.perf_counter()
        mb = ex.export_eval_artifact(det32, path, batch=V3_BATCH,
                                     img_size=V3_IMG) / 1e6
        export_s = time.perf_counter() - t0
        program = torch.export.load(path).module()
        sf = torch.ones(V3_BATCH, 4, device='cuda')
        hw = torch.full((V3_BATCH, 2), float(V3_IMG), device='cuda')
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        try:
            ref = det32(img, sf)
            with torch.inference_mode():
                got = nms.NMSResult(*program(img, sf, hw))
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic) = flags
        same = {k: torch.equal(getattr(ref, k), getattr(got, k))
                for k in ref._fields}
        log(f'YOLOv3 fp32 eval artifact: exported in {export_s:.1f} s, '
            f'{mb:.2f} MB; its call against the live Detector, TF32 off, '
            f'cuDNN deterministic: equal {json.dumps(same)}, '
            f'{int(ref.valid.sum())} detections')
        if not all(same.values()) or not int(ref.valid.sum()):
            raise AssertionError('the YOLOv3 fp32 exported program differs '
                                 'from the live Detector')
        del det32, program
    torch.cuda.empty_cache()
    return times, {'yolov3_inference_forward': infer,
                   'yolov3_train_step': train,
                   'yolov3_test_cli_batch': cli}


def run_zoo(torch):
    """Phase 16: Cascade R-CNN, the GN+WS and GN R-CNNs and YOLOv3 at full
    width and depth. Returns each path's launches of each kernel (all 0:
    ReLU and LeakyReLU)."""
    from tpudet_torch.ops import mish
    launches, times = {}, {}
    for name, fn in (('cascade', run_cascade), ('gn_ws', run_gn_ws),
                     ('yolov3', run_yolov3)):
        t0 = time.perf_counter()
        times[name], paths = fn(torch, mish)
        launches.update(paths)
        log(f'phase 16 {name}: {time.perf_counter() - t0:.1f} s')
    deferred_checks_finish()  # the phase's last fp32 checks
    log('phase 16 inference times: ' + json.dumps(times))
    return {k: {path: counts[k] for path, counts in launches.items()}
            for k in ('mish_fwd', 'mish_bwd')}


# ---------------------------------------------------------------------------
# 17. the zoo's rows d, e and g: DCN, GCB, attention, SSD, RegNet

CONFIG_DCN = os.path.join(
    ROOT, 'configs/dcn/faster_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py')
CONFIG_GCB = os.path.join(
    ROOT, 'configs/gcnet/mask_rcnn_r50_fpn_r16_gcb_c3-c5_1x_coco.py')
CONFIG_ATTENTION = os.path.join(
    ROOT, 'configs/empirical_attention/'
          'faster_rcnn_r50_fpn_attention_1111_1x_coco.py')
CONFIG_SSD300 = os.path.join(ROOT, 'configs/ssd/ssd300_coco.py')
CONFIG_SSD512 = os.path.join(ROOT, 'configs/ssd/ssd512_coco.py')
CONFIG_REGNET = os.path.join(
    ROOT, 'configs/regnet/retinanet_regnetx-3.2GF_fpn_1x_coco.py')
DCN_SITES = 13  # c3-c5 of ResNet-50: 4 + 6 + 3 blocks
# the sites timed alone: layer2's stride-2 first block, a stride-1 block
# of each stage
DCN_TIMED = ('layer2_0', 'layer2_1', 'layer3_1', 'layer4_1')


def time_deform_sites(torch, det, img, busy_ms):
    """The DCN Faster R-CNN's deformable convs at the inputs one bf16 call
    gives them (recorded by forward pre-hooks): each site's device ms
    alone (``ModulatedDeformConv2d``: the offset conv, the fp32 sampling
    and the contraction) against a bf16 3x3 conv of the same shapes, and
    for DCN_TIMED the sampling alone (``deform_sample`` on the offsets and
    masks the site predicts) with the offsets' mean and largest |value|
    and the masks' mean and std; the sum over the sites against the
    call's device busy ms. Returns the numbers logged."""
    from tpudet_torch.ops import deform_conv as dc
    import torch.nn.functional as F
    sites = {}

    def record(name):
        def hook(mod, args):
            sites.setdefault(name, (mod, args[0].detach().clone()))
        return hook
    hooks = [m.register_forward_pre_hook(record(name))
             for name, m in det.model.backbone.named_modules()
             if isinstance(m, dc.ModulatedDeformConv2d)]
    try:
        with torch.inference_mode():
            det(img)
    finally:
        for h in hooks:
            h.remove()
    if len(sites) != DCN_SITES:
        raise AssertionError(f'{len(sites)} DCN sites in a forward, not '
                             f'{DCN_SITES}')
    rows, total = {}, 0.0
    with torch.inference_mode():
        for name, (mod, x) in sites.items():
            block = name.split('.')[0]
            ms = cuda_ms(lambda: mod(x), warmup=2, runs=5)
            total += ms
            w = mod.weight.to(x.dtype)
            conv_ms = cuda_ms(lambda: F.conv2d(x, w, None, mod.stride, 1),
                              warmup=2, runs=5)
            row = dict(shape=list(x.shape), stride=mod.stride, ms=ms,
                       conv3x3_ms=conv_ms)
            if block in DCN_TIMED:
                k = mod.kernel_size
                pads = [dc.same_padding(n, k, mod.stride)
                        for n in x.shape[-2:]]
                om = mod.conv_offset(F.pad(x, (*pads[1], *pads[0])))
                om = om.permute(0, 2, 3, 1)
                off = om[..., :2 * k * k].float()
                mask = torch.sigmoid(om[..., 2 * k * k:]).float()
                xs = x.float().permute(0, 2, 3, 1)
                row['sample_ms'] = cuda_ms(lambda: dc.deform_sample(
                    xs, off, k, mod.stride, mask=mask), warmup=2, runs=5)
                row['offsets_px'] = [float(off.abs().mean()),
                                     float(off.abs().max())]
                row['mask_mean_std'] = [float(mask.mean()),
                                        float(mask.std())]
            rows[block] = row
    out = dict(sites=len(sites), sites_ms=total, busy_ms=busy_ms,
               share_of_busy=(total / busy_ms if busy_ms else None),
               timed={k: v for k, v in rows.items() if k in DCN_TIMED})
    log(f'DCN Faster R-CNN deformable sites (bf16 batch {FRCNN_BATCH} x '
        f'{FRCNN_IMG}^2): ' + json.dumps(out))
    log('  every site: ' + json.dumps(
        {k: [round(v['ms'], 3), round(v['conv3x3_ms'], 3)]
         for k, v in rows.items()}) + ' (ms, a 3x3 conv of the shapes)')
    for v in out['timed'].values():  # fractional offsets of a few px,
        # masks spread away from tpudet's init's 0.5
        if not (0.5 < v['offsets_px'][0] < 8 and v['mask_mean_std'][1] > 0.1):
            raise AssertionError('the redrawn offsets or masks are not '
                                 'what the check needs: ' + json.dumps(v))
    return out


def attention_block(torch, block, x):
    """One ``GeneralizedAttention`` call on ``x``: (the energy before the
    softmax, the attention's output before ``gamma`` (``proj_conv``'s),
    both fp64 on the CPU)."""
    from tpudet_torch.models import plugins
    rec = {}
    real = plugins.torch.softmax

    def softmax(energy, dim):
        rec['energy'] = energy.detach().double().cpu()
        return real(energy, dim=dim)
    def record(mod, args, out):  # returns None: the output stays
        rec['out'] = out.detach().double().cpu()
    hook = block.proj_conv.register_forward_hook(record)
    plugins.torch.softmax = softmax
    try:
        with torch.no_grad():
            block(x)
    finally:
        plugins.torch.softmax = real
        hook.remove()
    return rec['energy'], rec['out']


def check_attention_init(torch, cfg, seed, device='cuda'):
    """The attention Faster R-CNN on tpudet's own init (nothing redrawn:
    queries and keys as tpudet draws them, ``gamma`` and the biases 0),
    fp32, TF32 off, one image of ZOO_FP32_IMG^2, forward on ``device`` and
    on the CPU. Each ``GeneralizedAttention`` block of the backbone runs
    on the input that the ``device`` forward gave it, there and in the
    CPU model. Per block: the largest |energy| before the softmax; the
    top-1 minus top-2 energy of each (head, query), its least and median;
    the share of (head, query) pairs whose softmax puts over 0.99 on one
    key; the energies on ``device`` against the CPU within GA_ENERGY_RTOL;
    the pairs whose top key differs, and the near ties (top-2 gap within
    twice the largest energy delta: only these can flip); the attention's
    output (before ``gamma``: at 0 the block returns its input) within
    GA_OUT_RTOL at the settled queries (GA_SETTLED), and its delta at the
    others. Logged beside them, not held: the block's input from the two
    forwards (max |delta| over max |value|), and the energy delta and
    flipped pairs when the CPU block takes the CPU forward's own input.
    Returns the rows logged."""
    from tpudet_torch.apis import init_detector
    from tpudet_torch.models.builder import build_detector
    from tpudet_torch.models.plugins import GeneralizedAttention
    from tpudet_torch.utils.flax_import import random_flax_variables
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        tree = random_flax_variables(build_detector(cfg['model']), seed=SEED,
                                     device=device)
        img = torch.from_numpy(retina_images(cfg, 1, ZOO_FP32_IMG, seed))
        blocks, inputs = {}, {}
        for where in (device, 'cpu'):
            det = init_detector(cfg, variables=tree, device=where,
                                dtype=torch.float32)
            blocks[where] = {
                name: m for name, m in det.model.backbone.named_modules()
                if isinstance(m, GeneralizedAttention)}
            inputs[where] = {}

            def record(name, got=inputs[where]):
                def hook(mod, args):  # returns None: the input stays
                    got.setdefault(name, args[0].detach().clone())
                return hook
            hooks = [m.register_forward_pre_hook(record(name))
                     for name, m in blocks[where].items()]
            try:
                with torch.no_grad():
                    det.model(img.to(where))
            finally:
                for h in hooks:
                    h.remove()
        rows = {}
        for name, block in blocks[device].items():
            x = inputs[device][name]
            cpu_block = blocks['cpu'][name]
            e_dev, o_dev = attention_block(torch, block, x)
            e_cpu, o_cpu = attention_block(torch, cpu_block, x.cpu())
            e_own, _ = attention_block(torch, cpu_block, inputs['cpu'][name])
            top2 = e_cpu.topk(2, dim=-1).values
            gap = top2[..., 0] - top2[..., 1]  # (1, heads, queries)
            e_delta = float((e_dev - e_cpu).abs().max())
            flips = e_dev.argmax(-1) != e_cpu.argmax(-1)
            top_p = e_cpu.softmax(-1).amax(-1)  # (1, heads, queries)
            settled = (top_p > GA_SETTLED).all(1).flatten()
            o_delta = (o_dev - o_cpu).abs().flatten(2).amax((0, 1))
            x_cpu = inputs['cpu'][name].double()
            rows[name] = dict(
                shape=list(x.shape), energy_max=float(e_cpu.abs().max()),
                energy_delta=e_delta, gap_min=float(gap.min()),
                gap_median=float(gap.median()),
                one_hot_share=float((top_p > 0.99).double().mean()),
                pairs=int(gap.numel()), flips=int(flips.sum()),
                near_ties=int((gap <= 2 * e_delta).sum()),
                settled_share=float(settled.double().mean()),
                out_max=float(o_cpu.abs().max()),
                out_delta_settled=float(o_delta[settled].max())
                if settled.any() else 0.0,
                out_delta_other=float(o_delta[~settled].max())
                if (~settled).any() else 0.0,
                input_delta_rel=float((x.cpu().double() - x_cpu).abs().max()
                                      / x_cpu.abs().max()),
                own_input_energy_delta=float((e_dev - e_own).abs().max()),
                own_input_flips=int((e_dev.argmax(-1) != e_own.argmax(-1))
                                    .sum()))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.\
            allow_tf32 = flags
    log(f'attention blocks on tpudet\'s init (gamma 0), fp32 {device} '
        f'against the CPU on the input the {device} forward gave each, one '
        f'image of {ZOO_FP32_IMG}^2: ' + json.dumps(rows))
    for name, r in rows.items():
        if not (r['energy_delta'] <= GA_ENERGY_RTOL * r['energy_max'] and
                r['out_delta_settled'] <= GA_OUT_RTOL * r['out_max'] and
                r['settled_share'] > 0):
            raise AssertionError(f'attention block {name} on the card '
                                 f'differs from the CPU beyond rounding: '
                                 + json.dumps(r))
    del det, blocks, inputs
    torch.cuda.empty_cache()
    return rows


def zoo_batch_fn(torch, cfg, seed, masks=False, size=None):
    """Training batches of FRCNN_TRAIN_BATCH images at ``size`` (by default
    FRCNN_IMG)."""
    size = size or FRCNN_IMG
    if masks:
        return lambda step: mask_train_batch(
            torch, cfg, FRCNN_TRAIN_BATCH, size, seed + step, 'cuda')
    return lambda step: retina_train_batch(cfg, FRCNN_TRAIN_BATCH, size,
                                           seed + step)


def run_dcn(torch, mish):
    """The DCN Faster R-CNN R50 (c3-c5): bf16 inference at batch 8 on
    1344^2, the deformable sites timed, fp32 card against CPU at 640^2,
    2 bf16 steps of 2 images. Returns (times, launches by path)."""
    from tpudet_torch.config import Config
    tree, det, img, infer, times = zoo_inference(
        torch, mish, CONFIG_DCN, 'DCN Faster R-CNN R50', SEED + 3000)
    times['deform'] = time_deform_sites(torch, det, img, times['busy_ms'])
    del det, img
    torch.cuda.empty_cache()
    cfg = Config.fromfile(CONFIG_DCN)
    zoo_fp32_check(torch, cfg, tree, 'DCN Faster R-CNN', ZOO_FP32_IMG,
                   SEED + 3010)
    train = zoo_train_steps(torch, mish, CONFIG_DCN, tree, 'DCN Faster R-CNN',
                            zoo_batch_fn(torch, cfg, SEED + 3020))
    return times, {'dcn_faster_rcnn_inference_forward': infer,
                   'dcn_faster_rcnn_train_step': train}


def run_gcb_attention(torch, mish):
    """The GCB Mask R-CNN r16 (boxes; 2 steps) and the attention '1111'
    Faster R-CNN (its peak memory; fp32 card against CPU at 640^2; its
    blocks on tpudet's init, card against CPU; 2 steps), bf16 batch 8 on
    1344^2. Returns (times, launches by path)."""
    from tpudet_torch.config import Config
    times, launches = {}, {}
    for key, config, name, seed in (
            ('gcb_mask_rcnn', CONFIG_GCB, 'GCB Mask R-CNN r16', SEED + 3100),
            ('attention_faster_rcnn', CONFIG_ATTENTION,
             'attention 1111 Faster R-CNN', SEED + 3200)):
        tree, det, _, infer, times[key] = zoo_inference(
            torch, mish, config, name, seed)
        del det
        torch.cuda.empty_cache()
        cfg = Config.fromfile(config)
        if key == 'attention_faster_rcnn':
            zoo_fp32_check(torch, cfg, tree, name, ZOO_FP32_IMG, seed + 10)
            times[key]['init_blocks'] = check_attention_init(torch, cfg,
                                                             seed + 30)
        launches[f'{key}_inference_forward'] = infer
        launches[f'{key}_train_step'] = zoo_train_steps(
            torch, mish, config, tree, name, zoo_batch_fn(
                torch, cfg, seed + 20, masks='mask' in key))
    return times, launches


def run_ssd(torch, mish):
    """SSD300 (bf16 batch 8 on 300^2; fp32 card against CPU on 300^2; 2
    bf16 steps of the config's 2 images; ``train_detector`` and the test
    CLI) and SSD512 (bf16 batch 8 on 512^2; its 7th level holds no anchor,
    as tpudet's). Returns (times, launches by path)."""
    from tpudet_torch.config import Config
    times = {}
    tree, det, _, infer, times['ssd300'] = zoo_inference(
        torch, mish, CONFIG_SSD300, 'SSD300', SEED + 3300, size=300,
        batch=BATCH)
    del det
    torch.cuda.empty_cache()
    cfg = Config.fromfile(CONFIG_SSD300)
    zoo_fp32_check(torch, cfg, tree, 'SSD300', 300, SEED + 3310)
    n = cfg['data']['samples_per_gpu']
    train = zoo_train_steps(
        torch, mish, CONFIG_SSD300, tree, 'SSD300',
        lambda step: retina_train_batch(cfg, n, 300, SEED + 3320 + step))
    loop, cli = zoo_loop_and_cli(torch, CONFIG_SSD300, 'SSD300', SEED + 3330)
    _, det, _, infer512, times['ssd512'] = zoo_inference(
        torch, mish, CONFIG_SSD512, 'SSD512', SEED + 3400, size=512,
        batch=BATCH)
    levels = [tuple(c.shape[1:3]) for c in det.forward(
        torch.zeros(1, 512, 512, 3, device='cuda'))[0]]
    log(f'SSD512 levels: {levels}')
    if levels[-1] != (0, 0):
        raise AssertionError('SSD512\'s last level is not tpudet\'s 0 x 0')
    del det
    torch.cuda.empty_cache()
    return times, {'ssd300_inference_forward': infer,
                   'ssd300_train_step': train,
                   'ssd300_train_detector_step': loop,
                   'ssd300_test_cli_batch': cli,
                   'ssd512_inference_forward': infer512}


def run_regnet(torch, mish):
    """The RegNetX-3.2GF RetinaNet: bf16 batch 8 on 1344^2, 2 bf16 steps
    of 2 images. Returns (times, launches by path)."""
    from tpudet_torch.config import Config
    tree, det, _, infer, times = zoo_inference(
        torch, mish, CONFIG_REGNET, 'RegNetX-3.2GF RetinaNet', SEED + 3500)
    del det
    torch.cuda.empty_cache()
    cfg = Config.fromfile(CONFIG_REGNET)
    train = zoo_train_steps(torch, mish, CONFIG_REGNET, tree,
                            'RegNetX-3.2GF RetinaNet',
                            zoo_batch_fn(torch, cfg, SEED + 3510))
    return times, {'regnet_retinanet_inference_forward': infer,
                   'regnet_retinanet_train_step': train}


def run_zoo_deg(torch):
    """Phase 17: the DCN Faster R-CNN, the GCB Mask R-CNN, the attention
    Faster R-CNN, SSD300 / SSD512 and the RegNetX RetinaNet at full width
    and depth. Returns each path's launches of each kernel (all 0:
    ReLU)."""
    from tpudet_torch.ops import mish
    launches, times = {}, {}
    for name, fn in (('dcn', run_dcn), ('gcb_attention', run_gcb_attention),
                     ('ssd', run_ssd), ('regnet', run_regnet)):
        t0 = time.perf_counter()
        times[name], paths = fn(torch, mish)
        launches.update(paths)
        log(f'phase 17 {name}: {time.perf_counter() - t0:.1f} s')
    deferred_checks_finish()  # the phase's last fp32 checks
    log('phase 17 inference times: ' + json.dumps(times))
    return {k: {path: counts[k] for path, counts in launches.items()}
            for k in ('mish_fwd', 'mish_bwd')}


# ---------------------------------------------------------------------------
# 18. the ATSS family: zoo row f (GFL, LD) and row j's ATSS and VFNet

CONFIG_GFL = os.path.join(ROOT, 'configs/gfl/gfl_r50_fpn_1x_coco.py')
CONFIG_ATSS = os.path.join(ROOT, 'configs/atss/atss_r50_fpn_1x_coco.py')
CONFIG_VFNET = os.path.join(ROOT, 'configs/vfnet/vfnet_r50_fpn_1x_coco.py')
CONFIG_LD = os.path.join(ROOT, 'configs/ld/ld_r18_gflv1_r101_fpn_coco_1x.py')
# the redraws of phase 18 (class logits as RetinaNet's): ATSS's centerness
# logits, GFL's bin logits (distances of a few strides from a softmax that
# is not flat) and VFNet's log-distances (exp of it times 64-1024 px)
ATSS_CTR_SPREAD, GFL_BIN_SPREAD, VFNET_REG_SPREAD = 1.0, 1.0, 0.3
# fp32 card vs CPU: detections paired per image, at least (of the
# test_cfg's 100)
ATSS_MIN_PAIRS = 50


def atss_decode_and_nms_ms(torch, det, img, module=None):
    """A dense head's ``get_bboxes`` split on one bf16 call's pred maps:
    decode (the per-level top-k, the decode, the concatenation: the
    ``batched_nms`` of ``module``, the ATSS family's ``atss_head`` by
    default, skipped) and ``batched_nms`` on the candidates the call gave
    it, device ms; the candidates over ``score_thr``."""
    if module is None:
        from tpudet_torch.models.dense_heads import atss_head as module
    model = det.model
    recorded = []
    orig = module.batched_nms

    def record(*args, **kwargs):
        recorded.append((args, kwargs))
        return orig(*args, **kwargs)
    module.batched_nms = record
    try:
        with torch.inference_mode():
            maps = model(img)
            model.get_bboxes(maps)
        args, kwargs = recorded[0]
        module.batched_nms = lambda *a, **k: a[0]
        with torch.inference_mode():
            decode = cuda_ms(lambda: model.get_bboxes(maps), warmup=2,
                             runs=5)
            nms = cuda_ms(lambda: orig(*args, **kwargs), warmup=2, runs=5)
    finally:
        module.batched_nms = orig
    return {'decode_ms': decode, 'nms_ms': nms,
            'nms_candidates': int((args[1] > args[2]).sum())}


def run_atss_model(torch, mish, key, config, name, seed):
    """One model of the family: bf16 inference at batch 8 on 1344^2 with
    its decode and NMS ms, fp32 card against CPU at ZOO_FP32_IMG^2 (at
    least ATSS_MIN_PAIRS pairs an image), 2 bf16 steps of 2. Returns
    (weights tree, times, launches by path)."""
    from tpudet_torch.config import Config
    tree, det, img, infer, times = zoo_inference(torch, mish, config, name,
                                                 seed)
    times.update(atss_decode_and_nms_ms(torch, det, img))
    log(f'{name} get_bboxes split: ' + json.dumps(
        {k: times[k] for k in ('decode_ms', 'nms_ms', 'nms_candidates')}))
    del det, img
    torch.cuda.empty_cache()
    cfg = Config.fromfile(config)
    times['fp32_pairs'] = zoo_fp32_check(torch, cfg, tree, name,
                                         ZOO_FP32_IMG, seed + 10,
                                         min_pairs=ATSS_MIN_PAIRS)
    train = zoo_train_steps(torch, mish, config, tree, name,
                            zoo_batch_fn(torch, cfg, seed + 20))
    return tree, times, {f'{key}_inference_forward': infer,
                         f'{key}_train_step': train}


def run_zoo_atss(torch):
    """Phase 18: GFL, ATSS, VFNet (R50-FPN) and LD (R-18 student, R-101
    teacher) at full width and depth; ``train_detector`` on LD, the test
    CLI on GFL. Returns each path's launches of each kernel (all 0:
    ReLU)."""
    import tempfile

    from tpudet_torch.ops import mish
    from tpudet_torch.utils.checkpoint import save_variables
    launches, times = {}, {}
    for key, config, name, seed in (
            ('gfl', CONFIG_GFL, 'GFL R50-FPN', SEED + 4000),
            ('atss', CONFIG_ATSS, 'ATSS R50-FPN', SEED + 4100),
            ('vfnet', CONFIG_VFNET, 'VFNet R50-FPN', SEED + 4200),
            ('ld', CONFIG_LD, 'LD R-18 (R-101 teacher)', SEED + 4300)):
        t0 = time.perf_counter()
        tree, times[key], paths = run_atss_model(torch, mish, key, config,
                                                 name, seed)
        launches.update(paths)
        if key == 'gfl':
            with tempfile.TemporaryDirectory() as tmp:
                ckpt = os.path.join(tmp, 'gfl.msgpack')
                save_variables(ckpt, tree)
                launches['gfl_test_cli_batch'] = run_cli_eval(
                    torch, config, ckpt, img_size=FRCNN_IMG,
                    mish_per_forward=0)
        if key == 'ld':
            launches['ld_train_detector_step'], _ = zoo_loop_and_cli(
                torch, config, name, seed + 30, cli=False)
        del tree
        torch.cuda.empty_cache()
        log(f'phase 18 {key}: {time.perf_counter() - t0:.1f} s')
    deferred_checks_finish()  # the phase's last fp32 checks
    log('phase 18 inference times: ' + json.dumps(times))
    return {k: {path: counts[k] for path, counts in launches.items()}
            for k in ('mish_fwd', 'mish_bwd')}


# ---------------------------------------------------------------------------
# 19. PAA (row j) and ROADMAP.md's zoo row h: Libra R-CNN and RetinaNet,
# GRoIE, GHM RetinaNet

CONFIG_PAA = os.path.join(ROOT, 'configs/paa/paa_r50_fpn_1x_coco.py')
CONFIG_LIBRA_FRCNN = os.path.join(
    ROOT, 'configs/libra_rcnn/libra_faster_rcnn_r50_fpn_1x_coco.py')
CONFIG_LIBRA_RETINA = os.path.join(
    ROOT, 'configs/libra_rcnn/libra_retinanet_r50_fpn_1x_coco.py')
CONFIG_GROIE = os.path.join(
    ROOT, 'configs/groie/faster_rcnn_r50_fpn_groie_1x_coco.py')
CONFIG_GHM = os.path.join(ROOT, 'configs/ghm/retinanet_ghm_r50_fpn_1x_coco.py')
# BFP's non-local block: theta's and phi's outputs spread as the
# attention's queries and keys, conv_out's output by 1 (tpudet's zero init
# leaves the block the identity)
BFP_QK_SPREAD, BFP_OUT_SPREAD = 1.0, 1.0
# the Libra RetinaNet's canvas: its BFP brings P3-P7 to P4 by integer
# ratios (tpudet asserts them), and on 1344^2 P7 is 11 x 11 against P4's
# 84 x 84; 1408 is the multiple of 128 next above
LIBRA_RETINA_IMG = 1408
# PAA's positive mask, card against CPU in fp32 on the same pred maps:
# at most this share of the CPU's positives may differ (the EM's stop at
# tol 1e-3 and the kept prefix follow the candidates' fp32 losses)
PAA_MASK_SHARE = 0.01


@contextlib.contextmanager
def paa_assign_probe():
    """Records each ``PAAHead.assign`` while it is active: the positives
    and the EM iterations over the valid gts (mean and max; the loop runs
    up to the next multiple of ``EM_CHECK_EVERY`` masked)."""
    from tpudet_torch.models.dense_heads import paa_head
    rows = []
    orig = paa_head.PAAHead.assign

    def assign(self, preds, gt_bboxes, gt_labels, gt_valid):
        out = orig(self, preds, gt_bboxes, gt_labels, gt_valid)
        it = out[-1].iterations[gt_valid]
        rows.append(dict(
            positives=int(out[3].sum()), gts=int(gt_valid.sum()),
            em_iterations_mean=float(it.float().mean()),
            em_iterations_max=int(it.max()),
            em_loop=min(100, -(-int(it.max()) // paa_head.EM_CHECK_EVERY) *
                        paa_head.EM_CHECK_EVERY)))
        return out
    paa_head.PAAHead.assign = assign
    try:
        yield rows
    finally:
        paa_head.PAAHead.assign = orig


def check_paa_mask(torch, cfg, tree, seed):
    """PAA's positive mask card against CPU in fp32 (TF32 off) on the same
    pred maps: the card's fp32 forward of a training batch of 2 images of
    ZOO_FP32_IMG^2, then ``assign`` on the card and, on copies of those
    maps, on the CPU. Returns the masks' numbers."""
    import copy

    from tpudet_torch.apis import init_detector
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        det = init_detector(cfg, variables=tree, device='cuda',
                            dtype=torch.float32)
        batch = retina_train_batch(cfg, 2, ZOO_FP32_IMG, seed)
        gts = [torch.from_numpy(batch[k]) for k in ('gt_bboxes', 'gt_labels',
                                                   'gt_valid')]
        head = det.model.bbox_head
        with torch.no_grad():
            maps = det.model(torch.from_numpy(batch['img']).cuda())
            card = head.assign(maps, *[g.cuda() for g in gts])
            cpu = copy.deepcopy(head).cpu().assign(
                tuple(tuple(m.cpu() for m in lvl) for lvl in maps), *gts)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.\
            allow_tf32 = flags
    pos_card, pos_cpu = card[3].cpu(), cpu[3]
    out = dict(positives_cpu=int(pos_cpu.sum()),
               positives_card=int(pos_card.sum()),
               differ=int((pos_card ^ pos_cpu).sum()),
               em_iterations_differ=int((card[-1].iterations.cpu() !=
                                         cpu[-1].iterations).sum()),
               gts=int(gts[2].sum()))
    log(f'PAA positive mask, fp32 card vs CPU on the same pred maps (2 '
        f'images of {ZOO_FP32_IMG}^2): ' + json.dumps(out) + f' (at most '
        f'{PAA_MASK_SHARE} of the CPU\'s positives may differ)')
    if not (out['positives_cpu'] and
            out['differ'] <= PAA_MASK_SHARE * out['positives_cpu']):
        raise AssertionError('PAA\'s positive mask on the card differs from '
                             'the CPU\'s')
    del det
    torch.cuda.empty_cache()
    return out


def roi_extract_ms(torch, det, img):
    """The RoI head's ``extract`` on the proposals of one bf16 call, device
    ms (the pooled rois and the output's MB)."""
    head = det.model.roi_head
    seen = []
    orig = head.extract

    def record(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append((args, kwargs, out.numel() * out.element_size() / 1e6))
        return out
    head.extract = record
    try:
        with torch.inference_mode():
            det.model(img)
    finally:
        del head.extract
    args, kwargs, mb = seen[0]
    with torch.inference_mode():
        ms = cuda_ms(lambda: orig(*args, **kwargs), warmup=2, runs=5)
    return {'roi_extract_ms': ms, 'rois': int(args[1].shape[0] *
                                              args[1].shape[1]),
            'pooled_mb': mb}


def run_zoo_paa_libra(torch):
    """Phase 19: PAA, the Libra RetinaNet (on LIBRA_RETINA_IMG^2), the GHM
    RetinaNet (its inference is RetinaNet's: weights and steps only), the
    Libra Faster R-CNN and the GRoIE Faster R-CNN, R50-FPN at full width
    and depth: bf16 inference at batch 8 (e2e, forward, device busy, peak
    memory; the one-stage models' decode and NMS ms, the R-CNNs' RoI
    extract ms), fp32 card against CPU on 2 images of ZOO_FP32_IMG^2 (the
    one-stage models at least ATSS_MIN_PAIRS pairs an image, the R-CNNs
    1 % may differ), 2 bf16 steps of 2 (PAA's positives and EM iterations
    a step); PAA's positive mask card against CPU; the test CLI on PAA,
    ``train_detector`` on the Libra Faster R-CNN. Returns each path's
    launches of each kernel (all 0: ReLU)."""
    import tempfile

    from tpudet_torch.config import Config
    from tpudet_torch.models.dense_heads import retina_head
    from tpudet_torch.ops import mish
    from tpudet_torch.utils.checkpoint import save_variables
    log(f'phase 19 redraws: BFP non-local theta / phi outputs spread '
        f'{BFP_QK_SPREAD}, conv_out {BFP_OUT_SPREAD} (tpudet inits it at 0)')
    launches, times = {}, {}
    for key, config, name, seed in (
            ('paa', CONFIG_PAA, 'PAA R50-FPN', SEED + 5000),
            ('libra_retinanet', CONFIG_LIBRA_RETINA,
             'Libra RetinaNet R50-FPN', SEED + 5100),
            ('ghm_retinanet', CONFIG_GHM, 'GHM RetinaNet R50-FPN',
             SEED + 5200),
            ('libra_faster_rcnn', CONFIG_LIBRA_FRCNN,
             'Libra Faster R-CNN R50-FPN', SEED + 5300),
            ('groie_faster_rcnn', CONFIG_GROIE, 'GRoIE Faster R-CNN R50-FPN',
             SEED + 5400)):
        t0 = time.perf_counter()
        cfg = Config.fromfile(config)
        size = LIBRA_RETINA_IMG if key == 'libra_retinanet' else FRCNN_IMG
        if key == 'ghm_retinanet':
            tree = zoo_variables(torch, cfg, retina_images(
                cfg, FRCNN_TRAIN_BATCH, size, seed), seed)
            t = {}
        else:
            tree, det, img, infer, t = zoo_inference(torch, mish, config,
                                                     name, seed, size=size)
            launches[f'{key}_inference_forward'] = infer
            if key.endswith('faster_rcnn'):
                t.update(roi_extract_ms(torch, det, img))
            else:
                t.update(atss_decode_and_nms_ms(
                    torch, det, img, None if key == 'paa' else retina_head))
            log(f'{name} split: ' + json.dumps(
                {k: v for k, v in t.items() if k in (
                    'decode_ms', 'nms_ms', 'nms_candidates',
                    'roi_extract_ms', 'rois', 'pooled_mb')}))
            del det, img
            torch.cuda.empty_cache()
            t['fp32_pairs'] = zoo_fp32_check(
                torch, cfg, tree, name, ZOO_FP32_IMG, seed + 10,
                min_pairs=1 if key.endswith('faster_rcnn') else
                ATSS_MIN_PAIRS)
        batches = zoo_batch_fn(torch, cfg, seed + 20, size=size)
        if key == 'paa':
            t['positive_mask'] = check_paa_mask(torch, cfg, tree, seed + 15)
            with paa_assign_probe() as rows:
                train = zoo_train_steps(torch, mish, config, tree, name,
                                        batches)
            t['assign_per_step'] = rows
            log(f'{name} assignment a step: ' + json.dumps(rows))
            if not all(r['positives'] > 0 for r in rows):
                raise AssertionError('PAA kept no positive in a step')
            with tempfile.TemporaryDirectory() as tmp:
                ckpt = os.path.join(tmp, 'paa.msgpack')
                save_variables(ckpt, tree)
                launches['paa_test_cli_batch'] = run_cli_eval(
                    torch, config, ckpt, img_size=FRCNN_IMG,
                    mish_per_forward=0)
        else:
            train = zoo_train_steps(torch, mish, config, tree, name, batches)
        launches[f'{key}_train_step'] = train
        if key == 'libra_faster_rcnn':
            launches['libra_faster_rcnn_train_detector_step'], _ = \
                zoo_loop_and_cli(torch, config, name, seed + 30, cli=False)
        times[key] = t
        del tree
        torch.cuda.empty_cache()
        log(f'phase 19 {key}: {time.perf_counter() - t0:.1f} s')
    deferred_checks_finish()  # the phase's last fp32 checks
    log('phase 19 inference times: ' + json.dumps(times))
    return {k: {path: counts[k] for path, counts in launches.items()}
            for k in ('mish_fwd', 'mish_bwd')}


# ---------------------------------------------------------------------------
# 20. ROADMAP.md's zoo row i: Mask Scoring R-CNN, HTC, SCNet, PointRend,
# DetectoRS (SAC backbone, RFP neck) and YOLACT

CONFIG_MS_RCNN = os.path.join(ROOT,
                              'configs/ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py')
CONFIG_HTC = os.path.join(ROOT, 'configs/htc/htc_r50_fpn_1x_coco.py')
CONFIG_SCNET = os.path.join(ROOT, 'configs/scnet/scnet_r50_fpn_1x_coco.py')
CONFIG_POINT_REND = os.path.join(
    ROOT, 'configs/point_rend/point_rend_r50_fpn_1x_coco.py')
CONFIG_DETECTORS = os.path.join(
    ROOT, 'configs/detectors/detectors_htc_r50_1x_coco.py')
CONFIG_YOLACT = os.path.join(ROOT, 'configs/yolact/yolact_r50_1x8_coco.py')
# phase 20's redraws (module name regex -> (spread, bias)): the mask
# logits of every mask head (PointRend's coarse and point heads too) as
# phase 12's; YOLACT's 81 class logits (at tpudet's N(0, 0.01^2) every
# class sits at 1/81, under score_thr 0.05), deltas and prototype
# coefficients; and the leaves tpudet inits at zero, which leave SAC's
# context convs and switch and RFP's feedback and gate near identities:
# the context convs' outputs spread by SAC_CONTEXT_SPREAD, the switch's
# logits by 1 around tpudet's bias 1, the feedback conv's outputs by
# RFP_FEEDBACK_SPREAD, the gate's logits by 1; weight_diff at
# SAC_DIFF_SCALE of the kernel's std
YOLACT_CLS_SPREAD, YOLACT_COEFF_SPREAD = 3.0, 1.0
SAC_CONTEXT_SPREAD, RFP_FEEDBACK_SPREAD, SAC_DIFF_SCALE = 0.3, 0.3, 0.3
ZOO_I_SPREADS = {
    r'mask_head\d*\.conv_logits$': (MASK_LOGIT_SPREAD, 0.0),
    r'(mask_head|point_head)\.fc_logits$': (MASK_LOGIT_SPREAD, 0.0),
    r'bbox_head\.conv_cls$': (YOLACT_CLS_SPREAD, 0.0),
    r'bbox_head\.conv_reg$': (RETINA_REG_SPREAD, 0.0),
    r'bbox_head\.conv_coeff$': (YOLACT_COEFF_SPREAD, 0.0),
    r'\.(pre|post)_context$': (SAC_CONTEXT_SPREAD, 0.0),
    r'\.switch$': (1.0, 1.0),
    r'\.rfp_conv$': (RFP_FEEDBACK_SPREAD, 0.0),
    r'\.rfp_weight$': (1.0, 0.0)}
ZOO_I_SEMANTIC_CLASSES = 183
# fp32 card against the CPU: one image of ZOO_FP32_IMG^2, where RoIs reach
# every FPN level (P5 takes boxes of 448 px and more); the CPU's forward
# of these R50 models takes seconds, so one image, not the earlier
# phases' two; the redraw's measuring forward on the first 2 of the 8
ZOO_I_FP32_IMAGES, ZOO_I_REDRAW_IMAGES = 1, 2
# fp32 card against the CPU on the paired detections: the share of mask
# probabilities further apart than MRCNN_PROB_ATOL. PointRend's 784
# points a round are the most uncertain pixels, and a tie of -|logit|
# (common after a 2x upsample) falls either way under rounding; the other
# mask branches have no such choice
ZOO_I_MASK_SHARE = {'ms_rcnn': 0.0, 'scnet': 0.0, 'point_rend': 0.01,
                    'yolact': 0.0}
ZOO_I_CLI_IMAGES = 8


def zoo_i_measure(torch):
    """``run(model, img)`` for ``redrawn_variables``: the forward, and the
    mask branch on each image's first 100 rois where the model has one
    (PointRend's with labels 0), so that its layers' inputs are measured."""
    from tpudet_torch.apis.test import _mask_mode

    def run(model, x):
        out = model(x)
        mode = _mask_mode(model)
        if mode in ('roi', 'roi_labels'):
            boxes, valid = out[0][:, :100], out[1][:, :100]
            extra = ((torch.zeros_like(valid, dtype=torch.long),)
                     if mode == 'roi_labels' else ())
            model.predict_masks(x, boxes, valid, *extra)
    return run


def zoo_i_inference(torch, mish, config, name, seed):
    """``config``'s model at full width and depth, bf16, FRCNN_BATCH images
    on FRCNN_IMG squares, every count at 0 just before the one call: with
    a mask branch the test flow's ``predict_masks`` (its mode) and each
    image's RLEs pasted at MRCNN_ORI (``masks_to_segm_results``: the paste
    and the run boundaries on the card), else the detections; e2e,
    bbox-only and forward ms, device busy, peak memory. Returns (weights
    tree, Detector, images, scale factors, launches, times)."""
    from tpudet_torch.apis import init_detector
    from tpudet_torch.apis.test import (_mask_mode, masks_to_segm_results,
                                        predict_masks)
    from tpudet_torch.config import Config
    cfg = Config.fromfile(config)
    img_np = retina_images(cfg, FRCNN_BATCH, FRCNN_IMG, seed)
    t0 = time.perf_counter()
    deferred_checks_start()  # the last model's CPU check beside the draw
    tree = zoo_variables(torch, cfg, img_np[:ZOO_I_REDRAW_IMAGES], seed,
                         extra=ZOO_I_SPREADS, run=zoo_i_measure(torch))
    det = init_detector(cfg, variables=tree, device='cuda',
                        dtype=torch.bfloat16)
    model = det.model
    mode = _mask_mode(model)
    n_params = sum(p.numel() for p in model.parameters())
    log(f'{name}: {n_params / 1e6:.2f} M parameters, bf16, mask mode '
        f'{mode}, weights from seed {SEED} on the card (prediction and '
        f'zero-init layers redrawn, numpy seed {seed}) in '
        f'{time.perf_counter() - t0:.1f} s')
    img = torch.from_numpy(img_np).cuda()
    sf = torch.ones((FRCNN_BATCH, 4), device='cuda')
    h, w = MRCNN_ORI[:2]
    metas = [dict(ori_shape=MRCNN_ORI)] * FRCNN_BATCH
    nc = getattr(model, 'roi_head', getattr(model, 'bbox_head', None)
                 ).num_classes

    def e2e():
        with torch.inference_mode():
            if mode is None:
                return det(img), None, None
            res, probs = predict_masks(model, img, sf)
            return res, probs, masks_to_segm_results(probs, res, metas, nc,
                                                     MASK_THR)

    deferred_checks_join()  # before anything timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(mish)
    res, probs, segm = e2e()
    torch.cuda.synchronize()
    launches = _mish_counts(mish)
    n_valid = [int(v) for v in res.valid.sum(1)]
    msg = f'{name} bf16 batch {FRCNN_BATCH} x {FRCNN_IMG}^2: launches ' \
        f'{json.dumps(launches)}, detections per image {n_valid}'
    if segm is not None:
        n_rle = [sum(len(c) for c in s) for s in segm]
        areas = mask_areas(segm)
        msg += (f', masks {tuple(probs.shape[2:])} pasted at {w} x {h}: RLEs '
                f'per image {n_rle}, probabilities min '
                f'{float(probs.min()):.4f} max {float(probs.max()):.4f} mean '
                f'{float(probs.float().mean()):.4f}, first areas {areas[:3]}')
        # where a mask pastes empty: its box off the canvas, or its
        # probabilities at or under MASK_THR inside the box
        b = res.bboxes[res.valid].float()
        on = ((b[:, 2].clamp(max=w) - b[:, 0].clamp(min=0)).clamp(min=0) *
              (b[:, 3].clamp(max=h) - b[:, 1].clamp(min=0)).clamp(min=0))
        above = (probs[res.valid] > MASK_THR).float().mean(dim=(1, 2))
        msg += (f'; boxes overlapping the canvas by >= 1 px^2: '
                f'{int((on >= 1).sum())} of {len(b)}, median box '
                f'{float((b[:, 2:] - b[:, :2]).median(0).values[0]):.1f} x '
                f'{float((b[:, 2:] - b[:, :2]).median(0).values[1]):.1f} px, '
                f'mean share of mask cells above {MASK_THR}: '
                f'{float(above.mean()):.4f}')
    log(msg)
    if segm is not None:
        nonempty_share(areas, f'{name} bf16')
    if any(launches.values()):
        raise AssertionError(f'the {name} path launched a mish kernel')
    if not (torch.isfinite(res.bboxes).all() and
            torch.isfinite(res.scores).all() and min(n_valid) > 0):
        raise AssertionError(f'{name}: non-finite detections or an image '
                             f'without')
    if segm is not None and (n_rle != n_valid or not bool(
            torch.isfinite(probs).all()) or any(
            sum(r['counts']) != h * w for s in segm for c in s for r in c)):
        raise AssertionError(f'{name}: masks missing, non-finite or of the '
                             f'wrong size')
    del res, probs, segm
    with torch.inference_mode():
        times = {'e2e_ms': cuda_ms(e2e, warmup=1, runs=3),
                 'forward_ms': cuda_ms(lambda: model(img), warmup=1,
                                       runs=3)}
        if mode is not None:
            times['bbox_only_e2e_ms'] = cuda_ms(lambda: det(img), warmup=1,
                                                runs=3)
    times['img_per_s'] = FRCNN_BATCH / times['e2e_ms'] * 1e3
    times['peak_mem_gib'] = torch.cuda.max_memory_allocated() / 2**30
    prof = profile_device(torch, e2e, f'{name} e2e call', calls=1, top=8)
    times['busy_ms'] = prof[1] if prof else None
    log(f'{name} bf16 batch {FRCNN_BATCH} x {FRCNN_IMG}^2: ' +
        json.dumps(times))
    return tree, det, img, sf, launches, times


def sac_share(torch, det, img, busy_ms):
    """DetectoRS's fp32 SAC convs on the inputs one bf16 call gives them:
    the two 3x3s of every SAC (both backbones) run alone, and every SAC
    module whole, device ms, and the convs' share of the call's device
    busy ms; TF32 as the script has it (off since phase 4)."""
    import torch.nn.functional as F
    from tpudet_torch.models.backbones.detectors_resnet import SAConv2d
    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: calls.append((mod, args[0])))
        for m in det.model.modules() if isinstance(m, SAConv2d)]
    try:
        with torch.inference_mode():
            det.model(img)
    finally:
        for h in hooks:
            h.remove()

    def convs():
        for mod, x in calls:
            xk = x.float()
            F.conv2d(xk, mod.weight, None, mod.stride, 1, 1, mod.groups)
            F.conv2d(xk, mod.weight + mod.weight_diff, None, mod.stride, 3, 3,
                     mod.groups)

    with torch.inference_mode():
        conv_ms = cuda_ms(convs, warmup=1, runs=3)
        module_ms = cuda_ms(lambda: [mod(x) for mod, x in calls], warmup=1,
                            runs=3)
    out = dict(sac_sites=len(calls), sac_fp32_conv_ms=conv_ms,
               sac_module_ms=module_ms,
               sac_fp32_conv_share=conv_ms / busy_ms if busy_ms else None,
               tf32=torch.backends.cudnn.allow_tf32)
    log('DetectoRS SAC convs (fp32) on one bf16 call\'s inputs: ' +
        json.dumps(out))
    return out


def point_rend_refine_ms(torch, det, img, sf):
    """PointRend's ``refine_masks`` (5 rounds to 224^2, 784 points a
    round) on one bf16 call's detections, device ms."""
    model = det.model
    with torch.inference_mode():
        feats = model.extract_feat(img)
        res = model.get_bboxes(model.detect(feats, tuple(img.shape[1:3])),
                               scale_factors=sf)
        coarse = model.roi_head.mask_forward(feats, res.bboxes, res.valid)
        ms = cuda_ms(lambda: model.roi_head.refine_masks(
            feats, res.bboxes, res.valid, res.labels, coarse), warmup=1,
            runs=3)
    out = {'refine_ms': ms, 'refined_masks': int(res.valid.sum())}
    log('PointRend refine_masks: ' + json.dumps(out))
    return out


def yolact_fast_nms_check(torch, det, img):
    """YOLACT's fast NMS on the candidates one bf16 call gave it: device
    ms, and the card's result equal to the CPU's on the same inputs (every
    valid slot: boxes, scores, labels, rows)."""
    from tpudet_torch.models.dense_heads import yolact_head
    recorded = []
    orig = yolact_head.batched_fast_nms

    def record(*args, **kwargs):
        recorded.append((args, kwargs))
        return orig(*args, **kwargs)
    yolact_head.batched_fast_nms = record
    try:
        with torch.inference_mode():
            det(img)
    finally:
        yolact_head.batched_fast_nms = orig
    args, kwargs = recorded[0]
    with torch.inference_mode():
        ms = cuda_ms(lambda: orig(*args, **kwargs), warmup=2, runs=5)
        card, card_idx = orig(*args, **kwargs)
        cpu, cpu_idx = orig(*[a.cpu() if torch.is_tensor(a) else a
                              for a in args], **kwargs)
    valid = cpu.valid
    equal = torch.equal(card.valid.cpu(), valid) and all(
        torch.equal(a.cpu(), b) for a, b in zip(card, cpu)) and torch.equal(
        card_idx.cpu()[valid], cpu_idx[valid])
    out = {'fast_nms_ms': ms, 'candidates': list(args[1].shape),
           'kept': int(valid.sum()), 'card_equals_cpu': equal}
    log('YOLACT fast NMS: ' + json.dumps(out))
    if not (equal and out['kept']):
        raise AssertionError('YOLACT\'s fast NMS on the card differs from '
                             'the CPU on the same inputs')
    return out


def zoo_i_fp32_check(torch, cfg, tree, key, name, seed):
    """fp32 on the card (TF32 off) against the port's CPU call on
    ZOO_I_FP32_IMAGES seeded images of ZOO_FP32_IMG^2, through the test
    flow's ``predict_masks`` where the model has masks: the detections
    pair one-to-one (label, IoU >= MATCH_IOU), all but FRCNN_KEEP_SHARE of
    the CPU's; the mask probabilities of the pairs (every mask mode)
    further apart than MRCNN_PROB_ATOL at most at ZOO_I_MASK_SHARE of the
    pixels. The CPU's call and the comparison are queued
    (``deferred_checks_start``); the returned dict of numbers is filled
    then."""
    from tpudet_torch.apis import init_detector
    from tpudet_torch.apis.test import predict_masks
    masks = key in ZOO_I_MASK_SHARE
    n = ZOO_I_FP32_IMAGES
    few = torch.from_numpy(retina_images(cfg, n, ZOO_FP32_IMG, seed))
    sf = torch.ones((n, 4))
    result = dict(pairs=[], mask_prob_max_abs=0.0, mask_pixel_share=0.0)

    def call(device):
        det = init_detector(cfg, variables=tree, device=device,
                            dtype=torch.float32)
        with torch.inference_mode():
            res, probs = (predict_masks(det.model, few.to(device),
                                        sf.to(device)) if masks
                          else (det(few.to(device)), None))
        return (type(res)(*(t.cpu() for t in res)),
                None if probs is None else probs.cpu())

    def compare(got, got_p):
        t0 = time.perf_counter()
        ref, ref_p = call('cpu')
        cpu_s = time.perf_counter() - t0
        far = total = 0
        for i in range(n):
            m, n_ref, n_got, gap = match_detections(ref, got, i, MATCH_IOU)
            result['pairs'].append(m)
            if masks:
                pairs = detection_pairs(ref, got, i, MATCH_IOU)
                r_idx = torch.tensor([r for r, _ in pairs], dtype=torch.long)
                g_idx = torch.tensor([g for _, g in pairs], dtype=torch.long)
                d = (ref_p[i][r_idx] - got_p[i][g_idx]).abs()
                result['mask_prob_max_abs'] = max(
                    result['mask_prob_max_abs'], float(d.max()))
                far += int((d > MRCNN_PROB_ATOL).sum())
                total += d.numel()
            log(f'{name} fp32 card vs CPU ({cpu_s:.1f} s on the CPU), image '
                f'{i} at {ZOO_FP32_IMG}^2: detections {m} matched of {n_ref} '
                f'/ {n_got} (label and IoU >= {MATCH_IOU}), largest box '
                f'delta {gap:.3e} px')
            if not (n_ref and n_ref - m <= FRCNN_KEEP_SHARE * n_ref):
                raise AssertionError(f'{name} fp32 detections on the card '
                                     f'differ from the CPU')
        if masks:
            result['mask_pixel_share'] = far / max(total, 1)
            log(f'{name} fp32 card vs CPU masks {tuple(ref_p.shape[2:])} on '
                f'the pairs: max |delta| {result["mask_prob_max_abs"]:.3e}, '
                f'share further than {MRCNN_PROB_ATOL}: '
                f'{result["mask_pixel_share"]:.3e} (at most '
                f'{ZOO_I_MASK_SHARE[key]})')
            if not (total and result['mask_pixel_share'] <=
                    ZOO_I_MASK_SHARE[key]):
                raise AssertionError(f'{name} fp32 masks on the card differ '
                                     f'from the CPU')

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = call('cuda')
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.\
            allow_tf32 = flags
    DEFERRED_CHECKS.append(lambda: compare(*got))
    torch.cuda.empty_cache()
    return result


def semantic_batch_fn(torch, cfg, seed):
    """``zoo_batch_fn``'s batches with masks and a seeded semantic map at
    stride 8 (ZOO_I_SEMANTIC_CLASSES labels), made on the card."""
    base = zoo_batch_fn(torch, cfg, seed, masks=True)

    def batch(step):
        b = base(step)
        gen = torch.Generator(device='cuda')
        gen.manual_seed(seed + step)
        b['gt_semantic_seg'] = torch.randint(
            0, ZOO_I_SEMANTIC_CLASSES,
            (FRCNN_TRAIN_BATCH, FRCNN_IMG // 8, FRCNN_IMG // 8),
            generator=gen, device='cuda')
        return b
    return batch


def run_zoo_row_i(torch):
    """Phase 20: Mask Scoring R-CNN, HTC, SCNet, PointRend, DetectoRS and
    YOLACT, R50 at full width and depth: bf16 inference at batch 8 on
    1344^2 with masks pasted and RLE-encoded where the model has a mask
    branch (``'roi'``: MS R-CNN, SCNet; ``'roi_labels'``: PointRend;
    ``'proto'``: YOLACT; HTC and DetectoRS bbox only), PointRend's refine
    ms, YOLACT's fast-NMS ms (card equal to CPU), the share of DetectoRS's
    fp32 SAC convs, the share of non-empty pasted masks (above 0); fp32
    card against CPU (detections, and the masks of the four with a mask
    branch); 2 bf16 steps of 2 images (with ``gt_frame_masks``, HTC and
    SCNet with ``gt_semantic_seg``); the test CLI ``--eval bbox segm`` on
    YOLACT. Returns each path's launches of each kernel (all 0: ReLU)."""
    import tempfile

    from tpudet_torch.config import Config
    from tpudet_torch.ops import mish
    log('phase 20 redraws: ' + json.dumps(
        {k: list(v) for k, v in ZOO_I_SPREADS.items()}) +
        f'; SAC weight_diff x {SAC_DIFF_SCALE} of its kernel\'s std')
    launches, times = {}, {}
    for key, config, name, seed in (
            ('ms_rcnn', CONFIG_MS_RCNN, 'Mask Scoring R-CNN R50-FPN',
             SEED + 6000),
            ('htc', CONFIG_HTC, 'HTC R50-FPN', SEED + 6100),
            ('scnet', CONFIG_SCNET, 'SCNet R50-FPN', SEED + 6200),
            ('point_rend', CONFIG_POINT_REND, 'PointRend R50-FPN',
             SEED + 6300),
            ('detectors', CONFIG_DETECTORS, 'DetectoRS R50 (SAC, RFP)',
             SEED + 6400),
            ('yolact', CONFIG_YOLACT, 'YOLACT R50-FPN', SEED + 6500)):
        t0 = time.perf_counter()
        cfg = Config.fromfile(config)
        tree, det, img, sf, infer, t = zoo_i_inference(torch, mish, config,
                                                       name, seed)
        launches[f'{key}_inference_forward'] = infer
        if key == 'detectors':
            t.update(sac_share(torch, det, img, t['busy_ms']))
        elif key == 'point_rend':
            t.update(point_rend_refine_ms(torch, det, img, sf))
        elif key == 'yolact':
            t.update(yolact_fast_nms_check(torch, det, img))
        del det, img, sf
        torch.cuda.empty_cache()
        t['fp32'] = zoo_i_fp32_check(torch, cfg, tree, key, name, seed + 10)
        batches = (semantic_batch_fn(torch, cfg, seed + 20)
                   if key in ('htc', 'scnet') else
                   zoo_batch_fn(torch, cfg, seed + 20,
                                masks=key != 'detectors'))
        launches[f'{key}_train_step'] = zoo_train_steps(
            torch, mish, config, tree, name, batches)
        if key == 'yolact':
            register_array_data()
            with tempfile.TemporaryDirectory() as tmp:
                arrays, coco = eval_set(SEED + 6600, ZOO_I_CLI_IMAGES)
                launches['yolact_test_cli_batch'] = cli_segm_eval(
                    torch, mish, config, tree, arrays, with_polygons(coco),
                    tmp, FRCNN_IMG)
        times[key] = t
        del tree
        torch.cuda.empty_cache()
        log(f'phase 20 {key}: {time.perf_counter() - t0:.1f} s')
    deferred_checks_finish()  # the phase's last fp32 check
    log('phase 20 inference times: ' + json.dumps(times))
    return {k: {path: counts[k] for path, counts in launches.items()}
            for k in ('mish_fwd', 'mish_bwd')}


# ---------------------------------------------------------------------------
# 21. ROADMAP.md's zoo row j, its one-stage detectors on the RetinaNet
# machinery: FCOS, NAS-FCOS, FoveaBox, AutoAssign, FSAF, FreeAnchor, YOLOF,
# the NAS-FPN RetinaNet

CONFIG_FCOS = os.path.join(
    ROOT, 'configs/fcos/fcos_r50_caffe_fpn_gn-head_1x_coco.py')
CONFIG_NASFCOS = os.path.join(
    ROOT, 'configs/nas_fcos/'
    'nas_fcos_nashead_r50_caffe_fpn_gn-head_4x4_1x_coco.py')
CONFIG_FOVEA = os.path.join(ROOT,
                            'configs/foveabox/fovea_r50_fpn_4x4_1x_coco.py')
CONFIG_AUTOASSIGN = os.path.join(
    ROOT, 'configs/autoassign/autoassign_r50_fpn_8x2_1x_coco.py')
CONFIG_FSAF = os.path.join(ROOT, 'configs/fsaf/fsaf_r50_fpn_1x_coco.py')
CONFIG_FREE_ANCHOR = os.path.join(
    ROOT, 'configs/free_anchor/retinanet_free_anchor_r50_fpn_1x_coco.py')
CONFIG_YOLOF = os.path.join(ROOT, 'configs/yolof/yolof_r50_c5_8x8_1x_coco.py')
CONFIG_NAS_FPN = os.path.join(
    ROOT, 'configs/nas_fpn/retinanet_r50_nasfpn_crop640_50e_coco.py')
# NAS-FPN's levels come from floor max-pools and meet by integer ratios
# only (tpudet's _fit asserts): its canvas is a multiple of 128 (1344 x 800
# fails in both packages)
NAS_FPN_IMG = 1280
# phase 21's redraws (module name regex -> (spread, bias)) of the layers
# the earlier phases' table does not name: the class logits as RetinaNet's;
# FCOS's and NAS-FCOS's log-distances (exp(scale x): 20 px at the bias),
# FoveaBox's (in base edges), AutoAssign's (strides, tpudet's bias 4);
# the centerness and objectness logits; FSAF's TBLR distances (ReLU'd:
# a bias of 1 keeps them positive); YOLOF's class, delta and objectness
# convs. NAS-FCOS's conv_offset is the table's (DCN_OFFSET_SPREAD).
ZOO_J_CLS = (RETINA_CLS_SPREAD, RETINA_CLS_BIAS)
ZOO_J_SPREADS = {
    'fcos': {r'bbox_head\.conv_cls$': ZOO_J_CLS,
             r'bbox_head\.conv_reg$': (0.3, 3.0),
             r'bbox_head\.conv_centerness$': (ATSS_CTR_SPREAD, 0.0)},
    'fovea': {r'bbox_head\.conv_cls$': ZOO_J_CLS,
              r'bbox_head\.conv_reg$': (0.3, 0.0)},
    'autoassign': {r'bbox_head\.conv_cls$': ZOO_J_CLS,
                   r'bbox_head\.conv_reg$': (1.0, 4.0),
                   r'bbox_head\.conv_objectness$': (1.0, 0.0)},
    'fsaf': {r'bbox_head\.retina_reg$': (0.3, 1.0)},
    'free_anchor': {},
    'yolof': {r'bbox_head\.cls_score$': ZOO_J_CLS,
              r'bbox_head\.bbox_pred$': (RETINA_REG_SPREAD, 0.0),
              r'bbox_head\.object_pred$': (1.0, 0.0)},
    'nas_fpn': {},
}
ZOO_J_SPREADS['nasfcos'] = ZOO_J_SPREADS['fcos']


def zoo_j_leaves(seed):
    """The heads' raw leaves, which tpudet inits at 1, 0 and 1, redrawn:
    the level ``scales`` in [0.5, 1.5], AutoAssign's ``center_mean`` in
    [-0.5, 0.5] and ``center_sigma`` in [0.5, 2] strides."""
    import numpy as np

    def redraw(tree):
        rng = np.random.RandomState(seed + 2)
        head = tree['params']['bbox_head']
        for k, lo, hi in (('scales', 0.5, 1.5), ('center_mean', -0.5, 0.5),
                          ('center_sigma', 0.5, 2.0)):
            if k in head:
                head[k] = rng.uniform(lo, hi, head[k].shape).astype(
                    np.float32)
    return redraw


def module_share(torch, det, img, busy_ms, cls, label, head='bbox_head'):
    """The ``cls`` modules of the detector's ``head`` on the inputs one
    bf16 call gives them (recorded by forward pre-hooks), run alone, device
    ms, and their share of the call's device busy ms."""
    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: calls.append((mod, args)))
        for m in getattr(det.model, head).modules() if isinstance(m, cls)]
    try:
        with torch.inference_mode():
            det.model(img)
    finally:
        for h in hooks:
            h.remove()
    with torch.inference_mode():
        ms = cuda_ms(lambda: [mod(*args) for mod, args in calls], warmup=1,
                     runs=3)
    out = {f'{label}_sites': len(calls), f'{label}_ms': ms,
           f'{label}_share': ms / busy_ms if busy_ms else None}
    log(f'{label} sites of the head on one bf16 call\'s inputs: ' +
        json.dumps(out))
    return out


def run_zoo_row_j_dense(torch):
    """Phase 21: FCOS, NAS-FCOS, FoveaBox, AutoAssign, FSAF, FreeAnchor,
    YOLOF and the NAS-FPN RetinaNet, R50 at full width and depth (NAS-FPN
    on NAS_FPN_IMG^2): bf16 inference at batch 8 (e2e, forward, device
    busy, kernels, peak memory; decode and NMS ms; the GroupNorm share of
    AutoAssign and NAS-FCOS, NAS-FCOS's deformable sites), fp32 card
    against CPU on one image of ZOO_FP32_IMG^2 (at least ATSS_MIN_PAIRS
    pairs), 2 bf16 steps of 2 images (peak memory; FSAF's and FreeAnchor's
    gradient clips from their configs, 10 and 35); the test CLI on FCOS,
    ``train_detector`` on FSAF. Returns each path's launches of each kernel
    (all 0: ReLU)."""
    import tempfile

    from tpudet_torch.config import Config
    from tpudet_torch.models.dense_heads import (atss_head, retina_head,
                                                 yolof_head)
    from tpudet_torch.models.plugins import GroupNorm
    from tpudet_torch.ops import mish
    from tpudet_torch.ops.deform_conv import ModulatedDeformConv2d
    from tpudet_torch.utils.checkpoint import save_variables
    log('phase 21 redraws: ' + json.dumps(
        {k: {r: list(v) for r, v in d.items()}
         for k, d in ZOO_J_SPREADS.items()}) + '; scales, center_mean, '
        'center_sigma redrawn (zoo_j_leaves)')
    launches, times = {}, {}
    for key, config, name, seed, nms_module, clip in (
            ('fcos', CONFIG_FCOS, 'FCOS R50-FPN', SEED + 7000, atss_head,
             None),
            ('nasfcos', CONFIG_NASFCOS, 'NAS-FCOS R50', SEED + 7100,
             atss_head, None),
            ('fovea', CONFIG_FOVEA, 'FoveaBox R50-FPN', SEED + 7200,
             atss_head, None),
            ('autoassign', CONFIG_AUTOASSIGN, 'AutoAssign R50-FPN',
             SEED + 7300, atss_head, None),
            ('fsaf', CONFIG_FSAF, 'FSAF R50-FPN', SEED + 7400, atss_head,
             10),
            ('free_anchor', CONFIG_FREE_ANCHOR, 'FreeAnchor R50-FPN',
             SEED + 7500, retina_head, 35),
            ('yolof', CONFIG_YOLOF, 'YOLOF R50-C5', SEED + 7600, yolof_head,
             None),
            ('nas_fpn', CONFIG_NAS_FPN, 'NAS-FPN RetinaNet R50',
             SEED + 7700, retina_head, None)):
        t0 = time.perf_counter()
        cfg = Config.fromfile(config)
        size = NAS_FPN_IMG if key == 'nas_fpn' else FRCNN_IMG
        tree, det, img, infer, t = zoo_inference(
            torch, mish, config, name, seed, size=size,
            extra=ZOO_J_SPREADS[key], leaves=zoo_j_leaves(seed))
        launches[f'{key}_inference_forward'] = infer
        t.update(atss_decode_and_nms_ms(torch, det, img, nms_module))
        if key in ('nasfcos', 'autoassign'):
            t.update(module_share(torch, det, img, t['busy_ms'], GroupNorm,
                                  'groupnorm'))
        if key == 'nasfcos':
            t.update(module_share(torch, det, img, t['busy_ms'],
                                  ModulatedDeformConv2d, 'dcn'))
        log(f'{name} split: ' + json.dumps(
            {k: v for k, v in t.items() if k in (
                'decode_ms', 'nms_ms', 'nms_candidates')}))
        del det, img
        torch.cuda.empty_cache()
        t['fp32_pairs'] = zoo_fp32_check(torch, cfg, tree, name,
                                         ZOO_FP32_IMG, seed + 10,
                                         min_pairs=ATSS_MIN_PAIRS)
        launches[f'{key}_train_step'] = zoo_train_steps(
            torch, mish, config, tree, name,
            zoo_batch_fn(torch, cfg, seed + 20, size=size), grad_clip=clip)
        if key == 'fcos':
            with tempfile.TemporaryDirectory() as tmp:
                ckpt = os.path.join(tmp, 'fcos.msgpack')
                save_variables(ckpt, tree)
                launches['fcos_test_cli_batch'] = run_cli_eval(
                    torch, config, ckpt, img_size=FRCNN_IMG,
                    mish_per_forward=0)
        if key == 'fsaf':
            launches['fsaf_train_detector_step'], _ = zoo_loop_and_cli(
                torch, config, name, seed + 30, cli=False)
        times[key] = t
        del tree
        torch.cuda.empty_cache()
        log(f'phase 21 {key}: {time.perf_counter() - t0:.1f} s')
    deferred_checks_finish()  # the phase's last fp32 checks
    log('phase 21 inference times: ' + json.dumps(times))
    return {k: {path: counts[k] for path, counts in launches.items()}
            for k in ('mish_fwd', 'mish_bwd')}


CONFIG_REPPOINTS = os.path.join(
    ROOT, 'configs/reppoints/reppoints_moment_r50_fpn_1x_coco.py')
CONFIG_SABL_RETINA = os.path.join(
    ROOT, 'configs/sabl/sabl_retinanet_r50_fpn_1x_coco.py')
CONFIG_SABL_FRCNN = os.path.join(
    ROOT, 'configs/sabl/sabl_faster_rcnn_r50_fpn_1x_coco.py')
CONFIG_GA_RETINA = os.path.join(
    ROOT, 'configs/guided_anchoring/ga_retinanet_r50_fpn_1x_coco.py')
CONFIG_GA_FRCNN = os.path.join(
    ROOT, 'configs/guided_anchoring/ga_faster_r50_fpn_1x_coco.py')
J2A_FP32_IMG = 640  # phase 22's fp32 card-vs-CPU image
# phase 22's redraws (module name regex -> (spread, bias)) of the layers
# the earlier phases' table does not name (it names retina_cls,
# retina_reg, rpn_cls, rpn_reg, fc_cls, fc_reg and every conv_offset,
# FeatureAdaption's among them): RepPoints' class logits as RetinaNet's,
# its init points a stride around the grid (tpudet's N(0, 0.01^2) keeps
# the deformable taps on it) and the refinement half that; SABL's bucket
# logits and offsets, the RoI head's per position; Guided Anchoring's
# location logits around -3 (a fifth of the cells under the 0.01 filter)
# and shapes exp(+-0.5) of the square.
ZOO_J2A_SPREADS = {
    'reppoints': {r'bbox_head\.cls_out$': ZOO_J_CLS,
                  r'bbox_head\.pts_init_out$': (1.0, 0.0),
                  r'bbox_head\.refine_out$': (0.5, 0.0)},
    'sabl_retinanet': {r'bbox_head\.retina_bbox_cls$': (2.0, 0.0),
                       r'bbox_head\.retina_bbox_reg$': (0.3, 0.0)},
    'sabl_faster_rcnn': {r'roi_head\.bbox_head\.[xy]_cls$': (2.0, 0.0),
                         r'roi_head\.bbox_head\.[xy]_off$': (0.3, 0.0)},
    'ga_retinanet': {r'bbox_head\.conv_loc$': (2.0, -3.0),
                     r'bbox_head\.conv_shape$': (0.5, 0.0)},
    'ga_faster_rcnn': {r'rpn_head\.conv_loc$': (2.0, -3.0),
                       r'rpn_head\.conv_shape$': (0.5, 0.0)},
}
MOMENT_SPREAD = 0.3  # RepPoints' moment_transfer (0 at tpudet's init)


def zoo_j2a_leaves(seed):
    """RepPoints' ``moment_transfer`` redrawn in [-MOMENT_SPREAD,
    MOMENT_SPREAD]: the learned scale of the moment boxes."""
    import numpy as np

    def redraw(tree):
        head = tree['params'].get('bbox_head', {})
        if 'moment_transfer' in head:
            head['moment_transfer'] = np.random.RandomState(seed + 2).uniform(
                -MOMENT_SPREAD, MOMENT_SPREAD, 2).astype(np.float32)
    return redraw


def proposal_ms(torch, det, img):
    """The RPN head's ``get_proposals`` (``test_cfg.rpn``) on one bf16
    call's pred maps, device ms, and the proposals it keeps an image."""
    from tpudet_torch.models.detectors.two_stage import proposal_kwargs
    model = det.model
    kwargs = proposal_kwargs(dict(model.test_cfg or {}).get('rpn', {}), 1000)
    with torch.inference_mode():
        preds = model.rpn_head(model.extract_feat(img))

        def call():
            return model.rpn_head.get_proposals(
                preds, img_shape=tuple(img.shape[1:3]), **kwargs)
        kept = [int(v) for v in call()[2].sum(1)]
        ms = cuda_ms(call, warmup=1, runs=3)
    out = {'proposals_ms': ms, 'proposals_kept': kept,
           'max_num': kwargs['max_num']}
    log(f'{type(model.rpn_head).__name__} proposals on one bf16 call\'s '
        f'maps: ' + json.dumps(out))
    if max(kept) > kwargs['max_num'] or min(kept) == 0:
        raise AssertionError('the RPN kept no proposal or more than the '
                             'config caps')
    return out


def run_zoo_row_j2a(torch):
    """Phase 22: RepPoints, SABL RetinaNet, SABL Faster R-CNN, GA
    RetinaNet and GA Faster R-CNN, R50 at full width and depth: bf16
    inference at batch 8 on 1344^2 (e2e, forward, device busy, kernels,
    peak memory; decode and NMS ms of the one-stage three, the RPN's
    proposal ms of the two Faster R-CNNs; the deformable convs' share of
    busy for RepPoints and both GA models, RepPoints' GroupNorm share),
    fp32 card against CPU on one image of J2A_FP32_IMG^2 (at least
    ATSS_MIN_PAIRS pairs), 2 bf16 steps of 2 images at 1344^2 (peak
    memory); the test CLI on SABL RetinaNet, ``train_detector`` on GA
    Faster R-CNN. Returns each path's launches of each kernel (all 0:
    ReLU)."""
    import tempfile

    from tpudet_torch.config import Config
    from tpudet_torch.models.dense_heads import (atss_head,
                                                 guided_anchor_head,
                                                 sabl_retina_head)
    from tpudet_torch.models.plugins import GroupNorm
    from tpudet_torch.ops import mish
    from tpudet_torch.ops.deform_conv import DeformConv2d
    from tpudet_torch.utils.checkpoint import save_variables
    log('phase 22 redraws: ' + json.dumps(
        {k: {r: list(v) for r, v in d.items()}
         for k, d in ZOO_J2A_SPREADS.items()}) + f'; conv_offset spread '
        f'{DCN_OFFSET_SPREAD}; moment_transfer in +-{MOMENT_SPREAD}')
    launches, times = {}, {}
    for key, config, name, seed, nms_module, dcn_head in (
            ('reppoints', CONFIG_REPPOINTS, 'RepPoints R50-FPN',
             SEED + 8000, atss_head, 'bbox_head'),
            ('sabl_retinanet', CONFIG_SABL_RETINA, 'SABL RetinaNet R50-FPN',
             SEED + 8100, sabl_retina_head, None),
            ('sabl_faster_rcnn', CONFIG_SABL_FRCNN,
             'SABL Faster R-CNN R50-FPN', SEED + 8200, None, None),
            ('ga_retinanet', CONFIG_GA_RETINA, 'GA RetinaNet R50-FPN',
             SEED + 8300, guided_anchor_head, 'bbox_head'),
            ('ga_faster_rcnn', CONFIG_GA_FRCNN, 'GA Faster R-CNN R50-FPN',
             SEED + 8400, None, 'rpn_head')):
        t0 = time.perf_counter()
        cfg = Config.fromfile(config)
        tree, det, img, infer, t = zoo_inference(
            torch, mish, config, name, seed, extra=ZOO_J2A_SPREADS[key],
            leaves=zoo_j2a_leaves(seed))
        launches[f'{key}_inference_forward'] = infer
        if nms_module is not None:
            t.update(atss_decode_and_nms_ms(torch, det, img, nms_module))
        else:
            t.update(proposal_ms(torch, det, img))
        if dcn_head is not None:
            t.update(module_share(torch, det, img, t['busy_ms'],
                                  DeformConv2d, 'dcn', dcn_head))
        if key == 'reppoints':
            t.update(module_share(torch, det, img, t['busy_ms'], GroupNorm,
                                  'groupnorm'))
        log(f'{name} split: ' + json.dumps(
            {k: v for k, v in t.items() if k.endswith(
                ('decode_ms', 'nms_ms', 'nms_candidates', 'proposals_ms',
                 '_share'))}))
        del det, img
        torch.cuda.empty_cache()
        t['fp32_pairs'] = zoo_fp32_check(torch, cfg, tree, name,
                                         J2A_FP32_IMG, seed + 10,
                                         min_pairs=ATSS_MIN_PAIRS)
        launches[f'{key}_train_step'] = zoo_train_steps(
            torch, mish, config, tree, name,
            zoo_batch_fn(torch, cfg, seed + 20))
        if key == 'sabl_retinanet':
            with tempfile.TemporaryDirectory() as tmp:
                ckpt = os.path.join(tmp, 'sabl_retinanet.msgpack')
                save_variables(ckpt, tree)
                launches['sabl_retinanet_test_cli_batch'] = run_cli_eval(
                    torch, config, ckpt, img_size=FRCNN_IMG,
                    mish_per_forward=0)
        if key == 'ga_faster_rcnn':
            launches['ga_faster_rcnn_train_detector_step'], _ = \
                zoo_loop_and_cli(torch, config, name, seed + 30, cli=False)
        times[key] = t
        del tree
        torch.cuda.empty_cache()
        log(f'phase 22 {key}: {time.perf_counter() - t0:.1f} s')
    deferred_checks_finish()  # the phase's last fp32 checks
    log('phase 22 inference times: ' + json.dumps(times))
    return {k: {path: counts[k] for path, counts in launches.items()}
            for k in ('mish_fwd', 'mish_bwd')}


CONFIG_DOUBLE_HEAD = os.path.join(
    ROOT, 'configs/double_heads/dh_faster_rcnn_r50_fpn_1x_coco.py')
CONFIG_DYNAMIC = os.path.join(
    ROOT, 'configs/dynamic_rcnn/dynamic_rcnn_r50_fpn_1x_coco.py')
CONFIG_GRID = os.path.join(
    ROOT, 'configs/grid_rcnn/grid_rcnn_r50_fpn_gn-head_2x_coco.py')
CONFIG_PISA = os.path.join(
    ROOT, 'configs/pisa/pisa_faster_rcnn_r50_fpn_1x_coco.py')
CONFIG_CRPN = os.path.join(
    ROOT, 'configs/cascade_rpn/crpn_faster_rcnn_r50_caffe_fpn_1x_coco.py')
J2B_FP32_IMG = 640  # phase 23's fp32 card-vs-CPU image
# phase 23's redraws (module name regex -> (spread, bias)) beside the
# table's (rpn_cls, rpn_reg, fc_cls, fc_reg): the Cascade RPN's stage-0
# regression (tpudet's N(0, 0.01^2) leaves the refined anchors, and so the
# deformable taps, on the grid)
ZOO_J2B_SPREADS = {
    'double_head': {},
    'grid': {},
    'cascade_rpn': {r'rpn_head\.stage0\.rpn_reg$': (1.0, 0.0)},
}
# the Grid head's raw transposed-conv kernels redrawn at GRID_DECONV_GAIN /
# sqrt(fan-in) (tpudet's N(0, 0.001^2) leaves every heatmap flat at its
# -log 99 bias, and the votes without a maximum); the bias stays
GRID_DECONV_GAIN = 2.0
# the refined boxes of GRID_REFINE_BOXES detections, card against CPU (fp32,
# TF32 off): at least GRID_REFINE_SHARE of them within GRID_REFINE_ATOL px
# (a heatmap's argmax on a near-tie may pick another cell)
GRID_REFINE_BOXES, GRID_REFINE_ATOL, GRID_REFINE_SHARE = 20, 1e-2, 0.95


def zoo_j2b_leaves(seed):
    """The Grid head's ``deconv{1,2}_kernel`` redrawn (GRID_DECONV_GAIN)."""
    import numpy as np

    def redraw(tree):
        grid = tree['params'].get('roi_head', {}).get('grid_head')
        if grid is None:
            return
        rng = np.random.RandomState(seed + 3)
        for k in ('deconv1_kernel', 'deconv2_kernel'):
            shape = grid[k].shape
            grid[k] = (rng.randn(*shape) * GRID_DECONV_GAIN / math.sqrt(
                np.prod(shape[:-1]))).astype(np.float32)
    return redraw


def grid_refine(model, img, res):
    """``GridRCNN.refine_boxes`` of the first GRID_REFINE_BOXES detections
    an image (boxes where not valid)."""
    k = GRID_REFINE_BOXES
    return model.refine_boxes(img, res.bboxes[:, :k].to(img.device),
                              res.valid[:, :k].to(img.device))


def grid_refine_check(card, cpu):
    """The refined boxes, card against CPU (``grid_refine``)."""
    gap = (card - cpu).abs().amax(-1).flatten()
    share = float((gap <= GRID_REFINE_ATOL).float().mean())
    log(f'Grid R-CNN refine_boxes fp32 card vs CPU on {gap.numel()} boxes: '
        f'largest delta {float(gap.max()):.3e} px, share within '
        f'{GRID_REFINE_ATOL} px {share:.3f} (at least {GRID_REFINE_SHARE})')
    if not (bool(card.isfinite().all()) and share >= GRID_REFINE_SHARE):
        raise AssertionError('Grid R-CNN refined boxes differ card vs CPU')


def refine_boxes_ms(torch, det, img):
    """``GridRCNN.refine_boxes`` on one bf16 call's detections (8 x 100, the
    call's features reused), device ms, and how far it moves them."""
    model = det.model
    with torch.inference_mode():
        feats = model.extract_feat(img)
        res = model.get_bboxes(model.detect(feats, tuple(img.shape[1:3])))

        def call():
            return model.refine_boxes(img, res.bboxes, res.valid,
                                      feats=feats)
        refined = call()
        ms = cuda_ms(call, warmup=1, runs=3)
    moved = (refined - res.bboxes).abs().amax(-1)[res.valid]
    out = {'refine_ms': ms, 'refined_boxes': int(res.valid.sum()),
           'median_move_px': float(moved.float().median())}
    log('Grid R-CNN refine_boxes: ' + json.dumps(out))
    if not (refined.isfinite().all() and out['median_move_px'] > 0):
        raise AssertionError('Grid R-CNN refine_boxes: non-finite or no '
                             'box moved')
    return out


def run_zoo_row_j2b(torch):
    """Phase 23: Double-Head, Grid R-CNN and the Cascade RPN Faster R-CNN,
    R50 at full width and depth: bf16 inference at batch 8 on 1344^2
    (e2e, forward, device busy, kernels, peak memory; the Double head's
    RoI bbox head's share of busy, Grid R-CNN's ``refine_boxes`` ms, the
    Cascade RPN's proposal ms and its deformable convs' share), fp32 card
    against CPU on one image of J2B_FP32_IMG^2 (at least ATSS_MIN_PAIRS
    pairs; Grid R-CNN's refined boxes too), 2 bf16 steps of 2 images at
    1344^2 (peak memory); the test CLI on Grid R-CNN, ``train_detector``
    on the Cascade RPN Faster R-CNN. Dynamic R-CNN and PISA change only
    training (their eval is Faster R-CNN's, bit for bit, a CPU test holds
    it): their 2 bf16 steps each, on one weight draw (their trees are
    Faster R-CNN's), ``dynamic_beta`` and ``loss_carl`` logged. Returns
    each path's launches of each kernel (all 0: ReLU)."""
    import tempfile

    from tpudet_torch.config import Config
    from tpudet_torch.models.roi_heads.double_roi_head import \
        DoubleConvFCBBoxHead
    from tpudet_torch.ops import mish
    from tpudet_torch.ops.deform_conv import DeformConv2d
    from tpudet_torch.utils.checkpoint import save_variables
    log('phase 23 redraws: ' + json.dumps(
        {k: {r: list(v) for r, v in d.items()}
         for k, d in ZOO_J2B_SPREADS.items()}) + f'; the Grid head\'s '
        f'transposed-conv kernels at {GRID_DECONV_GAIN} / sqrt(fan-in)')
    launches, times = {}, {}
    for key, config, name, seed in (
            ('double_head', CONFIG_DOUBLE_HEAD, 'Double-Head R-CNN R50-FPN',
             SEED + 9000),
            ('grid', CONFIG_GRID, 'Grid R-CNN R50-FPN', SEED + 9100),
            ('cascade_rpn', CONFIG_CRPN, 'Cascade RPN Faster R-CNN R50-FPN',
             SEED + 9200)):
        t0 = time.perf_counter()
        cfg = Config.fromfile(config)
        tree, det, img, infer, t = zoo_inference(
            torch, mish, config, name, seed, extra=ZOO_J2B_SPREADS[key],
            leaves=zoo_j2b_leaves(seed))
        launches[f'{key}_inference_forward'] = infer
        if key == 'double_head':
            t.update(module_share(torch, det, img, t['busy_ms'],
                                  DoubleConvFCBBoxHead, 'roi_bbox_head',
                                  'roi_head'))
        elif key == 'grid':
            t.update(refine_boxes_ms(torch, det, img))
        else:
            t.update(proposal_ms(torch, det, img))
            t.update(module_share(torch, det, img, t['busy_ms'],
                                  DeformConv2d, 'dcn', 'rpn_head'))
        log(f'{name} split: ' + json.dumps(
            {k: v for k, v in t.items() if k.endswith(
                ('proposals_ms', 'refine_ms', '_share'))}))
        del det, img
        torch.cuda.empty_cache()
        t['fp32_pairs'] = zoo_fp32_check(
            torch, cfg, tree, name, J2B_FP32_IMG, seed + 10,
            min_pairs=ATSS_MIN_PAIRS,
            extra=(grid_refine, grid_refine_check) if key == 'grid'
            else None)
        launches[f'{key}_train_step'] = zoo_train_steps(
            torch, mish, config, tree, name,
            zoo_batch_fn(torch, cfg, seed + 20))
        if key == 'grid':
            with tempfile.TemporaryDirectory() as tmp:
                ckpt = os.path.join(tmp, 'grid_rcnn.msgpack')
                save_variables(ckpt, tree)
                launches['grid_test_cli_batch'] = run_cli_eval(
                    torch, config, ckpt, img_size=FRCNN_IMG,
                    mish_per_forward=0)
        if key == 'cascade_rpn':
            launches['cascade_rpn_train_detector_step'], _ = \
                zoo_loop_and_cli(torch, config, name, seed + 30, cli=False)
        times[key] = t
        del tree
        torch.cuda.empty_cache()
        log(f'phase 23 {key}: {time.perf_counter() - t0:.1f} s')
    # the training-only heads: one Faster R-CNN weight draw for both
    t0 = time.perf_counter()
    cfg = Config.fromfile(CONFIG_DYNAMIC)
    img_np = retina_images(cfg, ZOO_REDRAW_IMAGES, FRCNN_IMG, SEED + 9300)
    deferred_checks_start()
    tree = zoo_variables(torch, cfg, img_np, SEED + 9300)
    deferred_checks_join()
    for key, config, name, want in (
            ('dynamic', CONFIG_DYNAMIC, 'Dynamic R-CNN R50-FPN',
             'dynamic_beta'),
            ('pisa', CONFIG_PISA, 'PISA Faster R-CNN R50-FPN', 'loss_carl')):
        launches[f'{key}_train_step'] = zoo_train_steps(
            torch, mish, config, tree, name,
            zoo_batch_fn(torch, Config.fromfile(config), SEED + 9320),
            want=want)
    del tree
    torch.cuda.empty_cache()
    log(f'phase 23 dynamic and pisa: {time.perf_counter() - t0:.1f} s')
    deferred_checks_finish()  # the phase's last fp32 checks
    log('phase 23 inference times: ' + json.dumps(times))
    return {k: {path: counts[k] for path, counts in launches.items()}
            for k in ('mish_fwd', 'mish_bwd')}


def main():
    try:
        import torch
        sys.path.insert(0, ROOT)
        from tpudet_torch.ops import build, jpeg, mish
        from tpudet_torch.ops import letterbox as lb
    except ImportError as e:
        print(f'chip_smoke: cannot import the port ({e}); run it from the '
              f'root of a tpudet checkout', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1

    # 1. device
    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(f'nvidia-smi: {smi}')
    log(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}, device count '
        f'{torch.cuda.device_count()}')
    log('JPEG decoders on this machine: ' + json.dumps(jpeg_libraries(build)))

    # 2. build; the CUDA context, its first kernels and the mish op's
    # first dispatch start meanwhile in a thread (seconds of the host's,
    # which phase 3's first check waited for)
    def start_cuda():
        gen = torch.Generator(device='cuda').manual_seed(SEED)
        x = torch.randn(1024, generator=gen, device='cuda')
        (x.double() * 2).sum().item()
        graph_ms(lambda: x * 2, runs=1)  # CUDA graphs' first capture
        mish.mish_cuda(x.cpu())  # the custom op's first dispatch
    cuda_start = threading.Thread(target=start_cuda, name='CUDA start-up')
    cuda_start.start()
    t0 = time.perf_counter()
    secs = build.build(['mish', 'letterbox', 'nvjpeg_shim'])
    log(f'build: {json.dumps(secs)} (wall {time.perf_counter() - t0:.1f} s)')
    kernel_resources(build, ['mish', 'letterbox'])
    cuda_start.join()
    log(f'CUDA context up: {time.perf_counter() - t0:.1f} s after the '
        f'build started')

    # 3. kernels against their plain versions
    worst_fwd, _ = check_mish_kernel(torch, mish)
    worst_bwd, _ = check_mish_bwd_kernel(torch, mish)
    fixtures = load_fixtures()
    timed_letterbox = check_letterbox_kernel(torch, lb, fixtures)

    # 4. inference; its main path once, counts at 0 just before
    t0 = time.perf_counter()
    tree, infer_launches, mish_shapes, _ = run_slice(torch)
    timed_fwd = time_mish_main_path(torch, mish, mish_shapes)
    log(f'inference phases: {time.perf_counter() - t0:.1f} s')

    # 5. evaluation; its flow once with counts at 0 just before
    t0 = time.perf_counter()
    eval_launches = run_eval(torch)
    log(f'evaluation phases: {time.perf_counter() - t0:.1f} s')

    # 6. training; every step with counts at 0 just before
    t0 = time.perf_counter()
    train_launches, grad_sites = run_training(torch, tree)
    check_train_step_cpu(torch, tree)
    timed_bwd = time_mish_bwd_main_path(torch, mish, grad_sites)
    log(f'training phases: {time.perf_counter() - t0:.1f} s')

    # 7. the training loop; every step with counts at 0 just before
    t0 = time.perf_counter()
    loop_launches, _ = run_train_loop(torch, tree)
    log(f'training loop phases: {time.perf_counter() - t0:.1f} s')

    # 8. YOLOv5-l; each path once with counts at 0 just before
    t0 = time.perf_counter()
    v5_infer_launches, v5_train_launches, v5_errs = run_yolov5(torch)
    log(f'YOLOv5-l phases: {time.perf_counter() - t0:.1f} s')

    # 9. RetinaNet-R50-FPN; each path once with counts at 0 just before
    t0 = time.perf_counter()
    retina_launches, retina_times = run_retinanet(torch)
    log(f'RetinaNet phases: {time.perf_counter() - t0:.1f} s')

    # 10. serving; the served run and the file flow each with counts at 0
    # just before
    t0 = time.perf_counter()
    check_nvjpeg_decode(torch, jpeg, fixtures)
    serve_counts, serve_batches, detector = run_serving(torch, tree,
                                                        fixtures)
    serve_launches = {k: v // serve_batches for k, v in serve_counts.items()}
    files_launches = run_files_flow(torch, detector, fixtures)
    del detector
    torch.cuda.empty_cache()
    log(f'serving phases: {time.perf_counter() - t0:.1f} s')

    # 11. the two-stage family; each path once with counts at 0 just
    # before
    t0 = time.perf_counter()
    two_stage_launches = run_two_stage(torch, retina_times)
    log(f'two-stage phases: {time.perf_counter() - t0:.1f} s')

    # 12. Mask R-CNN; each path once with counts at 0 just before
    t0 = time.perf_counter()
    mask_launches, _ = run_mask_rcnn(torch)
    log(f'Mask R-CNN phases: {time.perf_counter() - t0:.1f} s')

    # 13. data-parallel training; each synced step with counts at 0 just
    # before
    t0 = time.perf_counter()
    dist_launches = run_data_parallel(torch, tree)
    log(f'data-parallel phases: {time.perf_counter() - t0:.1f} s')

    # 14. the other datasets, flip TTA, the image demo, the garbage
    # recipe; each path with counts at 0 just before
    t0 = time.perf_counter()
    other_launches = run_other_datasets(torch)
    log(f'other datasets phases: {time.perf_counter() - t0:.1f} s')

    # 15. the exported program; one exported call with counts at 0 just
    # before
    t0 = time.perf_counter()
    export_launches = run_export(torch, tree)
    log(f'exported program phases: {time.perf_counter() - t0:.1f} s')

    # 16. Cascade R-CNN, the GN and GN+WS R-CNNs, YOLOv3; each path with
    # counts at 0 just before
    t0 = time.perf_counter()
    zoo_launches = run_zoo(torch)
    log(f'zoo rows a-c phases: {time.perf_counter() - t0:.1f} s')

    # 17. DCN, GCB, attention, SSD, RegNet; each path with counts at 0 just
    # before
    t0 = time.perf_counter()
    zoo_deg_launches = run_zoo_deg(torch)
    log(f'zoo rows d, e, g phases: {time.perf_counter() - t0:.1f} s')

    # 18. GFL, ATSS, VFNet, LD; each path with counts at 0 just before
    t0 = time.perf_counter()
    zoo_atss_launches = run_zoo_atss(torch)
    log(f'zoo row f, ATSS and VFNet phases: {time.perf_counter() - t0:.1f} s')

    # 19. PAA, Libra R-CNN and RetinaNet, GRoIE, GHM; each path with
    # counts at 0 just before
    t0 = time.perf_counter()
    zoo_h_launches = run_zoo_paa_libra(torch)
    log(f'PAA and zoo row h phases: {time.perf_counter() - t0:.1f} s')

    # 20. MS R-CNN, HTC, SCNet, PointRend, DetectoRS, YOLACT; each path
    # with counts at 0 just before
    t0 = time.perf_counter()
    zoo_i_launches = run_zoo_row_i(torch)
    log(f'zoo row i phases: {time.perf_counter() - t0:.1f} s')

    # 21. FCOS, NAS-FCOS, FoveaBox, AutoAssign, FSAF, FreeAnchor, YOLOF,
    # NAS-FPN; each path with counts at 0 just before
    t0 = time.perf_counter()
    zoo_j_launches = run_zoo_row_j_dense(torch)
    log(f'zoo row j one-stage phases: {time.perf_counter() - t0:.1f} s')

    # 22. RepPoints, SABL RetinaNet and Faster R-CNN, GA RetinaNet and
    # Faster R-CNN; each path with counts at 0 just before
    t0 = time.perf_counter()
    zoo_j2a_launches = run_zoo_row_j2a(torch)
    log(f'zoo row j2a phases: {time.perf_counter() - t0:.1f} s')

    # 23. Double-Head, Grid R-CNN, the Cascade RPN Faster R-CNN; Dynamic
    # R-CNN's and PISA's steps; each path with counts at 0 just before
    t0 = time.perf_counter()
    zoo_j2b_launches = run_zoo_row_j2b(torch)
    log(f'zoo row j2b phases: {time.perf_counter() - t0:.1f} s')

    # 24. output
    def row(name, replaces, worst, timed):
        return dict(
            name=name, route='cuda', source='tpudet_torch/ops/csrc/mish.cu',
            replaces=replaces, launches=train_launches[name],
            launches_by_path={
                'inference_forward': infer_launches.get(name, 0),
                'train_step': train_launches[name],
                'train_detector_step': loop_launches[name],
                'yolov5_inference_forward': v5_infer_launches[name],
                'yolov5_train_step': v5_train_launches[name]},
            max_abs_err=max(worst, timed['max_abs_err'], v5_errs[name]),
            ms=timed['ms'], plain_ms=timed['plain_ms'],
            bound_ms=timed['bound_ms'], bound_by=timed['bound_by'],
            bound_share=timed['bound_ms'] / timed['ms'],
            library_ms=timed['library_ms'])
    kernels = [row('mish_fwd', 'tpudet/ops/mish.py:68', worst_fwd, timed_fwd),
               row('mish_bwd', 'tpudet/ops/mish.py:73', worst_bwd, timed_bwd)]
    kernels.append(dict(
        name='letterbox', route='cuda',
        source='tpudet_torch/ops/csrc/letterbox.cu',
        replaces='tpudet/ops/native/jpeg_loader.cc:76 (resize_bilinear_u8 '
                 'and the letterbox of decode_one, :133-190; a host op, '
                 'no TPU kernel)',
        launches=serve_counts['letterbox'],
        launches_by_path={'serve_batch': serve_launches['letterbox'],
                          'files_eval_batch': files_launches['letterbox']},
        **{k: timed_letterbox[k] for k in (
            'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
            'bound_share', 'library_ms', 'interpolate_ms', 'interpolate')}))
    for k in kernels:
        paths = k['launches_by_path']
        if k['name'] != 'letterbox':
            paths['eval_batch'] = eval_launches[k['name']]
            paths.update(retina_launches[k['name']])
            paths.update(two_stage_launches[k['name']])
            paths.update(mask_launches[k['name']])
            paths.update(dist_launches[k['name']])
            paths.update(other_launches[k['name']])
            paths.update(export_launches[k['name']])
            paths.update(zoo_launches[k['name']])
            paths.update(zoo_deg_launches[k['name']])
            paths.update(zoo_atss_launches[k['name']])
            paths.update(zoo_h_launches[k['name']])
            paths.update(zoo_i_launches[k['name']])
            paths.update(zoo_j_launches[k['name']])
            paths.update(zoo_j2a_launches[k['name']])
            paths.update(zoo_j2b_launches[k['name']])
            paths['serve_batch'] = serve_launches[k['name']]
            paths['files_eval_batch'] = files_launches[k['name']]
    log(f'chip_smoke: {time.perf_counter() - t_start:.1f} s in all, '
        f'{time.perf_counter() - T_IMPORT:.1f} s since its import')
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
