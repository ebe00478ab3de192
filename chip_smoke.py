#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: every hand-written kernel of the paths, from ``tpudet_torch/ops/
   csrc``, one nvcc per source, all started together; the registers of
   each kernel (``cuobjdump -res-usage``) and the SASS instructions of its
   main loop per element (``cuobjdump -sass``);
3. kernels: each kernel (mish forward and backward) against its plain
   PyTorch version on the card, in fp32, bf16 and fp16, at the largest
   shape of its path, at a ragged size and on special values, then timed
   against the plain version and the one PyTorch call that computes the
   same function;
4. inference: YOLOv4-l 640 (``configs/yolov4/yolov4l_coco_mosaic.py``,
   80 classes) built by the port's Config and builder, weights drawn from
   a numpy seed in tpudet's layout and carried by ``flax_import``; a
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
   one fp32 step (micro-batch 2, accumulation 2, TF32 off) on the card
   against the same code on the CPU;
7. the training loop: ``train_detector`` on both train configs, bf16,
   72 images per step, data served from seeded arrays (a dataset subclass
   and an image-loading transform registered by this script; the card's
   machine has no image decoder): the host chain
   (``yolov4l_coco_mosaic.py``: Mosaic, affine chain, HSV, filter on the
   card through ``DetDataLoader``) for 3 steps across an epoch boundary,
   with a checkpoint and the EMA evaluation every epoch; a second call
   that resumes from the checkpoint (its state must equal the saved one)
   for a profiled 4th step; the device-aug config
   (``MosaicTileLoader``, ``device_mosaic_affine`` inside the step) for 2
   steps. Every step: 648 launches of each mish kernel, finite losses,
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
   2 images; the Focus stem's time); the test CLI
   (``tpudet_torch.tools.test.main``) over 16 seeded images served from
   arrays, its report against ``single_device_test`` +
   ``coco_fast_bbox_eval`` of the same weights; training as in phase 6
   (594 launches of each kernel per step, no copy of ``g``);
9. output: a ``kernels`` JSON line (with each kernel's share of its
   bound), the nvidia-smi line, and last ``{"ok": true, "device":
   {...}}``.

Times come from CUDA events: warm-up, then the median of the timed runs.
Kernel times (and their plain and library counterparts) replay a CUDA
graph of the launches, so they hold device time only; end-to-end and step
times include the host.
"""
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, 'configs/yolov4/yolov4l_coco_mosaic.py')
SEED = 0
BATCH = 8
IMG = 640
MISH_PER_FORWARD = 108  # BN sites of YOLOv4-l, each followed by mish
# phase 8: YOLOv5-l, its weights read back by path from a msgpack whose
# meta names these classes; the fp32 card-vs-CPU check on 2 images; the
# test CLI over 16 seeded images, its report equal to the API's within
# REPORT_ATOL and its detection file's records within DET_ATOL (the same
# fp32 computation on the same card, so 0 is expected). The set's seed
# (SEED + 627) is one whose gts fall in all three scale buckets, so every
# value of the report is defined.
CONFIG_V5 = os.path.join(ROOT, 'configs/yolov5/yolov5l_coco_mosaic.py')
MISH_PER_FORWARD_V5 = 99  # BN sites of YOLOv5-l, each followed by mish
CHECKPOINT_CLASSES = ['rect', 'circle', 'triangle']
V5_FP32_IMAGES = 2
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
# the fp32 card-vs-CPU step: micro-batch 2, accumulation 2
CHECK_MICRO, CHECK_ACCUM = 2, 2

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
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
EVAL_TIMED_RUNS = 3
# the test pipeline on the card against the CPU: the same integer ops, so
# 0 expected; at most 1 uint8 level after Normalize
PIPELINE_TOL = 1 / 255
# the training loop (train_detector): 144 training images and 16 val images
# in EVAL_SIZES, 2 steps of 72 per epoch; the host chain runs 3 steps (so
# it crosses an epoch boundary), then resumes for a 4th; the device-aug
# config runs 2
LOOP_TRAIN_IMAGES = 144
LOOP_VAL_IMAGES = 16
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


def log(*args):
    print(*args, flush=True)


def nvidia_smi():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# 16-byte vector of each element type, in elements
PER_VECTOR = {'BF16': 8, 'F16': 8, 'F32': 4}


def _kernel_name(mangled):
    """``mish_fwd_kernel<BF16>`` and the like, from a mangled name."""
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


def cuda_ms(fn, warmup=3, runs=20):
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
        for shape in ((BATCH, 32, IMG, IMG), (1000003,)):
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
    """tpudet variables for a YOLO config from a numpy seed, in three
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
    model = build_detector(cfg['model'])
    tree = random_flax_variables(model, seed=SEED)
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


def match_detections(ref, got, image, iou_min):
    """Greedy one-to-one matching of ``got``'s valid detections to
    ``ref``'s on one image: same label, IoU >= iou_min. Returns (matched,
    n_ref, n_got)."""
    import numpy as np
    rv = ref.valid[image].cpu().numpy()
    gv = got.valid[image].cpu().numpy()
    rb = ref.bboxes[image].float().cpu().numpy()[rv]
    gb = got.bboxes[image].float().cpu().numpy()[gv]
    rl = ref.labels[image].cpu().numpy()[rv]
    gl = got.labels[image].cpu().numpy()[gv]
    if len(rb) == 0 or len(gb) == 0:
        return 0, len(rb), len(gb)
    ok = (_iou(rb, gb) >= iou_min) & (rl[:, None] == gl[None, :])
    used = np.zeros(len(gb), bool)
    matched = 0
    for r in range(len(rb)):
        cand = np.nonzero(ok[r] & ~used)[0]
        if len(cand):
            used[cand[0]] = True
            matched += 1
    return matched, len(rb), len(gb)


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
    log(f'weights: numpy seed {SEED}, tpudet layout, '
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
        matched, n_ref, n_got = match_detections(res_ref, res32, i,
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
    m16, n_ref16, n_got16 = match_detections(res_ref, res, 0, 0.5)
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
            'stem_ms': cuda_ms(lambda: stem(stem_in), runs=10),
            'e2e_ms': cuda_ms(lambda: det(img), runs=10),
            'forward_ms': cuda_ms(lambda: model(img), runs=10),
            'decode_ms': cuda_ms(
                lambda: model.get_bboxes(pm, with_nms=False), runs=10),
            'nms_ms': cuda_ms(lambda: batched_class_lane_nms(
                bbox, scores, cfg_t['score_thr'],
                cfg_t['nms']['iou_threshold'], cfg_t['max_per_img'],
                lane_pre=cfg_t['lane_pre'], class_pre=cfg_t['class_pre']),
                runs=10),
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


def profile_device(torch, fn, label, calls=3, top=15):
    """torch.profiler over ``calls`` calls of ``fn``: the device's busy
    share of the wall time and the kernels that take it, by name. Returns
    (wall ms, device busy ms) per call, or None without device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f'profile {label}: the profiler recorded no device activity; '
            f'device busy share not measured')
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float('-inf')
    for a, b in spans:  # union of kernel intervals, us
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        t = by_name.setdefault(e.name, [0.0, 0])
        t[0] += (e.time_range.end - e.time_range.start) / 1e3 / calls
        t[1] += 1
    busy_ms = busy / 1e3 / calls
    log(f'profile per {label}: wall {wall_ms:.3f} ms, device busy '
        f'{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %), '
        f'{len(kernels) // calls} kernels')
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        log(f'  {ms:8.3f} ms  {n // calls:5d}x  {name[:100]}')
    return wall_ms, busy_ms


def eval_set(seed, n=EVAL_IMAGES):
    """A set of ``n`` images from a numpy seed: (h, w, 3) BGR uint8 images
    of textured filled rectangles on a noise floor, and a COCO dict whose
    gts are the rectangles (categories 1-80 named as the config's classes,
    category 91 outside them). Image 0 holds a crowd gt, image 1 a gt of
    category 91."""
    import numpy as np
    from tpudet_torch.data import COCO_CLASSES
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
            cat = 91 if (i, j) == (1, 0) else int(rng.randint(1, 81))
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=cat, bbox=[x, y, bw, bh],
                             area=float(bw * bh),
                             iscrowd=int((i, j) == (0, 0))))
        arrays[i + 1] = img
        images.append(dict(id=i + 1, file_name=f'{i:04d}.jpg', width=w,
                           height=h))
    cats = [dict(id=k + 1, name=n) for k, n in enumerate(COCO_CLASSES)]
    cats.append(dict(id=91, name='unicorn'))
    return arrays, dict(images=images, annotations=anns, categories=cats)


def array_dataset(cfg, arrays, coco, device, tmp):
    """The port's ``CocoDataset`` over images held in memory: each array
    goes into ``results['img']`` and the config's test pipeline runs from
    its second transform on, as ``inference_detector`` does for an
    array."""
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
                            test_mode=True, device=device)


def match_per_class(ref, got, iou_min):
    """Greedy one-to-one matching of two images' per-class (n, 5) arrays
    within each class: IoU >= iou_min or, for a reference box under 1 px
    wide or high, corners within MATCH_CORNER_PX. Returns (matched, n_ref,
    n_got, matched by corners)."""
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
    """The first batch through ``single_device_test`` in fp32 on the card
    (TF32 off) and on the CPU: detections one-to-one per image and class
    at IoU >= MATCH_IOU."""
    from tpudet_torch.apis import init_detector, single_device_test
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    first = dict(coco, images=coco['images'][:BATCH])
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
                                        for a in host], runs=10),
            'copy_bytes': sum(a.nbytes for a in host),
            'forward_ms': cuda_ms(lambda: model(img), runs=10),
            'decode_ms': cuda_ms(lambda: model.get_bboxes(
                pm, scale_factors=sf, with_nms=False), runs=10),
            'nms_ms': cuda_ms(lambda: batched_class_lane_nms(
                bbox, scores, cfg_t['score_thr'],
                cfg_t['nms']['iou_threshold'], cfg_t['max_per_img'],
                lane_pre=cfg_t['lane_pre'], class_pre=cfg_t['class_pre']),
                runs=10),
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


def train_batch(n, seed):
    """A training batch from a numpy seed: ``n`` images of random pixels,
    normalized as the train pipeline does, and 1-20 gts per image padded
    to MAX_GTS. Each gt takes the shape of one of the 9 anchors (level and
    anchor drawn uniformly) scaled by e^U(-0.7, 0.7) per side, so targets
    land on all three levels; labels 0-79."""
    import numpy as np
    from tpudet_torch.models.dense_heads.yolocsp_head import \
        DEFAULT_BASE_SIZES
    rng = np.random.RandomState(seed)
    px = rng.randint(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)
    img = (px.astype(np.float32) - 114.0) / 255.0
    anchors = np.asarray(DEFAULT_BASE_SIZES, np.float32).reshape(-1, 2)
    boxes = np.zeros((n, MAX_GTS, 4), np.float32)
    valid = np.zeros((n, MAX_GTS), bool)
    for i in range(n):
        k = rng.randint(1, 21)
        wh = anchors[rng.randint(0, len(anchors), k)] * np.exp(
            rng.uniform(-0.7, 0.7, (k, 2)))
        wh = np.minimum(wh, IMG - 2.0)
        c = rng.uniform(wh / 2, IMG - wh / 2)
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


def check_train_step_cpu(torch, tree, config=CONFIG):
    """One fp32 optimizer step (micro-batch 2, accumulation 2) of
    ``config`` at 640 through ``init_trainer`` on the card (TF32 off) and
    on the CPU, from the same variables and batch."""
    from tpudet_torch.apis import init_trainer
    from tpudet_torch.config import Config
    from tpudet_torch.utils.flax_import import train_state_to_flax
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.fromfile(config)
    cfg['data'] = dict(cfg['data'], samples_per_gpu=CHECK_MICRO)
    cfg['nominal_batch_size'] = CHECK_MICRO * CHECK_ACCUM
    batch = train_batch(CHECK_MICRO * CHECK_ACCUM, SEED + 200)
    out = {}
    for device in ('cuda', 'cpu'):
        trainer = init_trainer(cfg, variables=tree, device=device,
                               max_steps=1)
        init = train_state_to_flax(trainer.state, trainer.model)
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in trainer.step(batch).items()}
        if device == 'cuda':
            torch.cuda.synchronize()
        log(f'fp32 step on {device}: {time.perf_counter() - t0:.1f} s, '
            + json.dumps(metrics))
        out[device] = (metrics, train_state_to_flax(trainer.state,
                                                    trainer.model))
        del trainer
        torch.cuda.empty_cache()
    (mc, sc), (mr, sr) = out['cuda'], out['cpu']
    rel = abs(mc['loss'] - mr['loss']) / abs(mr['loss'])
    log(f'fp32 step, card vs CPU: loss rel diff {rel:.3e} (tolerance '
        f'{STEP_LOSS_RTOL}), grad_norm {mc["grad_norm"]:.6f} vs '
        f'{mr["grad_norm"]:.6f}')
    if not rel <= STEP_LOSS_RTOL:
        raise AssertionError('fp32 card loss differs from the CPU')
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
        log(f'fp32 step, card vs CPU {name}: max |delta| {diff:.3e}, '
            f'update {upd:.3e} (tolerance {STEP_TREE_TOL} x update)')
        if not (upd > 0 and diff <= STEP_TREE_TOL * upd):
            raise AssertionError(f'fp32 card {name} differ from the CPU')


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


def check_loop_rows(rows, want_steps):
    """Every step launched each mish kernel 648 times, kept its losses
    finite and moved the params and the EMA."""
    want = ACCUMULATION * MISH_PER_FORWARD
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
    """``train_detector`` at full width and depth, bf16, 72 images per
    step: the host chain on ``yolov4l_coco_mosaic.py`` for LOOP_STEPS
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
    images = ACCUMULATION * MICRO_BATCH
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
        if trainer.accumulation != ACCUMULATION or \
                trainer.model.dtype != torch.bfloat16:
            raise AssertionError('not 6 bf16 micro-batches per step')
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


def run_cli_eval(torch, config, path):
    """``tpudet_torch.tools.test.main`` on ``config`` with the weights at
    ``path``, over CLI_IMAGES seeded images served from arrays (a config
    file written here points the test set at them), every kernel count at
    0 just before the call; then ``single_device_test`` and
    ``coco_fast_bbox_eval`` on ``init_detector(config, path)`` in fp32 over
    the same set: the reports agree within REPORT_ATOL, every value
    finite, and the detections the CLI wrote (``--format-out``) match the
    API's (``results2json``) record by record. Returns the launches per
    batch."""
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
        arrays, coco = eval_set(CLI_SET_SEED, CLI_IMAGES)
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
                           '--img-size', str(IMG), '--format-out',
                           os.path.join(tmp, 'cli')])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = {'mish_fwd': mish.mish_cuda.launches,
                    'mish_bwd': mish.mish_backward_cuda.launches}
        log(f'test CLI over {CLI_IMAGES} images in {batches} batches, fp32: '
            f'{cli_s:.2f} s, launches {json.dumps(launches)}')
        if launches != {'mish_fwd': batches * MISH_PER_FORWARD_V5,
                        'mish_bwd': 0}:
            raise AssertionError(f'test CLI launches {launches}, not '
                                 f'{MISH_PER_FORWARD_V5} forward per batch')
        cfg = Config.fromfile(cfg_file)
        det = init_detector(cfg, path, device='cuda', dtype=torch.float32)
        ds = build_dataset({**cfg['data']['test'], 'test_mode': True},
                           dict(device=det.device))
        results = single_device_test(det.model, ds, batch_size=BATCH,
                                     img_size=IMG, progress=False)
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


def main():
    try:
        import torch
        sys.path.insert(0, ROOT)
        from tpudet_torch.ops import build, mish
    except ImportError as e:
        print(f'chip_smoke: cannot import the port ({e}); run it from the '
              f'root of a tpudet checkout', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1

    # 1. device
    smi = nvidia_smi()
    log(f'nvidia-smi: {smi}')
    log(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}, device count '
        f'{torch.cuda.device_count()}')

    # 2. build
    t0 = time.perf_counter()
    secs = build.build(['mish'])
    log(f'build: {json.dumps(secs)} (wall {time.perf_counter() - t0:.1f} s)')
    kernel_resources(build, ['mish'])

    # 3. kernels against their plain versions
    worst_fwd, _ = check_mish_kernel(torch, mish)
    worst_bwd, _ = check_mish_bwd_kernel(torch, mish)

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

    # 9. output
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
    for k in kernels:
        k['launches_by_path']['eval_batch'] = eval_launches[k['name']]
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
