#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: every hand-written kernel of the path, from ``tpudet_torch/ops/
   csrc``, one nvcc per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, in
   fp32, bf16 and fp16, at the largest shape of the main path, at a ragged
   size and on special values, then timed against the plain version and
   the one PyTorch call that computes the same function;
4. the slice: YOLOv4-l 640 (``configs/yolov4/yolov4l_coco_mosaic.py``,
   80 classes) built by the port's Config and builder, weights drawn from
   a numpy seed in tpudet's layout and carried by ``flax_import``; a
   batch of 8 in bf16 through ``init_detector`` / ``Detector``; the launch
   counts of that one run; the card in fp32 against the same model on the
   CPU; bf16 against fp32; forward / decode / NMS / end-to-end times;
5. output: a ``kernels`` JSON line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Times come from CUDA events: warm-up, then the median of the timed runs.
Kernel times (and their plain and library counterparts) replay a CUDA
graph of the launches, so they hold device time only; end-to-end times
include the host.
"""
import json
import os
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

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# mish per element: abs, neg, exp, log1p, max, add, tanh, mul
MISH_OPS_PER_ELEMENT = 8

# fp32: <= 2 ulp; bf16 / fp16: <= 1 ulp of the output type (both the
# kernel and the plain version round once from fp32)
ULP_TOL = {'float32': 2, 'bfloat16': 1, 'float16': 1}
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
MATCH_IOU = 0.99


def log(*args):
    print(*args, flush=True)


def nvidia_smi():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def ulp_error(got, ref, dtype):
    """max |got - ref| in ulps of ``dtype`` at ``ref`` over finite values;
    non-finite values must agree exactly. Returns (ulps, max abs err)."""
    import torch
    fin = torch.isfinite(ref)
    same = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
    if not bool(same[~fin].all()):
        raise AssertionError(f'{dtype}: non-finite outputs disagree')
    g, r = got[fin].double(), ref[fin].double()
    mag = torch.clamp_min(r.abs(), 2.0 ** MIN_EXP[dtype])
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - MANTISSA[dtype])
    diff = (g - r).abs()
    return float((diff / ulp).max()), float(diff.max())


def special_values(n, dtype, device):
    import torch
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(n, generator=gen, device=device) * 4
    sp = torch.tensor([0., -0., 8., -8., 20., -20., 88., -88., 1e4, -1e4,
                       float('inf'), float('-inf')], device=device)
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


def make_variables(torch, cfg, img):
    """tpudet variables for YOLOv4-l from a numpy seed, in three steps:

    - tpudet's init, with every BatchNorm scale at ``BN_SCALE``;
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
            node['scale'] = np.full_like(node['scale'], BN_SCALE)
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


def run_slice(torch):
    from tpudet_torch.apis import init_detector
    from tpudet_torch.config import Config
    from tpudet_torch.core.nms import batched_class_lane_nms
    from tpudet_torch.models.layers import BatchNormAct, ConvModule
    from tpudet_torch.ops import mish

    cfg = Config.fromfile(CONFIG)
    img_np = images(BATCH, SEED + 1)
    t0 = time.perf_counter()
    tree = make_variables(torch, cfg, img_np)
    log(f'weights: numpy seed {SEED}, tpudet layout, '
        f'{time.perf_counter() - t0:.1f} s')
    det = init_detector(cfg, variables=tree, device='cuda',
                        dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in det.model.parameters())
    log(f'YOLOv4-l: {n_params / 1e6:.2f} M parameters, bf16 on '
        f'{torch.cuda.get_device_name(0)}')
    mish_shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: mish_shapes.append(tuple(out.shape)))
        for m in det.model.modules()
        if isinstance(m, (ConvModule, BatchNormAct)) and m.act is not None]
    img = torch.from_numpy(img_np).cuda()

    # the main path, once, with every kernel count at 0 just before
    mish.mish_cuda.launches = 0
    res = det(img)
    torch.cuda.synchronize()
    launches = {'mish_fwd': mish.mish_cuda.launches}
    for h in hooks:
        h.remove()
    log(f'main path launches: {json.dumps(launches)}')
    if not launches['mish_fwd'] == len(mish_shapes) == MISH_PER_FORWARD:
        raise AssertionError(f'mish kernel launched {launches["mish_fwd"]} '
                             f'times in one forward, not {MISH_PER_FORWARD}')
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
    det32 = init_detector(cfg, variables=tree, device='cuda',
                          dtype=torch.float32)
    cpu32 = init_detector(cfg, variables=tree, device='cpu',
                          dtype=torch.float32)
    one = img[:1]
    with torch.inference_mode():
        pm_ref = cpu32.model(one.cpu())
        res_ref = cpu32.model.get_bboxes(pm_ref)
        pm32 = det32.model(one)
        res32 = det32.model.get_bboxes(pm32)
    err32 = pred_map_error(pm32, pm_ref)
    log(f'fp32 card vs CPU pred maps, max|d|/max|ref| per level: {err32} '
        f'(tolerance {FP32_PRED_TOL})')
    if max(err32) > FP32_PRED_TOL:
        raise AssertionError('fp32 card pred maps differ from the CPU')
    matched, n_ref, n_got = match_detections(res_ref, res32, 0, MATCH_IOU)
    log(f'fp32 card vs CPU detections: {matched} matched of {n_ref} / '
        f'{n_got} (label and IoU >= {MATCH_IOU})')
    if not (matched == n_ref == n_got and n_ref > 0):
        raise AssertionError('fp32 card detections differ from the CPU')
    del det32
    torch.cuda.empty_cache()

    # bf16 card (image 0 of the batch run) against the fp32 reference
    with torch.inference_mode():
        pm16 = [p[:1] for p in det.forward(img)]
    err16 = pred_map_error(pm16, pm_ref)
    m16, n_ref16, n_got16 = match_detections(res_ref, res, 0, 0.5)
    log(f'bf16 card vs fp32 CPU pred maps, max|d|/max|ref| per level: '
        f'{err16} (tolerance {BF16_PRED_TOL}); detections matched at IoU '
        f'0.5 and label: {m16} of {n_ref16} / {n_got16}')
    if max(err16) > BF16_PRED_TOL:
        raise AssertionError('bf16 pred maps too far from fp32')

    # times per batch of 8, bf16; everything warmed up first
    model = det.model
    cfg_t = dict(model.test_cfg)
    with torch.inference_mode():
        for _ in range(5):
            det(img)
        pm = model(img)
        bbox, scores = model.get_bboxes(pm, with_nms=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = {
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
    log(f'bf16 batch {BATCH} x {IMG}^2: ' + json.dumps(times))
    profile_e2e(torch, det, img)
    return launches, mish_shapes


def profile_e2e(torch, det, img, calls=3):
    """torch.profiler over ``calls`` end-to-end calls: the device's busy
    share of the wall time and the kernels that take it, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                det(img)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log('profile: the profiler recorded no device activity; device busy '
            'share not measured')
        return
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    busy_ms = busy / 1e3 / calls
    log(f'profile per e2e call: wall {wall_ms:.3f} ms, device busy '
        f'{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %), '
        f'{len(kernels) // calls} kernels')
    for name, (ms, n) in top:
        log(f'  {ms:8.3f} ms  {n // calls:4d}x  {name[:100]}')


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
    errs = [float((mish.mish_cuda(x).float() - mish.mish_reference(x)
                   .float()).abs().max()) for x in xs]

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

    # 3. kernel against its plain version
    worst, _ = check_mish_kernel(torch, mish)

    # 4. the slice
    launches, mish_shapes = run_slice(torch)
    timed = time_mish_main_path(torch, mish, mish_shapes)

    # 5. output
    kernels = [dict(
        name='mish_fwd', route='cuda',
        source='tpudet_torch/ops/csrc/mish.cu',
        replaces='tpudet/ops/mish.py:68',
        launches=launches['mish_fwd'],
        max_abs_err=max(worst, timed['max_abs_err']),
        ms=timed['ms'], plain_ms=timed['plain_ms'],
        bound_ms=timed['bound_ms'], bound_by=timed['bound_by'],
        library_ms=timed['library_ms'])]
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
