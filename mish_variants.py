#!/usr/bin/env python3
"""Time the mish kernels against variants of their design on one NVIDIA GPU.

    python3 mish_variants.py [--source NAME=DIR ...] [--out FILE]

Each variant is ``tpudet_torch/ops/csrc/mish.cu`` with one design choice
made the other way, by replacing text of the source (``VARIANTS``; a
replacement that no longer finds its text is an error): one or four
16-byte vectors a thread in place of two, an evict-first load of the
forward's input, the other grid for either kernel, and ``__frcp_rn`` in
place of the inline reciprocal. ``--source NAME=DIR`` adds the
``mish.cu`` of another checkout (an unpacked earlier commit) as the
variant NAME; where its backward entry takes no row pitch (PR 2's), a
gradient in another layout than x's is first copied into x's, as that
version's wrapper did. All are built at once, one nvcc each, with the
flags of ``tpudet_torch/ops/build.py``.

Every variant runs the 108 mish sites of YOLOv4-l 640
(``configs/yolov4/yolov4l_coco_mosaic.py``) in bf16, channels_last: the
forward at the inference batch of 8, the backward at the training
micro-batch of 12 with each incoming gradient in the layout a training
step gives it (9 sites read a channel slice of a concat's gradient).
Each is one CUDA graph of 108 launches, timed as in ``chip_smoke.py``
(median of 20 replays), in the order variants, then variants reversed,
so that drift shows; ``F.mish`` / ``aten.mish_backward`` and a one-op
elementwise kernel over the same bytes (``torch.neg`` / ``torch.mul``)
on the same inputs in between. Per variant the registers (``cuobjdump
-res-usage``) and the static SASS of each kernel's main loop
(``cuobjdump -sass``), as ``chip_smoke.py`` reads them, and its largest
difference from the plain versions over all sites.

Prints one JSON object per line and writes them all to ``--out``
(default ``build/mish_variants/mish_variants.json``), the SASS of each
variant beside it.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, 'configs/yolov4/yolov4l_coco_mosaic.py')
SOURCE = os.path.join(ROOT, 'tpudet_torch/ops/csrc/mish.cu')
INFER_BATCH, MICRO_BATCH = 8, 12
# name -> [(text of mish.cu, its replacement), ...]
VARIANTS = {
    'shipped': [],
    'vecs1': [('constexpr int kVecs = 2;', 'constexpr int kVecs = 1;')],
    'vecs4': [('constexpr int kVecs = 2;', 'constexpr int kVecs = 4;')],
    'fwd_evict_first': [('v[k].v = __ldg(xv', 'v[k].v = __ldcs(xv'),
                        ('v.v = __ldg(xv', 'v.v = __ldcs(xv')],
    'fwd_full_grid': [('kFwdFullGrid = false', 'kFwdFullGrid = true')],
    'bwd_one_wave': [('kBwdFullGrid = true', 'kBwdFullGrid = false')],
    'frcp_rn': [('rcp_rn(__fadd_rn(b, 2.0f))',
                 '__frcp_rn(__fadd_rn(b, 2.0f))')],
}


def write_variants(out_dir):
    """``{name: path}`` of each variant's source, written to ``out_dir``."""
    with open(SOURCE) as f:
        text = f.read()
    paths = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise ValueError(f'variant {name}: {old!r} not in {SOURCE}')
            src = src.replace(old, new)
        paths[name] = os.path.join(out_dir, f'mish-{name}.cu')
        with open(paths[name], 'w') as f:
            f.write(src)
    return paths


def main_path_sites(torch):
    """The 108 mish sites of YOLOv4-l 640 from one training forward and
    backward of the port's model on the card at batch 2: per site
    ``(shape, x strides, g strides)`` of the gradient its backward kernel
    reads, the batch set to MICRO_BATCH (strides do not depend on it)."""
    from chip_smoke import record_gradient_layouts
    from tpudet_torch.config import Config
    from tpudet_torch.models.builder import build_detector
    model = build_detector(Config.fromfile(CONFIG)['model']).to(
        'cuda', memory_format=torch.channels_last).train()
    sites = []
    hooks = record_gradient_layouts(torch, model, sites)
    sum(p.float().sum() for p in model(
        torch.zeros(2, 640, 640, 3, device='cuda'))).backward()
    for h in hooks:
        h.remove()
    del model
    torch.cuda.empty_cache()
    return [((MICRO_BATCH,) + shape[1:], xs, gs) for shape, xs, gs in sites]


def build_all(sources):
    """``{name: source}`` -> ``{name: library}``, one nvcc each, all
    started together."""
    from tpudet_torch.ops import build
    out_dir = build.BUILD_DIR / 'variants'
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = out_dir / f'libmish-{name}.so'
        cmd = [build._nvcc(), *build.NVCC_FLAGS, '-o', str(lib), src]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc {name} exited {proc.returncode}\n{text}')
        libs[name] = lib
    return libs


def launchers(torch, mish, library, source):
    """One-site calls of a library's two entry points, as the port's
    wrappers make them."""
    import ctypes
    with open(source) as f:
        pitched = 'long long pitch' in f.read()
    lib = ctypes.CDLL(str(library))
    ptr, size = ctypes.c_void_p, ctypes.c_longlong
    fwd, bwd = lib.tpudet_mish_fwd, lib.tpudet_mish_bwd
    fwd.argtypes = [ptr, ptr, size, ctypes.c_int, ptr]
    bwd.argtypes = [ptr, ptr, ptr, size] + [size, size] * pitched + [
        ctypes.c_int, ptr]
    fwd.restype = bwd.restype = ctypes.c_int
    code = {torch.float32: 0, torch.bfloat16: 2}

    def fwd_one(x):
        y = torch.empty_like(x)
        if fwd(x.data_ptr(), y.data_ptr(), x.numel(), code[x.dtype],
               torch.cuda.current_stream().cuda_stream):
            raise RuntimeError(f'{library}: mish forward launch failed')
        return y

    def bwd_one(x, g):
        n = x.numel()
        rows = ()
        if pitched:
            row, pitch = mish._g_rows(x, g)
            rows = (0, 0) if row == n else (row, pitch)
        elif g.stride() != x.stride():
            g = torch.empty_like(x).copy_(g)
        dx = torch.empty_like(x)
        if bwd(x.data_ptr(), g.data_ptr(), dx.data_ptr(), n, *rows,
               code[x.dtype], torch.cuda.current_stream().cuda_stream):
            raise RuntimeError(f'{library}: mish backward launch failed')
        return dx
    return fwd_one, bwd_one


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--source', action='append', default=[],
                        metavar='NAME=DIR', help='root of another checkout '
                        'whose mish.cu is timed as the variant NAME')
    parser.add_argument('--out', default=os.path.join(
        ROOT, 'build', 'mish_variants', 'mish_variants.json'))
    args = parser.parse_args()
    import torch
    sys.path.insert(0, ROOT)
    from chip_smoke import (HBM_BYTES_PER_S, graph_ms, nvidia_smi,
                            res_usage, sass, sass_main_loops)
    from tpudet_torch.ops import build, mish
    if not torch.cuda.is_available():
        print('mish_variants: no CUDA device', file=sys.stderr)
        return 1
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    emit({'device': torch.cuda.get_device_name(0), 'nvidia_smi': nvidia_smi(),
          'torch': torch.__version__, 'cuda': torch.version.cuda})
    out_dir = os.path.dirname(args.out)
    os.makedirs(out_dir, exist_ok=True)
    sources = write_variants(out_dir)
    for spec in args.source:
        name, root = spec.split('=', 1)
        sources[name] = os.path.join(root, 'tpudet_torch/ops/csrc/mish.cu')
    t0 = time.perf_counter()
    libs = build_all(sources)
    emit({'build_s': time.perf_counter() - t0})
    tool = os.path.join(os.path.dirname(build._nvcc()), 'cuobjdump')
    for name, lib in libs.items():
        with open(os.path.join(out_dir, f'mish_{name}.sass'), 'w') as f:
            f.write(sass(tool, lib))
        emit({'variant': name, 'resources': res_usage(tool, lib),
              'sass_main_loop': sass_main_loops(tool, lib)})
    kernels = {name: launchers(torch, mish, lib, sources[name])
               for name, lib in libs.items()}

    sites = main_path_sites(torch)
    cl = torch.channels_last
    gen = torch.Generator(device='cuda').manual_seed(0)

    def draw(shape, stride=None):
        if stride is None:
            return torch.randn(shape, generator=gen, device='cuda').to(
                torch.bfloat16).contiguous(memory_format=cl)
        span = 1 + sum((n - 1) * s for n, s in zip(shape, stride))
        return torch.randn(span, generator=gen, device='cuda').to(
            torch.bfloat16).as_strided(shape, stride)
    xf = [draw((INFER_BATCH,) + shape[1:]) for shape, _, _ in sites]
    xb = [draw(shape, xs) for shape, xs, _ in sites]
    gb = [draw(shape, gs) for shape, _, gs in sites]
    stem = max(range(len(sites)), key=lambda i: xb[i].numel())
    n_f, n_b = sum(x.numel() for x in xf), sum(x.numel() for x in xb)
    emit({'sites': len(sites), 'fwd_elements': n_f, 'bwd_elements': n_b,
          'g_pitched_sites': sum(g.stride() != x.stride()
                                 for x, g in zip(xb, gb)),
          'fwd_bound_ms': 2 * n_f * 2 / HBM_BYTES_PER_S * 1e3,
          'bwd_bound_ms': 3 * n_b * 2 / HBM_BYTES_PER_S * 1e3,
          'stem_shape_fwd': list(xf[stem].shape),
          'stem_fwd_bound_ms': 2 * xf[stem].numel() * 2 / HBM_BYTES_PER_S
          * 1e3,
          'stem_bwd_bound_ms': 3 * xb[stem].numel() * 2 / HBM_BYTES_PER_S
          * 1e3})
    stem32 = (xf[stem].float(), xb[stem].float(),
              gb[stem].float().contiguous(memory_format=cl))

    def timed(fwd_one, bwd_one):
        """Over all sites, and over the largest (the stem) alone, in bf16
        and in fp32."""
        return {'fwd_ms': graph_ms(lambda: [fwd_one(x) for x in xf]),
                'bwd_ms': graph_ms(lambda: [bwd_one(x, g)
                                            for x, g in zip(xb, gb)]),
                'stem_fwd_ms': graph_ms(lambda: fwd_one(xf[stem])),
                'stem_bwd_ms': graph_ms(lambda: bwd_one(xb[stem], gb[stem])),
                'stem_fwd_fp32_ms': graph_ms(lambda: fwd_one(stem32[0])),
                'stem_bwd_fp32_ms': graph_ms(
                    lambda: bwd_one(stem32[1], stem32[2]))}

    for name, (fwd_one, bwd_one) in kernels.items():
        err = 0.0
        for x, g in zip(xb, gb):
            err = max(err, float((fwd_one(x).float() - mish.mish_reference(
                x).float()).abs().max()), float((bwd_one(x, g).float() - mish
                .mish_backward_reference(x, g).float()).abs().max()))
        emit({'variant': name, 'max_abs_diff_to_plain': err})

    yardsticks = {
        'library': (torch.nn.functional.mish,
                    lambda x, g: torch.ops.aten.mish_backward(g, x)),
        'one_op_floor': (torch.neg, torch.mul)}
    order = list(kernels) + list(reversed(kernels))
    for turn, name in enumerate(order):
        emit({'turn': turn, 'variant': name, **timed(*kernels[name])})
        if turn in (len(kernels) - 1, len(order) - 1):
            for yard, fns in yardsticks.items():
                emit({'turn': turn, 'variant': yard, **timed(*fns)})
    with open(args.out, 'w') as f:
        for row in rows:
            f.write(json.dumps(row) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
