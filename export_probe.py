#!/usr/bin/env python3
"""Probe, on one NVIDIA GPU, two costs around the exported inference
program, at ``chip_smoke.py`` phase 15's shapes (YOLOv4-l 640, bf16,
batch 8, phase 4's weights from the numpy seed):

1. the eager lane NMS (``batched_class_lane_nms``) of this tree against
   the ``core/nms.py`` of another commit (``--parent-nms``), in turns, on
   the candidates of one live call: ms, device kernels a call, the
   outputs equal; and the same NMS as an exported program (each block
   walk a ``while_loop``);
2. the exported eval call against the live one in a fresh process: ms in
   turns and where the host time goes (``chip_smoke.host_split``); then
   again with 10 M more tuples on the heap, with the garbage collector on
   and then off; and again after ``PROFILES`` torch.profiler sessions of
   each call, as a whole ``chip_smoke.py`` run holds many before phase
   15 (e); then after one fp32 forward of the same model on the CPU (as
   phase 4 makes), with torch's intra-op threads set to 1, after phase 4
   itself (``chip_smoke.run_slice``), and then with the garbage collector
   off;
3. with ``--after-fork``, in place of 1 and 2: both calls read fresh,
   after a subprocess (``nvidia-smi``), and after
   ``torch.set_num_threads`` of the count already set;
4. with ``--after-phases``, in place of 1 and 2: ``chip_smoke.py``'s
   whole run in this process, with a reading of both calls (ms, and the
   exported call's ``host_split``) before it and after each phase, to
   find the phase after which the exported call's host time grows
   (``--stop-after`` ends the run after one of them, lists the ops of
   each call that touch a CPU tensor, and reads both calls once more with
   torch's intra-op threads set to 1 and once with them set back).

    git show HEAD~1:tpudet_torch/core/nms.py > build/parent_nms.py
    python3 export_probe.py --parent-nms build/parent_nms.py
    python3 export_probe.py --after-fork
    python3 export_probe.py --after-phases [--stop-after run_slice]

Prints a line for each reading, the card's name and power limit, and one
JSON object of every number last.
"""
import argparse
import gc
import importlib.util
import json
import os
import sys
import tempfile

import chip_smoke as cs

HEAP_OBJECTS = 10_000_000
PROFILES = 5


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def nms_readings(torch, nms, call, parent):
    """ms of the lane NMS on one recorded call: this tree's eager walk, the
    parent's (if given) in turns with it, and the exported ``while_loop``
    program; each one's device kernels a call."""
    args, kwargs, want = call
    fns = {'change': nms.batched_class_lane_nms}
    if parent is not None:
        fns['parent'] = parent.batched_class_lane_nms
    calls = {who: (lambda f=f: f(*args, **kwargs)) for who, f in fns.items()}
    program, cands = cs.export_lane_nms(torch, nms, call)
    calls['while_loop'] = lambda: program(*cands)
    order = (['parent', 'change', 'change', 'parent'] * 2 if parent
             else ['change', 'change'])
    times = {who: [] for who in calls}
    with torch.inference_mode():
        for who, fn in calls.items():
            if not all(torch.equal(a, b) for a, b in zip(fn(), want)):
                raise AssertionError(f'the {who} lane NMS differs from the '
                                     f'live call\'s')
        for who in order + ['while_loop', 'while_loop']:
            times[who].append(cs.cuda_ms(calls[who], runs=20))
        kernels = {who: sum(cs.kernel_launches_by_name(torch, fn).values())
                   for who, fn in calls.items()}
    return dict(ms=times, kernels=kernels, scores_shape=list(args[1].shape))


def call_readings(torch, calls):
    """The live and the exported call in turns (ms), and ``host_split`` of
    each."""
    walls = {who: [] for who in calls}
    with torch.inference_mode():
        for who in ('live', 'exported', 'exported', 'live'):
            walls[who].append(cs.cuda_ms(calls[who], runs=10))
    return dict(e2e_ms=walls, host={who: cs.host_split(torch, fn)
                                    for who, fn in calls.items()})


# chip_smoke.py's phase functions, in the order its main calls them
PHASES = ('jpeg_libraries', 'build', 'kernel_resources',
          'check_mish_kernel', 'check_mish_bwd_kernel',
          'check_letterbox_kernel', 'run_slice', 'time_mish_main_path',
          'run_eval', 'run_training', 'run_train_loop',
          'run_yolov5', 'run_retinanet', 'run_serving', 'run_files_flow',
          'run_two_stage', 'run_mask_rcnn', 'run_data_parallel',
          'run_other_datasets', 'run_export')


class _Stop(Exception):
    pass


def after_phases(torch, calls, stop_after=None):
    """Run ``chip_smoke.main`` with a reading of ``calls`` after each of
    ``PHASES`` (the mish counters kept as the phase left them, so that its
    launch checks hold), up to the first reading after ``stop_after`` if
    given. Returns (main's exit code, or 0 if stopped; readings)."""
    from tpudet_torch.ops import build, mish
    counters = ((mish.mish_fwd, 'launches'), (mish.mish_bwd, 'launches'),
                (mish.mish_bwd, 'g_pitched'), (mish.mish_bwd, 'g_copies'))
    readings = []

    def reading(after):
        saved = [getattr(o, a) for o, a in counters]
        with torch.inference_mode():
            e2e = {who: cs.cuda_ms(fn, runs=10) for who, fn in calls.items()}
        host = cs.host_split(torch, calls['exported'])
        for (o, a), v in zip(counters, saved):
            setattr(o, a, v)
        readings.append(dict(after=after, e2e_ms=e2e, exported_host=host))
        cs.log(f'reading after {after}: ' + json.dumps(readings[-1]))

    def wrap(name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            reading(name)
            if name == stop_after:
                raise _Stop
            return out
        return wrapped

    reading('start')
    for name in PHASES:
        owner = build if name == 'build' else cs  # main calls build.build
        setattr(owner, name, wrap(name, getattr(owner, name)))
    try:
        return cs.main(), readings
    except _Stop:
        pass
    readings[-1]['cpu_ops'] = {who: cs.cpu_ops(torch, fn)
                               for who, fn in calls.items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    reading('one intra-op thread')
    torch.set_num_threads(threads)
    reading(f'{threads} intra-op threads again')
    return 0, readings


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--parent-nms', default=None,
                   help="another commit's tpudet_torch/core/nms.py")
    p.add_argument('--after-fork', action='store_true',
                   help='read both calls fresh, after a subprocess and '
                        'after torch.set_num_threads')
    p.add_argument('--after-phases', action='store_true',
                   help="read both calls after each of chip_smoke.py's "
                        'phases')
    p.add_argument('--stop-after', default=None, choices=PHASES,
                   help='with --after-phases, end after this phase')
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('export_probe: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, cs.ROOT)
    from tpudet_torch.apis import init_detector
    from tpudet_torch.config import Config
    from tpudet_torch.core import nms
    from tpudet_torch.models.dense_heads import yolocsp_head
    from tpudet_torch.tools import export_program as ex

    smi = cs.nvidia_smi()
    cfg = Config.fromfile(cs.CONFIG)
    img_np = cs.images(cs.BATCH, cs.SEED + 1)
    tree = cs.make_variables(torch, cfg, img_np)
    det = init_detector(cfg, variables=tree, device='cuda',
                        dtype=torch.bfloat16)
    img = torch.from_numpy(img_np).cuda()
    sf = torch.ones(cs.BATCH, 4, device='cuda')
    hw = torch.full((cs.BATCH, 2), float(cs.IMG), device='cuda')
    out = {}

    if not (args.after_phases or args.after_fork):
        with cs.recording(yolocsp_head, 'batched_class_lane_nms') as lanes:
            det(img, sf)
        parent = (load_module(args.parent_nms, 'parent_nms')
                  if args.parent_nms else None)
        out['lane_nms'] = nms_readings(torch, nms, lanes[0], parent)
        cs.log('lane NMS: ' + json.dumps(out['lane_nms']))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'yolov4l_bf16.pt2')
        ex.export_eval_artifact(det, path, batch=cs.BATCH, img_size=cs.IMG)
        program = torch.export.load(path).module()

    def exported():
        with torch.inference_mode():
            return program(img, sf, hw)

    calls = {'live': lambda: det(img, sf), 'exported': exported}
    if args.after_phases:
        rc, out['after_phases'] = after_phases(torch, calls,
                                               args.stop_after)
        print(json.dumps(out), flush=True)
        return rc
    out['fresh'] = call_readings(torch, calls)
    cs.log('fresh process: ' + json.dumps(out['fresh']))
    if args.after_fork:
        for name, step in (
                ('after_subprocess', cs.nvidia_smi),
                ('after_set_num_threads', lambda: torch.set_num_threads(
                    torch.get_num_threads()))):
            step()
            out[name] = call_readings(torch, calls)
            cs.log(f'{name}: ' + json.dumps(out[name]))
        print(smi)
        print(json.dumps(out), flush=True)
        return 0
    heap = [(i,) for i in range(HEAP_OBJECTS)]
    out['heap'] = call_readings(torch, calls)
    cs.log(f'{len(heap)} more objects: ' + json.dumps(out['heap']))
    gc.disable()
    try:
        out['heap_gc_off'] = call_readings(torch, calls)
    finally:
        gc.enable()
    cs.log(f'{len(heap)} more objects, gc off: '
           + json.dumps(out['heap_gc_off']))
    del heap
    for _ in range(PROFILES):
        for who, fn in calls.items():
            cs.profile_device(torch, fn, f'{who} call', top=0)
    out['after_profiles'] = call_readings(torch, calls)
    cs.log(f'after {PROFILES} profiles of each call: '
           + json.dumps(out['after_profiles']))
    on_cpu = init_detector(cfg, variables=tree, device='cpu',
                           dtype=torch.float32)
    on_cpu(torch.from_numpy(img_np[:1]), torch.ones(1, 4))
    del on_cpu
    out['after_cpu_forward'] = call_readings(torch, calls)
    cs.log('after a forward on the CPU: '
           + json.dumps(out['after_cpu_forward']))
    torch.set_num_threads(1)
    out['one_cpu_thread'] = call_readings(torch, calls)
    cs.log('one intra-op thread: ' + json.dumps(out['one_cpu_thread']))
    cs.run_slice(torch)
    out['after_phase_4'] = call_readings(torch, calls)
    cs.log('after phase 4: ' + json.dumps(out['after_phase_4']))
    gc.disable()
    try:
        out['after_phase_4_gc_off'] = call_readings(torch, calls)
    finally:
        gc.enable()
    cs.log('after phase 4, gc off: '
           + json.dumps(out['after_phase_4_gc_off']))
    print(smi)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
