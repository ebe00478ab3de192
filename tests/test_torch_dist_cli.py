"""The CLIs' multi-process flags on the CPU, the counterpart of
``tests/test_runtime/test_dist_launch.py`` and ``test_sharded_eval.py``:
real OS processes running ``python -m tpudet_torch.tools.train`` and
``python -m tpudet_torch.tools.test`` with ``--coordinator``,
``--num-processes`` and ``--process-id`` (the flags
``tools/dist_train.sh`` passes), ``--device cpu`` and the gloo backend.

Training (the narrow v4s config of ``test_torch_train_loop.py``, 64 px,
2 images a rank, 3 steps): both ranks log the 2-process line and the same
steps with finite losses, their final param checksums are equal, and only
rank 0 writes files besides its log (``ckpts/``, ``latest_ema.msgpack``).
Evaluation of those weights: the 2-process report, printed and written by
rank 0 only, equals the 1-process report exactly.

Each process gets one thread and 120 s, and its group a 60 s timeout.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

from .test_torch_train_loop import cfg_dict, coco, write_cfg  # noqa: F401
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _start(module, args):
    env = dict(os.environ, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1')
    return subprocess.Popen(
        [sys.executable, '-m', module] + args + ['--device', 'cpu',
                                                 '--dist-timeout', '60'],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _wait(procs):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out.decode(errors='replace'))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _dist(rank, coordinator):
    return ['--coordinator', coordinator, '--num-processes', '2',
            '--process-id', str(rank)]


@pytest.fixture(scope='module')
def trained(coco, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp('dist_cli')
    cfg = cfg_dict(*coco)
    cfg['data']['test'] = dict(cfg['data']['val'])
    cfg['runner'] = dict(max_epochs=2)
    cfg_file = write_cfg(tmp / 'cfg.py', cfg)
    coordinator = f'localhost:{_free_port()}'
    procs = [_start('tpudet_torch.tools.train',
                    [cfg_file, '--work-dir', str(tmp / f'work{r}'),
                     '--max-steps', '3', '--no-resume'] +
                    _dist(r, coordinator)) for r in range(2)]
    _wait(procs)
    return tmp, cfg_file


def _log(tmp, rank):
    with open(tmp / f'work{rank}' / 'train.log') as f:
        return f.read().splitlines()


def test_two_ranks_train_to_equal_checksums(trained):
    tmp, _ = trained
    checksums, steps = [], []
    for rank in range(2):
        log = _log(tmp, rank)
        assert any(f'devices 2 global / 1 local, process {rank}/2' in ln
                   and 'global batch 4 x accumulation 1' in ln
                   for ln in log), log[:3]
        loss_lines = [ln for ln in log if ' loss ' in ln]
        assert loss_lines and 'nan' not in loss_lines[-1].lower()
        steps.append([ln.split(' loss ')[0].split(' - ')[-1]
                      for ln in loss_lines])
        checksums.append([ln.split('checksum')[1] for ln in log
                          if 'final param checksum' in ln])
    assert steps[0] == steps[1] and len(steps[0]) == 3
    assert checksums[0] == checksums[1] and len(checksums[0]) == 1
    # every logged loss is the global one, equal on both ranks
    losses = [[ln.split(' loss ')[1].split(' img/s')[0]
               for ln in _log(tmp, r) if ' loss ' in ln] for r in range(2)]
    assert losses[0] == losses[1]


def test_only_rank_zero_writes(trained):
    tmp, _ = trained
    assert (tmp / 'work0' / 'latest_ema.msgpack').exists()
    assert os.listdir(tmp / 'work0' / 'ckpts')
    assert sorted(os.listdir(tmp / 'work1')) == ['train.log']


def test_two_process_evaluation_equals_one_process(trained):
    tmp, cfg_file = trained
    weights = str(tmp / 'work0' / 'latest_ema.msgpack')
    common = [cfg_file, weights, '--img-size', '64', '--batch-size', '2']
    coordinator = f'file://{tmp / "rendezvous_test"}'
    procs = [_start('tpudet_torch.tools.test',
                    common + ['--out', str(tmp / f'report{r}.json')] +
                    _dist(r, coordinator)) for r in range(2)]
    procs.append(_start('tpudet_torch.tools.test',
                        common + ['--out', str(tmp / 'report_one.json')]))
    outs = _wait(procs)
    with open(tmp / 'report0.json') as f:
        two = json.load(f)
    with open(tmp / 'report_one.json') as f:
        one = json.load(f)
    # equal, NaN (no gt of a size) where NaN
    assert json.dumps(two, sort_keys=True) == json.dumps(one, sort_keys=True)
    assert 'map' in one
    assert not (tmp / 'report1.json').exists()
    assert '"map"' in outs[0] and '"map"' not in outs[1]


@pytest.mark.parametrize('count', [2, 3])
def test_explicit_shards_merge_to_the_full_results(trained, count):
    """``single_device_test`` with an explicit ``process_index`` /
    ``process_count`` and no group returns its shard's sparse list, as
    tpudet's does; the shards cover the set (3 shards of 4 images pad the
    last with a repeat) and ``merge_sharded_results`` gives the one-process
    results."""
    import numpy as np
    import torch

    from tpudet_torch.apis import init_detector, single_device_test
    from tpudet_torch.apis.test import merge_sharded_results
    from tpudet_torch.data import build_dataset
    tmp, cfg_file = trained
    det = init_detector(cfg_file, str(tmp / 'work0' / 'latest_ema.msgpack'),
                        device='cpu', dtype=torch.float32)
    ds = build_dataset({**det.cfg['data']['test'], 'test_mode': True},
                       dict(device='cpu'))
    kw = dict(batch_size=2, img_size=64, progress=False)
    full = single_device_test(det.model, ds, **kw)
    shards = [single_device_test(det.model, ds, process_index=i,
                                 process_count=count, **kw)
              for i in range(count)]
    assert set().union(*({i for i, _ in s} for s in shards)) == \
        set(range(len(ds)))
    merged = merge_sharded_results(shards, len(ds))
    for got, ref in zip(merged, full):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def test_the_train_cli_takes_dist_train_sh_flags_in_their_order():
    """``tools/dist_train.sh CONFIG NPROC PROC_ID COORD ARGS...`` passes
    ``--num-processes``, ``--process-id``, ``--coordinator``, then the
    rest: the port's train CLI parses that line as tpudet's does."""
    from tpudet_torch.tools import train as train_cli
    args = train_cli.parse_args([
        'cfg.py', '--num-processes', '2', '--process-id', '1',
        '--coordinator', 'host:29500', '--work-dir', 'w', '--max-steps',
        '3'])
    assert (args.config, args.num_processes, args.process_id,
            args.coordinator, args.work_dir, args.max_steps) == (
                'cfg.py', 2, 1, 'host:29500', 'w', 3)
    assert args.dist_backend is None and args.device == 'cuda'
