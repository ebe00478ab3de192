"""Train a detector from a config file with the port: counterpart of
``tools/train.py``.

    python -m tpudet_torch.tools.train CONFIG [--work-dir DIR]
        [--max-steps N] [--no-resume] [--seed S]
        [--cfg-options key=value ...] [--device cuda|cpu]
        [--coordinator HOST:PORT --num-processes N --process-id I
         [--dist-backend nccl|gloo] [--dist-timeout SECONDS]]

The device is ``cuda`` unless ``--device cpu`` asks for the CPU; with no
GPU the default raises.

Multi-process training, as tpudet's: start the same command once per
process, each with its ``--process-id`` (``tools/dist_train.sh`` passes
the flags in this order: run it with ``python -m
tpudet_torch.tools.train`` in place of ``tools/train.py``). Process 0
listens at ``--coordinator`` (or give ``file://PATH``). Rank ``r`` trains
on ``cuda:(r % device_count)``, or on the CPU with ``--device cpu``. The
backend defaults to ``nccl`` on the card and ``gloo`` on the CPU;
``--dist-backend gloo`` on the card reduces CUDA tensors through the host
(two ranks may share one card only so).
"""
import argparse
import ast
import os.path as osp


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train a detector')
    p.add_argument('config', help='config file path')
    p.add_argument('--work-dir', help='dir to save logs and checkpoints')
    p.add_argument('--max-steps', type=int, default=None,
                   help='hard cap on optimizer steps')
    p.add_argument('--no-resume', action='store_true',
                   help='do not resume from the latest checkpoint')
    p.add_argument('--seed', type=int, default=None)
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='override config entries, key=value dotted keys')
    p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    add_dist_args(p)
    return p.parse_args(argv)


def add_dist_args(p):
    """tpudet's multi-process flags, and the torch backend and timeout."""
    p.add_argument('--coordinator', default=None,
                   help='HOST:PORT where process 0 listens, or file://PATH')
    p.add_argument('--num-processes', type=int, default=None)
    p.add_argument('--process-id', type=int, default=None)
    p.add_argument('--dist-backend', default=None, choices=['nccl', 'gloo'],
                   help='nccl (the default on the card) or gloo (the '
                        'default on the CPU; on the card through the host)')
    p.add_argument('--dist-timeout', type=float, default=1800.,
                   help='seconds a rank waits for the others')


def cfg_overrides(options):
    """``--cfg-options key=value ...`` as a dict of dotted keys, each value
    a Python literal where it parses as one, else the string."""
    overrides = {}
    for kv in options:
        k, v = kv.split('=', 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        overrides[k] = v
    return overrides


def init_from_args(args):
    """Open the process group the flags ask for; this process's device."""
    import datetime

    from tpudet_torch.parallel import init_distributed
    return init_distributed(
        args.coordinator, args.num_processes, args.process_id,
        backend=args.dist_backend, device=args.device,
        timeout=datetime.timedelta(seconds=args.dist_timeout))


def main(argv=None):
    args = parse_args(argv)

    from tpudet_torch.apis.train import train_detector
    from tpudet_torch.config import Config
    from tpudet_torch.parallel import close_distributed

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(cfg_overrides(args.cfg_options))
    if args.seed is not None:
        cfg['seed'] = args.seed

    work_dir = args.work_dir or osp.join(
        'work_dirs', osp.splitext(osp.basename(args.config))[0])
    device = init_from_args(args)
    try:
        return train_detector(cfg, work_dir, max_steps=args.max_steps,
                              resume=not args.no_resume, device=device)
    finally:
        close_distributed()


if __name__ == '__main__':
    main()
