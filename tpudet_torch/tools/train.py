"""Train a detector from a config file with the port: counterpart of
``tools/train.py``, on one device.

    python -m tpudet_torch.tools.train CONFIG [--work-dir DIR]
        [--max-steps N] [--no-resume] [--seed S]
        [--cfg-options key=value ...] [--device cuda|cpu]

The device is ``cuda`` unless ``--device cpu`` asks for the CPU; with no
GPU the default raises. Multi-process training (tpudet's
``--coordinator``/``--num-processes``/``--process-id``) comes with a later
slice.
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
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from tpudet_torch.apis.train import train_detector
    from tpudet_torch.config import Config

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        overrides = {}
        for kv in args.cfg_options:
            k, v = kv.split('=', 1)
            try:
                v = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                pass
            overrides[k] = v
        cfg.merge_from_dict(overrides)
    if args.seed is not None:
        cfg['seed'] = args.seed

    work_dir = args.work_dir or osp.join(
        'work_dirs', osp.splitext(osp.basename(args.config))[0])
    return train_detector(cfg, work_dir, max_steps=args.max_steps,
                          resume=not args.no_resume, device=args.device)


if __name__ == '__main__':
    main()
