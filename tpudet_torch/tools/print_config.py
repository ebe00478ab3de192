"""Print the fully resolved config: counterpart of
``tools/misc/print_config.py``.

    python -m tpudet_torch.tools.print_config CONFIG
        [--cfg-options key=value ...]

``_base_`` files merged, ``--cfg-options`` applied as ``tools/train.py``
applies them, then ``Config.dump()``: the same text as tpudet's.
"""
import argparse


def main(argv=None):
    """Print the dump; returns it."""
    p = argparse.ArgumentParser(description='Print the resolved config')
    p.add_argument('config')
    p.add_argument('--cfg-options', nargs='+', default=[])
    args = p.parse_args(argv)

    from tpudet_torch.config import Config
    from tpudet_torch.tools.train import cfg_overrides

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(cfg_overrides(args.cfg_options))
    text = cfg.dump()
    print(text)
    return text


if __name__ == '__main__':
    main()
