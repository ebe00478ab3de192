"""Publish a checkpoint: counterpart of
``tools/model_converters/publish_model.py``.

    python -m tpudet_torch.tools.publish_model IN OUT.msgpack [--raw]

Strips a checkpoint down to the inference weights and stamps the file
name with the first 8 hex digits of its sha256: ``OUT-<sha8>.msgpack``.
IN is either

- a ``*.msgpack`` weights file (tpudet's or the port's): re-published
  with ``published_from`` added to its meta;
- the port's train state: a ``ckpts`` directory that ``train_detector``
  writes (its latest ``<step>/train_state.msgpack``) or one ``<step>``
  directory in it. The EMA params and batch stats are published (the
  weights evaluation uses), or with ``--raw`` the online ones; the meta
  holds ``published_from`` and ``ema``, as tpudet's orbax branch.

The output loads in tpudet's and the port's ``load_variables``. tpudet's
orbax train-state directories are not read (ROADMAP.md's item "reading
tpudet's orbax train-state directories").
"""
import argparse
import hashlib
import os
import os.path as osp

ORBAX_ITEM = ("tpudet's orbax train-state directories are not read: "
              "ROADMAP.md's item \"reading tpudet's orbax train-state "
              'directories"')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Publish a model checkpoint')
    p.add_argument('in_file', help="msgpack weights OR the port's ckpts dir")
    p.add_argument('out_file', help='output msgpack path (hash appended)')
    p.add_argument('--use-ema', action='store_true', default=True,
                   help='publish EMA weights from a train state (default)')
    p.add_argument('--raw', dest='use_ema', action='store_false',
                   help='publish the online (non-EMA) weights')
    return p.parse_args(argv)


def train_state_file(path: str) -> str:
    """The port's train-state file in ``path``: ``path/train_state.msgpack``
    or the latest ``path/<step>/train_state.msgpack``. Exits on anything
    else (an orbax directory of tpudet's among them)."""
    from tpudet_torch.utils.checkpoint import STATE_FILE, latest_step
    if osp.isfile(osp.join(path, STATE_FILE)):
        return osp.join(path, STATE_FILE)
    step = latest_step(path)
    if step is None:
        raise SystemExit(f'{path} holds no train state of the port '
                         f'(<step>/{STATE_FILE}); {ORBAX_ITEM}')
    return osp.join(path, str(step), STATE_FILE)


def main(argv=None):
    """Write the published file; returns its path."""
    args = parse_args(argv)
    from tpudet_torch.utils.checkpoint import load_variables, save_variables

    if osp.isdir(args.in_file):
        trees, _ = load_variables(train_state_file(args.in_file))
        prefix = 'ema_' if args.use_ema else ''
        variables = {'params': trees[prefix + 'params'],
                     'batch_stats': trees.get(prefix + 'batch_stats', {})}
        meta = {'published_from': args.in_file, 'ema': bool(args.use_ema)}
    else:
        variables, meta = load_variables(args.in_file)
        meta = dict(meta, published_from=args.in_file)

    tmp = args.out_file
    save_variables(tmp, variables, meta)
    with open(tmp, 'rb') as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    root, ext = osp.splitext(tmp)
    final = f'{root}-{sha[:8]}{ext or ".msgpack"}'
    os.replace(tmp, final)
    print(f'published: {final}')
    return final


if __name__ == '__main__':
    main()
