"""Evaluate a detector on a config's test set with the port: counterpart of
``tools/test.py``.

    python -m tpudet_torch.tools.test CONFIG [CHECKPOINT] [--batch-size 8]
        [--img-size 640] [--metrics|--eval bbox [segm] [proposal_fast]]
        [--mask-thr 0.5] [--tta] [--out FILE] [--format-out PREFIX]
        [--device cuda|cpu]
        [--coordinator HOST:PORT --num-processes N --process-id I
         [--dist-backend nccl|gloo] [--dist-timeout SECONDS]]

CHECKPOINT is a ``*.msgpack`` weights file (``train_detector``'s
``best_ema.msgpack`` / ``latest_ema.msgpack``, or tpudet's); without it
the model takes tpudet's init from numpy seed 0. The detector computes in
fp32, as tpudet's test CLI does. Prints the report as JSON and returns
it, in tpudet's order: the fast-bbox keys for ``bbox``, ``AR@100``,
``AR@300`` and ``AR@1000`` (``coco_proposal_fast_eval``) for
``proposal_fast``, the ``segm_*`` keys of the mask mAP for ``segm`` (a
detector with a mask branch; masks binarized at ``--mask-thr``).
``--tta`` evaluates with flip test-time augmentation
(``single_device_test(tta=True)``: the batch and its mirror image, one
merged NMS); it refuses ``segm``, as tpudet's. ``--format-out`` writes
``<prefix>.bbox.json`` and, with ``segm``, ``<prefix>.segm.json``. The
device is ``cuda`` unless ``--device cpu`` asks for the CPU; with no GPU
the default raises.

With several processes (the flags of ``tools/train.py``, started once
per process), each tests a rank-strided shard of the set, the results
are all-gathered, and only process 0 prints and writes, as tpudet's
``tools/test.py:78-95``; the report is the one process's.
"""
import argparse
import json

from tpudet_torch.tools.train import add_dist_args, init_from_args


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Test a detector')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None,
                   help='msgpack weights (EMA) saved by training')
    p.add_argument('--batch-size', type=int, default=8)
    p.add_argument('--img-size', type=int, default=640)
    p.add_argument('--metrics', '--eval', nargs='+', default=['bbox'],
                   choices=['bbox', 'segm', 'proposal_fast'],
                   help="'bbox', 'segm' (a detector with a mask branch), "
                        "'proposal_fast' (AR@100/300/1000)")
    p.add_argument('--mask-thr', type=float, default=0.5,
                   help='mask binarisation threshold')
    p.add_argument('--tta', action='store_true',
                   help='flip test-time augmentation with merged-candidate '
                        'NMS; single-stage models')
    p.add_argument('--out', help='dump the report as json')
    p.add_argument('--format-out',
                   help='dump detections in the COCO result format to '
                        '<prefix>.bbox.json / <prefix>.segm.json')
    p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    add_dist_args(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from tpudet_torch.parallel import close_distributed, process_index

    device = init_from_args(args)
    try:
        return _evaluate(args, device, process_index())
    finally:
        close_distributed()


def _evaluate(args, device, rank):
    import torch

    from tpudet_torch.apis import init_detector, single_device_test
    from tpudet_torch.config import Config
    from tpudet_torch.data import build_dataset
    from tpudet_torch.evaluation import (coco_fast_bbox_eval,
                                         coco_fast_segm_eval,
                                         coco_proposal_fast_eval)

    cfg = Config.fromfile(args.config)
    det = init_detector(cfg, args.checkpoint, device=device,
                        dtype=torch.float32)
    dataset = build_dataset({**cfg['data']['test'], 'test_mode': True},
                            dict(device=det.device))
    with_masks = 'segm' in args.metrics
    results = single_device_test(det.model, dataset,
                                 batch_size=args.batch_size,
                                 img_size=args.img_size,
                                 with_masks=with_masks,
                                 mask_thr=args.mask_thr, tta=args.tta)
    segm_results = None
    if with_masks:
        results, segm_results = results
    annotations = [dataset.get_ann_info_test(i) for i in range(len(dataset))]
    report = {}
    if 'bbox' in args.metrics:
        report.update(coco_fast_bbox_eval(results, annotations,
                                          classes=dataset.CLASSES))
    if 'proposal_fast' in args.metrics:
        report.update(coco_proposal_fast_eval(results, annotations))
    if with_masks:
        report.update(coco_fast_segm_eval(results, segm_results,
                                          annotations,
                                          classes=dataset.CLASSES))
    # every rank holds the gathered report; only rank 0 prints and
    # writes, since ranks racing on one path corrupt it
    if rank != 0:
        return report
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f)
    if args.format_out:
        paths = dataset.results2json(results, args.format_out,
                                     segm_results=segm_results)
        for metric, path in paths.items():
            print(f'wrote {metric} results to {path}')
    return report


if __name__ == '__main__':
    main()
