"""COCO error analysis: counterpart of
``tools/analysis_tools/coco_error_analysis.py``.

    python -m tpudet_torch.tools.coco_error_analysis CONFIG [CHECKPOINT]
        [--batch-size 8] [--img-size 640] [--out error_analysis.json]
        [--device cuda|cpu]

Runs ``single_device_test`` (fp32) over ``data.test`` and evaluates its
detections at a ladder of relaxed settings with ``eval_map_flexible``,
tpudet's decomposition of the reference's per-class error contributions:

- C75 / C50: AP at IoU .75 / .5;
- Loc: AP at IoU .1 (localization errors forgiven);
- Oth: Loc after removing detections that overlap a gt of another class
  at IoU >= .1 and none of their own (class confusions forgiven; the
  reference's supercategory split needs the COCO taxonomy and is folded
  in);
- BG: Oth with the remaining false positives removed (background errors
  forgiven);
- FN: 1.0 (the rest is missed gts).

Prints the report as JSON and writes it to ``--out``. The device is
``cuda`` unless ``--device cpu`` asks for the CPU.
"""
import argparse
import json

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='coco error analysis')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--batch-size', type=int, default=8)
    p.add_argument('--img-size', type=int, default=640)
    p.add_argument('--out', default='error_analysis.json')
    p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    return p.parse_args(argv)


def _iou(a, b):
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    inter = np.prod(np.clip(br - tl, 0, None), -1)
    area_a = np.prod(a[:, 2:4] - a[:, :2], -1)
    area_b = np.prod(b[:, 2:4] - b[:, :2], -1)
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter,
                              1e-9)


def _gts(ann):
    return (np.asarray(ann['gt_bboxes'], np.float32).reshape(-1, 4),
            np.asarray(ann['gt_labels']).reshape(-1))


def remove_confusions(det_results, annotations, thr=0.1):
    """Drop detections overlapping a gt of ANOTHER class at IoU >= thr,
    unless they also overlap one of their own class that much."""
    out = []
    for dets, ann in zip(det_results, annotations):
        gtb, gtl = _gts(ann)
        new = []
        for cls, d in enumerate(dets):
            d = np.asarray(d, np.float32).reshape(-1, 5)
            other = gtb[gtl != cls]
            if len(d) and len(other):
                keep = _iou(d, other).max(1) < thr
                own = gtb[gtl == cls]
                if len(own):
                    keep = keep | (_iou(d, own).max(1) >= thr)
                d = d[keep]
            new.append(d)
        out.append(new)
    return out


def remove_background_fps(det_results, annotations, thr=0.1):
    """Keep only detections that overlap a gt of their class at IoU >=
    thr."""
    out = []
    for dets, ann in zip(det_results, annotations):
        gtb, gtl = _gts(ann)
        new = []
        for cls, d in enumerate(dets):
            d = np.asarray(d, np.float32).reshape(-1, 5)
            own = gtb[gtl == cls]
            if len(d):
                d = d[_iou(d, own).max(1) >= thr] if len(own) else d[:0]
            new.append(d)
        out.append(new)
    return out


def analyse(det_results, annotations, classes):
    """The report ``{C75, C50, Loc, Oth, BG, FN}`` of per-image, per-class
    (n, 5) detections."""
    from tpudet_torch.evaluation import eval_map_flexible

    def ap_at(dets, iou):
        return eval_map_flexible(
            dets, annotations, iou_thrs=(iou,), classes=classes,
            report_config=[('map', lambda x: x['breakdown'] == 'All')]
        )['map']

    return dict(
        C75=ap_at(det_results, 0.75),
        C50=ap_at(det_results, 0.5),
        Loc=ap_at(det_results, 0.1),
        Oth=ap_at(remove_confusions(det_results, annotations), 0.1),
        BG=ap_at(remove_background_fps(det_results, annotations), 0.1),
        FN=1.0,
    )


def main(argv=None):
    """Print and write the report; returns it."""
    args = parse_args(argv)

    import torch

    from tpudet_torch.apis import init_detector, single_device_test
    from tpudet_torch.config import Config
    from tpudet_torch.data import build_dataset

    cfg = Config.fromfile(args.config)
    det = init_detector(cfg, args.checkpoint, device=args.device,
                        dtype=torch.float32)
    dataset = build_dataset({**cfg['data']['test'], 'test_mode': True},
                            dict(device=det.device))
    dets = single_device_test(det.model, dataset, batch_size=args.batch_size,
                              img_size=args.img_size)
    anns = [dataset.get_ann_info_test(i) for i in range(len(dataset))]
    report = analyse(dets, anns, dataset.CLASSES)
    print(json.dumps(report, indent=2))
    with open(args.out, 'w') as f:
        json.dump(report, f)
    return report


if __name__ == '__main__':
    main()
