"""Evaluate saved detections against a config's test set: counterpart of
``tools/analysis_tools/eval_metric.py``.

    python -m tpudet_torch.tools.eval_metric CONFIG RESULTS.pkl
        [--device cuda|cpu]

RESULTS.pkl holds the per-image, per-class (n, 5) arrays of
``single_device_test``, in the order of ``data.test`` (any registered
dataset: COCO and its subclasses, the annotation-list and VOC sets).
Prints ``coco_fast_bbox_eval``'s report as JSON and returns it. The
dataset's pipeline is built on ``--device`` (no image is read).
"""
import argparse
import json
import pickle


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('config')
    p.add_argument('results', help='pickle of per-image per-class arrays')
    p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from tpudet_torch.config import Config
    from tpudet_torch.data import build_dataset
    from tpudet_torch.evaluation import coco_fast_bbox_eval

    cfg = Config.fromfile(args.config)
    dataset = build_dataset({**cfg['data']['test'], 'test_mode': True},
                            dict(device=args.device))
    with open(args.results, 'rb') as f:
        results = pickle.load(f)
    if len(results) != len(dataset):
        raise ValueError(f'{len(results)} results vs {len(dataset)} images')
    annotations = [dataset.get_ann_info_test(i) for i in range(len(dataset))]
    report = coco_fast_bbox_eval(results, annotations,
                                 classes=dataset.CLASSES)
    print(json.dumps(report, indent=2))
    return report


if __name__ == '__main__':
    main()
