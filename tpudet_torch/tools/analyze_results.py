"""Per-image result analysis: counterpart of
``tools/analysis_tools/analyze_results.py``.

    python -m tpudet_torch.tools.analyze_results CONFIG [CHECKPOINT]
        [--show-dir analysis_results] [--topk 20] [--batch-size 8]
        [--img-size 640] [--score-thr 0.3] [--device cuda|cpu]

Runs ``single_device_test`` (fp32) over ``data.test``, scores every image
by its own mAP at IoU 0.5 (``eval_map_flexible``), and draws the
``--topk`` worst images into ``<show-dir>/bad`` and the best into
``<show-dir>/good`` with ``imshow_det_bboxes``, each named
``<score>_<filename>``; where cv2 is not installed the file's suffix
becomes ``.png``, which the port writes without it.
"""
import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--show-dir', default='analysis_results')
    p.add_argument('--topk', type=int, default=20)
    p.add_argument('--batch-size', type=int, default=8)
    p.add_argument('--img-size', type=int, default=640)
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    """Write the drawings; returns the per-image scores."""
    args = parse_args(argv)

    import torch

    from tpudet_torch.apis import init_detector, single_device_test
    from tpudet_torch.config import Config
    from tpudet_torch.data import build_dataset
    from tpudet_torch.evaluation import eval_map_flexible
    from tpudet_torch.visualization import has_cv2, imshow_det_bboxes

    cfg = Config.fromfile(args.config)
    det = init_detector(cfg, args.checkpoint, device=args.device,
                        dtype=torch.float32)
    dataset = build_dataset({**cfg['data']['test'], 'test_mode': True},
                            dict(device=det.device))
    dets = single_device_test(det.model, dataset,
                              batch_size=args.batch_size,
                              img_size=args.img_size)
    anns = [dataset.get_ann_info_test(i) for i in range(len(dataset))]

    scores = []
    for i in range(len(dataset)):
        r = eval_map_flexible([dets[i]], [anns[i]],
                              iou_thrs=(0.5,), classes=dataset.CLASSES)
        scores.append(r['map'])
    order = np.argsort(scores)
    cv2_here = has_cv2()

    def draw(idx, kind):
        info = dataset.data_infos[idx]
        name = f'{scores[idx]:.3f}_{info["filename"]}'
        if not cv2_here:
            name = os.path.splitext(name)[0] + '.png'
        imshow_det_bboxes(os.path.join(dataset.img_prefix, info['filename']),
                          dets[idx], dataset.CLASSES,
                          score_thr=args.score_thr,
                          out_file=os.path.join(args.show_dir, kind, name),
                          device=det.device)

    os.makedirs(os.path.join(args.show_dir, 'good'), exist_ok=True)
    os.makedirs(os.path.join(args.show_dir, 'bad'), exist_ok=True)
    k = min(args.topk, len(dataset))
    for idx in order[:k]:
        draw(idx, 'bad')
    for idx in order[::-1][:k]:
        draw(idx, 'good')
    print(f'saved {2 * k} visualizations under {args.show_dir}')
    return scores


if __name__ == '__main__':
    main()
