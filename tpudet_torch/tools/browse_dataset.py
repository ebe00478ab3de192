"""Draw a config's training samples as the pipeline gives them:
counterpart of ``tools/misc/browse_dataset.py``.

    python -m tpudet_torch.tools.browse_dataset CONFIG
        [--output-dir work_dirs/browse] [--num 20] [--device cuda|cpu]

Builds ``data.train`` on the device, runs the first ``--num`` samples
through its pipeline, undoes ``Normalize``, draws each sample's gt boxes
in green (thickness 2, ``visualization.draw_rectangle``) and writes
``<i>.jpg`` with cv2, or ``<i>.png`` (the port's own writer) where cv2 is
not installed.
"""
import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('config')
    p.add_argument('--output-dir', default='work_dirs/browse')
    p.add_argument('--num', type=int, default=20)
    p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    """Write the drawings; returns their paths."""
    args = parse_args(argv)

    from tpudet_torch.config import Config
    from tpudet_torch.data import build_dataset
    from tpudet_torch.visualization import (draw_rectangle, has_cv2,
                                            write_image)

    cfg = Config.fromfile(args.config)
    dataset = build_dataset(cfg['data']['train'], dict(device=args.device))
    os.makedirs(args.output_dir, exist_ok=True)
    norm = None
    for t in cfg['data']['train']['pipeline']:
        if t.get('type') == 'Normalize':
            norm = t
    suffix = 'jpg' if has_cv2() else 'png'
    paths = []
    for i in range(min(args.num, len(dataset))):
        sample = dataset[i]
        img = sample['img']
        if not isinstance(img, np.ndarray):
            img = img.cpu().numpy()
        if norm is not None and img.dtype != np.uint8:
            img = img * np.asarray(norm['std']) + np.asarray(norm['mean'])
            if norm.get('to_rgb'):
                img = img[..., ::-1]
        img = np.clip(img, 0, 255).astype(np.uint8).copy()
        for box in sample.get('gt_bboxes', []):
            x1, y1, x2, y2 = (int(v) for v in box)
            draw_rectangle(img, (x1, y1), (x2, y2), (0, 255, 0), 2)
        paths.append(os.path.join(args.output_dir, f'{i}.{suffix}'))
        write_image(paths[-1], img)
    print(f'wrote {len(paths)} images to {args.output_dir}')
    return paths


if __name__ == '__main__':
    main()
