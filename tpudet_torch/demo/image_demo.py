"""Single-image detection demo of the port: counterpart of
``demo/image_demo.py``.

    python -m tpudet_torch.demo.image_demo IMG CONFIG [CHECKPOINT]
        [--score-thr 0.3] [--with-masks] [--out-file FILE]
        [--device cuda|cpu]

Builds the detector with ``init_detector`` (fp32; CHECKPOINT a
``*.msgpack`` weights file, else tpudet's init from numpy seed 0), runs
``inference_detector`` on the image file and prints tpudet's lines: one
``class: score=... box=(x1,y1,x2,y2)`` line per detection at or over
``--score-thr``, then ``N detections above THR``. ``--out-file`` draws
them with ``imshow_det_bboxes``: a ``.png`` needs no cv2, another suffix
does. The device is ``cuda`` unless ``--device cpu`` asks for the CPU;
with no GPU the default raises.
"""
import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('img', help='image file')
    p.add_argument('config', help='config file')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--with-masks', action='store_true',
                   help='predict and draw instance masks (a detector with '
                        'a mask branch)')
    p.add_argument('--out-file', default=None,
                   help='save the drawing to this file')
    p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    """Run the demo; returns ``inference_detector``'s result."""
    args = parse_args(argv)

    import torch

    from tpudet_torch.apis import inference_detector, init_detector
    from tpudet_torch.visualization import imshow_det_bboxes

    det = init_detector(args.config, args.checkpoint, device=args.device,
                        dtype=torch.float32)
    result = inference_detector(det, args.img, with_masks=args.with_masks)
    bbox_result = result[0] if args.with_masks else result
    kept = 0
    for cls, arr in enumerate(bbox_result):
        for box in arr:
            if box[4] >= args.score_thr:
                print(f'{det.CLASSES[cls]}: score={box[4]:.3f} '
                      f'box=({box[0]:.1f},{box[1]:.1f},{box[2]:.1f},'
                      f'{box[3]:.1f})')
                kept += 1
    print(f'{kept} detections above {args.score_thr}')
    if args.out_file:
        imshow_det_bboxes(args.img, result, det.CLASSES,
                          score_thr=args.score_thr, out_file=args.out_file,
                          device=det.device)
    return result


if __name__ == '__main__':
    main()
