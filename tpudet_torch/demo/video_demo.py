"""Video detection demo of the port: counterpart of ``demo/video_demo.py``.

    python -m tpudet_torch.demo.video_demo VIDEO CONFIG [CHECKPOINT]
        [--score-thr 0.3] [--out FILE] [--show] [--wait-time 1]
        [--device cuda|cpu]

Each frame goes through ``inference_detector`` (fp32) and is drawn with
``imshow_det_bboxes``. Frames come in through ``cv2.VideoCapture`` and go
out through ``cv2.VideoWriter`` (mp4v), so this demo needs cv2: without
it, it raises ``ImportError`` before it builds a model. The device is
``cuda`` unless ``--device cpu`` asks for the CPU.
"""
import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('video', help='video file')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--out', default=None, help='output video file')
    p.add_argument('--show', action='store_true')
    p.add_argument('--wait-time', type=float, default=1)
    p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    return p.parse_args(argv)


def import_cv2(demo: str):
    """cv2, or an ``ImportError`` that says why the demo needs it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f'{demo} reads frames with cv2.VideoCapture and writes them '
            f'with cv2.VideoWriter, and cv2 is not installed') from e
    return cv2


def main(argv=None):
    """Run the demo; returns the number of frames it read."""
    args = parse_args(argv)
    cv2 = import_cv2('video_demo')

    import torch

    from tpudet_torch.apis import inference_detector, init_detector
    from tpudet_torch.visualization import imshow_det_bboxes

    det = init_detector(args.config, args.checkpoint, device=args.device,
                        dtype=torch.float32)
    cap = cv2.VideoCapture(args.video)
    if not cap.isOpened():
        raise OSError(f'cannot open {args.video}')
    writer = None
    if args.out:
        fourcc = cv2.VideoWriter_fourcc(*'mp4v')
        fps = cap.get(cv2.CAP_PROP_FPS) or 25
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        writer = cv2.VideoWriter(args.out, fourcc, fps, (w, h))

    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        result = inference_detector(det, frame)
        vis = imshow_det_bboxes(frame, result, det.CLASSES,
                                score_thr=args.score_thr)
        if writer is not None:
            writer.write(vis)
        if args.show:
            cv2.imshow('video', vis)
            if cv2.waitKey(int(args.wait_time)) & 0xFF == 27:
                break
        n += 1
    cap.release()
    if writer is not None:
        writer.release()
        print(f'wrote {n} annotated frames to {args.out}')
    return n


if __name__ == '__main__':
    main()
