"""Webcam detection demo of the port: counterpart of
``demo/webcam_demo.py``.

    python -m tpudet_torch.demo.webcam_demo CONFIG [CHECKPOINT]
        [--camera-id 0] [--score-thr 0.3] [--device cuda|cpu]

Frames come from ``cv2.VideoCapture`` and are shown with ``cv2.imshow``
until ESC, each drawn with ``imshow_det_bboxes``. Without cv2 it raises
``ImportError`` before it builds a model.
"""
import argparse

from tpudet_torch.demo.video_demo import import_cv2


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--camera-id', type=int, default=0)
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cv2 = import_cv2('webcam_demo')

    import torch

    from tpudet_torch.apis import inference_detector, init_detector
    from tpudet_torch.visualization import imshow_det_bboxes

    det = init_detector(args.config, args.checkpoint, device=args.device,
                        dtype=torch.float32)
    cap = cv2.VideoCapture(args.camera_id)
    if not cap.isOpened():
        raise OSError(f'cannot open camera {args.camera_id}')
    print('press ESC to exit')
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        result = inference_detector(det, frame)
        vis = imshow_det_bboxes(frame, result, det.CLASSES,
                                score_thr=args.score_thr)
        cv2.imshow('webcam', vis)
        if cv2.waitKey(1) & 0xFF == 27:
            break
    cap.release()


if __name__ == '__main__':
    main()
