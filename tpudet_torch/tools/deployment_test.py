"""Evaluate an exported program: counterpart of ``tools/deployment/test.py``.

    python -m tpudet_torch.tools.deployment_test CONFIG MODEL.pt2
        [--batch-size 8] [--img-size 640] [--out FILE] [--device cuda|cpu]

MODEL.pt2 is the eval artifact that ``tpudet_torch.tools.export_program
--export`` writes (``torch.export.save``, the weights inside). It is
loaded and driven through the same eval protocol as a live model
(``single_device_test`` with an ``infer_fn``, then
``coco_fast_bbox_eval``), so that its report compares one to one with
``tpudet_torch.tools.test`` on the model it was exported from. The
config gives the test set and the model's structure (its class count);
no weights are read besides the artifact's. ``--batch-size`` and
``--img-size`` must be those the artifact was exported at; a short tail
batch is zero-padded. Prints the report as JSON. The dataset's pipeline
runs on ``--device`` (``cuda`` unless ``--device cpu`` asks for the CPU;
with no GPU the default raises); the program runs on the device it was
exported on.
"""
import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description='Test (and eval) an exported detector')
    p.add_argument('config', help='test config file path')
    p.add_argument('model', help='torch.export artifact '
                                 '(export_program.py --export)')
    p.add_argument('--batch-size', type=int, default=8,
                   help='MUST match the batch the artifact was exported '
                        'with (exported programs are shape-static); '
                        'short tail batches are zero-padded')
    p.add_argument('--img-size', type=int, default=640)
    p.add_argument('--out', help='dump eval report json')
    p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    return p.parse_args(argv)


def _user_inputs(ep):
    """The example values of the program's user inputs, in order."""
    names = set(ep.graph_signature.user_inputs)
    return [n.meta['val'] for n in ep.graph.nodes
            if n.op == 'placeholder' and n.name in names]


def load_exported_infer_fn(path: str, batch_size: int, img_size=None):
    """Load the artifact at ``path`` into a ``single_device_test``
    ``infer_fn(img, scale_factor, img_hw) -> NMSResult``.

    The program is shape-static at its exported batch and canvas: a
    ``batch_size`` or ``img_size`` other than those exits with tpudet's
    messages. A tail batch is zero-padded up (``scale_factor`` and
    ``img_hw`` with 1.0) and the outputs sliced back down."""
    import torch
    import torch.nn.functional as F

    from tpudet_torch.core.nms import NMSResult  # registers the ops

    ep = torch.export.load(path)
    image = _user_inputs(ep)[0]  # (B, H, W, 3)
    exp_batch, exp_h, exp_w = (int(s) for s in image.shape[:3])
    if exp_batch != batch_size:
        raise SystemExit(
            f'artifact was exported at batch_size={exp_batch} but '
            f'--batch-size={batch_size}; rerun with '
            f'--batch-size {exp_batch} or re-export')
    if img_size is not None and (exp_h, exp_w) != (img_size, img_size):
        raise SystemExit(
            f'artifact was exported at {exp_h}x{exp_w} input but '
            f'--img-size={img_size}; rerun with --img-size {exp_h} '
            f'or re-export')
    program = ep.module()
    device = image.device

    def infer_fn(img, scale_factor, img_hw):
        img = img.to(device, torch.float32)
        scale_factor = scale_factor.to(device, torch.float32)
        img_hw = img_hw.to(device, torch.float32)
        b = img.shape[0]
        if b > batch_size:
            raise ValueError(f'batch {b} > exported batch {batch_size}; '
                             f're-export or lower --batch-size')
        pad = batch_size - b
        if pad:
            img = F.pad(img, (0, 0) * (img.dim() - 1) + (0, pad))
            scale_factor = F.pad(scale_factor, (0, 0, 0, pad), value=1.0)
            img_hw = F.pad(img_hw, (0, 0, 0, pad), value=1.0)
        out = program(img, scale_factor, img_hw)
        return NMSResult(*(t[:b] for t in out))

    return infer_fn


def main(argv=None):
    """Evaluate the artifact; prints and returns the report."""
    args = parse_args(argv)

    from tpudet_torch.apis import single_device_test
    from tpudet_torch.config import Config
    from tpudet_torch.data import build_dataset
    from tpudet_torch.evaluation import coco_fast_bbox_eval
    from tpudet_torch.models.builder import build_detector
    from tpudet_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    # structure only (class count, head type); the weights live inside the
    # artifact
    model = build_detector(cfg['model']).to(device)
    dataset = build_dataset({**cfg['data']['test'], 'test_mode': True},
                            dict(device=device))
    infer_fn = load_exported_infer_fn(args.model, args.batch_size,
                                      img_size=args.img_size)
    results = single_device_test(model, dataset, batch_size=args.batch_size,
                                 img_size=args.img_size, infer_fn=infer_fn)
    annotations = [dataset.get_ann_info_test(i) for i in range(len(dataset))]
    report = coco_fast_bbox_eval(results, annotations,
                                 classes=dataset.CLASSES)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f)
    return report


if __name__ == '__main__':
    main()
