"""Export the inference program with ``torch.export``: counterpart of
``tools/deployment/export_stablehlo.py``.

    python -m tpudet_torch.tools.export_program CONFIG [CHECKPOINT]
        [--out model.graph.txt] [--batch 1] [--img-size 640]
        [--export model.pt2] [--device cuda|cpu]

The program is the whole shape-static inference path, forward -> decode
-> NMS, traced once at a fixed batch and square canvas:
``image (B, H, W, 3) float32 -> (bboxes, scores, labels, valid)``. Mish is
the registered op ``tpudet::mish_fwd`` (the hand-written kernel on the
card) and each NMS block walk a ``while_loop``, so the graph holds no
value read on the host while it was traced.

- ``--out`` writes the program's graph in core ATen as text (tpudet
  writes StableHLO text);
- ``--export PATH`` writes the eval artifact (tpudet's ``--jax-export``):
  ``(image, scale_factor (B, 4), img_hw (B, 2)) -> the same four``, the
  weights inside, a ``torch.export.save`` file that
  ``tpudet_torch.tools.deployment_test`` evaluates. Loading it needs
  ``import tpudet_torch`` first (the ops' registration);
- ``--saved-model`` exits: TensorFlow SavedModels come only from tpudet.

CHECKPOINT is a ``*.msgpack`` weights file (without it tpudet's init from
numpy seed 0). The model computes in fp32, as tpudet's CLI; a bf16
artifact comes from :func:`export_eval_artifact` on a bf16 ``Detector``.
The device is ``cuda`` unless ``--device cpu`` asks for the CPU; with no
GPU the default raises. A program exported on a device runs on that
device.

Detectors whose ``forward`` takes more than the image (``FastRCNN``, fed
proposals) do not fit the signature and are refused, as tpudet's export
fails on them. Mask branches are not exported: tpudet's program carries
boxes only.
"""
import argparse
import inspect
import os

import torch
from torch import nn


class InferenceProgram(nn.Module):
    """``image -> (bboxes, scores, labels, valid)``: the model, then its
    ``get_bboxes`` by the config's ``test_cfg``. With ``eval_signature``
    the program also takes each image's ``scale_factor`` (B, 4) and
    ``img_hw`` (B, 2), and maps the boxes back to the original images as
    ``single_device_test`` does (``tpudet/apis/test.py``)."""

    def __init__(self, model: nn.Module, eval_signature: bool = False):
        super().__init__()
        self.model = model
        self.eval_signature = eval_signature

    def forward(self, image, scale_factor=None, img_hw=None):
        outputs = self.model(image)
        if not self.eval_signature:
            res = self.model.get_bboxes(outputs)
        else:
            res = self.model.get_bboxes(
                outputs, scale_factors=scale_factor,
                img_shape=(img_hw[:, 0:1], img_hw[:, 1:2]))
        return res.bboxes, res.scores, res.labels, res.valid


def _check_model(model):
    params = list(inspect.signature(model.forward).parameters)
    if len(params) != 1:
        raise ValueError(f'{type(model).__name__}.forward takes {params}, '
                         f'not the image alone: its program has no '
                         f'image-only signature')


def _export(det, eval_signature: bool, batch: int, img_size: int):
    model = det.model.eval()
    _check_model(model)
    dev = det.device
    args = (torch.zeros(batch, img_size, img_size, 3, device=dev),)
    if eval_signature:
        args += (torch.ones(batch, 4, device=dev),
                 torch.full((batch, 2), float(img_size), device=dev))
    program = InferenceProgram(model, eval_signature)
    with torch.no_grad():
        # an eager call first: the heads cache their anchor grids on the
        # device, so that the trace takes them as device constants and the
        # program copies no host tensor to the card when it runs (such
        # copies run host ops, which wake torch's intra-op threads)
        program(*args)
        return torch.export.export(program, args)


def export_program(det, batch: int = 1, img_size: int = 640):
    """The ``ExportedProgram`` of ``det`` (an ``init_detector``
    ``Detector``) on its device and in its dtype, at ``batch`` images of
    ``img_size`` squared: ``image (B, H, W, 3) float32 -> (bboxes,
    scores, labels, valid)``, in core ATen (``run_decompositions``: the
    counterpart of tpudet's StableHLO; ``tpudet::mish_fwd`` and each
    ``while_loop`` stay whole)."""
    return _export(det, False, batch, img_size).run_decompositions()


def export_eval_artifact(det, out_path: str, batch: int = 8,
                         img_size: int = 640) -> int:
    """Write the eval-signature program ``(image, scale_factor, img_hw)
    -> (bboxes, scores, labels, valid)``, weights inside, to ``out_path``
    with ``torch.export.save``; ``img_shape`` is ``(img_hw[:, 0:1],
    img_hw[:, 1:2])``, as tpudet's. The program keeps the ATen ops as
    traced, the ones the live model runs, so that on the same device and
    settings it computes the live model's bits. Returns the file's
    bytes."""
    ep = _export(det, True, batch, img_size)
    # not the zero batch it was traced on (39 MB at 8 x 640 x 640)
    ep.example_inputs = None
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(ep, out_path)
    return os.path.getsize(out_path)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description='Export the inference program with torch.export')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--out', default='model.graph.txt',
                   help="the program's graph as text")
    p.add_argument('--batch', type=int, default=1)
    p.add_argument('--img-size', type=int, default=640)
    p.add_argument('--export', default=None,
                   help='also write the eval artifact (.pt2; evaluated by '
                        'tpudet_torch.tools.deployment_test)')
    p.add_argument('--saved-model', default=None,
                   help='not supported: TensorFlow SavedModels come from '
                        "tpudet's export_stablehlo.py")
    p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    """Write what the flags ask for; returns the ``ExportedProgram`` of
    ``--out``."""
    args = parse_args(argv)
    if args.saved_model:
        raise SystemExit('--saved-model: the port exports torch.export '
                         'programs only; write TensorFlow SavedModels with '
                         "tpudet's tools/deployment/export_stablehlo.py")

    from tpudet_torch.apis import init_detector

    det = init_detector(args.config, args.checkpoint, device=args.device,
                        dtype=torch.float32)
    ep = export_program(det, args.batch, args.img_size)
    text = str(ep.graph_module.print_readable(print_output=False))
    with open(args.out, 'w') as f:
        f.write(text)
    print(f'wrote the program graph ({len(text) / 1e6:.1f} MB) to '
          f'{args.out}')
    if args.export:
        n = export_eval_artifact(det, args.export, batch=max(args.batch, 1),
                                 img_size=args.img_size)
        print(f'wrote the eval artifact ({n / 1e6:.1f} MB) to {args.export}')
    return ep


if __name__ == '__main__':
    main()
