"""``torch.export`` of the port's inference program, on the CPU in fp32:
``nms_blocked``'s two loops, the registered mish ops and the exported
programs of YOLOv4, YOLOv5, RetinaNet and Faster R-CNN (whose RPN
proposals are ``RPN``'s; ``tpudet_torch/tools/export_program.py``), at
64 px.

- ``nms_blocked``: one export per block size (512, the YOLO and RetinaNet
  walk; 128, the dense per-class walk) of a batch whose rows are the
  cases (chains, score ties with padding, all padding, ``max_out`` filled
  in the first block, a few valid candidates), K = 700, not a multiple of
  either block. The exported program (a ``while_loop``) and the
  eager call (a host loop) give identical ``keep_idx``, ``keep_valid``,
  boxes and scores, and both equal tpudet's ``nms_blocked`` row by row:
  tolerance 0, the same comparisons on the same fp32 values;
- the mish ops: ``torch.library.opcheck``; the fake implementation keeps
  ``channels_last`` strides and the dtype; the CPU ops equal
  ``mish_reference`` / ``mish_backward_reference`` bit for bit;
  ``import tpudet_torch`` registers them;
- the exported programs equal the eager call bit for bit (tolerance 0:
  the program runs the same ATen ops on the same CPU), the eval
  signature with scale factors and per-image shapes; the export CLI's
  graph text is core ATen with ``tpudet.mish_fwd`` and ``while_loop``.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.core import nms as jnms
from tpudet_torch.apis import init_detector
from tpudet_torch.config import Config
from tpudet_torch.core import nms as tnms
from tpudet_torch.ops import mish
from tpudet_torch.tools import export_program as ex
from tpudet_torch.utils.checkpoint import save_variables

from .test_models.test_retinanet import retina_cfg
from .test_torch_faster_rcnn import frcnn_cfg
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

ROOT = __file__.rsplit('/tests/', 1)[0]
K, MAX_OUT, IOU_THR = 700, 300, 0.5


def _nms_cases():
    """(B, K) boxes, scores and valid, one case a row."""
    rng = np.random.RandomState(0)
    boxes = np.zeros((5, K, 4), np.float32)
    scores = np.zeros((5, K), np.float32)
    valid = np.ones((5, K), bool)
    # 0: 100 chains of 7 boxes 5 px apart (IoU 0.6 with a neighbour, 0.33
    # two apart), scores falling along each chain, the chains interleaved
    i = np.arange(K)
    chain, link = i // 7, i % 7
    x = (chain * 100 + link * 5).astype(np.float32)
    y = (chain % 10 * 40).astype(np.float32)
    boxes[0] = np.stack([x, y, x + 20, y + 20], -1)
    scores[0] = 1 - link / 10 - rng.rand(K).astype(np.float32) * 0.05
    # 1: crowded boxes, 4 score levels (ties), ~10 % padding
    xy = rng.rand(K, 2).astype(np.float32) * 100
    boxes[1] = np.concatenate([xy, xy + rng.rand(K, 2) * 60 + 2], -1)
    scores[1] = rng.randint(1, 5, K) / 4
    valid[1] = rng.rand(K) > 0.1
    # 2: all padding
    boxes[2], scores[2], valid[2] = boxes[1], scores[1], False
    # 3: disjoint boxes: the first block alone fills max_out
    gx, gy = i % 30 * 30., i // 30 * 30.
    boxes[3] = np.stack([gx, gy, gx + 20, gy + 20], -1)
    scores[3] = rng.rand(K)
    # 4: 30 valid disjoint candidates among padding
    boxes[4], scores[4] = boxes[3], rng.rand(K)
    valid[4] = False
    valid[4, rng.choice(K, 30, replace=False)] = True
    return boxes, scores.astype(np.float32), valid


class _NMS(torch.nn.Module):

    def __init__(self, block):
        super().__init__()
        self.block = block

    def forward(self, boxes, scores, valid):
        return tnms.nms_blocked(boxes, scores, IOU_THR, MAX_OUT, valid,
                                block=self.block, return_dets=True)


@pytest.fixture(scope='module', params=[512, 128])
def nms_runs(request):
    block = request.param
    args = [torch.from_numpy(a) for a in _nms_cases()]
    ep = torch.export.export(_NMS(block), tuple(args))
    exported = ep.module()(*args)
    eager = _NMS(block)(*args)
    ref = jax.jit(jax.vmap(lambda b, s, v: jnms.nms_blocked(
        b, s, IOU_THR, MAX_OUT, v, block=block, return_dets=True)))(
            *(jnp.asarray(a) for a in _nms_cases()))
    return ep, exported, eager, [np.asarray(r) for r in ref]


def test_nms_export_loop_equals_eager_loop(nms_runs):
    ep, exported, eager, _ = nms_runs
    loops = [n for n in ep.graph.nodes
             if n.target is torch.ops.higher_order.while_loop]
    assert len(loops) == 1  # the walk; the in-block loop sits in its body
    for e, g in zip(exported, eager):
        assert torch.equal(e, g)
    keep_valid = eager[3]
    # the cases reach what they stand for
    assert keep_valid[0].sum() == MAX_OUT and keep_valid[3].sum() == MAX_OUT
    assert not keep_valid[2].any() and keep_valid[4].sum() == 30


def test_nms_loops_equal_tpudets_nms_blocked(nms_runs):
    _, exported, eager, ref = nms_runs
    for got in (exported, eager):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), r)


def test_eager_nms_takes_no_while_loop_and_no_compile(monkeypatch):
    from torch._dynamo.utils import counters

    def refuse(*args):
        raise AssertionError('the eager loop reached while_loop')

    monkeypatch.setattr(torch._higher_order_ops, 'while_loop', refuse)
    frames = dict(counters['frames'])
    args = [torch.from_numpy(a) for a in _nms_cases()]
    keep_idx, keep_valid = tnms.nms_blocked(args[0], args[1], IOU_THR,
                                            MAX_OUT, args[2])
    assert keep_valid.sum() > 0
    assert dict(counters['frames']) == frames


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_mish_ops_pass_opcheck(dtype):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 6, 5, 4).astype(np.float32) * 4).to(
        dtype).contiguous(memory_format=torch.channels_last)
    g = torch.from_numpy(rng.randn(2, 6, 5, 4).astype(np.float32)).to(dtype)
    torch.library.opcheck(mish.mish_fwd, (x.requires_grad_(),))
    torch.library.opcheck(mish.mish_bwd, (x.detach(), g))


def test_mish_fake_keeps_layout_and_dtype():
    """The fake implementations (which ``torch.export`` traces and the meta
    device runs) give ``torch.empty_like(x)``: channels_last strides and
    the dtype survive."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    for dtype in (torch.float32, torch.bfloat16):
        with FakeTensorMode():
            x = torch.empty(2, 6, 5, 4, dtype=dtype).contiguous(
                memory_format=torch.channels_last)
            outs = [torch.ops.tpudet.mish_fwd(x),
                    torch.ops.tpudet.mish_bwd(x, x.contiguous())]
        outs.append(mish.mish_cuda(torch.empty(
            2, 6, 5, 4, dtype=dtype, device='meta').contiguous(
                memory_format=torch.channels_last)))
        for y in outs:
            assert y.stride() == x.stride() and y.dtype == dtype


def test_mish_cpu_ops_equal_the_plain_versions():
    rng = np.random.RandomState(2)
    x = np.concatenate([rng.randn(997) * 6, [np.inf, -np.inf, np.nan, 0.,
                                             20., 19.99, -1.1924]])
    g = rng.randn(x.size)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        xt = torch.from_numpy(x.astype(np.float32)).to(dtype)
        gt = torch.from_numpy(g.astype(np.float32)).to(dtype)
        np.testing.assert_array_equal(
            torch.ops.tpudet.mish_fwd(xt).float().numpy(),
            mish.mish_reference(xt).float().numpy())
        np.testing.assert_array_equal(
            torch.ops.tpudet.mish_bwd(xt, gt).float().numpy(),
            mish.mish_backward_reference(xt, gt).float().numpy())


def test_import_registers_the_ops():
    code = ('import torch, tpudet_torch; '
            'print(torch.ops.tpudet.mish_fwd.default._schema, '
            'torch.ops.tpudet.mish_bwd.default._schema)')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert 'tpudet::mish_fwd(Tensor x) -> Tensor' in out
    assert 'tpudet::mish_bwd(Tensor x, Tensor g) -> Tensor' in out


# ---------------------------------------------------------------------------
# the exported programs

V4S = dict(
    type='SingleStageDetector',
    backbone=dict(type='DarknetCSP', scale='v4s5p', out_indices=[3, 4, 5]),
    neck=dict(type='YOLOV4Neck', in_channels=[128, 256, 256],
              out_channels=[64, 64, 64], csp_repetition=1),
    bbox_head=dict(type='YOLOCSPHead', num_classes=3,
                   in_channels=[64, 64, 64]),
    test_cfg=dict(min_bbox_size=0, nms_pre=-1, score_thr=0.001,
                  anchor_pre=256, class_pre=32, lane_pre=4,
                  nms=dict(type='nms', iou_threshold=0.65),
                  max_per_img=50))
# YOLOv5-s narrowed at the neck's two coarse levels, as
# test_torch_test_cli.py's
V5S = Config.fromfile(f'{ROOT}/configs/yolov5/yolov5s_coco_mosaic.py')[
    'model']
V5S['neck']['out_channels'] = [128, 64, 64]
V5S['bbox_head'].update(num_classes=3, in_channels=[128, 64, 64])
V5S['test_cfg'].update(score_thr=0.0, anchor_pre=256, max_per_img=50)


# YOLOv3 with tpudet's test widths (tests/test_models/test_yolov3.py)
V3 = dict(Config.fromfile(f'{ROOT}/configs/yolo/yolov3_d53_mstrain-608_273e_'
                          f'coco.py')['model'])
V3['neck'] = dict(V3['neck'], out_channels=[128, 64, 32])
V3['bbox_head'] = dict(V3['bbox_head'], num_classes=3,
                       in_channels=[128, 64, 32], out_channels=[256, 128, 64])


def _model_cfg(name):
    if name == 'yolov5':
        return V5S
    if name == 'yolov3':
        return V3
    if name == 'cascade_rcnn':
        return dict(frcnn_cfg(), type='CascadeRCNN', roi_head=dict(
            type='CascadeRoIHead', num_classes=3, in_channels=64))
    if name == 'retinanet':
        cfg = retina_cfg(num_classes=4)
        cfg['test_cfg'] = dict(cfg['test_cfg'], score_thr=0.0)
        return cfg
    return frcnn_cfg()


def _eval_inputs(size, seed=3, b=2):
    rng = np.random.RandomState(seed)
    img = torch.from_numpy(rng.randn(b, size, size, 3).astype(np.float32)
                           * 0.5)
    scale = torch.tensor([[0.5, 0.5, 0.5, 0.5], [1.25, 1.5, 1.25, 1.5]])
    hw = torch.tensor([[size, size * 0.75], [size * 0.5, size]])
    return img, scale, hw


@pytest.mark.parametrize('name', ['yolov5', 'retinanet', 'faster_rcnn',
                                  'yolov3', 'cascade_rcnn'])
def test_exported_eval_program_equals_the_eager_call(name):
    size = 64
    det = init_detector(Config(dict(model=_model_cfg(name))), device='cpu',
                        dtype=torch.float32)
    args = _eval_inputs(size)
    ep = ex._export(det, True, 2, size)
    got = ep.module()(*args)
    with torch.no_grad():
        ref = ex.InferenceProgram(det.model, eval_signature=True)(*args)
    assert int(ref[3].sum()) > 0
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


def test_export_refuses_a_detector_fed_proposals():
    det = init_detector(Config(dict(model=frcnn_cfg('FastRCNN'))),
                        device='cpu', dtype=torch.float32)
    with pytest.raises(ValueError, match='image-only signature'):
        ex.export_program(det, 1, 64)


@pytest.fixture(scope='module')
def cli_export(tmp_path_factory):
    """The export CLI on a v4s config and msgpack weights whose pred convs
    are drawn wide, so that detections flow through the lane NMS."""
    from tpudet_torch.models.builder import build_detector
    from tpudet_torch.utils.flax_import import random_flax_variables
    d = tmp_path_factory.mktemp('export_cli')
    tree = random_flax_variables(build_detector(V4S), seed=0)
    rng = np.random.RandomState(4)
    for i in range(3):
        conv = tree['params']['bbox_head'][f'conv_pred{i}']
        conv['kernel'] = (rng.randn(*conv['kernel'].shape) * 0.2).astype(
            np.float32)
    ckpt = str(d / 'w.msgpack')
    save_variables(ckpt, tree)
    cfg = d / 'v4s.py'
    cfg.write_text(f'model = {V4S!r}\n')
    out = d / 'graph.txt'
    ep = ex.main([str(cfg), ckpt, '--out', str(out), '--batch', '2',
                  '--img-size', '64', '--device', 'cpu'])
    return ep, out.read_text(), init_detector(str(cfg), ckpt, device='cpu',
                                              dtype=torch.float32)


def test_export_cli_writes_core_aten_graph(cli_export):
    _, text, _ = cli_export
    for name in ('aten.convolution', 'tpudet.mish_fwd', 'while_loop'):
        assert name in text, name
    assert 'aten.conv2d' not in text  # decomposed to core ATen


def test_export_cli_program_equals_the_eager_call(cli_export):
    ep, _, det = cli_export
    img = _eval_inputs(64)[0]
    got = ep.module()(img)
    with torch.no_grad():
        ref = ex.InferenceProgram(det.model)(img)
    assert int(ref[3].sum()) > 0
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_export_cli_refuses_saved_model():
    with pytest.raises(SystemExit, match='SavedModels'):
        ex.main(['cfg.py', '--saved-model', 'out', '--device', 'cpu'])
