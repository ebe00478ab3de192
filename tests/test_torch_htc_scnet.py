"""HTC and SCNet (ROADMAP.md's zoo row i) in tpudet_torch against tpudet,
on the CPU, from numpy seeds: ResNet-18 of 16 base channels, an FPN of 32
with 5 levels, 3 classes, 8 semantic classes.

Tolerances:

- ``FusedSemanticHead`` (fp32; P2 down to the fusion level, P4-P6 up by
  non-integer ratios at 80 px): the embedding and the logits within 1e-5
  of their largest |value|, the input gradients within 1e-5 of theirs;
- the losses of the semantic and global-context branches (HTC's clipped
  CE, SCNet's one-hot CE with a label outside the classes, SCNet's
  multi-label BCE) and their gradients: rtol 1e-6;
- the detectors (BatchNorm in eval mode, fp32, 96 px): every forward
  output within 1e-4 of its largest |value| (the cascade's refined rois,
  mean class probabilities, last deltas), the valid slots equal; SCNet's
  ``predict_masks`` (relay included) on tpudet's detections within 1e-5;
- ``forward_train`` in float64 on both sides (BatchNorm in train mode,
  ``gt_frame_masks`` and ``gt_semantic_seg``, 16 rois sampled an image):
  every loss rtol 1e-4;
- the branches' gradients in fp32 on given features (HTC's mask stages
  0 -> 1 with the semantic crops and the information flow and their
  mask losses; SCNet's mask branch with the semantic crop, the global
  context and the relay, and its loss): every parameter's and input's
  gradient within 1e-4 of its largest |value| (RoIAlign's fp32 sample
  points round apart in the two packages, ~1e-6 of the pooled values);
- one ``init_trainer(...).step`` of each (with the semantic maps): every
  loss finite, the params moved. (tpudet's float64 step of these
  detectors jits for 1-3 minutes on this CPU, most of it the gradient of
  the unrolled stages: the losses above and the branch gradients hold
  the same functions at a fraction of it.)
- HTC has no mask branch at test time (tpudet's): a test with masks
  raises, as tpudet's does.
"""
import inspect
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models.builder import build_detector as jax_build_detector
from tpudet.models.roi_heads.htc_roi_head import \
    FusedSemanticHead as JaxFusedSemanticHead
from tpudet.models.roi_heads.scnet_roi_head import \
    SCNetRoIHead as JaxSCNetRoIHead
from tpudet_torch.apis.test import _mask_mode
from tpudet_torch.apis.train import forward_train_loss
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.roi_heads import SCNetRoIHead
from tpudet_torch.models.roi_heads.htc_roi_head import FusedSemanticHead
from tpudet_torch.utils.flax_import import load_flax_variables

from .test_torch_backbone_neck import random_variables
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

IMG, STEP_IMG, NUM_CLASSES, CH, SEM_CLASSES = 96, 64, 3, 32, 8
F64_SAMPLES = 16  # rois an image in the float64 loss tests


def rcnn_cfg(det_type, roi_head, num_samples=32):
    """A narrow two-stage detector of ``det_type`` with ``roi_head``
    (a dict, ``num_classes`` and ``in_channels`` filled in)."""
    return dict(
        type=det_type,
        backbone=dict(type='ResNet', depth=18, base_channels=16,
                      out_indices=[0, 1, 2, 3]),
        neck=dict(type='FPN', in_channels=[16, 32, 64, 128],
                  out_channels=CH, num_outs=5),
        rpn_head=dict(type='RPNHead', in_channels=CH, feat_channels=CH),
        roi_head=dict(dict(num_classes=NUM_CLASSES, in_channels=CH,
                           num_samples=num_samples), **roi_head),
        train_cfg=dict(rpn_proposal=dict(nms_pre=500, max_per_img=64,
                                         nms=dict(iou_threshold=0.7))),
        test_cfg=dict(rpn=dict(nms_pre=500, max_per_img=64,
                               nms=dict(iou_threshold=0.7)),
                      rcnn=dict(score_thr=0.05, nms=dict(iou_threshold=0.5),
                                max_per_img=20)))


def images(seed, b=2, size=IMG):
    return np.random.RandomState(seed).uniform(
        -1.5, 1.5, (b, size, size, 3)).astype(np.float32)


def frame_masks(seed, b=2, g=4, s=28):
    """Random binary gt-frame masks, a blob a gt."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:s, :s] + 0.5
    c = rng.uniform(0.3, 0.7, (b, g, 2, 1, 1)) * s
    r = rng.uniform(0.2, 0.5, (b, g, 1, 1)) * s
    return (((yy - c[:, :, 0]) ** 2 + (xx - c[:, :, 1]) ** 2) < r ** 2
            ).astype(np.float32)


def gt_boxes(seed, b=2, g=4, size=STEP_IMG):
    """Padded gts: 4 in the first image, 2 in the second, sides 20-70 % of
    the image."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate((g, 2)[:b]):
        wh = rng.uniform(0.2, 0.7, (n, 2)) * size
        xy = rng.uniform(0, 1, (n, 2)) * (size - wh)
        boxes[i, :n] = np.concatenate([xy, xy + wh], -1)
        valid[i, :n] = True
    labels = rng.randint(0, NUM_CLASSES, (b, g)).astype(np.int32)
    return boxes, labels, valid


def mask_batch(seed, size=STEP_IMG, semantic=False):
    """A float64 training batch with gt-frame masks (and a semantic map
    at stride 8 holding labels outside the classes too)."""
    boxes, labels, valid = gt_boxes(seed, size=size)
    batch = dict(img=images(seed, size=size).astype(np.float64),
                 gt_bboxes=boxes, gt_labels=labels, gt_valid=valid,
                 gt_frame_masks=frame_masks(seed + 1))
    if semantic:
        seg = np.random.RandomState(seed + 2).randint(
            0, SEM_CLASSES, (2, size // 8, size // 8)).astype(np.int32)
        seg[0, 0, :3] = 255
        batch['gt_semantic_seg'] = seg
    return batch


def forward_train_args(jmodel, batch):
    """The batch's entries in ``forward_train``'s order, by name, to the
    first optional one the batch lacks."""
    args = []
    for name, p in inspect.signature(jmodel.forward_train).parameters.items():
        if name not in batch:
            assert p.default is not inspect.Parameter.empty, name
            break
        args.append(batch[name])
    return args


def float64_losses(cfg, variables, batch):
    """``forward_train``'s losses of tpudet (x64) and of the port (the
    float64 model), BatchNorm in train mode, on ``variables``."""
    jmodel = jax_build_detector(cfg)
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)

    def losses(args):
        out, _ = jmodel.apply(v64, *args, method='forward_train',
                              mutable=['batch_stats'])
        return out

    with jax.enable_x64(True):
        jl = jax.device_get(jax.jit(losses)(
            [jnp.asarray(a) for a in forward_train_args(jmodel, batch)]))
    model = build_detector(cfg)
    load_flax_variables(model, variables)
    model.double().train()
    model.dtype = torch.float64
    with torch.no_grad():
        tl = forward_train_loss(model)(
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    return {k: float(v) for k, v in jl.items()}, \
        {k: float(v) for k, v in tl.items()}


def f64_cfg(cfg):
    """``cfg`` sampling F64_SAMPLES rois an image, for the float64 loss
    tests: XLA's CPU backend runs tpudet's float64 convs as plain loops,
    ~3 s a 256-wide mask conv over 64 rois."""
    return dict(cfg, roi_head=dict(cfg['roi_head'], num_samples=F64_SAMPLES))


def assert_losses_match(jl, tl, keys):
    assert set(tl) == set(jl) and set(keys) <= set(jl)
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=1e-4, err_msg=k)


def assert_trainer_steps(cfg, batch, variables):
    """One bf16-free ``init_trainer(...).step`` of ``cfg`` on the CPU:
    every metric finite, a loss of each kind, the params moved."""
    from tpudet_torch.apis import init_trainer
    from tpudet_torch.config import Config
    trainer = init_trainer(Config(dict(model=cfg, data=dict(
        samples_per_gpu=len(batch['img'])), seed=0)), variables=variables,
        device='cpu', max_steps=2)
    p0 = {k: v.detach().clone() for k, v in trainer.state.params.items()}
    metrics = {k: float(v) for k, v in trainer.step(
        {k: np.asarray(v, np.float32) if k == 'img' else v
         for k, v in batch.items()}).items()}
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    moved = max(float((trainer.state.params[k] - v).abs().max())
                for k, v in p0.items())
    assert moved > 0
    return metrics


def linear_heads(params):
    """``params`` with every RoI head's ReLU inputs moved above 0 (the
    biases of the FCs and convs after RoIAlign raised by 20, their kernels
    scaled by 0.1): RoIAlign's fp32 sample points round apart in the two
    packages, and a ReLU input that close to 0 takes another side."""
    params = jax.tree.map(np.array, params)

    def walk(node):
        for name, sub in node.items():
            if not isinstance(sub, dict):
                continue
            if 'kernel' in sub and 'bias' in sub and name.startswith(
                    ('shared_fc', 'conv', 'fc', 'res', 'upsample',
                     'downsample_conv', 'mask_info')) and \
                    not name.startswith(('fc_cls', 'fc_reg', 'conv_logits',
                                         'fc_logits', 'fc_mask_iou')):
                sub['bias'] = sub['bias'] + 20.
                sub['kernel'] = sub['kernel'] * 0.1
            walk(sub)
    walk(params['roi_head'])
    return params


def variables_for(jmodel, batch, seed):
    """A tpudet variables tree through ``forward_train`` (the mask and
    semantic heads' params exist only there), kernels N(0, 1/fan_in), the
    RPN's deltas 10x narrower (``test_torch_faster_rcnn.det_variables``)."""
    shapes = jax.eval_shape(
        partial(jmodel.init, method='forward_train'), jax.random.PRNGKey(0),
        *[jnp.asarray(a) for a in forward_train_args(jmodel, batch)])
    variables = jax.tree.map(np.asarray, random_variables(shapes, seed))
    reg = variables['params']['rpn_head']['rpn_reg']
    reg['kernel'] = reg['kernel'] * 0.1
    reg['bias'] = reg['bias'] * 0.1
    return variables


def forward_pair(cfg, seed):
    """tpudet's model and variables (fp32), the port's model in eval
    mode on them."""
    jmodel = jax_build_detector(cfg)
    batch = mask_batch(seed, size=IMG, semantic=True)
    batch['img'] = batch['img'].astype(np.float32)
    variables = variables_for(jmodel, batch, seed)
    model = build_detector(cfg)
    load_flax_variables(model, variables)
    return jmodel, variables, model.eval()


def assert_close(got, ref, tol=1e-4):
    for g, r in zip(got, ref):
        r = np.asarray(r, np.float32)
        g = g.float().numpy()
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= tol * max(np.abs(r).max(), 1.0)


# the semantic and global-context branches


@pytest.mark.parametrize('size', [96, 80])
def test_fused_semantic_head_matches_tpudet(size):
    rng = np.random.RandomState(size)
    sides = [size // s for s in (4, 8, 16, 32)]
    sides.append(-(-sides[-1] // 2))
    feats = [rng.randn(2, n, n, CH).astype(np.float32) for n in sides]
    jhead = JaxFusedSemanticHead(num_classes=SEM_CLASSES, in_channels=CH,
                                 conv_out_channels=CH)
    variables = jax.tree.map(np.asarray, random_variables(jax.eval_shape(
        jhead.init, jax.random.PRNGKey(0),
        [jnp.asarray(f) for f in feats]), 3))
    head = FusedSemanticHead(SEM_CLASSES, CH, CH)
    load_flax_variables(head, variables)
    cot = [rng.randn(2, sides[1], sides[1], c).astype(np.float32)
           for c in (CH, SEM_CLASSES)]

    def jtotal(*fs):
        emb, logits = jhead.apply(variables, list(fs))
        return jnp.sum(emb * cot[0]) + jnp.sum(logits * cot[1])
    ref = jax.jit(jhead.apply)(variables, [jnp.asarray(f) for f in feats])
    jg = jax.jit(jax.grad(jtotal, argnums=tuple(range(5))))(
        *(jnp.asarray(f) for f in feats))
    tf = [torch.tensor(f).permute(0, 3, 1, 2).requires_grad_() for f in feats]
    emb, logits = head(tf)
    got = [emb.permute(0, 2, 3, 1), logits.permute(0, 2, 3, 1)]
    (sum((g * torch.tensor(c)).sum() for g, c in zip(got, cot))).backward()
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(g.detach().numpy() - r).max() <= 1e-5 * np.abs(r).max()
    for t, r in zip(tf, jg):
        r = np.asarray(r)
        g = t.grad.permute(0, 2, 3, 1).numpy()
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max()


def _roi_head_pair(kind):
    cfg = zoo_cfg(kind)
    return jax_build_detector(cfg), build_detector(cfg).roi_head


def _loss_pair(jfn, tfn, *arrays):
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tv = tfn(*ts)
    tv.backward()
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(g)).max())
    return float(jv)


def test_semantic_losses_match_tpudet():
    """HTC clips the labels into the classes; SCNet's one-hot gives a
    label outside them a zero row (both counted in the mean)."""
    rng = np.random.RandomState(4)
    logits = rng.randn(2, 8, 8, SEM_CLASSES).astype(np.float32)
    seg = rng.randint(0, SEM_CLASSES, (2, 8, 8)).astype(np.int32)
    seg[0, 0, :4] = 255
    jseg = jnp.asarray(seg)
    tseg = torch.from_numpy(seg)
    jhtc, htc = _roi_head_pair('htc')

    def jhtc_loss(lg):
        logp = jax.nn.log_softmax(lg, -1)
        tgt = jnp.clip(jseg, 0, SEM_CLASSES - 1)
        return 0.2 * jnp.mean(-jnp.take_along_axis(logp, tgt[..., None],
                                                   -1)[..., 0])
    a = _loss_pair(jhtc_loss, lambda lg: htc.semantic_loss(
        lg.permute(0, 3, 1, 2), tseg), logits)
    jscnet = JaxSCNetRoIHead(num_classes=NUM_CLASSES, in_channels=CH,
                             num_semantic_classes=SEM_CLASSES)
    _, scnet = _roi_head_pair('scnet')
    b = _loss_pair(lambda lg: jscnet.apply(
        {}, lg, jseg, method='semantic_loss')['loss_semantic_seg'],
        lambda lg: scnet.semantic_loss(lg.permute(0, 3, 1, 2),
                                       tseg)['loss_semantic_seg'], logits)
    assert a != b


def test_glbctx_loss_matches_tpudet():
    rng = np.random.RandomState(5)
    mc = rng.randn(2, NUM_CLASSES).astype(np.float32)
    _, labels, valid = gt_boxes(6)
    jhead = JaxSCNetRoIHead(num_classes=NUM_CLASSES, in_channels=CH)
    head = SCNetRoIHead(NUM_CLASSES, CH)
    _loss_pair(lambda m: jhead.apply({}, m, jnp.asarray(labels),
                                     jnp.asarray(valid),
                                     method='glbctx_loss')['loss_glbctx'],
               lambda m: head.glbctx_loss(m, torch.from_numpy(labels),
                                          torch.from_numpy(valid)
                                          )['loss_glbctx'], mc)


# the detectors

KINDS = ('htc', 'scnet')


def zoo_cfg(kind):
    if kind == 'htc':
        return rcnn_cfg('HybridTaskCascade', dict(
            type='HTCRoIHead', num_semantic_classes=SEM_CLASSES))
    return rcnn_cfg('SCNet', dict(type='SCNetRoIHead',
                                  num_semantic_classes=SEM_CLASSES))


def _build(kind):
    """(kind, cfg, tpudet's model, variables, the port's model)."""
    return (kind, zoo_cfg(kind)) + forward_pair(zoo_cfg(kind), 5)


@pytest.fixture(scope='module')
def htc_pair():
    return _build('htc')


@pytest.fixture(scope='module')
def scnet_pair():
    return _build('scnet')


@pytest.fixture(scope='module', params=KINDS)
def pair(request):
    return request.getfixturevalue(f'{request.param}_pair')


def test_forward_and_masks_match_tpudet(pair):
    kind, _, jmodel, variables, model = pair
    img = images(5)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    assert_close(got, ref)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    res = jax.jit(jmodel.get_bboxes)(ref)
    assert int(np.asarray(res.valid).sum()) >= 10
    if kind == 'htc':  # tpudet's HTC has no test-time mask branch
        from tpudet.apis.test import single_device_test as jax_test
        from tpudet_torch.apis import single_device_test
        assert not hasattr(jmodel, 'predict_masks')
        assert _mask_mode(model) is None
        with pytest.raises(ValueError, match='has no mask branch'):
            jax_test(jmodel, variables, None, with_masks=True,
                     process_count=1)
        with pytest.raises(ValueError, match='has no mask branch'):
            single_device_test(model, None, with_masks=True)
        return
    masks = jax.jit(partial(jmodel.apply, method='predict_masks'))(
        variables, jnp.asarray(img), res.bboxes, res.valid)
    with torch.no_grad():
        got = model.predict_masks(
            torch.from_numpy(img), torch.from_numpy(np.asarray(res.bboxes)),
            torch.from_numpy(np.asarray(res.valid)))
    assert _mask_mode(model) == 'roi'
    assert got.shape == masks.shape == (2, 20, 28, 28, NUM_CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(masks), atol=1e-5)


LOSS_KEYS = {
    'htc': ['loss_semantic_seg'] + [f'loss_{t}_s{i}' for t in
                                    ('cls', 'bbox', 'mask')
                                    for i in range(3)],
    'scnet': ['loss_semantic_seg', 'loss_glbctx', 'loss_mask'] +
             [f'loss_{t}_s{i}' for t in ('cls', 'bbox') for i in range(3)]}


def test_forward_train_losses_match_tpudet_in_float64(pair):
    kind, cfg, _, variables, _ = pair
    batch = mask_batch(23, semantic=True)
    jl, tl = float64_losses(f64_cfg(cfg), variables, batch)
    assert_losses_match(jl, tl, LOSS_KEYS[kind])
    del batch['gt_semantic_seg']  # optional: no semantic loss then
    assert 'loss_semantic_seg' not in assert_trainer_steps(cfg, batch,
                                                           variables)


def _branch_inputs(seed, b=2, p=12, size=IMG):
    """FPN-like NHWC levels of a ``size`` image, the stride-8 embedding,
    valid rois, labels, positives, gt indices and the gts."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(b, size // s, size // s, CH).astype(np.float32)
             for s in (4, 8, 16, 32)]
    sem = rng.randn(b, size // 8, size // 8, CH).astype(np.float32)
    xy = rng.uniform(0, size * 0.6, (b, p, 2))
    wh = rng.uniform(8, size * 0.4, (b, p, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.rand(b, p) > 0.1
    boxes, labels, gt_valid = gt_boxes(seed + 1, b, size=size)
    gt_idx = rng.randint(0, 2, (b, p)).astype(np.int32)
    return dict(feats=feats, sem=sem, rois=rois, valid=valid,
                labels=rng.randint(0, NUM_CLASSES, (b, p)).astype(np.int32),
                pos=rng.rand(b, p) > 0.4, gt_idx=gt_idx, gt_boxes=boxes,
                gt_frame_masks=frame_masks(seed + 2, b))


def _assert_grads(jgrads, tgrads):
    """Gradients by name (tpudet's layout), each within 1e-4 of its
    largest |value|."""
    assert set(tgrads) == set(jgrads)
    for name, r in jgrads.items():
        r = np.asarray(r)
        assert np.abs(tgrads[name] - r).max() <= 1e-4 * np.abs(r).max(), name


def _head_grads(head, names):
    from tpudet_torch.utils.flax_import import _to_flax_layout, leaf_table
    sd = dict(head.named_parameters())
    out = {}
    for path, (key, kind) in leaf_table(head).items():
        if path[0] == 'params' and path[1] in names:
            out['/'.join(path[1:])] = _to_flax_layout(
                sd[key].grad.numpy(), kind)
    return out


def _flat_grads(tree, names):
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                out['/'.join(prefix + (k,))] = np.asarray(v)
    walk({k: tree[k] for k in names}, ())
    return out


def _torch_inputs(x):
    t = {k: (torch.from_numpy(v) if not isinstance(v, list) else
             [torch.from_numpy(f).permute(0, 3, 1, 2) for f in v])
         for k, v in x.items()}
    t['sem'] = t['sem'].permute(0, 3, 1, 2).requires_grad_()
    for f in t['feats']:
        f.requires_grad_()
    return t


def _load_roi_head(model, params):
    """A copy of ``model``'s RoI head holding ``params`` (tpudet's
    ``roi_head`` subtree)."""
    import copy
    head = copy.deepcopy(model.roi_head).train()
    load_flax_variables(head, {'params': params})
    return head


def test_htc_mask_stages_and_their_gradients_match_tpudet(htc_pair):
    """Stages 0 and 1 of the mask branch (semantic crops, the information
    flow into stage 1) and their mask losses, on given features."""
    _, _, jmodel, variables, model = htc_pair
    x = _branch_inputs(7)
    jhead = jmodel.roi_head
    names = ('mask_head0', 'mask_head1', 'mask_info0')
    params = linear_heads(variables['params'])['roi_head']

    def jtotal(p, feats, sem):
        v = {'params': {**params, **p}}
        total = 0.
        prev = None
        for stage in range(2):
            logits, prev = jhead.apply(
                v, stage, tuple(feats), x['rois'], x['valid'], sem, prev,
                method='mask_stage')
            total = total + jhead.apply(
                v, stage, logits, x['rois'], x['pos'], x['gt_idx'],
                x['gt_boxes'], x['gt_frame_masks'], x['labels'],
                method='mask_loss')
        return total
    ref, (jg, jf, js) = jax.jit(jax.value_and_grad(jtotal,
                                                   argnums=(0, 1, 2)))(
        {n: params[n] for n in names}, [jnp.asarray(f) for f in x['feats']],
        jnp.asarray(x['sem']))
    head = _load_roi_head(model, params)
    t = _torch_inputs(x)
    total, prev = 0., None
    for stage in range(2):
        logits, prev = head.mask_stage(stage, t['feats'], t['rois'],
                                       t['valid'], t['sem'], prev)
        total = total + head.mask_loss(stage, logits, t['rois'], t['pos'],
                                       t['gt_idx'], t['gt_boxes'],
                                       t['gt_frame_masks'], t['labels'])
    head.zero_grad()
    total.backward()
    np.testing.assert_allclose(float(total), float(ref), rtol=1e-5)
    _assert_grads(_flat_grads(jg, names), _head_grads(head, names))
    _assert_grads({'sem': js, **{f'f{i}': g for i, g in enumerate(jf)}},
                  {'sem': t['sem'].grad.permute(0, 2, 3, 1).numpy(),
                   **{f'f{i}': f.grad.permute(0, 2, 3, 1).numpy()
                      for i, f in enumerate(t['feats'])}})


def test_scnet_mask_branch_and_its_gradients_match_tpudet(scnet_pair):
    """The mask branch with the semantic crop, the global context and the
    relayed feature, and its loss (weighted as the detector's), on given
    features."""
    _, _, jmodel, variables, model = scnet_pair
    x = _branch_inputs(8)
    rng = np.random.RandomState(9)
    glbctx = rng.randn(2, CH).astype(np.float32)
    relayed = np.abs(rng.randn(2, 12, 1024)).astype(np.float32)
    jhead = jmodel.roi_head
    names = ('mask_head', 'feat_relay_fc')
    params = linear_heads(variables['params'])['roi_head']

    def jtotal(p, feats, sem, g, r):
        v = {'params': {**params, **p}}
        logits = jhead.apply(v, tuple(feats), x['rois'], x['valid'], sem, g,
                             r, method='mask_forward')
        return jhead.apply(v, logits, x['rois'], x['pos'], x['gt_idx'],
                           x['gt_boxes'], x['gt_frame_masks'], x['labels'],
                           weight=1.75, method='mask_loss')['loss_mask']
    ref, (jg, jf, js, jgl, jr) = jax.jit(jax.value_and_grad(
        jtotal, argnums=(0, 1, 2, 3, 4)))(
        {n: params[n] for n in names}, [jnp.asarray(f) for f in x['feats']],
        jnp.asarray(x['sem']), jnp.asarray(glbctx), jnp.asarray(relayed))
    head = _load_roi_head(model, params)
    t = _torch_inputs(x)
    tg = torch.tensor(glbctx, requires_grad=True)
    tr = torch.tensor(relayed, requires_grad=True)
    from tpudet_torch.models.roi_heads.mask_head import mask_bce_loss
    logits = head.mask_forward(t['feats'], t['rois'], t['valid'], t['sem'],
                               tg, tr)
    total = 1.75 * mask_bce_loss(logits, t['rois'], t['pos'], t['gt_idx'],
                                 t['gt_boxes'], t['gt_frame_masks'],
                                 t['labels'], NUM_CLASSES, 28)
    head.zero_grad()
    total.backward()
    np.testing.assert_allclose(float(total), float(ref), rtol=1e-5)
    _assert_grads(_flat_grads(jg, names), _head_grads(head, names))
    _assert_grads({'sem': js, 'glbctx': jgl, 'relayed': jr,
                   **{f'f{i}': g for i, g in enumerate(jf)}},
                  {'sem': t['sem'].grad.permute(0, 2, 3, 1).numpy(),
                   'glbctx': tg.grad.numpy(), 'relayed': tr.grad.numpy(),
                   **{f'f{i}': f.grad.permute(0, 2, 3, 1).numpy()
                      for i, f in enumerate(t['feats'])}})
