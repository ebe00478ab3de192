"""Localization distillation in tpudet_torch against tpudet, on the CPU:
``LDHead``, ``KnowledgeDistillationSingleStageDetector``, its teacher
built from ``teacher_config``, and its training path.

The detector: a student ResNet-18 of 16 base channels and a teacher
ResNet-18, each with an FPN of 32 channels from c3 (extra convs on the
input) and one stacked conv, 5 classes, ``reg_max`` 8; the teacher is a
``GFL`` config written to a temporary file and named by an absolute
``teacher_config``. Images of 64 px, batches of 2.

Tolerances, as ``test_torch_atss_gfl.py`` holds GFL:

- ``loss_with_teacher`` on tpudet's pred maps (student and teacher): each
  term rtol 1e-5, the gradients with respect to the student's maps rtol
  1e-5 (atol 1e-5 of the largest |value|); none reaches the teacher's;
- one train step in float64 on both sides, from tpudet's init through
  ``forward_train`` (the step's loss through it too, as tpudet's
  ``train_detector`` takes it): the losses (``loss_ld`` among them) and
  the gradient norm rtol 1e-4, the state within 5e-3 of the change the
  step made; the teacher's gradient is 0 in both; its BatchNorm
  statistics equal the initial ones exactly in both (eval mode: running
  statistics, never updated); its conv kernels move by the weight decay
  alone: the port's float64 weights by ``-lr * wd * p`` (rtol 1e-6),
  tpudet's (which updates the fp32-rounded weight and stores the result in
  fp32, even in a float64 run) within 5 % of it, the two within one fp32
  ulp of each other; its biases, BatchNorm and scales do not move;
- ``init_trainer`` with ``compute_dtype='bfloat16'``: the student's maps
  bf16, the teacher's computed in fp32 with fp32 parameters, the teacher
  in eval mode during the step and its statistics unchanged; ``set_dtype``
  for inference casts the student only;
- inference from tpudet's ``init`` tree (no teacher subtree): the
  student's maps equal tpudet's (1e-4 of the largest |value|), the
  teacher never runs; a tree with part of the teacher is refused.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models.builder import build_detector as jax_build_detector
from tpudet_torch.apis import init_detector, init_trainer
from tpudet_torch.config import Config
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.dense_heads import (
    KnowledgeDistillationSingleStageDetector, LDHead)
from tpudet_torch.utils.flax_import import (flax_to_state_dict,
                                            load_flax_variables,
                                            random_flax_variables)

from .test_torch_atss_gfl import (NUM_CLASSES, OPT, TEST_CFG,
                                  assert_loss_and_map_gradients,
                                  assert_maps_close, assert_step_matches,
                                  float64_step, gts, images, step_batch)
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 64
KEYS = ('loss_cls', 'loss_bbox', 'loss_dfl', 'loss_ld')
TEACHER = ('teacher_backbone', 'teacher_neck', 'teacher_bbox_head')


def _fpn(in_channels):
    return dict(type='FPN', in_channels=in_channels, out_channels=32,
                start_level=1, num_outs=5, add_extra_convs='on_input')


def _head(kind):
    return dict(type=kind, num_classes=NUM_CLASSES, in_channels=32,
                feat_channels=32, stacked_convs=1, reg_max=8)


TEACHER_CFG = dict(
    type='GFL', backbone=dict(type='ResNet', depth=18,
                              out_indices=[0, 1, 2, 3]),
    neck=_fpn([64, 128, 256, 512]), bbox_head=_head('GFLHead'),
    test_cfg=TEST_CFG)


@pytest.fixture(scope='module')
def ld_cfg(tmp_path_factory):
    """The narrow LD model dict; its teacher's config in a file."""
    path = str(tmp_path_factory.mktemp('teacher') / 'gfl_teacher.py')
    with open(path, 'w') as f:
        f.write(f'model = {TEACHER_CFG!r}\n')
    return dict(
        type='KnowledgeDistillationSingleStageDetector',
        teacher_config=path, teacher_ckpt='a converted checkpoint',
        backbone=dict(type='ResNet', depth=18, base_channels=16,
                      out_indices=[0, 1, 2, 3]),
        neck=_fpn([16, 32, 64, 128]), bbox_head=_head('LDHead'),
        test_cfg=TEST_CFG)


def test_the_shipped_teacher_builds_from_the_repo_root(monkeypatch,
                                                       tmp_path):
    """``configs/ld/``'s relative ``teacher_config`` resolves against the
    checkout that holds ``tpudet_torch/``, wherever the process runs; the
    teacher is the R-101 GFL of that config, ``teacher_ckpt`` dropped."""
    monkeypatch.chdir(tmp_path)
    cfg = Config.fromfile(os.path.join(
        ROOT, 'configs/ld/ld_r18_gflv1_r101_fpn_coco_1x.py'))['model']
    assert not os.path.isabs(cfg['teacher_config'])
    with torch.device('meta'):
        model = build_detector(cfg)
    assert type(model) is KnowledgeDistillationSingleStageDetector
    assert type(model.bbox_head) is LDHead
    assert type(model.teacher_bbox_head).__name__ == 'GFLHead'
    def blocks(backbone, stage):
        return sum(name.startswith(f'layer{stage}_')
                   for name, _ in backbone.named_children())
    assert blocks(model.teacher_backbone, 3) == 23  # ResNet-101
    assert blocks(model.backbone, 3) == 2  # the ResNet-18 student
    assert not hasattr(model, 'teacher_ckpt')


def test_loss_with_teacher_matches_tpudet(ld_cfg):
    """``loss_with_teacher`` on random student and teacher maps (the
    teacher's logits drawn apart from the student's)."""
    jmodel = jax_build_detector(ld_cfg)
    model = build_detector(ld_cfg)
    rng = np.random.RandomState(40)
    sizes = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]

    def maps(width, scale):
        return tuple((rng.randn(2, h, w, width) * scale).astype(np.float32)
                     for h, w in sizes)
    student = (maps(NUM_CLASSES, 2.0), maps(36, 2.0))
    teacher = (maps(NUM_CLASSES, 2.0), maps(36, 3.0))
    boxes, labels, valid = gts(41, size=IMG)

    class Both:
        """The two packages' ``loss_with_teacher`` as the helper's
        ``loss``, the teacher's maps fixed."""
        def __init__(self, head, wrap):
            self.head, self.wrap = head, wrap

        def loss(self, preds, *args):
            return self.head.loss_with_teacher(preds, self.wrap(teacher),
                                               *args)
    tl = assert_loss_and_map_gradients(
        Both(jmodel.bbox_head, lambda t: jax.tree.map(jnp.asarray, t)),
        Both(model.bbox_head, lambda t: tuple(tuple(
            torch.from_numpy(a) for a in lvl) for lvl in t)),
        student, boxes, labels, valid, KEYS)
    assert float(tl['loss_ld']) > 0


@pytest.fixture(scope='module')
def step(ld_cfg):
    return float64_step(ld_cfg, step_batch(42), forward_train=True)


def _teacher(tree):
    """The teacher's leaves of a tpudet tree, by path."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                out['/'.join(prefix + (k,))] = np.asarray(v)
    walk({k: tree[k] for k in TEACHER if k in tree}, ())
    return out


def test_a_train_step_matches_tpudet_in_float64(step):
    state0, jstate, jm, tstate, tm, model = step
    assert_step_matches(state0, jstate, jm, tstate, tm, KEYS)
    assert jm['loss_ld'] > 0
    # no gradient reached the teacher: none in the port, zeros in tpudet
    # (its momentum buffers hold weight decay alone)
    assert all(p.grad is None for name in TEACHER
               for p in getattr(model, name).parameters())
    bufs = _teacher(jstate.opt_state.momentum_buf)
    for path, p0 in _teacher(state0.params).items():
        wd = OPT['weight_decay'] if path.endswith('kernel') else 0.
        # tpudet decays the fp32-rounded weight, even in a float64 run
        np.testing.assert_allclose(bufs[path], wd * p0, rtol=1e-6,
                                   err_msg=path)


def test_the_teacher_is_frozen_but_decays_as_in_tpudet(step):
    state0, jstate, _, tstate, _, model = step
    lr, wd = OPT['lr'], OPT['weight_decay']
    for what in ('batch_stats', 'ema_batch_stats'):
        ref = _teacher(getattr(state0, what))
        assert len(ref) > 20
        for tree in (jstate, tstate):
            got = _teacher(getattr(tree, what))
            assert set(got) == set(ref)
            for path, r in ref.items():
                np.testing.assert_array_equal(got[path], r, err_msg=path)
    jparams, tparams = _teacher(jstate.params), _teacher(tstate.params)
    kernels = 0
    for path, p0 in _teacher(state0.params).items():
        pj, pt = jparams[path], tparams[path]
        if path.endswith('kernel'):  # the 'weight' group: decayed
            kernels += 1
            np.testing.assert_allclose(pj - p0, -lr * wd * p0, rtol=0.05,
                                       err_msg=path)
            # tpudet updates the fp32-rounded weight and stores the result
            # rounded to fp32, even in a float64 run; the port's tree is
            # rounded to fp32 too: one fp32 ulp apart
            ulp = np.spacing(np.abs(p0).astype(np.float32)).astype(
                np.float64)
            assert (np.abs(pt - pj) <= ulp).all(), path
        else:  # biases, BN scales, the level scales: no decay, no gradient
            np.testing.assert_array_equal(pj, p0, err_msg=path)
            np.testing.assert_array_equal(pt, p0, err_msg=path)
    assert kernels > 20
    # the port's own float64 weights: the decay, exactly
    init = flax_to_state_dict({'params': state0.params,
                               'batch_stats': state0.batch_stats}, model)
    for name, p in model.named_parameters():
        if name.startswith('teacher_') and p.dim() == 4:
            p0 = init[name].double()
            torch.testing.assert_close(p.detach() - p0, -lr * wd * p0,
                                       rtol=1e-6, atol=0)
    assert not model.teacher_backbone.training and model.backbone.training


def test_bf16_training_keeps_the_teacher_fp32_and_in_eval_mode(ld_cfg):
    cfg = Config(dict(model=ld_cfg, data=dict(samples_per_gpu=2),
                      compute_dtype='bfloat16', nominal_batch_size=2,
                      optimizer=dict(lr=0.01, momentum=0.9,
                                     weight_decay=1e-4)))
    trainer = init_trainer(cfg, device='cpu', max_steps=3)
    model = trainer.model
    stats0 = {k: v.clone() for k, v in model.state_dict().items()
              if k.startswith('teacher_') and 'running' in k}
    seen = {}

    def record(name):
        def hook(mod, args, out):
            seen[name] = (out[0][0].dtype, mod.training,
                          next(mod.parameters()).dtype)
        return hook
    hooks = [model.bbox_head.register_forward_hook(record('student')),
             model.teacher_bbox_head.register_forward_hook(
                 record('teacher'))]
    batch = step_batch(43)
    batch['img'] = batch['img'].astype(np.float32)
    try:
        metrics = trainer.step(batch)
    finally:
        for h in hooks:
            h.remove()
    assert np.isfinite(float(metrics['loss_ld']))
    assert seen['student'] == (torch.bfloat16, True, torch.float32)
    assert seen['teacher'] == (torch.float32, False, torch.float32)
    for k, v in stats0.items():
        assert torch.equal(model.state_dict()[k], v), k
    model.set_dtype(torch.bfloat16)
    assert model.bbox_head.gfl_cls.weight.dtype == torch.bfloat16
    assert model.backbone.stem_conv.weight.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for name in TEACHER
               for p in getattr(model, name).parameters())


def test_inference_loads_tpudets_init_tree_and_never_runs_the_teacher(
        ld_cfg):
    jmodel = jax_build_detector(ld_cfg)
    img = images(44, size=IMG)
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(1), jnp.asarray(img)))
    assert not set(TEACHER) & set(variables['params'])
    det = init_detector(ld_cfg, variables=variables, device='cpu',
                        dtype=torch.float32)
    calls = []
    hook = det.model.teacher_backbone.register_forward_pre_hook(
        lambda *a: calls.append(1))
    try:
        got = det.forward(img)
        det(img)
    finally:
        hook.remove()
    assert not calls
    assert_maps_close(got, jax.jit(jmodel.apply)(variables, jnp.asarray(img)))
    # a tree with some of the teacher must hold all of it
    model = build_detector(ld_cfg)
    full = random_flax_variables(model, seed=3)
    for c in ('params', 'batch_stats'):
        full[c].pop('teacher_neck', None)
    with pytest.raises(KeyError, match='teacher_neck'):
        load_flax_variables(model, full)
