"""Training API: counterpart of ``tpudet/apis/train.py`` up to the train
step (``opt_config_from_cfg``, ``init_trainer``, ``Trainer``).

``init_trainer`` does what ``train_detector`` does between the data loader
and the checkpoints: it builds the model (honouring ``compute_dtype``),
derives the gradient accumulation from ``nominal_batch_size``, reads the
warm-up and EMA hooks of the config, builds the train state from tpudet
variables and runs the NaN guard. ``Trainer.step`` takes one optimizer
step on a batch that the caller provides. The data loader, checkpoints,
evaluation and ``train_detector`` itself come with later slices
(ROADMAP.md). Entry points run on ``cuda`` unless the caller passes
``device='cpu'``; with no GPU they raise rather than run on the CPU.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch

from ..config import Config
from ..models.builder import build_detector
from ..train.optim import YoloSGDConfig
from ..train.train_state import (TrainState, create_train_state,
                                  make_train_step)
from ..utils.device import resolve_device
from ..utils.flax_import import load_flax_variables, random_flax_variables

BATCH_KEYS = ('img', 'gt_bboxes', 'gt_labels', 'gt_valid')


def opt_config_from_cfg(cfg: Config, total_steps: int,
                        steps_per_epoch: int,
                        accumulation: int = 1) -> YoloSGDConfig:
    """The optimizer and schedule settings of a config
    (``tpudet/apis/train.py:35-69``)."""
    opt = cfg.get('optimizer', {})
    lr_cfg = cfg.get('lr_config', {})
    warm = {}
    for hook in cfg.get('custom_hooks', []):
        if hook.get('type') == 'DetailedLinearWarmUpHook':
            warm = hook
    clip = cfg.get('optimizer_config', {}).get('grad_clip', {}) or {}
    policy = lr_cfg.get('policy', 'CosineAnnealing').lower()
    policy = {'cosineannealing': 'cosine', 'step': 'step',
              'fixed': 'fixed'}.get(policy, 'cosine')
    decay_epochs = lr_cfg.get('step', ())
    opt_type = str(opt.get('type', 'SGD')).lower()
    return YoloSGDConfig(
        lr=opt.get('lr', 0.01),
        momentum=opt.get('momentum', 0.937),
        weight_decay=opt.get('weight_decay',
                             0.0 if opt_type == 'adam' else 5e-4),
        nesterov=opt.get('nesterov', True),
        opt_type='adam' if opt_type in ('adam', 'adamw') else 'sgd',
        policy=policy,
        decay_steps=tuple(e * steps_per_epoch for e in decay_epochs),
        gamma=lr_cfg.get('gamma', 0.1),
        total_steps=total_steps,
        min_lr_ratio=lr_cfg.get('min_lr_ratio', 0.2),
        # the config's warmup_iters counts data iterations; the step counts
        # optimizer steps (one per `accumulation` data iterations)
        warmup_iters=max(1, warm.get('warmup_iters', 10000) // accumulation),
        lr_weight_warmup_ratio=warm.get('lr_weight_warmup_ratio', 0.),
        lr_bias_warmup_ratio=warm.get('lr_bias_warmup_ratio', 10.),
        momentum_warmup_ratio=warm.get('momentum_warmup_ratio', 0.95),
        grad_clip_norm=clip.get('max_norm', 35.0),
        steps_per_epoch=steps_per_epoch)


class Trainer:
    """A model, its train state and its train step on one device."""

    def __init__(self, model, state: TrainState, train_step,
                 opt_cfg: YoloSGDConfig, accumulation: int, max_steps: int,
                 nan_interval: int):
        self.model = model
        self.state = state
        self.train_step = train_step
        self.opt_cfg = opt_cfg
        self.accumulation = accumulation
        self.max_steps = max_steps
        self.nan_interval = nan_interval
        self.device = next(model.parameters()).device
        self.steps = 0

    def step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch``: ``img`` (B, H, W, 3) normalized,
        ``gt_bboxes`` (B, G, 4) xyxy, ``gt_labels`` (B, G), ``gt_valid``
        (B, G); numpy arrays or tensors, B = samples_per_gpu *
        accumulation. Returns the step's metrics (0-d tensors on the
        device). Every ``nan_guard.interval`` steps a non-finite loss or
        gradient norm raises ``FloatingPointError``."""
        if self.steps >= self.max_steps:
            raise RuntimeError(f'the schedule ends at max_steps='
                               f'{self.max_steps}')
        batch = {k: torch.as_tensor(batch[k]).to(self.device,
                                                 non_blocking=True)
                 for k in BATCH_KEYS}
        if batch['img'].shape[0] % self.accumulation:
            raise ValueError(f'batch of {batch["img"].shape[0]} images does '
                             f'not split into {self.accumulation} '
                             f'micro-batches')
        self.state, metrics = self.train_step(self.state, batch)
        self.steps += 1
        if self.nan_interval and self.steps % self.nan_interval == 0:
            loss, gnorm = float(metrics['loss']), float(metrics['grad_norm'])
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                bad = ' '.join(f'{k}={float(v)}' for k, v in metrics.items())
                raise FloatingPointError(
                    f'non-finite training metrics at step {self.steps}: '
                    f'{bad}')
        return metrics


def init_trainer(config: Union[str, Config],
                 variables: Optional[Dict] = None,
                 device: Union[str, torch.device] = 'cuda',
                 max_steps: Optional[int] = None) -> Trainer:
    """A ``Trainer`` for a config file or ``Config``, from tpudet
    ``variables`` (``{'params', 'batch_stats'}`` numpy tree) or, without
    them, tpudet's init drawn from numpy seed ``cfg.seed``, on ``device``.

    One device: the global batch is ``samples_per_gpu`` and the step
    accumulates ``ceil(nominal_batch_size / samples_per_gpu)``
    micro-batches. ``max_steps`` is the schedule's horizon (the cosine
    runs per step over it): the epoch length comes with the data loader,
    so until then it is required. ``compute_dtype='bfloat16'`` computes
    the forward in bf16 with fp32 master weights and an fp32 loss.
    """
    device = resolve_device(device)
    cfg = Config.fromfile(config) if isinstance(config, str) else config
    if max_steps is None:
        raise ValueError('init_trainer needs max_steps: the epoch length '
                         'that sets the schedule comes with the data loader')
    global_batch = cfg['data'].get('samples_per_gpu', 8)
    nominal = cfg.get('nominal_batch_size', global_batch)
    accumulation = max(1, -(-nominal // global_batch))
    opt_cfg = opt_config_from_cfg(cfg, max_steps, 0, accumulation)

    model = build_detector(cfg['model'])
    if variables is None:
        variables = random_flax_variables(model, seed=cfg.get('seed', 0))
    load_flax_variables(model, variables)
    model.to(device=device, memory_format=torch.channels_last)
    # the trainer leaves the conv weights in fp32; each conv casts them
    model.dtype = {'bfloat16': torch.bfloat16}.get(
        cfg.get('compute_dtype'), torch.float32)

    ema_cfg = {}
    for hook in cfg.get('custom_hooks', []):
        if hook.get('type') == 'StateEMAHook':
            ema_cfg = hook
    # EMA fires once per optimizer step; with `step` counting optimizer
    # steps the reference's warm-up curve reduces to interval 1
    train_step = make_train_step(
        model, opt_cfg,
        ema_momentum_base=ema_cfg.get('momentum', 0.9999),
        ema_warm_up=ema_cfg.get('warm_up', 2000),
        ema_interval=1,
        accumulation=accumulation)
    state = create_train_state(model, opt_cfg)
    nan_guard = cfg.get('nan_guard', dict(enabled=True, interval=50))
    nan_interval = max(int(nan_guard.get('interval', 50)), 1) \
        if nan_guard.get('enabled', True) else 0
    return Trainer(model, state, train_step, opt_cfg, accumulation,
                   max_steps, nan_interval)
