"""Training API: counterpart of ``tpudet/apis/train.py``
(``opt_config_from_cfg``, ``train_detector``, ``evaluate_ema``) on one
device, and ``init_trainer``/``Trainer``, one optimizer step on a batch
that the caller provides.

``train_detector`` runs the config's loop: the train set and its loader
(``DetDataLoader`` with the host pipeline, or ``MosaicTileLoader`` and the
on-device augmentation when the config has ``data.device_aug``), the
epoch length that sets the cosine horizon, ``compute_dtype``, the NaN
guard with its dump, tpudet's log line, a train-state checkpoint every
``checkpoint_config.interval`` epochs, resume from the latest one, the
EMA evaluation with ``best_ema.msgpack``, and ``latest_ema.msgpack`` with
the param checksum line at the end. The global batch is ``samples_per_gpu``
times the number of processes, accumulation ``ceil(nominal_batch_size /
global)``.

Several processes (``parallel.init_distributed`` before the call, one
device each) train one model as tpudet's SPMD program does
(``tpudet/apis/train.py:72-327``): each loads its rank-strided shard of
every batch, the train step syncs BatchNorm, the loss denominators and
the gradients, rank 0's train state (its resumed checkpoint, if any) is
broadcast at the start, only rank 0 writes checkpoints and weights (a
barrier follows each write), every rank logs the final param checksum,
and the EMA evaluation runs sharded over the ranks.

A detector with ``forward_train`` (the two-stage family, ``FastRCNN``,
the KD detector with its frozen teacher) trains through it
(``tpudet/apis/train.py:167-196``): its arguments are
taken from the batch by name, a required name missing from the batch
raises, and the total is the sum of the keys that contain ``loss``.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``;
with no GPU they raise rather than run on the CPU.
"""
from __future__ import annotations

import contextlib
import inspect
import math
import os
import os.path as osp
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..data.dataset import build_dataset
from ..data.device_aug import DeviceAug
from ..data.loader import DetDataLoader, MosaicTileLoader
from ..evaluation.mean_ap import coco_fast_bbox_eval
from ..models.builder import build_detector
from ..parallel.mesh import (barrier, broadcast_, process_count,
                             process_index)
from ..train.optim import YoloSGDConfig
from ..train.train_state import (TrainState, create_train_state,
                                  make_train_step, model_losses)
from ..utils.checkpoint import (latest_step, load_train_state,
                                save_train_state, save_variables)
from ..utils.device import resolve_device, to_device
from ..utils.flax_import import (load_flax_variables, random_flax_variables,
                                 train_state_to_flax)
from ..utils.logging import get_root_logger
from .test import single_device_test

BATCH_KEYS = ('img', 'gt_bboxes', 'gt_labels', 'gt_valid')
# a MosaicTileLoader batch; aug_seed stays on the host, where the draws
# are made
TILE_KEYS = ('tiles', 'tile_hw', 'gt_bboxes', 'gt_labels', 'gt_valid',
             'aug_seed')


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
    """A model, its train state and its train step on one device (one
    rank's, under a process group)."""

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
        # a forward_train model's batch names, in its signature's order
        self.batch_keys = (tuple(forward_train_params(model))
                           if hasattr(model, 'forward_train') else None)

    def step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch``: ``img`` (B, H, W, 3) normalized,
        ``gt_bboxes`` (B, G, 4) xyxy, ``gt_labels`` (B, G), ``gt_valid``
        (B, G); or, for a config with ``data.device_aug``, a
        ``MosaicTileLoader`` batch (``TILE_KEYS``); for a model with
        ``forward_train``, the entries named by its parameters
        (``FastRCNN`` also takes ``proposals`` and ``prop_valid``). Numpy
        arrays or tensors, B = samples_per_gpu * accumulation. Returns the
        step's metrics (0-d tensors on the device). Every
        ``nan_guard.interval`` steps a non-finite loss or gradient norm
        raises ``FloatingPointError``."""
        if self.steps >= self.max_steps:
            raise RuntimeError(f'the schedule ends at max_steps='
                               f'{self.max_steps}')
        keys = self.batch_keys or (TILE_KEYS if 'tiles' in batch
                                   else BATCH_KEYS)
        batch = {k: torch.as_tensor(batch[k]) if k == 'aug_seed'
                 else to_device(batch[k], self.device) for k in keys
                 if k in batch}
        n = batch[keys[0]].shape[0]
        if n % self.accumulation:
            raise ValueError(f'batch of {n} images does not split into '
                             f'{self.accumulation} micro-batches')
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


def forward_train_params(model):
    """The parameters of ``model.forward_train``, by name."""
    return inspect.signature(model.forward_train).parameters


def forward_train_loss(model):
    """tpudet's ``forward_train`` loss path (``tpudet/apis/train.py:
    167-196``): the loss dict of ``model.forward_train`` called with the
    micro-batch's entries by parameter name. An optional parameter missing
    from the batch ends the arguments; a required one raises
    ``TypeError``."""
    params = forward_train_params(model)

    def loss_fn(micro):
        args = []
        for name, p in params.items():
            if name in micro:
                args.append(micro[name])
            elif p.default is not inspect.Parameter.empty:
                break
            else:
                raise TypeError(
                    f"forward_train of {type(model).__name__} requires "
                    f"parameter '{name}' but the batch only provides "
                    f"{sorted(micro)}")
        return model.forward_train(*args)
    return loss_fn


def _accumulation(cfg: Config) -> int:
    """Micro-batches per optimizer step: the nominal batch over the
    global batch, ``samples_per_gpu`` on every process."""
    global_batch = cfg['data'].get('samples_per_gpu', 8) * process_count()
    nominal = cfg.get('nominal_batch_size', global_batch)
    return max(1, -(-nominal // global_batch))


def _build_trainer(cfg: Config, variables: Optional[Dict],
                   device: torch.device, total_steps: int,
                   steps_per_epoch: int) -> Trainer:
    """The model (``compute_dtype`` honoured, weights from ``variables`` or
    tpudet's init from numpy seed ``cfg.seed``), its train state and step
    (the warm-up and EMA hooks, the on-device augmentation of a
    ``data.device_aug`` config) and the NaN guard's interval."""
    accumulation = _accumulation(cfg)
    opt_cfg = opt_config_from_cfg(cfg, total_steps, steps_per_epoch,
                                  accumulation)
    with device:  # parameters made, and weights copied, on the device
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
    loss_fn = None
    if hasattr(model, 'forward_train'):
        loss_fn = forward_train_loss(model)
    elif cfg['data'].get('device_aug') is not None:
        augment = DeviceAug(**{
            'out_size': cfg['data'].get('train_img_size', 640),
            **cfg['data']['device_aug']})

        def loss_fn(micro):
            with torch.no_grad():
                aug = augment(micro)
            return model_losses(model, aug)
    # EMA fires once per optimizer step; with `step` counting optimizer
    # steps the reference's warm-up curve reduces to interval 1
    train_step = make_train_step(
        model, opt_cfg,
        ema_momentum_base=ema_cfg.get('momentum', 0.9999),
        ema_warm_up=ema_cfg.get('warm_up', 2000),
        ema_interval=1,
        accumulation=accumulation,
        loss_fn=loss_fn)
    state = create_train_state(model, opt_cfg)
    nan_guard = cfg.get('nan_guard', dict(enabled=True, interval=50))
    nan_interval = max(int(nan_guard.get('interval', 50)), 1) \
        if nan_guard.get('enabled', True) else 0
    return Trainer(model, state, train_step, opt_cfg, accumulation,
                   total_steps, nan_interval)


def init_trainer(config: Union[str, Config],
                 variables: Optional[Dict] = None,
                 device: Union[str, torch.device] = 'cuda',
                 max_steps: Optional[int] = None) -> Trainer:
    """A ``Trainer`` for a config file or ``Config``, from tpudet
    ``variables`` (``{'params', 'batch_stats'}`` numpy tree) or, without
    them, tpudet's init drawn from numpy seed ``cfg.seed``, on ``device``.

    The global batch is ``samples_per_gpu`` on each process (one, or the
    ranks of an open process group) and the step accumulates
    ``ceil(nominal_batch_size / global batch)`` micro-batches; the
    caller gives each rank its own shard of a step's batch.
    ``max_steps`` is the schedule's horizon (the cosine runs per step over
    it); ``train_detector`` takes it from its loader instead.
    ``compute_dtype='bfloat16'`` computes the forward in bf16 with fp32
    master weights and an fp32 loss.
    """
    device = resolve_device(device)
    cfg = Config.fromfile(config) if isinstance(config, str) else config
    if max_steps is None:
        raise ValueError('init_trainer needs max_steps, the schedule\'s '
                         'horizon; train_detector takes it from the loader')
    return _build_trainer(cfg, variables, device, max_steps, 0)


@contextlib.contextmanager
def ema_swapped_in(state: TrainState):
    """The EMA weights and BN statistics in the model's own tensors for
    the duration (the reference's EMA swap); the live ones are put back
    after."""
    live = {k: v.detach().clone() for k, v in state.params.items()}
    live_bs = {k: v.clone() for k, v in state.batch_stats.items()}
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(state.ema_params[k])
        for k, b in state.batch_stats.items():
            b.copy_(state.ema_batch_stats[k])
    try:
        yield
    finally:
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(live[k])
            for k, b in state.batch_stats.items():
                b.copy_(live_bs[k])


def evaluate_ema(cfg: Config, trainer: Trainer, logger) -> Dict:
    """Evaluate the EMA weights on ``data.val``
    (``tpudet/apis/train.py:334-348``): ``single_device_test`` at batch
    ``samples_per_gpu`` on the trainer's device, each rank on its shard of
    the set and every rank with the gathered results, then
    ``coco_fast_bbox_eval``."""
    val_dataset = build_dataset({**cfg['data']['val'], 'test_mode': True},
                                dict(device=trainer.device))
    with ema_swapped_in(trainer.state):
        results = single_device_test(
            trainer.model, val_dataset,
            batch_size=cfg['data'].get('samples_per_gpu', 8),
            progress=False, process_index=process_index(),
            process_count=process_count())
    annotations = [
        val_dataset.get_ann_info_test(i) for i in range(len(val_dataset))
    ]
    report = coco_fast_bbox_eval(results, annotations,
                                 classes=val_dataset.CLASSES)
    logger.info('eval: ' + ' '.join(f'{k}={v:.4f}' for k, v in report.items()))
    return report


def ema_variables(trainer: Trainer) -> Dict:
    """The EMA weights as a tpudet ``{'params', 'batch_stats'}`` tree."""
    flax = train_state_to_flax(trainer.state, trainer.model)
    return {'params': flax.ema_params, 'batch_stats': flax.ema_batch_stats}


def train_state_tensors(state: TrainState):
    """Every tensor of a train state: the step, params, BN statistics,
    their EMA copies and the optimizer's buffers."""
    return ([state.step] + list(state.params.values()) +
            list(state.batch_stats.values()) +
            list(state.ema_params.values()) +
            list(state.ema_batch_stats.values()) +
            list(state.opt_state.momentum_buf.values()))


def train_detector(cfg: Config,
                   work_dir: str,
                   max_steps: Optional[int] = None,
                   resume: bool = True,
                   eval_interval: Optional[int] = None,
                   device: Union[str, torch.device] = 'cuda',
                   variables: Optional[Dict] = None) -> Dict[str, float]:
    """Config-driven training on ``device`` (``tpudet/apis/train.py:
    72-327``); ``variables`` (a tpudet ``{'params', 'batch_stats'}`` tree)
    replace tpudet's init from ``cfg.seed``. Writes ``train.log`` into
    ``work_dir`` and, on rank 0, ``ckpts/<step>/``, ``best_ema.msgpack``
    and ``latest_ema.msgpack``. Under a process group each rank calls it
    with its own device; rank 0's ``work_dir`` holds the checkpoints, and
    a resume reads them there. Returns the last step's metrics."""
    device = resolve_device(device)
    rank, n_proc = process_index(), process_count()
    os.makedirs(work_dir, exist_ok=True)  # every rank logs locally
    logger = get_root_logger(osp.join(work_dir, 'train.log'))

    dataset = build_dataset(cfg['data']['train'], dict(device=device))
    if len(dataset) == 0:
        raise ValueError(
            'training dataset is empty after filtering — check ann_file '
            'paths and that the dataset `classes` match the annotation '
            'category names (unknown categories are silently dropped)')
    global_batch = cfg['data'].get('samples_per_gpu', 8) * n_proc
    max_epochs = cfg.get('runner', {}).get('max_epochs', 300)
    accumulation = _accumulation(cfg)
    # each rank loads its rank-strided shard of every step's batch
    loader_batch = global_batch * accumulation // n_proc
    shard = dict(process_index=rank, process_count=n_proc)

    if cfg['data'].get('device_aug') is not None:
        loader = MosaicTileLoader(
            dataset, batch_size=loader_batch,
            tile_size=cfg['data'].get('train_img_size', 640),
            max_gts_per_tile=cfg['data'].get('max_gts', 120) // 4, **shard)
    else:
        loader = DetDataLoader(
            dataset, batch_size=loader_batch,
            max_gts=cfg['data'].get('max_gts', 120),
            img_size=cfg['data'].get('train_img_size', 640), **shard)
    steps_per_epoch = len(loader)
    if steps_per_epoch == 0:
        # a silently-empty loader would spin the epoch loop doing
        # eval-only passes forever
        raise ValueError(
            f'training loader yields 0 steps/epoch: dataset has '
            f'{len(dataset)} samples but the global batch is '
            f'{global_batch * accumulation} (samples_per_gpu x processes x '
            f'accumulation). Shrink the batch/accumulation or check that '
            f'`classes` matches the annotation categories.')
    total_steps = steps_per_epoch * max_epochs
    if max_steps is not None:
        total_steps = min(total_steps, max_steps)
    logger.info(
        f'devices {n_proc} global / 1 local, process {rank}/{n_proc}, '
        f'device {device}'
        + (f' ({torch.cuda.get_device_name(device)})'
           if device.type == 'cuda' else '')
        + f', global batch {global_batch} x accumulation {accumulation}')

    trainer = _build_trainer(cfg, variables, device, total_steps,
                             steps_per_epoch)
    ckpt_dir = osp.join(work_dir, 'ckpts')
    last = latest_step(ckpt_dir) if resume and rank == 0 else None
    if last is not None:
        trainer.state = load_train_state(ckpt_dir, trainer.model,
                                         trainer.opt_cfg, last)
    # every rank starts from rank 0's state: its init, or its checkpoint
    broadcast_(train_state_tensors(trainer.state))
    start_step = int(trainer.state.step)
    if start_step:
        trainer.steps = start_step
        logger.info(f'resumed from step {start_step}')

    ckpt_interval_epochs = cfg.get('checkpoint_config', {}).get('interval', 5)
    eval_interval = eval_interval if eval_interval is not None else cfg.get(
        'evaluation', {}).get('interval', 1)
    log_interval = cfg.get('log_config', {}).get('interval', 50)

    metrics = {}
    step = start_step
    best_map = -1.0
    t0 = time.time()
    # a run resumed at its horizon takes no step (tpudet would take one)
    first_epoch = start_step // steps_per_epoch \
        if start_step < total_steps else max_epochs
    for epoch in range(first_epoch, max_epochs):
        loader.set_epoch(epoch)
        with contextlib.closing(iter(loader)) as batches:
            for batch in batches:
                try:
                    metrics = trainer.step(batch)
                except FloatingPointError as e:
                    # NaN guard (on the metrics summed over the ranks, so
                    # every rank trips at once): dump the state and stop,
                    # rather than train on poisoned gradients
                    logger.error(f'NaN guard tripped: {e}')
                    if rank == 0:
                        save_train_state(osp.join(work_dir, 'nan_dump'),
                                         trainer.state, trainer.model,
                                         trainer.steps)
                    raise FloatingPointError(
                        f'{e}; state dumped to {work_dir}/nan_dump') from e
                step += 1
                if step % log_interval == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    rate = (log_interval * global_batch * accumulation /
                            (time.time() - t0))
                    t0 = time.time()
                    parts = ' '.join(
                        f'{k[5:] if k.startswith("loss_") else k} {v:.4f}'
                        for k, v in sorted(m.items())
                        if 'loss' in k and k != 'loss')
                    logger.info(
                        f'epoch {epoch} step {step}/{total_steps} '
                        f'loss {m["loss"]:.4f} ({parts}) '
                        f'lr {m["lr"]:.5f} gnorm {m["grad_norm"]:.2f} '
                        f'img/s {rate:.1f}')
                if max_steps is not None and step >= max_steps:
                    break
        if (epoch + 1) % ckpt_interval_epochs == 0:
            if rank == 0:
                save_train_state(ckpt_dir, trainer.state, trainer.model,
                                 step)
            barrier()
        if eval_interval and (epoch + 1) % eval_interval == 0 and \
                'val' in cfg.get('data', {}):
            report = evaluate_ema(cfg, trainer, logger)
            # best-checkpoint tracking (reference eval_hooks.py:160); the
            # gathered report is equal on every rank
            cur = report.get('map', float('nan'))
            if np.isfinite(cur) and cur > best_map:
                best_map = cur
                if rank == 0:
                    save_variables(osp.join(work_dir, 'best_ema.msgpack'),
                                   ema_variables(trainer),
                                   meta=dict(step=step, map=cur,
                                             CLASSES=list(dataset.CLASSES)))
                barrier()
                logger.info(f'new best map {cur:.4f} at step {step}')
        if max_steps is not None and step >= max_steps:
            break

    # every rank logs a checksum over its final params: equal checksums
    # show equal states, across the ranks of a run and across runs
    checksum = sum(float(p.detach().double().abs().sum())
                   for p in trainer.state.params.values())
    logger.info(f'final param checksum {checksum:.9e} at step {step}')
    # publish EMA weights for inference
    if rank == 0:
        save_variables(osp.join(work_dir, 'latest_ema.msgpack'),
                       ema_variables(trainer),
                       meta=dict(step=step, CLASSES=list(dataset.CLASSES)))
    barrier()
    return {k: float(v) for k, v in metrics.items()}
