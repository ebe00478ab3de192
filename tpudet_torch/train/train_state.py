"""Train state and the train step: port of ``tpudet/train/train_state.py``.

One optimizer step, as tpudet's ``make_train_step`` computes it: the batch
is split into ``accumulation`` micro-batches, each runs forward, loss and
backward in turn, their gradients are **summed** (PyTorch accumulates
``.grad``), BN statistics update per micro-batch; then clip, SGD with the
warm-up schedules, and the EMA fold over params and BN statistics.

PyTorch idiom in place of the pure function: the state holds the model's
own parameter and buffer tensors, and the step updates them in place, so
the model always computes with the state it is given.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from .ema import ema_momentum, ema_update
from .optim import SGDState, YoloSGDConfig, make_yolo_sgd, param_labels


@dataclass
class TrainState:
    """Everything a step reads and writes, as tensors on the device.

    ``params`` and ``batch_stats`` are the model's own parameters and
    buffers (``running_mean``, ``running_var``, ``num_batches_tracked``),
    by torch name; the EMA copies and momentum buffers are keyed alike;
    ``step`` counts optimizer steps (int64, 0-d)."""
    step: torch.Tensor
    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    ema_params: Dict[str, torch.Tensor]
    ema_batch_stats: Dict[str, torch.Tensor]
    opt_state: SGDState


def create_train_state(model: nn.Module, opt_cfg: YoloSGDConfig
                       ) -> TrainState:
    """The state of ``model`` as it stands (its weights come from tpudet
    variables or tpudet's init, ``utils/flax_import``): step 0, EMA copies
    equal to the weights, zero momentum buffers. This is tpudet's plain
    init path; YOLOv4 has no ``forward_train``."""
    params = dict(model.named_parameters())
    batch_stats = dict(model.named_buffers())
    init_fn, _ = make_yolo_sgd(opt_cfg, param_labels(model))
    device = next(iter(params.values())).device
    return TrainState(
        step=torch.zeros((), dtype=torch.int64, device=device),
        params=params,
        batch_stats=batch_stats,
        ema_params={k: v.detach().clone() for k, v in params.items()},
        ema_batch_stats={k: v.clone() for k, v in batch_stats.items()},
        opt_state=init_fn(params))


def model_losses(model: nn.Module, batch: Dict) -> Dict[str, torch.Tensor]:
    """The loss dict of ``model`` on a batch of ``img`` and padded gts
    (tpudet's ``default_loss``)."""
    pred_maps = model(batch['img'])
    return model.loss(pred_maps, batch['gt_bboxes'], batch['gt_labels'],
                      batch['gt_valid'])


def make_train_step(model: nn.Module,
                    opt_cfg: YoloSGDConfig,
                    ema_momentum_base: float = 0.9999,
                    ema_warm_up: int = 2000,
                    ema_interval: int = 1,
                    accumulation: int = 1,
                    loss_fn: Optional[Callable[[Dict], Dict]] = None
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState,
                                                            Dict]]:
    """The train step: ``(state, batch) -> (state, metrics)``.

    ``batch`` holds tensors on the model's device: ``img`` (B, H, W, 3)
    and padded gts ``gt_bboxes`` (B, G, 4), ``gt_labels`` (B, G),
    ``gt_valid`` (B, G). Micro-batch ``i`` holds images ``[i*mb,
    (i+1)*mb)`` (``reshape((accumulation, -1) + shape[1:])``) of every
    entry. ``state`` must hold ``model``'s own tensors
    (``create_train_state``).

    ``loss_fn(micro_batch) -> losses`` replaces ``model_losses`` (tpudet's
    ``loss_fn`` hook, ``tpudet/train/train_state.py:111-146``): with the
    on-device augmentation it augments a tile micro-batch, without
    gradient, and returns ``model_losses`` of the result.

    ``metrics``: ``loss`` (the summed losses, mean over micro-batches),
    ``loss_cls``, ``loss_conf``, ``loss_bbox``, ``num_gts`` (means over
    micro-batches), ``grad_norm`` (before clipping), ``lr`` (the weight
    group's) and ``momentum``; 0-d tensors on the device.
    """
    _, opt_update = make_yolo_sgd(opt_cfg, param_labels(model))
    compute_losses = loss_fn or (lambda mb: model_losses(model, mb))

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState,
                                                            Dict]:
        model.train()
        for p in state.params.values():
            p.grad = None
        micro = {k: v.reshape((accumulation, -1) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        totals, seq = [], []
        for i in range(accumulation):
            losses = compute_losses({k: v[i] for k, v in micro.items()})
            total = sum(v for k, v in losses.items() if 'loss' in k)
            total.backward()
            totals.append(total.detach())
            seq.append({k: v.detach() for k, v in losses.items()})
        grads = {n: p.grad for n, p in state.params.items()}
        _, _, opt_metrics = opt_update(grads, state.opt_state, state.params,
                                       state.step)
        for p in state.params.values():
            p.grad = None
        m_t = ema_momentum(state.step, ema_momentum_base, ema_warm_up,
                           ema_interval)
        ema_update(state.ema_params, state.params, m_t)
        ema_update(state.ema_batch_stats, state.batch_stats, m_t)
        state.step += 1
        metrics = dict(loss=torch.stack(totals).mean(),
                       **{k: torch.stack([s[k] for s in seq]).mean()
                          for k in seq[0]},
                       **opt_metrics)
        return state, metrics

    return train_step
