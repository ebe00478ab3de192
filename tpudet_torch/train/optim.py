"""Optimizer: torch-semantics SGD (and Adam) with the reference's schedule
stack. Port of ``tpudet/train/optim.py``.

- SGD with nesterov momentum and weight decay, bias and norm params exempt
  from decay (``paramwise_cfg=dict(bias_decay_mult=0., norm_decay_mult=0.)``);
- cosine LR to ``min_lr_ratio`` (or step decay, or fixed);
- DetailedLinearWarmUpHook: over ``warmup_iters`` the bias LR anneals 10x ->
  base, the weight LR ramps 0 -> base, momentum ramps 0.95x -> base;
- gradient clipping by global norm (35).

Schedules are functions of the step, a tensor on the device, and compute
in fp32 as tpudet's jnp versions do, so no step needs the host. The
update works in place on the parameters and buffers (tpudet returns new
trees), with ``torch._foreach_*`` ops: a handful of launches per group,
not several per tensor.

Group labels come from tpudet's flax leaf names (``param_group_label``),
reached through ``utils/flax_import.leaf_table``: BN ``scale`` (torch
``weight``) follows the weight schedule without decay, every ``bias`` the
bias schedule, conv kernels the weight schedule with decay.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from ..utils.flax_import import leaf_table


class YoloSGDConfig(NamedTuple):
    lr: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 5e-4
    nesterov: bool = True
    # 'sgd' (torch SGD semantics) or 'adam' (torch Adam, L2-into-grad decay)
    opt_type: str = 'sgd'
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    # schedule
    policy: str = 'cosine'  # 'cosine' | 'step' | 'fixed'
    total_steps: int = 100000
    min_lr_ratio: float = 0.2
    decay_steps: Tuple[int, ...] = ()  # iteration boundaries, 'step' policy
    gamma: float = 0.1
    warmup_iters: int = 10000
    lr_weight_warmup_ratio: float = 0.
    lr_bias_warmup_ratio: float = 10.
    momentum_warmup_ratio: float = 0.95
    grad_clip_norm: float = 35.0
    # cosine stepping granularity: per epoch like mmcv's by_epoch=True
    steps_per_epoch: int = 0  # 0 -> smooth per-step cosine


def param_group_label(path: Tuple[str, ...], leaf) -> str:
    """'weight' / 'bias' / 'weight_nodecay' of a flax leaf path
    (``tpudet/train/optim.py:58-67``)."""
    name = str(path[-1])
    if name == 'bias':
        return 'bias'
    if name == 'scale':  # BN gamma == torch '.weight' but norm_decay_mult=0
        return 'weight_nodecay'
    if getattr(leaf, 'ndim', 0) <= 1:
        return 'bias'
    return 'weight'


def param_labels(model: torch.nn.Module) -> Dict[str, str]:
    """Group label of every parameter of ``model``, by torch name, from the
    flax path that ``leaf_table`` gives it."""
    params = dict(model.named_parameters())
    labels = {key: param_group_label(path, params[key])
              for path, (key, _) in leaf_table(model).items()
              if path[0] == 'params'}
    missing = sorted(set(params) - set(labels))
    if missing:
        raise KeyError(f'parameters with no flax leaf: {missing}')
    return labels


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step)


def cosine_lr(step, cfg: YoloSGDConfig) -> torch.Tensor:
    """Cosine annealing from lr to lr * min_lr_ratio over total_steps."""
    step = _step(step)
    if cfg.steps_per_epoch > 0:
        progress = (step // cfg.steps_per_epoch) * cfg.steps_per_epoch
        progress = progress / max(cfg.total_steps, 1)
    else:
        progress = step / max(cfg.total_steps, 1)
    progress = torch.clamp(progress, 0.0, 1.0)
    min_lr = cfg.lr * cfg.min_lr_ratio
    return min_lr + (cfg.lr - min_lr) * 0.5 * (
        1 + torch.cos(math.pi * progress))


def step_lr(step, cfg: YoloSGDConfig) -> torch.Tensor:
    """Step decay at iteration boundaries (mmcv StepLrUpdaterHook)."""
    step = _step(step)
    if not cfg.decay_steps:
        return torch.full((), cfg.lr, device=step.device)
    boundaries = torch.as_tensor(cfg.decay_steps, device=step.device)
    k = torch.sum(step >= boundaries)
    return cfg.lr * cfg.gamma**k


def schedule_lr(step, cfg: YoloSGDConfig) -> torch.Tensor:
    if cfg.policy == 'cosine':
        return cosine_lr(step, cfg)
    if cfg.policy == 'step':
        return step_lr(step, cfg)
    return torch.full((), cfg.lr, device=_step(step).device)


def warmup_factors(step, cfg: YoloSGDConfig):
    """(in_warmup, weight_lr_scale, bias_lr_scale, momentum_scale) at
    ``step``. Inside warmup the scales apply to cfg.lr, not to the cosine
    value, as the reference's hook overrides the LR hook."""
    step = _step(step)
    prog = torch.clamp(step / max(cfg.warmup_iters, 1), 0.0, 1.0)
    in_warmup = (step <= cfg.warmup_iters) & (cfg.warmup_iters > 0)
    w_scale = prog + (1 - prog) * cfg.lr_weight_warmup_ratio
    b_scale = prog + (1 - prog) * cfg.lr_bias_warmup_ratio
    m_scale = prog + (1 - prog) * cfg.momentum_warmup_ratio
    return in_warmup, w_scale, b_scale, m_scale


class SGDState(NamedTuple):
    momentum_buf: Dict[str, torch.Tensor]  # like params; Adam: stacked (m, v)


def global_norm_clip(grads, max_norm: float):
    """Clip a list of gradients by their global L2 norm (torch
    ``clip_grad_norm_`` semantics). Returns (clipped list, norm)."""
    grads = [g.float() for g in grads]
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-6), 1.0)
    return torch._foreach_mul(grads, scale), gnorm


def make_yolo_sgd(cfg: YoloSGDConfig, labels: Dict[str, str]):
    """Returns (init_fn(params) -> SGDState, update_fn(grads, state, params,
    step) -> (params, state, metrics)); ``labels`` maps each parameter name
    to its group (``param_labels``). ``update_fn`` updates ``params`` and
    the state's buffers in place.

    Torch SGD update order, as tpudet writes it: d = g + wd*p;
    buf = m*buf + d; d = d + m*buf if nesterov (else d = buf); p -= lr*d.
    """

    def init_fn(params) -> SGDState:
        if cfg.opt_type == 'adam':
            return SGDState({n: torch.zeros((2,) + tuple(p.shape),
                                            dtype=torch.float32,
                                            device=p.device)
                             for n, p in params.items()})
        return SGDState({n: torch.zeros_like(p) for n, p in params.items()})

    def _sgd(group, lr, momentum, decay, state, params, grads):
        ps = [params[n] for n in group]
        bufs = [state.momentum_buf[n] for n in group]
        d = [grads[n] for n in group]
        if decay:
            d = torch._foreach_add(d, ps, alpha=cfg.weight_decay)
        torch._foreach_mul_(bufs, momentum)
        torch._foreach_add_(bufs, d)
        if cfg.nesterov:
            d = torch._foreach_add(d, torch._foreach_mul(bufs, momentum))
        else:
            d = [b.clone() for b in bufs]
        torch._foreach_mul_(d, lr)
        torch._foreach_sub_(ps, d)

    def _adam(group, lr, decay, step, state, params, grads):
        # off the flagship path (the CornerNet/DETR configs train with
        # Adam): one tensor at a time, as tpudet writes it
        t = (step + 1).float()
        for n in group:
            p, g, buf = params[n], grads[n], state.momentum_buf[n]
            if decay:
                g = g + cfg.weight_decay * p
            m = cfg.adam_b1 * buf[0] + (1 - cfg.adam_b1) * g
            v = cfg.adam_b2 * buf[1] + (1 - cfg.adam_b2) * g * g
            mhat = m / (1 - cfg.adam_b1**t)
            vhat = v / (1 - cfg.adam_b2**t)
            p.sub_(lr * (mhat / (torch.sqrt(vhat) + cfg.adam_eps)))
            buf[0].copy_(m)
            buf[1].copy_(v)

    @torch.no_grad()
    def update_fn(grads, state: SGDState, params, step):
        step = _step(step)
        base_lr = schedule_lr(step, cfg)
        in_warmup, w_scale, b_scale, m_scale = warmup_factors(step, cfg)
        lr_weight = torch.where(in_warmup, cfg.lr * w_scale, base_lr)
        lr_bias = torch.where(in_warmup, cfg.lr * b_scale, base_lr)
        momentum = torch.where(in_warmup, cfg.momentum * m_scale,
                               torch.full_like(m_scale, cfg.momentum))

        names = list(params)
        clipped, gnorm = global_norm_clip([grads[n] for n in names],
                                          cfg.grad_clip_norm)
        grads = dict(zip(names, clipped))
        for label, lr, decay in (('weight', lr_weight, True),
                                 ('weight_nodecay', lr_weight, False),
                                 ('bias', lr_bias, False)):
            group = [n for n in names if labels[n] == label]
            if not group:
                continue
            if cfg.opt_type == 'adam':
                _adam(group, lr, decay, step, state, params, grads)
            else:
                _sgd(group, lr, momentum, decay, state, params, grads)
        metrics = dict(grad_norm=gnorm, lr=lr_weight, momentum=momentum)
        return params, state, metrics

    return init_fn, update_fn
