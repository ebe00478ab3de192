"""Mish activation, ``x * tanh(softplus(x))``.

Port of ``tpudet/ops/mish.py``. On the card every mish of the network goes
through :func:`mish_cuda`, the hand-written kernel in ``csrc/mish.cu``
(the counterpart of tpudet's Pallas ``mish_pallas``): fp32 arithmetic,
rounded once to the input type. On a CPU tensor the same wrapper computes
its plain PyTorch version, :func:`mish_reference`.

:func:`mish` keeps tpudet's dtype rules (bf16 computes the one-exp rational
form) so that the CPU tests can hold bf16 against tpudet; nothing on the
card's main path calls it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """Stable softplus, ``max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0.) + torch.log1p(torch.exp(-x.abs()))


def mish_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch mish: widen to fp32, ``x * tanh(softplus(x))``, round
    once to ``x.dtype``. The kernel's function, op for op. ``-inf`` maps to
    0, the limit (the literal product would be ``-inf * 0 = NaN``)."""
    xf = x.float()
    y = torch.where(xf == float('-inf'), torch.zeros_like(xf),
                    xf * torch.tanh(_softplus(xf)))
    return y.to(x.dtype)


def mish(x: torch.Tensor) -> torch.Tensor:
    """tpudet's dtype-preserving ``mish`` (``tpudet/ops/mish.py:29-65``):
    fp32 and fp16 compute the literal chain in fp32; bf16 computes in bf16
    with the one-exp rational form ``u(u+2)/(u^2+2u+2)``, ``u = e^x``,
    clamped at 8."""
    if x.dtype != torch.bfloat16:
        return mish_reference(x)
    u = torch.exp(torch.clamp_max(x, 8.0))
    return x * (u * (u + 2.0)) / (u * u + 2.0 * u + 2.0)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point, built and loaded on first use."""
    from .build import load
    fn = load('mish').tpudet_mish_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, y: torch.Tensor) -> int:
    return _kernel()(x.data_ptr(), y.data_ptr(), x.numel(),
                     _DTYPE_CODES[x.dtype],
                     torch.cuda.current_stream(x.device).cuda_stream)


def _dense(x: torch.Tensor) -> bool:
    return x.is_contiguous() or (
        x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last))


def mish_cuda(x: torch.Tensor) -> torch.Tensor:
    """Mish forward. A CUDA tensor launches the kernel of ``csrc/mish.cu``
    (and counts the launch in ``mish_cuda.launches``); a CPU tensor takes
    :func:`mish_reference`. The output is a new tensor with ``x``'s
    layout.

    The kernel takes fp32, fp16 and bf16 in a dense layout (contiguous or
    ``channels_last``). Anything else raises, as does a CUDA tensor that
    requires grad: the backward kernel is not ported yet (ROADMAP.md,
    "mish backward kernel and the training slice").
    """
    if x.device.type == 'cpu':
        return mish_reference(x)
    if x.device.type != 'cuda':
        raise ValueError(f'mish_cuda: unsupported device {x.device}')
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f'mish_cuda: unsupported dtype {x.dtype}')
    if not _dense(x):
        raise ValueError('mish_cuda: input must be contiguous or '
                         'channels_last')
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            'mish_cuda has no backward kernel yet (ROADMAP.md, "mish '
            'backward kernel and the training slice"); run inference '
            'under torch.inference_mode() or torch.no_grad()')
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    if x.device.index == torch.cuda.current_device():
        err = _launch(x, y)
    else:
        with torch.cuda.device(x.device):
            err = _launch(x, y)
    if err != 0:
        raise RuntimeError(f'mish kernel launch failed: cudaError {err}')
    mish_cuda.launches += 1
    return y


mish_cuda.launches = 0
