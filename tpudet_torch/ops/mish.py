"""Mish activation, ``x * tanh(softplus(x))``, and its gradient.

Port of ``tpudet/ops/mish.py``. On the card every mish of the network goes
through :func:`mish_cuda`, the hand-written kernels in ``csrc/mish.cu``
(the counterparts of tpudet's Pallas ``mish_pallas`` and its custom VJP):
fp32 arithmetic, rounded once to the input type. A tensor that requires
grad goes through :class:`MishFunction`, which saves only ``x`` and whose
backward is :func:`mish_backward_cuda`. On a CPU tensor the same wrappers
compute their plain PyTorch versions, :func:`mish_reference` and
:func:`mish_backward_reference`.

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


def mish_backward_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch gradient of mish (tpudet's ``_mish_bwd_kernel``): widen
    ``x`` and the incoming gradient ``g`` to fp32, ``t = tanh(softplus(x))``,
    ``g * (t + x * (1 - t^2) * sigmoid(x))``, round once to ``x.dtype``.
    The backward kernel's function, op for op. At ``x = +-inf`` the
    derivative is its limit, 1 and 0 (the literal formula gives
    ``inf * 0 = NaN``)."""
    xf = x.float()
    t = torch.tanh(_softplus(xf))
    d = t + xf * (1 - t * t) * torch.sigmoid(xf)
    d = torch.where(xf == float('inf'), torch.ones_like(d),
                    torch.where(xf == float('-inf'), torch.zeros_like(d), d))
    return (g.float() * d).to(x.dtype)


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
def _kernels():
    """The kernels' C entry points, built and loaded on first use."""
    from .build import load
    lib = load('mish')
    fwd, bwd = lib.tpudet_mish_fwd, lib.tpudet_mish_bwd
    fwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _dense(x: torch.Tensor) -> bool:
    return x.is_contiguous() or (
        x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last))


def _check(x: torch.Tensor, name: str):
    """Raise on what the kernels do not take."""
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: unsupported device {x.device}')
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f'{name}: unsupported dtype {x.dtype}')
    if not _dense(x):
        raise ValueError(f'{name}: input must be contiguous or channels_last')


def _launch(fn, x: torch.Tensor, *ptrs) -> None:
    """Call kernel entry ``fn`` with ``ptrs``, ``x``'s size and dtype, on
    the current stream of ``x``'s device; raise on a launch error."""
    args = (*ptrs, x.numel(), _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if x.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(x.device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f'mish kernel launch failed: cudaError {err}')


def _forward(x: torch.Tensor) -> torch.Tensor:
    """Mish of ``x`` with no autograd: the kernel on a CUDA tensor (one
    count in ``mish_cuda.launches``), :func:`mish_reference` on a CPU one."""
    if x.device.type == 'cpu':
        return mish_reference(x)
    _check(x, 'mish_cuda')
    y = torch.empty_like(x)
    if x.numel():
        _launch(_kernels()[0], x, x.data_ptr(), y.data_ptr())
        mish_cuda.launches += 1
    return y


def mish_backward_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Gradient of mish at ``x`` for the incoming gradient ``g``. CUDA
    tensors launch the backward kernel of ``csrc/mish.cu`` (and count the
    launch in ``mish_backward_cuda.launches``); CPU tensors take
    :func:`mish_backward_reference`. The output has ``x``'s layout.

    The kernel reads ``x`` and ``g`` in memory order, so ``g`` is first
    brought to ``x``'s strides if it has others (autograd may hand over a
    gradient in another memory format)."""
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f'mish_backward_cuda: g {tuple(g.shape)} {g.dtype} '
                         f'{g.device} does not match x {tuple(x.shape)} '
                         f'{x.dtype} {x.device}')
    if x.device.type == 'cpu':
        return mish_backward_reference(x, g)
    _check(x, 'mish_backward_cuda')
    if g.stride() != x.stride():
        g = torch.empty_like(x).copy_(g)
    dx = torch.empty_like(x)
    if x.numel():
        _launch(_kernels()[1], x, x.data_ptr(), g.data_ptr(), dx.data_ptr())
        mish_backward_cuda.launches += 1
    return dx


mish_backward_cuda.launches = 0


class MishFunction(torch.autograd.Function):
    """Mish with the gradient of tpudet's ``mish_pallas`` custom VJP: the
    forward saves only ``x``; the backward recomputes ``tanh(softplus(x))``
    from it (``tpudet/ops/mish.py:112-127``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _forward(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return mish_backward_cuda(x, g)


def mish_cuda(x: torch.Tensor) -> torch.Tensor:
    """Mish forward. A CUDA tensor launches the kernel of ``csrc/mish.cu``
    (and counts the launch in ``mish_cuda.launches``); a CPU tensor takes
    :func:`mish_reference`. The output is a new tensor with ``x``'s
    layout. A tensor that requires grad goes through :class:`MishFunction`,
    whose backward launches the backward kernel on the card.

    The kernels take fp32, fp16 and bf16 in a dense layout (contiguous or
    ``channels_last``). Anything else raises.
    """
    if x.requires_grad and torch.is_grad_enabled():
        return MishFunction.apply(x)
    return _forward(x)


mish_cuda.launches = 0
