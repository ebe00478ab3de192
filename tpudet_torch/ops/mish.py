"""Mish activation, ``x * tanh(softplus(x))``, and its gradient.

Port of ``tpudet/ops/mish.py``. On the card every mish of the network goes
through :func:`mish_cuda`, the hand-written kernels in ``csrc/mish.cu``
(the counterparts of tpudet's Pallas ``mish_pallas`` and its custom VJP):
fp32 arithmetic by tpudet's one-exp rational identity, rounded once to the
input type. A tensor that requires
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


# the reference's softplus THRESHOLD (tpudet/ops/mish.py:4-5): from here on
# mish(x) = x and mish'(x) = 1 to within 1e-15
THRESHOLD = 20.0


def _tanh_softplus(xf: torch.Tensor):
    """``tanh(softplus(x))`` of fp32 ``xf`` by tpudet's one-exp identity, as
    the kernels take it, each op rounded: ``u = e^min(x, 20)``, ``r = 1 /
    (u (u + 2) + 2)``, ``t = u (u + 2) r``. Returns ``(u, r, t)``."""
    u = torch.exp(torch.clamp_max(xf, THRESHOLD))
    b = u * (u + 2)
    r = torch.reciprocal(b + 2)
    return u, r, b * r


def mish_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch mish, the forward kernel's function op for op: widen
    to fp32, ``y = x t`` with ``t`` from :func:`_tanh_softplus`, round once
    to ``x.dtype``. ``y = x`` from ``x = 20`` on; ``-inf`` maps to 0, the
    limit (the product would be ``-inf * 0 = NaN``)."""
    xf = x.float()
    y = xf * _tanh_softplus(xf)[2]
    y = torch.where(xf >= THRESHOLD, xf, y)
    y = torch.where(xf == float('-inf'), 0.0, y)
    return y.to(x.dtype)


def mish_backward_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch gradient of mish, the backward kernel's function op
    for op: widen ``x`` and the incoming gradient ``g`` to fp32, ``d = t +
    4 x u (u + 1) r r`` (``u, r, t`` from :func:`_tanh_softplus`; it is
    ``t + x (1 - t^2) sigmoid(x)``, tpudet's ``_mish_bwd_kernel``), round
    ``g d`` once to ``x.dtype``. ``r`` enters twice since ``(u (u + 2) +
    2)^2`` overflows past ``x = 22``; ``x u`` comes first since ``4 x`` may
    overflow where ``u`` is 0. ``d`` is 1 from ``x = 20`` on and at
    ``+inf``, and 0 at ``-inf``, the limits."""
    xf = x.float()
    u, r, t = _tanh_softplus(xf)
    d = t + xf * u * (u + 1) * 4 * r * r
    d = torch.where(xf >= THRESHOLD, 1.0, d)
    d = torch.where(xf == float('-inf'), 0.0, d)
    return (g.float() * d).to(x.dtype)


def mish(x: torch.Tensor) -> torch.Tensor:
    """tpudet's dtype-preserving ``mish`` (``tpudet/ops/mish.py:29-65``):
    fp32 and fp16 compute in fp32 (:func:`mish_reference`, within a few
    fp32 ulp of tpudet's literal chain); bf16 computes in bf16 with the
    one-exp rational form ``u(u+2)/(u^2+2u+2)``, ``u = e^x``, clamped at
    8, as tpudet does."""
    if x.dtype != torch.bfloat16:
        return mish_reference(x)
    u = torch.exp(torch.clamp_max(x, 8.0))
    return x * (u * (u + 2.0)) / (u * u + 2.0 * u + 2.0)


@functools.lru_cache(maxsize=None)
def _kernels():
    """The kernels' C entry points, built and loaded on first use."""
    from .build import load
    lib = load('mish')
    ptr, size = ctypes.c_void_p, ctypes.c_longlong
    fwd, bwd = lib.tpudet_mish_fwd, lib.tpudet_mish_bwd
    fwd.argtypes = [ptr, ptr, size, ctypes.c_int, ptr]
    bwd.argtypes = [ptr, ptr, ptr, size, size, size, ctypes.c_int, ptr]
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


def _launch(fn, x: torch.Tensor, *args) -> None:
    """Call kernel entry ``fn`` with ``args``, ``x``'s dtype code and the
    current stream of ``x``'s device; raise on a launch error."""
    args = (*args, _DTYPE_CODES[x.dtype],
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
        _launch(_kernels()[0], x, x.data_ptr(), y.data_ptr(), x.numel())
        mish_cuda.launches += 1
    return y


def _memory_order(x: torch.Tensor):
    """``x``'s dims from the outermost in memory to the innermost."""
    if x.is_contiguous() or x.dim() != 4:
        return tuple(range(x.dim()))
    return 0, 2, 3, 1  # channels_last


def _g_rows(x: torch.Tensor, g: torch.Tensor):
    """How the backward kernel can read ``g`` beside a dense ``x`` of the
    same shape: ``(row, pitch)`` when ``g``'s elements, taken in ``x``'s
    memory order, are rows of ``row`` contiguous elements whose starts lie
    ``pitch`` elements apart, else None. ``row == x.numel()`` means ``g``
    is laid out as ``x``. A channel slice of a channels_last concat's
    gradient, which autograd hands a mish before a ``torch.cat``, is rows
    of C at a pitch of the concat's channels."""
    dims = [(x.shape[d], g.stride(d)) for d in _memory_order(x)
            if x.shape[d] != 1]
    row, k = 1, len(dims)
    while k and dims[k - 1][1] == row:
        k -= 1
        row *= dims[k][0]
    if k == 0:
        return row, row
    pitch = span = dims[k - 1][1]
    for size, stride in reversed(dims[:k]):
        if stride != span:
            return None
        span *= size
    return row, pitch


def mish_backward_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Gradient of mish at ``x`` for the incoming gradient ``g``. CUDA
    tensors launch the backward kernel of ``csrc/mish.cu`` (and count the
    launch in ``mish_backward_cuda.launches``); CPU tensors take
    :func:`mish_backward_reference`. The output has ``x``'s layout.

    The kernel reads ``x`` in memory order and ``g`` in its own layout
    where that is ``x``'s or rows of whole 16-byte vectors at a pitch
    (:func:`_g_rows`; each such launch counts in ``.g_pitched``). A ``g``
    in any other layout is first copied into ``x``'s strides, one more
    pass over it, counted in ``.g_copies``."""
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f'mish_backward_cuda: g {tuple(g.shape)} {g.dtype} '
                         f'{g.device} does not match x {tuple(x.shape)} '
                         f'{x.dtype} {x.device}')
    if x.device.type == 'cpu':
        return mish_backward_reference(x, g)
    _check(x, 'mish_backward_cuda')
    dx = torch.empty_like(x)
    n = x.numel()
    if not n:
        return dx
    rows = _g_rows(x, g)
    if rows is not None and rows[0] != n:
        vec = 16 // x.element_size()
        if (rows[0] % vec or rows[1] % vec or any(
                t.data_ptr() % 16 for t in (x, g, dx))):
            rows = None
    if rows is None:
        g = torch.empty_like(x).copy_(g)
        mish_backward_cuda.g_copies += 1
        rows = n, n
    row, pitch = (0, 0) if rows[0] == n else rows  # 0, 0: g laid out as x
    _launch(_kernels()[1], x, x.data_ptr(), g.data_ptr(), dx.data_ptr(), n,
            row, pitch)
    if row:
        mish_backward_cuda.g_pitched += 1
    mish_backward_cuda.launches += 1
    return dx


mish_backward_cuda.launches = 0
mish_backward_cuda.g_copies = 0
mish_backward_cuda.g_pitched = 0


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
