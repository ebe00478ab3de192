"""tpudet_torch — the PyTorch/CUDA port of tpudet for NVIDIA Hopper.

Plain tensor code is PyTorch; every Pallas kernel of tpudet on a ported
path is a hand-written CUDA kernel (``ops/csrc``), built with ``nvcc`` on
first use. The JAX package ``tpudet`` is the reference the port is tested
against; the port imports none of it.

Importing the package registers the port's ops (``tpudet::mish_fwd`` and
``tpudet::mish_bwd``), which ``torch.export.load`` of an exported
program needs.
"""
from .config import Config
from .ops import mish as _mish  # registers tpudet::mish_fwd / mish_bwd
from .registry import Registry, build_from_cfg

__all__ = ['Config', 'Registry', 'build_from_cfg']
