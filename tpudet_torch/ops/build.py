"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``csrc/<name>.cu`` has a plain C interface. On first use
it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/kernels/`` at the root of the checkout (git-ignored) and
loaded with ``ctypes``. No PyTorch header is included, so a build takes
seconds. The library's file name carries a hash of its source and flags,
so an edited source is rebuilt and a stale library is never loaded.

Nothing here runs at import time: the CPU-only test host has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which('nvcc')
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, 'bin', 'nvcc')):
        return os.path.join(CUDA_HOME, 'bin', 'nvcc')
    raise RuntimeError('nvcc not found: the CUDA kernels of tpudet_torch '
                       'are built from source on first use and need the '
                       'CUDA toolkit (set CUDA_HOME or put nvcc on PATH)')


def library_path(name: str) -> Path:
    src = CSRC / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes() +
                            ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'lib{name}-{digest}.so'


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns the wall seconds each build
    took (0.0 for a library that was already there)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started: List = []
    seconds: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, str(CSRC / f'{name}.cu')]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started.append((name, out, tmp, proc, time.perf_counter()))
    failures = []
    for name, out, tmp, proc, t0 in started:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f'{name}: nvcc exited {proc.returncode}\n{log}')
        else:
            # atomic: a concurrent loader sees the old state or the whole
            # library, never a half-written file
            os.replace(tmp, out)
    if failures:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
