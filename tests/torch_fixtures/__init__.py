"""Shared inputs of the port's tests: the committed JPEG fixtures
(``jpeg/``, written by ``tpudet_torch/tools/jpeg_fixtures.py``) and tpudet's
native JPEG loader built where no other test process builds it.

Importing it sets PyTorch's CPU ops to one intra-op thread: every port
test module imports it. The tests' ops are small (64-128 px, narrow
widths), so 8 threads run a test no faster than one; under the tier-1
run's 6 pytest-xdist workers each process would start 8 OpenMP threads on
the host's 8 cores, and their spinning waits multiplied the port's
test-seconds by 3.8 (2120 against 552 s over its six heaviest files).
The few comparisons that hold near-ties decided at PyTorch's default
thread count run under ``default_threads``.
"""
import json
import os
import shutil
from contextlib import contextmanager

import pytest
import torch

DEFAULT_THREADS = torch.get_num_threads()
torch.set_num_threads(1)


@contextmanager
def default_threads():
    """PyTorch's default intra-op thread count inside, one thread after:
    for a comparison whose near-ties (mirrored boxes whose scores differ
    by an ulp, a step's update at the edge of its tolerance) were measured
    with fp32 sums in that many threads' order."""
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(1)

JPEG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'jpeg')


def jpeg_manifest():
    """{name: entry} of ``jpeg/manifest.json``."""
    with open(os.path.join(JPEG_DIR, 'manifest.json')) as f:
        return json.load(f)['fixtures']


def jpeg_bytes(name):
    with open(os.path.join(JPEG_DIR, name), 'rb') as f:
        return f.read()


@contextmanager
def tpudet_native_jpeg(directory):
    """tpudet's ``jpeg_native`` with its library built into ``directory``.

    ``jpeg_native.load()`` builds ``tpudet/ops/native/_jpeg_loader.so``
    next to its source; concurrent test processes that build it there race
    (one opens a half-written file). Here ``_SO`` points into
    ``directory`` and ``_lib``/``_tried`` are reset, all three restored on
    exit. Skips where ``g++`` or libjpeg's headers are missing."""
    from tpudet.ops.native import jpeg_native
    if shutil.which('g++') is None:
        pytest.skip("tpudet's native JPEG loader needs g++")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jpeg_native, '_SO',
                   os.path.join(str(directory), '_jpeg_loader.so'))
        mp.setattr(jpeg_native, '_lib', None)
        mp.setattr(jpeg_native, '_tried', False)
        if not jpeg_native.available():
            pytest.skip("tpudet's native JPEG loader did not build (no "
                        "jpeglib.h or libjpeg)")
        yield jpeg_native
    finally:
        mp.undo()
