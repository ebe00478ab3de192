"""Shared inputs of the port's tests: the committed JPEG fixtures
(``jpeg/``, written by ``tpudet_torch/tools/jpeg_fixtures.py``) and tpudet's
native JPEG loader built where no other test process builds it."""
import json
import os
import shutil
from contextlib import contextmanager

import pytest

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
