"""The port stands alone: ``tpudet_torch``, ``chip_smoke.py`` and
``mish_variants.py`` import no JAX, no flax and no module of the JAX
package ``tpudet``, and importing the port needs neither ``nvcc`` nor
``triton``."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'tpudet')


def _port_files():
    files = [os.path.join(ROOT, n) for n in ('chip_smoke.py',
                                             'mish_variants.py')]
    for d, _, names in os.walk(os.path.join(ROOT, 'tpudet_torch')):
        files += [os.path.join(d, n) for n in names if n.endswith('.py')]
    return sorted(files)


def _forbidden(module: str) -> bool:
    """``tpudet`` and ``tpudet.*`` are the JAX package; ``tpudet_torch``
    is not."""
    return any(module == f or module.startswith(f + '.') for f in FORBIDDEN)


def test_forbidden_matches_exactly():
    assert _forbidden('tpudet') and _forbidden('tpudet.ops.mish')
    assert _forbidden('jax.numpy') and _forbidden('flax')
    assert not _forbidden('tpudet_torch')
    assert not _forbidden('tpudet_torch.ops')
    assert not _forbidden('jaxtyping')


@pytest.mark.parametrize('path', _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f'{path}:{node.lineno} imports {bad}'


def test_import_needs_no_jax_nvcc_or_triton():
    code = (
        'import sys, builtins\n'
        'real = builtins.__import__\n'
        'def guard(name, *a, **k):\n'
        '    if name.split(".")[0] in ("triton",):\n'
        '        raise ImportError("triton imported at import time")\n'
        '    return real(name, *a, **k)\n'
        'builtins.__import__ = guard\n'
        'import tpudet_torch, tpudet_torch.apis, tpudet_torch.ops.mish\n'
        'import tpudet_torch.ops.build\n'
        'bad = sorted(m for m in sys.modules\n'
        '             if m.split(".")[0] in ("jax", "flax", "tpudet"))\n'
        'assert not bad, bad\n'
        'print("ok")\n')
    env = dict(os.environ, PATH='/nonexistent', PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


def test_eval_path_imports_neither_cv2_nor_triton():
    """The card's machine has no cv2: the data, evaluation and test
    modules import it only when a file is read."""
    code = (
        'import sys\n'
        'import tpudet_torch.data, tpudet_torch.evaluation\n'
        'import tpudet_torch.apis.test, tpudet_torch.apis\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in\n'
        '             ("cv2", "triton", "jax", "flax", "tpudet"))\n'
        'assert not bad, bad\n'
        'print("ok")\n')
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'
