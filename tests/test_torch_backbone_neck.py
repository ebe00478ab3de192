"""DarknetCSP (v4s) + YOLOV4Neck: tpudet_torch against tpudet on the CPU.

One tpudet variables tree, drawn from a numpy seed with random BatchNorm
statistics, is carried into the port by ``flax_import``; both frameworks
run the same 128-px images in fp32. tpudet keeps its default
space-to-depth stem, so this also shows that the port's plain 3x3 stem
computes the same thing from the same params.

Tolerance: max |delta| <= 1e-4 * max |ref| per output (fp32 reassociation
through ~40 convs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models.backbones.darknet_csp import DarknetCSP as JaxDarknet
from tpudet.models.necks.yolo_neck_csp import YOLOV4Neck as JaxNeck
from tpudet_torch.models.backbones.darknet_csp import DarknetCSP
from tpudet_torch.models.necks.yolo_neck_csp import YOLOV4Neck
from tpudet_torch.utils.flax_import import load_flax_variables

from . import torch_fixtures  # noqa: F401  (one intra-op thread)

IMG = 128
WIDTHS, OUTS = (128, 256, 256), (128, 256, 512)


def random_variables(shapes, seed):
    """A variables tree of the given shapes: conv kernels N(0, 1/fan_in),
    BatchNorm affine and statistics spread around identity."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        shape = s.shape
        if name == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == 'scale':
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == 'var':
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _max_rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _images(seed, b=2):
    return np.random.RandomState(seed).uniform(
        -0.45, 0.55, (b, IMG, IMG, 3)).astype(np.float32)


@pytest.fixture(scope='module')
def backbone_pair():
    jmodel = JaxDarknet(scale='v4s5p', out_indices=(3, 4, 5))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, IMG, IMG, 3)))
    variables = random_variables(shapes, seed=0)
    tmodel = DarknetCSP('v4s5p', out_indices=(3, 4, 5))
    load_flax_variables(tmodel, variables)
    return jmodel, variables, tmodel.eval()


def test_backbone_matches_tpudet(backbone_pair):
    jmodel, variables, tmodel = backbone_pair
    x = _images(1)
    ref = jmodel.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == r.shape
        assert _max_rel(g, np.asarray(r)) <= 1e-4


def test_neck_matches_tpudet():
    rng = np.random.RandomState(2)
    feats = [rng.randn(2, IMG // s, IMG // s, c).astype(np.float32)
             for s, c in zip((8, 16, 32), WIDTHS)]
    jneck = JaxNeck(in_channels=WIDTHS, out_channels=OUTS, csp_repetition=1)
    shapes = jax.eval_shape(jneck.init, jax.random.PRNGKey(0),
                            [jnp.asarray(f) for f in feats])
    variables = random_variables(shapes, seed=3)
    tneck = YOLOV4Neck(WIDTHS, OUTS, csp_repetition=1)
    load_flax_variables(tneck, variables)
    ref = jneck.apply(variables, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = tneck.eval()(
            [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    for g, r, c in zip(got, ref, OUTS):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape[-1] == c and g.shape == r.shape
        assert _max_rel(g, np.asarray(r)) <= 1e-4


def test_backbone_neck_channels_last_matches_nchw(backbone_pair):
    """The card runs channels_last; the layout changes no value."""
    _, _, tmodel = backbone_pair
    x = torch.from_numpy(_images(4)).permute(0, 3, 1, 2)
    with torch.no_grad():
        ref = tmodel(x.contiguous())
        got = tmodel.to(memory_format=torch.channels_last)(
            x.contiguous(memory_format=torch.channels_last))
        tmodel.to(memory_format=torch.contiguous_format)
    for g, r in zip(got, ref):
        assert _max_rel(g.numpy(), r.numpy()) <= 1e-5
