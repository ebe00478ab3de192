"""The mask paste and the RLE's run boundaries on the card against their
CPU versions (``tpudet_torch/core/mask.py``).

Marked ``gpu``: skipped where no CUDA device is present. Imports no JAX,
so that it runs on the card's machine:

    python -m pytest --noconftest tests/test_torch_mask_kernel.py -m gpu

Tolerance: equal on every pixel and every run (the paste's arithmetic is
IEEE float64 and integer gathers on both devices; ``chip_smoke.py`` phase
12 allows MRCNN_PIXEL_SHARE of the pixels to differ where the network's
own probabilities differ, not here, where both get the same ones).
"""
import numpy as np
import pytest
import torch

from tpudet_torch.core import mask as M


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


def _inputs(seed, d=100, h=800, w=1333):
    rng = np.random.RandomState(seed)
    probs = rng.rand(d, 28, 28).astype(np.float32)
    c = rng.uniform(-0.1, 1.1, (d, 2)) * [w, h]
    wh = np.exp(rng.uniform(np.log(0.5), np.log(w), (d, 2)))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    boxes[:4, :2] = np.floor(boxes[:4, :2])
    boxes[:4, 2:] = boxes[:4, :2] + 14  # windows of half the mask
    return probs, boxes


@pytest.mark.gpu
@pytest.mark.parametrize('thr', [0.3, 0.5])
def test_paste_on_the_card_equals_the_cpu(thr):
    _card()
    probs, boxes = _inputs(int(thr * 10))
    ref = M.paste_mask_probs(probs[:20], boxes[:20], 800, 1333, thr)
    cpu = M.paste_masks(torch.from_numpy(probs), torch.from_numpy(boxes),
                        800, 1333, thr)
    card = M.paste_masks(torch.from_numpy(probs).cuda(),
                         torch.from_numpy(boxes).cuda(), 800, 1333, thr)
    assert card.is_cuda
    assert torch.equal(card.cpu(), cpu)
    assert np.array_equal(cpu[:20].numpy(), ref.astype(bool))


@pytest.mark.gpu
def test_rle_on_the_card_equals_the_cpu():
    _card()
    probs, boxes = _inputs(3)
    masks = M.paste_masks(torch.from_numpy(probs).cuda(),
                          torch.from_numpy(boxes).cuda(), 800, 1333)
    masks[0] = True  # a first pixel that is 1, a last one too
    got = M.encode_rle_batch(masks)
    assert got == M.encode_rle_batch(masks.cpu())
    for m, rle in zip(masks[:10].cpu().numpy(), got):
        assert rle == M.encode_rle(m.astype(np.uint8))
