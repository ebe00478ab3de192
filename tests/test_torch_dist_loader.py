"""The loaders' shards: the port's ``DetDataLoader`` and
``MosaicTileLoader`` at ``process_index`` 0 and 1 of 2 against tpudet's
at the same ranks (``tpudet/data/loader.py``): the same indices in each
epoch, the same per-image augmentation seeds and the same Mosaic partners
(tiles equal), seeded alike (tpudet's global ``random`` with ``seed +
epoch``, as the port seeds its dataset's generator). No process group is
needed: a rank's loader reads only its own rank and count.

tpudet's global batch of a step is the ranks' loader batches one after the
other, and its train step reshapes it to (accumulation, -1); the port's
rank ``r`` takes micro-batch ``i`` from its own ``i``-th slice
(``test_torch_dist_train_step.py`` holds the step in that grouping). At
accumulation 1 the two are the same rows; the last test here shows it."""
import random

import numpy as np
import pytest

from tpudet.data import build_dataset as jax_build_dataset
from tpudet.data.loader import DetDataLoader as JaxLoader
from tpudet.data.loader import MosaicTileLoader as JaxTileLoader
from tpudet_torch.data import build_dataset
from tpudet_torch.data.loader import DetDataLoader, MosaicTileLoader

from .test_torch_train_loop import IMG, N_IMAGES, cfg_dict, coco  # noqa
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

WORLD, SEED = 2, 3


@pytest.fixture(scope='module')
def datasets(coco):  # noqa: F811
    cfg = cfg_dict(*coco, device_aug=True, backend='cv2')
    return (jax_build_dataset(cfg['data']['train']),
            build_dataset(cfg['data']['train'], dict(device='cpu')))


@pytest.mark.parametrize('rank', range(WORLD))
@pytest.mark.parametrize('shuffle, drop_last', [(True, True),
                                                (False, False)])
def test_each_rank_takes_tpudets_indices(datasets, rank, shuffle,
                                         drop_last):
    ref_ds, got_ds = datasets
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=SEED,
              process_index=rank, process_count=WORLD)
    # 3 images a batch: 16 images in 2 shards of 8, so a shard ends in a
    # part batch, which drop_last keeps or drops
    ref, got = JaxLoader(ref_ds, 3, **kw), DetDataLoader(got_ds, 3, **kw)
    seen = set()
    for epoch in range(3):
        ref.set_epoch(epoch)
        got.set_epoch(epoch)
        np.testing.assert_array_equal(got._indices(), ref._indices())
        assert len(got) == len(ref)
        seen |= set(got._indices().tolist())
    assert len(seen) > N_IMAGES // WORLD if shuffle else \
        seen == set(range(rank, N_IMAGES, WORLD))


@pytest.mark.parametrize('rank', range(WORLD))
def test_each_rank_draws_tpudets_seeds_and_partners(datasets, rank):
    ref_ds, got_ds = datasets
    kw = dict(tile_size=IMG, max_gts_per_tile=2, seed=SEED,
              process_index=rank, process_count=WORLD)
    ref_l, got_l = JaxTileLoader(ref_ds, 2, **kw), \
        MosaicTileLoader(got_ds, 2, **kw)
    ref_l.set_epoch(1)
    got_l.set_epoch(1)
    random.seed(SEED + 1)
    ref_b, got_b = list(ref_l), list(got_l)
    assert len(got_b) == len(ref_b) == N_IMAGES // WORLD // 2
    for g, r in zip(got_b, ref_b):
        # equal tiles: the same images and the same three partners each
        np.testing.assert_array_equal(g['tiles'].numpy(), r['tiles'])
        for k in ('tile_hw', 'gt_bboxes', 'gt_labels', 'gt_valid',
                  'aug_seed'):
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_at_accumulation_one_the_ranks_hold_tpudets_global_batch(
        datasets):
    """Step ``s`` of the two ranks together holds the epoch order's
    ``s``-th global batch, the rows a one-process run would take."""
    ref_ds, got_ds = datasets
    loaders = [DetDataLoader(got_ds, 2, seed=SEED, process_index=r,
                             process_count=WORLD) for r in range(WORLD)]
    for lo in loaders:
        lo.set_epoch(2)
    order = np.random.RandomState(SEED + 2).permutation(N_IMAGES)
    steps = len(loaders[0])
    for s in range(steps):
        ranks = [lo._indices()[s * 2:(s + 1) * 2] for lo in loaders]
        assert sorted(np.concatenate(ranks).tolist()) == sorted(
            order[s * 4:(s + 1) * 4].tolist())
