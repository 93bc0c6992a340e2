"""mmhand_torch.data.loader.HostLoader against mmhand_tpu's: the same
batches, in the same order, over an RHD-layout tree, whatever the worker
count, the prefetch depth, the cache and the ragged last batch."""

import numpy as np
import pytest

from mmhand_torch import config as tcfg
from mmhand_torch.data import datasets as tds
from mmhand_torch.data import loader as tloader
from mmhand_torch.data.rhd_tree import write_block_tree
from mmhand_tpu import config as jcfg
from mmhand_tpu.data import datasets as jds
from mmhand_tpu.data import loader as jloader

N, SIZE = 11, 32


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_block_tree(tmp_path_factory.mktemp("loader") / "tree", N,
                            SIZE)


def _dataset(module, datasets, root):
    cfg = module.Config(model=module.ModelConfig(fine_size=SIZE),
                        data=module.DataConfig(dataset="RHD", dataroot=root))
    return datasets.build_dataset(cfg)


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, num_threads=4, prefetch=2),
    dict(batch_size=3, num_threads=1, prefetch=0, drop_last=False),
    dict(batch_size=2, num_threads=8, prefetch=1, cache=True),
    dict(batch_size=5, num_threads=3, prefetch=2, max_items=9,
         drop_last=False, shuffle=False),
], ids=["default", "one_thread", "cached", "ragged_serial"])
def test_batches_match_jax(tree, kw):
    kw = dict(kw)
    bsz = kw.pop("batch_size")
    port = tloader.HostLoader(_dataset(tcfg, tds, tree), bsz, seed=7, **kw)
    ref = jloader.HostLoader(_dataset(jcfg, jds, tree), bsz, seed=7, **kw)
    for epoch in (0, 1, 1):
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == port.steps_per_epoch() > 0
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]))
