"""horovod_tpu_torch's per-rank data sharding == horovod_tpu's
(``data/__init__.py``: ``DistributedSampler``, ``shard_arrays``,
``ShardedBatchIterator``) and ``utils/random.data_key``.

The same seeded NumPy arrays go through both packages across world sizes,
ranks, epochs, shuffle on and off and both ``last`` modes: every index,
batch and mask must be equal exactly (the same NumPy arithmetic), a shard
smaller than one batch too, and both raise the same ``ValueError`` for the
same bad input. ``rank`` and ``size`` default to the port's ``hvd.rank()``
and ``hvd.size()``. ``data_key`` is a ``torch.Generator`` fixed by (seed,
epoch, rank): a deliberate divergence from the reference's JAX key, whose
draws it cannot reproduce.
"""

import numpy as np
import pytest
import torch

from horovod_tpu import data as jdata

from horovod_tpu_torch import data as pdata
from horovod_tpu_torch.utils.random import data_key

WORLDS = [(1, 0), (2, 1), (3, 2), (4, 0), (4, 3), (8, 5)]


def _arrays(n=23):
    g = np.random.default_rng(3)
    return [g.standard_normal((n, 4)).astype(np.float32),
            g.integers(0, 100, n).astype(np.int32)]


@pytest.mark.parametrize("size,rank", WORLDS)
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("num_samples", [1, 7, 23, 64])
def test_sampler_indices_equal_the_reference(size, rank, shuffle,
                                             num_samples):
    kw = dict(rank=rank, size=size, shuffle=shuffle, seed=5)
    p = pdata.DistributedSampler(num_samples, **kw)
    j = jdata.DistributedSampler(num_samples, **kw)
    for epoch in (0, 1, 7):
        p.set_epoch(epoch)
        j.set_epoch(epoch)
        assert list(p) == list(j)
        assert len(p) == len(j)


@pytest.mark.parametrize("size,rank", WORLDS)
@pytest.mark.parametrize("last", ["drop", "pad"])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("batch", [1, 4, 5, 16])
def test_batches_and_masks_equal_the_reference(size, rank, last, shuffle,
                                               batch):
    arrays = _arrays()
    kw = dict(rank=rank, size=size, shuffle=shuffle, seed=9, last=last)
    p = pdata.ShardedBatchIterator(arrays, batch, **kw)
    j = jdata.ShardedBatchIterator(arrays, batch, **kw)
    for epoch in (0, 3):
        p.set_epoch(epoch)
        j.set_epoch(epoch)
        got, want = list(p), list(j)
        assert len(got) == len(want) == len(p) == len(j)
        for (pb, pm), (jb, jm) in zip(got, want):
            assert len(pb) == len(jb) == 2
            for x, y in zip(pb, jb):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(pm, jm)


@pytest.mark.parametrize("size", [4, 8])
def test_shard_smaller_than_a_batch_is_padded_by_cycling(size):
    arrays = _arrays(9)
    for rank in range(size):
        kw = dict(rank=rank, size=size, shuffle=True, seed=1, last="pad")
        (pb, pm), = list(pdata.ShardedBatchIterator(arrays, 8, **kw))
        (jb, jm), = list(jdata.ShardedBatchIterator(arrays, 8, **kw))
        for x, y in zip(pb, jb):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(pm, jm)
        assert pm.sum() == -(-9 // size) and pb[0].shape == (8, 4)
        assert list(pdata.ShardedBatchIterator(
            arrays, 8, **dict(kw, last="drop"))) == []


@pytest.mark.parametrize("size,rank", WORLDS)
def test_shard_arrays_equal_the_reference(size, rank):
    arrays = _arrays()
    got = pdata.shard_arrays(arrays, rank=rank, size=size)
    want = jdata.shard_arrays(arrays, rank=rank, size=size)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


ERRORS = {
    "rank_out_of_range": lambda m: m.DistributedSampler(4, rank=2, size=2),
    "negative_rank": lambda m: m.DistributedSampler(4, rank=-1, size=2),
    "bad_last": lambda m: m.ShardedBatchIterator(_arrays(), 2, rank=0,
                                                 size=1, last="keep"),
    "ragged_iterator": lambda m: m.ShardedBatchIterator(
        [np.zeros(3), np.zeros(4)], 2, rank=0, size=1),
    "ragged_shard": lambda m: m.shard_arrays(
        [np.zeros(3), np.zeros(4)], rank=0, size=1),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_are_the_references(case):
    with pytest.raises(ValueError) as want:
        ERRORS[case](jdata)
    with pytest.raises(ValueError) as got:
        ERRORS[case](pdata)
    assert str(got.value) == str(want.value)


def test_rank_and_size_default_to_the_ports_world(monkeypatch):
    from horovod_tpu_torch import core
    monkeypatch.setattr(core, "rank", lambda: 2)
    monkeypatch.setattr(core, "size", lambda: 3)
    s = pdata.DistributedSampler(10, seed=4)
    assert (s.rank, s.size) == (2, 3)
    assert list(s) == list(jdata.DistributedSampler(10, rank=2, size=3,
                                                    seed=4))
    it = pdata.ShardedBatchIterator(_arrays(10), 2, seed=4)
    assert (it.sampler.rank, it.sampler.size) == (2, 3)
    got = pdata.shard_arrays(_arrays(10))
    np.testing.assert_array_equal(got[0], _arrays(10)[0][2::3])


def test_packer_is_still_exported():
    assert pdata.pack_documents is not None and pdata.pack_rows is not None


def test_data_key_is_a_generator_fixed_by_seed_epoch_and_rank():
    def draw(*a):
        return torch.randint(0, 2 ** 30, (8,), generator=data_key(*a))
    assert isinstance(data_key(0, 0, 0), torch.Generator)
    assert torch.equal(draw(1, 2, 3), draw(1, 2, 3))
    draws = [draw(*k) for k in ((1, 2, 3), (1, 2, 4), (1, 3, 3), (2, 2, 3))]
    for i in range(len(draws)):
        for j in range(i):
            assert not torch.equal(draws[i], draws[j])
    # Before init the rank is 0.
    assert torch.equal(draw(1, 2), draw(1, 2, 0))
