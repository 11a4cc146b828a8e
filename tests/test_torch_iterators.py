"""The port's iterators against the JAX reference's
(``datasets/iterator.py``): the sampling, multi-epoch, reconstruction,
Iris and native-batch iterators.

Both packages draw with numpy's ``default_rng`` from the same seed (the
native batcher with the same C++ source), so every batch is held EQUAL
to the reference's, features and labels, not merely alike.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import iterator as jit
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.runtime import native as jnative
from deeplearning4j_tpu_torch.datasets import iterator as tit
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.runtime import native as tnative

torch.set_num_threads(2)


def _arrays(n=30, d=4, k=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.eye(k, dtype=np.float32)[rng.integers(0, k, n)]
    return x, y


def _same(tds, jds):
    assert isinstance(tds.features, torch.Tensor)
    assert tds.features.device.type == "cpu"
    np.testing.assert_array_equal(tds.features.numpy(),
                                  np.asarray(jds.features))
    np.testing.assert_array_equal(tds.labels.numpy(), np.asarray(jds.labels))


def _drain(it):
    out = []
    while it.has_next():
        out.append(it.next())
    return out


def test_sampling_iterator_draws_the_reference_rows():
    x, y = _arrays()
    t = tit.SamplingDataSetIterator(TDataSet(torch.from_numpy(x),
                                             torch.from_numpy(y)),
                                    batch_size=7, total_samples=30, seed=4,
                                    device="cpu")
    j = jit.SamplingDataSetIterator(JDataSet(x, y), batch_size=7,
                                    total_samples=30, seed=4)
    tb, jb = _drain(t), _drain(j)
    assert len(tb) == len(jb) == 5
    for a, b in zip(tb, jb):
        _same(a, b)
    assert (t.total_examples(), t.input_columns(), t.total_outcomes()) == \
        (30, 4, 3)
    t.reset()                                   # replays the same draws
    j.reset()
    _same(t.next(), j.next())
    _same(t.next(num=3), j.next(num=3))


def test_multiple_epochs_and_reconstruction_iterators():
    x, y = _arrays(n=12)
    tparts = [TDataSet(torch.from_numpy(x[i:i + 4]),
                       torch.from_numpy(y[i:i + 4])) for i in (0, 4, 8)]
    jparts = [JDataSet(x[i:i + 4], y[i:i + 4]) for i in (0, 4, 8)]
    t = tit.MultipleEpochsIterator(3, tit.ListDataSetIterator(tparts, 4))
    j = jit.MultipleEpochsIterator(3, jit.ListDataSetIterator(jparts, 4))
    tb, jb = _drain(t), _drain(j)
    assert len(tb) == len(jb) == 9
    for a, b in zip(tb, jb):
        _same(a, b)
    assert t.total_examples() == j.total_examples() == 36
    t.reset()
    assert len(list(t)) == 9
    r = tit.ReconstructionDataSetIterator(tit.ListDataSetIterator(tparts, 4))
    r.set_pre_processor(lambda ds: TDataSet(ds.features * 2,
                                            ds.labels * 2))
    out = _drain(r)
    assert len(out) == 3
    for ds, part in zip(out, tparts):
        assert torch.equal(ds.labels, ds.features)
        assert torch.equal(ds.features, part.features * 2)
    assert r.total_outcomes() == r.input_columns() == 4


def test_iris_iterator_equals_reference():
    t, j = tit.IrisDataSetIterator(40), jit.IrisDataSetIterator(40)
    tb, jb = _drain(t), _drain(j)
    assert [b.num_examples() for b in tb] == [40, 40, 40, 30]
    for a, b in zip(tb, jb):
        _same(a, b)
    assert (t.total_examples(), t.input_columns(), t.total_outcomes()) == \
        (150, 4, 3)


def test_native_batch_iterator_equals_reference():
    assert tnative.available(), tnative.build_error
    if not jnative.available():
        pytest.skip("the reference's native library did not build")
    x, y = _arrays(n=40, d=6, k=4, seed=2)
    t = tit.NativeBatchIterator(x, y, batch_size=10, seed=1, device="cpu")
    j = jit.NativeBatchIterator(x, y, batch_size=10, seed=1)
    try:
        assert t.uses_native and j.uses_native
        for _ in range(2):                       # two epochs of one stream
            tb, jb = _drain(t), _drain(j)
            assert len(tb) == 4
            for a, b in zip(tb, jb):
                _same(a, b)
            t.reset()
            j.reset()
        assert t.has_next()
    finally:
        t.close()
        j.close()
    with pytest.raises(RuntimeError):
        t.next()


def test_native_batch_iterator_python_fallback_equals_reference(
        monkeypatch):
    class Unavailable:
        def __init__(self, *a, **k):
            raise RuntimeError("native library unavailable")

    monkeypatch.setattr(tnative, "NativeBatcher", Unavailable)
    monkeypatch.setattr(jnative, "NativeBatcher", Unavailable)
    x = np.arange(24, dtype=np.float32)[:, None]
    y = x[:, 0] * 2                               # 1-D labels
    t = tit.NativeBatchIterator(x, y, batch_size=6, seed=0, device="cpu")
    j = jit.NativeBatchIterator(x, y, batch_size=6, seed=0)
    assert not t.uses_native and not j.uses_native
    for _ in range(2):
        tb, jb = _drain(t), _drain(j)
        for a, b in zip(tb, jb):
            _same(a, b)
        seen = np.concatenate([a.features.numpy()[:, 0] for a in tb])
        assert sorted(seen.tolist()) == list(range(24))
        t.reset()
        j.reset()
    t.close()
    with pytest.raises(RuntimeError):
        t.next()
