"""The port's LabeledPoint interop (``datasets/interop.py``) against the
JAX reference's: the same records give equal DataSets (features and
one-hot or continuous labels), and DataSet -> records -> DataSet is a
round trip."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import interop as jinterop
from deeplearning4j_tpu_torch.datasets import interop as tinterop
from deeplearning4j_tpu_torch.datasets.dataset import DataSet

torch.set_num_threads(2)


def _records(seed=0, n=9, d=3, k=4):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)), rng.integers(0, k, n)


@pytest.mark.parametrize("num_classes", [None, 6, 0])
def test_from_arrays_equals_reference(num_classes):
    x, labels = _records()
    t = tinterop.from_arrays(x, labels, num_classes)
    j = jinterop.from_arrays(x, labels, num_classes)
    assert t.features.dtype == torch.float32
    np.testing.assert_array_equal(t.features.numpy(), np.asarray(j.features))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))


def test_round_trip_and_records_equal_reference():
    x, labels = _records(seed=1)
    ds = tinterop.from_arrays(x, labels)
    points = tinterop.to_labeled_points(ds)
    jpoints = jinterop.to_labeled_points(jinterop.from_arrays(x, labels))
    assert [p.label for p in points] == [p.label for p in jpoints]
    for p, q in zip(points, jpoints):
        np.testing.assert_array_equal(p.features, q.features)
    back = tinterop.from_labeled_points(points, num_classes=4)
    assert torch.equal(back.features, ds.features)
    assert torch.equal(back.labels, ds.labels)
    # continuous labels ride as a [N, 1] column and come back unchanged
    reg = DataSet(torch.from_numpy(x.astype(np.float32)),
                  torch.linspace(-1, 1, len(x))[:, None])
    again = tinterop.from_labeled_points(tinterop.to_labeled_points(reg),
                                         num_classes=0)
    assert torch.equal(again.labels, reg.labels)


def test_bad_records_raise_like_the_reference():
    for bad in ([], [tinterop.LabeledPoint(1.5, np.ones(2))],
                [tinterop.LabeledPoint(-1, np.ones(2))]):
        with pytest.raises(ValueError):
            tinterop.from_labeled_points(bad)
    with pytest.raises(ValueError, match="num_classes"):
        tinterop.from_labeled_points([tinterop.LabeledPoint(3, np.ones(2))],
                                     num_classes=2)
