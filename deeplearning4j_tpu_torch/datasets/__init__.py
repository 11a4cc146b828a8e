"""Data pipeline of the port (counterpart of
``deeplearning4j_tpu/datasets``): ``DataSet``, the iterator SPI and
its iterators, the fetchers (MNIST, Iris, CSV, curves, LFW), the idx
readers and the LabeledPoint interop."""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: F401
from deeplearning4j_tpu_torch.datasets.data_service import (  # noqa: F401
    DataService, ReadPlan)
