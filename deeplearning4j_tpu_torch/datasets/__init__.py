"""Data pipeline of the port (counterpart of
``deeplearning4j_tpu/datasets``): ``DataSet``, the iterator SPI, the
MNIST fetcher and idx readers."""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: F401
