"""DataSetIterator SPI and its in-memory and MNIST implementations.

Port of ``deeplearning4j_tpu/datasets/iterator.py`` (:31-127, :420):
``DataSetIterator``, ``BaseDatasetIterator``, ``ListDataSetIterator``
and ``MnistDataSetIterator``.  ``PrefetchIterator``,
``NativeBatchIterator`` and the sampling and multi-epoch iterators are
not ported yet (ROADMAP A5).
"""

from __future__ import annotations

from typing import Callable, Iterator as PyIterator, Optional, Sequence

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.fetchers import (DataSetFetcher,
                                                        MnistDataFetcher)


class DataSetIterator:
    """Iterator SPI (``DataSetIterator.java``); also a Python iterable."""

    def __init__(self, batch_size: int):
        self.batch = batch_size
        self.pre_processor: Optional[Callable[[DataSet], DataSet]] = None

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self, num: Optional[int] = None) -> DataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def total_examples(self) -> int:
        raise NotImplementedError

    def input_columns(self) -> int:
        raise NotImplementedError

    def total_outcomes(self) -> int:
        raise NotImplementedError

    def set_pre_processor(self, fn: Callable[[DataSet], DataSet]) -> None:
        """DataSetPreProcessor hook."""
        self.pre_processor = fn

    def _post(self, ds: DataSet) -> DataSet:
        return self.pre_processor(ds) if self.pre_processor else ds

    def __iter__(self) -> PyIterator[DataSet]:
        self.reset()
        while self.has_next():
            yield self.next()


class BaseDatasetIterator(DataSetIterator):
    """Fetcher-backed iterator (BaseDatasetIterator.java parity);
    ``num_examples <= 0`` means the fetcher's whole source."""

    def __init__(self, batch_size: int, num_examples: int,
                 fetcher: DataSetFetcher):
        super().__init__(batch_size)
        self.fetcher = fetcher
        self.num_examples = (num_examples if num_examples > 0
                             else fetcher.total)

    def has_next(self) -> bool:
        return self.fetcher.cursor < self.total_examples()

    def next(self, num: Optional[int] = None) -> DataSet:
        remaining = self.total_examples() - self.fetcher.cursor
        self.fetcher.fetch(min(num or self.batch, remaining))
        return self._post(self.fetcher.next())

    def reset(self) -> None:
        self.fetcher.reset()

    def total_examples(self) -> int:
        return min(self.num_examples, self.fetcher.total)

    def input_columns(self) -> int:
        return self.fetcher.input_columns()

    def total_outcomes(self) -> int:
        return self.fetcher.total_outcomes()


class ListDataSetIterator(DataSetIterator):
    """Over a list of batches (ListDataSetIterator.java parity)."""

    def __init__(self, batches: Sequence[DataSet], batch_size: int = 0):
        super().__init__(batch_size)
        self._batches = list(batches)
        self._i = 0

    def has_next(self) -> bool:
        return self._i < len(self._batches)

    def next(self, num: Optional[int] = None) -> DataSet:
        ds = self._batches[self._i]
        self._i += 1
        return self._post(ds)

    def reset(self) -> None:
        self._i = 0

    def total_examples(self) -> int:
        return sum(b.num_examples() for b in self._batches)

    def input_columns(self) -> int:
        return self._batches[0].num_inputs()

    def total_outcomes(self) -> int:
        return self._batches[0].num_outcomes()


class MnistDataSetIterator(BaseDatasetIterator):
    """MNIST in batches of ``batch``; keyword arguments go to
    ``MnistDataFetcher`` (``flatten=False`` for LeNet's NHWC input)."""

    def __init__(self, batch: int, num_examples: int = 0,
                 binarize: bool = True, train: bool = True, **kw):
        super().__init__(batch, num_examples,
                         MnistDataFetcher(binarize=binarize, train=train,
                                          **kw))
