"""DataSetIterator SPI and its in-memory and MNIST implementations.

Port of ``deeplearning4j_tpu/datasets/iterator.py`` (:31-127, :228-420):
``DataSetIterator``, ``BaseDatasetIterator``, ``ListDataSetIterator``,
``PrefetchIterator`` (what the data-parallel ``fit_iterator`` needs) and
``MnistDataSetIterator``.  ``NativeBatchIterator`` and the sampling and
multi-epoch iterators are not ported yet (ROADMAP A5b).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator as PyIterator, Optional, Sequence

import torch

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


def _tensor_on(a, device) -> torch.Tensor:
    """``a`` as a tensor on ``device``, float64 as fp32 (as JAX without
    x64 takes numpy arrays)."""
    t = torch.as_tensor(a)
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device)


class PrefetchIterator(DataSetIterator):
    """A background thread pulls batches from ``inner`` and stages them
    into a queue of ``depth`` (reference :228-419), so the host prepares
    batch k+1 while the device runs step k.

    ``sharding`` (``parallel/sharded_fit.batch_sharding(mesh)``) stages
    each batch for the data-parallel step: zero-padded to a multiple of
    ``pad_rows_to`` rows, cut to this rank's row block and moved to its
    device.  The staged ``DataSet`` carries ``n_valid`` (the batch's
    real rows, for the masked loss) and ``staged = True``; every staged
    batch books its bytes and wall time into ``runtime.metrics.
    dp_metrics``.  Without ``sharding`` batches pass through as they
    are.

    ``close()`` (or leaving a ``with`` block) stops the producer, drains
    its queue and joins the thread; a producer error surfaces from
    ``next()`` after the same drain.  ``reset()`` rewinds ``inner`` for
    another pass."""

    _STOP = object()

    def __init__(self, inner: DataSetIterator, depth: int = 2,
                 sharding=None, pad_rows_to: int = 0):
        super().__init__(inner.batch)
        self.inner = inner
        self.depth = depth
        self.sharding = sharding
        self.pad_rows_to = pad_rows_to
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self._peeked = None
        self._done = False

    def _stage(self, ds: DataSet) -> DataSet:
        """Pad, cut and move one batch (on the producer thread)."""
        from deeplearning4j_tpu_torch.parallel.mesh import pad_rows
        from deeplearning4j_tpu_torch.runtime import telemetry
        from deeplearning4j_tpu_torch.runtime.metrics import dp_metrics

        n_valid = int(ds.features.shape[0])
        x, y = ds.features, ds.labels
        if self.pad_rows_to > 1 and n_valid % self.pad_rows_to:
            target = -(-n_valid // self.pad_rows_to) * self.pad_rows_to
            x, y = pad_rows(x, target), pad_rows(y, target)
        t0 = time.perf_counter()
        x = _tensor_on(self.sharding.place(x), self.sharding.device)
        y = _tensor_on(self.sharding.place(y), self.sharding.device)
        stage_ms = (time.perf_counter() - t0) * 1e3
        nbytes = x.numel() * x.element_size() + y.numel() * y.element_size()
        dp_metrics.note_staged(nbytes, stage_ms)
        tr = telemetry.get_tracer()
        if tr is not None:
            tr.event("ingest.stage", bytes=int(nbytes),
                     stage_ms=round(stage_ms, 3), rows=n_valid)
        staged = DataSet(x, y)
        staged.n_valid = n_valid
        staged.staged = True
        return staged

    def _producer(self, q: queue.Queue, stop: threading.Event) -> None:
        try:
            while self.inner.has_next() and not stop.is_set():
                ds = self.inner.next()
                if self.sharding is not None:
                    ds = self._stage(ds)
                while not stop.is_set():
                    try:
                        q.put(ds, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # noqa: BLE001 — surfaced by next()
            try:
                q.put(e, timeout=1.0)
            except queue.Full:
                pass
        finally:
            while not stop.is_set():
                try:
                    q.put(self._STOP, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def _ensure_started(self) -> None:
        if self._thread is None:
            self._queue = queue.Queue(maxsize=self.depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._producer, args=(self._queue, self._stop),
                daemon=True)
            self._thread.start()

    def has_next(self) -> bool:
        if self._peeked is not None:
            return True
        if self._done:
            return False
        self._ensure_started()
        item = self._queue.get()
        if item is self._STOP:
            self._done = True
            return False
        self._peeked = item
        return True

    def next(self, num: Optional[int] = None) -> DataSet:
        if not self.has_next():
            raise StopIteration
        ds, self._peeked = self._peeked, None
        if isinstance(ds, Exception):
            self._shutdown()
            self._done = True
            raise RuntimeError("prefetch producer failed") from ds
        return self._post(ds)

    def _shutdown(self) -> None:
        """Stop the producer, discard its queue, join the thread."""
        if self._thread is not None:
            self._stop.set()
            while self._thread.is_alive() or not self._queue.empty():
                try:
                    self._queue.get(timeout=0.1)
                except queue.Empty:
                    if not self._thread.is_alive():
                        break
            self._thread.join(timeout=5)
        self._thread = None
        self._queue = None
        self._stop = None
        self._peeked = None

    def close(self) -> None:
        """Terminal drain of an abandoned pass; idempotent."""
        self._shutdown()
        self._done = True

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def reset(self) -> None:
        self._shutdown()
        self._done = False
        self.inner.reset()

    def total_examples(self) -> int:
        return self.inner.total_examples()

    def input_columns(self) -> int:
        return self.inner.input_columns()

    def total_outcomes(self) -> int:
        return self.inner.total_outcomes()


class MnistDataSetIterator(BaseDatasetIterator):
    """MNIST in batches of ``batch``; keyword arguments go to
    ``MnistDataFetcher`` (``flatten=False`` for LeNet's NHWC input)."""

    def __init__(self, batch: int, num_examples: int = 0,
                 binarize: bool = True, train: bool = True, **kw):
        super().__init__(batch, num_examples,
                         MnistDataFetcher(binarize=binarize, train=train,
                                          **kw))
