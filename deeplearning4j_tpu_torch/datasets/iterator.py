"""DataSetIterator SPI and its in-memory and MNIST implementations.

Port of ``deeplearning4j_tpu/datasets/iterator.py``: ``DataSetIterator``,
``BaseDatasetIterator``, ``ListDataSetIterator``,
``SamplingDataSetIterator``, ``MultipleEpochsIterator``,
``ReconstructionDataSetIterator``, ``PrefetchIterator`` (what the
data-parallel ``fit_iterator`` needs), ``MnistDataSetIterator``,
``IrisDataSetIterator`` and ``NativeBatchIterator`` (the native library's
threaded batch producer).  The fetcher-backed iterators hand out CPU
tensors that the fit moves; the sampling and native iterators put their
batches on their ``device`` (None means ``"cuda"``).  Random draws use
numpy's ``default_rng`` with the reference's seeds, so a seed gives the
reference's batches, not just batches alike.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Iterator as PyIterator, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.fetchers import (DataSetFetcher,
                                                        IrisDataFetcher,
                                                        MnistDataFetcher)

log = logging.getLogger(__name__)


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


class SamplingDataSetIterator(DataSetIterator):
    """Random with-replacement sampling from a source DataSet
    (SamplingDataSetIterator.java parity, reference :129-163): batch
    rows drawn by ``np.random.default_rng(seed)``, on ``device``."""

    def __init__(self, source: DataSet, batch_size: int,
                 total_samples: int, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__(batch_size)
        self.source = source
        self.total_samples = total_samples
        self.device = resolve_device(device)
        self._x = _tensor_on(source.features, self.device)
        self._y = _tensor_on(source.labels, self.device)
        self._seed = seed
        self._drawn = 0
        self._rng = np.random.default_rng(seed)

    def has_next(self) -> bool:
        return self._drawn < self.total_samples

    def next(self, num: Optional[int] = None) -> DataSet:
        n = num or self.batch
        idx = self._rng.integers(0, self.source.num_examples(), size=n)
        self._drawn += n
        idx = torch.from_numpy(idx).to(self.device)
        return self._post(DataSet(self._x[idx], self._y[idx]))

    def reset(self) -> None:
        self._drawn = 0
        self._rng = np.random.default_rng(self._seed)

    def total_examples(self) -> int:
        return self.total_samples

    def input_columns(self) -> int:
        return self.source.num_inputs()

    def total_outcomes(self) -> int:
        return self.source.num_outcomes()


class MultipleEpochsIterator(DataSetIterator):
    """``inner`` for ``num_epochs`` passes (MultipleEpochsIterator.java
    parity, reference :166-198)."""

    def __init__(self, num_epochs: int, inner: DataSetIterator):
        super().__init__(inner.batch)
        self.inner = inner
        self.num_epochs = num_epochs
        self._epoch = 0

    def has_next(self) -> bool:
        if self.inner.has_next():
            return True
        if self._epoch + 1 < self.num_epochs:
            self._epoch += 1
            self.inner.reset()
            return self.inner.has_next()
        return False

    def next(self, num: Optional[int] = None) -> DataSet:
        return self.inner.next(num)

    def reset(self) -> None:
        self._epoch = 0
        self.inner.reset()

    def total_examples(self) -> int:
        return self.inner.total_examples() * self.num_epochs

    def input_columns(self) -> int:
        return self.inner.input_columns()

    def total_outcomes(self) -> int:
        return self.inner.total_outcomes()


class ReconstructionDataSetIterator(DataSetIterator):
    """labels := features (ReconstructionDataSetIterator.java parity,
    reference :201-225)."""

    def __init__(self, inner: DataSetIterator):
        super().__init__(inner.batch)
        self.inner = inner

    def has_next(self) -> bool:
        return self.inner.has_next()

    def next(self, num: Optional[int] = None) -> DataSet:
        ds = self.inner.next(num)
        return self._post(DataSet(ds.features, ds.features))

    def reset(self) -> None:
        self.inner.reset()

    def total_examples(self) -> int:
        return self.inner.total_examples()

    def input_columns(self) -> int:
        return self.inner.input_columns()

    def total_outcomes(self) -> int:
        return self.inner.input_columns()


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


class IrisDataSetIterator(BaseDatasetIterator):
    """Iris in batches of ``batch``; keyword arguments go to
    ``IrisDataFetcher``."""

    def __init__(self, batch: int, num_examples: int = 0, **kw):
        super().__init__(batch, num_examples, IrisDataFetcher(**kw))


_python_producer_noted = False


def _warn_python_producer(err: Exception) -> None:
    """Log, once a process, that NativeBatchIterator draws in Python."""
    global _python_producer_noted
    if not _python_producer_noted:
        _python_producer_noted = True
        log.warning("NativeBatchIterator: the native library is "
                    "unavailable (%s); batches come from the Python "
                    "producer, in another order for the same seed", err)


class NativeBatchIterator(DataSetIterator):
    """Shuffled minibatches assembled by the native library's producer
    thread (``runtime/native.NativeBatcher``, reference :432-520): the
    gather runs off the Python thread and overlaps device work.  Where
    the library is unavailable it draws the same way in Python (a numpy
    permutation an epoch, ``default_rng(seed + epoch)``), so callers
    never branch; ``uses_native`` says which runs, and the first Python
    producer of a process logs a warning.  The two producers give
    different batch orders for the same seed (the native one draws with
    its own generator), so whether the library built changes the order
    a fit sees, not the batches' contents or count.  Batches land on
    ``device``.

    ``has_next`` is epoch-scoped like BaseDatasetIterator: one epoch of
    full batches, then ``reset()`` rewinds the epoch counter (the native
    stream keeps producing across epochs).
    """

    def __init__(self, features: np.ndarray, labels: np.ndarray,
                 batch_size: int, seed: int = 0, shuffle: bool = True,
                 device: DeviceLike = None):
        from deeplearning4j_tpu_torch.runtime.native import NativeBatcher

        super().__init__(batch_size)
        self.device = resolve_device(device)
        self._x = np.ascontiguousarray(features, dtype=np.float32)
        self._y = np.ascontiguousarray(labels, dtype=np.float32)
        if self._y.ndim == 1:
            self._y = self._y[:, None]
        self._seed = seed
        self._shuffle = shuffle
        self._native = None
        self._closed = False
        # the Python state is always set: next() takes it both when the
        # library is absent and after close()
        self.batches_per_epoch = max(len(self._x) // batch_size, 1)
        self._epoch = 0
        self._order = self._make_order()
        try:
            self._native = NativeBatcher(self._x, self._y, batch_size,
                                         seed=seed, shuffle=shuffle)
            self.batches_per_epoch = self._native.batches_per_epoch
        except RuntimeError as e:
            _warn_python_producer(e)
        self._cursor = 0

    def _make_order(self) -> np.ndarray:
        if not self._shuffle:
            return np.arange(len(self._x))
        rng = np.random.default_rng(self._seed + self._epoch)
        return rng.permutation(len(self._x))

    @property
    def uses_native(self) -> bool:
        return self._native is not None

    def has_next(self) -> bool:
        return self._cursor < self.batches_per_epoch

    def next(self, num: Optional[int] = None) -> DataSet:
        if self._closed:
            raise RuntimeError("NativeBatchIterator is closed")
        if self._native is not None:
            bx, by = self._native.next()
        else:
            b, n = self.batch, len(self._x)
            idx = self._order[(self._cursor * b + np.arange(b)) % n]
            bx, by = self._x[idx], self._y[idx]
            if self._cursor + 1 >= self.batches_per_epoch:
                self._epoch += 1
                self._order = self._make_order()
        self._cursor += 1
        return self._post(DataSet(torch.from_numpy(bx).to(self.device),
                                  torch.from_numpy(by).to(self.device)))

    def reset(self) -> None:
        self._cursor = 0

    def total_examples(self) -> int:
        return len(self._x)

    def input_columns(self) -> int:
        return self._x.shape[1]

    def total_outcomes(self) -> int:
        return self._y.shape[1]

    def close(self) -> None:
        self._closed = True
        if self._native is not None:
            self._native.close()
            self._native = None
