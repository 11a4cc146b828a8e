"""InferenceEngine — shape-bucketed inference serving on the card.

Port of ``deeplearning4j_tpu/serving/engine.py`` (:60-296).  What stays:

- incoming batches are padded on the host up to a fixed **bucket
  ladder** and the result rows sliced back out, so the forward only ever
  sees the ladder's batch sizes;
- requests larger than the ladder are chunked by its largest bucket;
- the forward runs through the compile engine (``runtime/compile_cache``,
  the reference's ``cached_jit`` at :162): on the card each bucket is
  one CUDA graph, captured by ``warmup()`` (or a bucket's first
  request) and replayed after, so a warm-up books one compile a bucket
  and steady traffic none (``serving_metrics.mark_compiles`` /
  ``compile_delta_since_mark``);
- ``input_spec`` records the per-example shape and dtype served, so the
  batcher can reject a mismatched request at submit time.

``quantize="int8"|"bf16"`` serves post-training quantized weights
(``runtime/quantize.py``): the params are quantized once per distinct
tree and dequantized (fp32, the reference's default) inside the
captured forward, which is its own engine entry keyed on the mode.

Params are read-only arguments of the captured forward: a call with
other params than the last ones (a live network after a fit, an
explicit ``params=``) has them copied into the graph's buffers, with no
new capture; the engine's own params are copied once, not per request.
The padded batch is copied in at every dispatch, and the output rows
are a clone of the graph's output (the engine's boundary rule).

``apply_fn(params, x)`` takes the padded batch as a tensor on the
engine's device and returns one tensor whose rows depend only on the
matching input rows; padded rows then cannot perturb real ones.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.runtime import compile_cache
from deeplearning4j_tpu_torch.runtime import quantize as qz
from deeplearning4j_tpu_torch.runtime import telemetry
from deeplearning4j_tpu_torch.runtime.metrics import (compile_metrics,
                                                      serving_metrics)

#: default ladder: powers of two up to max_batch_size
DEFAULT_MAX_BATCH = 256


def default_buckets(max_batch_size: int = DEFAULT_MAX_BATCH) -> Tuple[int, ...]:
    """Powers-of-two ladder 1, 2, 4, ... up to (and including) the
    smallest power >= max_batch_size."""
    if max_batch_size < 1:
        raise ValueError(f"max_batch_size must be >= 1: {max_batch_size}")
    ladder = [1]
    while ladder[-1] < max_batch_size:
        ladder.append(ladder[-1] * 2)
    return tuple(ladder)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; callers chunk by the largest bucket first,
    so n <= max(buckets) always holds here."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"no bucket >= {n} in {buckets}")


def pad_rows(x, bucket: int):
    """Zero-pad the leading (batch) dim up to ``bucket``, so the device
    only ever sees ladder shapes: a numpy batch on the host, a tensor on
    its own device."""
    n = x.shape[0]
    if n == bucket:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((bucket - n,) + x.shape[1:])])
    buf = np.zeros((bucket,) + x.shape[1:], dtype=x.dtype)
    buf[:n] = x
    return buf


class InferenceEngine:
    """Bucketed forward for any model, on ``device`` (None = CUDA).

    ``params`` may be the params themselves or a zero-arg callable
    returning them (so a live model's current params are served).
    With ``quantize``, static params are quantized once and the engine
    drops its reference to the raw tree; a callable's trees are
    quantized once each (memoized on identity).  ``apply_fn`` may also
    be an engine-wrapped callable (a ``cached_graph`` result, as
    ``MultiLayerNetwork`` shares one per conf), used as it is.
    """

    def __init__(self, apply_fn: Callable, params: Any = None, *,
                 buckets: Optional[Sequence[int]] = None,
                 max_batch_size: int = DEFAULT_MAX_BATCH,
                 quantize: Optional[str] = None,
                 device: DeviceLike = None):
        self.quantize = qz.check_mode(quantize)
        self.device = resolve_device(device)
        self.buckets = tuple(sorted(set(
            buckets if buckets is not None
            else default_buckets(max_batch_size))))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"bad bucket ladder: {self.buckets}")
        if isinstance(apply_fn, compile_cache.GraphFn):
            if self.quantize is not None:
                raise ValueError(
                    "quantize= needs a raw apply_fn: an engine-wrapped "
                    "callable cannot be rekeyed on the quantization mode")
            self._forward = apply_fn
        else:
            if self.quantize is not None:
                raw_apply = apply_fn

                def apply_fn(params, x):
                    return raw_apply(qz.dequantize_tree(params), x)
            self._forward = compile_cache.cached_graph(
                apply_fn, label="serving.forward")
        self._served = qz.ServedParams(
            params, None if self.quantize is None
            else lambda raw: qz.quantize_tree(raw, self.quantize))
        #: (per-example shape, dtype) the engine serves — set by
        #: warmup() / the first successful infer
        self.input_spec: Optional[Tuple[Tuple[int, ...], Any]] = None

    def current_params(self, params: Any = None) -> Any:
        """The tree the forward takes: quantized when ``quantize`` is
        set (:class:`runtime.quantize.ServedParams`)."""
        return self._served.get(params)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, input_shape: Optional[Sequence[int]] = None,
               dtype: Any = np.float32, example: Any = None,
               params: Any = None) -> dict:
        """Run every bucket once before traffic arrives (on the card:
        capture its graph).  ``input_shape`` is the per-example shape (no
        batch dim), or pass ``example`` (a representative batch).
        Returns ``{"buckets": n, "compiles": captures booked,
        "warmup_ms": wall}``."""
        if example is not None:
            ex = np.asarray(example)
            input_shape, dtype = ex.shape[1:], ex.dtype
        if input_shape is None:
            raise ValueError("warmup needs input_shape=... or example=...")
        self.input_spec = (tuple(input_shape), np.dtype(dtype))
        p = self.current_params(params)
        t0 = time.perf_counter()
        c0 = compile_metrics.compile_count
        with telemetry.span("serving.warmup", buckets=len(self.buckets)):
            for b in self.buckets:
                self._call_forward(p, np.zeros((b,) + tuple(input_shape),
                                               dtype=dtype))
            self._sync()
        return {"buckets": len(self.buckets),
                "compiles": compile_metrics.compile_count - c0,
                "warmup_ms": (time.perf_counter() - t0) * 1e3}

    def _call_forward(self, params: Any, x) -> torch.Tensor:
        xt = (x.to(self.device) if isinstance(x, torch.Tensor)
              else torch.from_numpy(np.array(x)).to(self.device))
        with torch.inference_mode():
            return self._forward(params, xt)

    def _dispatch(self, x, params: Any) -> torch.Tensor:
        """One bucketed forward: pad -> apply -> slice rows out."""
        n = x.shape[0]
        bucket = pick_bucket(n, self.buckets)
        serving_metrics.note_dispatch(bucket)
        tr = telemetry.get_tracer()
        sp = tr.span("serving.dispatch", bucket=bucket, rows=n) \
            if tr is not None else telemetry.NOOP_SPAN
        with sp:
            out = self._call_forward(params, pad_rows(x, bucket))
        return out if bucket == n else out[:n]

    def infer(self, x, params: Any = None, sync: bool = False,
              count_request: bool = True) -> torch.Tensor:
        """Serve one request batch ``[n, ...]`` (numpy, or a tensor on
        any device): bucket-pad, run the forward, slice the n real rows
        back out.  Requests larger than the ladder are chunked by the
        largest bucket.  ``sync=True`` waits for the device, so the
        recorded latency is honest."""
        t0 = time.perf_counter()
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        if x.ndim == 0:
            raise ValueError("infer expects a batched input [n, ...]")
        n = x.shape[0]
        if count_request:
            serving_metrics.note_request(n)
        tr = telemetry.get_tracer()
        sp = tr.span("serving.infer", rows=n) if tr is not None \
            else telemetry.NOOP_SPAN
        with sp:
            p = self.current_params(params)
            cap = self.buckets[-1]
            if n <= cap:
                out = self._dispatch(x, p)
            else:
                out = torch.cat([self._dispatch(x[i:i + cap], p)
                                 for i in range(0, n, cap)], dim=0)
            if sync:
                self._sync()
        if self.input_spec is None and isinstance(x, np.ndarray):
            self.input_spec = (x.shape[1:], x.dtype)
        if count_request:
            # batcher-routed traffic records end-to-end latency itself
            serving_metrics.note_latency_ms(
                (time.perf_counter() - t0) * 1e3)
        return out

    __call__ = infer
