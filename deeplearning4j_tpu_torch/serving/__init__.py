"""Inference serving (counterpart of ``deeplearning4j_tpu/serving``):
``InferenceEngine`` (engine.py), a shape-bucketed forward with host-side
padding, warmup and optional weight quantization; ``DynamicBatcher``
(batcher.py), which coalesces concurrent requests into micro-batches;
and continuous-batching decode serving (decode.py: ``DecodeEngine``,
``ContinuousBatcher``).  The router comes later."""
