"""Inference serving (counterpart of ``deeplearning4j_tpu/serving``):
``InferenceEngine`` (engine.py), a shape-bucketed forward with host-side
padding, warmup and optional weight quantization; ``DynamicBatcher``
(batcher.py), which coalesces concurrent requests into micro-batches;
continuous-batching decode serving (decode.py: ``DecodeEngine`` with
paged KV, the prefix store and speculative decoding,
``ContinuousBatcher``); and ``Router`` (router.py), least-depth dispatch
over replicas with load shedding.  The fleet half of router.py
(autoscaling, the live weight swap, replica health) comes later."""
