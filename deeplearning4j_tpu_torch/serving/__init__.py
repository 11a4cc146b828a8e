"""One-shot inference serving (counterpart of
``deeplearning4j_tpu/serving``): ``InferenceEngine`` (engine.py), a
shape-bucketed forward with host-side padding and warmup, and
``DynamicBatcher`` (batcher.py), which coalesces concurrent requests
into micro-batches.  Decode serving and the router come later."""
