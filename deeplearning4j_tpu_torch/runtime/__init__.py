"""Runtime services of the port: counters, the span tracer, post-training
quantization, and the numpy-only checkpoint reader (counterpart of
``deeplearning4j_tpu/runtime``)."""
