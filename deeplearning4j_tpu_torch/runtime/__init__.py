"""Runtime services of the port: counters, the span tracer, and the
numpy-only checkpoint reader (counterpart of
``deeplearning4j_tpu/runtime``)."""
