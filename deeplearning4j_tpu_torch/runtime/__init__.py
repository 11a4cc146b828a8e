"""Runtime services of the port (counterpart of
``deeplearning4j_tpu/runtime``): the compile engine (CUDA graphs), the
counter families and telemetry, checkpoints and their manager, the
self-healing training loop, post-training quantization, the training
console, the native host library (``native``) and the attention
autotuner (``autotune``)."""
