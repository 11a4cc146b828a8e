"""Host utilities of the port (counterpart of ``deeplearning4j_tpu/utils``):
image loading."""
