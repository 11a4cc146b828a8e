"""Host utilities of the port (counterpart of ``deeplearning4j_tpu/utils``):
image loading, math and string helpers, and Viterbi decoding (its
forward pass on the emissions' device)."""
