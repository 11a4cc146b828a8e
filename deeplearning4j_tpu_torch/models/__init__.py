"""Models of the port (counterpart of ``deeplearning4j_tpu/models``):
the transformer encoder and BERT."""
