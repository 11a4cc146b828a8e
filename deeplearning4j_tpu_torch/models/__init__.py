"""Models of the port (counterpart of ``deeplearning4j_tpu/models``):
the transformer encoder, BERT (MLM training and fill-mask serving) and
GPT (causal-LM training)."""
