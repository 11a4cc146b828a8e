"""Models of the port (counterpart of ``deeplearning4j_tpu/models``):
the transformer encoder, BERT (MLM training and fill-mask serving),
GPT (causal-LM training, KV-cache generation and scoring) and LeNet
(``MultiLayerNetwork`` on MNIST)."""
