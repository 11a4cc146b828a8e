"""Neural-network core of the port: configuration, layers and
``MultiLayerNetwork`` (counterpart of ``deeplearning4j_tpu/nn``)."""
