"""Neural-network core of the port: configuration, layers,
``MultiLayerNetwork``, the sequence-classifier API (``api``) and the
gradient container (counterpart of ``deeplearning4j_tpu/nn``)."""
