"""Configuration system: the port's copy of
``deeplearning4j_tpu/nn/conf``, whose JSON both packages read."""

from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: F401
    LayerKind,
    OptimizationAlgorithm,
    WeightInit,
    HiddenUnit,
    VisibleUnit,
    NeuralNetConfiguration,
    MultiLayerConfiguration,
    MIXED_PRECISION_POLICIES,
)
