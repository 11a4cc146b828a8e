"""Kernels, kernel selection and optimizers: the counterpart of
``deeplearning4j_tpu/ops``.  ``flash_attention`` holds the port of the
Pallas flash-attention forward and backward; ``fused_word2vec`` and
``fused_glove`` the word2vec and GloVe chunk updates; ``kernel_select``
the shared dispatch policy; ``cuda_build`` compiles the CUDA sources
under ``csrc/``; ``updaters`` the optax-exact ``adamw`` and the
reference's ``dl4j_updater``; ``registry``, ``losses`` and ``random`` the
named activations, the loss functions and the generator-driven draws
of the ``MultiLayerNetwork`` spine; ``graph`` the symbolic
``GraphBuilder``."""

from deeplearning4j_tpu_torch.ops.registry import (  # noqa: F401
    get_activation,
    get_activation_derivative,
    register_activation,
    list_activations,
)
from deeplearning4j_tpu_torch.ops.losses import (  # noqa: F401
    LossFunction, score as loss_score)
from deeplearning4j_tpu_torch.ops import random  # noqa: F401
