"""Layers of the port; importing this package registers the kinds it
has (dense, output, convolution, subsampling, RBM, autoencoder) with the
factory."""

from deeplearning4j_tpu_torch.nn.layers.base import (  # noqa: F401
    Layer, PretrainLayer, register_layer, make_layer,
)
from deeplearning4j_tpu_torch.nn.layers.dense import DenseLayer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.convolution import (  # noqa: F401
    ConvolutionLayer, SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.rbm import RBMLayer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.autoencoder import (  # noqa: F401
    AutoEncoderLayer,
)
