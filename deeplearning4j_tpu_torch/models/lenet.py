"""LeNet: the MNIST conv net, built from the port's own layers.

Port of ``deeplearning4j_tpu/models/lenet.py``: conv 5x5x20 (SAME) ->
max 2 -> conv 5x5x50 (SAME) -> max 2 -> dense 2450 -> 500 relu ->
softmax 10, assembled through ``MultiLayerConfiguration`` as a user
would write it.  NHWC input ``[B, 28, 28, 1]``.  ``lenet_conf`` gives
the same JSON as the reference's.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch import DeviceLike
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    LayerKind, MultiLayerConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def lenet_conf(n_classes: int = 10, lr: float = 0.1,
               compute_dtype: str = "bfloat16") -> MultiLayerConfiguration:
    """conv(5x5,20) -> max2 -> conv(5x5,50) -> max2 -> dense(500, relu)
    -> softmax."""
    def conv(n_ch, n_f):
        return (NeuralNetConfiguration.builder()
                .kind(LayerKind.CONVOLUTION).n_channels(n_ch).n_filters(n_f)
                .kernel_size((5, 5)).stride((1, 1)).padding("SAME")
                .activation("relu").lr(lr).use_adagrad(False)
                .compute_dtype(compute_dtype).build())

    def pool():
        return (NeuralNetConfiguration.builder()
                .kind(LayerKind.SUBSAMPLING).pool_size((2, 2))
                .pool_type("max").build())

    dense = (NeuralNetConfiguration.builder()
             .kind(LayerKind.DENSE).n_in(7 * 7 * 50).n_out(500)
             .activation("relu").lr(lr).use_adagrad(False)
             .compute_dtype(compute_dtype).build())
    out = (NeuralNetConfiguration.builder()
           .kind(LayerKind.OUTPUT).n_in(500).n_out(n_classes)
           .activation("softmax").loss_function("mcxent").lr(lr)
           .use_adagrad(False).compute_dtype(compute_dtype).build())

    return MultiLayerConfiguration(
        confs=[conv(1, 20), pool(), conv(20, 50), pool(), dense, out],
        input_preprocessors={4: {"name": "flatten"}},
        pretrain=False, backprop=True,
    )


def lenet(n_classes: int = 10, seed: int = 123,
          compute_dtype: str = "bfloat16",
          device: DeviceLike = None) -> MultiLayerNetwork:
    """An initialized LeNet on ``device`` (None = CUDA)."""
    net = MultiLayerNetwork(lenet_conf(n_classes,
                                       compute_dtype=compute_dtype),
                            device=device)
    net.init(seed)
    return net


def lenet_serving(net: MultiLayerNetwork, buckets=None,
                  max_batch_size: int = 256):
    """A serving engine for a (trained) LeNet with every bucket of its
    ladder run once on the MNIST input shape."""
    eng = net.serving_engine(buckets=buckets, max_batch_size=max_batch_size)
    eng.warmup(input_shape=(28, 28, 1))
    return eng
