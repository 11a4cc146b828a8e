"""The port's recursive autoencoder against the JAX reference
(``nn/layers/autoencoder.py:70-124``).

The same numpy params (the JAX layer's init carried through
``nn.params.params_from_numpy``) and numpy inputs from a seed.
Tolerances: the fold's root and loss, and the gradients, within rtol
1e-5 (atol 1e-6): the same fp32 arithmetic over T merges, in another
summation order inside each product; greedy pretraining through each
package's ``MultiLayerNetwork.pretrain`` within rtol 1e-4 (atol 1e-5)
after 10 steps of the updater (AdaGrad and momentum carry the
products' last-ulp differences on).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import configuration as jconf
from deeplearning4j_tpu.nn.layers import make_layer as jmake_layer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.nn.conf import configuration as tconf
from deeplearning4j_tpu_torch.nn.layers import make_layer as tmake_layer
from deeplearning4j_tpu_torch.nn.layers.autoencoder import \
    RecursiveAutoEncoderLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.params import params_from_numpy

torch.set_num_threads(2)

D, B, T = 6, 4, 5


def _layer_conf(C, activation="tanh"):
    return (C.NeuralNetConfiguration.builder()
            .kind(C.LayerKind.RECURSIVE_AUTOENCODER).n_in(D).n_out(D)
            .activation(activation).compute_dtype("float32").build())


def _net_conf(C):
    return (C.NeuralNetConfiguration.builder()
            .kind(C.LayerKind.RECURSIVE_AUTOENCODER).n_in(D).n_out(D)
            .activation("tanh").lr(0.05).num_iterations(10)
            .compute_dtype("float32").list(1).pretrain(True)
            .backward(False).build())


def _params(seed=0):
    jl = jmake_layer(_layer_conf(jconf))
    jp = jax.tree.map(np.asarray, jl.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed + 50)
    # non-zero biases, so a bias in the wrong place shows
    return {k: (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
            for k, v in jp.items()}


def _xs(seed=1):
    return np.random.default_rng(seed).normal(
        0, 0.5, (B, T, D)).astype(np.float32)


def test_init_layout():
    tl = tmake_layer(_layer_conf(tconf))
    assert isinstance(tl, RecursiveAutoEncoderLayer)
    p = tl.init(torch.Generator().manual_seed(0), "cpu")
    jp = _params()
    assert sorted(p) == sorted(jp) == ["U", "W", "b", "c"]
    for k in p:
        assert tuple(p[k].shape) == jp[k].shape, k
    assert tl.out_features(D) == D


@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
def test_fold_loss_and_gradients_match_jax(activation):
    jl = jmake_layer(_layer_conf(jconf, activation))
    tl = tmake_layer(_layer_conf(tconf, activation))
    jp, xs = _params(), _xs()
    tp = params_from_numpy(jp, "cpu")
    jroot, jloss = jl.fold(jp, jnp.asarray(xs))
    troot, tloss = tl.fold(tp, torch.from_numpy(xs))
    np.testing.assert_allclose(troot.numpy(), np.asarray(jroot),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tl.activate(tp, torch.from_numpy(xs)).numpy(),
                               np.asarray(jl.activate(jp, jnp.asarray(xs))),
                               rtol=1e-5, atol=1e-6)
    jv, jg = jl.pretrain_value_and_grad(jp, jax.random.key(0),
                                        jnp.asarray(xs))
    tv, tg = tl.pretrain_value_and_grad(tp, None, torch.from_numpy(xs))
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # the caller's params are read, never written or left with grads
    assert all(not v.requires_grad for v in tp.values())


def test_single_item_fold_is_the_item_with_zero_loss():
    tl = tmake_layer(_layer_conf(tconf))
    tp = params_from_numpy(_params(), "cpu")
    x = torch.from_numpy(_xs()[:, :1])
    root, loss = tl.fold(tp, x)
    assert torch.equal(root, x[:, 0]) and float(loss) == 0.0


def test_pretrain_through_the_network_matches_jax():
    """The port's greedy pretraining loop drives the recursive
    autoencoder as the reference's does: the same params after 10
    steps."""
    jp, xs = _params(seed=2), _xs(seed=3)
    jnet = JNet(_net_conf(jconf), params=[{k: jnp.asarray(v)
                                           for k, v in jp.items()}])
    tnet = TNet(_net_conf(tconf), params=params_from_numpy([jp], "cpu"),
                device="cpu")
    jnet.pretrain(JDataSet(jnp.asarray(xs), jnp.asarray(xs)))
    tnet.pretrain(TDataSet(torch.from_numpy(xs), torch.from_numpy(xs)))
    for k in jp:
        np.testing.assert_allclose(tnet.params[0][k].numpy(),
                                   np.asarray(jnet.params[0][k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    before = float(tnet.layers[0].fold(params_from_numpy([jp], "cpu")[0],
                                       torch.from_numpy(xs))[1])
    after = float(tnet.layers[0].fold(tnet.params[0],
                                      torch.from_numpy(xs))[1])
    assert after < before
