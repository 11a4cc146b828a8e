"""The port's LSTM layer against the JAX reference.

The same conf, numpy params (the JAX layer's init carried through
``nn.params.params_from_numpy``) and numpy inputs (from a seed) go
through ``deeplearning4j_tpu.nn.layers.lstm.LSTMLayer`` and the port's.

Tolerances, each with its reason:
- fp32 products: hidden states, logits, the loss and the gradients
  within rtol 1e-5 (atol 1e-6): the same fp32 arithmetic over T steps,
  in another summation order inside each product;
- bf16 products: the loss within rtol 1e-2 and the gradients' relative
  L2 within 3e-2 (``tests/test_pallas_attention.py``'s bf16 bar): each
  product's bf16 result may round its last bit the other way;
- ``truncate_bptt`` on and off: equal gradients (the recompute repeats
  the same ops on the same values);
- sampling at temperature 1e-6: identical ids (both sides take the
  argmax; their random streams never agree).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import configuration as jconf
from deeplearning4j_tpu.nn.layers.lstm import LSTMLayer as JLSTM
from deeplearning4j_tpu_torch.nn import params as tparams
from deeplearning4j_tpu_torch.nn.conf import configuration as tconf
from deeplearning4j_tpu_torch.nn.layers.lstm import LSTMLayer as TLSTM

torch.set_num_threads(2)

N_IN, HIDDEN, B, T = 5, 8, 3, 7


def _conf(C, cdt="float32", tbptt=0, n_out=N_IN):
    return (C.NeuralNetConfiguration.builder().kind(C.LayerKind.LSTM)
            .n_in(N_IN).n_out(n_out).hidden_size(HIDDEN)
            .activation("softmax").compute_dtype(cdt).truncate_bptt(tbptt)
            .build())


def _pair(cdt="float32", tbptt=0, seed=0, n_out=N_IN):
    jl, tl = JLSTM(_conf(jconf, cdt, tbptt, n_out)), \
        TLSTM(_conf(tconf, cdt, tbptt, n_out))
    jp = jax.tree.map(np.asarray, jl.init(jax.random.key(seed)))
    # the init's zero biases would hide a bias added in the wrong place
    rng = np.random.default_rng(seed + 100)
    jp = {k: (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
          for k, v in jp.items()}
    return jl, tl, jp, tparams.params_from_numpy(jp, "cpu")


def _data(seed=1, n_out=N_IN):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(B, T, N_IN)).astype(np.float32)
    ys = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, (B, T))]
    return xs, ys


def _torch_loss_grads(layer, p, xs, ys):
    live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    loss = layer.sequence_loss(live, torch.from_numpy(xs),
                               torch.from_numpy(ys))
    grads = torch.autograd.grad(loss, [live[k] for k in sorted(live)])
    return float(loss.detach()), dict(zip(sorted(live), grads))


def test_params_layout_and_carrier():
    """lstm_params keeps the reference's leaves and shapes, and one
    layer's numpy dict carries across as one dict."""
    _, tl, jp, tp = _pair()
    gen = torch.Generator().manual_seed(0)
    fresh = tl.init(gen, "cpu")
    assert sorted(fresh) == sorted(jp)
    for k in jp:
        assert tuple(fresh[k].shape) == jp[k].shape, k
        np.testing.assert_array_equal(tp[k].numpy(), jp[k])
    assert fresh["recurrent_W"].shape == (N_IN + HIDDEN, 4 * HIDDEN)


def test_scan_decode_and_activate_match_jax():
    jl, tl, jp, tp = _pair()
    xs, _ = _data()
    jh = np.array(jl.scan_sequence(jp, jnp.asarray(xs)))
    th = tl.scan_sequence(tp, torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(th, jh, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tl.decode(tp, torch.from_numpy(jh)).numpy(),
        np.asarray(jl.decode(jp, jnp.asarray(jh))), rtol=1e-5, atol=1e-6)
    for x in (xs, xs[:, 0]):                       # [B, T, D] and 2-D
        np.testing.assert_allclose(
            tl.activate(tp, torch.from_numpy(x)).numpy(),
            np.asarray(jl.activate(jp, jnp.asarray(x))),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tbptt", [0, 2])
def test_sequence_loss_and_gradients_match_jax_fp32(tbptt):
    jl, tl, jp, tp = _pair(tbptt=tbptt)
    xs, ys = _data()
    jloss, jgrads = jax.value_and_grad(jl.sequence_loss)(
        jp, jnp.asarray(xs), jnp.asarray(ys))
    tloss, tgrads = _torch_loss_grads(tl, tp, xs, ys)
    np.testing.assert_allclose(tloss, float(jloss), rtol=1e-5)
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k].numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_sequence_loss_and_gradients_match_jax_bf16():
    jl, tl, jp, tp = _pair(cdt="bfloat16")
    xs, ys = _data()
    jloss, jgrads = jax.value_and_grad(jl.sequence_loss)(
        jp, jnp.asarray(xs), jnp.asarray(ys))
    tloss, tgrads = _torch_loss_grads(tl, tp, xs, ys)
    np.testing.assert_allclose(tloss, float(jloss), rtol=1e-2)
    num = sum(float(np.sum((tgrads[k].numpy() - np.asarray(jgrads[k]))
                           ** 2)) for k in jgrads)
    den = sum(float(np.sum(np.asarray(jgrads[k]) ** 2)) for k in jgrads)
    assert (num / den) ** 0.5 <= 3e-2


def test_truncate_bptt_gives_equal_gradients():
    """Recompute in the backward changes memory, not the gradient."""
    _, off, _, tp = _pair(tbptt=0)
    _, on, _, _ = _pair(tbptt=5)
    xs, ys = _data(seed=2)
    loss_off, g_off = _torch_loss_grads(off, tp, xs, ys)
    loss_on, g_on = _torch_loss_grads(on, tp, xs, ys)
    assert loss_on == loss_off
    for k in g_off:
        assert torch.equal(g_on[k], g_off[k]), k


@pytest.mark.parametrize("start_id", [0, 3])
def test_sample_near_zero_temperature_matches_jax(start_id):
    jl, tl, jp, tp = _pair(seed=3)
    jids = np.asarray(jl.sample(jp, jax.random.key(0), 24,
                                start_id=start_id, temperature=1e-6))
    tids = tl.sample(tp, torch.Generator().manual_seed(0), 24,
                     start_id=start_id, temperature=1e-6)
    assert tids.dtype == torch.int64 and tids.shape == (24,)
    np.testing.assert_array_equal(tids.numpy(), jids)


def test_sample_draws_from_the_generator_and_needs_one_hot_io():
    _, tl, _, tp = _pair(seed=4)
    a = tl.sample(tp, torch.Generator().manual_seed(1), 64)
    b = tl.sample(tp, torch.Generator().manual_seed(1), 64)
    c = tl.sample(tp, torch.Generator().manual_seed(2), 64)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < N_IN
    _, tl3, _, tp3 = _pair(n_out=3)
    with pytest.raises(ValueError, match="one-hot io"):
        tl3.sample(tp3, torch.Generator(), 4)
