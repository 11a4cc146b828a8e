"""The port's ResNet against the JAX reference, on shared weights.

JAX's params and batch statistics (from its own ``init_params``) are
carried over with ``resnet.params_from_numpy``; the same numpy images
(from a seed) go through ``resnet.forward`` in both packages, and
through JAX's ``make_train_step`` on a one-device mesh and the port's
on the CPU.

Tolerances, each with its reason:
- logits and new batch statistics, fp32: 1e-5 (summation order of the
  convolutions and the moments); bf16: 5e-2 (the two frameworks round
  the bf16 convolutions' fp32 sums at other places);
- the asymmetric ``"SAME"`` padding (7x7/s2 stem on 224, 3x3/s2 pool on
  112), fp32: 1e-5 for the convolution, exact for the max pool;
- the space-to-depth stem against the plain one and JAX's: 1e-4, as
  the reference's own test (the re-tiled contraction sums in another
  order);
- three SGD-Nesterov steps, fp32: params and statistics within 1e-5;
- checkpoints: the files either package writes restore bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import resnet as jres
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh
from deeplearning4j_tpu.runtime import checkpoint as jckpt
from deeplearning4j_tpu_torch.models import resnet as tres
from deeplearning4j_tpu_torch.ops import updaters
from deeplearning4j_tpu_torch.runtime import checkpoint as tckpt
from deeplearning4j_tpu_torch.serving.engine import InferenceEngine

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
S2D_TOL = 1e-4
STEP_TOL = 1e-5

TINY = {
    "tiny": jres.resnet_tiny(),
    "w4": jres.ResNetConfig(stage_sizes=(1, 1, 1), width=4, n_classes=5,
                            stem_kernel=3, stem_stride=1, stem_pool=False),
}


def _tcfg(cfg, **kw):
    return tres.ResNetConfig(**dict(dataclasses.asdict(cfg), **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = (val.detach().float().numpy()
                                 if isinstance(val, torch.Tensor)
                                 else np.asarray(val, np.float32))
    return out


def _assert_trees_close(got, ref, tol, what):
    got, ref = _flat(got), _flat(ref)
    assert sorted(got) == sorted(ref), what
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], rtol=tol, atol=tol,
                                   err_msg=f"{what}: {path}")


def _images(n, size, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def _both(cfg, seed=0):
    jp, js = jres.init_params(jax.random.key(seed), cfg)
    jp, js = _np_tree(jp), _np_tree(js)
    return (jp, js), (tres.params_from_numpy(jp, "cpu"),
                      tres.params_from_numpy(js, "cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "inference"])
@pytest.mark.parametrize("name", sorted(TINY))
def test_forward_matches_jax(name, train, dtype):
    cfg = dataclasses.replace(TINY[name], compute_dtype=dtype)
    (jp, js), (tp, ts) = _both(cfg)
    x = _images(4, 16)
    jl, jst = jres.forward(cfg, jp, js, jnp.asarray(x), train=train)
    tl, tst = tres.forward(_tcfg(cfg), tp, ts, torch.from_numpy(x),
                           train=train)
    assert tl.dtype == torch.float32 and tl.shape == (4, cfg.n_classes)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=TOL[dtype], atol=TOL[dtype])
    _assert_trees_close(tst, _np_tree(jst), TOL["float32"], "new stats")


def test_imagenet_stem_and_pool_pad_like_xla():
    """7x7/s2 on 224 pads (2, 3); the 3x3/s2 pool on 112 pads (0, 1)
    with -inf; a 3x3/s2 on an even input (0, 1): PyTorch's symmetric
    padding would shift every window."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 224, 224, 3)).astype(np.float32)
    w = rng.normal(size=(7, 7, 3, 8)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tres._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(w), 2, torch.float32)
    assert tres._same_pads(224, 7, 2) == (2, 3)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=TOL["float32"],
                               atol=TOL["float32"])
    h = rng.normal(size=(2, 112, 112, 8)).astype(np.float32)
    ref = jax.lax.reduce_window(jnp.asarray(h), -jnp.inf, jax.lax.max,
                                (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    got = tres._max_pool_same(torch.from_numpy(h).permute(0, 3, 1, 2))
    assert tres._same_pads(112, 3, 2) == (0, 1)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref))
    w3 = rng.normal(size=(3, 3, 8, 4)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(h), jnp.asarray(w3), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tres._conv(torch.from_numpy(h).permute(0, 3, 1, 2),
                     torch.from_numpy(w3), 2, torch.float32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=TOL["float32"],
                               atol=TOL["float32"])


def test_imagenet_stem_network_matches_jax():
    """A one-stage net with the ImageNet stem (7x7/s2, BN, the 3x3/s2
    pool) on 224 images: logits and stats, fp32."""
    cfg = jres.ResNetConfig(stage_sizes=(1,), width=8, n_classes=5,
                            compute_dtype="float32")
    (jp, js), (tp, ts) = _both(cfg, seed=2)
    x = _images(2, 224, seed=2)
    jl, jst = jres.forward(cfg, jp, js, jnp.asarray(x))
    tl, tst = tres.forward(_tcfg(cfg), tp, ts, torch.from_numpy(x))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=TOL["float32"], atol=TOL["float32"])
    _assert_trees_close(tst, _np_tree(jst), TOL["float32"], "new stats")


def test_stem_s2d_matches_plain_stem_and_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    w = rng.normal(size=(7, 7, 3, 16)).astype(np.float32)
    plain = tres._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w), 2, torch.float32)
    s2d = tres._stem_s2d_conv(torch.from_numpy(x), torch.from_numpy(w),
                              torch.float32)
    ref = jres._stem_s2d_conv(jnp.asarray(x), jnp.asarray(w), jnp.float32)
    assert s2d.shape == plain.shape == (2, 16, 16, 16)
    np.testing.assert_allclose(s2d.numpy(), plain.numpy(), rtol=S2D_TOL,
                               atol=S2D_TOL)
    np.testing.assert_allclose(s2d.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=S2D_TOL, atol=S2D_TOL)
    cfg = jres.ResNetConfig(stage_sizes=(1,), width=8, n_classes=5,
                            compute_dtype="float32")
    (_, _), (tp, ts) = _both(cfg, seed=5)
    xs = torch.from_numpy(_images(2, 32, seed=6))
    a, _ = tres.forward(_tcfg(cfg), tp, ts, xs, train=False)
    b, _ = tres.forward(_tcfg(cfg, stem_s2d=True), tp, ts, xs, train=False)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=S2D_TOL,
                               atol=S2D_TOL)
    with pytest.raises(ValueError, match="even"):
        tres.forward(_tcfg(cfg, stem_s2d=True), tp, ts, xs[:, :31])


def _jax_state(cfg, seed):
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    init_fn, step_fn = jres.make_train_step(cfg, mesh)
    return init_fn(jax.random.key(seed)), step_fn


def test_three_sgd_nesterov_steps_match_jax():
    cfg = dataclasses.replace(jres.resnet_tiny(n_classes=4),
                              compute_dtype="float32")
    jstate, jstep = _jax_state(cfg, 4)
    tstate = tres.TrainState(
        tres.params_from_numpy(_np_tree(jstate.params), "cpu"),
        tres.params_from_numpy(_np_tree(jstate.batch_stats), "cpu"),
        updaters.TraceState(tres.params_from_numpy(
            _np_tree(jstate.opt_state[0].trace), "cpu")), 0)
    _, tstep = tres.make_train_step(_tcfg(cfg), device="cpu")
    rng = np.random.default_rng(0)
    x = _images(8, 16)
    y = rng.integers(0, 4, 8).astype(np.int32)
    jl, tl = [], []
    for _ in range(3):
        jstate, loss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        jl.append(float(loss))
        tstate, loss = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=STEP_TOL)
    assert tstate.step == 3
    _assert_trees_close(tstate.params, _np_tree(jstate.params), STEP_TOL,
                        "params")
    _assert_trees_close(tstate.batch_stats, _np_tree(jstate.batch_stats),
                        STEP_TOL, "batch stats")
    _assert_trees_close(tstate.opt_state.trace,
                        _np_tree(jstate.opt_state[0].trace), STEP_TOL,
                        "momentum trace")


def test_n_steps_in_one_graph_equals_single_steps():
    cfg = _tcfg(jres.resnet_tiny(n_classes=4), compute_dtype="float32")
    init_1, step_1 = tres.make_train_step(cfg, device="cpu")
    _, step_3 = tres.make_train_step(cfg, n_steps=3, device="cpu")
    s1 = init_1(torch.Generator().manual_seed(0))
    s3 = init_1(torch.Generator().manual_seed(0))
    x, y = tres.synthetic_batch(1, cfg, 4, 16, device="cpu")
    losses = []
    for _ in range(3):
        s1, loss = step_1(s1, x, y)
        losses.append(loss)
    s3, loss3 = step_3(s3, x, y)
    assert loss3.shape == (3,) and s3.step == 3
    torch.testing.assert_close(loss3, torch.stack(losses), rtol=0, atol=0)
    for a, b in zip(updaters.tree_leaves(s3), updaters.tree_leaves(s1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_resnet50_param_count():
    params, stats = tres.init_params(torch.Generator().manual_seed(0),
                                     tres.resnet50(), device="cpu")
    n = tres.param_count(params)
    assert 25_000_000 < n < 26_000_000, n
    jp, jst = jax.eval_shape(lambda: jres.init_params(jax.random.key(0),
                                                      jres.resnet50()))
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    for got, ref in ((params, jp), (stats, jst)):
        assert {k: v.shape for k, v in _flat(got).items()} == \
            {k: tuple(v.shape) for k, v in _flat(
                jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                             ref)).items()}


def test_train_state_checkpoint_crosses_both_ways(tmp_path):
    cfg = dataclasses.replace(jres.resnet_tiny(n_classes=4),
                              compute_dtype="float32")
    jstate, jstep = _jax_state(cfg, 6)
    x = jnp.asarray(_images(4, 16))
    jstate, _ = jstep(jstate, x, jnp.asarray([0, 1, 2, 3]))
    # JAX writes, the port reads
    path = str(tmp_path / "jax.npz")
    jckpt.save_pytree(path, jstate, {"step": 1})
    tstate = tres.train_state_from_numpy(tckpt.load_numpy_tree(path), "cpu")
    assert tstate.step == 1
    for got, ref in zip(updaters.tree_leaves(tstate),
                        jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    # the port writes, JAX restores like= its own state
    _, tstep = tres.make_train_step(_tcfg(cfg), device="cpu")
    tstate, _ = tstep(tstate, torch.from_numpy(np.array(x)),
                      torch.tensor([3, 2, 1, 0], dtype=torch.int32))
    out = str(tmp_path / "port.npz")
    tckpt.save_pytree(out, tres.train_state_to_numpy(tstate), {"step": 2})
    restored, meta = jckpt.load_pytree(out, like=jstate)
    assert meta == {"step": 2} and int(restored.step) == 2
    for got, ref in zip(jax.tree.leaves(restored),
                        updaters.tree_leaves(tstate)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_serving_engine_pads_image_batches_exactly():
    cfg = _tcfg(jres.resnet_tiny(n_classes=6), compute_dtype="float32")
    params, stats = tres.init_params(torch.Generator().manual_seed(1), cfg,
                                     device="cpu")
    apply_fn, key = tres.make_serving_apply(cfg)
    assert key == ("resnet_serving", repr(cfg))
    eng = InferenceEngine(apply_fn, params=(params, stats), buckets=(1, 4, 8),
                          device="cpu")
    assert eng.warmup(input_shape=(16, 16, 3))["buckets"] == 3
    x = _images(11, 16, seed=3)
    with torch.no_grad():
        ref, _ = tres.forward(cfg, params, stats, torch.from_numpy(x),
                              train=False)
    for n in (1, 3, 8, 11):
        got = eng.infer(x[:n])
        assert got.shape == (n, 6)
        np.testing.assert_allclose(got.numpy(), ref[:n].numpy(),
                                   rtol=TOL["float32"], atol=TOL["float32"])
    state = tres.TrainState(params, stats, None, 0)
    assert torch.equal(tres.predict(cfg, state, torch.from_numpy(x)),
                       ref.argmax(-1))


def test_entry_points_need_cuda_or_an_explicit_cpu():
    cfg = tres.resnet_tiny()
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        tres.make_train_step(cfg, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        for call in (lambda: tres.make_train_step(cfg),
                     lambda: tres.init_params(torch.Generator(), cfg),
                     lambda: tres.synthetic_batch(0, cfg, 2, 16)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    x, y = tres.synthetic_batch(0, cfg, 3, 16, device="cpu")
    assert x.shape == (3, 16, 16, 3) and y.dtype == torch.int32
    assert bool((y >= 0).all() and (y < cfg.n_classes).all())
