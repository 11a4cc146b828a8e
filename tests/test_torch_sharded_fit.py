"""The port's sharded-fit steps against the JAX reference.

- ``next_loss_scale`` over a sequence of skips and good runs long enough
  to grow the scale, and up to its cap and floor: the scale and the
  good-step count equal the reference's after every step (powers of
  two: exact);
- ``init_loss_scale`` and the constants equal;
- ``mp_cast`` on trees of mixed dtypes: fp32 leaves cast, every other
  leaf untouched, as the reference's;
- ``build_scanned_epochs`` at ``mesh=None`` against a loop of
  ``build_sharded_step`` calls of the same step: params, state, scores
  and skips bit-equal (the same captured step, replayed), scores shaped
  ``[num_epochs, NB]``; a preemption notice stops the staged loop at a
  step boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import sharded_fit as jsf
from deeplearning4j_tpu_torch.ops.updaters import tree_map
from deeplearning4j_tpu_torch.parallel import sharded_fit as tsf
from deeplearning4j_tpu_torch.runtime import resilience

torch.set_num_threads(2)


def test_constants_and_initial_state_match_reference():
    for name in ("LOSS_SCALE_INIT", "LOSS_SCALE_MIN", "LOSS_SCALE_MAX",
                 "LOSS_SCALE_GROWTH_INTERVAL", "SCAN_MAX_DATASET_BYTES"):
        assert getattr(tsf, name) == getattr(jsf, name), name
    j, t = jsf.init_loss_scale(), tsf.init_loss_scale("cpu")
    assert float(t["scale"]) == float(j["scale"])
    assert int(t["good_steps"]) == int(j["good_steps"])
    assert t["scale"].dtype == torch.float32
    assert t["good_steps"].dtype == torch.int32


def _skip_sequence():
    """Skips at the start (down toward the floor), good runs past the
    growth interval, a skip mid-run, and a long good stretch."""
    seq = [1] * 3 + [0] * 205 + [1] + [0] * 199 + [0] * 3 + [1, 1] \
        + [0] * 401
    return seq


@pytest.mark.parametrize("start", ["init", "floor", "cap"])
def test_next_loss_scale_sequence_matches_reference(start):
    j, t = jsf.init_loss_scale(), tsf.init_loss_scale("cpu")
    if start != "init":
        v = jsf.LOSS_SCALE_MIN * 2 if start == "floor" else \
            jsf.LOSS_SCALE_MAX / 2
        j = {"scale": jnp.float32(v), "good_steps": jnp.int32(0)}
        t = {"scale": torch.tensor(v, dtype=torch.float32),
             "good_steps": torch.tensor(0, dtype=torch.int32)}
    seq = _skip_sequence() if start != "floor" else [1] * 4 + [0] * 10
    for i, s in enumerate(seq):
        j = jsf.next_loss_scale(j, jnp.int32(s))
        t = tsf.next_loss_scale(t, torch.tensor(s, dtype=torch.int32))
        assert float(t["scale"]) == float(j["scale"]), i
        assert int(t["good_steps"]) == int(j["good_steps"]), i
    assert t["good_steps"].dtype == torch.int32


def test_mp_cast_matches_reference_on_mixed_trees():
    rng = np.random.RandomState(0)
    tree = {"w": rng.randn(3, 4).astype(np.float32),
            "i": np.arange(5, dtype=np.int32),
            "h": rng.randn(2).astype(np.float16),
            "nested": [{"b": rng.randn(4).astype(np.float32)},
                       np.array([True, False])]}

    def build(tree, leaf):
        if isinstance(tree, dict):
            return {k: build(v, leaf) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v, leaf) for v in tree]
        return leaf(tree)

    j = jsf.mp_cast(build(tree, jnp.asarray))
    t = tsf.mp_cast(build(tree, torch.from_numpy))
    pairs = [(t["w"], j["w"]), (t["i"], j["i"]), (t["h"], j["h"]),
             (t["nested"][0]["b"], j["nested"][0]["b"]),
             (t["nested"][1], j["nested"][1])]
    for tl, jl in pairs:
        assert str(tl.dtype).replace("torch.", "") == str(jl.dtype)
        if tl.dtype == torch.bfloat16:
            np.testing.assert_array_equal(tl.float().numpy(),
                                          np.asarray(jl, np.float32))
        else:
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    # an explicit dtype casts the fp32 leaves only
    assert tsf.mp_cast(build(tree, torch.from_numpy),
                       torch.float16)["w"].dtype == torch.float16


def _toy_step(params, ustate, batch, gen, it):
    """A least-squares step with momentum, a guard and a loss scale."""
    x, y = batch
    mom, ls = ustate
    w = params["w"].detach().requires_grad_(True)
    with torch.enable_grad():
        loss = ((x @ w - y) ** 2).mean() + 0 * torch.rand((), generator=gen)
        (g,) = torch.autograd.grad(loss * ls["scale"], [w])
    g = g / ls["scale"]
    new_m = 0.9 * mom["w"] + g
    new_p, new_mom, skipped = resilience.guard_update(
        params, mom, {"w": params["w"] - 0.1 * new_m}, {"w": new_m},
        (loss.detach(), g))
    return (new_p, (new_mom, tsf.next_loss_scale(ls, skipped)),
            loss.detach(), skipped)


def _toy_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(4, 2, generator=g)}
    ustate = ({"w": torch.zeros(4, 2)}, tsf.init_loss_scale("cpu"))
    xs = torch.randn(3, 8, 4, generator=g)
    ys = torch.randn(3, 8, 2, generator=g)
    xs[1, 0, 0] = float("nan")          # one poisoned batch: a skip a pass
    return params, ustate, xs, ys


def test_scanned_epochs_equal_a_loop_of_the_sharded_step():
    step = tsf.build_sharded_step(_toy_step, None, label="test.toy_step")
    epochs = tsf.build_scanned_epochs(_toy_step, None,
                                      label="test.toy_epochs", step=step)
    params, ustate, xs, ys = _toy_state()
    caller_w = params["w"]
    it = torch.zeros((), dtype=torch.int32)
    gen = torch.Generator().manual_seed(3)
    p1, u1, it1, scores, skips = epochs(params, ustate, it, (xs, ys), gen, 2)
    # the caller's state was copied in, never written
    assert torch.equal(caller_w, _toy_state()[0]["w"])
    assert scores.shape == skips.shape == (2, 3)
    assert skips.tolist() == [[0, 1, 0], [0, 1, 0]]
    assert int(it1) == 6
    params, ustate, xs, ys = _toy_state()
    it = torch.zeros((), dtype=torch.int32)
    gen = torch.Generator().manual_seed(3)
    loop_scores = []
    for _ in range(2):
        for j in range(3):
            params, ustate, it, s, k = step(params, ustate, it,
                                            (xs[j], ys[j]), gen)
            loop_scores.append(s)
    assert torch.equal(p1["w"], params["w"])
    assert torch.equal(u1[0]["w"], ustate[0]["w"])
    assert float(u1[1]["scale"]) == float(ustate[1]["scale"]) == 2.0 ** 13
    torch.testing.assert_close(scores.reshape(-1), torch.stack(loop_scores),
                               rtol=0, atol=0, equal_nan=True)


def test_scanned_epochs_stop_at_a_preemption_notice():
    step = tsf.build_sharded_step(_toy_step, None, label="test.toy_step")
    epochs = tsf.build_scanned_epochs(_toy_step, None, label="test.toy",
                                      step=step)
    params, ustate, xs, ys = _toy_state()
    it = torch.zeros((), dtype=torch.int32)
    with resilience.PreemptionGuard(signals=()) as guard:
        guard.request()
        _, _, it, scores, skips = epochs(
            tree_map(torch.clone, params), ustate, it, (xs, ys), None, 2)
    assert scores.numel() == skips.numel() == 0 and int(it) == 0
