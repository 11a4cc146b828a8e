"""The port's ``parallel/hogwild.py`` against the JAX package, on the CPU.

After ``tests/test_parallel.py:165-217``: softmax regression on Iris
(the reference's ``_softmax_loss``, ``_iris_batches``, ``_init_params``
as numpy), trained by worker threads that pull the global params, take
``local_steps`` ``dl4j_updater`` steps and fold their delta into the
tracker's params with no barrier.

Held:
- one worker is ``torch.equal`` to a plain loop of the same steps and
  folds (the worker keeps training its own replica; the global params
  take each job's delta);
- one worker against the reference's one worker from the same params
  and batches: within 1e-5 (fp32; the reference runs its steps under
  ``jit``, the port eagerly, so sums round in another order);
- four workers train Iris above 0.75, every job processed once, every
  worker taking part (the reference's bar);
- each worker draws from a generator of its own seeded ``seed + w``: a
  run is reproducible and another seed draws otherwise;
- a worker's crash stops its peers and re-raises in ``fit``;
- ``INDArrayAggregator``'s mean equals the reference's.
"""

import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops.updaters import (apply_descent,
                                                   dl4j_updater, tree_map)
from deeplearning4j_tpu_torch.parallel.hogwild import (HogwildTrainer,
                                                       INDArrayAggregator)
from test_torch_paged import assert_no_jax

torch.set_num_threads(2)

TOL = 1e-5
CPU = torch.device("cpu")


def _iris_np():
    from deeplearning4j_tpu_torch.datasets.fetchers import IrisDataFetcher
    f = IrisDataFetcher()
    f.fetch(150)
    data = f.next().normalize_zero_mean_unit_variance()
    return np.asarray(data.features), np.asarray(data.labels)


def _batches(n_batches=8, batch=40):
    """tests/test_parallel.py:_iris_batches, as numpy."""
    x, y = _iris_np()
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n_batches):
        idx = rng.integers(0, 150, size=batch)
        out.append((x[idx], y[idx]))
    return out


def _init_np():
    rng = np.random.default_rng(5)
    return {"W": (0.01 * rng.standard_normal((4, 3))).astype(np.float32),
            "b": np.zeros(3, np.float32)}


def _params():
    return {k: torch.from_numpy(v.copy()) for k, v in _init_np().items()}


def _softmax_loss(params, x, y, gen):
    logits = x @ params["W"] + params["b"]
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(y * logp, dim=-1))


def _accuracy(params) -> float:
    x, y = _iris_np()
    logits = torch.from_numpy(x) @ params["W"] + params["b"]
    return float((logits.argmax(-1) == torch.from_numpy(y).argmax(-1))
                 .float().mean())


def _updater():
    return dl4j_updater(lr=0.3, momentum=0.0, use_adagrad=False)


def test_one_worker_equals_a_plain_loop():
    steps = 3
    batches = _batches()
    trainer = HogwildTrainer(_softmax_loss, _updater(), num_workers=1,
                             local_steps=steps, device="cpu")
    got = trainer.fit(_params(), batches, seed=0)

    upd = _updater()
    grad_and_value = torch.func.grad_and_value(
        lambda p, x, y: _softmax_loss(p, x, y, None))
    local, glob = _params(), _params()
    ustate = upd.init(local)
    for j, (x, y) in enumerate(batches):
        x, y = torch.from_numpy(x), torch.from_numpy(y)
        pulled = p = local
        for i in range(steps):
            grads, _ = grad_and_value(p, x, y)
            u, ustate = upd.update(ustate, grads, p, j + i, 1)
            p = apply_descent(p, u)
        local = p
        glob = tree_map(lambda g, a, b: g + (a - b), glob, p, pulled)
    for k in got:
        assert torch.equal(got[k], glob[k]), k
    assert trainer.tracker.count("iterations") == len(batches)


def test_one_worker_matches_reference():
    import jax.numpy as jnp
    from deeplearning4j_tpu.ops.updaters import dl4j_updater as jupdater
    from deeplearning4j_tpu.parallel.hogwild import \
        HogwildTrainer as JTrainer

    def jloss(params, x, y, key):
        import jax
        logits = x @ params["W"] + params["b"]
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.sum(y * logp, axis=-1))

    batches = _batches()
    jt = JTrainer(jloss, jupdater(lr=0.3, momentum=0.0, use_adagrad=False),
                  num_workers=1, local_steps=3)
    want = jt.fit({k: jnp.asarray(v) for k, v in _init_np().items()},
                  [(jnp.asarray(x), jnp.asarray(y)) for x, y in batches])
    got = HogwildTrainer(_softmax_loss, _updater(), num_workers=1,
                         local_steps=3, devices=[CPU]).fit(
        _params(), batches)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=TOL)


def test_four_workers_train_iris():
    trainer = HogwildTrainer(_softmax_loss, _updater(), num_workers=4,
                             local_steps=3, device="cpu")
    params = trainer.fit(_params(), _batches(16, 64), seed=0)
    assert _accuracy(params) > 0.75
    assert len(trainer.tracker.updates()) == 16
    assert trainer.tracker.count("iterations") == 16
    assert len(trainer.tracker.workers()) == 4


def test_each_worker_draws_from_its_own_generator():
    """A loss that drops inputs with the worker's generator: the same
    seed reproduces the run, another seed does not; each worker's
    generator is seeded ``seed + w`` on its device."""
    seen = []

    def noisy(params, x, y, gen):
        seen.append((threading.get_ident(), gen.initial_seed(),
                     gen.device.type))
        keep = (torch.rand(x.shape, generator=gen) > 0.2).float()
        return _softmax_loss(params, x * keep, y, gen)

    def run(seed):
        t = HogwildTrainer(noisy, _updater(), num_workers=1, local_steps=2,
                           device="cpu")
        return t.fit(_params(), _batches(4), seed=seed)

    a, b, c = run(3), run(3), run(4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["W"], c["W"])
    seen.clear()
    HogwildTrainer(noisy, _updater(), num_workers=2, local_steps=1,
                   device="cpu").fit(_params(), _batches(6), seed=10)
    by_thread = {}
    for ident, s, dev in seen:
        by_thread.setdefault(ident, set()).add((s, dev))
    assert {s for v in by_thread.values() for s in v} \
        <= {(10, "cpu"), (11, "cpu")}
    assert all(len(v) == 1 for v in by_thread.values())


def test_worker_crash_stops_peers_and_reraises():
    calls = []

    def exploding(params, x, y, gen):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("worker blew up")
        return _softmax_loss(params, x, y, gen)

    trainer = HogwildTrainer(exploding, _updater(), num_workers=2,
                             local_steps=1, device="cpu")
    with pytest.raises(RuntimeError, match="worker blew up"):
        trainer.fit(_params(), _batches(40), seed=0)
    assert trainer._abort.is_set()
    assert trainer.tracker.count("iterations") < 40


def test_ind_array_aggregator_matches_reference():
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel.hogwild import \
        INDArrayAggregator as JAgg

    rng = np.random.default_rng(1)
    trees = [{"w": rng.standard_normal(4).astype(np.float32),
              "b": [rng.standard_normal(2).astype(np.float32)]}
             for _ in range(3)]
    agg, jagg = INDArrayAggregator(), JAgg()
    for t in trees:
        agg.accumulate(tree_map(torch.from_numpy, t))
        jagg.accumulate({"w": jnp.asarray(t["w"]),
                         "b": [jnp.asarray(t["b"][0])]})
    got, want = agg.aggregate(), jagg.aggregate()
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["b"][0].numpy(),
                               np.asarray(want["b"][0]), rtol=1e-6)
    with pytest.raises(AssertionError):
        INDArrayAggregator().aggregate()


def test_hogwild_imports_no_jax():
    assert_no_jax("deeplearning4j_tpu_torch.parallel.hogwild")
