"""The port's compile engine (``runtime/compile_cache.py``) on the CPU.

On the CPU the engine calls each function directly and counts the first
call of each signature as its compile, as JAX traces on the CPU; the
CUDA-graph capture itself runs only on the card (``chip_smoke.py``
phase 11).  These tests hold the contract the engine shares with the
reference's ``tests/test_compile_engine.py``:

- one compile per signature, ``cached_dispatches`` for the rest,
  ``clear``/``size`` and the LRU bound on shared entries;
- two identically configured networks compile ``multilayer.train_step``
  once (the reference's docstring; its own run traces it twice on this
  platform, so the port is held to the documented count), and the entry
  does not keep a fitted network alive;
- per-thread attribution under two threads;
- a serving warm-up compiles once a bucket and a mixed-size stream none
  after ``mark_compiles`` (checked against JAX's counts), the decode
  engine likewise;
- the boundary: a read-only argument that a function writes raises, a
  caller's training state survives a step, and a fit leaves the network
  with params of its own;
- the card's bookkeeping, with a CPU stand-in for the capture (it runs
  the function where a CUDA graph would replay it, on the same static
  buffers): states that are alive at once each step from their own
  memory (interleaved through one entry, two same-conf fits in two
  threads), a free state set is reused, a read-only argument is copied
  in only when it changes, and the decode engine's warm-up and burst.
"""

import gc
import threading
import weakref

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import LayerKind as JLayerKind
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.runtime import compile_cache as jcc
from deeplearning4j_tpu.runtime.metrics import compile_metrics as jmetrics
from deeplearning4j_tpu.runtime.metrics import serving_metrics as jserving
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.nn.conf import LayerKind, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import updaters
from deeplearning4j_tpu_torch.runtime import compile_cache
from deeplearning4j_tpu_torch.runtime.metrics import (compile_metrics,
                                                      decode_metrics,
                                                      serving_metrics)
from deeplearning4j_tpu_torch.serving.decode import (ContinuousBatcher,
                                                     DecodeEngine)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def fresh_engine():
    compile_cache.clear()
    compile_metrics.reset()
    serving_metrics.reset()
    decode_metrics.reset()
    yield


def _mlp_conf(conf_cls=NeuralNetConfiguration, kind=LayerKind, lr=0.1):
    return (conf_cls.builder()
            .n_in(4).lr(lr).momentum(0.5).use_adagrad(False)
            .dropout(0.0).num_iterations(5)
            .activation("tanh")
            .list(3)
            .hidden_layer_sizes(8, 6)
            .override(2, kind=kind.OUTPUT, n_out=3,
                      activation="softmax", loss_function="mcxent",
                      dropout=0.0)
            .pretrain(False).backward(True)
            .build())


def _toy_data(n=32, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return DataSet(x, y)


def _net(seed, **kw):
    return MultiLayerNetwork(_mlp_conf(**kw), device="cpu").init(seed=seed)


# -- the engine itself --------------------------------------------------------

def test_one_compile_per_signature_then_cached_dispatches():
    def f(x, scale):
        return x * scale

    g = compile_cache.cached_graph(f, label="t.scale")
    for shape, scale in [((3,), 2.0), ((3,), 2.0), ((4,), 2.0),
                         ((3,), 3.0), ((4,), 2.0), ((3,), 2.0)]:
        out = g(torch.ones(shape), scale)
        assert torch.equal(out, torch.full(shape, scale))
    snap = compile_metrics.snapshot()
    # (3,) x 2.0, (4,) x 2.0 and (3,) x 3.0: three signatures
    assert snap["traces"] == {"t.scale": 3}
    assert snap["compile_count"] == 3
    assert snap["cached_dispatches"] == 3
    assert g.signatures() == 3
    assert g.fn is f and g.label == "t.scale"


def test_signature_walk_flattens_as_the_pytree():
    """The signature's own walk gives the pytree's leaves in its order
    (dicts in insertion order, lists, tuples, named tuples, None), tells
    structures apart as the pytree does, and leaves any other container
    to the pytree."""
    from collections import OrderedDict, namedtuple
    from torch.utils import _pytree as pytree

    Pair = namedtuple("Pair", "k v")
    t = torch.zeros(2, 1)
    tree = ({"b": [t, 3], "a": Pair(t, None)}, (t, "x", torch.float32))
    struct, leaves = [], []
    assert compile_cache._walk(tree, struct, leaves)
    ref = pytree.tree_leaves(tree)
    assert len(leaves) == len(ref)
    assert all(x is y for x, y in zip(leaves, ref))
    g = compile_cache.cached_graph(lambda *a: a[0] * 2, label="t.walk")
    sig = g._signature((t, {"a": 1, "b": 2}), {})[0]
    assert sig != g._signature((t, {"b": 2, "a": 1}), {})[0]
    assert sig != g._signature((t, [1, 2]), {})[0]
    assert sig == g._signature((t.clone(), {"a": 1, "b": 2}), {})[0]
    assert not compile_cache._walk(OrderedDict(a=t), [], [])
    sig_od, lv, _ = g._signature((OrderedDict(a=t),), {})
    assert lv == [t] and sig_od[0][0] == pytree.tree_structure(
        OrderedDict(a=t))


def test_clear_size_and_shared_keys():
    a = compile_cache.cached_graph(lambda x: x + 1, key="k1", label="a")
    b = compile_cache.cached_graph(lambda x: x + 2, key="k1", label="b")
    c = compile_cache.cached_graph(lambda x: x + 3, key="k2", label="c")
    assert a is b and a is not c
    assert compile_cache.size() == 2
    snap = compile_metrics.snapshot()
    assert (snap["engine_builds"], snap["engine_hits"]) == (2, 1)
    assert torch.equal(b(torch.zeros(2)), torch.ones(2))    # a's function
    compile_cache.clear()
    assert compile_cache.size() == 0
    assert compile_cache.cached_graph(lambda x: x, key="k1") is not a


def test_lru_bound_evicts_the_oldest_entry(monkeypatch):
    monkeypatch.setattr(compile_cache, "MAX_ENTRIES", 3)
    built = [compile_cache.get_or_build(("k", i), object) for i in range(5)]
    assert compile_cache.size() == 3
    # the two oldest went; the newest three are hits
    assert compile_cache.get_or_build(("k", 4), object) is built[4]
    assert compile_cache.get_or_build(("k", 0), object) is not built[0]
    assert compile_metrics.snapshot()["engine_builds"] == 6


def test_donated_state_and_device_counter():
    def step(state, it, x):
        state.add_(x * it)
        it.add_(1)
        return state, it, x.sum()

    g = compile_cache.cached_graph(step, label="t.step",
                                   donate_argnums=(0, 1))
    state = torch.zeros(3)
    it = torch.zeros((), dtype=torch.int32)
    for _ in range(3):
        state, it, total = g(state, it, torch.ones(3))
    assert state.tolist() == [3.0, 3.0, 3.0] and int(it) == 3
    assert float(total) == 3.0
    assert compile_metrics.snapshot()["traces"] == {"t.step": 1}
    # the caller's own state is never written; a returned one is
    # updated in place by the call it is passed to
    mine = torch.zeros(3)
    s1, i1, _ = g(mine, torch.zeros((), dtype=torch.int32), torch.ones(3))
    assert mine.tolist() == [0.0, 0.0, 0.0]
    s2, i2, _ = g(s1, i1, torch.ones(3))
    assert s2 is s1 and i2 is i1 and s2.tolist() == [1.0, 1.0, 1.0]


def test_writing_a_read_only_argument_raises():
    def bad(x):
        x.add_(1)
        return x

    with pytest.raises(RuntimeError, match="not donated"):
        compile_cache.cached_graph(bad, label="t.bad")(torch.zeros(2))


def test_per_thread_attribution_under_two_threads():
    """Two threads call one entry with a signature each: exactly one
    compile per signature, every other call a cached dispatch, whatever
    the interleaving."""
    g = compile_cache.cached_graph(lambda x: x * 2, label="t.threads")
    n = 50
    errors = []
    start = threading.Barrier(2)

    def worker(width):
        try:
            start.wait()
            for _ in range(n):
                assert g(torch.ones(width)).shape == (width,)
        except Exception as e:          # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,)) for w in (3, 5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    snap = compile_metrics.snapshot()
    assert snap["compile_count"] == 2
    assert snap["traces"] == {"t.threads": 2}
    assert snap["cached_dispatches"] == 2 * n - 2


# -- the multilayer network ---------------------------------------------------

def test_two_identical_networks_compile_train_step_once():
    data = _toy_data()
    net1, net2 = _net(1), _net(2)
    net1.fit_backprop(data, num_epochs=3)
    net2.fit_backprop(data, num_epochs=3)
    snap = compile_metrics.snapshot()
    assert snap["traces"].get("multilayer.train_step") == 1, snap
    assert snap["compile_count"] == 1, snap
    assert snap["engine_builds"] == 1 and snap["engine_hits"] >= 1, snap
    assert snap["cached_dispatches"] >= 4, snap
    assert net1._machinery() is net2._machinery()
    assert not torch.equal(net1.params_flat(), net2.params_flat())


def test_different_confs_do_not_share_engines():
    _net(1, lr=0.1).fit_backprop(_toy_data())
    _net(1, lr=0.2).fit_backprop(_toy_data())
    snap = compile_metrics.snapshot()
    assert snap["engine_builds"] == 2, snap
    assert snap["traces"].get("multilayer.train_step") == 2, snap


def test_engine_entry_does_not_pin_network():
    net = _net(8)
    net.fit_backprop(_toy_data(), num_epochs=2)
    ref = weakref.ref(net)
    del net
    gc.collect()
    assert ref() is None, "engine entry kept the fitted network alive"
    _net(9).fit_backprop(_toy_data(), num_epochs=1)
    assert compile_metrics.snapshot()["traces"].get(
        "multilayer.train_step") == 1


def test_caller_held_params_survive_fit_backprop():
    """The step donates (writes) its params; the fit copies the network's
    params on entry and clones the trained ones back out."""
    net = _net(3)
    held = net.params
    before = net.params_flat().clone()
    net.fit_backprop(_toy_data(), num_epochs=4)
    held_flat = torch.cat([held[i][k].reshape(-1) for i in range(len(held))
                           for k in sorted(held[i])])
    assert torch.equal(held_flat, before)
    assert not torch.equal(net.params_flat(), before)
    # a later fit of the same conf leaves this network's params alone
    trained = net.params_flat().clone()
    _net(4).fit_backprop(_toy_data(seed=1), num_epochs=2)
    assert torch.equal(net.params_flat(), trained)


# -- serving and decoding -----------------------------------------------------

def _jax_serving_warmup_compiles(buckets):
    jcc.clear()
    jmetrics.reset()
    jserving.reset()
    jnet = JNet(_mlp_conf(JConf, JLayerKind)).init(seed=3)
    eng = jnet.serving_engine(buckets=buckets)
    return eng.warmup(input_shape=(4,))["compiles"]


def test_warmup_compiles_once_per_bucket_then_stream_is_compile_free():
    buckets = (1, 2, 4, 8, 16, 32)
    net = _net(3)
    eng = net.serving_engine(buckets=buckets)
    warm = eng.warmup(input_shape=(4,))
    assert warm["buckets"] == len(buckets)
    assert warm["compiles"] == len(buckets) \
        == _jax_serving_warmup_compiles(buckets)
    assert compile_metrics.snapshot()["traces"] == {
        "serving.forward": len(buckets)}
    serving_metrics.mark_compiles()
    rng = np.random.RandomState(7)
    for n in rng.randint(1, 80, size=40):
        x = rng.randn(int(n), 4).astype(np.float32)
        got = eng.infer(x)
        ref = net.feed_forward(net.params, torch.from_numpy(x))[-1]
        assert torch.allclose(got, ref, rtol=0, atol=2e-6)
    snap = serving_metrics.snapshot()
    assert snap["compile_delta_since_mark"] == 0, snap
    # new params (a refit) are copied in, not captured again
    net.fit_backprop(_toy_data(), num_epochs=1)
    eng.infer(rng.randn(3, 4).astype(np.float32))
    assert compile_metrics.snapshot()["traces"]["serving.forward"] == \
        len(buckets)


def test_decode_warmup_then_burst_is_compile_free():
    cfg = tgpt.gpt_tiny(vocab_size=64, max_len=64)
    params = tgpt.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    eng = DecodeEngine(cfg, params, n_slots=2, buckets=(32, 64),
                       prefill_chunk=8, device="cpu")
    eng.warmup()
    traces = compile_metrics.snapshot()["traces"]
    assert traces == {"decode.prefill": 2, "decode.step": 2}, traces
    decode_metrics.mark_compiles()
    rng = np.random.default_rng(1)
    with ContinuousBatcher(eng, default_max_tokens=6) as cb:
        reqs = [cb.submit(rng.integers(0, 64, size=int(n)),
                          max_tokens=int(m), temperature=t, seed=i)
                for i, (n, m, t) in enumerate(
                    [(3, 6, 0.0), (11, 20, 0.7), (5, 4, 0.0), (17, 30, 1.0)])]
        outs = [r.result(timeout=120) for r in reqs]
    assert [len(o) for o in outs] == [6, 20, 4, 30]
    assert decode_metrics.snapshot()["compile_delta_since_mark"] == 0


def test_train_step_copies_a_callers_state_on_entry():
    """The transformer step donates its state: a state the step did not
    hand out is copied on entry and stays as it was; a returned state is
    the engine's and is updated in place by the next step."""
    cfg = tbert.bert_tiny()
    init, step = tbert.make_train_step(cfg, device="cpu")
    batch = tbert.synthetic_batch(0, cfg, 2, 16, device="cpu")
    s0 = init(torch.Generator().manual_seed(0))
    before = [t.clone() for t in updaters.tree_leaves(s0.params)]
    s1, _ = step(s0, batch)
    for b, t in zip(before, updaters.tree_leaves(s0.params)):
        assert torch.equal(b, t)
    assert int(s0.opt_state.count) == 0 and int(s1.opt_state.count) == 1
    s2, _ = step(s1, batch)
    assert s2.params["embed"]["tok"] is s1.params["embed"]["tok"]
    assert int(s2.opt_state.count) == 2 and s2.step == 2
    assert compile_metrics.snapshot()["traces"] == {"bert.train_step": 1}


# -- the card's bookkeeping, with a CPU stand-in for the capture ------------

class _EagerGraph:
    """Stands in for a captured CUDA graph: ``replay`` runs the function
    on the static buffers it was recorded with and writes fresh outputs
    into the recorded ones, as a replay writes the graph's outputs."""

    def __init__(self, fn, args, kwargs, out):
        self.fn, self.args, self.kwargs, self.out = fn, args, kwargs, out

    def replay(self):
        new = self.fn(*self.args, **self.kwargs)
        for old, fresh in zip(torch.utils._pytree.tree_leaves(self.out),
                              torch.utils._pytree.tree_leaves(new)):
            if isinstance(old, torch.Tensor) and old is not fresh:
                old.copy_(fresh)


def _record_eagerly(fn, args, kwargs, warm_args, gens, device, pool):
    """A capture records and does not run: the recording run's writes to
    the static buffers and generators are rolled back."""
    saved = [g.get_state() for g in gens]
    for _ in range(compile_cache.WARMUP_RUNS):
        a, kw = warm_args()
        fn(*a, **kw)
        for g, st in zip(gens, saved):
            g.set_state(st)
    leaves = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
              if isinstance(t, torch.Tensor)]
    before = [(t.clone(), compile_cache._version(t)) for t in leaves]
    out = fn(*args, **kwargs)
    for t, (b, v) in zip(leaves, before):
        if v is None or t._version != v:
            t.copy_(b)
    for g, st in zip(gens, saved):
        g.set_state(st)
    return _EagerGraph(fn, args, kwargs, out), out


@pytest.fixture
def graphs_on_cpu(monkeypatch):
    monkeypatch.setattr(compile_cache, "_graphs_on", lambda dev: True)
    monkeypatch.setattr(compile_cache, "_new_pool", lambda: None)
    monkeypatch.setattr(compile_cache, "_record", _record_eagerly)


def _toy_step(state, it, x, gen):
    state.mul_(0.5).add_(x * it + torch.rand(3, generator=gen))
    it.add_(1)
    return state, it, state.sum()


def _toy_run(g, seed, n, x):
    gen = torch.Generator().manual_seed(seed)
    state, it = torch.full((3,), float(seed)), torch.ones((), dtype=torch.int32)
    outs = []
    for _ in range(n):
        state, it, total = g(state, it, x, gen)
        outs.append(total)
    return state, torch.stack(outs)


@pytest.mark.parametrize("captured", [False, True])
def test_interleaved_states_each_step_from_their_own(captured, request):
    """``a1 = f(a0); b1 = f(b0); a2 = f(a1)``: a2 is computed from a1,
    whatever b's steps did in between, as with JAX's donation; on the
    card two live states hold two state sets (two captures)."""
    if captured:
        request.getfixturevalue("graphs_on_cpu")
    x = torch.arange(3.0)
    solo = [_toy_run(_toy_step, seed, 4, x) for seed in (1, 2)]
    g = compile_cache.cached_graph(_toy_step, label="t.toy",
                                   donate_argnums=(0, 1))
    gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
    states = [(torch.full((3,), float(s)),
               torch.ones((), dtype=torch.int32)) for s in (1, 2)]
    totals = [[], []]
    for _ in range(4):
        for k in (0, 1):
            *states[k], total = g(*states[k], x, gens[k])
            totals[k].append(total)
    for k in (0, 1):
        assert torch.equal(states[k][0], solo[k][0])
        assert torch.equal(torch.stack(totals[k]), solo[k][1])
    assert compile_metrics.snapshot()["traces"] == {
        "t.toy": 2 if captured else 1}
    assert g.signatures() == (2 if captured else 1)


def test_a_free_state_set_is_reused(graphs_on_cpu):
    """Once a state's aliases are dropped its buffers take the next
    state, copied in, without a capture; a state passed back is not
    copied at all."""
    x = torch.arange(3.0)
    g = compile_cache.cached_graph(_toy_step, label="t.toy",
                                   donate_argnums=(0, 1))
    a, _ = _toy_run(g, 1, 3, x)
    n0 = g.copied_bytes
    del a
    b, totals = _toy_run(g, 2, 3, x)
    assert torch.equal(b, _toy_run(_toy_step, 2, 3, x)[0])
    snap = compile_metrics.snapshot()
    assert snap["traces"] == {"t.toy": 1} and snap["cached_dispatches"] == 5
    # b's first step copies its state (3 fp32 + 1 int32); x is the same
    # tensor at the same version, and b's later steps copy nothing
    assert g.copied_bytes - n0 == 3 * 4 + 4


def test_read_only_argument_is_copied_only_when_it_changes(graphs_on_cpu):
    w = torch.ones(4)
    g = compile_cache.cached_graph(lambda w, x: w * x, label="t.ro")
    x = torch.arange(4.0)
    assert torch.equal(g(w, x), x)
    n0 = g.copied_bytes
    for _ in range(3):
        g(w, x)
    assert g.copied_bytes == n0
    w.mul_(2)                       # a new version: copied in again
    assert torch.equal(g(w, x), 2 * x)
    assert g.copied_bytes == n0 + 16
    assert compile_metrics.snapshot()["traces"] == {"t.ro": 1}


def test_two_same_conf_fits_in_two_threads(graphs_on_cpu):
    """Two networks of one conf fit at once through the shared
    ``multilayer.train_step``, in lockstep (a listener holds each step
    until the other thread's same step is done): each ends where its
    solo fit ends, and the second live state costs its own captures."""
    # a ragged last batch: the per-step path, with listeners every step
    data = [_toy_data(n=16, seed=s) for s in range(3)] + [_toy_data(n=8)]
    solo = []
    for seed in (5, 6):
        net = _net(seed)
        net.fit_backprop(data, num_epochs=2)
        solo.append(net.params_flat())
    lockstep = threading.Barrier(2, timeout=60)

    class Lockstep:
        def iteration_done(self, net, n, score):
            lockstep.wait()

    nets = [_net(5), _net(6)]
    for net in nets:
        net.set_listeners([Lockstep()])
    c0 = compile_metrics.compile_count
    errors = []

    def worker(net):
        try:
            net.fit_backprop(data, num_epochs=2)
        except Exception as e:          # pragma: no cover - reported below
            lockstep.abort()
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(n,)) for n in nets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    for net, ref in zip(nets, solo):
        assert torch.equal(net.params_flat(), ref)
    # one fit reuses the solo fits' free set; the other, alive at the
    # same time, captures both batch shapes on a set of its own
    assert compile_metrics.compile_count - c0 == 2


def test_transformer_states_interleaved(graphs_on_cpu):
    """Two training states through one BERT step, interleaved: each
    equals its solo run, and the initial states are not written."""
    cfg = tbert.bert_tiny()
    init, step = tbert.make_train_step(cfg, device="cpu")
    batch = tbert.synthetic_batch(0, cfg, 2, 16, device="cpu")
    s0 = [init(torch.Generator().manual_seed(s)) for s in (0, 1)]
    before = [updaters.tree_map(torch.clone, s.params) for s in s0]

    def leaves(s):
        return torch.cat([t.reshape(-1) for t in
                          updaters.tree_leaves(s.params)])

    solo = []
    for s in s0:
        for _ in range(3):
            s, _ = step(s, batch)
        solo.append(leaves(s))
        del s
    st = list(s0)
    for _ in range(3):
        for k in (0, 1):
            st[k], _ = step(st[k], batch)
    for k in (0, 1):
        assert torch.equal(leaves(st[k]), solo[k])
        assert int(st[k].opt_state.count) == 3
        for b, t in zip(updaters.tree_leaves(before[k]),
                        updaters.tree_leaves(s0[k].params)):
            assert torch.equal(b, t)


def test_decode_engine_through_the_capture_path(graphs_on_cpu):
    """The decode engine on the card's path: captures equal 2 x buckets,
    the burst adds none, its tokens equal the plain CPU run's, and a
    steady step copies no weights."""
    cfg = tgpt.gpt_tiny(vocab_size=64, max_len=64)
    params = tgpt.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    specs = [(3, 6, 0.0), (11, 20, 0.7), (5, 4, 0.0), (17, 30, 1.0)]

    def burst(eng):
        rng = np.random.default_rng(1)
        with ContinuousBatcher(eng, default_max_tokens=6) as cb:
            reqs = [cb.submit(rng.integers(0, 64, size=n), max_tokens=m,
                              temperature=t, seed=i)
                    for i, (n, m, t) in enumerate(specs)]
            return [r.result(timeout=120) for r in reqs]

    eng = DecodeEngine(cfg, params, n_slots=2, buckets=(32, 64),
                       prefill_chunk=8, device="cpu")
    assert eng.warmup()["compiles"] == 4
    decode_metrics.mark_compiles()
    outs = burst(eng)
    assert decode_metrics.snapshot()["compile_delta_since_mark"] == 0
    eng.start(np.arange(5), max_tokens=8)
    eng.advance(32)
    n0 = eng._decode.copied_bytes
    eng.advance(32)
    assert eng._decode.copied_bytes == n0
    with monkeypatch_graphs_off():
        ref = burst(DecodeEngine(cfg, params, n_slots=2, buckets=(32, 64),
                                 prefill_chunk=8, device="cpu"))
    assert [list(o) for o in outs] == [list(o) for o in ref]


class monkeypatch_graphs_off:
    """The plain CPU path inside a test that stands in for the card."""

    def __enter__(self):
        self._on = compile_cache._graphs_on
        compile_cache._graphs_on = lambda dev: False

    def __exit__(self, *exc):
        compile_cache._graphs_on = self._on
