"""A CPU stand-in for CUDA-graph capture of the functions the port hands
to its compile engine (``runtime/compile_cache``).

A CUDA graph records the kernels of one call and replays them on new
values in the same buffers: a Python number read at capture, or a host
read of a tensor, is frozen into it.  ``make_fx`` records the same
thing on the CPU: each function is traced once on step 0's inputs and
the traced graph is replayed on steps 1-4, where the values that change
from step to step (an iteration, a learning rate, a slot, a position, a
chunk index) differ, and is held EXACTLY (fp32) to the eager function
run on a copy of the same state.  A frozen number or a host read fails
here (``make_fx`` refuses ``.item()``).  A generator is baked into a
traced graph as a constant, as a capture binds the engine's static twin
generator: the tests copy the caller's generator state into it around
every replay, as the engine does.

Covered: the LeNet train step (with a momentum schedule that switches
inside the replayed steps), ``slot_prefill`` at two slots and two
offsets and ``slot_decode`` through the decode engine's functions, the
adamw train step of a 2-layer transformer without dropout, and the
word2vec pair chunk with a decaying learning rate and in-graph
negatives.
"""

import dataclasses

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.models import lenet as tlenet
from deeplearning4j_tpu_torch.nlp import word2vec as tw2v
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.serving.decode import DecodeEngine

torch.set_num_threads(2)


def _clone(x):
    """A deep copy of nested dicts, lists and (named) tuples of tensors."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_clone(v) for v in x]
    if isinstance(x, tuple):
        vals = [_clone(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def _leaves(x):
    out = []
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, dict):
        for v in x.values():
            out.extend(_leaves(v))
    elif isinstance(x, (list, tuple)):
        for v in x:
            out.extend(_leaves(v))
    return out


def _assert_equal(got, ref, what):
    got, ref = _leaves(got), _leaves(ref)
    assert len(got) == len(ref), what
    for i, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g, r), f"{what}: leaf {i} differs"


class _Replay:
    """``fn`` traced on its first arguments; later calls replay the traced
    graph.  ``gen`` (the generator the trace baked in) takes a caller's
    generator state before a replay and gives it back after."""

    def __init__(self, fn, args, gen=None):
        self.gen = gen
        self.gm = make_fx(fn)(*args)

    def __call__(self, *args, caller_gen=None):
        if caller_gen is not None:
            self.gen.set_state(caller_gen.get_state())
        out = self.gm(*args)
        if caller_gen is not None:
            caller_gen.set_state(self.gen.get_state())
        return out


def test_lenet_train_step_replays_like_eager():
    conf = tlenet.lenet_conf()
    for c in conf.confs:
        c.momentum_after = {2: 0.9}         # switches inside steps 1-4
    net = MultiLayerNetwork(conf, device="cpu").init()
    step = net._machinery()[0].fn
    params, ustate, it, gen = net._fit_state(2)

    def batch(seed):
        rng = np.random.default_rng(seed)
        x = rng.random((4, 28, 28, 1), dtype=np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)]
        return torch.from_numpy(x), torch.from_numpy(y)

    eager = _clone((params, ustate, it))
    graph = _clone((params, ustate, it))
    replay = _Replay(step, _clone((params, ustate, it)) + batch(0)
                     + (gen,))
    for k in range(1, 5):
        x, y = batch(k)
        ref = step(*eager, x, y, gen)
        out = replay(*graph, x, y, gen)
        _assert_equal(out, ref, f"step {k}")
    assert int(graph[2]) == 4


def _decode_setup():
    cfg = dataclasses.replace(tgpt.gpt_tiny(vocab_size=64, max_len=64),
                              compute_dtype="float32")
    params = tgpt.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    eng = DecodeEngine(cfg, params, n_slots=2, buckets=(64,),
                       prefill_chunk=8, device="cpu")
    return cfg, eng, eng.current_params()


def _prefill_args(slots, toks, slot, start, n_valid, temp, seed):
    return (slots, toks,
            torch.tensor([slot, start, n_valid, seed], dtype=torch.int64),
            torch.tensor(temp, dtype=torch.float32))


def test_slot_prefill_and_decode_replay_like_eager():
    cfg, eng, params = _decode_setup()
    prefill, decode = eng._prefill.fn, eng._decode.fn
    slots = tgpt.init_slots(cfg, 2, 64, device="cpu")
    rng = np.random.default_rng(3)
    chunks = [torch.from_numpy(rng.integers(0, 64, 8).astype(np.int32))
              for _ in range(5)]
    # (slot, start, n_valid, temperature, seed): two slots, two offsets
    calls = [(0, 0, 8, 0.0, 3), (1, 0, 8, 0.7, 5), (0, 8, 8, 0.0, 3),
             (1, 8, 5, 0.9, 5), (0, 16, 3, 1.0, 7)]
    eager, graph = _clone(slots), _clone(slots)
    prefill(params, _clone(slots), *_prefill_args(None, chunks[0],
                                                   *calls[0])[1:])
    replay = _Replay(prefill, (params,) + _prefill_args(
        _clone(slots), chunks[0], *calls[0]))
    for toks, call in zip(chunks, calls):
        ref = prefill(params, *_prefill_args(eager, toks, *call))
        out = replay(params, *_prefill_args(graph, toks, *call))
        _assert_equal(out, ref, f"prefill {call}")
    active = torch.tensor([True, True])
    temps = torch.tensor([0.0, 0.8])
    seeds = torch.tensor([3, 5], dtype=torch.int64)
    dreplay = _Replay(decode, (params, _clone(eager), active, temps, seeds))
    for k in range(4):
        if k == 2:
            active = torch.tensor([True, False])   # a slot leaves
        ref = decode(params, eager, active, temps, seeds)
        out = dreplay(params, graph, active, temps, seeds)
        _assert_equal(out, ref, f"decode step {k}")
    assert graph.pos.tolist() == [23, 15]


def test_transformer_adamw_step_replays_like_eager():
    cfg = dataclasses.replace(tbert.bert_tiny(), n_layers=2, dropout=0.0,
                              compute_dtype="float32")
    init, step_fn = tbert.make_train_step(cfg, attn_fn=fa.flash_attention,
                                          device="cpu")
    state = init(torch.Generator().manual_seed(0))
    step = step_fn.graph.fn
    batches = [tbert.synthetic_batch(k, cfg, 2, 16, device="cpu")
               for k in range(5)]
    eager = _clone((state.params, state.opt_state))
    graph = _clone((state.params, state.opt_state))
    replay = _Replay(step, _clone((state.params, state.opt_state))
                     + (batches[0], None))
    for k in range(1, 5):
        ref = step(*eager, batches[k], None)
        out = replay(*graph, batches[k], None)
        _assert_equal(out, ref, f"step {k}")
    assert int(graph[1].count) == 4


def test_word2vec_pair_chunk_replays_like_eager():
    V, D, B, NC, L, K, W = 40, 8, 32, 5, 4, 3, 3
    rng = np.random.default_rng(0)
    gen_t = torch.Generator().manual_seed(11)
    state = ((torch.rand((V, D), generator=gen_t) - 0.5) / D,
             torch.randn((V, D), generator=gen_t) * 0.1,
             torch.randn((V, D), generator=gen_t) * 0.1)
    slab = tuple(torch.from_numpy(a) for a in (
        rng.integers(0, V, (NC, B)).astype(np.int32),
        rng.integers(0, V, (NC, B)).astype(np.int32),
        rng.integers(0, 1000, (NC, B)).astype(np.int32),
        rng.integers(-W, W + 1, (NC, B)).astype(np.int32)))
    n_real = torch.tensor([B] * (NC - 1) + [B - 7])
    alphas = tw2v._alphas(0.025, 1e-4, np.linspace(0.0, 0.9, NC,
                                                   dtype=np.float32), "cpu")
    assert len(set(alphas.tolist())) == NC           # it decays
    hs = (torch.from_numpy(rng.integers(0, 2, (V, L)).astype(np.float32)),
          torch.from_numpy(rng.integers(0, V, (V, L)).astype(np.int32)),
          torch.from_numpy((rng.random((V, L)) < 0.8).astype(np.float32)))
    table = torch.from_numpy(rng.integers(0, V, 100).astype(np.int32))
    seed32 = torch.tensor([12345], dtype=torch.int64)
    kw = dict(window=W, window_mask=True, use_hs=True, negative=K,
              impl="plain")

    def chunk(state, c, gen):
        return tw2v._pair_chunk(state, c, *slab, n_real, alphas, seed32, hs,
                                table, None, gen, **kw)

    c0 = torch.zeros(1, dtype=torch.int64)
    twin = torch.Generator().manual_seed(0)
    eager_gen = torch.Generator().manual_seed(9)
    caller_gen = torch.Generator().manual_seed(9)
    replay = _Replay(chunk, (_clone(state), c0.clone(), twin), gen=twin)
    eager = (_clone(state), c0.clone())
    graph = (_clone(state), c0.clone())
    for k in range(NC):
        ref = chunk(*eager, eager_gen)
        out = replay(*graph, twin, caller_gen=caller_gen)
        _assert_equal(out, ref, f"chunk {k}")
    assert int(graph[1]) == NC
    assert torch.equal(caller_gen.get_state(), eager_gen.get_state())
