"""Serving on a pipe or seq mesh, against the JAX reference.

The reference's model-sharded ``DecodeEngine`` (``serving/decode.py``
:603-730) splits only the ``model`` axis (``gpt.shard_specs`` at a pipe
degree of 1, ``P()`` for the rest), so on a mesh with a ``pipe`` or
``seq`` axis above 1 every device of that axis holds the whole served
tree and decodes the same tokens.  The port's engine does the same, and
its ``ContinuousBatcher`` serves the ranks that share a data coordinate
as one group: the lowest rank leads, the others follow its schedule.

Held on spawned gloo CPU ranks (``test_torch_mesh.run_ranks``), a tiny
GPT (``test_torch_model_serving``'s), greedy tokens, token for token:

- two ranks on ``data=1 x pipe=2`` and on ``data=1 x seq=2``: each
  rank's engine gives ``mesh=None``'s tokens and the reference engine's
  on a CPU mesh of the same shape, with int8 weights, int8 KV, pages,
  the prefix store (a second request mounts the first's prefix) and a
  draft; each rank holds the whole served tree; the batcher on the
  group serves concurrent clients through rank 0, and rank 1 refuses a
  submit;
- four ranks on ``data=1 x model=2 x pipe=2`` with int8 weights: every
  rank's tokens equal the reference's int8 engine's on a 2 x 2 CPU
  mesh, the model-split leaves are half the replicated ones on every
  rank, and the batcher over the four ranks serves the burst.

The module imports no JAX at its top, so the spawned ranks do not
either; the reference runs inside the tests.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from test_torch_mesh import run_ranks
from test_torch_model_serving import (BURST, DRAFT_KW, ENGINE, PROMPTS,
                                      _greedy, _jax_cfg, _jtree,
                                      _port_cfg, _spec_greedy, _tensors)

torch.set_num_threads(2)

DEADLINE_S = 300.0
#: the knobs each rank serves with, by name
KNOBS = {"plain": {}, "q8": dict(quantize="int8"),
         "kv8": dict(kv_dtype="int8"), "paged": dict(paged=True),
         "prefix": dict(prefix_cache=True)}


def _bytes(tree) -> int:
    from deeplearning4j_tpu_torch.runtime.quantize import tree_bytes
    return tree_bytes(tree)


def _serve_burst(b):
    results = [None] * len(BURST)

    def client(i):
        prompt, n = BURST[i]
        results[i] = b.submit(prompt, max_tokens=n).result(120).tolist()

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(BURST))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(150)
    return results


def _batcher(eng):
    from deeplearning4j_tpu_torch.serving.decode import ContinuousBatcher

    b = ContinuousBatcher(eng, default_max_tokens=8)
    out = {"leads": b.leads}
    if b.leads:
        out["burst"] = _serve_burst(b)
    else:
        try:
            b.submit([1, 2])
            out["submit"] = "accepted"
        except RuntimeError as e:
            out["submit"] = str(e)
    b.close()
    out["closed"] = not b._thread.is_alive()
    return out


def pipe_seq_rank(_data_mesh, p):
    """Two ranks: every knob on ``pipe=2`` and on ``seq=2``."""
    from deeplearning4j_tpu_torch.parallel import mesh as tmesh
    from deeplearning4j_tpu_torch.runtime.metrics import decode_metrics
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine

    cfg = _port_cfg()
    params = _tensors(p["params"])
    draft = (_port_cfg(**DRAFT_KW), _tensors(p["draft"]))
    out = {}
    for axis in ("pipe", "seq"):
        mesh = tmesh.make_mesh(tmesh.MeshSpec(data=1, **{axis: 2}))
        res = {}
        for name, kw in KNOBS.items():
            eng = DecodeEngine(cfg, params, mesh=mesh, device="cpu",
                               **ENGINE, **kw)
            hits = decode_metrics.prefix_hits
            res[name] = [_greedy(eng, q) for q in PROMPTS]
            if name == "prefix":
                # the same prompt again mounts the stored prefix
                res["prefix_again"] = _greedy(eng, PROMPTS[2])
                res["prefix_hits"] = decode_metrics.prefix_hits - hits
            if name == "plain":
                rep = DecodeEngine(cfg, params, device="cpu", **ENGINE)
                res["bytes"] = (_bytes(eng.current_params()),
                                _bytes(rep.current_params()))
                res["kv_bytes"] = (eng.kv_bytes_per_slot,
                                   rep.kv_bytes_per_slot)
        eng = DecodeEngine(cfg, params, mesh=mesh, device="cpu",
                           draft=draft, draft_k=3, **ENGINE)
        res["spec"] = [_spec_greedy(eng, q) for q in PROMPTS]
        res["batcher"] = _batcher(DecodeEngine(cfg, params, mesh=mesh,
                                               device="cpu", **ENGINE))
        out[axis] = res
    return out


def model_pipe_rank(_data_mesh, p):
    """Four ranks on ``data=1 x model=2 x pipe=2``, int8 weights."""
    from deeplearning4j_tpu_torch.parallel import mesh as tmesh
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine

    cfg = _port_cfg()
    params = _tensors(p["params"])
    mesh = tmesh.make_mesh(tmesh.MeshSpec(data=1, model=2, pipe=2))
    eng = DecodeEngine(cfg, params, mesh=mesh, quantize="int8",
                       device="cpu", **ENGINE)
    served = eng.current_params()["blocks"]["w1"]
    out = {"tokens": [_greedy(eng, q) for q in PROMPTS],
           "coords": dict(mesh.coords),
           "w1_cols": int(served.q.shape[-1])}
    out["batcher"] = _batcher(DecodeEngine(cfg, params, mesh=mesh,
                                           quantize="int8", device="cpu",
                                           **ENGINE))
    return out


# ---------------------------------------------------------------------------
# the reference side and the fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def payload():
    from test_torch_decode import numpy_params
    return {"params": numpy_params(_jax_cfg()),
            "draft": numpy_params(_jax_cfg(**DRAFT_KW), seed=1)}


@pytest.fixture(scope="module")
def two(payload, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe_serving")
    return run_ranks(pipe_seq_rank, 2, tmp, payload, deadline=DEADLINE_S)


@pytest.fixture(scope="module")
def four(payload, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_pipe_serving")
    return run_ranks(model_pipe_rank, 4, tmp, payload, deadline=DEADLINE_S)


def _jax_tokens(payload, spec=None, prompts=PROMPTS, **kw):
    """The reference engine's greedy tokens, replicated or on a CPU mesh
    of ``spec``'s shape."""
    import jax
    from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh
    from deeplearning4j_tpu.serving.decode import DecodeEngine as JEngine

    mesh = None
    if spec is not None:
        n = int(np.prod(list(spec.values())))
        mesh = make_mesh(MeshSpec(**spec), devices=jax.devices()[:n])
    eng = JEngine(_jax_cfg(), _jtree(payload["params"]), mesh=mesh,
                  **ENGINE, **kw)
    return [_greedy(eng, q) for q in prompts]


def _port_tokens(payload, **kw):
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
    eng = DecodeEngine(_port_cfg(), _tensors(payload["params"]),
                       device="cpu", **ENGINE, **kw)
    return [_greedy(eng, q) for q in PROMPTS]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", ["pipe", "seq"])
@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_engine_on_a_pipe_or_seq_mesh_matches_reference(two, payload, axis,
                                                        knob):
    """Each rank's greedy tokens equal the port's ``mesh=None`` engine's
    and the reference engine's on a 2-device CPU mesh of the same shape,
    with the same knob (the prefix store's cold tokens; its hit is the
    next test's)."""
    kw = {k: v for k, v in KNOBS[knob].items() if k != "prefix_cache"}
    want = _jax_tokens(payload, {"data": 1, axis: 2}, **kw)
    assert _port_tokens(payload, **kw) == want
    for r in two:
        assert r[axis][knob] == want


@pytest.mark.parametrize("axis", ["pipe", "seq"])
def test_pipe_or_seq_ranks_hold_the_whole_tree_and_share_prefixes(two,
                                                                  axis):
    """The served tree and the KV a slot are the replicated engine's on
    every rank; a second request for a stored prompt mounts its prefix
    and gives the same tokens; a draft's speculative tokens are the
    plain ones."""
    for r in two:
        res = r[axis]
        assert res["bytes"][0] == res["bytes"][1]
        assert res["kv_bytes"][0] == res["kv_bytes"][1]
        assert res["prefix_again"] == res["prefix"][2]
        assert res["prefix_hits"] >= 1
        assert res["spec"] == res["plain"]


@pytest.mark.parametrize("axis", ["pipe", "seq"])
def test_batcher_on_a_pipe_or_seq_group(two, payload, axis):
    """Rank 0 leads the group and serves six concurrent clients, each
    the port's ``mesh=None`` greedy continuation of its own prompt (whose
    equality to the reference's the engine test holds); rank 1 follows, refuses a submit, and both
    workers stop at the leader's close."""
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
    eng = DecodeEngine(_port_cfg(), _tensors(payload["params"]),
                       device="cpu", **ENGINE)
    want = [_greedy(eng, q, n) for q, n in BURST]
    lead, follow = (r[axis]["batcher"] for r in two)
    assert lead["leads"] and not follow["leads"]
    assert lead["burst"] == want
    assert "submit on the group's model rank 0" in follow["submit"]
    assert lead["closed"] and follow["closed"]


def test_int8_weights_on_model_by_pipe_mesh_match_reference(four, payload):
    """``data=1 x model=2 x pipe=2``: every rank's int8 tokens equal the
    reference's int8 engine's on a 2 x 2 CPU mesh (and its replicated
    one's); each rank holds its model shard (half of w1's columns) and
    the whole tree across pipe; rank 0 leads the four."""
    want = _jax_tokens(payload, {"data": 1, "model": 2, "pipe": 2},
                       quantize="int8")
    assert want == _jax_tokens(payload, quantize="int8")
    cfg = _port_cfg()
    for g, r in enumerate(four):
        assert r["tokens"] == want
        assert (r["coords"]["model"], r["coords"]["pipe"]) == (g // 2,
                                                               g % 2)
        assert r["w1_cols"] == cfg.ffn_dim // 2
        assert r["batcher"]["leads"] == (g == 0)
        assert r["batcher"]["closed"]
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
    eng = DecodeEngine(cfg, _tensors(payload["params"]), quantize="int8",
                       device="cpu", **ENGINE)
    assert four[0]["batcher"]["burst"] == [_greedy(eng, q, n)
                                           for q, n in BURST]
