"""The port's ``CausalLM`` against the JAX reference's.

The same params (JAX's ``init``, carried through the shared checkpoint
format: ``save_pytree`` by one package, ``load_pytree`` by the other)
and the same numpy ids go through each package's ``fit_backprop``; the
per-step scores (a listener) and the final ``params_flat()`` are
compared.  Configs are the reference's test sizes at fp32 compute
(``gpt_tiny``, the default ``MoETransformerConfig``: depth 2, width 64,
T = 32), dropout 0; the port's attention on the CPU is the plain one,
which is what the reference's step computes on a mesh of one.

Tolerances: fp32 1e-5 relative on the scores and on the params' L2
(summed products and log-softmax rounded by each library); bf16 mixed
precision 5e-2 (the bf16 forward tests' bar).  ``ResilientFit`` kill
and resume, and the 2-rank fit against the port's ``grad_accum=2``,
are bit-equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.models import lm_fit as jlm
from deeplearning4j_tpu.models import moe as jmoe
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.runtime import checkpoint as jck
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.models import lm_fit as tlm
from deeplearning4j_tpu_torch.models import moe as tmoe
from deeplearning4j_tpu_torch.ops.updaters import tree_map
from deeplearning4j_tpu_torch.runtime import checkpoint as tck
from deeplearning4j_tpu_torch.runtime.resilience import (ResilienceConfig,
                                                         ResilientFit)
from test_torch_mesh import _fake_mesh, lm_fit_rank, lm_ids, run_ranks

torch.set_num_threads(2)

TOL = {"off": 1e-5, "bf16": 5e-2}


def _cfgs(kind, mp="off"):
    cdt = "bfloat16" if mp == "bf16" else "float32"
    if kind == "gpt":
        return (dataclasses.replace(jgpt.gpt_tiny(), compute_dtype=cdt),
                dataclasses.replace(tgpt.gpt_tiny(), compute_dtype=cdt))
    return tuple(dataclasses.replace(m.MoETransformerConfig(),
                                     compute_dtype=cdt) for m in (jmoe, tmoe))


class _Scores:
    def __init__(self):
        self.seen = []

    def iteration_done(self, model, i, score):
        self.seen.append(float(score))


def _pair(kind, tmp_path, mp="off", accum=1):
    """(JAX CausalLM, port CausalLM) holding the same params."""
    jc, tc = _cfgs(kind, mp)
    kw = dict(lr=0.05, momentum=0.9, mixed_precision=mp, grad_accum=accum)
    j = jlm.CausalLM(jc, **kw).init(0)
    t = tlm.CausalLM(tc, device="cpu", **kw).init(1)
    path = str(tmp_path / f"{kind}.npz")
    jck.save_pytree(path, j.params)
    t.params, _ = tck.load_pytree(path, like=t.params)
    return j, t


def _fit(model, data_cls, ids, **kw):
    rec = _Scores()
    model.listeners = [rec]
    model.fit_backprop([data_cls(x, x) for x in ids], num_epochs=2, **kw)
    return np.asarray(model.params_flat()), np.array(rec.seen)


@pytest.mark.parametrize("kind,mp,accum", [
    ("gpt", "off", 1), ("gpt", "off", 2), ("gpt", "bf16", 1),
    ("moe", "off", 1), ("moe", "off", 2), ("moe", "bf16", 1)])
def test_fit_matches_reference(kind, mp, accum, tmp_path):
    j, t = _pair(kind, tmp_path, mp, accum)
    ids = lm_ids(j.cfg.vocab_size)
    want, jscores = _fit(j, JDataSet, ids)
    got, tscores = _fit(t, TDataSet, ids)
    tol = TOL[mp]
    np.testing.assert_allclose(tscores, jscores, rtol=tol)
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)
    assert t.guard_skips == 0
    if mp == "bf16":
        assert float(t.loss_scale["scale"]) == 2.0 ** 15
        assert int(t.loss_scale["good_steps"]) == 6
    else:
        assert t.loss_scale is None


def test_ragged_batch_matches_reference(tmp_path):
    j, t = _pair("gpt", tmp_path, accum=2)
    ids = lm_ids(j.cfg.vocab_size)
    ids[-1] = ids[-1][:5]
    want, jscores = _fit(j, JDataSet, ids)
    got, tscores = _fit(t, TDataSet, ids)
    np.testing.assert_allclose(tscores, jscores, rtol=TOL["off"])
    assert np.linalg.norm(got - want) <= TOL["off"] * np.linalg.norm(want)


def test_params_cross_the_checkpoint_format_both_ways(tmp_path):
    j, t = _pair("moe", tmp_path)
    np.testing.assert_array_equal(t.params_flat().numpy(),
                                  np.asarray(j.params_flat()))
    path = str(tmp_path / "back.npz")
    tck.save_pytree(path, t.params)
    back, _ = jck.load_pytree(path, like=j.params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(j.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert t.num_param_bytes() == j.num_param_bytes()


def test_resilient_fit_resumes_bit_exactly(tmp_path):
    cfg = dataclasses.replace(tgpt.gpt_tiny(), compute_dtype="bfloat16")
    ids = [TDataSet(x, x) for x in lm_ids(cfg.vocab_size, n=4)]

    def run(d, **kw):
        lm = tlm.CausalLM(cfg, lr=0.05, momentum=0.9, mixed_precision="bf16",
                          device="cpu").init(0)
        rf = ResilientFit(lm, ResilienceConfig(
            checkpoint_dir=str(d), checkpoint_every=2, shuffle=False, **kw))
        rf.fit(ids, num_epochs=2)
        return lm

    whole = run(tmp_path / "whole")
    part = run(tmp_path / "part", max_steps=3)
    assert not torch.equal(part.params_flat(), whole.params_flat())
    resumed = run(tmp_path / "part", resume=True)
    assert torch.equal(resumed.params_flat(), whole.params_flat())
    assert torch.isfinite(whole.params_flat()).all()


def test_poisoned_step_skips_and_halves_the_scale():
    cfg = dataclasses.replace(tgpt.gpt_tiny(), compute_dtype="bfloat16")
    lm = tlm.CausalLM(cfg, lr=0.05, momentum=0.9, mixed_precision="bf16",
                      device="cpu").init(0)
    step, _ = lm._backprop_machinery()
    params = tree_map(torch.clone, lm.params)
    params["blocks"]["w1"][0, 0, 0] = float("inf")
    ustate = step.init_ustate(params)
    ids = torch.from_numpy(lm_ids(cfg.vocab_size, n=1)[0])
    it = torch.zeros((), dtype=torch.int32)
    before = tree_map(torch.clone, params)
    p, u, it, score, skipped = step(
        params, ustate, it, (ids, ids, torch.tensor(8, dtype=torch.int32)),
        None)
    assert int(skipped) == 1 and int(it) == 1
    for a, b in zip(tlm._sorted_leaves(p), tlm._sorted_leaves(before)):
        assert torch.equal(a, b)
    assert all(float(m.abs().sum()) == 0.0 for m in tlm._sorted_leaves(u[0]))
    assert float(u[1]["scale"]) == 2.0 ** 14


def test_unported_axes_and_pipeline_raise_naming_a7():
    # the pipeline's microbatches are ported: at mesh=None
    # pipe_microbatches=2 walks the same two slices, in the same order,
    # as grad_accum=2 (the pipe and seq meshes: test_torch_pipeline.py,
    # test_torch_ring_attention.py)
    cfg = dataclasses.replace(tgpt.gpt_tiny(), compute_dtype="float32")
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size, (4, 16)) \
        .astype(np.int32)
    flats = []
    for kw in (dict(pipe_microbatches=2), dict(grad_accum=2)):
        lm = tlm.CausalLM(cfg, lr=0.05, momentum=0.9, device="cpu", **kw)
        lm.init(0).fit_backprop([TDataSet(ids, ids)], num_epochs=2)
        flats.append(lm.params_flat())
    assert torch.equal(*flats)
    with pytest.raises(ValueError, match="pipe_microbatches"):
        tlm.CausalLM(cfg, pipe_microbatches=0, device="cpu")
    with pytest.raises(ValueError, match="causal"):
        tlm.CausalLM(dataclasses.replace(cfg, causal=False), device="cpu")
    with pytest.raises(ValueError, match="mixed_precision"):
        tlm.CausalLM(cfg, mixed_precision="fp16", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tlm.CausalLM(cfg)


def test_two_rank_fit_matches_reference_and_grad_accum_2(tmp_path):
    jc, tc = _cfgs("gpt")
    j = jlm.CausalLM(jc, lr=0.05, momentum=0.9).init(0)
    params_np = tree_map(lambda a: np.array(a), jax.tree.map(np.asarray,
                                                             j.params))
    ids = lm_ids(jc.vocab_size)
    r0, r1 = run_ranks(lm_fit_rank, 2, tmp_path, params_np, ids)
    np.testing.assert_array_equal(r0, r1)
    accum = tlm.CausalLM(tc, lr=0.05, momentum=0.9, grad_accum=2,
                         device="cpu")
    accum.params = tree_map(torch.from_numpy, params_np)
    # one thread, as a rank runs: the CPU's products split their sums by
    # thread count
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got, _ = _fit(accum, TDataSet, ids)
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(r0, got)
    mesh = jmesh.make_mesh(jmesh.MeshSpec(data=2), devices=jax.devices()[:2])
    want, _ = _fit(j, JDataSet, ids, mesh=mesh)
    assert np.linalg.norm(r0 - want) <= TOL["off"] * np.linalg.norm(want)
