"""The port's layout rules of the ``model`` axis against the reference's.

``transformer`` / ``gpt`` / ``bert`` ``.shard_specs`` (and
``param_specs``, ``pipe_stage_specs``, ``gpt.slot_specs`` /
``paged_specs``) give the same axis names leaf by leaf as the JAX
package's ``PartitionSpec`` trees, at model degrees 1, 2 and 4, with the
reference's divisibility errors; ``sharded_fit.spec_axis_names`` and
``validate_specs_against_mesh`` agree with the reference's; a rank's
slice (``shard_tree``) is the block the reference's ``NamedSharding``
places on that device; GPT-2 small at a model degree of 2 keeps
81,940,992 of its 124,440,576 parameters a rank; the pipe axis lays
the stacked blocks out stage-major as the reference's specs do; and
every entry point builds on a mesh with a pipe or seq axis.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.models import transformer as jtfm
from deeplearning4j_tpu.parallel import sharded_fit as jsf
from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.models import lm_fit as tlm
from deeplearning4j_tpu_torch.models import transformer as ttfm
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.parallel import collectives as tcol
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel import sharded_fit as tsf
from deeplearning4j_tpu_torch.parallel import tensor_parallel as tpar

torch.set_num_threads(2)


def _axes(tree):
    """A spec tree of either package as nested dicts of tuples."""
    if isinstance(tree, dict):
        return {k: _axes(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _axes(getattr(tree, f)) for f in tree._fields}
    return None if tree is None else tuple(tree)


def _cfgs(family):
    small = dict(hidden=32, n_layers=2, n_heads=4, ffn_dim=64)
    if family == "bert":
        return (dataclasses.replace(jbert.bert_tiny(vocab_size=64), **small),
                dataclasses.replace(tbert.bert_tiny(vocab_size=64), **small))
    return (dataclasses.replace(jgpt.gpt_tiny(vocab_size=64), **small),
            dataclasses.replace(tgpt.gpt_tiny(vocab_size=64), **small))


FAMILIES = {"transformer": (jtfm, ttfm), "gpt": (jgpt, tgpt),
            "bert": (jbert, tbert)}


@pytest.mark.parametrize("degree", [1, 2, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_shard_specs_equal_the_references(family, degree):
    jmod, tmod = FAMILIES[family]
    jc, tc = _cfgs("bert" if family == "bert" else "gpt")
    assert _axes(tmod.shard_specs(tc, degree)) \
        == _axes(jmod.shard_specs(jc, degree))


@pytest.mark.parametrize("vocab", [63, 64])
def test_vocab_shards_only_when_the_degree_divides_it(vocab):
    for jmod, tmod in (FAMILIES["gpt"], FAMILIES["bert"]):
        jc, tc = _cfgs("bert" if jmod is jbert else "gpt")
        jc = dataclasses.replace(jc, vocab_size=vocab)
        tc = dataclasses.replace(tc, vocab_size=vocab)
        got, want = tmod.shard_specs(tc, 2), jmod.shard_specs(jc, 2)
        assert _axes(got) == _axes(want)
        assert (tuple(got["embed"]["tok"]) == ("model", None)) \
            == (vocab % 2 == 0)


@pytest.mark.parametrize("family", ["transformer", "bert"])
def test_param_specs_equal_the_references(family):
    jmod, tmod = FAMILIES[family]
    jc, tc = _cfgs("bert" if family == "bert" else "gpt")
    assert _axes(tmod.param_specs(tc)) == _axes(jmod.param_specs(jc))


@pytest.mark.parametrize("kv", [None, "int8"])
def test_slot_and_paged_specs_equal_the_references(kv):
    jc, tc = _cfgs("gpt")
    assert _axes(tgpt.slot_specs(tc, kv)) == _axes(jgpt.slot_specs(jc, kv))
    assert _axes(tgpt.paged_specs(tc, kv)) \
        == _axes(jgpt.paged_specs(jc, kv))


@pytest.mark.parametrize("change,degree,match", [
    (dict(n_heads=6, hidden=36), 4, "n_heads"),
    (dict(n_heads=6, hidden=36), 6, "ffn_dim"),
    (dict(), 3, "n_heads"),
])
def test_divisibility_errors_are_the_references(change, degree, match):
    jc, tc = _cfgs("gpt")
    jc, tc = (dataclasses.replace(c, **change) for c in (jc, tc))
    with pytest.raises(ValueError, match=match) as want:
        jtfm.shard_specs(jc, degree)
    with pytest.raises(ValueError, match=match) as got:
        ttfm.shard_specs(tc, degree)
    assert str(got.value) == str(want.value)


def test_pipe_stage_specs_at_degree_one_and_above():
    jc, tc = _cfgs("gpt")
    blocks_j = jtfm.param_specs(jc)["blocks"]
    blocks_t = ttfm.param_specs(tc)["blocks"]
    assert _axes(ttfm.pipe_stage_specs(blocks_t, tc, 1)) \
        == _axes(jtfm.pipe_stage_specs(blocks_j, jc, 1))
    with pytest.raises(ValueError, match="n_layers=2 not divisible"):
        ttfm.pipe_stage_specs(blocks_t, tc, 3)
    # above a degree of 1 the stacked blocks go stage-major over pipe,
    # the model split kept on the trailing dimensions
    assert _axes(ttfm.shard_specs(tc, 2, pipe_degree=2)) \
        == _axes(jtfm.shard_specs(jc, 2, pipe_degree=2))
    assert ttfm.shard_specs(tc, 2, pipe_degree=2)["blocks"]["wq"] \
        == tpar.P("pipe", None, "model", None)


def test_spec_axis_names_and_validation_match_reference():
    specs = {"w": JP(None, "model"), "b": JP(("data", "pipe"))}
    tspecs = {"w": tpar.P(None, "model"), "b": tpar.P(("data", "pipe"))}
    assert tsf.spec_axis_names(tspecs) == jsf.spec_axis_names(specs) \
        == {"model", "data", "pipe"}

    class Narrow:
        axis_names = ("data",)

    tsf.validate_specs_against_mesh(Narrow(), {"w": tpar.P("data")})
    with pytest.raises(ValueError, match="does not declare"):
        tsf.validate_specs_against_mesh(Narrow(), {"w": tpar.P(None,
                                                               "model")})


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_tree_takes_the_references_device_block(rank):
    """A rank's slice is the shard the reference's NamedSharding puts on
    device ``rank`` of a model=2 mesh."""
    from jax.sharding import NamedSharding
    from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh

    jc, tc = _cfgs("gpt")
    jparams = jgpt.init_params(jax.random.key(0), jc)
    jmesh = make_mesh(MeshSpec(data=1, model=2), devices=jax.devices()[:2])
    jspecs = jgpt.shard_specs(jc, 2)
    placed = jax.device_put(jparams, jax.tree.map(
        lambda s: NamedSharding(jmesh, s), jspecs,
        is_leaf=lambda x: isinstance(x, JP)))
    mesh = tmesh.Mesh({"data": 1, "model": 2}, None, (0, 1), 0,
                      torch.device("cpu"), "gloo",
                      groups={"data": None, "model": None},
                      coords={"data": 0, "model": rank})
    local = ttfm.shard_tree(tgpt.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu"), tgpt.shard_specs(tc, 2),
        mesh)
    dev = jmesh.devices.flat[rank]
    for grp in ("embed", "blocks"):
        for name, leaf in placed[grp].items():
            shard = next(s for s in leaf.addressable_shards
                         if s.device == dev)
            np.testing.assert_array_equal(local[grp][name].numpy(),
                                          np.asarray(shard.data),
                                          err_msg=f"{grp}/{name}")


def _local_numel(shape, spec, degree):
    n = int(np.prod(shape))
    return n // degree if "model" in tuple(spec) else n


def test_gpt2_small_rank_keeps_0_658_of_the_params():
    """GPT-2 small at a model degree of 2: the 50,257-row embedding stays
    replicated (odd vocabulary), so a rank holds 81,940,992 of the
    tree's 124,440,576 parameters (0.658), by the count of the
    reference's specs as of the port's.  (The tree carries a one-row
    token-type table, 768 parameters, beside GPT-2's 124,439,808.)"""
    cfg = tgpt.gpt_config()
    shapes = jax.eval_shape(lambda: jgpt.init_params(jax.random.key(0),
                                                     jgpt.gpt_config()))
    for specs in (tgpt.shard_specs(cfg, 2), jgpt.shard_specs(
            jgpt.gpt_config(), 2)):
        total = local = 0
        for grp in ("embed", "blocks"):
            for name, sds in shapes[grp].items():
                total += int(np.prod(sds.shape))
                local += _local_numel(sds.shape, specs[grp][name], 2)
        assert (local, total) == (81_940_992, 124_440_576)
        assert local / total <= 0.70


def _fake_mesh(**axes):
    m = tmesh.Mesh({"data": 1}, None, (0,), 0, torch.device("cpu"), "gloo")
    m.shape.update(axes)
    return m


@pytest.mark.parametrize("axis,item", [("pipe", "A7.1b"),
                                       ("expert", "A7.1b"),
                                       ("seq", "A7.5")])
def test_unported_axes_raise_naming_their_roadmap_item(axis, item):
    # the axes of ROADMAP A7.1b and A7.5 are ported: every entry point
    # builds on a mesh with them (the expert axis beside a pipe axis),
    # the attention dispatch takes the ring on a seq axis, and a
    # collective over an axis of one is this rank alone
    m = _fake_mesh(**({axis: 2} if axis != "expert"
                      else {"expert": 2, "pipe": 2}))
    tmesh.check_mesh_axes(m)
    tsf.build_sharded_step(lambda *a: a, m, label="x")
    step, _ = tlm.CausalLM(tgpt.gpt_tiny(), device="cpu") \
        ._backprop_machinery(m)
    piped = axis != "seq"
    assert (step.param_specs is not None) == piped
    if piped:
        assert tuple(step.param_specs["blocks"]["wq"])[0] == "pipe"
    _, train = tgpt.make_train_step(tgpt.gpt_tiny(), mesh=m, device="cpu")
    assert tuple(train.specs["blocks"]["wq"])[0] is None  # replicated
    d = fa.make_attn_fn("auto", mesh=m).describe((2, 16, 4, 8),
                                                 (2, 16, 4, 8), True,
                                                 device="cpu",
                                                 dtype=torch.float32)
    assert d.impl == ("ring" if axis == "seq" else "plain")
    torch.testing.assert_close(
        tcol.psum(torch.ones(2), (_fake_mesh(),
                                  "pipe" if axis == "expert" else axis)),
        torch.ones(2))


def test_model_axis_is_accepted_and_the_rest_stays_raising():
    m = _fake_mesh(model=2)
    tmesh.check_mesh_axes(m)
    assert tmesh.model_degree(m) == 2
    assert tmesh.mesh_captures(None)
    assert not tmesh.mesh_captures(m)          # gloo
    # the MoE family, the router over model groups and the engine's
    # knobs on a model mesh are ported (tests/test_torch_expert_parallel
    # .py, tests/test_torch_model_serving.py), and so are a pipe axis
    # beside the model axis and the pipeline's microbatches; serving on
    # a pipe mesh and a group the ranks cannot fill refuse
    from deeplearning4j_tpu_torch.models import moe as tmoe
    piped = _fake_mesh(model=2, pipe=2)
    step, _ = tlm.CausalLM(tmoe.MoETransformerConfig(), device="cpu") \
        ._backprop_machinery(piped)
    assert step.param_specs["blocks"]["wi"] == tpar.P("pipe", "model", None,
                                                      None)
    assert tlm.CausalLM(tgpt.gpt_tiny(), pipe_microbatches=2,
                        device="cpu").pipe_microbatches == 2
    from deeplearning4j_tpu_torch.serving.router import Router
    with pytest.raises(ValueError, match="model_degree 2"):
        Router.replicate(tgpt.gpt_tiny(), None, 1, model_degree=2,
                         device="cpu")
    for knob in (dict(quantize="int8"), dict(kv_dtype="int8")):
        from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
        with pytest.raises(NotImplementedError, match="ROADMAP A7.1b.4"):
            DecodeEngine(tgpt.gpt_tiny(), {}, mesh=piped, device="cpu",
                         **knob)


def test_vocab_embed_needs_its_group():
    with pytest.raises(ValueError, match="model group"):
        tpar.vocab_embed(torch.zeros(4, 2), torch.zeros(3, dtype=torch.long),
                         None)
