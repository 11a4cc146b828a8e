"""The port's public surface closed: the seven examples and the last names.

- ``ops/flash_attention``'s ``attention_auto``, ``make_flash_attn`` and
  ``AttnDecision.kernel_name`` against the JAX package's on the CPU
  (its ``attention_auto`` is the XLA attention there), within 1e-5 from
  the same numpy q, k, v and mask;
- ``runtime/autotune.measured_crossover`` on a hand-written cache with
  two rows buckets, a losing and a winning key-length bucket, against
  the reference's on the same records in its own key format;
- ``Evaluation.accuracy_delta`` / ``assert_accuracy_within`` against
  the reference's on the same labels and predictions;
- each example's ``main(["--device", "cpu", ...])`` at the reference's
  sizes with ``chip_smoke.py`` phase 26's checks: LeNet's test accuracy
  >= 0.90 and its conf JSON byte-equal to the reference's, word2vec's
  three nearest words in the vocabulary, GloVe's similarities finite,
  every LM and BERT loss finite and below its first step's, the word
  counts equal to the JAX package's ``word_count_distributed``, the
  streaming accuracies >= 0.85; ``data_parallel --ranks 2`` and
  ``parallelism_axes`` (8 ranks) as spawned gloo ranks;
- no fallback: without CUDA and ``--device cpu`` an example stops with
  ``resolve_device``'s message, and a rank that dies or hangs fails the
  spawner within its deadline, naming the rank.
"""

import ast
import json
import math
import re
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.eval.evaluation import Evaluation as JEvaluation
from deeplearning4j_tpu.ops import pallas_attention as jpa
from deeplearning4j_tpu.runtime import autotune as jat
from deeplearning4j_tpu_torch import examples
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.models import transformer as ttfm
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.runtime import autotune as at

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
NAMES = ("mnist_lenet", "word_embeddings", "data_parallel",
         "distributed_runtime", "text_generation", "parallelism_axes",
         "streaming_ingestion")


def _example(name):
    import importlib
    return importlib.import_module(f"deeplearning4j_tpu_torch.examples.{name}")


def _launches(out):
    """The launches line's counts; every example prints exactly one."""
    lines = [ln for ln in out.splitlines()
             if ln.startswith(examples.LAUNCHES_PREFIX)]
    assert len(lines) == 1, out
    counts = json.loads(lines[0][len(examples.LAUNCHES_PREFIX):])
    assert sorted(counts) == sorted(examples.KERNELS)
    return counts


def _run(name, capsys, *argv):
    rc = _example(name).main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert rc == 0, out
    counts = _launches(out)
    # no hand kernel runs on CPU tensors: the plain twins do
    assert not any(counts.values()), counts
    return out


# -- attention ---------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_attention_auto_matches_jax_on_the_cpu(causal, masked):
    rng = np.random.default_rng(3)
    B, T, H, D = 2, 24, 4, 16
    q, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32)
               for _ in range(3))
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[1, 17:] = 0
    ref = jpa.attention_auto(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             None if mask is None else jnp.asarray(mask),
                             causal)
    got = fa.attention_auto(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v),
                            None if mask is None else torch.from_numpy(mask),
                            causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_kernel_name_maps_the_impl():
    assert fa.AttnDecision("cuda", "heuristic").kernel_name == "cuda"
    assert fa.AttnDecision("plain", "off-cuda").kernel_name == "plain"
    assert fa.AttnDecision("ring", "seq-sharded").kernel_name == "ring"
    attn = fa.make_attn_fn("auto")
    assert attn.describe((2, 128, 4, 64), (2, 128, 4, 64),
                         device="cpu").kernel_name == "plain"
    assert attn.describe((2, 128, 4, 64), (2, 128, 4, 64),
                         device="cuda").kernel_name == "cuda"
    assert attn.describe((2, 128, 4, 12), (2, 128, 4, 12),
                         device="cuda").kernel_name == "plain"
    # the reference's names for the same three cases
    assert jpa.AttnDecision("xla", False, 128, 128, "off-tpu",
                            4096).kernel_name == "xla"


def test_make_flash_attn_on_a_cpu_mesh_is_the_plain_attention(tmp_path):
    from deeplearning4j_tpu_torch.parallel import mesh as pm

    pm.initialize_distributed(f"file://{tmp_path}/rdv", 1, 0, device="cpu")
    try:
        mesh = pm.make_mesh(pm.MeshSpec(data=1))
        assert fa.make_flash_attn(mesh) is ttfm.attention
    finally:
        torch.distributed.destroy_process_group()
    # as the reference: its XLA attention off the TPU
    from deeplearning4j_tpu.models import transformer as jtfm
    assert jpa.make_flash_attn(jax.sharding.Mesh(
        np.asarray(jax.devices()[:1]), ("data",))) is jtfm.attention


@pytest.mark.parametrize("seq,plain", [(1, False), (2, True)],
                         ids=["data-mesh", "seq-mesh"])
def test_make_flash_attn_on_a_card_mesh(seq, plain):
    """On a CUDA mesh the kernels' dispatch, except under a seq axis
    (ring attention owns it); the mesh is described, not joined."""
    import types

    mesh = types.SimpleNamespace(device="cuda", shape={"data": 1,
                                                        "seq": seq})
    attn = fa.make_flash_attn(mesh)
    if plain:
        assert attn is ttfm.attention
    else:
        assert attn is not ttfm.attention
        assert attn.describe((2, 128, 4, 64), (2, 128, 4, 64),
                             device="cuda").impl == "cuda"


# -- the measured crossover --------------------------------------------------

KIND = "NVIDIA H100 80GB HBM3"
#: (rows bucket, q bucket, k bucket, head dim, causal, winner)
RECORDS = [
    (32, 128, 128, 64, False, "plain"),     # the kernel loses at k128
    (32, 512, 512, 64, False, "cuda"),      # and wins at k512, rows 32
    (256, 256, 256, 64, False, "cuda"),     # a smaller k at rows 256
    (256, 2048, 2048, 64, False, "cuda"),
    (32, 1024, 1024, 64, True, "cuda"),
    (32, 128, 128, 128, False, "plain"),
]


def _write_port_cache(path):
    recs = {at.attn_key(KIND, q, k, d, c, rows_bucket=r): {"impl": w}
            for r, q, k, d, c, w in RECORDS}
    recs[at.attn_key("other card", 128, 128, 64, False,
                     rows_bucket=32)] = {"impl": "cuda"}
    path.write_text(json.dumps(recs))


def _write_reference_cache(path):
    """The same verdicts in the reference's key format (no rows field;
    ``pallas``/``xla`` for ``cuda``/``plain``)."""
    recs = {}
    for r, q, k, d, c, w in RECORDS:
        key = jat.attn_key(KIND, q, k, d, c)
        if recs.get(key, {}).get("impl") != "pallas":
            recs[key] = {"impl": "pallas" if w == "cuda" else "xla"}
    path.write_text(json.dumps(recs))


@pytest.mark.parametrize("head_dim,causal,want", [
    (64, False, 256), (64, True, 1024), (128, False, None), (32, False, None)])
def test_measured_crossover_reads_the_k_field(tmp_path, monkeypatch,
                                              head_dim, causal, want):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    _write_port_cache(tmp_path / "port" / "attention.json")
    _write_reference_cache(tmp_path / "ref" / "attention.json")
    monkeypatch.setenv(at.AUTOTUNE_CACHE_ENV, str(tmp_path / "port"))
    monkeypatch.setenv(jat.AUTOTUNE_CACHE_ENV, str(tmp_path / "ref"))
    at.reset_memo()
    jat.reset_memo()
    try:
        got = at.measured_crossover(head_dim, causal, kind=KIND)
        assert got == want
        assert got == jat.measured_crossover(head_dim, causal, kind=KIND)
        # the reference's parse (field 3) would read the q bucket here
        assert at.measured_crossover(64, False, kind="other card") == 128
    finally:
        at.reset_memo()
        jat.reset_memo()


def test_measured_crossover_is_none_with_the_cache_off(monkeypatch):
    monkeypatch.setenv(at.AUTOTUNE_CACHE_ENV, "off")
    assert at.measured_crossover(64, False, kind=KIND) is None


# -- the accuracy acceptance helpers -----------------------------------------

def _evals(rng, n, flip):
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    base = labels + 0.1 * rng.random((n, 3)).astype(np.float32)
    other = base.copy()
    other[:flip] = np.roll(other[:flip], 1, axis=1)
    out = []
    for cls in (Evaluation, JEvaluation):
        a, b = cls(), cls()
        a.eval(labels, base)
        b.eval(labels, other)
        out.append((a, b))
    return out


@pytest.mark.parametrize("flip", [0, 3, 17])
def test_accuracy_delta_matches_the_reference(flip):
    (ta, tb), (ja, jb) = _evals(np.random.default_rng(flip), 64, flip)
    assert ta.accuracy_delta(tb) == ja.accuracy_delta(jb)
    assert ta.assert_accuracy_within(tb, 0.3) == \
        ja.assert_accuracy_within(jb, 0.3)


def test_assert_accuracy_within_raises_the_reference_message():
    (ta, tb), (ja, jb) = _evals(np.random.default_rng(1), 64, 17)
    with pytest.raises(AssertionError) as terr:
        ta.assert_accuracy_within(tb, 0.01, label="int8")
    with pytest.raises(AssertionError) as jerr:
        ja.assert_accuracy_within(jb, 0.01, label="int8")
    assert str(terr.value) == str(jerr.value)
    assert str(terr.value).startswith("int8 accuracy delta 0.2656")


# -- the examples ------------------------------------------------------------

def test_examples_import_no_jax():
    from test_torch_paged import assert_no_jax

    assert_no_jax("deeplearning4j_tpu_torch.examples",
                  *(f"deeplearning4j_tpu_torch.examples.{n}" for n in NAMES))
    for name in NAMES:
        src = (REPO / "deeplearning4j_tpu_torch" / "examples" /
               f"{name}.py").read_text()
        assert not re.search(r"\bimport jax\b|\bfrom jax\b|"
                             r"deeplearning4j_tpu(?!_torch)\b", src), name


def test_mnist_lenet(capsys, monkeypatch, tmp_path):
    import tempfile

    from deeplearning4j_tpu.models.lenet import lenet_conf

    monkeypatch.delenv("MNIST_DIR", raising=False)
    monkeypatch.setattr(tempfile, "mkdtemp", lambda prefix="": str(tmp_path))
    out = _run("mnist_lenet", capsys)
    acc = [float(m) for m in re.findall(r"^ Accuracy:\s+([0-9.]+)$", out,
                                        re.M)]
    assert len(acc) == 1 and acc[0] >= 0.90, out
    assert "train accuracy:" in out and "saved model to" in out
    assert (tmp_path / "lenet.json").read_text() == \
        lenet_conf(lr=0.05).to_json()
    import os
    assert "MNIST_DIR" not in os.environ


def test_word_embeddings(capsys):
    from deeplearning4j_tpu_torch.examples.word_embeddings import CORPUS

    out = _run("word_embeddings", capsys)
    vocab = {w for s in CORPUS for w in s.split()}
    for prefix in ("word2vec nearest(sea):", "word2vec[device] nearest(sea):"):
        (line,) = [ln for ln in out.splitlines() if ln.startswith(prefix)]
        near = ast.literal_eval(line[len(prefix):].strip())
        assert len(near) == 3 and all(w in vocab and w != "sea"
                                      for w, _ in near), line
    sims = re.search(r"sim\(cat,dog\) = (\S+)\s+sim\(cat,crowns\) = (\S+)",
                     out)
    assert sims and all(math.isfinite(float(s)) for s in sims.groups())
    norm = re.search(r"inferred vector norm: (\S+)", out)
    assert norm and math.isfinite(float(norm.group(1)))


def test_text_generation(capsys):
    out = _run("text_generation", capsys)
    first = float(re.search(r"first LM loss: (\S+)", out).group(1))
    final = float(re.search(r"final LM loss: (\S+)", out).group(1))
    assert math.isfinite(final) and final < first, out
    cont = re.search(r"gpt continuation: (.*)", out).group(1)
    text = ast.literal_eval(cont)
    assert text.startswith("the quick ") and len(text) == 10 + 40


def test_distributed_runtime_counts_equal_the_reference(capsys):
    from deeplearning4j_tpu.nlp.distributed import \
        word_count_distributed as jcount
    from deeplearning4j_tpu_torch.examples.distributed_runtime import \
        SENTENCES
    from deeplearning4j_tpu_torch.nlp.distributed import \
        word_count_distributed as tcount

    out = _run("distributed_runtime", capsys)
    ref = jcount(SENTENCES, n_workers=3)
    assert tcount(SENTENCES, n_workers=3) == ref
    top = sorted(ref.items(), key=lambda kv: -kv[1])[:3]
    assert f"word counts (3 workers): {top}" in out
    assert "with 25% injected crashes: identical result -> True" in out


def test_streaming_ingestion(capsys):
    out = _run("streaming_ingestion", capsys)
    accs = [float(a) for a in re.findall(r"accuracy ([0-9.]+)$", out, re.M)]
    assert len(accs) == 2 and min(accs) >= 0.85, out
    assert "(5 of 10 batch keys in shard 0/2)" in out


def _losses(out, pattern):
    return [float(x) for x in re.findall(pattern, out)]


def test_data_parallel_on_two_ranks(capsys):
    out = _run("data_parallel", capsys, "--ranks", "2")
    losses = _losses(out, r"step \d: loss (\S+)  \(batch sharded over 2 ")
    assert len(losses) == 5 and all(map(math.isfinite, losses))
    assert losses[-1] < losses[0], out


def test_data_parallel_defaults_to_one_rank_on_the_cpu(capsys):
    out = _run("data_parallel", capsys)
    losses = _losses(out, r"step \d: loss (\S+)  \(batch sharded over 1 ")
    assert len(losses) == 5 and losses[-1] < losses[0], out


def test_parallelism_axes_on_eight_ranks(capsys):
    out = _run("parallelism_axes", capsys)
    losses = _losses(out, r"(?:BERT|MoE-LM) loss (\S+)")
    assert len(losses) == 4 and all(map(math.isfinite, losses)), out
    for mesh in ("dp4 x tp2", "dp2 x pp4", "dp2 x sp4", "dp2 x ep4"):
        assert mesh in out
    assert "all parallelism axes OK" in out


def test_parallelism_axes_needs_eight_ranks():
    with pytest.raises(SystemExit, match="needs 8 ranks"):
        _example("parallelism_axes").main(["--device", "cpu", "--ranks", "4"])


@pytest.mark.parametrize("name", NAMES)
def test_examples_need_cuda_unless_asked_for_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        _example(name).main([])


def test_a_dead_rank_fails_the_example_naming_it():
    from test_torch_mesh import example_rank_dies

    t0 = time.monotonic()
    with pytest.raises(SystemExit) as err:
        examples.run_ranks("drill", example_rank_dies, 2,
                           torch.device("cpu"), deadline=60.0)
    # rank 0 is killed, or fails first when gloo sees its peer go
    assert "rank 1 died (exit code -9)" in str(err.value)
    assert time.monotonic() - t0 < 60.0


def test_a_hung_rank_fails_at_the_deadline():
    from test_torch_mesh import example_rank_hangs

    t0 = time.monotonic()
    with pytest.raises(SystemExit, match=r"ranks \[0, 1\] still running "
                                         r"after 15 s: killed"):
        examples.run_ranks("drill", example_rank_hangs, 2,
                           torch.device("cpu"), deadline=15.0)
    assert time.monotonic() - t0 < 40.0


def test_backend_choice(monkeypatch):
    """gloo on the CPU and for more ranks than cards, NCCL with one rank
    a card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert examples.backend_for(8, torch.device("cpu")) == "gloo"
    assert examples.backend_for(8, torch.device("cuda")) == "gloo"
    assert examples.backend_for(4, torch.device("cuda")) == "nccl"
    assert examples.backend_for(1, torch.device("cuda")) == "nccl"
