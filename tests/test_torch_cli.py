"""The port's command line (``deeplearning4j_tpu_torch/cli.py``) on the CPU.

Each command runs as a user runs it, ``python -m
deeplearning4j_tpu_torch.cli ... --device cpu`` in a subprocess, on an
Iris CSV written to ``tmp_path``:
- ``train`` (through ``fit``), ``test`` and ``predict``; the model file
  loads in the JAX package's ``MultiLayerNetwork.from_bytes`` and
  predicts the same classes, and a JAX model file loads in the port's
  ``test``;
- ``train --checkpoint-dir`` (``prepare_resilient_fit`` ->
  ``ResilientFit``) runs to its end, the same command refuses the
  populated directory with a one-line exit, ``--resume`` continues, and
  ``--resume`` refuses an empty directory;
- ``telemetry`` summarizes a ``train --telemetry`` journal;
- ``generate --device cpu`` trains a char-GPT for a few steps, saves it
  and serves two prompts through the router; its npz loads in the JAX
  package's ``_gpt_load_npz`` and a JAX-written npz in the port's
  ``generate --params``, and both packages give the same greedy text
  (fp32);
- ``train`` over two processes (``--coordinator file://...
  --num-processes 2 --process-id k``): both join one gloo group, train
  through ``ResilientFit`` on the data mesh and commit cluster snapshots;
  without ``--checkpoint-dir`` more than one process exits with the
  reference's message, and without a card the default ``--device cuda``
  exits with one line.
Predictions across the packages are compared as classes (argmax), equal.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import cli as jcli
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.datasets.fetchers import IrisDataFetcher
from deeplearning4j_tpu_torch.nn.conf import configuration as tconf

REPO = Path(__file__).resolve().parents[1]


def _cli(*args, cwd, check=True):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch.cli",
                          *args], cwd=str(cwd), env=env, capture_output=True,
                         text=True, timeout=300)
    if check:
        assert res.returncode == 0, res.stdout + res.stderr
    return res


@pytest.fixture
def iris(tmp_path):
    f = IrisDataFetcher()
    np.savetxt(tmp_path / "iris.csv",
               np.c_[f.features, f.labels.argmax(1)], delimiter=",",
               fmt="%.5f")
    conf = (tconf.NeuralNetConfiguration.builder()
            .n_in(4).lr(0.1).num_iterations(20).use_adagrad(False)
            .activation("tanh").compute_dtype("float32")
            .list(2).hidden_layer_sizes(8)
            .override(1, kind=tconf.LayerKind.OUTPUT, n_out=3,
                      activation="softmax", loss_function="mcxent")
            .pretrain(False).backward(True).build())
    (tmp_path / "conf.json").write_text(conf.to_json())
    return tmp_path


def test_train_test_predict_and_models_cross_packages(iris):
    out = _cli("train", "--input", "iris.csv", "--conf", "conf.json",
               "--output", "m.bin", "--epochs", "5", "--batch", "30",
               "--device", "cpu", cwd=iris).stdout
    assert "saved model to m.bin" in out and "train accuracy:" in out
    assert "Accuracy" in _cli("test", "--input", "iris.csv", "--model",
                              "m.bin", "--device", "cpu", cwd=iris).stdout
    _cli("predict", "--input", "iris.csv", "--model", "m.bin", "--output",
         "p.txt", "--device", "cpu", cwd=iris)
    preds = np.loadtxt(iris / "p.txt", dtype=np.int64)
    x = np.loadtxt(iris / "iris.csv", delimiter=",", dtype=np.float32)[:, :4]
    jnet = JNet.from_bytes((iris / "m.bin").read_bytes())
    jnet._resolve_fit_mesh = lambda mesh, min_batch: None
    np.testing.assert_array_equal(preds, np.asarray(jnet.predict(
        jnp.asarray(x))))
    # the reverse: a JAX-trained model file through the port's test
    jnet.fit_backprop(
        [__import__("deeplearning4j_tpu.datasets.dataset", fromlist=["x"])
         .DataSet(jnp.asarray(x), jnp.eye(3)[np.asarray(preds)])], mesh=None)
    (iris / "j.bin").write_bytes(jnet.to_bytes())
    _cli("predict", "--input", "iris.csv", "--model", "j.bin", "--output",
         "pj.txt", "--device", "cpu", cwd=iris)
    np.testing.assert_array_equal(
        np.loadtxt(iris / "pj.txt", dtype=np.int64),
        np.asarray(jnet.predict(jnp.asarray(x))))


def test_checkpoint_dir_resume_and_refusals(iris):
    base = ("train", "--input", "iris.csv", "--conf", "conf.json",
            "--output", "m.bin", "--batch", "30", "--device", "cpu",
            "--checkpoint-dir", "ck", "--checkpoint-every", "2")
    out = _cli(*base, cwd=iris).stdout
    assert "train accuracy:" in out
    assert sorted(os.listdir(iris / "ck"))
    again = _cli(*base, cwd=iris, check=False)
    assert again.returncode == 1 and "already holds snapshots" in \
        again.stderr and "Traceback" not in again.stderr
    resumed = _cli(*base, "--resume", "--epochs", "2", cwd=iris).stdout
    assert "train accuracy:" in resumed
    empty = _cli(*base[:-4], "--checkpoint-dir", "none", "--resume",
                 cwd=iris, check=False)
    assert empty.returncode == 1 and "no checkpoints found" in empty.stderr
    lone = _cli(*base[:-4], "--resume", cwd=iris, check=False)
    assert lone.returncode == 1 and "require --checkpoint-dir" in lone.stderr


def test_telemetry_journal_summary(iris):
    out = _cli("train", "--input", "iris.csv", "--conf", "conf.json",
               "--output", "m.bin", "--batch", "50", "--device", "cpu",
               "--telemetry", "tel", cwd=iris).stdout
    journal = [ln.split()[2] for ln in out.splitlines()
               if ln.startswith("telemetry journal:")][0]
    summary = _cli("telemetry", "--journal", journal, "--export-trace",
                   "t.json", cwd=iris).stdout
    assert "multilayer.finetune" in summary and "multilayer.fit" in summary
    assert (iris / "t.json").exists()


def test_stubs_name_their_roadmap_items(iris):
    """Multi-process ``train`` (ROADMAP A7, now ported) keeps the
    reference's refusals: without ``--checkpoint-dir`` more than one
    process exits with its message, and a partial launcher trio names
    both spellings; without a card the default ``--device cuda`` exits
    with one line."""
    multi = _cli("train", "--input", "iris.csv", "--conf", "conf.json",
                 "--output", "m.bin", "--device", "cpu", "--num-processes",
                 "2", "--process-id", "0", "--coordinator",
                 f"file://{iris}/rdv", cwd=iris, check=False)
    assert multi.returncode == 1 and "multi-process training requires " \
        "--checkpoint-dir" in multi.stderr
    assert "Traceback" not in multi.stderr
    partial = _cli("train", "--input", "iris.csv", "--conf", "conf.json",
                   "--output", "m.bin", "--device", "cpu", "--num-processes",
                   "2", cwd=iris, check=False)
    assert partial.returncode == 1 and "partial cluster wiring" in \
        partial.stderr and "DL4J_TPU_PROCESS_ID" in partial.stderr
    if not torch.cuda.is_available():
        card = _cli("test", "--input", "iris.csv", "--model", "m.bin",
                    cwd=iris, check=False)
        assert card.returncode == 1 and "CUDA is not available" in \
            card.stderr and "Traceback" not in card.stderr


def test_generate_trains_saves_and_serves(tmp_path):
    out = _cli("generate", "--device", "cpu", "--train-steps", "5",
               "--save-params", "g.npz", "--prompt", "the quick ",
               "--prompt", "a lazy ", "--max-tokens", "12",
               "--replicas", "1", cwd=tmp_path).stdout
    assert "final LM loss" in out and "saved params to g.npz" in out
    lines = [ln for ln in out.splitlines() if " -> " in ln]
    assert len(lines) == 2 and lines[0].startswith("'the quick ' -> ")
    assert "compile_delta 0" in out
    cfg, params, chars = jcli._gpt_load_npz(str(tmp_path / "g.npz"))
    assert cfg.vocab_size == len(chars) and params["blocks"]["wq"].ndim == 4


def _greedy_text(cfg, params, chars, prompt, n):
    """JAX's greedy continuation of ``prompt`` (the reference's
    ``generate``)."""
    from deeplearning4j_tpu.models import gpt as jgpt

    stoi = {c: i for i, c in enumerate(chars)}
    ids = np.asarray([[stoi.get(c, 0) for c in prompt]], np.int32)
    out = jgpt.generate(cfg, jax.tree.map(jnp.asarray, params), ids, n,
                        jax.random.key(0), temperature=0.0)
    return prompt + "".join(chars[t] for t in np.asarray(out)[0])


def test_generate_npz_crosses_packages(tmp_path):
    """An fp32 char-GPT saved by either package loads in the other, and
    the port's ``generate --params --temperature 0`` prints JAX's greedy
    text for it."""
    import dataclasses

    from deeplearning4j_tpu.models.transformer import TransformerConfig
    from deeplearning4j_tpu_torch import cli as tcli
    from deeplearning4j_tpu_torch.models.transformer import \
        TransformerConfig as TCfg
    from test_torch_decode import numpy_params

    chars = " abcdefghijklmnopqrstuvwxyz."
    kw = dict(vocab_size=len(chars), max_len=64, hidden=32, n_layers=2,
              n_heads=2, ffn_dim=64, dropout=0.0, compute_dtype="float32",
              causal=True, type_vocab_size=1)
    tree = numpy_params(TCfg(**kw), 5)
    prompts = ["the quick ", "a lazy dog"]
    for writer, name in ((tcli._gpt_save_npz, "port.npz"),
                         (jcli._gpt_save_npz, "jax.npz")):
        cfg = (TCfg if writer is tcli._gpt_save_npz
               else TransformerConfig)(**kw)
        writer(str(tmp_path / name), cfg, tree, chars)
        jcfg, jparams, jchars = jcli._gpt_load_npz(str(tmp_path / name))
        tcfg, tparams, tchars = tcli._gpt_load_npz(str(tmp_path / name))
        assert jchars == tchars == chars
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert dataclasses.asdict(tcfg).items() >= kw.items()
        for grp in tree:
            for leaf in tree[grp]:
                np.testing.assert_array_equal(tparams[grp][leaf],
                                              tree[grp][leaf])
                np.testing.assert_array_equal(jparams[grp][leaf],
                                              tree[grp][leaf])
        args = ["generate", "--device", "cpu", "--params", name,
                "--temperature", "0", "--max-tokens", "16"]
        for p in prompts:
            args += ["--prompt", p]
        out = _cli(*args, cwd=tmp_path).stdout
        got = [ln.split(" -> ", 1)[1] for ln in out.splitlines()
               if " -> " in ln]
        assert got == [repr(_greedy_text(jcfg, jparams, chars, p, 16))
                       for p in prompts], name


def test_cli_imports_no_jax():
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch.cli as c\n"
            "c.build_parser()\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeplearning4j_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), \
        res.stdout + res.stderr


def test_two_process_train_commits_cluster_snapshots(iris):
    """Two ``train`` processes join one group (the line "joined cluster:
    process k of 2"), train on the data mesh of both and commit cluster
    snapshots whose manifest names both members; each writes its model
    file."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "train",
         "--input", "iris.csv", "--conf", "conf.json", "--output",
         f"m{k}.bin", "--batch", "30", "--device", "cpu", "--epochs", "2",
         "--checkpoint-dir", "ck", "--checkpoint-every", "4",
         "--coordinator", f"file://{iris}/rdv", "--num-processes", "2",
         "--process-id", str(k)], cwd=str(iris), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for k, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        assert f"joined cluster: process {k} of 2" in out
        assert "train accuracy:" in out and (iris / f"m{k}.bin").exists()
    manifests = sorted((iris / "ck").glob("ckpt_*.npz.manifest.json"))
    assert manifests
    man = json.loads(manifests[-1].read_text())
    assert man["cluster"] == {"layout": "replicated", "members": [0, 1],
                              "coordinator": 0}
