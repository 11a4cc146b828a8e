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
- the stubs: more than one process exits naming ROADMAP A7, ``generate``
  naming A4, and without a card the default ``--device cuda`` exits with
  one line.
Predictions across the packages are compared as classes (argmax), equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    multi = _cli("train", "--input", "iris.csv", "--conf", "conf.json",
                 "--output", "m.bin", "--device", "cpu", "--num-processes",
                 "2", cwd=iris, check=False)
    assert multi.returncode == 1 and "ROADMAP A7" in multi.stderr
    gen = _cli("generate", "--prompt", "hi", cwd=iris, check=False)
    assert gen.returncode == 1 and "ROADMAP A4" in gen.stderr
    if not torch.cuda.is_available():
        card = _cli("test", "--input", "iris.csv", "--model", "m.bin",
                    cwd=iris, check=False)
        assert card.returncode == 1 and "CUDA is not available" in \
            card.stderr and "Traceback" not in card.stderr


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
