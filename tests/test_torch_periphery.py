"""The port's periphery against the JAX package's, on the CPU: the math
and string utilities, the config registry, the provisioning scripts, and
the generated local launch script forming a real two-process cluster of
the port's ``cli.py train``.

After ``tests/test_cli_plot_utils.py`` (utils) and ``tests/test_cloud.py``
(provision, registry).  The modules are copies; each result is equal to
the reference's.  The reference's local-simulation test brings up
``jax.distributed`` and is flaky (two simulated hosts share one stdout);
the port's runs two ``cli.py train --device cpu`` processes over gloo
from the same script, with a timeout of its own, and reads each
process's join line.
"""

import os
import shlex
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu.cloud import provision as jprov
from deeplearning4j_tpu.cloud import registry as jreg
from deeplearning4j_tpu.utils import math_utils as jmu
from deeplearning4j_tpu.utils import strings as jstr
from deeplearning4j_tpu_torch.cloud import provision as tprov
from deeplearning4j_tpu_torch.cloud import registry as treg
from deeplearning4j_tpu_torch.utils import math_utils as tmu
from deeplearning4j_tpu_torch.utils import strings as tstr

from test_torch_paged import assert_no_jax

REPO = Path(__file__).resolve().parents[1]


def test_imports_no_jax():
    assert_no_jax("deeplearning4j_tpu_torch.utils.math_utils",
                  "deeplearning4j_tpu_torch.utils.strings",
                  "deeplearning4j_tpu_torch.cloud",
                  "deeplearning4j_tpu_torch.cloud.provision",
                  "deeplearning4j_tpu_torch.cloud.registry",
                  "deeplearning4j_tpu_torch.clustering",
                  "deeplearning4j_tpu_torch.plot")


def test_cloud_package_exports():
    from deeplearning4j_tpu_torch import cloud

    assert cloud.TpuPodSpec is tprov.TpuPodSpec
    assert cloud.ConfigRegistry is treg.ConfigRegistry
    for name in ("render_create_script", "render_launch_script",
                 "render_teardown_script", "ArtifactStore",
                 "LocalArtifactStore"):
        assert hasattr(cloud, name)


# -- utils ------------------------------------------------------------------

def test_math_utils_equal():
    rng = np.random.RandomState(0)
    a, b = rng.randn(7), rng.randn(7)
    for name, args in [
            ("sigmoid", (a,)), ("entropy", ([0.5, 0.25, 0.25],)),
            ("entropy", ([1.0],)),
            ("information_gain", ([0.5, 0.5], [[1.0], [0.3, 0.7]],
                                  [0.4, 0.6])),
            ("euclidean_distance", (a, b)), ("manhattan_distance", (a, b)),
            ("cosine_similarity", (a, b)), ("correlation", (a, b)),
            ("normalize", (a,)), ("normalize", (a, -1.0, 2.0)),
            ("next_power_of_2", (17,)), ("next_power_of_2", (16,)),
            ("round_to_nearest", (7.3, 0.5)), ("clamp", (3.0, 0.0, 1.0)),
            ("log2", (10.0,)), ("summary_stats", ([1, 2, 3, 4],)),
            ("moving_average", (rng.randn(2, 9), 3))]:
        np.testing.assert_array_equal(getattr(tmu, name)(*args),
                                      getattr(jmu, name)(*args), name)
    x = np.arange(16, dtype=np.float32).reshape(4, 4)
    for rot in (False, True):
        tw = tmu.moving_window_matrix(x, 2, 2, add_rotate=rot)
        jw = jmu.moving_window_matrix(x, 2, 2, add_rotate=rot)
        assert len(tw) == len(jw)
        for u, v in zip(tw, jw):
            np.testing.assert_array_equal(u, v)
    s, r = tmu.SummaryStatistics.of(a), jmu.SummaryStatistics.of(a)
    assert str(s) == str(r) and s.n == r.n == 7


def test_strings_equal():
    rows = ["John  Smith", "smith, john", "John Smith", "Alice Wu",
            "alice   wu!", "Bob"]
    ti, ji = tstr.Index(), jstr.Index()
    assert [ti.add(w) for w in rows] == [ji.add(w) for w in rows]
    assert list(ti) == list(ji) and len(ti) == len(ji)
    for w in rows + ["nobody"]:
        assert tstr.fingerprint(w) == jstr.fingerprint(w)
        assert ti.index_of(w) == ji.index_of(w)
    tc, jc = tstr.StringCluster(rows), jstr.StringCluster(rows)
    assert tc.clusters() == jc.clusters()
    assert tc.duplicates() == jc.duplicates()
    assert [tc.canonical(w) for w in rows] == [jc.canonical(w) for w in rows]
    lines = ["a,John Smith,1", "b,smith  JOHN,2", "c,Alice,3", "d,alice,4"]
    tg, jg = tstr.StringGrid.from_lines(lines), jstr.StringGrid.from_lines(
        lines)
    assert tg.dedup_column(1).to_lines() == jg.dedup_column(1).to_lines()
    assert tg.filter_rows_by_column(0, {"a", "c"}).rows == \
        jg.filter_rows_by_column(0, {"a", "c"}).rows
    assert tg.cluster_column(1).clusters() == jg.cluster_column(1).clusters()
    assert tg.get_column(2) == jg.get_column(2)
    assert tg.to_lines() == jg.to_lines() == lines


# -- registry and provisioning ---------------------------------------------

def test_registry_equal(tmp_path):
    conf = {"lr": 0.1, "layers": [4, 3], "name": "x"}
    t, j = treg.ConfigRegistry(str(tmp_path / "t")), \
        jreg.ConfigRegistry(str(tmp_path / "j"))
    for reg in (t, j):
        reg.register("jobs/a/conf", conf)
        reg.register("/jobs/b/conf/", {"k": 1})
        reg.register("top", {})
    assert t.keys() == j.keys() == ["jobs/a/conf", "jobs/b/conf", "top"]
    assert t.keys("jobs/a") == j.keys("jobs/a")
    assert t.retrieve("jobs/a/conf") == j.retrieve("jobs/a/conf") == conf
    assert (tmp_path / "t" / "jobs" / "a" / "conf.json").read_text() == \
        (tmp_path / "j" / "jobs" / "a" / "conf.json").read_text()
    t.delete("top")
    assert not t.exists("top") and t.exists("jobs/b/conf")
    with pytest.raises(KeyError):
        t.retrieve("top")
    # the other package reads what this one wrote
    assert jreg.ConfigRegistry(str(tmp_path / "t")).retrieve(
        "jobs/a/conf") == conf
    for bad in ("", "/", "..", "./.."):
        with pytest.raises(ValueError):
            t.register(bad, {})


SPECS = [dict(), dict(name="pod", accelerator_type="v5litepod-64",
                      zone="europe-west4-a", project="proj",
                      network="net", preemptible=True,
                      env={"A": "1", "B": "two words"}),
         dict(accelerator_type="weird")]


@pytest.mark.parametrize("kw", SPECS)
def test_provision_scripts_equal(kw, tmp_path):
    ts, js = tprov.TpuPodSpec(**kw), jprov.TpuPodSpec(**kw)
    assert ts.n_hosts == js.n_hosts
    cmd = "python -m train --epochs 2"
    assert tprov.render_create_script(ts) == jprov.render_create_script(js)
    assert tprov.render_launch_script(ts, cmd, 9000) == \
        jprov.render_launch_script(js, cmd, 9000)
    assert tprov.render_local_launch_script(ts, cmd, 9000) == \
        jprov.render_local_launch_script(js, cmd, 9000)
    assert tprov.render_teardown_script(ts) == \
        jprov.render_teardown_script(js)
    tp = tprov.write_cluster_scripts(ts, cmd, str(tmp_path / "t"))
    jp = jprov.write_cluster_scripts(js, cmd, str(tmp_path / "j"))
    assert [os.path.basename(p) for p in tp] == \
        [os.path.basename(p) for p in jp]
    for a, b in zip(tp, jp):
        assert Path(a).read_text() == Path(b).read_text()
        assert os.access(a, os.X_OK)


def test_provision_trio_is_what_cli_reads():
    from deeplearning4j_tpu_torch.parallel import multihost

    assert (tprov.ENV_COORDINATOR, tprov.ENV_NUM_PROCESSES,
            tprov.ENV_PROCESS_ID) == multihost.ENV_TRIO


def test_local_sim_launch_script_forms_real_cluster(tmp_path):
    """The generated localhost launch script runs the port's ``cli.py
    train`` once per simulated host; its exported trio joins both into
    one gloo group, they train on a data mesh of both and commit cluster
    snapshots."""
    from deeplearning4j_tpu_torch.datasets.fetchers import IrisDataFetcher
    from deeplearning4j_tpu_torch.nn.conf import configuration as tconf

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
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    train = (f"exec {sys.executable} -m deeplearning4j_tpu_torch.cli train "
             "--input iris.csv --conf conf.json --batch 30 --epochs 2 "
             "--device cpu --checkpoint-dir ck --checkpoint-every 4 "
             "--output m${DL4J_TPU_PROCESS_ID}.bin")
    spec = tprov.TpuPodSpec(accelerator_type="v5litepod-16")  # 2 hosts
    sh = tmp_path / "launch_local_sim.sh"
    sh.write_text(tprov.render_local_launch_script(
        spec, f"sh -c {shlex.quote(train)}", coordinator_port=port))
    sh.chmod(0o755)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([str(sh)], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    for k in (0, 1):
        assert f"joined cluster: process {k} of 2 at 127.0.0.1:{port}" \
            in r.stdout, r.stdout
        assert (tmp_path / f"m{k}.bin").exists()
    assert r.stdout.count("train accuracy:") == 2
    assert sorted((tmp_path / "ck").glob("ckpt_*.npz.manifest.json"))
