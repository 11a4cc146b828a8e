"""The port's k-means, spatial trees, t-SNE and plotter against the JAX
package's, on the CPU.

After ``tests/test_clustering_plot.py`` and the plotter part of
``tests/test_cli_plot_utils.py``:
- k-means from the same initial centroids (the reference's ``_lloyd``
  against the port's ``lloyd``): labels and iteration counts equal,
  centroids and inertia within 1e-5 (relative for the inertia); the
  port's own k-means++ seeding recovers the blobs;
- KD-, VP-, Quad- and SpTree (copies): the same neighbours, centres of
  mass and forces;
- exact t-SNE from the same P and ``y0``, the port in float64, the
  reference in float32: P equal, the embedding within 1e-4 of the
  reference's scale and the last KL within rtol 1e-4.  The exact iteration is chaotic at the reference's default
  learning rate: a relative perturbation of 1e-7 in ``y0`` grows to about
  0.2 by iteration 20 in float64 alone (``tools/tsne_chaos_probe.py``),
  so at the defaults the packages are held over the first 6 iterations,
  and over 50 iterations at learning rates where the dynamics stay
  stable, with early exaggeration and the momentum switch inside the
  run;
- ``BarnesHutTsne.fit_transform`` at N = 60 from the same
  ``RandomState`` start within 1e-5 of the reference's scale, at a
  learning rate where its iteration is stable, over an exaggeration and
  a momentum switch;
- the plotter's histograms, filter grids and pages are written; without
  matplotlib the histograms fall back to ``.npz`` and the scalars page
  raises, as in the reference; the embedding page equals the
  reference's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.clustering import kmeans as jkm
from deeplearning4j_tpu.clustering import trees as jtrees
from deeplearning4j_tpu.plot import plotter as jplot
from deeplearning4j_tpu.plot import tsne as jts
from deeplearning4j_tpu_torch.clustering import kmeans as tkm
from deeplearning4j_tpu_torch.clustering import trees as ttrees
from deeplearning4j_tpu_torch.plot import plotter as tplot
from deeplearning4j_tpu_torch.plot import tsne as tts

from test_torch_paged import assert_no_jax

torch.set_num_threads(2)


def _blobs(seed=0, n_per=20, dim=5, spread=6.0):
    rng = np.random.RandomState(seed)
    centers = (0.0, spread, -spread)
    x = np.concatenate([rng.randn(n_per, dim) + c for c in centers])
    return x, np.repeat(np.arange(3), n_per)


def test_imports_no_jax():
    assert_no_jax("deeplearning4j_tpu_torch.clustering.kmeans",
                  "deeplearning4j_tpu_torch.clustering.trees",
                  "deeplearning4j_tpu_torch.plot.tsne",
                  "deeplearning4j_tpu_torch.plot.plotter")


# -- k-means ----------------------------------------------------------------

@pytest.mark.parametrize("k,rows,max_iter,tol", [
    (4, [0, 21, 42, 5], 100, 1e-4),
    (3, [0, 1, 2], 100, 1e-4),       # three seeds in one blob
    (5, [0, 1, 2, 3, 4], 2, 1e-4),   # cut by max_iter
    (3, [0, 21, 42], 100, 10.0),     # stopped by the tolerance
])
def test_kmeans_from_given_centroids_matches_jax(k, rows, max_iter, tol):
    x, _ = _blobs(n_per=21)
    x = x.astype(np.float32)
    init = x[rows]
    cj, lj, ij, nj = jkm._lloyd(jnp.asarray(x), jnp.asarray(init), k,
                                max_iter, tol)
    ct, lt, it_, nt = tkm.lloyd(torch.from_numpy(x), torch.from_numpy(init),
                                max_iter, tol)
    assert nt == int(nj)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
    np.testing.assert_allclose(float(it_), float(ij), rtol=1e-5)
    assert lt.dtype == torch.int64 and it_.dim() == 0


def test_kmeans_empty_cluster_keeps_its_centroid():
    x = np.asarray([[0.0, 0.0], [0.1, 0.0], [10.0, 10.0]], np.float32)
    init = np.asarray([[0.0, 0.0], [10.0, 10.0], [99.0, 99.0]], np.float32)
    cj, lj, _, nj = jkm._lloyd(jnp.asarray(x), jnp.asarray(init), 3, 10,
                               1e-4)
    ct, lt, _, nt = tkm.lloyd(torch.from_numpy(x), torch.from_numpy(init),
                              10, 1e-4)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    assert ct[2].tolist() == [99.0, 99.0] and nt == int(nj)


def test_kmeans_seeded_init_recovers_blobs():
    x, true = _blobs(n_per=30)
    km = tkm.KMeansClustering(tkm.KMeansConfig(n_clusters=3, seed=1),
                              device="cpu")
    labels = km.apply_to(x).numpy()
    for c in range(3):
        part = labels[true == c]
        assert (part == np.bincount(part).argmax()).mean() > 0.95
    assert km.inertia_ < np.var(x) * x.shape[0]
    assert km.centroids.shape == (3, 5)
    np.testing.assert_array_equal(km.predict(x).numpy(), labels)
    # the fit is Lloyd from the seeds it records
    c, lab, inertia, iters = tkm.lloyd(
        torch.from_numpy(x.astype(np.float32)), km.init_centroids_, 100,
        1e-4)
    assert iters == km.n_iter_ and float(inertia) == km.inertia_
    np.testing.assert_array_equal(lab.numpy(), labels)


@pytest.mark.parametrize("init", ["kmeans++", "random"])
def test_kmeans_seeding_picks_distinct_points(init):
    """With no Lloyd step the centroids are the seeds: distinct rows of
    the data, the same for the same seed."""
    x, _ = _blobs(n_per=30)
    x32 = x.astype(np.float32)
    seeds = []
    for _ in range(2):
        km = tkm.KMeansClustering(tkm.KMeansConfig(
            n_clusters=4, max_iterations=0, seed=5, init=init), device="cpu")
        km.fit(x)
        assert km.n_iter_ == 0
        seeds.append(km.centroids.numpy())
    np.testing.assert_array_equal(seeds[0], seeds[1])
    rows = [int(np.flatnonzero((x32 == c).all(1))[0]) for c in seeds[0]]
    assert len(set(rows)) == 4


# -- trees ------------------------------------------------------------------

def test_kd_and_vp_trees_equal():
    rng = np.random.RandomState(2)
    pts = rng.randn(120, 3)
    queries = rng.randn(6, 3)
    jk, tk = jtrees.KDTree.build(pts), ttrees.KDTree.build(pts)
    jv, tv = jtrees.VPTree(pts, seed=5), ttrees.VPTree(pts, seed=5)
    for q in queries:
        assert tk.knn(q, k=5) == jk.knn(q, k=5)
        assert tk.nearest(q) == jk.nearest(q)
        assert tv.knn(q, k=4) == jv.knn(q, k=4)
    assert tk.contains(pts[17]) and jk.contains(pts[17])
    for p in ([1.0, 2.0, 0.5], [3.0, 1.0, -1.0]):
        tk.insert(p)
        jk.insert(p)
    assert tk.nearest([3.1, 1.1, -1.0]) == jk.nearest([3.1, 1.1, -1.0])


@pytest.mark.parametrize("dims,theta", [(2, 0.0), (2, 0.5), (3, 0.5)])
def test_sptree_forces_equal(dims, theta):
    rng = np.random.RandomState(4)
    pts = rng.randn(80, dims)
    build_t = ttrees.QuadTree.build if dims == 2 else ttrees.SpTree.build
    build_j = jtrees.QuadTree.build if dims == 2 else jtrees.SpTree.build
    tt, jt = build_t(pts), build_j(pts)
    assert tt.mass == jt.mass == 80.0
    np.testing.assert_array_equal(tt.com, jt.com)
    for i in (0, 7, 33):
        ft, fj = np.zeros(dims), np.zeros(dims)
        assert tt.compute_non_edge_forces(pts[i], theta, ft) == \
            jt.compute_non_edge_forces(pts[i], theta, fj)
        np.testing.assert_array_equal(ft, fj)


# -- t-SNE ------------------------------------------------------------------

def test_joint_probabilities_equal():
    x, _ = _blobs()
    np.testing.assert_array_equal(tts.joint_probabilities(x, 10.0),
                                  jts.joint_probabilities(x, 10.0))
    d2 = np.square(x[:, None] - x[None]).sum(-1)
    np.testing.assert_array_equal(tts._binary_search_betas(d2, 10.0),
                                  jts._binary_search_betas(d2, 10.0))
    for n in (60, 1200):
        assert tts._resolve_lr(tts.TsneConfig(), n) == \
            jts._resolve_lr(jts.TsneConfig(), n) == max(n / 12, 50.0)


@pytest.mark.parametrize("kw,iters", [
    ({}, 6),                                            # the defaults
    ({"learning_rate": 2.0, "exaggeration_iters": 10,
      "momentum_switch_iter": 25}, 50),
    ({"learning_rate": 0.5, "exaggeration_iters": 0,
      "momentum_switch_iter": 25}, 50),
])
def test_exact_tsne_matches_jax(kw, iters):
    x, _ = _blobs()
    p = jts.joint_probabilities(x, 10.0)
    cfg = jts.TsneConfig(perplexity=10.0, max_iter=iters, **kw)
    y0 = (1e-4 * np.random.RandomState(7).randn(60, 2)).astype(np.float32)
    yj, klj = jts._exact_loop(
        jnp.asarray(p, jnp.float32), jnp.asarray(y0), iters,
        cfg.exaggeration_iters, cfg.momentum_switch_iter,
        jts._resolve_lr(cfg, 60), cfg.early_exaggeration,
        cfg.momentum_initial, cfg.momentum_final)
    ts = tts.Tsne(tts.TsneConfig(perplexity=10.0, max_iter=iters, **kw),
                  device="cpu")
    yt = ts.embed(p, y0)
    assert ts.kl_history_.dtype == torch.float64
    yj = np.asarray(yj)
    scale = np.abs(yj).max()
    assert scale > 0.1                       # the points really moved
    np.testing.assert_allclose(yt, yj, atol=1e-4 * scale)
    np.testing.assert_allclose(ts.kl_, float(klj), rtol=1e-4)
    kls = ts.kl_history_.numpy()
    assert kls.shape == (iters,) and float(kls[-1]) == ts.kl_
    ex = kw.get("exaggeration_iters", 100)
    if 0 < ex < iters:
        assert kls[ex - 1] > 5 * kls[ex]     # exaggerated P in the KL
    # the whole entry point: P and the loop, y0 given
    np.testing.assert_array_equal(ts.fit_transform(x, y0), yt)


def test_exact_tsne_default_start_and_blobs():
    x, true = _blobs(n_per=25)
    ts = tts.Tsne(tts.TsneConfig(perplexity=10.0, max_iter=300, seed=1),
                  device="cpu")
    y = ts.fit_transform(x)
    assert y.shape == (75, 2) and np.isfinite(y).all()
    np.testing.assert_array_equal(ts.initial_y(75), ts.initial_y(75))
    within = np.mean([np.linalg.norm(y[true == c] - y[true == c].mean(0),
                                     axis=1).mean() for c in range(3)])
    centers = np.stack([y[true == c].mean(0) for c in range(3)])
    between = np.mean([np.linalg.norm(centers[i] - centers[j])
                       for i in range(3) for j in range(i + 1, 3)])
    assert between > 3 * within
    kls = ts.kl_history_.numpy()
    assert kls[-1] < kls[100]


def test_barnes_hut_fit_transform_matches_jax():
    x, _ = _blobs()
    kw = dict(perplexity=10.0, max_iter=40, learning_rate=5.0,
              exaggeration_iters=10, momentum_switch_iter=20, seed=3)
    yj = jts.BarnesHutTsne(jts.TsneConfig(**kw)).fit_transform(x)
    yt = tts.BarnesHutTsne(tts.TsneConfig(**kw),
                           device="cpu").fit_transform(x)
    scale = np.abs(yj).max()
    assert scale > 1.0
    np.testing.assert_allclose(yt, yj, atol=1e-5 * scale)


# -- plotter ----------------------------------------------------------------

def _net():
    from deeplearning4j_tpu_torch.nn.conf import configuration as tconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (tconf.NeuralNetConfiguration.builder()
            .n_in(16).activation("tanh")
            .list(2).hidden_layer_sizes(8)
            .override(1, kind=tconf.LayerKind.OUTPUT, n_out=3,
                      activation="softmax", loss_function="mcxent")
            .pretrain(False).backward(True).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_plotter_outputs(tmp_path):
    from deeplearning4j_tpu_torch.runtime.metrics import ScalarsLogger

    net = _net()
    p1 = tplot.NeuralNetPlotter().plot_network_gradient(
        net, str(tmp_path / "weights.png"))
    p2 = tplot.NeuralNetPlotter().plot_activations(
        net, np.ones((8, 16), np.float32), str(tmp_path / "acts.png"))
    w = np.random.default_rng(0).normal(size=(16, 9)).astype(np.float32)
    p3 = tplot.FilterRenderer().render_filters(
        torch.from_numpy(w), str(tmp_path / "filters.png"))
    p4 = tplot.FilterRenderer().render_filters(
        np.random.default_rng(1).normal(size=(5, 5, 1, 12)),
        str(tmp_path / "conv.png"))
    sl = ScalarsLogger(str(tmp_path / "scalars.jsonl"))
    for i in range(5):
        sl.log(i, loss=1.0 / (i + 1))
    sl.close()
    p5 = tplot.render_scalars_html(str(tmp_path / "scalars.jsonl"),
                                   str(tmp_path / "scalars.png"))
    for p in (p1, p2, p3, p4, p5):
        assert p.endswith(".png") and os.path.getsize(p) > 0


def test_plotter_without_matplotlib(tmp_path, monkeypatch):
    """The reference's fallback: histograms and filter grids as numpy
    files, the scalars page refused."""
    monkeypatch.setattr(tplot, "_mpl", lambda: None)
    net = _net()
    p1 = tplot.NeuralNetPlotter().plot_network_gradient(
        net, str(tmp_path / "weights.png"))
    assert p1.endswith(".png.npz")
    with np.load(p1) as z:
        assert sorted(z.files) == sorted(
            f"layer{i}/{n}" for i, lp in enumerate(net.params) for n in lp)
        for i, lp in enumerate(net.params):
            for n, t in lp.items():
                np.testing.assert_array_equal(z[f"layer{i}/{n}"],
                                              t.numpy().ravel())
    p2 = tplot.FilterRenderer().render_filters(
        np.ones((16, 4), np.float32), str(tmp_path / "f.png"))
    assert p2.endswith(".png.npy") and np.load(p2).shape == (9, 9)
    from deeplearning4j_tpu_torch.runtime.metrics import ScalarsLogger

    sl = ScalarsLogger(str(tmp_path / "scalars.jsonl"))
    sl.log(0, loss=1.0)
    sl.close()
    with pytest.raises(RuntimeError):
        tplot.render_scalars_html(str(tmp_path / "scalars.jsonl"),
                                  str(tmp_path / "s.png"))


def test_embedding_page_equals_reference(tmp_path):
    words = ["cat", "dog", "fish"]
    pts = np.asarray([[0.0, 1.0], [1.0, 0.0], [0.5, 0.25]])
    pt = tplot.render_embedding_html(words, torch.from_numpy(pts),
                                     str(tmp_path / "t.html"))
    pj = jplot.render_embedding_html(words, pts, str(tmp_path / "j.html"))
    assert open(pt).read() == open(pj).read()
    with pytest.raises(ValueError):
        tplot.render_embedding_html(words, pts[:2], str(tmp_path / "x.html"))
