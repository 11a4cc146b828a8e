"""Real-image ingestion in the port: the native baseline-JPEG decode
against PIL, the port's ``utils/image`` and LFW fetcher against the JAX
reference's, and a JPEG corpus through the fetcher into training.

Tolerances: the native decode against PIL's ``convert("L")`` as the
reference's own test holds it (``tests/test_jpeg_lfw.py``: mean < 0.01,
max < 0.1 for colour, max < 0.02 for grayscale: the Y channel is
BT.601 luma up to RGB clamping on saturated chroma); the port's images
and fetcher arrays against the reference's: equal (the same decoder
source, the same resize and the same numpy arithmetic).
"""

import io
import os
import tarfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import fetchers as jfetch
from deeplearning4j_tpu.utils import image as jimage
from deeplearning4j_tpu_torch.datasets import fetchers as tfetch
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    LayerKind, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.runtime import native as tnative
from deeplearning4j_tpu_torch.utils import image as timage

torch.set_num_threads(2)


def _pil():
    return pytest.importorskip("PIL.Image")


def _jpeg_bytes(arr_u8, quality=92, subsampling=2, **kw):
    buf = io.BytesIO()
    _pil().fromarray(arr_u8).save(buf, "JPEG", quality=quality,
                                  subsampling=subsampling, **kw)
    return buf.getvalue()


def _face(seed, h=48, w=40):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 120 + 80 * np.exp(-((yy - h / 2) ** 2 + (xx - w / 2) ** 2)
                            / (2 * (w / 3) ** 2))
    img = img + rng.normal(0, 6, img.shape)
    rgb = np.stack([img, img * 0.9, img * 0.8], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _make_lfw_tree(root, n_people=3, n_imgs=4, h=48, w=40):
    for p in range(n_people):
        d = root / f"person_{p}"
        d.mkdir(parents=True)
        for i in range(n_imgs):
            arr = _face(100 + p * 10 + i, h, w)
            arr = np.clip(arr.astype(np.int32) + 25 * p, 0, 255).astype(
                np.uint8)
            (d / f"img_{i}.jpg").write_bytes(_jpeg_bytes(arr))


@pytest.fixture(scope="module", autouse=True)
def native_built():
    assert tnative.available(), tnative.build_error


def _pil_gray(data):
    return np.asarray(_pil().open(io.BytesIO(data)).convert("L"),
                      np.float32) / 255.0


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_native_jpeg_matches_pil(subsampling):
    data = _jpeg_bytes(_face(0), quality=90, subsampling=subsampling)
    out = tnative.decode_jpeg(data)
    assert out is not None and out.shape == (48, 40)
    ref = _pil_gray(data)
    assert np.abs(out - ref).mean() < 0.01
    assert np.abs(out - ref).max() < 0.1


def test_native_jpeg_grayscale():
    data = _jpeg_bytes(_face(1)[..., 0], quality=95)
    assert np.abs(tnative.decode_jpeg(data) - _pil_gray(data)).max() < 0.02


def test_progressive_jpeg_takes_the_pil_fallback():
    data = _jpeg_bytes(_face(3), progressive=True)
    assert tnative.decode_jpeg(data) is None
    out = timage.load_image_bytes(data, size=24)
    assert out.shape == (24, 24)
    np.testing.assert_array_equal(out, jimage.load_image_bytes(data,
                                                               size=24))


def test_load_image_equals_reference(tmp_path):
    p = tmp_path / "x.jpg"
    p.write_bytes(_jpeg_bytes(_face(4)))
    for size in (None, 32, 17):
        got = timage.load_image(str(p), size)
        np.testing.assert_array_equal(got, jimage.load_image(str(p), size))
    assert got.shape == (17, 17) and 0.0 <= got.min() and got.max() <= 1.0
    npy = tmp_path / "x.npy"
    np.save(npy, np.arange(12, dtype=np.float32).reshape(3, 4) * 20)
    np.testing.assert_array_equal(timage.load_image(str(npy)),
                                  jimage.load_image(str(npy)))


def test_lfw_fetcher_equals_reference_on_the_repo_corpus():
    """data/lfw (120 baseline JPEGs, 12 people) through find_lfw, the
    native decode and the resize: the reference's arrays exactly."""
    assert tfetch.find_lfw() == jfetch.find_lfw()
    t = tfetch.LFWDataFetcher(image_size=28)
    j = jfetch.LFWDataFetcher(image_size=28)
    assert not t.synthetic and t.names == j.names and len(t.names) == 12
    assert t.features.shape == (120, 784)
    np.testing.assert_array_equal(t.features, j.features)
    np.testing.assert_array_equal(t.labels, j.labels)


def test_lfw_directory_and_archive_tiers_equal_reference(tmp_path,
                                                         monkeypatch):
    _make_lfw_tree(tmp_path / "lfw")
    t = tfetch.LFWDataFetcher(image_dir=str(tmp_path / "lfw"), image_size=16)
    j = jfetch.LFWDataFetcher(image_dir=str(tmp_path / "lfw"), image_size=16)
    assert t.names == ["person_0", "person_1", "person_2"] == j.names
    np.testing.assert_array_equal(t.features, j.features)
    np.testing.assert_array_equal(t.labels, j.labels)
    tgz = tmp_path / "lfw.tgz"
    with tarfile.open(tgz, "w:gz") as tf:
        tf.add(tmp_path / "lfw", arcname="lfw")
    x, labels, names = timage.load_lfw_archive(str(tgz), size=16)
    jx, jlabels, jnames = jimage.load_lfw_archive(str(tgz), size=16)
    assert names == jnames and list(np.bincount(labels)) == [4, 4, 4]
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(x, t.features)      # same images
    monkeypatch.setenv("LFW_DIR", str(tmp_path))
    assert tfetch.find_lfw() == str(tgz) == jfetch.find_lfw()
    f = tfetch.LFWDataFetcher(image_size=16)
    assert not f.synthetic and len(f.names) == 3


def test_lfw_synthetic_fallback_equals_reference(tmp_path):
    missing = str(tmp_path / "no-such-dir")
    t = tfetch.LFWDataFetcher(image_dir=missing, image_size=20, n=40)
    j = jfetch.LFWDataFetcher(image_dir=missing, image_size=20, n=40)
    assert t.synthetic and j.synthetic and t.names == j.names
    np.testing.assert_array_equal(t.features, j.features)
    np.testing.assert_array_equal(t.labels, j.labels)


def _fit(features, labels, hidden, lr, act, epochs):
    f_ds = tfetch.ArrayFetcher(features, labels)
    f_ds.fetch(len(features))
    ds = f_ds.next().normalize_zero_mean_unit_variance()
    conf = (NeuralNetConfiguration.builder()
            .n_in(features.shape[1]).lr(lr).activation(act).list(2)
            .hidden_layer_sizes(hidden)
            .override(1, kind=LayerKind.OUTPUT, n_out=labels.shape[1],
                      activation="softmax", loss_function="mcxent")
            .pretrain(False).backward(True).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.fit_backprop([ds], num_epochs=epochs)
    return net.evaluate(ds).accuracy()


def test_lfw_jpg_directory_trains_end_to_end(tmp_path):
    _make_lfw_tree(tmp_path / "lfw")
    f = tfetch.LFWDataFetcher(image_dir=str(tmp_path / "lfw"), image_size=16)
    assert f.features.shape == (12, 256) and f.labels.shape == (12, 3)
    assert _fit(f.features, f.labels, 32, 0.1, "tanh", 100) > 0.8


def test_real_lfw_accuracy_tier():
    """The reference's accuracy tier (tests/test_jpeg_lfw.py:160-193) on
    the port: data/lfw, 784-48-12 relu, lr 0.05, 300 epochs."""
    f = tfetch.LFWDataFetcher(image_size=28)
    assert not f.synthetic
    assert _fit(f.features, f.labels, 48, 0.05, "relu", 300) > 0.8
