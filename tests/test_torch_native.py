"""The port's native host library (``runtime/native.py``) against the
JAX reference's binding of the same C++ source.

The port builds ``native/dl4j_native.cpp`` into ``build/native/``; the
reference builds it into ``native/``.  Both are the same code, so every
output is held BIT-equal: idx, CSV, PNM and JPEG decodes, the resize,
and the shuffled batch stream of ``NativeBatcher`` for one seed.  The
Python paths (no library) are held to the native ones as the
reference's tests hold them (PNM within atol 1e-6).
"""

import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import mnist as jmnist
from deeplearning4j_tpu.runtime import native as jnative
from deeplearning4j_tpu_torch.datasets import mnist as tmnist
from deeplearning4j_tpu_torch.runtime import native as tnative
from deeplearning4j_tpu_torch.utils import image as timage

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def libs():
    """Both packages' libraries; the port's must build here (g++)."""
    assert tnative.available(), tnative.build_error
    if not jnative.available():
        pytest.skip("the reference's native library did not build")
    return jnative, tnative


def _face_jpeg(seed, subsampling=2, quality=90, **kw):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:48, 0:40].astype(np.float32)
    img = 120 + 80 * np.exp(-((yy - 24) ** 2 + (xx - 20) ** 2) / 200.0)
    img = img + rng.normal(0, 6, img.shape)
    rgb = np.clip(np.stack([img, img * 0.9, img * 0.8], -1), 0,
                  255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=quality,
                              subsampling=subsampling, **kw)
    return buf.getvalue()


def test_library_builds_under_build_native_not_native():
    path = tnative.library_path()
    assert path.parent == tnative.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "native")
    assert tnative.available() and path.exists()
    # the reference's directory holds only what git tracks and the
    # reference's own library
    allowed = {"Makefile", "dl4j_native.cpp", "libdl4j_tpu_native.so"}
    assert set(os.listdir(os.path.join(REPO, "native"))) <= allowed


def test_idx_parse_bit_equal_to_reference(libs, tmp_path):
    j, t = libs
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (17, 5, 9), dtype=np.uint8)
    labels = rng.integers(0, 10, 17).astype(np.uint8)
    ip, lp = str(tmp_path / "img.idx3"), str(tmp_path / "lab.idx1")
    tmnist.write_idx_images(ip, images)
    tmnist.write_idx_labels(lp, labels)
    for fn in ("parse_idx_images", "parse_idx_images_u8"):
        np.testing.assert_array_equal(getattr(t, fn)(ip),
                                      getattr(j, fn)(ip))
    np.testing.assert_array_equal(t.parse_idx_labels(lp),
                                  j.parse_idx_labels(lp))
    np.testing.assert_array_equal(t.parse_idx_images_u8(ip), images)
    bad = tmp_path / "bogus.bin"
    bad.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError):
        t.parse_idx_images(str(bad))


def test_mnist_loader_takes_the_native_reader(libs, tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (16, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 16).astype(np.uint8)
    tmnist.write_idx_images(str(tmp_path / "train-images-idx3-ubyte"),
                            images)
    tmnist.write_idx_labels(str(tmp_path / "train-labels-idx1-ubyte"),
                            labels)
    calls = []
    real = tnative.parse_idx_images_u8
    monkeypatch.setattr(tnative, "parse_idx_images_u8",
                        lambda p: calls.append(p) or real(p))
    gi, gl = tmnist.load_mnist(str(tmp_path), train=True)
    ji, jl = jmnist.load_mnist(str(tmp_path), train=True)
    assert calls, "load_mnist did not take the native reader"
    np.testing.assert_array_equal(gi, ji)
    np.testing.assert_array_equal(gl, jl)
    np.testing.assert_array_equal(gi, images)


def test_csv_parse_bit_equal_to_reference(libs, tmp_path):
    j, t = libs
    rng = np.random.default_rng(1)
    data = rng.normal(size=(50, 7)).astype(np.float32)
    p = str(tmp_path / "d.csv")
    np.savetxt(p, data, delimiter=",", header="a,b,c,d,e,f,g")
    np.testing.assert_array_equal(t.parse_csv(p, skip_header=1),
                                  j.parse_csv(p, skip_header=1))
    np.testing.assert_allclose(t.parse_csv(p, skip_header=1), data,
                               rtol=1e-5, atol=1e-6)
    ragged = tmp_path / "bad.csv"
    ragged.write_text("1,2,3\n4,5\n")
    with pytest.raises(ValueError):
        t.parse_csv(str(ragged))


def test_pnm_decode_bit_equal_and_python_fallback(libs, tmp_path,
                                                  monkeypatch):
    j, t = libs
    rng = np.random.RandomState(0)
    g = rng.randint(0, 256, (5, 7), np.uint8)
    rgb = rng.randint(0, 256, (4, 6, 3), np.uint8)
    cases = {
        "P5": b"P5\n# comment\n7 5\n255\n" + g.tobytes(),
        "P6": b"P6 6 4 255\n" + rgb.tobytes(),
        "P2": ("P2\n7 5\n255\n"
               + " ".join(str(v) for v in g.ravel())).encode(),
        "P3": ("P3\n6 4\n255\n"
               + " ".join(str(v) for v in rgb.ravel())).encode(),
    }
    for kind, blob in cases.items():
        got = t.decode_pnm(blob)
        assert got is not None, kind
        np.testing.assert_array_equal(got, j.decode_pnm(blob), err_msg=kind)
    assert t.decode_pnm(b"P5 1000000 1000000 255\n") is None
    assert t.decode_pnm(b"P5\n2 2\n65535\n" + bytes(8)) is None
    p = tmp_path / "x.pgm"
    p.write_bytes(cases["P5"])
    with_native = timage.load_image(str(p))
    monkeypatch.setattr(tnative, "decode_pnm", lambda data: None)
    monkeypatch.setattr(tnative, "resize_nearest", lambda img, s: None)
    np.testing.assert_allclose(timage.load_image(str(p)), with_native,
                               atol=1e-6)
    assert timage.load_image(str(p), size=3).shape == (3, 3)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_jpeg_decode_bit_equal_to_reference(libs, subsampling):
    j, t = libs
    data = _face_jpeg(subsampling, subsampling=subsampling)
    got = t.decode_jpeg(data)
    assert got is not None and got.shape == (48, 40)
    np.testing.assert_array_equal(got, j.decode_jpeg(data))
    assert t.decode_jpeg(_face_jpeg(3, progressive=True)) is None
    assert t.decode_jpeg(b"\xff\xd8" + bytes(64)) is None


def test_jpeg_decoder_survives_hostile_bytes(libs):
    """Truncated JPEGs decode as the reference's build of the same source
    does (or fail in both); bit-flipped ones fail cleanly (None) or
    decode to finite values in [0, 1], never crash."""
    j, t = libs
    data = _face_jpeg(7)
    for cut in range(2, len(data), max(1, len(data) // 60)):
        got, ref = t.decode_jpeg(data[:cut]), j.decode_jpeg(data[:cut])
        assert (got is None) == (ref is None)
        if got is not None:
            np.testing.assert_array_equal(got, ref)
    rng = np.random.RandomState(1)
    for _ in range(300):
        d = bytearray(data)
        for _ in range(rng.randint(1, 8)):
            d[rng.randint(2, len(d))] ^= 1 << rng.randint(8)
        got = t.decode_jpeg(bytes(d))
        if got is not None:
            assert np.isfinite(got).all()
            assert 0.0 <= got.min() and got.max() <= 1.0


def test_jpeg_scan_naming_a_missing_huffman_table_is_refused(libs):
    """A scan header whose table selector is above 3: the C decoder
    would index past its four tables (the reference's wrapper crashes
    the process on this input), the port's wrapper refuses it."""
    _, t = libs
    data = bytearray(_face_jpeg(7))
    i = 2
    while data[i + 1] != 0xDA:                   # walk to SOS
        i += 2 + ((data[i + 2] << 8) | data[i + 3])
    sel = i + 6                                  # first component's Td/Ta
    assert t.decode_jpeg(bytes(data)) is not None
    for bad in (0x15, 0x51, 0xFF):
        d = bytearray(data)
        d[sel] = bad
        assert t.decode_jpeg(bytes(d)) is None


def test_resize_bit_equal_to_reference_and_python(libs):
    j, t = libs
    img = np.random.RandomState(1).rand(13, 9).astype(np.float32)
    got = t.resize_nearest(img, 8)
    np.testing.assert_array_equal(got, j.resize_nearest(img, 8))
    ys = (np.arange(8) * 13 / 8).astype(int).clip(0, 12)
    xs = (np.arange(8) * 9 / 8).astype(int).clip(0, 8)
    np.testing.assert_array_equal(got, img[np.ix_(ys, xs)])


@pytest.mark.parametrize("shuffle", [True, False])
def test_batcher_stream_equals_reference_and_covers_epochs(libs, shuffle):
    j, t = libs
    n, dx, dy, bs = 64, 5, 3, 16
    x = np.arange(n * dx, dtype=np.float32).reshape(n, dx)
    y = np.arange(n * dy, dtype=np.float32).reshape(n, dy)
    tb = t.NativeBatcher(x, y, bs, seed=7, shuffle=shuffle)
    jb = j.NativeBatcher(x, y, bs, seed=7, shuffle=shuffle)
    try:
        assert tb.batches_per_epoch == jb.batches_per_epoch == n // bs
        epochs = []
        for _ in range(2):
            seen = []
            for _ in range(tb.batches_per_epoch):
                bx, by = tb.next()
                rx, ry = jb.next()
                np.testing.assert_array_equal(bx, rx)
                np.testing.assert_array_equal(by, ry)
                rows = (bx[:, 0] / dx).astype(int)
                np.testing.assert_array_equal(by, y[rows])
                seen.extend(rows.tolist())
            assert sorted(seen) == list(range(n))   # one epoch, every row
            epochs.append(seen)
        assert (epochs[0] != epochs[1]) == shuffle
        if not shuffle:
            assert epochs[0] == list(range(n))
    finally:
        tb.close()
        jb.close()


def test_disk_queue_fifo(libs, tmp_path):
    _, t = libs
    q = t.DiskBasedQueue(str(tmp_path / "q.bin"))
    try:
        items = [b"alpha", b"", b"x" * 10000, b"last"]
        for it in items:
            q.push(it)
        assert len(q) == 4
        assert [q.pop() for _ in range(4)] == items
        assert q.pop() is None
        q.push(b"again")
        assert q.pop() == b"again"
    finally:
        q.close()


def test_without_the_library_every_wrapper_falls_back(monkeypatch,
                                                      tmp_path):
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    assert not tnative.available()
    p = str(tmp_path / "x.csv")
    np.savetxt(p, np.ones((2, 2)), delimiter=",")
    assert tnative.parse_csv(p) is None
    assert tnative.decode_jpeg(b"\xff\xd8") is None
    assert tnative.resize_nearest(np.ones((4, 4), np.float32), 2) is None
    with pytest.raises(RuntimeError):
        tnative.NativeBatcher(np.ones((4, 1), np.float32),
                              np.ones((4, 1), np.float32), 2)
    with pytest.raises(RuntimeError):
        tnative.DiskBasedQueue(str(tmp_path / "q"))
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 28, 28), dtype=np.uint8)
    tmnist.write_idx_images(str(tmp_path / "train-images-idx3-ubyte"),
                            images)
    tmnist.write_idx_labels(str(tmp_path / "train-labels-idx1-ubyte"),
                            np.arange(4, dtype=np.uint8))
    np.testing.assert_array_equal(
        tmnist.load_mnist(str(tmp_path))[0], images)


def test_failed_build_is_logged_with_the_compiler_stderr(monkeypatch,
                                                         tmp_path, caplog):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_failed", False)
    monkeypatch.setattr(tnative, "build_error", None)
    with caplog.at_level("WARNING", logger=tnative.__name__):
        assert tnative.get_lib() is None
    assert "broken.cpp" in tnative.build_error
    assert "error" in tnative.build_error          # g++'s own message
    assert any("broken.cpp" in r.getMessage() for r in caplog.records)
    assert not list((tmp_path / "out").glob("*.so"))
    assert not list((tmp_path / "out").glob("*.tmp"))


def test_concurrent_builds_share_one_library(tmp_path):
    """Processes building at once (test workers) serialize on the lock
    and all load the one library."""
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        sys.path.insert(0, {REPO!r})
        from deeplearning4j_tpu_torch.runtime import native
        native.BUILD_DIR = Path({str(tmp_path)!r})
        print(native.available(), native.library_path().name)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=600)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert all(o[0] == "True" for o in outs), outs
    assert len({o[1] for o in outs}) == 1
    assert [f.name for f in tmp_path.glob("*.so")] == [outs[0][1]]
    assert not list(tmp_path.glob("*.tmp"))
