"""The port's serving stack on the CPU: InferenceEngine + DynamicBatcher
over BERT-tiny fill-mask, and the guard that keeps the port free of JAX.
"""

import ast
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import bert
from deeplearning4j_tpu_torch.runtime import quantize as qz
from deeplearning4j_tpu_torch.runtime import telemetry
from deeplearning4j_tpu_torch.runtime.metrics import (decode_metrics,
                                                      serving_metrics)
from deeplearning4j_tpu_torch.serving.batcher import (BatcherClosed,
                                                      DeadlineExceeded,
                                                      DynamicBatcher)
from deeplearning4j_tpu_torch.serving.engine import (InferenceEngine,
                                                     default_buckets,
                                                     pad_rows, pick_bucket)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
T = 16


@pytest.fixture(scope="module")
def model():
    cfg = bert.bert_tiny(vocab_size=256, max_len=32)
    params = bert.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    return cfg, params, bert.make_serving_apply(cfg)


def _ids(seed, rows, cfg):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (rows, T)).astype(np.int32)


def _unpadded(apply_fn, params, x):
    with torch.inference_mode():
        return apply_fn(params, torch.from_numpy(x)).numpy()


def test_bucket_ladder_and_padding():
    assert default_buckets(1) == (1,)
    assert default_buckets(5) == (1, 2, 4, 8)
    assert default_buckets(32) == (1, 2, 4, 8, 16, 32)
    with pytest.raises(ValueError):
        default_buckets(0)
    assert [pick_bucket(n, (1, 2, 4, 8)) for n in (1, 2, 3, 5, 8)] == \
        [1, 2, 4, 8, 8]
    with pytest.raises(ValueError):
        pick_bucket(9, (1, 2, 4, 8))
    x = np.arange(6, dtype=np.int32).reshape(3, 2)
    p = pad_rows(x, 4)
    assert p.shape == (4, 2) and np.array_equal(p[:3], x) and not p[3].any()
    assert pad_rows(x, 3) is x


def test_engine_pads_slices_and_chunks_against_unpadded(model):
    """Every size, inside and above the ladder, returns exactly the
    unpadded forward's rows (bit-equal on the CPU)."""
    cfg, params, apply_fn = model
    eng = InferenceEngine(apply_fn, params, max_batch_size=4, device="cpu")
    w = eng.warmup(input_shape=(T,), dtype=np.int32)
    assert w["buckets"] == 3 and eng.input_spec == ((T,), np.dtype(np.int32))
    serving_metrics.reset()
    for n in (1, 3, 4, 9):
        x = _ids(n, n, cfg)
        out = eng.infer(x, sync=True)
        assert out.shape == (n, T, cfg.vocab_size)
        ref = np.concatenate([_unpadded(apply_fn, params, x[i:i + 4])
                              for i in range(0, n, 4)])
        np.testing.assert_array_equal(out.numpy(), ref)
    snap = serving_metrics.snapshot()
    # 9 rows chunk into 4 + 4 + 1: 1 + 1 + 1 + 3 dispatches
    assert snap["requests"] == 4 and snap["rows"] == 17
    assert snap["dispatches"] == 6 and snap["rows_padded"] == 1 + 4 + 4 + 9
    assert snap["latency_samples"] == 4


def test_engine_options():
    with pytest.raises(ValueError, match="quantize mode"):
        InferenceEngine(lambda p, x: x, quantize="int4", device="cpu")
    w = torch.tensor([[0.5, -1.0], [0.25, 2.0]])
    q8 = InferenceEngine(lambda p, x: x @ p["w"], params={"w": w},
                         buckets=(2,), quantize="int8", device="cpu")
    assert isinstance(q8.current_params()["w"], qz.QTensor)
    np.testing.assert_allclose(q8.infer(np.eye(2, dtype=np.float32)).numpy(),
                               w.numpy(), atol=float(w.abs().max()) / 254)
    with pytest.raises(ValueError, match="bucket"):
        InferenceEngine(lambda p, x: x, buckets=(0, 2), device="cpu")
    eng = InferenceEngine(lambda p, x: x * p, params=lambda: 3,
                          buckets=(2,), device="cpu")
    np.testing.assert_array_equal(eng.infer(np.ones((1, 2))).numpy(),
                                  [[3.0, 3.0]])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            InferenceEngine(lambda p, x: x)


def test_batcher_concurrent_clients_get_their_own_rows_in_order(model):
    cfg, params, apply_fn = model
    eng = InferenceEngine(apply_fn, params, max_batch_size=8, device="cpu")
    eng.warmup(input_shape=(T,), dtype=np.int32)
    n_clients, per_client = 4, 5
    reqs = {(c, j): _ids(100 * c + j, 1 + (c + j) % 3, cfg)
            for c in range(n_clients) for j in range(per_client)}
    got = {}
    errors = []
    serving_metrics.reset()
    tracer = telemetry.enable()
    try:
        with DynamicBatcher(eng, max_batch_size=8, max_delay_ms=20.0) as bt:
            def client(c):
                try:
                    futs = [bt.submit(reqs[c, j]) for j in range(per_client)]
                    got[c] = [f.result(timeout=60) for f in futs]
                except Exception as e:     # asserted below
                    errors.append(e)
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(n_clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            one = bt.submit_one(reqs[0, 0][0]).result(timeout=60)
    finally:
        telemetry.disable()
    assert not errors
    for c in range(n_clients):
        for j in range(per_client):
            ref = _unpadded(apply_fn, params, reqs[c, j])
            np.testing.assert_allclose(got[c][j], ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        one, _unpadded(apply_fn, params, reqs[0, 0][:1])[0],
        rtol=1e-5, atol=1e-5)
    snap = serving_metrics.snapshot()
    assert snap["requests"] == n_clients * per_client + 1
    assert snap["batches_formed"] < snap["requests"]        # coalesced
    assert snap["latency_samples"] == snap["requests"]
    names = {r["name"] for r in tracer.records()}
    assert {"serving.enqueue", "serving.cohort", "serving.dispatch",
            "serving.complete"} <= names


def test_batcher_closed_and_input_spec_rejection(model):
    cfg, params, apply_fn = model
    eng = InferenceEngine(apply_fn, params, max_batch_size=2, device="cpu")
    eng.warmup(input_shape=(T,), dtype=np.int32)
    bt = DynamicBatcher(eng, max_batch_size=2)
    with pytest.raises(ValueError, match="does not match"):
        bt.submit(np.zeros((1, T + 1), np.int32))
    with pytest.raises(ValueError, match="does not match"):
        bt.submit(np.zeros((1, T), np.float32))
    with pytest.raises(ValueError, match="deadline_ms"):
        bt.submit(np.zeros((1, T), np.int32), deadline_ms=0)
    assert bt.infer(np.zeros((1, T), np.int32)).shape == \
        (1, T, cfg.vocab_size)
    bt.close()
    assert not bt._thread.is_alive()
    with pytest.raises(BatcherClosed):
        bt.submit(np.zeros((1, T), np.int32))


def test_batcher_deadline_exceeded():
    """A request queued behind a stalled dispatch past its deadline
    resolves with DeadlineExceeded instead of a forward."""
    entered, release = threading.Event(), threading.Event()

    def slow_apply(params, x):
        entered.set()
        release.wait(timeout=30)
        return x.float()

    eng = InferenceEngine(slow_apply, buckets=(1,), device="cpu")
    decode_metrics.reset()
    with DynamicBatcher(eng, max_batch_size=1, max_delay_ms=0.0) as bt:
        first = bt.submit(np.ones((1, 2), np.float32))
        assert entered.wait(timeout=30)
        late = bt.submit(np.ones((1, 2), np.float32), deadline_ms=1.0)
        time.sleep(0.05)
        release.set()
        np.testing.assert_array_equal(first.result(timeout=30), [[1, 1]])
        with pytest.raises(DeadlineExceeded) as ei:
            late.result(timeout=30)
    assert ei.value.deadline_ms == pytest.approx(1.0)
    assert ei.value.elapsed_ms > 1.0 and ei.value.tokens_emitted == 0
    assert decode_metrics.snapshot()["deadline_expirations"] == 1


# -- the port never reaches for JAX -----------------------------------------

_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "deeplearning4j_tpu"}


def _port_sources():
    files = sorted((REPO / "deeplearning4j_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_sources_import_no_jax():
    offenders = []
    files = _port_sources()
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in _FORBIDDEN:
                    offenders.append(f"{path.relative_to(REPO)}:"
                                     f"{node.lineno} imports {name}")
    assert not offenders, offenders


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "deeplearning4j_tpu_torch." + ".".join(
            p.relative_to(REPO / "deeplearning4j_tpu_torch")
            .with_suffix("").parts)
        for p in (REPO / "deeplearning4j_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(_FORBIDDEN)!r})\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), \
        res.stdout + res.stderr
