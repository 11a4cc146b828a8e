"""The port's attention autotuner (``runtime/autotune.py``) and its
consult in ``ops/flash_attention.make_attn_fn``.

Every cache lives in ``tmp_path``.  On the CPU a sweep times only the
plain candidate (the hand kernel runs on CUDA tensors alone); the card
sweep is ``chip_smoke.py`` phase 18(e).  The bucket ladder and the
on/off grammar are held to the reference's; the key is the reference's
with the rows' (batch x heads) bucket added, and ``make_attn_fn``
consults the cache only when its caller opts in.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from deeplearning4j_tpu.runtime import autotune as jat
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import kernel_select as ks
from deeplearning4j_tpu_torch.runtime import autotune as at
from deeplearning4j_tpu_torch.runtime.metrics import mfu_metrics

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(batch=2, n_heads=2, dtype=torch.float32, device="cpu",
             repeats=2)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv(at.AUTOTUNE_CACHE_ENV, str(tmp_path / "tune"))
    at.reset_memo()
    mfu_metrics.reset()
    yield tmp_path / "tune" / "attention.json"
    at.reset_memo()


def test_cache_dir_grammar_and_the_reference_cache_is_never_read(
        tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv(at.AUTOTUNE_CACHE_ENV, raising=False)
    default = os.path.join(str(tmp_path), ".cache",
                           "dl4j_tpu_torch_autotune")
    assert at.cache_dir() == default
    for on in ("1", "true", "ON", " on "):
        monkeypatch.setenv(at.AUTOTUNE_CACHE_ENV, on)
        assert at.cache_dir() == default
    for off in ("0", "false", "OFF"):
        monkeypatch.setenv(at.AUTOTUNE_CACHE_ENV, off)
        assert at.cache_dir() is None and at.cache_path() is None
        # the reference's grammar says the same of the same value
        monkeypatch.setenv(jat.AUTOTUNE_CACHE_ENV, off)
        assert jat.cache_dir() is None
    monkeypatch.setenv(at.AUTOTUNE_CACHE_ENV, str(tmp_path / "x"))
    assert at.cache_path() == str(tmp_path / "x" / "attention.json")
    # the reference's variable and directory are not the port's
    assert at.AUTOTUNE_CACHE_ENV != jat.AUTOTUNE_CACHE_ENV
    monkeypatch.delenv(at.AUTOTUNE_CACHE_ENV)
    monkeypatch.setenv(jat.AUTOTUNE_CACHE_ENV, str(tmp_path / "tpu"))
    assert at.cache_dir() == default


def test_keys_and_buckets_match_the_reference():
    for n in (1, 100, 128, 129, 1000, 1024, 5000):
        assert at.shape_bucket(n) == jat.shape_bucket(n)
    # the rows' bucket has no floor of 128: batch 1 x 1 head and GPT-2
    # small's 8 x 12 never share a key
    assert [at.shape_bucket(n, 1) for n in (1, 2, 3, 96, 384)] == \
        [1, 2, 4, 128, 512]
    assert at.attn_key("H100", 128, 1024, 64, True, rows_bucket=128) == \
        jat.attn_key("H100", 128, 1024, 64, True).replace(
            "attn|H100|", "attn|H100|r128|")
    assert at.device_kind("cpu") == "cpu"


def test_cold_lookup_misses_then_sweep_persists_the_plain_winner(cache):
    assert at.lookup_attention(64, 64, 16, True, rows=4, kind="cpu") is None
    assert mfu_metrics.count("consults") == 1
    assert mfu_metrics.count("cache_misses") == 1
    rec = at.sweep_attention(64, 64, 16, True, **SHAPE)
    assert rec["impl"] == "plain" and set(rec["candidates"]) == {"plain"}
    assert rec["candidates"]["plain"]["step_ms"] > 0
    assert rec["key"] == at.attn_key("cpu", 128, 128, 16, True,
                                     rows_bucket=4)
    assert "fixed" in rec["blocks"] and rec["shape"] == [2, 64, 64, 2, 16]
    assert mfu_metrics.count("sweeps") == 1
    assert mfu_metrics.count("candidates_timed") == 1
    assert mfu_metrics.count("winners_persisted") == 1
    on_disk = json.loads(cache.read_text())
    assert on_disk[rec["key"]]["impl"] == "plain"
    assert at.lookup_attention(100, 128, 16, True, rows=3,
                               kind="cpu") == rec
    assert mfu_metrics.count("cache_hits") == 1
    # a verdict taken at 2 x 2 rows does not answer for 32 x 12
    assert at.lookup_attention(64, 64, 16, True, rows=384,
                               kind="cpu") is None
    # the caller names the shape: there is no default batch
    with pytest.raises(TypeError):
        at.sweep_attention(64, 64, 16, True, device="cpu")


def test_persist_merges_keys_and_ignores_a_corrupt_file(cache):
    cache.parent.mkdir(parents=True)
    cache.write_text("{not json")
    assert at.lookup_attention(64, 64, 16, False, rows=4,
                               kind="cpu") is None
    a = at.sweep_attention(64, 64, 16, False, **SHAPE)
    at.reset_memo()                    # as another process would see it
    b = at.sweep_attention(300, 300, 8, True, **SHAPE)
    on_disk = json.loads(cache.read_text())
    assert set(on_disk) == {a["key"], b["key"]}
    assert not list(cache.parent.glob("*.tmp.*"))


def test_a_second_process_finds_the_winner_without_sweeping(cache):
    at.sweep_attention(64, 64, 16, True, **SHAPE)
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]);"
            "from deeplearning4j_tpu_torch.runtime import autotune as at;"
            "from deeplearning4j_tpu_torch.runtime.metrics import "
            "mfu_metrics as m;"
            "rec = at.ensure_attention(64, 64, 16, True, batch=2, n_heads=2,"
            " device='cpu');"
            "print(json.dumps([rec['impl'], m.count('sweeps'), "
            "m.count('cache_hits')]))")
    out = subprocess.run([sys.executable, "-c", code, REPO],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ), check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == ["plain", 0, 1]


def test_off_disables_consults_and_persistence(tmp_path, monkeypatch):
    monkeypatch.setenv(at.AUTOTUNE_CACHE_ENV, "off")
    at.reset_memo()
    mfu_metrics.reset()
    assert at.lookup_attention(64, 64, 16, True, rows=4, kind="cpu") is None
    assert mfu_metrics.count("consults") == 0
    rec = at.sweep_attention(64, 64, 16, True, **SHAPE)
    assert rec["impl"] == "plain"
    assert mfu_metrics.count("winners_persisted") == 0


def test_resolve_kernel_follows_a_measured_winner_only_in_auto():
    kw = dict(aligned=True, on_cuda=True)
    assert ks.resolve_kernel("auto", **kw) == "cuda"
    assert ks.resolve_kernel("auto", autotuned="plain", **kw) == "plain"
    assert ks.resolve_kernel("auto", autotuned="cuda", **kw) == "cuda"
    assert ks.resolve_kernel("cuda", autotuned="plain", **kw) == "cuda"
    assert ks.resolve_kernel("plain", autotuned="cuda", **kw) == "plain"
    assert ks.resolve_kernel("auto", aligned=True, on_cuda=False,
                             autotuned="cuda") == "plain"


def test_make_attn_fn_consults_the_cache_for_cuda_shapes(cache,
                                                         monkeypatch):
    """describe() decides without running.  By default no cache is read
    and the kernel takes every CUDA shape it supports; with
    ``autotune=True`` a cached winner for the card and the shape's
    buckets routes auto and is reported as autotuned; other rows
    buckets, shapes the kernel does not take, CPU tensors and forced
    modes never follow it."""
    monkeypatch.setattr(at, "device_kind", lambda device=None: "card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    q = (4, 128, 12, 64)                         # 48 rows: bucket 64
    at._persist(str(cache), at.attn_key("card", 128, 128, 64, False,
                                        rows_bucket=64),
                {"impl": "plain"})
    mfu_metrics.reset()
    d = fa.make_attn_fn().describe(q, q, False, device="cuda")
    assert (d.impl, d.source) == ("cuda", "heuristic")
    assert mfu_metrics.count("consults") == 0
    d = fa.make_attn_fn(autotune=True).describe(q, q, False, device="cuda")
    assert (d.impl, d.source) == ("plain", "autotuned")
    d = fa.make_attn_fn(autotune=True).describe(q, q, True, device="cuda")
    assert (d.impl, d.source) == ("cuda", "heuristic")
    big = (32, 128, 12, 64)                      # 384 rows: bucket 512
    d = fa.make_attn_fn(autotune=True).describe(big, big, False,
                                                device="cuda")
    assert (d.impl, d.source) == ("cuda", "heuristic")
    assert mfu_metrics.count("consults") == 3
    attn = fa.make_attn_fn(autotune=True)
    for _ in range(3):                           # once per shape
        attn.describe(q, q, False, device="cuda")
    assert mfu_metrics.count("consults") == 4
    fa.make_attn_fn(autotune=True).describe(
        (4, 128, 12, 60), (4, 128, 12, 60), False, device="cuda")
    fa.make_attn_fn(autotune=True).describe(q, q, False, device="cpu")
    d = fa.make_attn_fn("cuda", autotune=True).describe(q, q, False,
                                                        device="cuda")
    assert (d.impl, d.source) == ("cuda", "forced")
    assert mfu_metrics.count("consults") == 4
    # a host without a card describes a CUDA shape without a consult
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = fa.make_attn_fn(autotune=True).describe(q, q, False, device="cuda")
    assert (d.impl, d.source) == ("cuda", "heuristic")
    assert mfu_metrics.count("consults") == 4


def test_forced_cuda_on_cpu_still_raises_with_a_cached_winner(cache):
    at._persist(str(cache), at.attn_key("cpu", 128, 128, 16, False,
                                        rows_bucket=2),
                {"impl": "cuda"})
    q = torch.zeros(1, 64, 2, 16)
    with pytest.raises(ValueError, match="CPU tensors"):
        fa.make_attn_fn("cuda", autotune=True)(q, q, q)
    out = fa.make_attn_fn(autotune=True)(q, q, q)   # auto on the CPU: plain
    assert out.shape == q.shape


def test_sweep_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        at.sweep_attention(64, 64, 16, False, batch=1, n_heads=1)
