"""The port's flash-attention forward against the JAX Pallas kernel.

The same numpy-seeded inputs go through JAX ``pallas_attention._fwd``
(interpreted on the CPU, as the JAX package's own tests run it) and the
port's plain twin ``flash_attention_fwd_plain``, which is what the port's
wrapper runs for CPU tensors and what ``chip_smoke.py`` holds the CUDA
kernel against on the card.  Tolerances are those of
tests/test_pallas_attention.py: fp32 2e-5, bf16 3e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jtfm
from deeplearning4j_tpu.ops import pallas_attention as jpa
from deeplearning4j_tpu_torch.models import transformer as ttfm
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import kernel_select as ks

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(seed, B, NH, Tq, Tk, D, lens=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B * NH, Tq, D)).astype(np.float32)
    k = rng.standard_normal((B * NH, Tk, D)).astype(np.float32)
    v = rng.standard_normal((B * NH, Tk, D)).astype(np.float32)
    mask = np.ones((B, Tk), np.float32)
    if lens is not None:
        mask = (np.arange(Tk)[None, :] < np.asarray(lens)[:, None]) \
            .astype(np.float32)
    bias = (1.0 - mask) * np.float32(fa.MASK_VAL)
    return q, k, v, mask, bias


def _jax_fwd(q, k, v, bias, NH, causal, dtype, block=32):
    jd = jnp.dtype(dtype)
    o, lse = jpa._fwd(jnp.asarray(q, jd), jnp.asarray(k, jd),
                      jnp.asarray(v, jd),
                      jnp.repeat(jnp.asarray(bias), NH, axis=0), causal,
                      block, block, True)
    return np.asarray(o, np.float32), np.asarray(lse)


def _port_fwd(q, k, v, bias, causal, dtype):
    td = getattr(torch, dtype)
    o, lse = fa.flash_attention_fwd(
        torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
        torch.from_numpy(v).to(td), torch.from_numpy(bias), causal)
    assert o.dtype == td and lse.dtype == torch.float32
    return o.float().numpy(), lse.numpy()


CASES = [
    # id, B, NH, Tq, Tk, D, key lengths, causal, dtype
    ("plain", 2, 2, 64, 64, 16, None, False, "float32"),
    ("mask", 2, 2, 64, 64, 16, [48, 64], False, "float32"),
    ("causal", 2, 2, 64, 64, 16, None, True, "float32"),
    ("causal-mask", 2, 2, 64, 64, 16, [48, 64], True, "float32"),
    ("tq-ne-tk", 2, 2, 32, 96, 16, [80, 96], False, "float32"),
    ("ragged", 2, 2, 40, 40, 8, [40, 29], False, "float32"),
    ("fully-masked-row", 2, 1, 32, 32, 8, [0, 32], False, "float32"),
    ("bf16", 2, 2, 64, 64, 16, [60, 64], False, "bfloat16"),
    ("bf16-causal", 2, 2, 64, 64, 16, None, True, "bfloat16"),
]


@pytest.mark.parametrize(
    "B,NH,Tq,Tk,D,lens,causal,dtype", [c[1:] for c in CASES],
    ids=[c[0] for c in CASES])
def test_plain_twin_matches_pallas_fwd(B, NH, Tq, Tk, D, lens, causal,
                                       dtype):
    q, k, v, _, bias = _inputs(0, B, NH, Tq, Tk, D, lens)
    o_ref, lse_ref = _jax_fwd(q, k, v, bias, NH, causal, dtype)
    o, lse = _port_fwd(q, k, v, bias, causal, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(o, o_ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(lse, lse_ref, rtol=tol, atol=tol)


def test_bias_rows_per_head_or_per_batch_agree():
    """A [B, Tk] bias indexed by bh // NH equals the same bias repeated
    to [BH, Tk] (the JAX kernel's input)."""
    B, NH = 2, 3
    q, k, v, _, bias = _inputs(1, B, NH, 16, 16, 8, [16, 9])
    args = [torch.from_numpy(a) for a in (q, k, v)]
    o1, lse1 = fa.flash_attention_fwd(*args, torch.from_numpy(bias))
    o2, lse2 = fa.flash_attention_fwd(
        *args, torch.from_numpy(np.repeat(bias, NH, axis=0)))
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_btnd_matches_jax(causal, dtype):
    B, T, NH, D = 2, 48, 2, 16
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((B, T, NH, D)).astype(np.float32)
               for _ in range(3))
    mask = (np.arange(T)[None, :] < np.array([[40], [48]])).astype(
        np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jpa.flash_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                              jnp.asarray(v, jd), jnp.asarray(mask), causal,
                              block_q=16, block_k=16, interpret=True)
    out = fa.flash_attention(torch.from_numpy(q).to(td),
                             torch.from_numpy(k).to(td),
                             torch.from_numpy(v).to(td),
                             torch.from_numpy(mask), causal)
    assert out.shape == (B, T, NH, D)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_plain_attention_matches_jax():
    """The port's plain attention (the "plain" dispatch) against JAX's."""
    B, T, NH, D = 2, 24, 2, 8
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((B, T, NH, D)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((B, T), np.float32)
    mask[0, 17:] = 0
    for causal in (False, True):
        ref = jtfm.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(mask), causal)
        out = ttfm.attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(mask),
                             causal)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=2e-5, atol=2e-5)


def test_causal_requires_equal_lengths():
    q = torch.zeros(2, 8, 8)
    k = torch.zeros(2, 16, 8)
    with pytest.raises(ValueError, match="Tq == Tk"):
        fa.flash_attention_fwd(q, k, k, None, causal=True)
    q, k = torch.zeros(1, 8, 2, 8), torch.zeros(1, 16, 2, 8)
    with pytest.raises(ValueError, match="Tq == Tk"):
        fa.flash_attention(q, k, k, None, causal=True)


# -- the dispatch contract --------------------------------------------------

def test_resolve_attn_kernel_contract():
    assert ks.resolve_kernel("auto", aligned=True,
                                  on_cuda=False) == "plain"
    assert ks.resolve_kernel("auto", aligned=True,
                                  on_cuda=True) == "cuda"
    assert ks.resolve_kernel("auto", aligned=False,
                                  on_cuda=True) == "plain"
    assert ks.resolve_kernel("plain", aligned=True,
                                  on_cuda=True) == "plain"
    assert ks.resolve_kernel("cuda", aligned=True,
                                  on_cuda=True) == "cuda"
    with pytest.raises(ValueError, match="CPU tensors"):
        ks.resolve_kernel("cuda", aligned=True, on_cuda=False)
    with pytest.raises(ValueError, match="never a silent fallback"):
        ks.resolve_kernel("cuda", aligned=False, on_cuda=True)
    with pytest.raises(ValueError, match="kernel must be one of"):
        ks.resolve_kernel("pallas", aligned=True, on_cuda=True)


def test_make_attn_fn_dispatch():
    q = torch.randn(1, 8, 2, 8)
    auto = fa.make_attn_fn("auto")
    d = auto.describe(q.shape, q.shape, device="cpu", dtype=q.dtype)
    assert (d.impl, d.source) == ("plain", "off-cuda")
    d = auto.describe(q.shape, q.shape, device="cuda", dtype=torch.bfloat16)
    assert (d.impl, d.source) == ("cuda", "heuristic")
    d = auto.describe((1, 8, 2, 12), (1, 8, 2, 12), device="cuda",
                      dtype=torch.bfloat16)
    assert d.impl == "plain"                  # D % 8 != 0
    d = auto.describe(q.shape, q.shape, device="cuda", dtype=torch.float16)
    assert d.impl == "plain"                  # dtype the kernel lacks
    torch.testing.assert_close(auto(q, q, q), ttfm.attention(q, q, q, None))
    with pytest.raises(ValueError, match="CPU tensors"):
        fa.make_attn_fn("cuda")(q, q, q)
    with pytest.raises(ValueError, match="kernel must be one of"):
        fa.make_attn_fn("xla")
    with pytest.raises(NotImplementedError, match="parallel slice"):
        fa.make_attn_fn("auto", mesh=object())


def test_kernel_wrapper_refuses_cpu_and_unsupported_inputs():
    """The CUDA entry point raises rather than running anything else:
    on CPU tensors, and on shapes or dtypes the kernel does not take."""
    before = fa.launches
    q = torch.zeros(2, 16, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_fwd_cuda(q, q, q)
    with pytest.raises(ValueError, match="D % 8 == 0"):
        fa.flash_attention_fwd_cuda(*(torch.zeros(2, 16, 12),) * 3)
    with pytest.raises(ValueError, match="D % 8 == 0"):
        fa.flash_attention_fwd_cuda(*(torch.zeros(2, 16, 8,
                                                  dtype=torch.float16),) * 3)
    with pytest.raises(ValueError, match="dtypes differ"):
        fa.flash_attention_fwd_cuda(q, q.bfloat16(), q)
    assert fa.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize(
    "D,causal,T,route",
    [(64, True, 256, "wgmma"), (128, False, 200, "wgmma"),
     (40, True, 200, "mma.sync")],
    ids=["d64-causal-t256", "d128-t200", "d40-causal-mma-sync"])
def test_cuda_kernel_matches_plain_twin(D, causal, T, route):
    """On a CUDA card: B1 against its tile-exact plain twin (bf16 3e-2),
    launched once, on the route the entry point picks for the head dim
    (wgmma + TMA for 64 and 128)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the card "
                    "(python3 chip_smoke.py covers it there)")
    assert fa.fwd_route(torch.bfloat16, D) == route
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(24, T, D, generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    bias = torch.zeros(2, T, device="cuda")
    bias[1, 150:] = fa.MASK_VAL
    before = fa.launches
    o, lse = fa.flash_attention_fwd(q, k, v, bias, causal)
    assert fa.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_fwd_plain(
        q, k, v, bias, causal, causal_tile=fa.CAUSAL_TILE)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=3e-2,
                               atol=3e-2)
    torch.testing.assert_close(lse, lse_ref, rtol=3e-2, atol=3e-2)
