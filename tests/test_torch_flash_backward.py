"""The port's flash-attention backward against the JAX Pallas kernels.

The same numpy-seeded q, k, v, mask and output gradient go through
``jax.vjp`` of JAX ``pallas_attention.flash_attention`` (interpreted on
the CPU, as the JAX package's own tests run it) and through the port:
its plain twin ``flash_attention_bwd_plain`` (fed the plain forward's o
and lse, what the CUDA kernels B2/B3 are held against on the card), and
autograd through ``flash_attention`` (``FlashAttentionFn``, which runs
the plain twins for CPU tensors).  Also ``_matmul``'s gradient against
JAX's transpose of a ``preferred_element_type`` einsum.

Tolerances: fp32 5e-4 (tests/test_pallas_attention.py:55); bf16 3e-2
of the case's largest |grad| (bf16 rounds p and dS before the products,
at other places than XLA's interpreter).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_attention as jpa
from deeplearning4j_tpu_torch.models import transformer as ttfm
from deeplearning4j_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

FP32_TOL = 5e-4
BF16_TOL = 3e-2

CASES = [
    # id, B, NH, Tq, Tk, D, key lengths, causal, dtype
    ("plain", 2, 2, 64, 64, 16, None, False, "float32"),
    ("causal", 2, 2, 64, 64, 16, None, True, "float32"),
    ("padded-keys", 2, 2, 48, 48, 8, [48, 29], False, "float32"),
    ("causal-padded", 2, 2, 64, 64, 16, [64, 37], True, "float32"),
    ("tq-ne-tk", 2, 2, 24, 56, 8, [56, 40], False, "float32"),
    ("fully-masked-row", 2, 1, 32, 32, 8, [0, 32], False, "float32"),
    ("bf16", 2, 2, 64, 64, 16, [60, 64], False, "bfloat16"),
    ("bf16-causal", 2, 2, 64, 64, 16, None, True, "bfloat16"),
]


def _inputs(seed, B, NH, Tq, Tk, D, lens):
    """q, k, v, dO ``[B, T, NH, D]`` and the ``[B, Tk]`` mask, fp32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, NH, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, NH, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, NH, D)).astype(np.float32)
    do = rng.standard_normal((B, Tq, NH, D)).astype(np.float32)
    mask = np.ones((B, Tk), np.float32)
    if lens is not None:
        mask = (np.arange(Tk)[None, :] < np.asarray(lens)[:, None]) \
            .astype(np.float32)
    return q, k, v, do, mask


def _jax_vjp(q, k, v, do, mask, causal, dtype, block=32):
    """(o, (dq, dk, dv)) of the interpreted Pallas flash attention, fp32."""
    jd = jnp.dtype(dtype)

    @jax.jit
    def vjp(q, k, v, do):
        def f(q, k, v):
            return jpa.flash_attention(q, k, v, jnp.asarray(mask), causal,
                                       block_q=block, block_k=block,
                                       interpret=True)
        o, pull = jax.vjp(f, q, k, v)
        return o, pull(do)

    o, grads = vjp(*(jnp.asarray(x, jd) for x in (q, k, v, do)))
    return (np.asarray(o, np.float32),
            [np.asarray(g, np.float32) for g in grads])


def _jax_grads(q, k, v, do, mask, causal, dtype):
    """(dq, dk, dv) of the interpreted Pallas flash attention, fp32."""
    return _jax_vjp(q, k, v, do, mask, causal, dtype)[1]


def _assert_grads_close(got, ref, dtype):
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=FP32_TOL, atol=FP32_TOL,
                                       err_msg=name)
        else:
            err = np.abs(a - b).max()
            assert err <= BF16_TOL * np.abs(b).max(), (name, err,
                                                       np.abs(b).max())


def _bhtd(x):
    B, T, NH, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * NH, T, D)


def _btnd(x, B, NH):
    return x.reshape(B, NH, *x.shape[1:]).permute(0, 2, 1, 3)


@pytest.mark.parametrize("path", ["bwd_plain", "autograd"])
@pytest.mark.parametrize(
    "B,NH,Tq,Tk,D,lens,causal,dtype", [c[1:] for c in CASES],
    ids=[c[0] for c in CASES])
def test_backward_matches_pallas_vjp(B, NH, Tq, Tk, D, lens, causal, dtype,
                                     path):
    q, k, v, do, mask = _inputs(0, B, NH, Tq, Tk, D, lens)
    ref = _jax_grads(q, k, v, do, mask, causal, dtype)
    td = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(td) for x in (q, k, v, do))
    tmask = torch.from_numpy(mask)
    if path == "bwd_plain":
        bias = (1.0 - tmask) * fa.MASK_VAL
        q4, k4, v4, do4 = (_bhtd(x) for x in (tq, tk, tv, tdo))
        o, lse = fa.flash_attention_fwd(q4, k4, v4, bias, causal)
        grads = fa.flash_attention_bwd(q4, k4, v4, bias, o, lse, do4, causal)
        grads = [_btnd(g, B, NH) for g in grads]
    else:
        leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
        out = fa.flash_attention(*leaves, tmask, causal)
        grads = torch.autograd.grad(out, leaves, tdo)
    assert all(g.dtype == td for g in grads)
    _assert_grads_close([g.float().numpy() for g in grads], ref, dtype)


def test_fully_masked_rows_keep_probabilities_summing_to_one():
    """A row whose every key is masked keeps log(sum) beside -1e5 in its
    saved lse, so its backward probabilities still sum to 1 (the reason
    MASK_VAL is -1e5, flash_attention.py:41-44).  With dO = 1, dV's
    column sums count the rows: Tq for the masked sequence as for the
    live one, within the rounding of lse to fp32's 2^-7 steps at 1e5
    (1%)."""
    B, NH, T, D = 2, 1, 16, 8
    q, k, v, _, mask = _inputs(5, B, NH, T, T, D, [0, T])
    bias = (1.0 - torch.from_numpy(mask)) * fa.MASK_VAL
    q4, k4, v4 = (_bhtd(torch.from_numpy(x)) for x in (q, k, v))
    o, lse = fa.flash_attention_fwd(q4, k4, v4, bias)
    _, _, dv = fa.flash_attention_bwd(q4, k4, v4, bias, o, lse,
                                      torch.ones_like(q4))
    torch.testing.assert_close(dv.sum(1), torch.full((B, D), float(T)),
                               rtol=1e-2, atol=0)


@pytest.mark.parametrize("T", [256, 192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_exact_twins_match_pallas_on_fully_masked_causal_rows(dtype, T):
    """Causal attention where one sequence's keys are all masked: every
    row of it is fully masked, and its softmax runs over the -1e5 scores
    of the key tiles the kernel walked.  With ``causal_tile=64`` the
    plain forward and backward skip the kernels' tiles (B1's 64-key tile,
    ``csrc/flash_common.cuh``), and agree with the Pallas kernel at
    block 64 (``_pick_block`` keeps 64 at T=256 and 192) on every row,
    the fully masked ones included; the default twins, which see every
    key, do not.  T=192 is an odd count of 64-row tiles, where the wgmma
    B1's last 128-row block has rows in its first warpgroup only.
    Tolerances: the forward fp32 2e-5 and the gradients fp32 5e-4
    (tests/test_pallas_attention.py:34,55); bf16 3e-2 of the largest
    |value|."""
    B, NH, D = 2, 1, 64
    q, k, v, do, mask = _inputs(7, B, NH, T, T, D, [0, T])
    o_ref, g_ref = _jax_vjp(q, k, v, do, mask, True, dtype, block=64)
    td = getattr(torch, dtype)
    q4, k4, v4, do4 = (_bhtd(torch.from_numpy(x).to(td))
                       for x in (q, k, v, do))
    bias = (1.0 - torch.from_numpy(mask)) * fa.MASK_VAL
    o, lse = fa.flash_attention_fwd_plain(q4, k4, v4, bias, True,
                                          causal_tile=fa.CAUSAL_TILE)
    grads = fa.flash_attention_bwd_plain(q4, k4, v4, bias, o, lse, do4,
                                         True, causal_tile=fa.CAUSAL_TILE)
    got_o = _btnd(o, B, NH).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got_o, o_ref, rtol=2e-5, atol=2e-5)
    else:
        assert np.abs(got_o - o_ref).max() <= BF16_TOL * np.abs(o_ref).max()
    _assert_grads_close([_btnd(g, B, NH).float().numpy() for g in grads],
                        g_ref, dtype)
    # the masked sequence's rows before the last tile see fewer tiles
    # than keys
    o_all, _ = fa.flash_attention_fwd_plain(q4, k4, v4, bias, True)
    diff = np.abs(_btnd(o_all, B, NH).float().numpy() - o_ref)
    assert diff[0, :T - 64].max() > 0.1 and diff[1].max() <= 3e-2


def test_bias_gets_no_gradient_and_inference_mode_runs_forward_only():
    q = torch.randn(1, 16, 2, 8, requires_grad=True)
    mask = torch.ones(1, 16, requires_grad=True)
    out = fa.flash_attention(q, q, q, mask)
    (gq, gmask) = torch.autograd.grad(out.sum(), (q, mask),
                                      allow_unused=True)
    assert gq is not None and gmask is None
    with torch.inference_mode():
        served = fa.flash_attention(q.detach(), q.detach(), q.detach(),
                                    mask.detach())
    assert not served.requires_grad
    torch.testing.assert_close(served, out.detach())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_grad_matches_jax_einsum(dtype):
    """``_matmul``'s gradient against JAX's transpose of ``einsum(...,
    preferred_element_type=float32)`` over fp32 master arrays cast to the
    compute dtype (the projections of transformer.py:224)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    w = (0.1 * rng.standard_normal((32, 4, 8))).astype(np.float32)
    r = rng.standard_normal((2, 12, 4, 8)).astype(np.float32)
    jd = jnp.dtype(dtype)

    def jloss(x, w):
        y = jnp.einsum("bth,hnd->btnd", x.astype(jd), w.astype(jd),
                       preferred_element_type=jnp.float32)
        return jnp.sum(y * r)

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    y = ttfm._matmul(tx, tw.reshape(32, 32), getattr(torch, dtype))
    assert y.dtype == torch.float32
    gx, gw = torch.autograd.grad((y.reshape(2, 12, 4, 8)
                                  * torch.from_numpy(r)).sum(), (tx, tw))
    assert gx.dtype == gw.dtype == torch.float32
    for got, ref in ((gx, jgx), (gw, jgw)):
        ref = np.asarray(ref)
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                       atol=1e-5)
        else:
            # bf16-rounded cotangent and gradient: within a bf16 ulp
            np.testing.assert_allclose(got.numpy(), ref, rtol=3e-2,
                                       atol=3e-2 * np.abs(ref).max())


def test_launch_counters_and_reset():
    fa.reset_launches()
    assert fa.launch_counts() == {"launches": 0, "launches_dkv": 0,
                                  "launches_dq": 0}
    q = torch.randn(1, 8, 2, 8, requires_grad=True)
    torch.autograd.grad(fa.flash_attention(q, q, q).sum(), q)
    assert fa.launch_counts() == {"launches": 0, "launches_dkv": 0,
                                  "launches_dq": 0}   # plain twins on CPU


def test_backward_wrapper_refuses_cpu_and_unsupported_inputs():
    """The CUDA entry point raises rather than running anything else."""
    before = fa.launch_counts()
    q = torch.zeros(2, 16, 8)
    lse = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_bwd_cuda(q, q, q, None, q, lse, q)
    with pytest.raises(ValueError, match="D % 8 == 0"):
        x = torch.zeros(2, 16, 12)
        fa.flash_attention_bwd_cuda(x, x, x, None, x, lse, x)
    with pytest.raises(ValueError, match="Tq == Tk"):
        fa.flash_attention_bwd(q, torch.zeros(2, 8, 8), torch.zeros(2, 8, 8),
                               None, q, lse, q, causal=True)
    assert fa.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize(
    "D,causal,T,route",
    [(64, True, 256, "wgmma"), (128, False, 200, "wgmma"),
     (40, True, 200, "mma.sync")],
    ids=["d64-causal-t256", "d128-t200", "d40-causal-mma-sync"])
def test_cuda_backward_kernels_match_plain_twins(D, causal, T, route):
    """On a CUDA card: B2/B3 against their tile-exact plain twins (bf16,
    3e-2 of the largest |grad|), each launched once, on the route the
    entry points pick for the head dim (wgmma + TMA for 64 and 128)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card "
                    "(python3 chip_smoke.py covers them there)")
    assert fa.bwd_route(torch.bfloat16, D) == route
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(24, T, D, generator=gen, device="cuda")
                   .bfloat16() for _ in range(4))
    bias = torch.zeros(2, T, device="cuda")
    bias[1, 150:] = fa.MASK_VAL
    o, lse = fa.flash_attention_fwd(q, k, v, bias, causal)
    before = fa.launch_counts()
    grads = fa.flash_attention_bwd(q, k, v, bias, o, lse, do, causal)
    after = fa.launch_counts()
    assert after["launches_dkv"] == before["launches_dkv"] + 1
    assert after["launches_dq"] == before["launches_dq"] + 1
    refs = fa.flash_attention_bwd_plain(q, k, v, bias, o, lse, do, causal,
                                        causal_tile=fa.CAUSAL_TILE)
    for got, ref in zip(grads, refs):
        err = (got.float() - ref.float()).abs().max()
        assert err <= BF16_TOL * ref.float().abs().max()
