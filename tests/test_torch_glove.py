"""The port's GloVe against the JAX package.

The same numpy-seeded inputs go through JAX (``nlp/glove._glove_update``,
its plain path, and ``ops/pallas_glove.fused_glove_chunk`` interpreted on
the CPU) and through the port's plain twin ``fused_glove_chunk_plain``
plus ``apply_chunk``, which is what the port runs for CPU tensors and
what ``chip_smoke.py`` holds kernel B5 against on the card.

Tolerances:
- co-occurrence triples: equal;
- the chunk path against JAX's ``_glove_update``: 1e-6 for weights and
  biases, rtol 1e-5 for the AdaGrad sums (both fp32; the same algebra
  with the sums taken in another order);
- against the interpreted Pallas kernel: the JAX test's own bounds
  (tests/test_nlp_glove_pv.py:176-193), atol 2e-3 for weights and
  biases and rtol 3e-2 / atol 5e-3 for the AdaGrad sums, since that
  kernel rounds its payloads to bf16;
- whole fits from the same initial weights (and JAX's permutation when
  there is more than one chunk): 1e-6, AdaGrad sums rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import glove as jg
from deeplearning4j_tpu.nlp.text import DefaultTokenizerFactory as JTok
from deeplearning4j_tpu.nlp.vocab import build_vocab as jbuild_vocab
from deeplearning4j_tpu.ops import pallas_glove as jpg
from deeplearning4j_tpu_torch.nlp import glove as tg
from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory as TTok
from deeplearning4j_tpu_torch.nlp.vocab import build_vocab as tbuild_vocab
from deeplearning4j_tpu_torch.ops import fused_glove as fg

torch.set_num_threads(2)

CORPUS = ["the cat sat on the mat", "the dog sat on the rug",
          "a cat and a dog are friends",
          "a king and a queen wear crowns"] * 30


@pytest.mark.parametrize("window,symmetric", [(5, True), (3, False)])
def test_cooccurrence_triples_equal(window, symmetric):
    jc = jbuild_vocab(CORPUS, JTok(), 1)
    tc = tbuild_vocab(CORPUS, TTok(), 1)
    assert tc.index == jc.index
    ref = jg.count_cooccurrences(CORPUS, JTok(), jc, window, symmetric)
    got = tg.count_cooccurrences(CORPUS, TTok(), tc, window, symmetric)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _chunk(V=64, D=32, B=128, seed=0):
    """tests/test_nlp_glove_pv.py's kernel-test inputs, as numpy."""
    rng = np.random.RandomState(seed)
    w, wt = (rng.randn(V, D).astype(np.float32) * 0.1 for _ in range(2))
    b, bt = (rng.randn(V).astype(np.float32) * 0.1 for _ in range(2))
    state = (w, wt, b, bt, np.full((V, D), 1e-8, np.float32),
             np.full((V, D), 1e-8, np.float32), np.full(V, 1e-8, np.float32),
             np.full(V, 1e-8, np.float32))
    rows = rng.randint(0, V, B).astype(np.int32)
    cols = rng.randint(0, V, B).astype(np.int32)
    x = rng.rand(B).astype(np.float32) * 50 + 1
    mask = (rng.rand(B) < 0.9).astype(np.float32)
    return state, rows, cols, x, mask


def _port_chunk(state, rows, cols, x, mask, alpha):
    """The port's chunk path (glove_epoch's body) on CPU tensors."""
    st = tuple(torch.from_numpy(a) for a in state)
    wext, wtext, gext, gtext = tg.to_extended(st)
    D = wext.shape[1] - 2
    accw, accwt, ls = fg.fused_glove_chunk(
        wext, wtext, *(torch.from_numpy(a) for a in (rows, cols, x, mask)),
        x_max=100.0, power=0.75)
    wb, gwb = fg.apply_chunk(wext[:, :D + 1], gext, accw, alpha)
    wtb, gwtb = fg.apply_chunk(torch.cat([wtext[:, :D], wtext[:, D + 1:]],
                                         1), gtext, accwt, alpha)
    return (wb[:, :D], wtb[:, :D], wb[:, D], wtb[:, D], gwb[:, :D],
            gwtb[:, :D], gwb[:, D], gwtb[:, D]), ls


def test_chunk_path_matches_jax_update_and_pallas():
    state, rows, cols, x, mask = _chunk()
    alpha = 0.05
    got, ls = _port_chunk(state, rows, cols, x, mask, alpha)

    j = (jnp.asarray(a) for a in (rows, cols, x, mask))
    ref, ref_loss = jg._glove_update(tuple(jnp.asarray(a) for a in state),
                                     *j, jnp.float32(alpha), 100.0, 0.75)
    for k, (g, r) in enumerate(zip(got, ref)):
        if k < 4:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                       atol=1e-6)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-9)
    np.testing.assert_allclose(float(ls[0, 0] / ls[0, 1]), float(ref_loss),
                               rtol=1e-6)
    # the port's own plain scatter step agrees with JAX's
    port_ref, port_loss = tg._glove_update(
        tuple(torch.from_numpy(a) for a in state),
        *(torch.from_numpy(a) for a in (rows, cols, x, mask)), alpha, 100.0,
        0.75)
    for g, r in zip(port_ref, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)
    assert float(port_loss) == pytest.approx(float(ref_loss), rel=1e-6)

    # the interpreted Pallas kernel + apply_chunk, within its test's bounds
    w, wt, b, bt, gw, gwt, gb, gbt = (jnp.asarray(a) for a in state)
    ones = jnp.ones((w.shape[0], 1), jnp.float32)
    D = w.shape[1]
    accw, accwt, _ = jpg.fused_glove_chunk(
        jnp.concatenate([w, b[:, None], ones], 1),
        jnp.concatenate([wt, ones, bt[:, None]], 1),
        *(jnp.asarray(a) for a in (rows, cols, x, mask)), x_max=100.0,
        power=0.75, block=64, interpret=True)
    wb, gwb = jpg.apply_chunk(jnp.concatenate([w, b[:, None]], 1),
                              jnp.concatenate([gw, gb[:, None]], 1), accw,
                              jnp.float32(alpha))
    wtb, gwtb = jpg.apply_chunk(jnp.concatenate([wt, bt[:, None]], 1),
                                jnp.concatenate([gwt, gbt[:, None]], 1),
                                accwt, jnp.float32(alpha))
    pallas = (wb[:, :D], wtb[:, :D], wb[:, D], wtb[:, D], gwb[:, :D],
              gwtb[:, :D], gwb[:, D], gwtb[:, D])
    for k, (g, p) in enumerate(zip(got, pallas)):
        if k < 4:
            np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=2e-3)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=3e-2,
                                       atol=5e-3)


def _init(V, D, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(V, D).astype(np.float32) * 0.1,
            rng.randn(V, D).astype(np.float32) * 0.1,
            np.zeros(V, np.float32), np.zeros(V, np.float32),
            np.full((V, D), 1e-8, np.float32),
            np.full((V, D), 1e-8, np.float32),
            np.full(V, 1e-8, np.float32), np.full(V, 1e-8, np.float32))


@pytest.mark.parametrize("batch", [4096, 16])
def test_glove_fit_matches_jax(batch):
    """One chunk holds every triple at batch 4096 (no permutation
    matters); at batch 16 the port is given JAX's permutations."""
    cfg = dict(vector_size=8, epochs=3, batch_size=batch)
    j = jg.Glove(CORPUS, jg.GloveConfig(kernel="xla", **cfg))
    jc = jbuild_vocab(CORPUS, JTok(), 1)
    init = _init(len(jc), 8)
    j.fit(initial_weights=init)
    t = tg.Glove(CORPUS, tg.GloveConfig(**cfg), device="cpu")
    if batch < 4096:
        key = jax.random.key(13)
        t._shuffles = lambda epoch, n: np.array(
            jax.random.permutation(jax.random.fold_in(key, epoch), n))
    t.fit(initial_weights=init)
    assert t.kernel_used == "plain" and t.chunks > 0
    for k, (g, r) in enumerate(zip(t.state, j.state)):
        if k < 4:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                       atol=1e-6)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                       atol=1e-8)
    assert t.losses == pytest.approx(j.losses, rel=1e-5)
    np.testing.assert_allclose(t.word_vectors.vectors.numpy(),
                               np.asarray(j.word_vectors.vectors), atol=2e-6)


def test_glove_devices_and_kernel_modes_raise_where_they_must():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tg.Glove(CORPUS)
    with pytest.raises(ValueError, match="kernel='cuda'"):
        tg.Glove(CORPUS, tg.GloveConfig(vector_size=8, epochs=1,
                                        kernel="cuda"), device="cpu").fit()
    with pytest.raises(NotImplementedError, match="A9"):
        tg.Glove(CORPUS, tg.GloveConfig(vector_size=8, epochs=1),
                 device="cpu").fit(mesh=object())
    state, rows, cols, x, mask = _chunk()
    wext, wtext, _, _ = tg.to_extended(tuple(torch.from_numpy(a)
                                             for a in state))
    before = fg.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fg.fused_glove_chunk_cuda(
            wext, wtext, *(torch.from_numpy(a) for a in (rows, cols, x,
                                                         mask)),
            x_max=100.0, power=0.75)
    assert fg.launches == before


@pytest.mark.parametrize("dim", [8, 100, 510, 600, 1024])
def test_auto_takes_the_kernel_for_cuda_tensors_at_any_width(dim):
    """B5 takes every width (extended rows past 512 take its wide path),
    so auto never gives way to the plain twin on the card."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tg._resolve("auto", dim, cuda, 4096) == "cuda"
    assert tg._resolve("cuda", dim, cuda, 4096) == "cuda"
    assert tg._resolve("auto", dim, cpu, 4096) == "plain"
    assert tg._resolve("plain", dim, cuda, 4096) == "plain"


def test_glove_converges_on_cpu():
    g = tg.Glove(CORPUS, tg.GloveConfig(vector_size=16, epochs=15,
                                        batch_size=64), device="cpu")
    g.fit()
    assert g.losses[-1] < g.losses[0]
    assert all(np.isfinite(g.losses))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_twin():
    """On a CUDA card: B5 against its plain twin (fp32, unordered
    atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the card "
                    "(python3 chip_smoke.py covers it there)")
    state, rows, cols, x, mask = _chunk()
    wext, wtext, _, _ = tg.to_extended(tuple(torch.from_numpy(a).cuda()
                                             for a in state))
    args = (wext, wtext) + tuple(torch.from_numpy(a).cuda()
                                 for a in (rows, cols, x, mask))
    before = fg.launches
    got = fg.fused_glove_chunk(*args, x_max=100.0, power=0.75)
    assert fg.launches == before + 1
    ref = fg.fused_glove_chunk_plain(*args, x_max=100.0, power=0.75)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_kernel_wide_rows_match_plain_twin():
    """On a CUDA card: B5's wide path (D + 2 > 512) against its plain
    twin (fp32, unordered atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the card "
                    "(python3 chip_smoke.py covers it there)")
    state, rows, cols, x, mask = _chunk(D=600)
    wext, wtext, _, _ = tg.to_extended(tuple(torch.from_numpy(a).cuda()
                                             for a in state))
    args = (wext, wtext) + tuple(torch.from_numpy(a).cuda()
                                 for a in (rows, cols, x, mask))
    got = fg.fused_glove_chunk_cuda(*args, x_max=100.0, power=0.75)
    ref = fg.fused_glove_chunk_plain(*args, x_max=100.0, power=0.75)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


# -- the fused chunk step ----------------------------------------------------

def _old_epoch_chunk(ext, rows, cols, x, mask, alpha):
    """One chunk of glove_epoch as it was before the fused step: the
    accumulator mode, two apply_chunk calls, the cat and the slice
    writes into the tables."""
    wext, wtext, gext, gtext = (t.clone() for t in ext)
    D = wext.shape[1] - 2
    accw, accwt, ls = fg.fused_glove_chunk_plain(wext, wtext, rows, cols, x,
                                                 mask, x_max=100.0,
                                                 power=0.75)
    wb, gext = fg.apply_chunk(wext[:, :D + 1], gext, accw, alpha)
    wtb, gtext = fg.apply_chunk(
        torch.cat([wtext[:, :D], wtext[:, D + 1:]], dim=1), gtext, accwt,
        alpha)
    wext[:, :D + 1] = wb
    wtext[:, :D] = wtb[:, :D]
    wtext[:, D + 1] = wtb[:, D]
    return (wext, wtext, gext, gtext), ls


def _step_inputs(D=32, seed=0):
    state, rows, cols, x, mask = _chunk(D=D, seed=seed)
    ext = tg.to_extended(tuple(torch.from_numpy(a) for a in state))
    return ext, tuple(torch.from_numpy(a) for a in (rows, cols, x, mask))


@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_step_plain_equals_the_old_epoch_composition(seed):
    ext, tri = _step_inputs(seed=seed)
    *got, ls = fg.glove_chunk_step_plain(*ext, *tri, 0.05, x_max=100.0,
                                         power=0.75)
    ref, ref_ls = _old_epoch_chunk(ext, *tri, 0.05)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert torch.equal(ls, ref_ls)


def test_chunk_step_plain_leaves_untouched_rows_bit_identical():
    """A row no live triple touches has sums 0 and count 0: the AdaGrad
    step leaves its bits alone, so B5 updates only the touched rows."""
    ext, (rows, cols, x, mask) = _step_inputs()
    rows, cols = rows[:20], cols[:20]
    x, mask = x[:20], mask[:20]
    *got, _ = fg.glove_chunk_step_plain(*ext, rows, cols, x, mask, 0.05,
                                        x_max=100.0, power=0.75)
    V = ext[0].shape[0]
    for side, idx in ((0, rows), (1, cols)):
        hit = torch.zeros(V, dtype=torch.bool)
        hit[idx[mask != 0].long()] = True
        assert (~hit).any()
        for old, new in ((ext[side], got[side]),
                         (ext[side + 2], got[side + 2])):
            assert torch.equal(new[~hit], old[~hit])
            assert not torch.equal(new[hit], old[hit])


def test_refit_leaves_an_earlier_word_vectors_unchanged():
    g = tg.Glove(CORPUS, tg.GloveConfig(vector_size=8, epochs=2,
                                        batch_size=64), device="cpu")
    first = g.fit()
    kept = first.vectors.clone()
    state = tuple(t.clone() for t in g.state)
    g.fit(initial_weights=g.state)
    assert torch.equal(first.vectors, kept)
    for a, b in zip(state, g.state):
        assert not torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 600])
def test_cuda_chunk_step_matches_plain_twin_in_place(D):
    """On a CUDA card: glove_chunk_step_cuda updates the tables it is
    given (narrow and wide paths) as glove_chunk_step_plain computes
    them, and launches B5 once."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the card "
                    "(python3 chip_smoke.py covers it there)")
    ext, tri = _step_inputs(D=D)
    ext = tuple(t.cuda() for t in ext)
    tri = tuple(t.cuda() for t in tri)
    *ref, ref_ls = fg.glove_chunk_step_plain(*ext, *tri, 0.05, x_max=100.0,
                                             power=0.75)
    tables = [t.clone() for t in ext]
    before = fg.launches
    *got, ls = fg.glove_chunk_step_cuda(*tables, *tri, 0.05, x_max=100.0,
                                        power=0.75)
    assert fg.launches == before + 1
    assert all(g is t for g, t in zip(got, tables))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ls, ref_ls, rtol=1e-5, atol=1e-5)
