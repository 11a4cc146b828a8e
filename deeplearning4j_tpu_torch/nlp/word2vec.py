"""Word2Vec — skip-gram with hierarchical softmax + negative sampling.

Port of ``deeplearning4j_tpu/nlp/word2vec.py`` (reference parity:
``Word2Vec.java`` and ``InMemoryLookupTable.iterateSample``).  Whole
[B]-pair chunks train through one call of
``ops/fused_word2vec`` each: kernel B4 on CUDA tensors of any width,
its plain twin on CPU tensors (or when ``kernel="plain"``).

- Pair generation is the JAX package's numpy code, copied: candidate
  pairs at the full window are built once per corpus and cached
  (``pair_mode="masked"``, the dynamic window shrink a per-epoch mask on
  the device), re-drawn on the host every epoch (``"exact"``), or built
  on the device from the uploaded token stream (``"device"``).
- The JAX package's ``lax.scan`` over chunks (``_scan_slab`` :161,
  ``_stream_epoch_scan`` :282) becomes a Python loop over chunks here,
  each chunk one call of a function captured by the compile engine
  (``runtime/compile_cache``: ``word2vec.pair_chunk`` and
  ``word2vec.stream_chunk``, one CUDA graph a chunk shape on the card,
  B4 inside it).  Everything that changes from chunk to chunk reaches
  it on the device: the chunk index (a counter the graph advances), the
  slab's arrays, the per-chunk learning rates (computed on the host in
  fp32 as JAX does, uploaded once a slab and epoch), the epoch's shrink
  seed; negatives are drawn inside the graph from the run's generator.
  The tables are donated: the graph updates the engine's copy of them
  in place, and a fit clones them at its end, which frees that copy for
  the next fit.  The plain path's ``_hs_update``/``_neg_update`` (:98, :129)
  are ``ops/fused_word2vec.hs_update``/``neg_update``, B4's plain
  twin.
- ``_hash_shrink`` computes JAX's uint32 hash in int64 with a mask after
  every step (torch has no general uint32 multiply), bit-equal to it.
- Random draws: the per-epoch window-shrink seed and the negatives come
  from :class:`Draws` (a ``torch.Generator`` seeded from
  ``config.seed`` on the run's device).  They cannot equal JAX's
  ``jax.random`` draws, so the engine functions take ``draws=`` and the
  tests hand over JAX's values through it.
- Not ported here: ``fit(mesh=...)`` and ``make_dp_stream_epoch``
  (ROADMAP A7); the TPU block rounding of the device mode's chunk
  (:460-465, :499-513): the port takes the JAX plain path's granularity.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import (VocabCache, build_huffman,
                                                build_vocab, encode_hs_tables,
                                                unigram_table)
from deeplearning4j_tpu_torch.nlp.word_vectors import WordVectors
from deeplearning4j_tpu_torch.ops import fused_word2vec as fw
from deeplearning4j_tpu_torch.ops import kernel_select as ks
from deeplearning4j_tpu_torch.ops.updaters import copy_into
from deeplearning4j_tpu_torch.runtime import compile_cache

Tensor = torch.Tensor


@dataclasses.dataclass
class Word2VecConfig:
    vector_size: int = 100
    window: int = 5
    min_word_frequency: int = 1
    alpha: float = 0.025
    min_alpha: float = 1e-4
    negative: int = 0           # 0 => hierarchical softmax only
    use_hs: bool = True
    epochs: int = 1
    batch_size: int = 2048
    seed: int = 42
    table_size: int = 100_000
    #: "auto" takes kernel B4 for CUDA tensors and the plain twin for CPU
    #: tensors; "cuda" demands B4 (raises on the CPU); "plain" forces the
    #: plain twin on any device
    kernel: str = "auto"
    #: >1 partitions pairs by center Huffman depth into that many
    #: buckets with per-bucket sliced HS tables (exact semantics)
    depth_buckets: int = 1
    #: "masked", "exact" or "device" (see the module docstring)
    pair_mode: str = "masked"


# -- random draws -----------------------------------------------------------

class Draws:
    """The run's random draws: one window-shrink seed per epoch and the
    negative-sample indices of each chunk, from a ``torch.Generator``
    seeded with ``seed + 1`` (JAX's ``jax.random.key(seed + 1)``) on
    ``device``.  An object with the same two methods can stand in (the
    tests pass JAX's draws)."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed + 1)

    def seed32(self, epoch: int) -> int:
        """The epoch's shrink seed, in [0, 2^31 - 1)."""
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.gen,
                                 device=self.device).item())

    def negatives(self, epoch: int, chunk: int, shape: Tuple[int, int],
                  n: int) -> Tensor:
        """Indices into the unigram table for chunk ``chunk``."""
        return torch.randint(0, n, shape, generator=self.gen,
                             device=self.device)


_M32 = 0xFFFFFFFF


def _mul32(h: Tensor, c: int) -> Tensor:
    """``h * c mod 2^32`` for int64 ``h`` in [0, 2^32): split ``c`` in
    16-bit halves so no product leaves int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_shrink(pos: Tensor, seed32, window: int) -> Tensor:
    """Stateless per-(epoch, position) window-shrink draw (:270-279): a
    Wang-style integer hash of the position in uint32 arithmetic, done
    in int64 with ``& 0xFFFFFFFF`` after each step.  ``seed32`` is an
    int or an int64 tensor of one value."""
    h = (_mul32(pos.long() & _M32, 2654435761) + seed32) & _M32
    h = _mul32(h ^ (h >> 16), 2246822519)
    h = _mul32(h ^ (h >> 13), 3266489917)
    return ((h ^ (h >> 16)) % window).to(torch.int32)


# -- one chunk ----------------------------------------------------------------

def _update(state, inputs, targets, pmask, alpha, hs_tables, table, negs,
            gen, *, use_hs: bool, negative: int, impl: str):
    """One chunk's update of the donated ``state`` (syn0, syn1, syn1neg),
    in place: gather the centers' Huffman rows, map the negatives (given
    indices into the unigram table, or drawn here from ``gen``), run B4
    or its plain twin, and write the result into ``state``."""
    dev = inputs.device
    B = inputs.shape[0]
    if use_hs:
        c_t, p_t, m_t = hs_tables
        tl = targets.long()
        hs = (c_t[tl], p_t[tl], m_t[tl])
    else:
        hs = (torch.zeros((B, 1), device=dev),
              torch.zeros((B, 1), dtype=torch.int32, device=dev),
              torch.zeros((B, 1), device=dev))
    if negative > 0:
        if negs is None:
            negs = torch.randint(0, table.shape[0], (B, negative),
                                 generator=gen, device=dev)
        negs = table[negs.long()]
    else:
        negs = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    update = (fw.fused_chunk_update_cuda if impl == "cuda"
              else fw.fused_chunk_update_plain)
    new = update(*state, inputs, targets, *hs, negs, pmask, alpha,
                 use_hs=use_hs, negative=negative)
    copy_into(state, new)
    return state


def _pair_chunk(state, c, cen, ctx, cpos, dlt, n_real, alphas, seed32,
                hs_tables, table, negs, gen, *, window: int,
                window_mask: bool, use_hs: bool, negative: int, impl: str):
    """Chunk ``c`` (a ``[1]`` device counter, advanced here) of a pair
    slab ``[NC, B]``: its pad and window-shrink mask, its learning rate
    ``alphas[c]``, and :func:`_update`."""
    B = cen.shape[1]
    pm = (torch.arange(B, device=cen.device)
          < n_real.index_select(0, c)).float()
    if window_mask:
        shrink = window - _hash_shrink(cpos.index_select(0, c)[0], seed32,
                                       window)
        pm = (dlt.index_select(0, c)[0].abs() <= shrink).float() * pm
    # pairs of pair_mode="exact" arrive pre-shrunk: all real train
    state = _update(state, ctx.index_select(0, c)[0],
                    cen.index_select(0, c)[0], pm, alphas.index_select(0, c),
                    hs_tables, table, negs, gen, use_hs=use_hs,
                    negative=negative, impl=impl)
    c.add_(1)
    return state, c


def _stream_chunk(state, i, tok, sid, alphas, seed32, hs_tables, table,
                  negs, gen, *, pos_chunk: int, window: int, use_hs: bool,
                  negative: int, impl: str):
    """Chunk ``i`` (a ``[1]`` device counter, advanced here) of the
    uploaded token stream (``_stream_epoch_scan``, :282-370): its
    ``pos_chunk`` positions' pairs built on the device — contexts at the
    2W signed offsets, sentence boundaries through a separator-count
    sentence id, the window shrink through :func:`_hash_shrink` — then
    :func:`_update`."""
    dev = tok.device
    n_pad = tok.shape[0]
    deltas = torch.cat([torch.arange(-window, 0, device=dev),
                        torch.arange(1, window + 1, device=dev)])
    W2 = 2 * window
    B = pos_chunk * W2
    pos = i * pos_chunk + torch.arange(pos_chunk, device=dev)
    cen = tok[pos]
    j = pos[:, None] + deltas[None, :]                      # [P, 2W]
    jc = j.clamp(0, n_pad - 1)
    ctx = tok[jc]
    valid = ((j >= 0) & (cen[:, None] >= 0) & (ctx >= 0)
             & (sid[jc] == sid[pos][:, None]))
    shrink = window - _hash_shrink(pos, seed32, window)
    m = valid & (deltas.abs()[None, :] <= shrink[:, None])
    state = _update(state, ctx.clamp_min(0).reshape(B),
                    cen.clamp_min(0)[:, None].expand(pos_chunk, W2)
                    .reshape(B), m.reshape(B).float(),
                    alphas.index_select(0, i), hs_tables, table, negs, gen,
                    use_hs=use_hs, negative=negative, impl=impl)
    i.add_(1)
    return state, i


class _Chunks:
    """What every chunk of a run shares: the device, the implementation,
    the tables it gathers from, the draws, and the engine's two chunk
    entries (shared module-wide: they close over nothing)."""

    def __init__(self, dev, impl, B, codes_t, points_t, mask_t, table,
                 use_hs, negative, draws):
        self.dev, self.B, self.impl = dev, B, impl
        self.use_hs, self.negative, self.draws = use_hs, negative, draws
        self.hs_tables = (torch.as_tensor(codes_t, dtype=torch.float32,
                                          device=dev),
                          torch.as_tensor(points_t, dtype=torch.int32,
                                          device=dev),
                          torch.as_tensor(mask_t, dtype=torch.float32,
                                          device=dev))
        self.table = torch.as_tensor(np.asarray(table), dtype=torch.int32,
                                     device=dev)
        self.pair_step = compile_cache.cached_graph(
            _pair_chunk, key="word2vec.pair_chunk",
            label="word2vec.pair_chunk", donate_argnums=(0, 1))
        self.stream_step = compile_cache.cached_graph(
            _stream_chunk, key="word2vec.stream_chunk",
            label="word2vec.stream_chunk", donate_argnums=(0, 1))
        self.count = 0

    def seed32(self, epoch: int) -> Tensor:
        """The epoch's shrink seed, as an int64 tensor on the device."""
        return torch.tensor([self.draws.seed32(epoch)],
                            dtype=torch.int64).to(self.dev)

    def negatives(self, epoch: int, chunk: int):
        """``(negs, gen)`` of a chunk: the port's :class:`Draws` draw
        inside the chunk from their generator; other draws (the tests
        hand JAX's over) come as indices into the unigram table."""
        if self.negative <= 0:
            return None, None
        if isinstance(self.draws, Draws):
            return None, self.draws.gen
        draws = self.draws.negatives(epoch, chunk, (self.B, self.negative),
                                     self.table.shape[0])
        return torch.as_tensor(draws, device=self.dev), None

    def consts(self):
        return dict(use_hs=self.use_hs, negative=self.negative,
                    impl=self.impl)


def _resolve(kernel: str, dim: int, dev: torch.device, B: int) -> str:
    """B4 takes every width, so ``auto`` launches it on any CUDA
    tensors."""
    return ks.resolve_kernel(kernel, aligned=True,
                             on_cuda=dev.type == "cuda",
                             desc=f"word2vec dim {dim} (batch {B})")


def _alphas(alpha0, min_alpha, frac: np.ndarray, dev) -> Tensor:
    """``max(min_alpha, alpha0 * (1 - frac))`` in float32, as JAX does,
    for an fp32 array of decay fractions: one learning rate a chunk, on
    ``dev``."""
    f32 = np.float32
    a = np.maximum(f32(min_alpha),
                   f32(alpha0) * (f32(1.0) - frac.astype(f32)))
    return torch.from_numpy(a.astype(f32)).to(dev)


# -- pair_mode="device" -------------------------------------------------------

def _stream_epoch(state, cache, chunks: _Chunks, epoch: int, n_epochs: int,
                  alpha0, min_alpha, window: int):
    """One epoch over the uploaded token stream (``_stream_epoch_scan``,
    :282-370): one :func:`_stream_chunk` a chunk of ``pos_chunk``
    positions."""
    dev = chunks.dev
    pos_chunk, n_chunks = cache["pos_chunk"], cache["n_chunks"]
    seed32 = chunks.seed32(epoch)
    f32 = np.float32
    nf = f32(cache["n_stream"])
    span = max(nf * f32(max(n_epochs, 1)), f32(1.0))
    p0 = (np.arange(n_chunks) * pos_chunk).astype(f32)
    alphas = _alphas(alpha0, min_alpha, (f32(epoch) * nf + p0) / span, dev)
    i = torch.zeros(1, dtype=torch.int64, device=dev)
    for c in range(n_chunks):
        negs, gen = chunks.negatives(epoch, c)
        state, i = chunks.stream_step(
            state, i, cache["tok"], cache["sid"], alphas, seed32,
            chunks.hs_tables, chunks.table, negs, gen, pos_chunk=pos_chunk,
            window=window, **chunks.consts())
        chunks.count += 1
    return state


def run_stream_training(syn0, syn1, syn1neg, indexed, *,
                        vocab_size, dim, epochs, codes_t, points_t,
                        mask_t, table, window, alpha, min_alpha, use_hs,
                        negative, batch_size, kernel, seed,
                        stream_cache=None, draws=None):
    """pair_mode="device" engine (:444-583, without ``mesh``): upload the
    separator-delimited token stream once, then one :func:`_stream_epoch`
    per epoch.  The chunk is the JAX plain path's ``fine`` granularity
    (:487): ``max(8, (batch_size // 2W) // 8 * 8)`` positions.  Returns
    ``(syn0, syn1, syn1neg, stream_cache, kernel_used, chunks)``."""
    dev = syn0.device
    W2 = 2 * window
    pos_chunk = max(8, (batch_size // W2) // 8 * 8)
    B = pos_chunk * W2
    impl = _resolve(kernel, dim, dev, B)
    if stream_cache is None:
        n_stream = int(sum(a.size + 1 for a in indexed))
        NC = max(1, -(-n_stream // pos_chunk))
        stream = np.full(NC * pos_chunk, -1, np.int32)
        off = 0
        for a in indexed:
            stream[off:off + a.size] = a
            off += a.size + 1
        tok = torch.as_tensor(stream, device=dev).long()
        stream_cache = {"tok": tok, "sid": torch.cumsum(tok < 0, 0),
                        "n_stream": n_stream, "n_chunks": NC,
                        "pos_chunk": pos_chunk}
    if stream_cache["pos_chunk"] != pos_chunk:
        raise ValueError("stream cache built for a different batch "
                         "size; refit with a fresh instance")
    had_neg = syn1neg is not None
    if not had_neg:
        syn1neg = torch.zeros((1, dim), device=dev)
    chunks = _Chunks(dev, impl, B, codes_t, points_t, mask_t, table, use_hs,
                     negative, draws or Draws(seed, dev))
    state = (syn0, syn1, syn1neg)
    for epoch in range(epochs):
        state = _stream_epoch(state, stream_cache, chunks, epoch, epochs,
                              alpha, min_alpha, window)
    # the boundary: the graph's buffers stay with the engine
    syn0, syn1, syn1neg = (t.clone() for t in state)
    return (syn0, syn1, syn1neg if had_neg else None, stream_cache, impl,
            chunks.count)


# -- host-side pair generation (numpy, copied) -------------------------------

def sentence_pairs(idx: np.ndarray, window: int,
                   rng: np.random.RandomState
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(center, context) pairs with per-position dynamic window shrink
    (skipGram:314's b = rand % window), vectorized."""
    n = idx.shape[0]
    if n < 2:
        return (np.empty(0, np.int32),) * 2
    b = rng.randint(0, window, size=n)
    deltas = np.concatenate([np.arange(-window, 0),
                             np.arange(1, window + 1)])      # [2W]
    pos = np.arange(n)
    j = pos[:, None] + deltas[None, :]                        # [n, 2W]
    valid = ((np.abs(deltas)[None, :] <= (window - b)[:, None])
             & (j >= 0) & (j < n))
    ci, di = np.nonzero(valid)            # row-major: same order as the
    return (idx[ci].astype(np.int32),     # reference's per-pos j sweep
            idx[j[ci, di]].astype(np.int32))


def corpus_pairs(indexed: Sequence[np.ndarray], window: int,
                 slab: int = 1 << 20
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                            np.ndarray]:
    """CANDIDATE (center, context) pairs for the whole corpus at the FULL
    window: (centers, contexts, center_pos, delta, word_offset), the
    last the words-seen count at the pair's sentence (the lr clock)."""
    outs = list(_corpus_pair_blocks(indexed, window, slab))
    if not outs:
        return (np.empty(0, np.int32),) * 4 + (np.empty(0, np.int64),)
    return tuple(np.concatenate([o[k] for o in outs])        # type: ignore
                 for k in range(5))


def _corpus_pair_blocks(indexed: Sequence[np.ndarray], window: int,
                        slab: int = 1 << 20, shrink_rng=None):
    """Yield candidate-pair 5-tuples per position slab; ``shrink_rng``
    applies the dynamic window shrink on the host (pair_mode="exact")."""
    if not indexed:
        return
    tok = np.concatenate(indexed).astype(np.int32)
    lens = np.asarray([a.size for a in indexed])
    sid = np.repeat(np.arange(len(indexed)), lens)
    # words seen AFTER each sentence, int64 (float32 loses integers past
    # 2^24 corpus words)
    seen_after = np.cumsum(lens, dtype=np.int64)
    word_off = seen_after[sid] - lens[sid]
    n = tok.size
    deltas = np.concatenate([np.arange(-window, 0),
                             np.arange(1, window + 1)]).astype(np.int32)
    for s0 in range(0, n, slab):
        s1 = min(n, s0 + slab)
        pos = np.arange(s0, s1, dtype=np.int32)
        j = pos[:, None] + deltas[None, :]                   # [S, 2W] i32
        jc = np.clip(j, 0, n - 1)
        valid = (j >= 0) & (j < n) & (sid[jc] == sid[s0:s1, None])
        if shrink_rng is not None:
            b = shrink_rng.randint(0, window, size=s1 - s0)
            valid &= np.abs(deltas)[None, :] <= (window - b)[:, None]
        ci, di = np.nonzero(valid)
        p = pos[ci]
        yield (tok[p], tok[j[ci, di]], p.astype(np.int32),
               deltas[di], word_off[p])


def corpus_pairs_slabs(indexed: Sequence[np.ndarray], window: int,
                       pairs_per_slab: int, shrink_rng=None):
    """Yield ``corpus_pairs``-shaped blocks of exactly ``pairs_per_slab``
    pairs (the last may be shorter)."""
    bufs: List[Tuple[np.ndarray, ...]] = []
    n = 0
    pos_slab = max(1024, pairs_per_slab // (8 * window))
    for arr_slab in _corpus_pair_blocks(indexed, window, pos_slab,
                                        shrink_rng):
        bufs.append(arr_slab)
        n += arr_slab[0].size
        while n >= pairs_per_slab:
            cat = tuple(np.concatenate([b[k] for b in bufs])
                        for k in range(5))
            yield tuple(a[:pairs_per_slab] for a in cat)
            bufs = [tuple(a[pairs_per_slab:] for a in cat)]
            n -= pairs_per_slab
    if n:
        yield tuple(np.concatenate([b[k] for b in bufs]) for k in range(5))


#: pairs per slab — bounds host buffers and upload sizes
PAIRS_PER_SLAB = 1 << 22
#: total pairs kept device-resident across epochs (beyond: host numpy,
#: uploaded once per slab per epoch)
RESIDENT_PAIR_CAP = 32 * (1 << 20)


def run_pair_training(syn0, syn1, syn1neg,
                      pairs=None, *,
                      vocab_size, dim, epochs,
                      total_words, codes_t, points_t,
                      mask_t, table, window,
                      alpha, min_alpha, use_hs,
                      negative, batch_size, kernel,
                      seed, dev_cache=None, pairs_iter=None,
                      pairs_iter_factory=None, window_mask=True,
                      hs_lengths=None, hs_weights=None, depth_buckets=1,
                      draws=None):
    """The shared slab engine (:707-946); Word2Vec AND ParagraphVectors
    fit through here.  Pairs (the ``corpus_pairs`` layout, plus any
    always-train pairs encoded with delta = 0) arrive materialized
    (``pairs``), as a stream of blocks (``pairs_iter``: epoch 0 streams
    them and caches the prepared slabs for replay), or fresh every epoch
    (``pairs_iter_factory(epoch)``, pair_mode="exact", no cache).  Each
    slab trains as a loop over [B] chunks, one chunk update each.
    Returns ``(syn0, syn1, syn1neg, dev_cache, kernel_used, chunks)``;
    thread ``dev_cache`` back in to replay the slabs on later fits."""
    dev = syn0.device
    B = batch_size
    impl = _resolve(kernel, dim, dev, B)
    if epochs <= 0:
        return syn0, syn1, syn1neg, dev_cache, impl, 0
    total = max(1, total_words * epochs)
    neg_tab = (syn1neg if syn1neg is not None
               else torch.zeros((1, dim), device=dev))
    chunks = _Chunks(dev, impl, B, codes_t, points_t, mask_t, table, use_hs,
                     negative, draws or Draws(seed, dev))
    f32 = np.float32
    epoch_frac = f32(total_words / total)

    # -- depth buckets (opt-in): pairs grouped by center Huffman depth
    # train against HS tables sliced to the bucket's depth (levels past a
    # pair's depth are masked zeros, so only chunk grouping changes)
    n_buckets = max(1, depth_buckets) if (use_hs and hs_lengths is not None
                                          ) else 1
    full_l = int(np.asarray(codes_t).shape[1])
    if n_buckets > 1:
        hs_len = np.asarray(hs_lengths)
        w = (np.asarray(hs_weights, np.float64)
             if hs_weights is not None else np.ones_like(hs_len, float))
        order = np.argsort(hs_len)
        cw = np.cumsum(w[order])
        cw /= cw[-1]
        qs = [hs_len[order][np.searchsorted(cw, i / n_buckets)]
              for i in range(1, n_buckets)]
        bounds = sorted(set(int(q) for q in qs) | {full_l})
        bucket_l = [b for b in bounds if b > 0]

        def bucket_of(cen):
            return np.searchsorted(np.asarray(bucket_l),
                                   hs_len[cen], side="left")
    else:
        bucket_l = [full_l]
        bucket_of = None
    tables = [tuple(t[:, :lb] for t in chunks.hs_tables) for lb in bucket_l]

    def prep_slab(blk, resident):
        cen, ctx, cpos, dlt, woff = blk
        P = cen.size
        NC = -(-P // B)
        pad = NC * B - P

        def ch(a):
            if pad:
                a = np.concatenate([a, np.zeros(pad, a.dtype)])
            a = a.reshape(NC, B)
            return torch.as_tensor(a, device=dev) if resident else a

        n_real = np.full(NC, B, np.int64)
        n_real[-1] = P - (NC - 1) * B
        # per-chunk lr clock: the word offset at the chunk's first pair as
        # a FRACTION of the decay span, formed in float64
        off_frac = (woff[::B].astype(np.float64) / float(total)
                    ).astype(np.float32)
        return (ch(cen), ch(ctx), ch(cpos), ch(dlt), off_frac, n_real)

    def dispatch(slab, cid0, bidx, epoch, seed32, state):
        cen_d, ctx_d, cpos_d, dlt_d, off_frac, n_real = (
            torch.as_tensor(a, device=dev) if isinstance(a, np.ndarray)
            and a.ndim == 2 else a for a in slab)
        NC = n_real.shape[0]
        n_real_d = torch.from_numpy(n_real).to(dev)
        alphas = _alphas(alpha, min_alpha,
                         f32(epoch) * epoch_frac + off_frac, dev)
        c_d = torch.zeros(1, dtype=torch.int64, device=dev)
        for c in range(NC):
            negs, gen = chunks.negatives(epoch, cid0 + c)
            state, c_d = chunks.pair_step(
                state, c_d, cen_d, ctx_d, cpos_d, dlt_d, n_real_d, alphas,
                seed32, tables[bidx], chunks.table, negs, gen,
                window=window, window_mask=window_mask, **chunks.consts())
            chunks.count += 1
        return state

    state = (syn0, syn1, neg_tab)

    def stream(blocks, epoch, seed32, slabs):
        """Prep and train one epoch's pair blocks; ``slabs`` (a list)
        caches the prepared slabs for replay, None trains without."""
        nonlocal state
        seen_pairs = 0
        cid0 = 0
        bufs: List[List[Tuple[np.ndarray, ...]]] = \
            [[] for _ in range(len(bucket_l))]
        buf_n = [0] * len(bucket_l)

        def record(part, bidx):
            nonlocal seen_pairs, cid0, state
            resident = (slabs is not None
                        and seen_pairs + part[0].size <= RESIDENT_PAIR_CAP)
            slab = prep_slab(part, resident)
            state = dispatch(slab, cid0, bidx, epoch, seed32, state)
            if slabs is not None:
                slabs.append((slab, cid0, bidx))
            seen_pairs += part[0].size
            cid0 += slab[5].shape[0]

        def emit(bidx, blk_b, final):
            bufs[bidx].append(blk_b)
            buf_n[bidx] += blk_b[0].size
            while buf_n[bidx] >= PAIRS_PER_SLAB or (final and buf_n[bidx]):
                cat = tuple(np.concatenate([b[k] for b in bufs[bidx]])
                            for k in range(5))
                take = min(PAIRS_PER_SLAB, cat[0].size)
                bufs[bidx] = [tuple(a[take:] for a in cat)]
                buf_n[bidx] -= take
                record(tuple(a[:take] for a in cat), bidx)
                if final and buf_n[bidx] == 0:
                    break

        empty = tuple(np.empty(0, np.int32) for _ in range(4)) + (
            np.empty(0, np.int64),)
        for blk in blocks:
            if blk[0].size == 0:
                continue
            if len(bucket_l) == 1:
                record(blk, 0)
            else:
                which = bucket_of(blk[0])
                for bidx in range(len(bucket_l)):
                    sel = which == bidx
                    if sel.any():
                        emit(bidx, tuple(a[sel] for a in blk), final=False)
        for bidx in range(len(bucket_l)):
            if buf_n[bidx]:
                emit(bidx, empty, final=True)

    def result(cache):
        # the boundary: the graph's buffers stay with the engine
        syn0, syn1, neg_tab = (t.clone() for t in state)
        return (syn0, syn1, neg_tab if syn1neg is not None else None,
                cache, impl, chunks.count)

    if pairs_iter_factory is not None:
        for epoch in range(epochs):
            stream(pairs_iter_factory(epoch), epoch, chunks.seed32(epoch),
                   None)
        return result(None)

    if dev_cache is not None and dev_cache["bucket_l"] != bucket_l:
        raise ValueError(
            f"cached pair slabs were built for depth buckets "
            f"{dev_cache['bucket_l']} but the config now implies "
            f"{bucket_l}; refit with a fresh instance (or keep "
            f"depth_buckets stable across fits)")
    first_epoch = 0
    if dev_cache is None:
        if pairs_iter is None:
            if pairs is None:
                raise ValueError("need pairs, pairs_iter or dev_cache")
            pairs_iter = (tuple(a[lo:lo + PAIRS_PER_SLAB] for a in pairs)
                          for lo in range(0, pairs[0].size, PAIRS_PER_SLAB))
        dev_cache = {"bucket_l": bucket_l, "slabs": []}
        stream(pairs_iter, 0, chunks.seed32(0), dev_cache["slabs"])
        first_epoch = 1
    for epoch in range(first_epoch, epochs):
        seed32 = chunks.seed32(epoch)
        for slab, cid0, bidx in dev_cache["slabs"]:
            state = dispatch(slab, cid0, bidx, epoch, seed32, state)
    return result(dev_cache)


def prepare_train_tables(cache, table_size: int):
    """Training tables from a built vocab, numpy (:949-960): (codes_t,
    points_t, mask_t, unigram table, hs code lengths)."""
    codes_np, points_np, lengths_t = encode_hs_tables(cache)
    mask_t = hs_mask_table(codes_np, lengths_t)
    return (codes_np, points_np, mask_t, unigram_table(cache, table_size),
            lengths_t)


def hs_mask_table(codes_t: np.ndarray, lengths_t: np.ndarray) -> np.ndarray:
    """[V, L] float32 mask from per-word Huffman path lengths."""
    return (np.arange(codes_t.shape[1])[None, :] <
            np.asarray(lengths_t)[:, None]).astype(np.float32)


def as_table(x, dev: torch.device) -> Tensor:
    """A caller's table (torch, numpy or any array) as a fresh fp32
    tensor on ``dev``: a copy, so training never writes the caller's."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=dev, dtype=torch.float32).clone()
    return torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)


class Word2Vec:
    """fit() -> WordVectors, as ``Word2Vec.java``'s builder usage:
    ``Word2Vec(sentences, Word2VecConfig(...), tokenizer, cache,
    device)``.  ``device=None`` means CUDA and raises without it."""

    def __init__(self, sentences: Iterable[str],
                 config: Optional[Word2VecConfig] = None,
                 tokenizer=None,
                 cache: Optional[VocabCache] = None,
                 device: DeviceLike = None):
        self.config = config or Word2VecConfig()
        self.tokenizer = tokenizer or DefaultTokenizerFactory()
        self.sentences = sentences
        self.cache = cache
        self.device = resolve_device(device)
        self.syn0: Optional[Tensor] = None
        self.syn1: Optional[Tensor] = None
        self.syn1neg: Optional[Tensor] = None
        self._wv: Optional[WordVectors] = None
        self._n_positions = 0       # corpus words (the lr-decay clock)
        self._dev_cache = None      # prepared pair slabs (masked mode)
        self._indexed = None        # indexed corpus
        self._stream_cache = None   # uploaded token stream ("device")
        #: the random draws of the next fit (None: :class:`Draws` from
        #: config.seed); tests put JAX's draws here
        self._draws = None
        #: chunk updates of the last fit (one B4 launch each on CUDA)
        self.chunks = 0

    # -- vocab (buildVocab:257 parity) -------------------------------------
    def build_vocab(self) -> VocabCache:
        if self.cache is None:
            self.cache = build_vocab(self.sentences, self.tokenizer,
                                     self.config.min_word_frequency)
        if self.config.use_hs:
            build_huffman(self.cache)
        return self.cache

    def _index_sentences(self) -> List[np.ndarray]:
        """Tokenize + vocab-index the corpus; sets the lr-decay clock."""
        d = {w: vw.index for w, vw in self.cache.vocab.items()}
        get = d.get
        tok = self.tokenizer
        indexed: List[np.ndarray] = []
        n = 0
        for sent in self.sentences:
            arr = np.fromiter(
                (i for i in map(get, tok(sent)) if i is not None),
                np.int32)
            if arr.size:
                indexed.append(arr)
                n += arr.size
        self._n_positions = n
        return indexed

    def _reset_weights(self) -> None:
        """syn0 ~ U(-0.5, 0.5)/dim (InMemoryLookupTable:98-104), from a
        ``torch.Generator`` seeded with config.seed."""
        cfg, dev = self.config, self.device
        V, D = len(self.cache), cfg.vector_size
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)
        self.syn0 = (torch.rand((V, D), generator=gen, device=dev) - 0.5) / D
        self.syn1 = torch.zeros((V, D), device=dev)
        if cfg.negative > 0:
            self.syn1neg = torch.zeros((V, D), device=dev)

    def fit(self, initial_weights=None, mesh=None) -> WordVectors:
        """Train; ``initial_weights=(syn0, syn1, syn1neg|None)`` resumes
        from given tables (copied to the device) instead of
        re-initializing."""
        cfg = self.config
        if mesh is not None:
            raise NotImplementedError(
                "Word2Vec.fit(mesh=...) data-parallel training is not "
                "ported yet (ROADMAP A7)")
        if cfg.kernel not in ks.KERNELS:
            raise ValueError(
                f"Word2VecConfig.kernel must be one of {ks.KERNELS}, got "
                f"{cfg.kernel!r}")
        if cfg.pair_mode not in ("masked", "exact", "device"):
            raise ValueError(
                f"Word2VecConfig.pair_mode must be 'masked', 'exact' or "
                f"'device', got {cfg.pair_mode!r}")
        if not cfg.use_hs and cfg.negative <= 0:
            raise ValueError(
                "no training objective: enable use_hs and/or negative > 0")
        self.build_vocab()
        if len(self.cache) == 0:
            raise ValueError("empty vocabulary")
        dev = self.device
        if initial_weights is not None:
            self.syn0, self.syn1 = (as_table(initial_weights[0], dev),
                                    as_table(initial_weights[1], dev))
            self.syn1neg = (None if initial_weights[2] is None
                            else as_table(initial_weights[2], dev))
        else:
            self._reset_weights()
        codes_t, points_t, mask_t, table, lengths_t = prepare_train_tables(
            self.cache, cfg.table_size)
        counts = np.asarray([self.cache.vocab[w].count
                             for w in self.cache.index], np.float64)
        if cfg.negative > 0 and self.syn1neg is None:
            raise ValueError(
                "negative sampling enabled but no syn1neg table: pass "
                "initial_weights with a syn1neg entry (or None weights to "
                "initialize fresh)")
        if self._indexed is None and (cfg.pair_mode != "masked"
                                      or self._dev_cache is None):
            self._indexed = self._index_sentences()
        common = dict(vocab_size=len(self.cache), dim=cfg.vector_size,
                      epochs=cfg.epochs, codes_t=codes_t, points_t=points_t,
                      mask_t=mask_t, table=table, window=cfg.window,
                      alpha=cfg.alpha, min_alpha=cfg.min_alpha,
                      use_hs=cfg.use_hs, negative=cfg.negative,
                      batch_size=cfg.batch_size, kernel=cfg.kernel,
                      seed=cfg.seed, draws=self._draws)
        if cfg.pair_mode == "device":
            (self.syn0, self.syn1, self.syn1neg, self._stream_cache,
             self.kernel_used, self.chunks) = run_stream_training(
                self.syn0, self.syn1, self.syn1neg, self._indexed,
                stream_cache=self._stream_cache, **common)
            self._wv = WordVectors(self.cache, self.syn0)
            return self._wv
        pairs_iter = factory = None
        if cfg.pair_mode == "exact":
            indexed, w = self._indexed, cfg.window

            def factory(epoch):
                rng = np.random.RandomState(
                    (cfg.seed + 7919 * (epoch + 1)) % (2 ** 31 - 1))
                return corpus_pairs_slabs(indexed, w, PAIRS_PER_SLAB, rng)
        elif self._dev_cache is None:
            pairs_iter = corpus_pairs_slabs(self._indexed, cfg.window,
                                            PAIRS_PER_SLAB)
        (self.syn0, self.syn1, self.syn1neg, self._dev_cache,
         self.kernel_used, self.chunks) = run_pair_training(
                self.syn0, self.syn1, self.syn1neg,
                total_words=self._n_positions,
                dev_cache=self._dev_cache, pairs_iter=pairs_iter,
                pairs_iter_factory=factory,
                window_mask=cfg.pair_mode != "exact",
                hs_lengths=np.asarray(lengths_t), hs_weights=counts,
                depth_buckets=cfg.depth_buckets, **common)
        self._wv = WordVectors(self.cache, self.syn0)
        return self._wv

    # -- query passthrough --------------------------------------------------
    @property
    def word_vectors(self) -> WordVectors:
        if self._wv is None:
            raise RuntimeError("call fit() first")
        return self._wv

    def similarity(self, a: str, b: str) -> float:
        return self.word_vectors.similarity(a, b)

    def words_nearest(self, word: str, top_n: int = 10):
        return self.word_vectors.words_nearest(word, top_n)
