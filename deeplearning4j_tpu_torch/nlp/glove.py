"""GloVe — co-occurrence counting + AdaGrad weighted-least-squares fit.

Port of ``deeplearning4j_tpu/nlp/glove.py`` (reference parity:
``Glove.java``, ``GloveWeightLookupTable.iterateSample``).

- ``count_cooccurrences`` is the JAX package's numpy code, copied: COO
  triples (i, j, X_ij) with weight 1/d by distance d.
- An epoch shuffles the triples and walks fixed [batch] chunks, carrying
  the extended tables ``wext = (w|b|1)``, ``wtext = (wt|1|bt)`` and the
  packed AdaGrad state across the epoch, as the JAX kernel branch does
  (:162-199): one ``ops/fused_glove`` chunk step per chunk, the chunk's
  sums and then ``apply_chunk``'s AdaGrad step per side (kernel B5 in
  place on CUDA tensors, its plain twin on CPU tensors or with
  ``kernel="plain"``).  Each chunk is one call through the compile
  engine (``runtime/compile_cache``, ``glove.chunk``: a CUDA graph on
  the card), the chunk index a device counter it advances; the tables
  are donated to it (the caller's are copied in, never written), and a
  fit clones them at its end.
- ``_glove_update`` (:112), JAX's plain scatter step, is kept in plain
  PyTorch as the reference the chunk path is held to.
- The per-epoch permutation comes from a ``torch.Generator`` seeded
  with ``config.seed`` on the run's device; ``Glove._shuffles`` can
  stand in for it (the tests pass JAX's permutation).
- Not ported here: ``fit(mesh=...)`` and ``make_dp_glove_epoch``
  (ROADMAP A7).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, build_vocab
from deeplearning4j_tpu_torch.nlp.word2vec import as_table
from deeplearning4j_tpu_torch.nlp.word_vectors import WordVectors
from deeplearning4j_tpu_torch.ops import fused_glove as fg
from deeplearning4j_tpu_torch.ops import kernel_select as ks
from deeplearning4j_tpu_torch.ops.updaters import copy_into
from deeplearning4j_tpu_torch.runtime import compile_cache

Tensor = torch.Tensor


@dataclasses.dataclass
class GloveConfig:
    vector_size: int = 100
    window: int = 5
    min_word_frequency: int = 1
    alpha: float = 0.05          # AdaGrad master step
    x_max: float = 100.0
    weight_power: float = 0.75
    epochs: int = 5
    batch_size: int = 4096
    symmetric: bool = True
    seed: int = 13
    #: "auto" takes kernel B5 for CUDA tensors and the plain twin for CPU
    #: tensors; "cuda" demands B5; "plain" forces the plain twin
    kernel: str = "auto"


def count_cooccurrences(sentences: Iterable[str], tokenizer,
                        cache: VocabCache, window: int = 5,
                        symmetric: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO triples (rows, cols, counts); weight 1/d by distance d, merged
    with np.unique over packed i*V+j keys (:54-109)."""
    V = max(1, len(cache))
    deltas = np.arange(1, window + 1)
    weights_d = (1.0 / deltas).astype(np.float32)
    merged_k = np.empty(0, np.int64)
    merged_v = np.empty(0, np.float32)
    keys_parts: list = []
    w_parts: list = []
    buffered = 0

    def collapse():
        """Fold the raw pair buffer into the running unique set."""
        nonlocal merged_k, merged_v, keys_parts, w_parts, buffered
        keys = np.concatenate([merged_k] + keys_parts)
        ws = np.concatenate([merged_v] + w_parts)
        merged_k, inv = np.unique(keys, return_inverse=True)
        merged_v = np.zeros(merged_k.size, np.float32)
        np.add.at(merged_v, inv, ws)
        keys_parts, w_parts, buffered = [], [], 0

    for sent in sentences:
        idx = [cache.index_of(t) for t in tokenizer(sent)]
        idx = np.asarray([i for i in idx if i >= 0], np.int64)
        n = idx.size
        if n < 2:
            continue
        j = np.arange(n)[:, None] + deltas[None, :]          # [n, W]
        valid = j < n
        pi, di = np.nonzero(valid)
        a, b = idx[pi], idx[j[pi, di]]
        keys_parts.append(a * V + b)
        w_parts.append(weights_d[di])
        if symmetric:
            keys_parts.append(b * V + a)
            w_parts.append(weights_d[di])
        buffered += a.size * (2 if symmetric else 1)
        if buffered >= 4_000_000:
            collapse()
    if buffered or keys_parts:
        collapse()
    if merged_k.size == 0:
        return (np.empty(0, np.int32),) * 2 + (np.empty(0, np.float32),)
    return ((merged_k // V).astype(np.int32),
            (merged_k % V).astype(np.int32), merged_v)


def _glove_update(state, rows: Tensor, cols: Tensor, x: Tensor,
                  mask: Tensor, alpha, x_max: float, power: float):
    """One batched AdaGrad WLS step on COO triples (:112-144), the plain
    scatter form: ``(state, mean loss)``."""
    w, wt, b, bt, gw, gwt, gb, gbt = state
    rows, cols = rows.long(), cols.long()
    wi, wj = w[rows], wt[cols]
    diff = ((wi * wj).sum(1) + b[rows] + bt[cols]
            - torch.log(x.clamp_min(1e-12)))
    fx = ((x / x_max) ** power).clamp_max(1.0)
    g = fx * diff * mask

    def adagrad_scatter(table, gsq, idx, grad, hit):
        # count-normalized scatter (stability under duplicate rows)
        cnt = torch.zeros(table.shape[0], dtype=table.dtype,
                          device=table.device).index_add_(0, idx, hit)
        norm = cnt.clamp_min(1.0)[idx]
        if grad.dim() == 2:
            norm = norm[:, None]
        grad = grad / norm
        gsq = gsq.index_add(0, idx, grad * grad)
        step = alpha * grad / torch.sqrt(gsq[idx] + 1e-8)
        return table.index_add(0, idx, -step), gsq

    w, gw = adagrad_scatter(w, gw, rows, g[:, None] * wj, mask)
    wt, gwt = adagrad_scatter(wt, gwt, cols, g[:, None] * wi, mask)
    b, gb = adagrad_scatter(b, gb, rows, g, mask)
    bt, gbt = adagrad_scatter(bt, gbt, cols, g, mask)
    loss = 0.5 * (fx * diff * diff * mask).sum() / mask.sum().clamp_min(1.0)
    return (w, wt, b, bt, gw, gwt, gb, gbt), loss


def to_extended(state):
    """The 8-tuple state as ``(wext, wtext, gext, gtext)``: (w|b|1),
    (wt|1|bt), (gw|gb), (gwt|gbt)."""
    w, wt, b, bt, gw, gwt, gb, gbt = state
    ones = torch.ones((w.shape[0], 1), dtype=w.dtype, device=w.device)
    return (torch.cat([w, b[:, None], ones], dim=1),
            torch.cat([wt, ones, bt[:, None]], dim=1),
            torch.cat([gw, gb[:, None]], dim=1),
            torch.cat([gwt, gbt[:, None]], dim=1))


def from_extended(ext):
    """The inverse of :func:`to_extended`."""
    wext, wtext, gext, gtext = ext
    D = wext.shape[1] - 2
    return (wext[:, :D], wtext[:, :D], wext[:, D], wtext[:, D + 1],
            gext[:, :D], gtext[:, :D], gext[:, D], gtext[:, D])


def _glove_chunk(ext, sums, i, rows: Tensor, cols: Tensor, x: Tensor,
                 mask: Tensor, perm: Tensor, *, alpha: float, x_max: float,
                 power: float, batch: int, impl: str):
    """Chunk ``i`` (a ``[1]`` device counter, advanced here) of the
    permuted triples: B5's step or its plain twin, written into the
    donated ``ext`` in place, and the chunk's weighted loss and count
    added to the donated ``sums`` ``[2]``.  ``alpha`` is constant within
    a fit, so it stays a kernel argument (part of the signature)."""
    step = (fg.glove_chunk_step_cuda if impl == "cuda"
            else fg.glove_chunk_step_plain)
    idx = perm.view(-1, batch).index_select(0, i)[0]
    *new, ls = step(*ext, rows[idx], cols[idx], x[idx], mask[idx], alpha,
                    x_max=x_max, power=power)
    copy_into(ext, tuple(new))
    loss = ls[0, 0] / ls[0, 1].clamp_min(1.0)
    sums.add_(torch.stack([loss * ls[0, 1], ls[0, 1]]))
    i.add_(1)
    return ext, sums, i


def glove_epoch(ext, rows: Tensor, cols: Tensor, x: Tensor, mask: Tensor,
                perm: Tensor, alpha, *, x_max: float, power: float,
                n_chunks: int, batch: int, impl: str):
    """One epoch over the permuted triples (``_glove_epoch_body``,
    :147-213, the extended-table carry of its kernel branch).  ``ext``
    is :func:`to_extended`'s 4-tuple, donated: each chunk is one call of
    :func:`_glove_chunk` through the compile engine (``glove.chunk``,
    one CUDA graph on the card, B5 inside), which updates it in place.
    Returns ``(ext, weighted loss sum, count sum)``, the sums as device
    tensors."""
    dev = ext[0].device
    step = compile_cache.cached_graph(_glove_chunk, key="glove.chunk",
                                      label="glove.chunk",
                                      donate_argnums=(0, 1, 2))
    sums = torch.zeros(2, device=dev)
    i = torch.zeros(1, dtype=torch.int64, device=dev)
    for _ in range(n_chunks):
        ext, sums, i = step(ext, sums, i, rows, cols, x, mask, perm,
                            alpha=float(alpha), x_max=float(x_max),
                            power=float(power), batch=batch, impl=impl)
    # a clone: a view of the donated sums would keep their buffers busy
    # into the next epoch, which would then need buffers of its own
    sums = sums.clone()
    return tuple(ext), sums[0], sums[1]


def _resolve(kernel: str, dim: int, dev: torch.device, B: int) -> str:
    """B5 takes every width, so ``auto`` launches it on any CUDA
    tensors."""
    return ks.resolve_kernel(kernel, aligned=True,
                             on_cuda=dev.type == "cuda",
                             desc=f"glove dim {dim} (batch {B})")


class Shuffles:
    """Per-epoch permutations of the triples from a ``torch.Generator``
    seeded with ``seed`` on ``device``."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)

    def __call__(self, epoch: int, n: int) -> Tensor:
        return torch.randperm(n, generator=self.gen, device=self.device)


class Glove:
    def __init__(self, sentences: Iterable[str],
                 config: Optional[GloveConfig] = None,
                 tokenizer=None, cache: Optional[VocabCache] = None,
                 device: DeviceLike = None):
        self.config = config or GloveConfig()
        self.tokenizer = tokenizer or DefaultTokenizerFactory()
        self.sentences = sentences
        self.cache = cache
        self.device = resolve_device(device)
        self._wv: Optional[WordVectors] = None
        self.state: Optional[Tuple] = None
        self.losses: list = []
        #: ``(epoch, n) -> permutation`` of the next fit (None:
        #: :class:`Shuffles` from config.seed); tests pass JAX's here
        self._shuffles = None
        #: chunk updates of the last fit (one B5 launch each on CUDA)
        self.chunks = 0

    def fit(self, initial_weights: Optional[Tuple] = None,
            cooccurrences: Optional[Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]] = None,
            mesh=None) -> WordVectors:
        """Train; ``initial_weights`` (the 8-tuple of w/w~/b/b~ and their
        AdaGrad accumulators, as in ``self.state``) warm-starts;
        ``cooccurrences`` = precomputed (rows, cols, counts) triples."""
        cfg, dev = self.config, self.device
        if mesh is not None:
            raise NotImplementedError(
                "Glove.fit(mesh=...) data-parallel training is not ported "
                "yet (ROADMAP A7)")
        if self.cache is None:
            self.cache = build_vocab(self.sentences, self.tokenizer,
                                     cfg.min_word_frequency)
        V, D = len(self.cache), cfg.vector_size
        if V == 0:
            raise ValueError("empty vocabulary")
        if cooccurrences is None:
            cooccurrences = count_cooccurrences(
                self.sentences, self.tokenizer, self.cache, cfg.window,
                cfg.symmetric)
        rows, cols, x = cooccurrences
        if rows.size == 0:
            raise ValueError("no co-occurrences")
        if initial_weights is not None:
            state = tuple(as_table(t, dev) for t in initial_weights)
            if tuple(state[0].shape) != (V, D):
                raise ValueError(
                    f"initial weights shaped {tuple(state[0].shape)}, "
                    f"vocab expects {(V, D)}")
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(cfg.seed)

            def init():
                return (torch.rand((V, D), generator=gen, device=dev)
                        - 0.5) / D

            state = (init(), init(), torch.zeros(V, device=dev),
                     torch.zeros(V, device=dev),
                     torch.full((V, D), 1e-8, device=dev),
                     torch.full((V, D), 1e-8, device=dev),
                     torch.full((V,), 1e-8, device=dev),
                     torch.full((V,), 1e-8, device=dev))

        # fixed batch width, power-of-two chunk count (:333-353): the
        # padding chunks are fully masked and the weighted loss ignores
        # them
        B = cfg.batch_size
        P = rows.size
        NC = max(1, 1 << (-(-P // B) - 1).bit_length())
        pad = NC * B - P
        if pad:
            rows = np.concatenate([rows, np.zeros(pad, np.int32)])
            cols = np.concatenate([cols, np.zeros(pad, np.int32)])
            x = np.concatenate([x, np.ones(pad, np.float32)])
        rows_d = torch.as_tensor(rows, device=dev)
        cols_d = torch.as_tensor(cols, device=dev)
        x_d = torch.as_tensor(x, device=dev)
        mask_d = torch.as_tensor(np.arange(NC * B) < P, dtype=torch.float32,
                                 device=dev)
        impl = _resolve(cfg.kernel, D, dev, B)
        self.kernel_used = impl
        shuffles = self._shuffles or Shuffles(cfg.seed, dev)
        alpha = float(np.float32(cfg.alpha))
        ext = to_extended(state)
        for epoch in range(cfg.epochs):
            perm = torch.as_tensor(shuffles(epoch, NC * B),
                                   device=dev).long()
            ext, ls, cs = glove_epoch(
                ext, rows_d, cols_d, x_d, mask_d, perm, alpha,
                x_max=cfg.x_max, power=cfg.weight_power, n_chunks=NC,
                batch=B, impl=impl)
            self.losses.append(float(ls / cs.clamp_min(1.0)))
        self.chunks = NC * cfg.epochs
        # the boundary: the graph's buffers stay with the engine
        self.state = from_extended(tuple(t.clone() for t in ext))
        w, wt = self.state[0], self.state[1]
        self._wv = WordVectors(self.cache, w + wt)
        return self._wv

    @property
    def word_vectors(self) -> WordVectors:
        if self._wv is None:
            raise RuntimeError("call fit() first")
        return self._wv

    def similarity(self, a: str, b: str) -> float:
        return self.word_vectors.similarity(a, b)

    def words_nearest(self, word: str, top_n: int = 10):
        return self.word_vectors.words_nearest(word, top_n)
