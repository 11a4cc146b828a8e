"""RNTN — Recursive Neural Tensor Network (Socher 2013) over parse trees.

Port of ``deeplearning4j_tpu/nlp/rntn.py`` (reference parity:
``models/rntn/RNTN.java:66`` — per-node tensor composition
``forwardPropagateTree:359``, AdaGrad updates; trees from PTB-style
s-expressions or nlp/treeparser).

A tree compiles to flat post-order arrays (children before parents; the
reference's ``compile_tree``, copied), and a batch of trees padded to
``max_nodes`` runs one node position at a time: position ``i`` of every
tree composes ``[B, 2d]`` children against ``V [d, 2d, 2d]`` at once.
The reference's ``lax.scan`` writes ``H.at[i].set(h)``; here each step
makes a new activation tensor with an out-of-place ``index_copy``, so
no tensor autograd saved is ever written in place, and the backward is
autograd of that loop.  Padding positions compose node 0 with itself as
the reference's do, so per-node predictions agree over the whole
``max_nodes`` row.

Weights: ``init_params`` draws from a ``torch.Generator`` (the
reference's ``jax.random`` draws cannot be reproduced);
:func:`params_from_numpy` takes the reference's own initial weights so
that both packages start from the same point.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device

Tensor = torch.Tensor
Params = Dict[str, Tensor]
PARAM_NAMES = ("embed", "W", "b", "V", "U", "bc")


# ---------------------------------------------------------------------------
# trees (Tree.java + treeparser parity, minimal)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Tree:
    label: int
    word: Optional[str] = None            # leaves only
    left: Optional["Tree"] = None
    right: Optional["Tree"] = None

    @property
    def is_leaf(self) -> bool:
        return self.word is not None

    def leaves(self) -> List[str]:
        if self.is_leaf:
            return [self.word]
        return self.left.leaves() + self.right.leaves()

    def size(self) -> int:
        return 1 if self.is_leaf else 1 + self.left.size() + self.right.size()


_TOKEN_RE = re.compile(r"\(|\)|[^\s()]+")


def parse_tree(s: str) -> Tree:
    """PTB-style s-expression: ``(3 (2 nice) (3 movie))`` — label then
    either a word (leaf) or exactly two subtrees."""
    tokens = _TOKEN_RE.findall(s)
    pos = 0

    def parse() -> Tree:
        nonlocal pos
        if tokens[pos] != "(":
            raise ValueError(f"expected '(' at token {pos}")
        pos += 1
        label = int(tokens[pos]); pos += 1
        if tokens[pos] != "(":                       # leaf: (label word)
            word = tokens[pos]; pos += 1
            if tokens[pos] != ")":
                raise ValueError("leaf must close after its word")
            pos += 1
            return Tree(label=label, word=word)
        left = parse()
        right = parse()
        if tokens[pos] != ")":
            raise ValueError("internal node must have exactly 2 children")
        pos += 1
        return Tree(label=label, left=left, right=right)

    t = parse()
    if pos != len(tokens):
        raise ValueError("trailing tokens after tree")
    return t


def compile_tree(tree: Tree, vocab: Dict[str, int], max_nodes: int
                 ) -> Dict[str, np.ndarray]:
    """Post-order flattening: children always precede parents, so a single
    forward scan over node indices sees resolved child activations."""
    n = tree.size()
    if n > max_nodes:
        raise ValueError(f"tree has {n} nodes > max_nodes={max_nodes}")
    word = np.zeros(max_nodes, np.int32)
    left = np.zeros(max_nodes, np.int32)
    right = np.zeros(max_nodes, np.int32)
    is_leaf = np.zeros(max_nodes, np.float32)
    label = np.zeros(max_nodes, np.int32)
    mask = np.zeros(max_nodes, np.float32)
    idx = 0

    def walk(t: Tree) -> int:
        nonlocal idx
        if t.is_leaf:
            me = idx; idx += 1
            word[me] = vocab.get(t.word, 0)
            is_leaf[me] = 1.0
        else:
            l = walk(t.left)
            r = walk(t.right)
            me = idx; idx += 1
            left[me], right[me] = l, r
        label[me] = t.label
        mask[me] = 1.0
        return me

    walk(tree)
    return {"word": word, "left": left, "right": right, "is_leaf": is_leaf,
            "label": label, "mask": mask}


def build_vocab(trees: Sequence[Tree]) -> Dict[str, int]:
    vocab: Dict[str, int] = {"<UNK>": 0}
    for t in trees:
        for w in t.leaves():
            vocab.setdefault(w, len(vocab))
    return vocab


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RNTNConfig:
    vocab_size: int = 1000
    dim: int = 25                 # reference default numHidden=25
    n_classes: int = 5            # sentiment treebank granularity
    max_nodes: int = 64
    adagrad_lr: float = 0.01      # reference trains with AdaGrad
    reg: float = 1e-4


def init_params(gen: torch.Generator, cfg: RNTNConfig,
                device: DeviceLike = None) -> Params:
    """The reference's initial scales, drawn on the CPU from ``gen`` and
    moved to the device (one seed gives the same weights everywhere)."""
    d, k = cfg.dim, cfg.n_classes
    host = {
        "embed": torch.randn((cfg.vocab_size, d), generator=gen) * 0.1,
        "W": torch.randn((2 * d, d), generator=gen) * (1.0 / np.sqrt(2 * d)),
        "b": torch.zeros((d,)),
        # the tensor: output dim k gets cᵀ V[k] c
        "V": torch.randn((d, 2 * d, 2 * d), generator=gen) * (1.0 / (2 * d)),
        "U": torch.randn((d, k), generator=gen) * (1.0 / np.sqrt(d)),
        "bc": torch.zeros((k,)),
    }
    dev = resolve_device(device)
    return {n: t.to(dev) for n, t in host.items()}


def params_from_numpy(tree, device: DeviceLike = None) -> Params:
    """Parameters from a dict of arrays with the reference's names
    (``embed``, ``W``, ``b``, ``V``, ``U``, ``bc``), as fp32 tensors on
    ``device``: the reference's ``init_params`` output, taken to numpy."""
    dev = resolve_device(device)
    return {n: torch.tensor(np.asarray(tree[n], np.float32), device=dev)
            for n in PARAM_NAMES}


def _compose(params: Params, hl: Tensor, hr: Tensor) -> Tensor:
    """tanh(Wc + b + cᵀVc) over a batch: ``hl``, ``hr`` [B, d] (or
    [d]) -> [B, d] (RNTN.java:359)."""
    c = torch.cat([hl, hr], dim=-1)                      # [B, 2d]
    linear = c @ params["W"] + params["b"]               # [B, d]
    tensor = torch.einsum("...i,kij,...j->...k", c, params["V"], c)
    return torch.tanh(linear + tensor)


def _batched(tree_arrays: Dict[str, Tensor]):
    """(arrays with a leading batch dimension, whether one was added)."""
    single = tree_arrays["word"].dim() == 1
    if single:
        return {k: v[None] for k, v in tree_arrays.items()}, True
    return tree_arrays, False


def forward_tree(params: Params, tree_arrays: Dict[str, Tensor]) -> Tensor:
    """Node activations ``H`` [max_nodes, d] for one tree, or
    [B, max_nodes, d] for a batch: one step per node position (children
    precede parents in the post-order layout, so H is resolved when
    read)."""
    arrays, single = _batched(tree_arrays)
    word, left, right = arrays["word"], arrays["left"], arrays["right"]
    leaf = arrays["is_leaf"]
    B, N = word.shape
    d = params["b"].shape[0]
    rows = torch.arange(B, device=word.device)
    H = params["b"].new_zeros((B, N, d))
    for i in range(N):
        h_leaf = params["embed"][word[:, i]]
        h_int = _compose(params, H[rows, left[:, i]], H[rows, right[:, i]])
        lf = leaf[:, i, None]
        h = lf * h_leaf + (1.0 - lf) * h_int
        # out of place: the H a gather above saved for autograd stays
        H = H.index_copy(1, rows.new_tensor([i]), h[:, None])
    return H[0] if single else H


def _logits(params: Params, H: Tensor) -> Tensor:
    return H @ params["U"] + params["bc"]


def _per_tree_loss(params: Params, arrays: Dict[str, Tensor]) -> Tensor:
    """Summed per-node softmax cross-entropy over every labelled node,
    divided by the node count (masked over padding): [B]."""
    H = forward_tree(params, arrays)
    logp = torch.log_softmax(_logits(params, H), dim=-1)
    ll = torch.gather(logp, -1, arrays["label"][..., None])[..., 0]
    mask = arrays["mask"]
    return -(ll * mask).sum(-1) / mask.sum(-1).clamp_min(1.0)


def tree_loss(params: Params, tree_arrays: Dict[str, Tensor],
              cfg: RNTNConfig) -> Tensor:
    """One tree's loss (every node is labeled — RNTN trains sentiment at
    all constituents), masked over padding."""
    arrays, _ = _batched(tree_arrays)
    return _per_tree_loss(params, arrays)[0]


def batch_loss(params: Params, batch: Dict[str, Tensor],
               cfg: RNTNConfig) -> Tensor:
    """Mean tree loss plus ``reg`` times the squares of W, V and U (the
    embedding is not regularized, as in the reference)."""
    reg = sum((params[n] ** 2).sum() for n in ("W", "V", "U"))
    return _per_tree_loss(params, batch).mean() + cfg.reg * reg


def adagrad_step(params: Params, accum: Params, batch: Dict[str, Tensor],
                 cfg: RNTNConfig) -> Tensor:
    """One full-batch AdaGrad step in place (the reference's jitted
    ``step``): ``accum += g²``, ``p -= lr·g/(√accum + 1e-8)``.  Returns
    the loss before the step."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    loss = batch_loss(leaves, batch, cfg)
    grads = torch.autograd.grad(loss, [leaves[n] for n in PARAM_NAMES])
    with torch.no_grad():
        for n, g in zip(PARAM_NAMES, grads):
            accum[n].add_(g * g)
            params[n].sub_(cfg.adagrad_lr * g / (accum[n].sqrt() + 1e-8))
    return loss.detach()


def predict_root(params: Params, tree_arrays: Dict[str, Tensor]) -> Tensor:
    """Root sentiment: the root is the LAST real node in post-order."""
    arrays, single = _batched(tree_arrays)
    H = forward_tree(params, arrays)
    root = arrays["mask"].sum(-1).long() - 1
    rows = torch.arange(H.shape[0], device=H.device)
    pred = torch.argmax(_logits(params, H[rows, root]), dim=-1)
    return pred[0] if single else pred


class RNTN:
    """Trainer facade (RNTN.java API shape): fit(trees), predict(tree)."""

    def __init__(self, cfg: Optional[RNTNConfig] = None,
                 trees: Optional[Sequence[Tree]] = None, seed: int = 0,
                 device: DeviceLike = None,
                 params: Optional[Params] = None):
        """``params`` (from :func:`params_from_numpy`) replaces the
        seeded initial weights."""
        trees = list(trees or [])
        self.device = resolve_device(device)
        self.vocab = build_vocab(trees) if trees else {"<UNK>": 0}
        self.cfg = cfg or RNTNConfig(vocab_size=max(len(self.vocab), 2))
        if self.cfg.vocab_size < len(self.vocab):
            raise ValueError("vocab_size smaller than actual vocabulary")
        self.trees = trees
        if params is None:
            params = init_params(torch.Generator().manual_seed(seed),
                                 self.cfg, self.device)
        self.params = {n: params[n].to(self.device, torch.float32).clone()
                       for n in PARAM_NAMES}
        self._accum = {n: torch.zeros_like(p)
                       for n, p in self.params.items()}        # AdaGrad

    def _batch_arrays(self, trees: Sequence[Tree]) -> Dict[str, Tensor]:
        if not trees:
            raise ValueError("no training trees provided")
        compiled = [compile_tree(t, self.vocab, self.cfg.max_nodes)
                    for t in trees]
        return _to_device({k: np.stack([c[k] for c in compiled])
                           for k in compiled[0]}, self.device)

    def fit(self, epochs: int = 30,
            trees: Optional[Sequence[Tree]] = None) -> List[float]:
        batch = self._batch_arrays(trees or self.trees)
        losses = [adagrad_step(self.params, self._accum, batch, self.cfg)
                  for _ in range(epochs)]
        return torch.stack(losses).tolist() if losses else []

    def predict(self, tree: Tree) -> int:
        arrays = _to_device(compile_tree(tree, self.vocab,
                                         self.cfg.max_nodes), self.device)
        with torch.no_grad():
            return int(predict_root(self.params, arrays))


def _to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, Tensor]:
    """Compiled tree arrays as tensors: indices int64, masks fp32."""
    return {k: torch.as_tensor(v, dtype=torch.float32 if v.dtype.kind == "f"
                               else torch.int64).to(device)
            for k, v in arrays.items()}


# ---------------------------------------------------------------------------
# evaluation (RNTNEval.java parity)
# ---------------------------------------------------------------------------

def predict_nodes(params: Params, tree_arrays: Dict[str, Tensor]) -> Tensor:
    """Per-node argmax sentiment labels [max_nodes] for a tree, or
    [B, max_nodes] for a batch (padding included; filter with
    mask/is_leaf on the host side)."""
    H = forward_tree(params, tree_arrays)
    return torch.argmax(_logits(params, H), dim=-1)


class RNTNEval:
    """Per-node sentiment evaluation over labeled trees.

    Reference parity: ``models/rntn/RNTNEval.java`` — walks each evaluated
    tree and adds (gold label, argmax prediction) for every NON-LEAF node
    to a confusion matrix; ``stats()`` prints the non-zero confusion
    cells.  Here the whole batch of trees is evaluated at once on the
    model's device (the batched forward + argmax) instead of per-node
    host recursion, and per-ROOT accuracy is tracked too (the headline
    sentiment-treebank metric the reference never reports).
    """

    def __init__(self, n_classes: Optional[int] = None):
        self._n = n_classes
        self._node_counts: Optional[np.ndarray] = None   # [K, K] gold x pred
        self._root_counts: Optional[np.ndarray] = None

    def _ensure(self, k: int) -> None:
        if self._node_counts is None:
            k = max(k, self._n or 0)
            self._node_counts = np.zeros((k, k), np.int64)
            self._root_counts = np.zeros((k, k), np.int64)

    def eval(self, rntn: RNTN, trees: Sequence[Tree]) -> None:
        """Accumulate confusion counts for every internal node (and every
        root) of ``trees`` under ``rntn``'s current parameters."""
        if not trees:
            return
        self._ensure(rntn.cfg.n_classes)
        batch = rntn._batch_arrays(trees)
        with torch.no_grad():
            preds = predict_nodes(rntn.params, batch).cpu().numpy()  # [B, N]
        host = {k: v.cpu().numpy() for k, v in batch.items()}
        mask = host["mask"] > 0
        internal = mask & (host["is_leaf"] == 0)
        gold = host["label"]
        k = self._node_counts.shape[0]
        np.add.at(self._node_counts, (gold[internal], preds[internal]), 1)
        # root = last real node in post-order
        n_real = mask.sum(axis=1).astype(int)
        rows = np.arange(len(trees))
        roots = n_real - 1
        np.add.at(self._root_counts, (gold[rows, roots], preds[rows, roots]),
                  1)

    @property
    def confusion(self) -> np.ndarray:
        """[gold, pred] counts over internal nodes."""
        if self._node_counts is None:
            raise ValueError("eval() has not been called")
        return self._node_counts

    def accuracy(self) -> float:
        """Per-internal-node accuracy (the metric RNTNEval.java's counts
        support)."""
        c = self.confusion
        total = c.sum()
        return float(np.trace(c) / total) if total else 0.0

    def root_accuracy(self) -> float:
        c = self._root_counts
        if c is None:
            raise ValueError("eval() has not been called")
        total = c.sum()
        return float(np.trace(c) / total) if total else 0.0

    def stats(self) -> str:
        """Reference-format summary (non-zero confusion cells) plus the
        accuracy lines."""
        lines = []
        c = self.confusion
        for g in range(c.shape[0]):
            for p in range(c.shape[1]):
                if c[g, p]:
                    lines.append(f"Actual Class {g} was predicted with "
                                 f"Predicted {p} with count {c[g, p]} times")
        lines.append(f"Node accuracy: {self.accuracy():.4f}")
        lines.append(f"Root accuracy: {self.root_accuracy():.4f}")
        return "\n".join(lines)
