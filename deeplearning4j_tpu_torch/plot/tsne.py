"""t-SNE — exact (device loop) and Barnes-Hut (host trees + device steps).

Port of ``deeplearning4j_tpu/plot/tsne.py`` (reference parity:
``plot/Tsne.java:47`` — computeGaussianPerplexity:125, gradient:334,
momentum schedule step:351 — and ``plot/BarnesHutTsne.java:63``).

- The affinities P (``joint_probabilities`` and its per-point precision
  search ``_binary_search_betas``) are the reference's host numpy
  float64 code, copied exactly, so both packages compute the same P.
- Exact mode: :func:`exact_loop` runs ``max_iter`` steps on [N, N]
  tensors on P's device with the reference's momentum switch (0.5 ->
  0.8 at iteration 250), early exaggeration (the KL of those iterations
  uses the exaggerated P), gains (``sign(g)`` against ``sign(vel)``,
  ``sign(0) = 0``) and the recentring.  The gradient is
  ``4 (rowsum(pq) * y - pq @ y)``, the reference's
  ``(diag(rowsum(pq)) - pq) @ y`` without the diagonal matrix.
- Barnes-Hut mode: per-iteration positive forces from a kNN-sparse P on
  the device, negative forces from the host ``SpTree`` (the reference's
  own Python, which runs identically in both packages).

Precision: both modes compute in float64 (``DTYPE``), as the host's P
and the Barnes-Hut iterate already are; the reference rounds to float32
for its device.  At the default learning rate the iteration is chaotic
(``tools/tsne_chaos_probe.py``: a relative perturbation of 1e-7 reaches
order 1 within 20 iterations), so float32 runs on two devices part
after a few iterations while float64 runs stay together.

The initial ``y0`` is drawn from a ``torch.Generator`` (the reference's
``jax.random.normal`` draw cannot be reproduced); ``fit_transform`` and
:meth:`Tsne.embed` take a given ``y0``.  Barnes-Hut starts from
``RandomState(seed)`` as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.clustering.trees import SpTree

Tensor = torch.Tensor
DTYPE = torch.float64


@dataclasses.dataclass
class TsneConfig:
    n_components: int = 2
    perplexity: float = 30.0
    #: "auto" = max(N / early_exaggeration, 50) — the Belkina et al.
    #: (2019) heuristic sklearn adopted as its default.  A fixed lr of
    #: 200 is far too hot for small N: gradient magnitudes scale with
    #: P ~ 1/N, so small embeddings bounce around the gain schedule and
    #: never tighten their clusters (the exact-tsne blob test failed on
    #: exactly this).  A float keeps the old fixed-rate behavior.
    learning_rate: "float | str" = "auto"
    max_iter: int = 500
    early_exaggeration: float = 12.0
    exaggeration_iters: int = 100
    momentum_initial: float = 0.5
    momentum_final: float = 0.8
    momentum_switch_iter: int = 250   # Tsne.java switchMomentumIteration
    theta: float = 0.5                # Barnes-Hut accuracy
    seed: int = 0


def _resolve_lr(cfg: TsneConfig, n: int) -> float:
    """Concrete learning rate for an N-point embedding (see
    ``TsneConfig.learning_rate``)."""
    if isinstance(cfg.learning_rate, str):
        if cfg.learning_rate != "auto":
            raise ValueError(
                f"learning_rate must be a float or 'auto', got "
                f"{cfg.learning_rate!r}")
        return max(n / cfg.early_exaggeration, 50.0)
    return float(cfg.learning_rate)


def _binary_search_betas(d2: np.ndarray, perplexity: float,
                         tol: float = 1e-5, max_steps: int = 50
                         ) -> np.ndarray:
    """Per-point precision search (computeGaussianPerplexity:125)."""
    n = d2.shape[0]
    target = np.log(perplexity)
    betas = np.ones(n)
    for i in range(n):
        lo, hi = -np.inf, np.inf
        beta = 1.0
        di = np.delete(d2[i], i)
        for _ in range(max_steps):
            p = np.exp(-di * beta)
            s = max(p.sum(), 1e-12)
            h = np.log(s) + beta * float((di * p).sum()) / s
            diff = h - target
            if abs(diff) < tol:
                break
            if diff > 0:
                lo = beta
                beta = beta * 2 if hi == np.inf else (beta + hi) / 2
            else:
                hi = beta
                beta = beta / 2 if lo == -np.inf else (beta + lo) / 2
        betas[i] = beta
    return betas


def joint_probabilities(x: np.ndarray, perplexity: float) -> np.ndarray:
    """Symmetrized high-dimensional affinities P."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    sq = np.sum(x * x, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    np.fill_diagonal(d2, 0.0)
    betas = _binary_search_betas(d2, perplexity)
    p = np.exp(-d2 * betas[:, None])
    np.fill_diagonal(p, 0.0)
    p /= np.maximum(p.sum(axis=1, keepdims=True), 1e-12)
    p = (p + p.T) / (2.0 * n)
    return np.maximum(p, 1e-12)


def exact_loop(p: Tensor, y0: Tensor, max_iter: int, exag_iters: int,
               switch_iter: int, lr: float, exag: float, mom_i: float,
               mom_f: float) -> Tuple[Tensor, Tensor]:
    """``max_iter`` exact t-SNE steps from ``y0`` [N, C] under P [N, N]
    (both on one device): (y, KL of every iteration [max_iter], each
    computed before that iteration's update)."""
    n = y0.shape[0]
    p_exag = p * exag
    y = y0
    vel = torch.zeros_like(y0)
    gains = torch.ones_like(y0)
    kls = y0.new_zeros((max_iter,))
    for it in range(max_iter):
        p_eff = p_exag if it < exag_iters else p
        sq = torch.sum(y * y, dim=1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (y @ y.T)
        num = 1.0 / (1.0 + d2)
        num.fill_diagonal_(0.0)
        q = num / torch.sum(num).clamp_min(1e-12)
        q = q.clamp_min(1e-12)
        pq = (p_eff - q) * num                                 # [N, N]
        g = 4.0 * (pq.sum(dim=1, keepdim=True) * y - pq @ y)
        kls[it] = torch.sum(p_eff * torch.log(p_eff / q))
        mom = mom_i if it < switch_iter else mom_f
        # gains (bar-delta adaptive lr, standard t-SNE; Tsne.java gradient)
        same_sign = torch.sign(g) == torch.sign(vel)
        gains = torch.where(same_sign, gains * 0.8, gains + 0.2
                            ).clamp_min(0.01)
        vel = mom * vel - lr * gains * g
        y = y + vel
        y = y - torch.mean(y, dim=0, keepdim=True)
    return y, kls


class Tsne:
    """Exact t-SNE (Tsne.java parity), iterated on the device."""

    def __init__(self, config: Optional[TsneConfig] = None,
                 device: DeviceLike = None, **kw):
        self.config = config or TsneConfig(**kw)
        self.device = resolve_device(device)
        self.kl_: Optional[float] = None
        #: KL of every iteration of the last run ([max_iter], on device)
        self.kl_history_: Optional[Tensor] = None

    def initial_y(self, n: int) -> Tensor:
        """1e-4 x standard normal [n, n_components] from ``seed``."""
        gen = torch.Generator().manual_seed(self.config.seed)
        return 1e-4 * torch.randn((n, self.config.n_components),
                                  generator=gen)

    def embed(self, p, y0=None) -> np.ndarray:
        """The device loop from affinities ``p`` [N, N] (numpy, as
        :func:`joint_probabilities` gives them) and ``y0`` (default
        :meth:`initial_y`)."""
        cfg = self.config
        n = p.shape[0]
        y0 = self.initial_y(n) if y0 is None else torch.as_tensor(y0)
        y, kls = exact_loop(
            torch.as_tensor(np.asarray(p)).to(self.device, DTYPE),
            y0.to(self.device, DTYPE), cfg.max_iter,
            cfg.exaggeration_iters, cfg.momentum_switch_iter,
            _resolve_lr(cfg, n), cfg.early_exaggeration,
            cfg.momentum_initial, cfg.momentum_final)
        self.kl_history_ = kls
        self.kl_ = float(kls[-1]) if cfg.max_iter else 0.0
        return y.cpu().numpy()

    def fit_transform(self, x, y0=None) -> np.ndarray:
        x = np.asarray(x, np.float64)
        return self.embed(joint_probabilities(x, self.config.perplexity), y0)


class BarnesHutTsne:
    """O(N log N) t-SNE: kNN-sparse P + SpTree negative forces
    (BarnesHutTsne.java parity; tree traversal host-side by design)."""

    def __init__(self, config: Optional[TsneConfig] = None,
                 device: DeviceLike = None, **kw):
        self.config = config or TsneConfig(**kw)
        self.device = resolve_device(device)
        self.kl_: Optional[float] = None

    def fit_transform(self, x) -> np.ndarray:
        cfg = self.config
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        k = min(n - 1, int(3 * cfg.perplexity))
        p_full = joint_probabilities(x, cfg.perplexity)
        # sparsify to kNN of P mass
        cols = np.argsort(-p_full, axis=1)[:, :k]          # [N, k]
        vals = np.take_along_axis(p_full, cols, axis=1)
        vals /= max(vals.sum(), 1e-12)

        lr = _resolve_lr(cfg, n)
        rng = np.random.RandomState(cfg.seed)
        y = 1e-4 * rng.randn(n, cfg.n_components)
        vel = np.zeros_like(y)
        gains = np.ones_like(y)

        cols_t = torch.from_numpy(cols).to(self.device)
        vals_t = torch.from_numpy(vals).to(self.device, DTYPE)

        def pos_forces(yt: Tensor, p_eff: Tensor) -> np.ndarray:
            diff = yt[:, None, :] - yt[cols_t]              # [N, k, C]
            d2 = torch.sum(diff * diff, dim=-1)
            w = p_eff / (1.0 + d2)
            return torch.sum(w[..., None] * diff, dim=1).cpu().numpy()

        for it in range(cfg.max_iter):
            exag = cfg.early_exaggeration if it < cfg.exaggeration_iters else 1.0
            pos = pos_forces(torch.from_numpy(y).to(self.device, DTYPE),
                             vals_t * exag)
            tree = SpTree.build(y)
            neg = np.zeros_like(y)
            z = 0.0
            for i in range(n):
                f = np.zeros(cfg.n_components)
                z += tree.compute_non_edge_forces(y[i], cfg.theta, f)
                neg[i] = f
            g = pos - neg / max(z, 1e-12)
            mom = (cfg.momentum_initial if it < cfg.momentum_switch_iter
                   else cfg.momentum_final)
            same = np.sign(g) == np.sign(vel)
            gains = np.clip(np.where(same, gains * 0.8, gains + 0.2),
                            0.01, None)
            vel = mom * vel - lr * gains * g
            y = y + vel
            y -= y.mean(axis=0, keepdims=True)
        return y
