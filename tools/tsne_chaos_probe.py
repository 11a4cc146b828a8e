#!/usr/bin/env python3
"""How fast two exact t-SNE runs that start a rounding error apart part.

Run from the repo root (the CPU by default; ``--device cuda`` on a card):

    python3 tools/tsne_chaos_probe.py [--n 60] [--device cpu]

Uses the port's ``plot/tsne.py`` only.  For each configuration it runs
``exact_loop`` from one P and one ``y0`` three ways: float64, float64
with ``y0`` scaled by (1 + 1e-7), and float32; and prints, at iterations
5, 10, 20 and 50, the embedding's scale and the largest difference of
the perturbed and the float32 runs from the float64 run, relative to
that scale.  ``--n 60`` is the data of ``tests/test_torch_clustering_plot.py``
(three Gaussian blobs in 5-d, perplexity 10); ``--n 2404`` is eight
Gaussian clusters in 100-d at the t-SNE defaults (perplexity 30), the
size of ``chip_smoke.py``'s phase 25 embedding.

At the reference's defaults (learning rate ``max(N/12, 50)``, early
exaggeration 12 for 100 iterations) the points leave their 1e-4 start
within a few iterations and the run becomes chaotic: the gaps grow by
orders of magnitude every few iterations, so two correct
implementations agree only over the first iterations.  The stable
configurations are the ones the parity tests hold over 50 iterations.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def data(n: int):
    """(x, perplexity) for the probe's two sizes."""
    if n == 60:
        rng = np.random.RandomState(0)
        x = np.concatenate([rng.randn(20, 5) + c for c in (0.0, 6.0, -6.0)])
        return x, 10.0
    rng = np.random.RandomState(0)
    centres = rng.randn(8, 100)
    x = 0.3 * rng.randn(n, 100) + centres[rng.randint(8, size=n)]
    return x, 30.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=60, choices=(60, 2404))
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    import torch

    from deeplearning4j_tpu_torch import resolve_device
    from deeplearning4j_tpu_torch.plot import tsne

    dev = resolve_device(args.device)
    x, perplexity = data(args.n)
    p = tsne.joint_probabilities(x, perplexity)
    y0 = 1e-4 * np.random.RandomState(7).randn(args.n, 2)
    configs = [("defaults", {})]
    if args.n == 60:
        configs += [
            ("lr 2, exaggeration 10 its, momentum switch 25",
             dict(learning_rate=2.0, exaggeration_iters=10,
                  momentum_switch_iter=25)),
            ("lr 0.5, no exaggeration, momentum switch 25",
             dict(learning_rate=0.5, exaggeration_iters=0,
                  momentum_switch_iter=25))]
    for name, kw in configs:
        cfg = tsne.TsneConfig(perplexity=perplexity, **kw)
        lr = tsne._resolve_lr(cfg, args.n)
        print(f"N={args.n} {name} (learning rate {lr:g}) on {dev}:")
        for iters in (5, 10, 20, 50):
            def run(dtype, scale=1.0):
                y, _ = tsne.exact_loop(
                    torch.tensor(p, dtype=dtype, device=dev),
                    torch.tensor(y0 * scale, dtype=dtype, device=dev),
                    iters, cfg.exaggeration_iters, cfg.momentum_switch_iter,
                    lr, cfg.early_exaggeration, cfg.momentum_initial,
                    cfg.momentum_final)
                return y.double().cpu().numpy()

            ref = run(torch.float64)
            size = np.abs(ref).max()
            pert = np.abs(run(torch.float64, 1 + 1e-7) - ref).max() / size
            f32 = np.abs(run(torch.float32) - ref).max() / size
            print(f"  iteration {iters}: scale {size:.4g}, float64 with y0 "
                  f"x (1 + 1e-7) {pert:.3e}, float32 {f32:.3e} (relative "
                  f"to the float64 run)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
