#!/usr/bin/env python3
"""Why LeNet's fp32 losses on the card part from the CPU's on data/mnist.

Run from the repo root on a machine with one CUDA card:

    python3 tools/lenet_tie_probe.py

Prints, for the port's LeNet (bf16 and fp32 confs, seed 123) on the
first data/mnist batches at B=128:

1. each intermediate of one fp32 forward and backward (conv
   pre-activations, relu outputs, pooled maps, the dense layer) on the
   card and on the CPU against an fp64 CPU run: value and gradient
   errors (max |diff| / max |ref|), and the relu mask flips;
2. 10 fp32 training steps' losses from the same params under several
   convolutions: cuDNN on the card (default, deterministic, with
   cuDNN's fp32 precision set to "ieee", and cuDNN off), the CPU's own
   conv, and an im2col + GEMM conv on the card and on the CPU, each
   against the fp64 CPU run, the CPU conv and the CPU im2col;
3. one epoch's device busy time a step with cuDNN's conv and with the
   im2col conv (torch.profiler), in turns;
4. run-to-run spread: 10 fp32 steps on seeded random batches (the
   parity inputs of chip_smoke.py's phase 9) five times on the card
   with cuDNN's default algorithms and five with
   ``cudnn.deterministic``, each against the CPU, and the device busy
   time a bf16 step under each.

The data's flat saturated regions hold windows whose entries are equal
in exact arithmetic; which conv keeps them bit-equal decides where max
pooling sends their gradient.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 128
STEPS = 10


def im2col_conv(torch, cv):
    """``conv2d_nhwc`` as patches @ weights: every output row is one dot
    product in one order, so equal windows give bit-equal outputs."""
    import torch.nn.functional as F

    def conv(x, w, stride, padding):
        sh, sw = stride
        kh, kw, cin, cout = w.shape
        if padding == "SAME":
            top, bottom = cv.same_padding(x.shape[1], kh, sh)
            left, right = cv.same_padding(x.shape[2], kw, sw)
            x = F.pad(x, (0, 0, left, right, top, bottom))
        p = x.unfold(1, kh, sh).unfold(2, kw, sw)    # [B, Ho, Wo, C, kh, kw]
        n, ho, wo = p.shape[:3]
        p = p.permute(0, 1, 2, 4, 5, 3).reshape(n * ho * wo, kh * kw * cin)
        return (p @ w.reshape(kh * kw * cin, cout)).reshape(n, ho, wo, cout)
    return conv


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lenet_tie_probe: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from deeplearning4j_tpu_torch import resolve_device
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.fetchers import MnistDataFetcher
    from deeplearning4j_tpu_torch.models import lenet as ln
    from deeplearning4j_tpu_torch.nn.layers import convolution as cv
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.listeners import \
        CollectScoresListener
    from torch.profiler import ProfilerActivity, profile

    resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fetch = MnistDataFetcher(train=True, flatten=False, binarize=False)
    fetch.fetch(STEPS * B)
    batches = fetch.next().batch_by(B)
    params = ln.lenet(device="cpu").params
    p64 = [{k: v.double() for k, v in p.items()} for p in params]

    def net(dtype, pp, dev):
        return MultiLayerNetwork(
            ln.lenet_conf(compute_dtype=dtype),
            params=[{k: v.to(dev) for k, v in p.items()} for p in pp],
            device=dev)

    # -- 1. one forward and backward, intermediate by intermediate --------
    def intermediates(dtype, pp, dev):
        n = net(dtype, pp, dev)
        live = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                for p in n.params]
        x = batches[0].features.to(dev, getattr(torch, dtype))
        y = batches[0].labels.to(dev, getattr(torch, dtype))
        out = {}

        def keep(name, t):
            t.retain_grad()
            out[name] = t
            return t
        L = n.layers
        z0 = keep("conv1 pre-activation", L[0].pre_output(live[0], x))
        a0 = keep("conv1 relu", torch.relu(z0))
        p1 = keep("pool1", L[1].activate({}, a0))
        z2 = keep("conv2 pre-activation", L[2].pre_output(live[2], p1))
        a2 = keep("conv2 relu", torch.relu(z2))
        p3 = keep("pool2", L[3].activate({}, a2)).reshape(B, -1)
        a4 = keep("dense relu", L[4].activate(live[4], p3))
        L[5].loss(live[5], a4, y).backward()
        out["conv1 W"], out["conv2 W"] = live[0]["W"], live[2]["W"]
        return out

    ref = intermediates("float64", p64, "cpu")
    for dev in ("cuda", "cpu"):
        got = intermediates("float32", params, dev)
        for name, r in ref.items():
            a = got[name]
            val = float((a.detach().double().cpu() - r.detach()).abs().max()
                        / r.detach().abs().max())
            grad = float((a.grad.double().cpu() - r.grad).abs().max()
                         / r.grad.abs().max())
            flips = (int(((a.detach().cpu() > 0) != (r.detach() > 0)).sum())
                     if "pre-activation" in name else "-")
            print(f"1. fp32 {dev} {name}: value {val:.3e}, gradient "
                  f"{grad:.3e}, relu flips {flips}")

    # -- 2. ten steps under each convolution --------------------------------
    cudnn_conv, gemm_conv = cv.conv2d_nhwc, im2col_conv(torch, cv)

    def losses(dtype, pp, dev, conv, **flags):
        saved = {k: getattr(torch.backends.cudnn, k) for k in flags}
        for k, v in flags.items():
            setattr(torch.backends.cudnn, k, v)
        cv.conv2d_nhwc = conv
        try:
            n = net(dtype, pp, dev)
            col = CollectScoresListener()
            n.set_listeners([col])
            n.fit_backprop(batches)
        finally:
            cv.conv2d_nhwc = cudnn_conv
            for k, v in saved.items():
                setattr(torch.backends.cudnn, k, v)
        return np.array([s for _, s in col.scores])

    runs = {"fp64 CPU": losses("float64", p64, "cpu", cudnn_conv),
            "CPU conv": losses("float32", params, "cpu", cudnn_conv),
            "CPU im2col": losses("float32", params, "cpu", gemm_conv),
            "card cuDNN": losses("float32", params, "cuda", cudnn_conv),
            "card cuDNN deterministic": losses(
                "float32", params, "cuda", cudnn_conv, deterministic=True),
            "card cuDNN off": losses("float32", params, "cuda", cudnn_conv,
                                     enabled=False),
            "card im2col": losses("float32", params, "cuda", gemm_conv)}
    conv_prec = torch.backends.cudnn.conv
    saved = conv_prec.fp32_precision
    conv_prec.fp32_precision = "ieee"
    runs["card cuDNN ieee"] = losses("float32", params, "cuda", cudnn_conv)
    conv_prec.fp32_precision = saved
    for name, got in runs.items():
        print(f"2. {name}: " + " ".join(f"{v:.7f}" for v in got))
    for name, got in runs.items():
        print(f"2. {name}: largest relative difference " + ", ".join(
            f"{(np.abs(got - runs[b]) / np.abs(runs[b])).max():.3e} to {b}"
            for b in ("fp64 CPU", "CPU conv", "CPU im2col")))

    # -- 3. device time a step, cuDNN's conv and im2col in turns -------------
    dev_batches = [DataSet(b.features.cuda(), b.labels.cuda())
                   for b in batches]
    for name, conv in (("cuDNN", cudnn_conv), ("im2col", gemm_conv),
                       ("im2col", gemm_conv), ("cuDNN", cudnn_conv)):
        cv.conv2d_nhwc = conv
        n = ln.lenet(device="cuda")
        n.fit_backprop(dev_batches)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            n.fit_backprop(dev_batches)
            torch.cuda.synchronize()
        cv.conv2d_nhwc = cudnn_conv
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        print(f"3. bf16 LeNet, {name} conv: device busy "
              f"{busy / 1e3 / len(dev_batches):.4f} ms a step")

    # -- 4. run-to-run spread, default vs deterministic cuDNN ---------------
    rng = np.random.default_rng(0)
    x = rng.random((STEPS * B, 28, 28, 1), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, STEPS * B)]
    rand = DataSet(x, y).batch_by(B)
    cpu = None
    for det in (False, True):
        rels = []
        for _ in range(5):
            torch.backends.cudnn.deterministic = det
            n = net("float32", params, "cuda")
            col = CollectScoresListener()
            n.set_listeners([col])
            n.fit_backprop(rand)
            got = np.array([v for _, v in col.scores])
            if cpu is None:
                c = net("float32", params, "cpu")
                col = CollectScoresListener()
                c.set_listeners([col])
                c.fit_backprop(rand)
                cpu = np.array([v for _, v in col.scores])
            rels.append((np.abs(got - cpu) / cpu).max())
        n = ln.lenet(device="cuda")
        n.fit_backprop(dev_batches)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            n.fit_backprop(dev_batches)
            torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = False
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        print(f"4. cudnn.deterministic={det}: fp32 card vs CPU over "
              f"{STEPS} steps on seeded random batches, five runs: "
              + ", ".join(f"{r:.3e}" for r in rels)
              + f"; bf16 device busy {busy / 1e3 / len(dev_batches):.4f} "
              f"ms a step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
