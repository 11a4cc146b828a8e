#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold every
kernel on it against its plain PyTorch twin.

Run from the repo root:  python3 chip_smoke.py

Phases, each fatal on failure:
1. environment: the card's name and power limit, torch and CUDA versions;
2. build: every kernel under deeplearning4j_tpu_torch/csrc with nvcc
   for sm_90a (one nvcc per source, all started together);
3. kernels: the flash-attention forward against its plain twin on the
   card (bf16 3e-2, fp32 2e-5 — the tolerances of
   tests/test_pallas_attention.py), over BERT-base shapes, padded keys,
   causal, ragged T, Tq != Tk, fully masked rows (causal too), fp32 and
   other head dims, and the edges of the wgmma route (serving's B=1
   T=128, an odd count of 64-row tiles with a sequence fully masked,
   D=128 causal T=1024), each case printing its route; then kernel,
   plain twin and F.scaled_dot_product_attention (a yardstick the port
   never calls) timed with CUDA events at BERT's serving shapes and
   GPT-2 small's causal training shape;
4. BERT-base fill-mask serving at full width (12 x 768, 12 heads, vocab
   30522, bf16, seeded random weights) through InferenceEngine +
   DynamicBatcher, with client threads sending mixed requests at T=128
   and one T=512 request through its own engine.  Checks: each future
   gets its own rows, logits are finite and agree with an unpadded
   forward and with the plain-attention forward, and B1 launched exactly
   once per layer per dispatch;
5. BERT-base MLM training (B=32, T=128, dropout 0.1) and
6. GPT-2 small causal-LM training (B=8, T=1024), each through the
   model's make_train_step defaults (flash attention, adamw) at full
   width: 2 warm-up and 10 timed steps on a fixed batch, each block
   recomputed in the backward (cfg.remat).  Checks: the loss is finite
   and falls; B2 and B3 launch once per layer per step and B1 twice
   (forward and recompute); one dropout-0 step's gradients through the
   kernels agree
   with the plain attention's (global relative L2 <= 3e-2), and for
   BERT an fp32-compute step at depth 2 within 1e-4.  Prints step ms,
   tokens/s, the model-FLOPs share of 989 TFLOP/s and a profile of one
   step (B1/B2/B3, forward and backward products, optimizer, fp32 adds
   and fills) and the peak memory.

7. word2vec (the bench.py:676-678 config: D=100, window 5, 5 negatives,
   HS, batch 16,384) on data/text8 (50-word sentences, min count 5):
   masked cold fit, warm refit and one profiled epoch, then exact and
   device pair modes; on a 2M-word Zipf corpus of 71,290 names (cold
   and warm); ParagraphVectors over the labelled text8 sentences.
   Checks: B4 launches once per chunk on every path, finite tables,
   tests/test_nlp.py's text8 neighbour check, and one epoch through B4
   against one through the plain twin with the same draws (1e-4);
8. GloVe (GloveConfig defaults) on text8 and the Zipf corpus: B5
   launches once per chunk, the loss falls, one epoch through B5
   against one through the plain twin with the same permutation.
   Prints words/s and triples/s (host clock after synchronize) and the
   device-busy share of one profiled epoch.
9. LeNet-MNIST (models/lenet.py at full width, seeded weights) on
   data/mnist (2,048 train, 512 test images), B=128: the same params and
   10 seeded random batches through the port on the card and on the CPU
   (per-step losses fp32 rtol 1e-4, bf16 5e-2), 10 data/mnist batches
   the same way (printed, not held: exact max-pool ties there are
   broken by each conv algorithm's rounding), max pooling's tie routing
   card vs CPU (equal), the bf16 dense product with cuBLAS's
   reduced-precision reduction on and off; fit_backprop and
   fit_iterator for 2 epochs each (bf16), then evaluate on the test
   split (accuracy >= 0.90); a warmed serving engine's mixed-size
   stream against the unpadded forward (bf16 3e-2, fp32 2e-5); the
   step's time (median of 207 synchronized steps, and the staged path
   between CUDA events), the busy share and device ms by kernel kind of
   one profiled epoch, peak memory.  No hand kernel runs here (the
   path is cuDNN and cuBLAS): their launch counts must stay 0.
10. GPT-2 small generation serving (gpt.gpt_config() at full width and
   depth, bf16, seeded random weights): (a) 4 prompts of 128 tokens,
   64 greedy tokens through gpt.generate, its prefill and step logits
   teacher-forced against forward_logits over prompt + tokens (bf16 5e-2,
   fp32 1e-3) and its tokens against the dense argmax wherever the
   dense top-2 margin exceeds the bar; (b) a seeded burst of 32 requests
   (prompts 16-512, 64 tokens, half greedy, half sampled at 0.8 with
   their own seeds) through DecodeEngine(n_slots=8, buckets 32-1024) +
   ContinuousBatcher: TTFT and per-step latency p50/p99 and tokens/s,
   against the same burst as sequential solo generate calls; requests
   join mid-flight and every slot is free at the end; every sampled
   request gives the same tokens resubmitted alone; one decode step of
   8 slots in bucket 1024 timed (host) and profiled (device ms,
   kernels), the burst profiled for its busy share; the burst in fp32,
   each greedy request token-identical to its solo generate up to the
   solo run's first step of top-2 margin below 1e-3; (c) the burst with
   int8 weights + int8 KV and with bf16 weights (tokens/s,
   kv_bytes_per_slot, the dequantization's ms a dispatch, greedy
   agreement with full precision), int8 on the card against the port's
   CPU (round trip within scale / 2, payloads, prefill logits within 5%
   of their scale: tests/test_serving_tier2.py:70, :204); (d) GPT
   scoring through InferenceEngine(gpt.make_serving_apply) at T=1024
   causal, buckets 1/2/4: logits within 5e-2 of the plain-attention
   forward, and one row through InferenceEngine(quantize="int8") within
   5e-2 of the plain-attention forward of the dequantized tree; B1 launched 12 times a
   dispatch and never on the decode path.  Every line ends with the card's name and power limit.
11. the compile engine (runtime/compile_cache): each of the five
   captured paths runs the same seeded inputs through its raw function
   (``call.fn``, or every engine entry made eager for the loops) and
   through its CUDA graphs: LeNet fp32 B=128, 20 steps (losses and
   params within 1e-6 relative, cuDNN deterministic for both), then two
   same-conf LeNet fits at once in two threads through the shared step,
   each against its solo eager fit (1e-6); BERT-base MLM B=32 T=128 and
   GPT-2 small B=8 T=1024 (remat), 10 bf16 steps with dropout (loss per
   step, and the relative L2 of the params' change from the initial
   state, within 1e-6), then two BERT states stepped alternately through
   one step_fn, each against its solo eager run (1e-6), the initial
   states unchanged; slot_decode's logits at 8 slots in bucket 1024
   (fp32 1e-5, bf16 5e-2), the 32-request burst and one decode step,
   which must copy no byte into the graphs' buffers; one word2vec and
   one GloVe epoch on text8 (1e-4 relative L2).  Each path prints host ms
   (median of synchronized calls), device ms and the busy share, eager
   beside captured, and holds its steady state to zero new captures;
   the captures per label must equal the signatures the entries hold.
12. self-healing training, checkpoints and run telemetry
   (runtime/{checkpoint,resilience,telemetry,metrics}): (a) ResilientFit
   over LeNet-MNIST (bf16, data/mnist, B=128, 3 epochs, async snapshots
   every 8 steps, cuDNN deterministic) with one batch NaN-poisoned on its
   first read and an injected detector forcing one rollback:
   steps_skipped == 1, rollbacks == 1, params finite; the same run
   stopped at max_steps=20 and resumed with resume=True ends torch.equal
   to the uninterrupted run (final params, and the newest common
   snapshot leaf for leaf, momentum state included); a programmatic
   PreemptionGuard.request() stops at the next boundary with one final
   sync snapshot; no capture after warm-up across all of it; (b) GPT-2
   small's training state (B=8, T=1024, remat, dropout, adamw; B1-B3 on
   the path): 2 steps, an AsyncCheckpointer.save, 2 steps dispatched
   behind it at once, then the snapshot restored into a fresh run that
   replays those 2 steps with the same batches and dropout streams:
   bit-identical to the uninterrupted run, no new capture; the
   checkpointer's pinned pool is reserved for the state before training,
   so the first snapshot's staging is within 5x of a second one's; it
   prints the snapshot's bytes, the training thread's staging ms, the
   writer's commit ms and write-behind lag, and the step's ms (CUDA
   events) with and without a snapshot in flight; (c) the telemetry registry's
   snapshot (all nine counter families, peak_bytes_in_use) and part
   (a)'s journal and Chrome trace, summarized.  Checkpoints go under a
   temporary directory that is removed at the end.
13. MultiLayerNetwork.fit and what it reaches (optimize/{solver,
   line_search,hessian_free}, the RBM and autoencoder, cli.py): (1)
   LeNet-MNIST (fp32, B=128) through net.fit(batches, num_epochs=2), the
   finetune of the output layer through the solver (its scores fall, the
   iterations run before a termination printed) then fit_backprop; test
   accuracy >= 0.90; the finetune's scores against the port's CPU
   finetune on the card's activations (rtol 1e-4); ms a GD iteration and
   the host read's share; (2) prepare_resilient_fit -> ResilientFit:
   params torch.equal to finetune's, 0 captures after warm-up; (3) a deep
   belief net at Hinton, Osindero & Teh (2006)'s MNIST widths
   784-500-500-2000 (binary RBMs, CD-1, 10 steps a batch) on binarized
   data/mnist through fit (pretrain, finetune, one backprop epoch): each
   RBM's reconstruction error falls (mean of its last 10 steps below its
   first 10), test accuracy printed, a second pretrain with the seed
   torch.equal, the device ms of a CD-1 step a layer; the same widths with
   denoising autoencoders (corruption 0.25), whose losses fall; (4) CG
   and L-BFGS (30 iterations) on the DBN's 2000x10 output layer over the
   merged 2,048 rows: the score never rises, card vs CPU on the same
   activations within rtol 1e-4 an iteration with the same line-search
   trials; (5) Hessian-free on Martens (2010)'s curves deep autoencoder
   784-400-200-100-50-25-6-25-50-100-200-400-784 (sigmoid layers, logistic
   outputs under cross-entropy, weights N(0, 9/fan_in)) over
   CurvesDataFetcher(n=20000): 5 outer iterations take the score below
   0.9 of its start, no capture after the first as lambda adapts; ms an
   outer iteration, CG iterations, ms a damped Gauss-Newton product; (6)
   the CLI in subprocesses on the card: train (mnist2d, LeNet conf, one
   epoch), test and predict (the written classes score test's accuracy),
   train
   --checkpoint-dir, the same command refused in one line, --resume; each
   command's wall time; the phase's peak memory.  No hand kernel runs
   here (the path is cuBLAS, cuDNN and torch ops): their launch counts
   must stay 0.

Phases 4-10 run through the compile engine as a user's calls do: every
serving dispatch, training step, decode and prefill dispatch and
embedding chunk is a CUDA graph replay after its signature's capture,
and the kernel wrappers' launch counts are booked once per replay.

Phase 3 also holds the backward kernels B2 (dK/dV) and B3 (dQ) against
their plain twins on the same 17 cases (bf16 within 3e-2 of the case's
largest |grad|, fp32 5e-4), and times them (profiler, per kernel) beside
their twins, their bound and the backward of
F.scaled_dot_product_attention.  The twins skip B1's causal tiles
(causal_tile=CAUSAL_TILE), so every row is held, a causal row whose every
key is masked included; each case prints the route the kernels took
(wgmma, mma.sync or cuda-cores).  Phase 2 fails if a Hopper (wgmma)
kernel spills registers, and prints the Hopper kernels' dynamic shared
memory.  Phase 3c holds B4 (word2vec chunk, which updates its tables in
place, so each call gets copies) against its plain twin evaluated in
fp64 on 11 cases (the JAX test shape, text8 and Zipf shapes, padded
pairs, negative == target, D=50, 300 and 600, the last through the
kernel's wide path) and B5 (GloVe chunk) in its accumulator mode against
its twin on 5 (D=600 the wide path), and B5's in-place chunk step
against glove_chunk_step_plain on 4 of them (text8, Zipf, 25% masked,
D=600), with tolerances from each chunk's hit counts (see U32; B5's per
entry, carried through the AdaGrad step for the step cases).  It times
both at the text8 and Zipf shapes: B4's call as the device time summed
over its phases (profiler) and as a whole call (CUDA events), B5's chunk
step beside the old composition (accumulator mode, two apply_chunk, the
cat and the slice writes) in the same run, each beside its twin and
bound; no PyTorch call computes either function, so they have no
library time.

Prints one {"kernels": [...]} line and, last, {"ok": true, "device": ...}.
Exits non-zero, printing no result, when CUDA is absent or any phase
fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: published dense peaks of an H100 SXM at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

TOL = {"bfloat16": 3e-2, "float32": 2e-5}
LOGITS_TOL = 5e-2          # bf16 logits, as the CPU parity tests
MIN_ARGMAX_AGREE = 0.99


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(torch, fn, iters: int = 50, warmup: int = 3) -> float:
    """Device ms per call, CUDA events around ``iters`` calls.  A sleep
    kernel holds the stream first, so the host enqueues the calls ahead
    and the events time the device, not the Python wrapper."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound(B, NH, Tq, Tk, D, itemsize, causal):
    """(bound_ms, bound_by) of a bf16 call: the larger of the FLOPs over
    the bf16 peak and the bytes (q, k, v, o, bias, lse once each) over
    the memory rate."""
    flops = 4.0 * B * NH * Tq * Tk * D * (0.5 if causal else 1.0)
    nbytes = (itemsize * B * NH * D * (2 * Tq + 2 * Tk)
              + 4 * B * Tk + 4 * B * NH * Tq)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ptxas_summary(log: str):
    """One entry per kernel of an ``nvcc -Xptxas -v`` report: (its name
    and template argument, a line with its registers, static shared
    memory and spill stores and loads, spilled bytes)."""
    import re

    out, kernel, spill = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = kernel = entry.group(1)
            spill = ""
            # <length><identifier> of the kernel, then its template int;
            # the digits before it may end a hex namespace hash
            for m in re.finditer(r"(\d+)((?:flash|w2v|glove)_\w+)",
                                   mangled):
                digits, rest = m.group(1), m.group(2)
                for i in range(len(digits)):
                    ident = rest[:int(digits[i:])]
                    if ident.endswith("_kernel"):
                        arg = re.match(r"ILi(\d+)E", rest[len(ident):])
                        kernel = ident + (f"<{arg.group(1)}>" if arg
                                          else "")
                        break
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line and kernel is not None:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            spilled = sum(int(n) for n in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", spill))
            out.append((kernel, f"{kernel}: {regs.group(1) if regs else '?'} "
                        f"registers, {smem.group(1) if smem else 0} bytes "
                        f"static smem; {spill}", spilled))
            kernel = None
    return out


# ---------------------------------------------------------------------------
# phase 3: the flash kernel against its plain twin
# ---------------------------------------------------------------------------

KERNEL_CASES = [
    # name, B, NH, Tq, Tk, D, dtype, causal, key lengths (None = all live)
    ("bert-base T=128", 8, 12, 128, 128, 64, "bfloat16", False, None),
    ("bert-base T=512", 8, 12, 512, 512, 64, "bfloat16", False, None),
    ("padded keys", 8, 12, 128, 128, 64, "bfloat16", False,
     [128, 100, 64, 1, 77, 128, 5, 120]),
    ("causal", 4, 12, 256, 256, 64, "bfloat16", True, None),
    ("causal ragged, padded", 2, 4, 200, 200, 64, "bfloat16", True,
     [200, 150]),
    ("ragged T=200", 4, 12, 200, 200, 64, "bfloat16", False,
     [200, 180, 64, 3]),
    ("Tq != Tk", 2, 4, 100, 300, 64, "bfloat16", False, [300, 211]),
    ("fully masked row", 2, 4, 128, 128, 64, "bfloat16", False, [0, 100]),
    ("fp32", 4, 12, 128, 128, 64, "float32", False, [128, 90, 33, 128]),
    ("fp32 causal D=128", 2, 4, 160, 160, 128, "float32", True, None),
    ("fp32 D=256", 1, 2, 96, 96, 256, "float32", False, [70]),
    ("D=128", 4, 8, 256, 256, 128, "bfloat16", False, [256, 200, 7, 256]),
    ("D=256", 1, 4, 130, 130, 256, "bfloat16", False, [130]),
    ("D=40", 2, 3, 70, 70, 40, "bfloat16", True, [70, 41]),
    # one sequence's keys all masked under causal masking: its rows see
    # only the -1e5 scores of the 64-key tiles B1 walked, which the
    # tile-exact twins (causal_tile=CAUSAL_TILE) follow
    ("causal, one sequence fully masked", 2, 12, 256, 256, 64, "bfloat16",
     True, [0, 256]),
    ("D=128 causal", 2, 4, 256, 256, 128, "bfloat16", True, [256, 190]),
    ("Tq != Tk D=128", 2, 4, 300, 100, 128, "bfloat16", False, [100, 57]),
]

#: forward-only cases at the edges of the wgmma B1: serving's smallest
#: bucket (12 CTAs); an odd count of 64-row tiles, so the last 128-row
#: CTA's second warpgroup has no rows, with one causal sequence fully
#: masked; and D=128 causal at GPT-2 small's length
FWD_CASES = KERNEL_CASES + [
    ("serving B=1 T=128", 1, 12, 128, 128, 64, "bfloat16", False, [128]),
    ("causal T=192, one sequence fully masked", 2, 12, 192, 192, 64,
     "bfloat16", True, [0, 192]),
    ("D=128 causal T=1024", 2, 4, 1024, 1024, 128, "bfloat16", True, None),
]


def kernel_phase(torch, fa):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    worst = 0.0
    for name, B, NH, Tq, Tk, D, dt, causal, lens in FWD_CASES:
        dtype = getattr(torch, dt)

        def rand(T):
            return torch.randn((B, T, NH, D), generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)

        q, k, v = rand(Tq), rand(Tk), rand(Tk)
        mask = None
        if lens is not None:
            mask = (torch.arange(Tk, device="cuda")[None, :]
                    < torch.tensor(lens, device="cuda")[:, None]).float()
        bias = None if mask is None else (1.0 - mask) * fa.MASK_VAL

        def bhtd(x):
            return x.permute(0, 2, 1, 3).reshape(B * NH, x.shape[1], D) \
                .contiguous()

        q4, k4, v4 = bhtd(q), bhtd(k), bhtd(v)
        o, lse = fa.flash_attention_fwd_cuda(q4, k4, v4, bias, causal)
        o_h = fa.flash_attention(q, k, v, mask, causal)   # [B, T, NH, D]
        o_ref, lse_ref = fa.flash_attention_fwd_plain(
            q4, k4, v4, bias, causal, causal_tile=fa.CAUSAL_TILE)
        torch.cuda.synchronize()
        tol = TOL[dt]
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_h = (bhtd(o_h).float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        ok = (torch.allclose(o.float(), o_ref.float(), rtol=tol, atol=tol)
              and torch.allclose(bhtd(o_h).float(), o_ref.float(),
                                 rtol=tol, atol=tol)
              and torch.allclose(lse, lse_ref, rtol=tol, atol=tol)
              and bool(torch.isfinite(o.float()).all()))
        print(f"  kernel case {name!r} [{fa.fwd_route(dtype, D)}]: B={B} "
              f"NH={NH} Tq={Tq} Tk={Tk} "
              f"D={D} {dt} causal={causal}: max|o-o_plain|={err_o:.3e} "
              f"([B,T,NH,D] path {err_h:.3e}) max|lse-lse_plain|="
              f"{err_lse:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
        check(ok, f"flash kernel disagrees with its plain twin: {name}")
        worst = max(worst, err_o, err_h)
    return worst


def time_flash(torch, F, fa, B, T, NH=12, D=64, causal=False):
    """Kernel, plain twin and SDPA, bf16: at a serving shape with the
    all-live mask bias of the serving path, or causal with no bias, as
    GPT's training path calls it."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    def rand():
        return torch.randn((B * NH, T, D), generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)

    q4, k4, v4 = rand(), rand(), rand()
    bias = None if causal else torch.zeros((B, T), device="cuda",
                                           dtype=torch.float32)
    q_s, k_s, v_s = (x.view(B, NH, T, D) for x in (q4, k4, v4))
    with torch.inference_mode():
        ms = time_ms(torch, lambda: fa.flash_attention_fwd_cuda(
            q4, k4, v4, bias, causal))
        plain_ms = time_ms(torch, lambda: fa.flash_attention_fwd_plain(
            q4, k4, v4, bias, causal), iters=10)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q_s, k_s, v_s, is_causal=causal))
    bound_ms, bound_by = flash_bound(B, NH, T, T, D, 2, causal)
    flops = 4.0 * B * NH * T * T * D * (0.5 if causal else 1.0)
    print(f"  flash fwd B={B} NH={NH} T={T} D={D} bf16 causal={causal} "
          f"[{fa.fwd_route(torch.bfloat16, D)}]: "
          f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
          f"{ms / lib_ms:.2f}x sdpa), plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by}) [events]")
    return ms, plain_ms, lib_ms, bound_ms, bound_by


# ---------------------------------------------------------------------------
# phase 3b: the backward kernels against their plain twins
# ---------------------------------------------------------------------------

BWD_TOL = {"bfloat16": 3e-2, "float32": 5e-4}


def bwd_error(torch, got, ref, dt: str):
    """(max |got - ref|, ok): bf16 within 3e-2 of the case's largest
    |grad|, fp32 within 5e-4 (tests/test_pallas_attention.py:55)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    tol = BWD_TOL[dt]
    if dt == "bfloat16":
        ok = err <= tol * max(ref.abs().max().item(), 1e-30)
    else:
        ok = bool(torch.allclose(got, ref, rtol=tol, atol=tol))
    return err, ok and bool(got.isfinite().all())


def kernel_bwd_phase(torch, fa):
    """B2 and B3 on the kernel cases, against the tile-exact plain twins
    (causal_tile=CAUSAL_TILE) fed the same o and lse (B1's), through the
    [BH, T, D] entry point and through autograd on [B, T, NH, D]; each
    case prints the route the C entry points took."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    worst = {"dkv": 0.0, "dq": 0.0}
    for name, B, NH, Tq, Tk, D, dt, causal, lens in KERNEL_CASES:
        dtype = getattr(torch, dt)

        def rand(T):
            return torch.randn((B, T, NH, D), generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)

        q, k, v, do = rand(Tq), rand(Tk), rand(Tk), rand(Tq)
        mask = None
        if lens is not None:
            mask = (torch.arange(Tk, device="cuda")[None, :]
                    < torch.tensor(lens, device="cuda")[:, None]).float()
        bias = None if mask is None else (1.0 - mask) * fa.MASK_VAL

        def bhtd(x):
            return x.permute(0, 2, 1, 3).reshape(B * NH, x.shape[1], D) \
                .contiguous()

        q4, k4, v4, do4 = bhtd(q), bhtd(k), bhtd(v), bhtd(do)
        o, lse = fa.flash_attention_fwd_cuda(q4, k4, v4, bias, causal)
        dq, dk, dv = fa.flash_attention_bwd_cuda(q4, k4, v4, bias, o, lse,
                                                 do4, causal)
        qh, kh, vh = (x.clone().requires_grad_(True) for x in (q, k, v))
        oh = fa.flash_attention(qh, kh, vh, mask, causal)
        gh = torch.autograd.grad(oh, (qh, kh, vh), do)
        dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(
            q4, k4, v4, bias, o, lse, do4, causal,
            causal_tile=fa.CAUSAL_TILE)
        dq_ref = fa.flash_attention_bwd_dq_plain(
            q4, k4, v4, bias, o, lse, do4, causal,
            causal_tile=fa.CAUSAL_TILE)
        torch.cuda.synchronize()
        errs, oks = {}, []
        for label, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                                ("dv", dv, dv_ref),
                                ("dq[BTHD]", bhtd(gh[0]), dq_ref),
                                ("dk[BTHD]", bhtd(gh[1]), dk_ref),
                                ("dv[BTHD]", bhtd(gh[2]), dv_ref)):
            errs[label], ok = bwd_error(torch, got, ref, dt)
            oks.append(ok)
        ok = all(oks)
        print(f"  backward case {name!r} [{fa.bwd_route(dtype, D)}]: "
              + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
              + f" (max|ref| dq {dq_ref.float().abs().max().item():.3e}, "
              f"dk {dk_ref.float().abs().max().item():.3e}, dv "
              f"{dv_ref.float().abs().max().item():.3e}) tol="
              f"{BWD_TOL[dt]:g}{' x max|ref|' if dt == 'bfloat16' else ''} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"flash backward kernels disagree with their plain twins: "
                  f"{name}")
        worst["dkv"] = max(worst["dkv"], errs["dk"], errs["dv"],
                           errs["dk[BTHD]"], errs["dv[BTHD]"])
        worst["dq"] = max(worst["dq"], errs["dq"], errs["dq[BTHD]"])
    return worst


def bwd_bound(B, NH, Tq, Tk, D, itemsize, causal, kernel):
    """(bound_ms, bound_by) of B2 ("dkv") or B3 ("dq"): the larger of
    its FLOPs (8 or 6 * BH*Tq*Tk*D, halved when causal) over the bf16
    peak and its bytes (q, k, v, dO read and its gradients written once,
    lse, delta and the bias) over the memory rate."""
    BH = B * NH
    flops = ((8.0 if kernel == "dkv" else 6.0) * BH * Tq * Tk * D
             * (0.5 if causal else 1.0))
    grads = 2 * Tk if kernel == "dkv" else Tq
    nbytes = (itemsize * BH * D * (2 * Tq + 2 * Tk + grads)
              + 4 * 2 * BH * Tq + 4 * B * Tk)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def profile_kernel_ms(torch, fn, names, iters: int = 20):
    """Mean device ms per call of each kernel whose name contains one of
    ``names``, from torch.profiler over ``iters`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {n: 0.0 for n in names}
    for e in prof.key_averages():
        for n in names:
            if n in e.key:
                out[n] += e.self_device_time_total / 1e3 / iters
    return out


def profile_call_ms(torch, fn, iters: int = 20):
    """(device ms per call summed over every kernel and memset a call of
    ``fn`` launches, {name: ms per call}), torch.profiler over ``iters``
    calls after 3 warm-up calls.  A profile that reports no device time
    (the profiler on the card has returned an empty trace now and then)
    is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by = {e.key: e.self_device_time_total / 1e3 / iters
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0}
        if by:
            break
    return sum(by.values()), by


def phases(by, marks):
    """One line of a call's device ms by phase: each mark's kernels."""
    return ", ".join(f"{m} {sum(ms for k, ms in by.items() if m in k):.4f}"
                     for m in marks)


def time_flash_bwd(torch, F, fa, B, T, NH=12, D=64, causal=False):
    """B2 and B3 (device time of each, from the profiler), the whole
    backward call (CUDA events), their plain twins, and the backward of
    F.scaled_dot_product_attention (a yardstick the port never calls),
    bf16 with an all-live mask bias."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)

    def rand():
        return torch.randn((B * NH, T, D), generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)

    q4, k4, v4, do4 = rand(), rand(), rand(), rand()
    bias = torch.zeros((B, T), device="cuda", dtype=torch.float32)
    o, lse = fa.flash_attention_fwd_cuda(q4, k4, v4, bias, causal)
    args = (q4, k4, v4, bias, o, lse, do4, causal)
    prof = profile_kernel_ms(torch, lambda: fa.flash_attention_bwd_cuda(
        *args), ("flash_bwd_dkv", "flash_bwd_dq"))
    call_ms = time_ms(torch, lambda: fa.flash_attention_bwd_cuda(*args))
    dkv_plain = time_ms(torch, lambda: fa.flash_attention_bwd_dkv_plain(
        *args), iters=10)
    dq_plain = time_ms(torch, lambda: fa.flash_attention_bwd_dq_plain(
        *args), iters=10)
    qs, ks, vs = (x.view(B, NH, T, D).detach().requires_grad_(True)
                  for x in (q4, k4, v4))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    dos = do4.view(B, NH, T, D)
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, (qs, ks, vs), dos, retain_graph=True))
    rows = {}
    for kernel, ms, plain_ms in (("dkv", prof["flash_bwd_dkv"], dkv_plain),
                                 ("dq", prof["flash_bwd_dq"], dq_plain)):
        bound_ms, bound_by = bwd_bound(B, NH, T, T, D, 2, causal, kernel)
        rows[kernel] = (ms, plain_ms, lib_ms, bound_ms, bound_by)
    # achieved rates on the FLOPs each kernel runs (B2 four products, B3
    # three, halved when causal); SDPA's backward on its five
    half = 0.5 if causal else 1.0
    fl = {"dkv": 8.0 * B * NH * T * T * D * half,
          "dq": 6.0 * B * NH * T * T * D * half}
    pair_ms = rows["dkv"][0] + rows["dq"][0]
    print(f"  flash bwd B={B} NH={NH} T={T} D={D} bf16 causal={causal} "
          f"[{fa.bwd_route(torch.bfloat16, D)}]: B2 {rows['dkv'][0]:.4f} ms "
          f"(bound {rows['dkv'][3]:.4f}, {rows['dkv'][4]}; "
          f"{fl['dkv'] / rows['dkv'][0] / 1e9:.1f} TFLOP/s), B3 "
          f"{rows['dq'][0]:.4f} ms (bound {rows['dq'][3]:.4f}, "
          f"{rows['dq'][4]}; {fl['dq'] / rows['dq'][0] / 1e9:.1f} TFLOP/s), "
          f"B2 + B3 {pair_ms:.4f} ms ({(fl['dkv'] + fl['dq']) / pair_ms / 1e9:.1f}"
          f" TFLOP/s, {pair_ms / lib_ms:.2f}x sdpa's backward) [profiler]; "
          f"whole backward call {call_ms:.4f} ms [events]; plain B2 "
          f"{dkv_plain:.4f} ms, plain B3 {dq_plain:.4f} ms; sdpa backward "
          f"{lib_ms:.4f} ms ({10.0 * B * NH * T * T * D * half / lib_ms / 1e9:.1f}"
          f" TFLOP/s) [events]")
    check(rows["dkv"][0] > 0 and rows["dq"][0] > 0,
          "the profiler saw no device time for B2/B3")
    return rows


# ---------------------------------------------------------------------------
# phase 4: BERT-base fill-mask serving
# ---------------------------------------------------------------------------

def compare(got: np.ndarray, ref, what: str):
    """Logits against a reference forward: (max |diff|, argmax matches,
    positions).  Fails beyond the bf16 logits tolerance."""
    ref = ref.float().cpu().numpy()
    check(got.shape == ref.shape, f"{what}: shape {got.shape} != {ref.shape}")
    err = float(np.abs(got - ref).max())
    check(np.allclose(got, ref, rtol=LOGITS_TOL, atol=LOGITS_TOL),
          f"{what}: logits differ by up to {err} (tolerance {LOGITS_TOL})")
    same = int((got.argmax(-1) == ref.argmax(-1)).sum())
    return err, same, got.shape[0] * got.shape[1]


def check_agreement(rows, what: str) -> float:
    """Aggregate (err, matches, positions) rows; fail under 99% argmax."""
    err = max(r[0] for r in rows)
    same, total = sum(r[1] for r in rows), sum(r[2] for r in rows)
    frac = same / total
    print(f"  {what}: max|diff|={err:.3e} (tolerance {LOGITS_TOL}), "
          f"fill-mask argmax agreement {same}/{total} = {frac:.4f} "
          f"(need >= {MIN_ARGMAX_AGREE})")
    check(frac >= MIN_ARGMAX_AGREE, f"{what}: argmax agreement {frac}")
    return err


class PlainAgreement:
    """The served (kernel-path) logits against the same forward with the
    plain attention (bf16) and with fp32 compute, over many requests.

    With random weights about 1% of positions have a top-1/top-2 logit
    gap below bf16's resolution, and any two bf16 forwards — with or
    without the kernel — disagree on about that many argmaxes.  So the
    99% argmax bar is held on the positions the fp32 forward resolves
    (gap >= 2^-8 of its largest logit), and over all positions the
    kernel path must agree with fp32 as well as the plain path does."""

    TIE = 2.0 ** -8

    def __init__(self, what: str):
        self.what = what
        self.err = 0.0
        self.n = self.same = self.n_res = self.same_res = 0
        self.kernel_fp32 = self.plain_fp32 = 0

    def add(self, got: np.ndarray, plain, fp32) -> None:
        plain = plain.float().cpu().numpy()
        fp32 = fp32.float().cpu().numpy()
        check(got.shape == plain.shape == fp32.shape,
              f"{self.what}: shapes {got.shape} {plain.shape} {fp32.shape}")
        err = float(np.abs(got - plain).max())
        check(np.allclose(got, plain, rtol=LOGITS_TOL, atol=LOGITS_TOL),
              f"{self.what}: logits differ from the plain-attention "
              f"forward by up to {err} (tolerance {LOGITS_TOL})")
        self.err = max(self.err, err)
        a_k, a_p, a_32 = got.argmax(-1), plain.argmax(-1), fp32.argmax(-1)
        top2 = np.partition(fp32, -2, axis=-1)[..., -2:]
        resolved = (top2[..., 1] - top2[..., 0]) >= \
            self.TIE * float(np.abs(fp32).max())
        self.n += a_k.size
        self.same += int((a_k == a_p).sum())
        self.n_res += int(resolved.sum())
        self.same_res += int((a_k == a_p)[resolved].sum())
        self.kernel_fp32 += int((a_k == a_32).sum())
        self.plain_fp32 += int((a_p == a_32).sum())

    def check(self) -> None:
        res = self.same_res / self.n_res
        k32, p32 = self.kernel_fp32 / self.n, self.plain_fp32 / self.n
        print(f"  {self.what}: max|diff| vs plain attention {self.err:.3e} "
              f"(tolerance {LOGITS_TOL}); fill-mask argmax agreement "
              f"{self.same}/{self.n} = {self.same / self.n:.4f} over all "
              f"positions, {self.same_res}/{self.n_res} = {res:.4f} over "
              f"the positions fp32 resolves (need >= {MIN_ARGMAX_AGREE}); "
              f"agreement with the fp32 forward: kernel path {k32:.4f}, "
              f"plain path {p32:.4f}")
        check(res >= MIN_ARGMAX_AGREE,
              f"{self.what}: resolved argmax agreement {res}")
        check(k32 >= p32 - 0.005,
              f"{self.what}: kernel path agrees with fp32 on {k32}, the "
              f"plain path on {p32}")


def serving_phase(torch, fa):
    from deeplearning4j_tpu_torch.models import bert
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.runtime.metrics import serving_metrics
    from deeplearning4j_tpu_torch.serving.batcher import DynamicBatcher
    from deeplearning4j_tpu_torch.serving.engine import InferenceEngine

    cfg = bert.bert_base()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = bert.init_params(gen, cfg, device="cuda")
    apply_fn = bert.make_serving_apply(cfg)
    eng = InferenceEngine(apply_fn, params, max_batch_size=32)
    w = eng.warmup(input_shape=(128,), dtype=np.int32)
    print(f"  warmup: {w['buckets']} buckets in {w['warmup_ms']:.1f} ms")

    rng = np.random.default_rng(0)

    def request(rows, T):
        ids = rng.integers(1000, cfg.vocab_size, (rows, T)).astype(np.int32)
        ids[rng.random((rows, T)) < 0.15] = 103       # [MASK]
        return ids

    reqs = [request(int(rng.integers(1, 9)), 128) for _ in range(24)]
    long_req = request(4, 512)
    eng512 = InferenceEngine(apply_fn, params, max_batch_size=4)
    eng512.warmup(input_shape=(512,), dtype=np.int32)

    # -- the main path, counted ------------------------------------------
    results = [None] * len(reqs)
    errors = []
    batcher = DynamicBatcher(eng, max_batch_size=32, max_delay_ms=5.0)

    def client(ids):
        try:
            futs = [(i, batcher.submit(reqs[i])) for i in ids]
            for i, f in futs:
                results[i] = f.result(timeout=300)
        except Exception as e:      # surfaced below, after the join
            errors.append(e)

    n_clients = 4
    threads = [threading.Thread(target=client,
                                args=(range(c, len(reqs), n_clients),))
               for c in range(n_clients)]
    fa.reset_launches()
    serving_metrics.reset()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    batcher.close()
    check(not any(t.is_alive() for t in threads), "client threads hung")
    check(not errors, f"client errors: {errors!r}")
    snap = serving_metrics.snapshot()
    launches_batched = fa.launches
    out512 = eng512.infer(long_req, sync=True).float().cpu().numpy()
    launches_total = fa.launches

    tokens = sum(r.size for r in reqs)
    print(f"  served {len(reqs)} requests ({tokens} tokens) from "
          f"{n_clients} client threads in {wall * 1e3:.1f} ms: "
          f"{tokens / wall:.1f} tokens/s; {snap['dispatches']} dispatches, "
          f"{snap['batches_formed']} batches, padding waste "
          f"{snap['padding_waste_ratio']:.3f}; request latency p50 "
          f"{snap['latency_p50_ms']:.2f} ms p99 "
          f"{snap['latency_p99_ms']:.2f} ms ({snap['latency_samples']} "
          f"samples)")
    print(f"  flash launches: {launches_batched} over "
          f"{snap['dispatches']} batched dispatches, "
          f"{launches_total - launches_batched} for the T=512 dispatch "
          f"({cfg.n_layers} layers)")
    check(snap["dispatches"] > 0, "no dispatch ran")
    check(launches_batched == cfg.n_layers * snap["dispatches"],
          "flash kernel launches != layers x batched dispatches")
    check(launches_total - launches_batched == cfg.n_layers,
          "flash kernel launches != layers for the T=512 dispatch")

    # -- correctness of what came out ------------------------------------
    vocab = cfg.vocab_size
    plain_apply = bert.make_serving_apply(cfg, attn_fn=tfm.attention)
    fp32_apply = bert.make_serving_apply(
        dataclasses.replace(cfg, compute_dtype="float32"),
        attn_fn=tfm.attention)
    own = []
    plain = PlainAgreement("T=128 results")
    plain512 = PlainAgreement("T=512 result")
    with torch.inference_mode():
        for i, (x, got) in enumerate(zip(reqs, results)):
            check(got is not None and got.shape == (x.shape[0], 128, vocab),
                  f"request {i}: bad result shape "
                  f"{None if got is None else got.shape}")
            check(bool(np.isfinite(got).all()), f"request {i}: non-finite")
            xt = torch.from_numpy(x).cuda()
            own.append(compare(got, apply_fn(params, xt),
                               f"request {i} vs its unpadded forward"))
            plain.add(got, plain_apply(params, xt), fp32_apply(params, xt))
        check(bool(np.isfinite(out512).all()), "T=512 logits non-finite")
        xt = torch.from_numpy(long_req).cuda()
        plain512.add(out512, plain_apply(params, xt), fp32_apply(params, xt))
    check_agreement(own, "batched results vs each request's unpadded "
                         "forward (own rows)")
    plain.check()
    plain512.check()

    # -- where a full dispatch's time goes ---------------------------------
    x32 = request(32, 128)
    fwd, d2h = [], []
    for _ in range(7):
        t0 = time.perf_counter()
        out = eng.infer(x32, sync=True)
        t1 = time.perf_counter()
        out.cpu().numpy()
        d2h.append(time.perf_counter() - t1)
        fwd.append(t1 - t0)
    print(f"  one 32-row T=128 dispatch: forward {np.median(fwd) * 1e3:.2f} "
          f"ms (host clock, synchronized), logits to host "
          f"{np.median(d2h) * 1e3:.2f} ms ({out.numel() * 4 / 1e6:.0f} MB), "
          f"median of 7")
    profile_dispatch(torch, lambda: eng.infer(x32, sync=True))
    return launches_total


def profile_dispatch(torch, run) -> None:
    """Device time of one dispatch by kernel, from torch.profiler: the
    busy share of the dispatch's wall time and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    if not rows:
        print("  profiler: no device time reported (busy share not "
              "measured)")
        return
    print(f"  profiler, one 32-row T=128 dispatch: device busy "
          f"{busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall "
          f"({busy_us / wall_us:.1%})")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"    {us / 1e3:8.3f} ms  {count:4d}x  {key[:90]}")


# ---------------------------------------------------------------------------
# phases 5 and 6: BERT-base MLM and GPT-2 small training
# ---------------------------------------------------------------------------

GRAD_TOL_BF16 = 3e-2       # kernel path vs plain attention, global rel. L2
GRAD_TOL_FP32 = 1e-4
WARMUP_STEPS = 2
TIMED_STEPS = 10


def launches_per_step(cfg):
    """B1/B2/B3 launches of one training step: each layer's backward runs
    B2 and B3 once; its forward runs B1 once, and again in the backward
    when cfg.remat recomputes the block (as jax.checkpoint does)."""
    L = cfg.n_layers
    return {"launches": (2 if cfg.remat else 1) * L, "launches_dkv": L,
            "launches_dq": L}


def bert_train_flops(cfg, batch: int, seq: int) -> float:
    """Analytic matmul FLOPs for one BERT MLM training step (fwd*3):
    per layer 8BTh² (qkv+out) + 4BTh·ffn (mlp) + 4BT²h (scores+values),
    plus the vocab logits matmul 2BThV (bench.py:143)."""
    L, h, f, V = cfg.n_layers, cfg.hidden, cfg.ffn_dim, cfg.vocab_size
    per_layer = (8 * batch * seq * h * h + 4 * batch * seq * h * f
                 + 4 * batch * seq * seq * h)
    fwd = L * per_layer + 2 * batch * seq * h * V
    return 3.0 * fwd


def gpt_train_flops(cfg, batch: int, seq: int) -> float:
    """Analytic matmul FLOPs for one causal-LM training step (fwd*3),
    the dense score matrix counted full (bench.py:265)."""
    L, h, f, V = cfg.n_layers, cfg.hidden, cfg.ffn_dim, cfg.vocab_size
    per_layer = (8 * batch * seq * h * h + 4 * batch * seq * h * f
                 + 4 * batch * seq * seq * h)
    return 3.0 * (L * per_layer + 2 * batch * seq * h * V)


def grad_agreement(updaters, got, ref):
    """(global relative L2 error, the leaf with the largest error, that
    leaf's own relative L2 error).  The largest error, not the largest
    relative one: a leaf whose true gradient is 0 up to rounding (the
    key bias: softmax ignores a shift shared by a row's scores) has a
    meaningless relative error."""
    paths = []

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, prefix + key + "/")
            else:
                paths.append(prefix + key)
    walk(ref, "")
    num = den = 0.0
    worst = ("", -1.0, 0.0)
    for path, g, r in zip(paths, updaters.tree_leaves(got),
                          updaters.tree_leaves(ref)):
        d = float((g.float() - r.float()).norm()) ** 2
        n = float(r.float().norm()) ** 2
        num, den = num + d, den + n
        if d > worst[1]:
            worst = (path, d, (d / n) ** 0.5 if n > 0 else float("inf"))
    return (num / den) ** 0.5, worst[0], worst[2]


GEMM_MARKS = ("gemm", "Gemm", "GEMM", "nvjet", "cutlass", "xmma", "cublas")


def device_ms_by_kernel(torch, run):
    """{kernel name: device ms} of one call of ``run``, torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def gemm_ms(by_kernel) -> float:
    return sum(ms for k, ms in by_kernel.items()
               if any(m in k for m in GEMM_MARKS))


def profile_step(torch, tfm, updaters, what, step_fn, state, batch, gen,
                 forward_loss, optimizer, step_ms: float) -> None:
    """Where one training step's device time goes: the whole step, the
    forward alone (its products), and the optimizer alone, each from
    torch.profiler; backward products = the step's minus the forward's.
    The busy share is the step's device time over ``step_ms``, the
    unprofiled median step (the profiler slows the host)."""
    step_k = device_ms_by_kernel(torch, lambda: step_fn(state, batch, gen))
    with torch.no_grad():
        fwd_k = device_ms_by_kernel(torch, lambda: forward_loss(
            state.params))
    _, grads = tfm.value_and_grad(forward_loss, state.params)
    opt_k = device_ms_by_kernel(torch, lambda: updaters.apply_updates(
        state.params, optimizer.update(grads, state.opt_state,
                                       state.params)[0]))
    if not step_k:
        print(f"  {what} profile: no device time reported (not measured)")
        return
    busy = sum(step_k.values())

    def named(mark):
        return sum(ms for k, ms in step_k.items() if mark in k)

    b1, b2, b3 = (named("flash_fwd"), named("flash_bwd_dkv"),
                  named("flash_bwd_dq"))
    g_all, g_fwd = gemm_ms(step_k), gemm_ms(fwd_k)
    opt = sum(opt_k.values())
    other = busy - b1 - b2 - b3 - g_all - opt
    print(f"  {what} profile of one step: device busy {busy:.2f} ms = "
          f"{busy / step_ms:.1%} of the median step; B1 {b1:.3f} ms "
          f"({b1 / busy:.1%}), B2 {b2:.3f} ms ({b2 / busy:.1%}), B3 "
          f"{b3:.3f} ms ({b3 / busy:.1%}); products {g_all:.3f} ms "
          f"({g_all / busy:.1%}): forward {g_fwd:.3f} ms, backward "
          f"{g_all - g_fwd:.3f} ms ({(g_all - g_fwd) / busy:.1%}); "
          f"optimizer {opt:.3f} ms ({opt / busy:.1%}, profiled alone); "
          f"the rest {other:.3f} ms ({other / busy:.1%})")
    vec_add, add, fill = fp32_add_fill_ms(step_k)
    print(f"  {what} profile of one step: fp32 add {vec_add:.3f} ms "
          f"(vectorized CUDAFunctor_add<float>; every fp32 add kernel "
          f"{add:.3f} ms), fills {fill:.3f} ms")
    for key, ms in sorted(step_k.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {ms:8.3f} ms  {key[:100]}")


def fp32_add_fill_ms(by_kernel):
    """(device ms of the vectorized fp32 add kernel, of every fp32 add
    kernel, of fills) in a profile.  Summing per-layer gradients of the
    stacked weights at full size ran in the first and the fills; one
    unbind per leaf removed that."""
    vec = sum(ms for k, ms in by_kernel.items()
              if "vectorized_elementwise_kernel" in k
              and "CUDAFunctor_add<float>" in k)
    add = sum(ms for k, ms in by_kernel.items()
              if "add" in k.lower() and "<float>" in k)
    fill = sum(ms for k, ms in by_kernel.items() if "FillFunctor" in k)
    return vec, add, fill


def remat_comparison(torch, mod, cfg, what, state, batch, gen, step_fn,
                     peak_on: float) -> None:
    """One step with cfg.remat off beside one with it on, in this run:
    peak memory and device time, and the fp32 adds and fills of each."""
    _, step_off = mod.make_train_step(dataclasses.replace(cfg, remat=False))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_off(state, batch, gen)
    torch.cuda.synchronize()
    peak_off = torch.cuda.max_memory_allocated() / 1e9
    on = device_ms_by_kernel(torch, lambda: step_fn(state, batch, gen))
    off = device_ms_by_kernel(torch, lambda: step_off(state, batch, gen))
    if not on or not off:
        print(f"  {what}: remat comparison: no device time reported")
        return
    (va_on, a_on, f_on), (va_off, a_off, f_off) = (fp32_add_fill_ms(on),
                                                   fp32_add_fill_ms(off))
    print(f"  {what}: remat on vs off, one step each: peak memory "
          f"{peak_on:.2f} vs {peak_off:.2f} GB; device busy "
          f"{sum(on.values()):.2f} vs {sum(off.values()):.2f} ms; fp32 add "
          f"(vectorized) {va_on:.3f} vs {va_off:.3f} ms, every fp32 add "
          f"{a_on:.3f} vs {a_off:.3f} ms, fills {f_on:.3f} vs {f_off:.3f} ms")


def train_phase(torch, fa, what, mod, cfg, batch, flops, loss_of):
    """Train ``cfg`` through ``mod.make_train_step`` defaults (flash
    attention, adamw) at full width: warm-up, then timed steps with the
    kernel launch counts read around them; then one step's gradients
    through the kernels against the plain attention (dropout 0), and a
    profile of one step.  ``loss_of(cfg, params, attn_fn)`` is the
    model's loss on ``batch``.  Returns the launch counts."""
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.ops import updaters

    init_fn, step_fn = mod.make_train_step(cfg)
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    dropout_gen = torch.Generator(device="cuda").manual_seed(1)
    losses, step_s = [], []
    # the peak spans the warm-up: a captured step's workspace is taken
    # from its graph's pool at capture (the engine's warm-up runs execute
    # eagerly), and a replay allocates nothing
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(WARMUP_STEPS):
        state, loss = step_fn(state, batch, dropout_gen)
        losses.append(float(loss))
    torch.cuda.synchronize()

    # -- the main path, counted ------------------------------------------
    fa.reset_launches()
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        state, loss = step_fn(state, batch, dropout_gen)
        losses.append(float(loss))         # synchronizes
        step_s.append(time.perf_counter() - t0)
    counts = fa.launch_counts()

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = float(np.median(step_s)) * 1e3
    tokens = (batch.token_ids if hasattr(batch, "token_ids")
              else batch).numel()
    print(f"  {what}: losses " + " ".join(f"{x:.4f}" for x in losses)
          + f" ({WARMUP_STEPS} warm-up, {TIMED_STEPS} timed)")
    print(f"  {what}: step {ms:.2f} ms (median of {TIMED_STEPS}, host clock, "
          f"synchronized; min {min(step_s) * 1e3:.2f}, max "
          f"{max(step_s) * 1e3:.2f}), {tokens / (ms / 1e3):.1f} tokens/s, "
          f"model FLOPs {flops / 1e12:.3f} TFLOP/step = "
          f"{flops / (ms / 1e3) / PEAK_BF16_FLOPS:.2%} of 989 TFLOP/s; "
          f"peak memory {peak_gb:.2f} GB (remat "
          f"{'on' if cfg.remat else 'off'})")
    print(f"  {what}: launches over the {TIMED_STEPS} timed steps: {counts} "
          f"({cfg.n_layers} layers)")
    check(all(np.isfinite(losses)), f"{what}: non-finite loss {losses}")
    check(losses[-1] < losses[WARMUP_STEPS],
          f"{what}: loss did not fall over the timed steps: {losses}")
    expect = launches_per_step(cfg)
    for name, n in counts.items():
        check(n == expect[name] * TIMED_STEPS,
              f"{what}: {name} = {n}, not {expect[name]} per step")

    # -- kernel-path gradients against the plain attention ----------------
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    kernel_attn = fa.make_attn_fn("auto")
    lk, gk = tfm.value_and_grad(
        lambda p: loss_of(cfg0, p, kernel_attn), state.params)
    lp, gp = tfm.value_and_grad(
        lambda p: loss_of(cfg0, p, tfm.attention), state.params)
    rel, leaf, leaf_rel = grad_agreement(updaters, gk, gp)
    del gp
    print(f"  {what}: dropout-0 step through the kernels vs the plain "
          f"attention: loss {float(lk):.6f} vs {float(lp):.6f}; gradients' "
          f"global relative L2 error {rel:.3e} (tolerance "
          f"{GRAD_TOL_BF16:g}); largest error in {leaf} (relative "
          f"{leaf_rel:.3e})")
    check(rel <= GRAD_TOL_BF16, f"{what}: kernel-path gradients differ "
                                f"from the plain path by {rel}")
    optimizer = updaters.adamw(1e-4, weight_decay=0.01)
    profile_step(torch, tfm, updaters, what, step_fn, state, batch,
                 dropout_gen, lambda p: loss_of(cfg0, p, kernel_attn),
                 optimizer, ms)
    remat_comparison(torch, mod, cfg, what, state, batch, dropout_gen,
                     step_fn, peak_gb)
    return counts


def bert_train_phase(torch, fa):
    from deeplearning4j_tpu_torch.models import bert

    cfg = bert.bert_base()
    B, T = 32, 128
    batch = bert.synthetic_batch(0, cfg, B, T, device="cuda")

    def loss_of(c, params, attn):
        return bert.mlm_loss(c, params, batch, None, attn)

    counts = train_phase(torch, fa, "BERT-base MLM B=32 T=128", bert, cfg,
                         batch, bert_train_flops(cfg, B, T), loss_of)
    fp32_check(torch, fa, bert, cfg, batch)
    return counts


def fp32_check(torch, fa, bert, cfg, batch) -> None:
    """fp32 compute at depth 2: the CUDA-core flash kernels against the
    plain attention, one step's gradients within 1e-4."""
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.ops import updaters

    c32 = dataclasses.replace(cfg, compute_dtype="float32", n_layers=2,
                              dropout=0.0)
    params = bert.init_params(torch.Generator(device="cuda").manual_seed(2),
                              c32, device="cuda")
    before = fa.launch_counts()
    lk, gk = tfm.value_and_grad(lambda p: bert.mlm_loss(
        c32, p, batch, None, fa.make_attn_fn("auto")), params)
    after = fa.launch_counts()
    lp, gp = tfm.value_and_grad(lambda p: bert.mlm_loss(
        c32, p, batch, None, tfm.attention), params)
    rel, leaf, leaf_rel = grad_agreement(updaters, gk, gp)
    print(f"  BERT-base fp32 compute, depth 2: loss {float(lk):.7f} vs "
          f"{float(lp):.7f}; gradients' global relative L2 error "
          f"{rel:.3e} (tolerance {GRAD_TOL_FP32:g}); largest error in {leaf} "
          f"(relative {leaf_rel:.3e}); fp32 kernel launches "
          f"{ {k: after[k] - before[k] for k in after} }")
    expect = launches_per_step(c32)
    check(all(after[k] - before[k] == expect[k] for k in after),
          f"fp32 step's launches are not {expect}")
    check(rel <= GRAD_TOL_FP32, f"fp32 kernel-path gradients differ by {rel}")


def gpt_train_phase(torch, fa):
    from deeplearning4j_tpu_torch.models import gpt

    cfg = gpt.gpt_config()
    B, T = 8, 1024
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T))
                           .astype(np.int32)).cuda()

    def loss_of(c, params, attn):
        return gpt.lm_loss(c, params, ids, None, None, attn)

    return train_phase(torch, fa, "GPT-2 small B=8 T=1024", gpt, cfg, ids,
                       gpt_train_flops(cfg, B, T), loss_of)


# ---------------------------------------------------------------------------
# phase 3c: B4 (word2vec chunk) and B5 (GloVe chunk) against their twins
# ---------------------------------------------------------------------------

#: published fp32 rate of an H100 SXM outside the tensor cores (700 W)
PEAK_FP32_FLOPS = 67e12
#: Tolerances of B4/B5 against their plain twins.  A sum of n fp32 terms
#: in any order is within (n-1) * u * sum|t| of the exact sum (u = 2^-24).
#: B4 is held against its twin evaluated in fp64: the fp32 twin, like
#: JAX's .at[].add, adds each of a row's n terms into the table itself,
#: so at the Huffman root (n = 16,384) its own rounding is ~1e-5, larger
#: than the update it checks.  B4 sums each row's terms in registers (and
#: a split row's segments in scratch) and adds a row's mean once: each
#: table is within 2 * n_max * u * t + 4 * u *
#: max|table| of the exact result, with t the largest term (alpha *
#: max|l1| for syn1/syn1neg, alpha * (L+K+1) * max|partner row| for
#: syn0) and n_max the chunk's most-hit row (for syn0 on the wide path,
#: which adds each partner's term on its own, times L+K+1).  B5's twin
#: also sums into zeroed accumulators, in fp32; B5 is held to it entry
#: by entry (see glove_tolerances).
U32 = 2.0 ** -24
#: one training epoch through the kernel against one through the plain
#: twin, same draws: the per-chunk rounding differences compound over the
#: epoch's chunks
EPOCH_TOL = 1e-4
TEXT8 = os.path.join(REPO, "data", "text8")
W2V_CONFIG = dict(vector_size=100, window=5, negative=5, use_hs=True,
                  batch_size=16384)            # bench.py:676-678
ZIPF_VOCAB = 71290        # the min-count-5 vocabulary of public text8
ZIPF_WORDS = 2_000_000


def text8_sentences():
    """data/text8 (tools/make_text_corpus.py) as 50-word sentences."""
    with open(TEXT8) as f:
        words = f.read().split()
    return [" ".join(words[i:i + 50]) for i in range(0, len(words), 50)]


def zipf_sentences():
    """The synthetic Zipf corpus of bench.py:654-660 (exponent 1.05,
    30-word sentences, RandomState(0)) at ZIPF_VOCAB names and about
    ZIPF_WORDS words."""
    rng = np.random.RandomState(0)
    probs = 1.0 / np.arange(1, ZIPF_VOCAB + 1) ** 1.05
    probs /= probs.sum()
    ids = rng.choice(ZIPF_VOCAB, p=probs, size=(-(-ZIPF_WORDS // 30), 30))
    return [" ".join(f"w{i}" for i in row) for row in ids]


def zipf_cache():
    """A vocabulary of all ZIPF_VOCAB names at their expected Zipf counts
    over ZIPF_WORDS words, with Huffman codes."""
    from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, build_huffman

    probs = 1.0 / np.arange(1, ZIPF_VOCAB + 1) ** 1.05
    counts = probs / probs.sum() * ZIPF_WORDS
    cache = VocabCache()
    for i, c in enumerate(counts):
        cache.add_token(f"w{i}", float(c))
    cache.trim(0)
    build_huffman(cache)
    return cache, probs / probs.sum()


def w2v_chunk_inputs(torch, tables, cen, ctx, K, pmask=None, seed=0):
    """One B4 chunk on the card: Huffman rows of the centers, negatives
    from the unigram table.  ``tables`` = prepare_train_tables(...)."""
    codes_t, points_t, mask_t, table, _ = tables
    rng = np.random.RandomState(seed)
    B = cen.size
    negs = table[rng.randint(0, table.size, (B, max(K, 1)))]
    t = lambda a, dt=None: torch.as_tensor(np.ascontiguousarray(a),
                                           device="cuda", dtype=dt)
    return dict(inputs=t(ctx, torch.int32), targets=t(cen, torch.int32),
                codes=t(codes_t[cen], torch.float32),
                points=t(points_t[cen], torch.int32),
                mask=t(mask_t[cen], torch.float32),
                negs=t(negs, torch.int32),
                pmask=t(np.ones(B, np.float32) if pmask is None else pmask))


def w2v_partners(torch, c, use_hs, K):
    """Chunk ``c``'s live hits, one entry per hit: (HS points, negative
    sampling rows, inputs of pairs with a live HS level, inputs of
    unpadded pairs when K > 0)."""
    pts = rows = in_hs = in_ng = c["inputs"][:0].long()
    pm = c["pmask"] > 0
    if use_hs:
        m = (c["mask"] * c["pmask"][:, None]) > 0
        pts, in_hs = c["points"][m].long(), c["inputs"][m.any(1)].long()
    if K > 0:
        r = torch.cat([c["targets"][:, None], c["negs"][:, :K]], 1)
        valid = torch.cat([torch.ones_like(r[:, :1], dtype=torch.bool),
                           r[:, 1:] != r[:, :1]], 1) & pm[:, None]
        rows, in_ng = r[valid].long(), c["inputs"][pm].long()
    return pts, rows, in_hs, in_ng


def w2v_work(torch, c, V0, D, use_hs, K):
    """(bytes, flops, touched rows, the most hits on one row) of chunk
    ``c``: the least work is the index arrays once and each touched row
    of syn0, syn1 and syn1neg read once and written once; 6*D FLOPs per
    live (pair, partner)."""
    B = c["inputs"].shape[0]
    L = c["codes"].shape[1] if use_hs else 0
    pts, rows, in_hs, in_ng = w2v_partners(torch, c, use_hs, K)
    hits = [torch.bincount(x, minlength=V0)
            for x in (torch.cat([in_hs, in_ng]), pts, rows)]
    touched = sum(int((h > 0).sum()) for h in hits)
    nbytes = 4 * B * (3 + 3 * L + K) + 8 * D * touched
    most = max(int(h.max()) if h.numel() else 0 for h in hits)
    return nbytes, 6.0 * D * (pts.numel() + rows.numel()), touched, most


def bound(nbytes, flops):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def w2v_case_chunks(torch, text8_tables, text8_pairs, zipf):
    """The B4 cases: (name, V, D, K, use_hs, tables, chunk, time_it)."""
    from deeplearning4j_tpu_torch.nlp.word2vec import prepare_train_tables

    cases = []
    rng = np.random.RandomState(0)
    # the JAX test's shape (tests/test_nlp.py:_rand_chunk)
    V, D, L, K, B = 64, 32, 7, 3, 256
    small = dict(inputs=rng.randint(0, V, B), targets=rng.randint(0, V, B),
                 codes=rng.randint(0, 2, (B, L)).astype(np.float32),
                 points=rng.randint(0, V, (B, L)),
                 mask=(rng.rand(B, L) < 0.7).astype(np.float32),
                 negs=rng.randint(0, V, (B, K)),
                 pmask=(rng.rand(B) < 0.9).astype(np.float32))
    small = {k: torch.as_tensor(v, device="cuda",
                                dtype=torch.float32 if v.dtype == np.float32
                                else torch.int32) for k, v in small.items()}
    for name, hs, k in (("JAX test shape, HS only", True, 0),
                        ("JAX test shape, negatives only", False, K),
                        ("JAX test shape, HS + negatives", True, K)):
        cases.append((name, V, D, k, hs, small, False))
    cen, ctx = text8_pairs
    B = 16384
    main = w2v_chunk_inputs(torch, text8_tables, cen[:B], ctx[:B], 5)
    V8 = text8_tables[0].shape[0]
    cases += [("text8 V=2404 D=100 L=14 K=5 B=16384, HS + negatives",
               V8, 100, 5, True, main, True),
              ("text8, HS only", V8, 100, 0, True, main, False),
              ("text8, negatives only", V8, 100, 5, False, main, False)]
    # padded pairs and negative == target collisions
    pm = (rng.rand(B) < 0.7).astype(np.float32)
    pad = w2v_chunk_inputs(torch, text8_tables, cen[:B], ctx[:B], 5, pm,
                           seed=1)
    hit = torch.as_tensor(rng.rand(B, 5) < 0.2, device="cuda")
    pad["negs"] = torch.where(hit, pad["targets"][:, None], pad["negs"])
    cases.append(("text8, 30% padded pairs, 20% negatives == target", V8,
                  100, 5, True, pad, False))
    for d in (50, 300, 600):
        wide = ", the wide path (D > 512)" if d > 512 else ""
        cases.append((f"text8, D={d}{wide}", V8, d, 5, True, main, False))
    zcache, probs = zipf
    ztables = prepare_train_tables(zcache, 100_000)
    zc = rng.choice(ZIPF_VOCAB, p=probs, size=B)
    zx = rng.choice(ZIPF_VOCAB, p=probs, size=B)
    cases.append((f"Zipf V={ZIPF_VOCAB} D=100 L={ztables[0].shape[1]} K=5 "
                  f"B=16384, HS + negatives", ZIPF_VOCAB, 100, 5, True,
                  w2v_chunk_inputs(torch, ztables, zc, zx, 5), True))
    return cases


def w2v_tolerances(torch, c, args, use_hs, K):
    """B4's per-table tolerances (syn0, syn1, syn1neg) for chunk ``c``
    (see U32 above), from its hit counts and the tables' largest |x|."""
    syn0, syn1, sneg = args[:3]
    alpha = args[-1]

    def most(x):
        return int(torch.bincount(x).max()) if x.numel() else 0

    pts, rows, in_hs, in_ng = w2v_partners(torch, c, use_hs, K)
    l1 = syn0.abs().max().item()
    partner = max(syn1.abs().max().item(), sneg.abs().max().item())
    L = c["codes"].shape[1] if use_hs else 0
    # the wide path (D > 512) adds each partner's term into acc0 on its
    # own: L + K + 1 times the terms a row's sum takes
    wide = L + K + 1 if syn0.shape[1] > 512 else 1
    return [2 * n * U32 * alpha * term + 4 * U32 * table.abs().max().item()
            for n, term, table in (
                (wide * max(most(in_hs), most(in_ng)), (L + K + 1) * partner,
                 syn0),
                (most(pts), l1, syn1), (most(rows), l1, sneg))]


def w2v_kernel_phase(torch, fw, cases):
    """B4 against its plain twin on every case; times at the main-path
    shapes.  Returns (worst |diff|, timing rows)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    worst, rows = 0.0, []
    for name, V, D, K, hs, c, time_it in cases:
        syn = [torch.randn((V, D), generator=gen, device="cuda") * 0.1
               for _ in range(3)]
        syn1 = syn[1] if hs else torch.zeros((1, D), device="cuda")
        sneg = syn[2] if K else torch.zeros((1, D), device="cuda")
        args = (syn[0], syn1, sneg, c["inputs"], c["targets"], c["codes"],
                c["points"], c["mask"], c["negs"][:, :max(K, 1)],
                c["pmask"], 0.025)
        kw = dict(use_hs=hs, negative=K)
        # B4 updates the tables it is given in place; the twins reuse args
        got = fw.fused_chunk_update_cuda(*(a.clone() for a in args[:3]),
                                         *args[3:], **kw)
        ref = fw.fused_chunk_update_plain(
            *(a.double() if torch.is_tensor(a) and a.is_floating_point()
              else a for a in args), **kw)
        torch.cuda.synchronize()
        errs = [(g.double() - r).abs().max().item()
                for g, r in zip(got, ref)]
        # the fp32 twin's own rounding, for scale: it adds each term into
        # the table itself (as JAX's .at[].add), B4 adds a row's mean once
        twin32 = fw.fused_chunk_update_plain(*args, **kw)
        twin_errs = [(t.double() - r).abs().max().item()
                     for t, r in zip(twin32, ref)]
        tols = w2v_tolerances(torch, c, args, hs, K)
        ok = all(e <= t for e, t in zip(errs, tols)) and all(
            bool(g.isfinite().all()) for g in got)
        print(f"  B4 case {name!r}: max|diff| vs the fp64 twin syn0 "
              f"{errs[0]:.3e} syn1 "
              f"{errs[1]:.3e} syn1neg {errs[2]:.3e} (tolerances "
              + " ".join(f"{t:.2e}" for t in tols)
              + f") {'ok' if ok else 'FAIL'}; the fp32 twin vs the fp64 "
              f"twin: " + " ".join(f"{e:.3e}" for e in twin_errs))
        check(ok, f"B4 disagrees with its plain twin: {name}")
        worst = max(worst, *errs)
        if time_it:
            tabs = [a.clone() for a in args[:3]]

            def call():
                fw.fused_chunk_update_cuda(*tabs, *args[3:], **kw)

            ms, by = profile_call_ms(torch, call)
            call_ms = time_ms(torch, call, iters=20)
            plain_ms = time_ms(torch, lambda: fw.fused_chunk_update_plain(
                *args, **kw), iters=10)
            nbytes, flops, touched, most = w2v_work(torch, c, V, D, hs, K)
            b_ms, b_by = bound(nbytes, flops)
            print(f"  B4 timing {name!r}: kernels {ms:.4f} ms a call "
                  f"[profiler, every phase summed: "
                  + phases(by, W2V_PHASES)
                  + f"], whole update call {call_ms:.4f} ms [events], plain "
                  f"twin {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}: "
                  f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); "
                  f"{touched} touched rows, at most {most} hits on one, "
                  f"segments of {fw.SEGMENT}; library: none (no one PyTorch "
                  f"call computes it)")
            check(ms > 0, "the profiler saw no device time for B4")
            rows.append((name, ms, plain_ms, b_ms, b_by, call_ms))
    return worst, rows


#: the kernels (and memset) of one B4 call, by phase
W2V_PHASES = ("Memset", "w2v_phase_a", "scan_kernel", "scatter_kernel",
              "w2v_reduce_syn_kernel", "w2v_reduce_syn0_kernel")
#: and of one B5 call
GLOVE_PHASES = ("Memset", "glove_score", "scan_kernel", "scatter_kernel",
                "glove_reduce_kernel", "glove_apply_kernel")


def glove_case_chunks(torch, text8_triples, zipf_probs):
    rng = np.random.RandomState(3)
    cases = []

    def chunk(V, D, rows, cols, x, mask):
        t = torch.as_tensor
        return (V, D, t(rows, device="cuda", dtype=torch.int32),
                t(cols, device="cuda", dtype=torch.int32),
                t(x, device="cuda", dtype=torch.float32),
                t(mask, device="cuda", dtype=torch.float32))

    V, B = 64, 128
    cases.append(("V=64 D=32 B=128 (the JAX test's shape)", False, False,
                  chunk(V, 32, rng.randint(0, V, B), rng.randint(0, V, B),
                        rng.rand(B) * 50 + 1,
                        (rng.rand(B) < 0.9).astype(np.float32))))
    B = 4096
    r, c, x, V8 = text8_triples
    sel = rng.permutation(r.size)[:B]
    cases.append((f"text8 V={V8} D=100 B=4096", True, True,
                  chunk(V8, 100, r[sel], c[sel], x[sel], np.ones(B))))
    zr = rng.choice(ZIPF_VOCAB, p=zipf_probs, size=B)
    zc = rng.choice(ZIPF_VOCAB, p=zipf_probs, size=B)
    zx = np.exp(rng.uniform(np.log(0.1), np.log(1000.0), B))
    cases.append((f"Zipf V={ZIPF_VOCAB} D=100 B=4096, x from 0.1 to 1000",
                  True, True, chunk(ZIPF_VOCAB, 100, zr, zc, zx,
                                    np.ones(B))))
    cases.append(("text8, x on both sides of x_max, 25% masked", False, True,
                  chunk(V8, 100, r[sel], c[sel], zx,
                        (rng.rand(B) < 0.75).astype(np.float32))))
    cases.append(("text8 D=600 B=4096, the wide path (D+2 > 512)", False,
                  True, chunk(V8, 600, r[sel], c[sel], x[sel], np.ones(B))))
    return cases


def glove_tolerances(torch, args, x_max, power):
    """B5's per-entry tolerances (accw, accwt, loss sums) for one chunk,
    worked out in fp64.  Kernel and twin each compute an entry's n terms
    t in fp32, each within dt of the exact term, and sum them in some
    order within n * u * sum|t|, so the two differ by at most 2 * (n * u
    * sum|t| + sum dt).  dt comes from the score: an fp32 dot of E
    products and a log are within dd = (E + 3) * u * (sum|wi * wj| +
    |log x|) of exact, so g = f * diff * m is within f * dd * m + 6 * u
    * |g|, a gradient term g * p within |p| * dg + u * |g * p|, its
    square within 2 * |g * p| * dt + u * (g * p)^2 and a loss term
    0.5 * f * diff^2 * m within f * |diff| * dd * m + 6 * u * loss."""
    wext, wtext, r, c, x, m = (a.double() if a.is_floating_point()
                               else a.long() for a in args)
    V, E = wext.shape
    D = E - 2
    wi, wj = wext[r], wtext[c]
    prod = wi * wj
    logx = torch.log(x.clamp_min(1e-12))
    diff = prod.sum(1) - logx
    fx = ((x / x_max) ** power).clamp_max(1.0)
    g = fx * diff * m
    dd = (E + 3) * U32 * (prod.abs().sum(1) + logx.abs())
    dg = fx * dd * m + 6 * U32 * g.abs()
    live = (m != 0).double()

    def side(idx, partner):
        t = g[:, None] * partner
        dt = partner.abs() * dg[:, None] + U32 * t.abs()
        size = torch.cat([t.abs(), t * t, m[:, None].abs()], 1)
        err = torch.cat([dt, 2 * t.abs() * dt + U32 * t * t,
                         torch.zeros_like(m[:, None])], 1)
        zero = torch.zeros((V, 2 * D + 3), dtype=torch.float64,
                           device=wext.device)
        n = torch.zeros(V, dtype=torch.float64, device=wext.device
                        ).index_add_(0, idx, live)
        return 2 * (n[:, None] * U32 * zero.index_add(0, idx, size)
                    + zero.index_add(0, idx, err))

    loss = 0.5 * fx * diff * diff * m
    dloss = fx * diff.abs() * dd * m + 6 * U32 * loss
    n = live.sum()
    tol_loss = 2 * torch.stack([n * U32 * loss.abs().sum() + dloss.sum(),
                                n * U32 * m.abs().sum()])[None, :]
    return (side(r, wj[:, :D + 1]),
            side(c, torch.cat([wi[:, :D], wi[:, D + 1:]], 1)), tol_loss)


def glove_step_tolerances(torch, fg, args, gext, gtext, alpha, x_max,
                          power):
    """B5's chunk step against glove_chunk_step_plain, per entry of
    (wext, wtext, gext, gtext), worked out in fp64: glove_tolerances
    bounds the two's sums (ds, dq) and the AdaGrad step carries them,
    with k the row's hits, as grad = s/k within ds/k + 2u|grad|, g2 =
    gsq + q/k^2 within dq/k^2 + 4u|g2|, step = alpha * grad / sqrt(G),
    G = g2 + 1e-8, within alpha * dgrad / sqrt(G) + alpha * |grad| *
    dg2 / (2 G^1.5) + 6u|step|, and the new weight within dstep +
    2u|w - step|."""
    acc_tols = glove_tolerances(torch, args, x_max, power)
    wext, wtext, r, c, x, m = (a.double() if a.is_floating_point() else a
                               for a in args)
    accs = fg.fused_glove_chunk_plain(wext, wtext, r, c, x, m, x_max=x_max,
                                      power=power)
    D = wext.shape[1] - 2
    d1 = D + 1
    out = []
    for acc, tol, table_b, gsq in (
            (accs[0], acc_tols[0], wext[:, :d1], gext.double()),
            (accs[1], acc_tols[1],
             torch.cat([wtext[:, :D], wtext[:, D + 1:]], 1), gtext.double())):
        k = acc[:, 2 * d1:].clamp_min(1.0)
        grad = acc[:, :d1] / k
        g2 = gsq + acc[:, d1:2 * d1] / (k * k)
        G = g2 + 1e-8
        step = alpha * grad / G.sqrt()
        dgrad = tol[:, :d1] / k + 2 * U32 * grad.abs()
        dg2 = tol[:, d1:2 * d1] / (k * k) + 4 * U32 * g2.abs()
        dstep = (alpha * dgrad / G.sqrt()
                 + alpha * grad.abs() * dg2 / (2 * G ** 1.5)
                 + 6 * U32 * step.abs())
        out.append((dstep + 2 * U32 * (table_b - step).abs(), dg2))
    zero = torch.zeros_like(out[0][0][:, :1])
    (dwi, dgi), (dwj, dgj) = out
    return (torch.cat([dwi, zero], 1),                       # (w | b | 1)
            torch.cat([dwj[:, :D], zero, dwj[:, D:]], 1),    # (wt | 1 | bt)
            dgi, dgj)


def glove_kernel_phase(torch, fg, cases):
    """B5's accumulator mode against fused_glove_chunk_plain on every
    case, its chunk step against glove_chunk_step_plain on the step
    cases, and at the timed shapes the step's device time beside the old
    composition's.  Returns (worst |diff|, timing rows)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    worst, rows = 0.0, []
    for name, time_it, step_case, (V, D, r, c, x, m) in cases:
        ones = torch.ones((V, 1), device="cuda")
        w, wt = (torch.randn((V, D), generator=gen, device="cuda") * 0.1
                 for _ in range(2))
        b, bt = (torch.randn((V, 1), generator=gen, device="cuda") * 0.1
                 for _ in range(2))
        args = (torch.cat([w, b, ones], 1), torch.cat([wt, ones, bt], 1),
                r, c, x, m)
        kw = dict(x_max=100.0, power=0.75)
        got = fg.fused_glove_chunk_cuda(*args, **kw)
        ref = fg.fused_glove_chunk_plain(*args, **kw)
        torch.cuda.synchronize()
        tols = glove_tolerances(torch, args, **kw)
        errs, ratios = [], []
        for g, rf, tol in zip(got, ref, tols):
            diff = (g.double() - rf.double()).abs()
            errs.append(diff.max().item())
            ratios.append(float((diff / tol.clamp_min(1e-300)).max()))
        ok = all(ratio <= 1.0 for ratio in ratios) and all(
            bool(g.isfinite().all()) for g in got)
        d1 = D + 1

        def blocks(tol):       # the largest tolerance per column block
            return "|".join(f"{float(tol[:, a:b].max()):.2e}" for a, b in (
                (0, d1), (d1, 2 * d1), (2 * d1, 2 * d1 + 1)))

        print(f"  B5 case {name!r}: max|diff| accw {errs[0]:.3e} accwt "
              f"{errs[1]:.3e} loss {errs[2]:.3e}; largest diff/tolerance "
              f"per entry " + " ".join(f"{q:.3f}" for q in ratios)
              + f" {'ok' if ok else 'FAIL'}; largest tolerance per block "
              f"(grad|grad^2|hits) accw {blocks(tols[0])} accwt "
              f"{blocks(tols[1])}, loss sums "
              + " ".join(f"{float(t):.2e}" for t in tols[2][0]))
        check(ok, f"B5 disagrees with its plain twin: {name}")
        worst = max(worst, *errs)
        if not step_case:
            continue

        # the fused chunk step, in place on copies, against its twin
        gext, gtext = (torch.rand((V, d1), generator=gen, device="cuda")
                       * 0.1 + 1e-8 for _ in range(2))
        alpha = 0.05
        state = (args[0], args[1], gext, gtext)
        *step_ref, ls_ref = fg.glove_chunk_step_plain(*state, *args[2:],
                                                      alpha, **kw)
        *step_got, ls = fg.glove_chunk_step_cuda(
            *(t.clone() for t in state), *args[2:], alpha, **kw)
        torch.cuda.synchronize()
        step_tols = glove_step_tolerances(torch, fg, args, gext, gtext,
                                          alpha, **kw)
        step_ratios = [float(((g.double() - rf.double()).abs()
                              / tol.clamp_min(1e-300)).max())
                       for g, rf, tol in zip(step_got, step_ref, step_tols)]
        loss_ratio = float(((ls.double() - ls_ref.double()).abs()
                            / tols[2].clamp_min(1e-300)).max())
        step_errs = [float((g - rf).abs().max())
                     for g, rf in zip(step_got, step_ref)]
        ok = (max(step_ratios + [loss_ratio]) <= 1.0
              and all(bool(g.isfinite().all()) for g in step_got))
        print(f"  B5 step case {name!r}: max|diff| wext {step_errs[0]:.3e} "
              f"wtext {step_errs[1]:.3e} gext {step_errs[2]:.3e} gtext "
              f"{step_errs[3]:.3e}; largest diff/tolerance per entry "
              + " ".join(f"{q:.3f}" for q in step_ratios)
              + f", loss {loss_ratio:.3f} {'ok' if ok else 'FAIL'}")
        check(ok, f"B5's chunk step disagrees with its plain twin: {name}")
        worst = max(worst, *step_errs)
        if not time_it:
            continue
        tabs = [t.clone() for t in state]

        def fused():
            fg.glove_chunk_step_cuda(*tabs, *args[2:], alpha, **kw)

        def old_composition():
            wext, wtext, gx, gt = tabs
            accw, accwt, _ = fg.fused_glove_chunk_cuda(wext, wtext,
                                                       *args[2:], **kw)
            wb, gx2 = fg.apply_chunk(wext[:, :D + 1], gx, accw, alpha)
            wtb, gt2 = fg.apply_chunk(
                torch.cat([wtext[:, :D], wtext[:, D + 1:]], 1), gt, accwt,
                alpha)
            wext[:, :D + 1] = wb
            wtext[:, :D] = wtb[:, :D]
            wtext[:, D + 1] = wtb[:, D]
            gx.copy_(gx2)
            gt.copy_(gt2)

        old_ms, _ = profile_call_ms(torch, old_composition)
        ms, by = profile_call_ms(torch, fused)
        old_ms2, _ = profile_call_ms(torch, old_composition)
        plain_ms = time_ms(torch, lambda: fg.glove_chunk_step_plain(
            *state, *args[2:], alpha, **kw), iters=10)
        # the four [B] inputs once; each touched row of each side: its
        # extended row read, its D+1 update columns and AdaGrad sums read
        # and written
        live = m > 0
        rows_hit = (torch.unique(r[live]).numel()
                    + torch.unique(c[live]).numel())
        nbytes = 16 * r.numel() + 4 * rows_hit * (4 * D + 5) + 8
        flops = 6.0 * D * int(live.sum())
        b_ms, b_by = bound(nbytes, flops)
        old = min(old_ms, old_ms2)
        print(f"  B5 timing {name!r}: chunk step {ms:.4f} ms [profiler, "
              f"every phase summed: " + phases(by, GLOVE_PHASES)
              + f"]; the old composition (accumulators, two apply_chunk, "
              f"cat, slice writes) {old_ms:.4f} / {old_ms2:.4f} ms, the step "
              f"at {ms / old:.2f}x of it; plain twin {plain_ms:.4f} ms; "
              f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP); library: none (no one PyTorch "
              f"call computes it)")
        check(ms > 0, "the profiler saw no device time for B5")
        rows.append((name, ms, plain_ms, b_ms, b_by, old))
    return worst, rows


# ---------------------------------------------------------------------------
# phases 7 and 8: word2vec, ParagraphVectors and GloVe training
# ---------------------------------------------------------------------------

def busy_share(torch, run):
    """(device busy ms, wall ms) of one call of ``run``, torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return busy, wall


def rel_diff(torch, got, ref):
    """(max |diff| over the tables, global relative L2 difference)."""
    err = max((g - r).abs().max().item() for g, r in zip(got, ref))
    num = sum(float((g - r).double().norm()) ** 2 for g, r in zip(got, ref))
    den = sum(float(r.double().norm()) ** 2 for r in ref)
    return err, (num / max(den, 1e-30)) ** 0.5


def w2v_fit(torch, fw, what, sents, cfg, cache=None, w2v=None):
    """One fit, timed on the host clock after synchronize, with B4's
    launches read around it and held to one per chunk.  Returns the
    Word2Vec, seconds and launches."""
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

    w2v = w2v or Word2Vec(sents, cfg, cache=cache, device="cuda")
    fw.reset_launches()
    t0 = time.perf_counter()
    w2v.fit()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    n = fw.launches
    check(w2v.chunks > 0 and n == w2v.chunks,
          f"{what}: B4 launched {n} times for {w2v.chunks} chunks")
    tabs = [t for t in (w2v.syn0, w2v.syn1, w2v.syn1neg) if t is not None]
    check(all(bool(t.isfinite().all()) for t in tabs),
          f"{what}: non-finite tables")
    words = w2v._n_positions * cfg.epochs
    print(f"  {what}: {cfg.epochs} epochs, {w2v._n_positions} words, "
          f"V={len(w2v.cache)}, {w2v.chunks} chunks = {n} B4 launches, "
          f"{sec:.3f} s, {words / sec:.1f} words/s (host clock, "
          f"synchronized)")
    return w2v, sec, n


def neighbour_check(wv, what):
    """tests/test_nlp.py:test_word2vec_real_corpus_tier's check."""
    check(len(wv.cache) > 1000, f"{what}: vocabulary {len(wv.cache)}")
    probe = next((w for w in ("the", "of", "and", "one")
                  if w in wv.cache.vocab), wv.cache.word_for(0))
    near = wv.words_nearest(probe, 5)
    print(f"  {what}: nearest to {probe!r}: "
          + ", ".join(f"{w} {s:.3f}" for w, s in near))
    check(len(near) == 5 and all(np.isfinite(s) for _, s in near),
          f"{what}: neighbour check failed: {near}")


def word2vec_phase(torch, fw, t8, zipf):
    """Phase 7: returns B4's launches over the main paths."""
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
        ParagraphVectors, ParagraphVectorsConfig)
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec, Word2VecConfig

    launches = 0
    cfg = Word2VecConfig(min_word_frequency=5, epochs=3, **W2V_CONFIG)
    w2v, sec, n = w2v_fit(torch, fw, "text8 masked, cold fit", t8, cfg)
    launches += n
    cache = w2v.cache
    neighbour_check(w2v.word_vectors, "text8 masked")
    _, sec, n = w2v_fit(torch, fw, "text8 masked, warm refit (cached "
                        "slabs)", t8, cfg, w2v=w2v)
    launches += n
    print(f"  text8 masked: warm epoch {sec / cfg.epochs * 1e3:.1f} ms, "
          f"{w2v._n_positions / (sec / cfg.epochs):.1f} words/s")
    w2v.config = dataclasses.replace(cfg, epochs=1)
    fw.reset_launches()
    busy, wall = busy_share(torch, w2v.fit)
    launches += fw.launches
    print(f"  text8 masked, one profiled epoch: device busy {busy:.2f} ms "
          f"of {wall:.2f} ms wall ({busy / wall:.1%}); "
          f"{fw.launches} B4 launches")
    for mode in ("exact", "device"):
        _, _, n = w2v_fit(torch, fw, f"text8 {mode}, cold fit", t8,
                          dataclasses.replace(cfg, pair_mode=mode),
                          cache=cache)
        launches += n

    # one epoch through B4 against one through the plain twin, same draws
    gen = torch.Generator(device="cuda").manual_seed(5)
    V, D = len(cache), cfg.vector_size
    init = ((torch.rand((V, D), generator=gen, device="cuda") - 0.5) / D,
            torch.randn((V, D), generator=gen, device="cuda") * 0.01,
            torch.randn((V, D), generator=gen, device="cuda") * 0.01)
    out = {}
    for kernel in ("cuda", "plain"):
        one = Word2Vec(t8, dataclasses.replace(cfg, epochs=1, kernel=kernel),
                       cache=cache, device="cuda")
        one.fit(initial_weights=init)
        out[kernel] = (one.syn0, one.syn1, one.syn1neg)
    err, rel = rel_diff(torch, out["cuda"], out["plain"])
    print(f"  text8 masked, one epoch through B4 vs through the plain twin "
          f"(same draws): max|diff| {err:.3e}, relative L2 {rel:.3e} "
          f"(tolerance {EPOCH_TOL:g})")
    check(err <= EPOCH_TOL, "word2vec epoch: B4 and plain twin disagree")

    zcfg = dataclasses.replace(cfg, min_word_frequency=1, epochs=2)
    zw, sec, n = w2v_fit(torch, fw, f"Zipf {ZIPF_VOCAB} names masked, cold "
                         f"fit", zipf, zcfg)
    launches += n
    _, sec, n = w2v_fit(torch, fw, "Zipf masked, warm refit", zipf, zcfg,
                        w2v=zw)
    launches += n
    print(f"  Zipf masked: warm epoch {sec / zcfg.epochs * 1e3:.1f} ms, "
          f"{zw._n_positions / (sec / zcfg.epochs):.1f} words/s")

    docs = [(f"doc{i}", s) for i, s in enumerate(t8)]
    pv = ParagraphVectors(docs, ParagraphVectorsConfig(
        min_word_frequency=5, epochs=3, vector_size=100, window=5,
        batch_size=16384), device="cuda")
    fw.reset_launches()
    t0 = time.perf_counter()
    pv.fit()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    n = fw.launches
    launches += n
    inferred = pv.infer_vector(t8[0])
    labels = pv.nearest_labels(t8[0])
    print(f"  ParagraphVectors over {len(docs)} text8 documents: 3 epochs, "
          f"{pv.chunks} chunks = {n} B4 launches, {sec:.3f} s; inferred "
          f"|v| {np.linalg.norm(inferred):.4f}; nearest labels {labels}")
    check(pv.chunks > 0 and n == pv.chunks,
          "ParagraphVectors: B4 launches != chunks")
    check(bool(pv.syn0.isfinite().all()) and np.isfinite(inferred).all()
          and len(labels) == 3, "ParagraphVectors: bad result")
    return launches


def glove_fit(torch, fg, what, sents, cfg, cache=None):
    from deeplearning4j_tpu_torch.nlp.glove import (Glove,
                                                    count_cooccurrences)
    from deeplearning4j_tpu_torch.nlp.vocab import build_vocab

    g = Glove(sents, cfg, device="cuda")
    g.cache = cache or build_vocab(sents, g.tokenizer,
                                   cfg.min_word_frequency)
    t0 = time.perf_counter()
    co = count_cooccurrences(sents, g.tokenizer, g.cache, cfg.window,
                             cfg.symmetric)
    t_count = time.perf_counter() - t0
    fg.reset_launches()
    t0 = time.perf_counter()
    g.fit(cooccurrences=co)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    n = fg.launches
    P = co[0].size
    print(f"  {what}: V={len(g.cache)}, {P} triples, counting {t_count:.3f} "
          f"s; {cfg.epochs} epochs, {g.chunks} chunks = {n} B5 launches, "
          f"{sec:.3f} s, {P * cfg.epochs / sec:.1f} triples/s (host clock, "
          f"synchronized); losses " + " ".join(f"{x:.5f}" for x in g.losses))
    check(g.chunks > 0 and n == g.chunks, f"{what}: B5 launches != chunks")
    check(all(np.isfinite(g.losses)) and g.losses[-1] < g.losses[0],
          f"{what}: loss did not fall: {g.losses}")
    check(all(bool(t.isfinite().all()) for t in g.state),
          f"{what}: non-finite state")
    return g, co, n


def glove_phase(torch, fg, t8, zipf):
    """Phase 8: returns B5's launches over the main paths."""
    from deeplearning4j_tpu_torch.nlp.glove import Glove, GloveConfig

    cfg = GloveConfig()
    g, co, launches = glove_fit(torch, fg, "text8 GloVe", t8, cfg)
    one_cfg = dataclasses.replace(cfg, epochs=1)
    prof = Glove(t8, one_cfg, cache=g.cache, device="cuda")
    fg.reset_launches()
    busy, wall = busy_share(torch, lambda: prof.fit(cooccurrences=co))
    launches += fg.launches
    print(f"  text8 GloVe, one profiled epoch: device busy {busy:.2f} ms of "
          f"{wall:.2f} ms wall ({busy / wall:.1%}); {fg.launches} B5 "
          f"launches")
    out = {}
    for kernel in ("cuda", "plain"):
        one = Glove(t8, dataclasses.replace(one_cfg, kernel=kernel),
                    cache=g.cache, device="cuda")
        one.fit(initial_weights=g.state, cooccurrences=co)
        out[kernel] = one.state
    err, rel = rel_diff(torch, out["cuda"], out["plain"])
    print(f"  text8 GloVe, one epoch through B5 vs through the plain twin "
          f"(same permutation): max|diff| {err:.3e}, relative L2 {rel:.3e} "
          f"(tolerance {EPOCH_TOL:g})")
    check(err <= EPOCH_TOL, "GloVe epoch: B5 and plain twin disagree")
    _, _, n = glove_fit(torch, fg, f"Zipf {ZIPF_VOCAB} names GloVe", zipf,
                        dataclasses.replace(cfg, epochs=2))
    return launches + n


# ---------------------------------------------------------------------------
# phase 9: LeNet-MNIST training, evaluation and serving
# ---------------------------------------------------------------------------

LENET_B = 128
LENET_LOSS_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}   # as the CPU tests
LENET_DENSE_TOL = 3e-2     # bf16 dense product, card vs CPU, of max |ref|
LENET_SERVE_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
LENET_MIN_ACC = 0.90       # tests/test_mnist_e2e.py:122 on data/mnist
LENET_TIMED_EPOCHS = 13    # 13 x 16 batches = 208 steps

#: a LeNet step's device kernels by kind, first match wins; cuDNN's own
#: padding and layout kernels count with the convolutions (its cutlass
#: wgrad kernels are named for neither direction)
LENET_KINDS = (("convolutions (cuDNN)", ("conv", "grad", "fprop",
                                         "implicit_gemm", "Padding",
                                         "nhwcTo", "nchwTo", "cudnn")),
               ("GEMMs", GEMM_MARKS), ("max pooling", ("MaxOps",)),
               ("copies and casts", ("copy",)),
               ("finite checks", ("ReduceOp<bool",)))


def lenet_flops(batch: int) -> float:
    """bench.py:500-505: one training step (forward x 3)."""
    macs = (28 * 28 * 25 * 1 * 20 + 14 * 14 * 25 * 20 * 50
            + 7 * 7 * 50 * 500 + 500 * 10)
    return 3.0 * 2.0 * macs * batch


def mnist_split(train: bool):
    from deeplearning4j_tpu_torch.datasets.fetchers import MnistDataFetcher

    f = MnistDataFetcher(train=train, flatten=False, binarize=False)
    check(not f.synthetic, "data/mnist not found")
    f.fetch(f.total)
    return f.next()


def lenet_net(ln, dtype, params, device):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    return MultiLayerNetwork(
        ln.lenet_conf(compute_dtype=dtype),
        params=[{k: v.to(device) for k, v in p.items()} for p in params],
        device=device)


def lenet_random_batches(n: int, seed: int = 0):
    """``n`` batches of seeded uniform images and labels (the CPU parity
    tests' inputs, tests/test_torch_lenet.py, at B=128)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    rng = np.random.default_rng(seed)
    x = rng.random((n * LENET_B, 28, 28, 1), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n * LENET_B)]
    return DataSet(x, y).batch_by(LENET_B)


def lenet_losses(ln, dtype, params, batches, device):
    from deeplearning4j_tpu_torch.optimize.listeners import \
        CollectScoresListener

    net = lenet_net(ln, dtype, params, device)
    col = CollectScoresListener()
    net.set_listeners([col])
    net.fit_backprop(batches)
    return np.array([v for _, v in col.scores])


def lenet_parity(torch, ln, params, mnist_batches) -> None:
    """The same params and batches through the port on the card and on
    the CPU, fp32 and bf16: held to the bar on seeded random images;
    data/mnist's batches printed beside them, not held: their flat
    saturated regions give max-pool windows that tie in exact
    arithmetic, and each conv algorithm's rounding breaks those ties its
    own way (cuDNN on the card agrees with an im2col conv on the CPU
    over 10 steps, and two CPU convs part by 3e-3:
    tools/lenet_tie_probe.py).  Then pooling ties on the card, and the
    bf16 dense 2450 -> 500 product with cuBLAS's reduced-precision
    reduction on and off."""
    random_batches = lenet_random_batches(len(mnist_batches))
    for dtype, tol in LENET_LOSS_RTOL.items():
        for what, batches in (("seeded random", random_batches),
                              ("data/mnist", mnist_batches)):
            cuda = lenet_losses(ln, dtype, params, batches, "cuda")
            cpu = lenet_losses(ln, dtype, params, batches, "cpu")
            rel = np.abs(cuda - cpu) / np.abs(cpu)
            held = what == "seeded random"
            print(f"  LeNet {dtype}, {what} batches: {len(batches)} steps at "
                  f"B={LENET_B}, card vs CPU: losses "
                  + " ".join(f"{v:.6f}" for v in cuda)
                  + f"; largest relative difference {rel.max():.3e} at "
                  f"step {int(rel.argmax())} "
                  + (f"(tolerance {tol:g})" if held else
                     "(exact ties broken by rounding: not held)"))
            check(bool(np.isfinite(cuda).all()),
                  f"LeNet {dtype}: non-finite loss on the card")
            if held and dtype == "float32":
                again = lenet_losses(ln, dtype, params, batches, "cuda")
                print(f"  LeNet {dtype}, {what} batches: a second card run "
                      f"against the first: largest relative difference "
                      f"{(np.abs(again - cuda) / np.abs(cuda)).max():.3e}")
            if held:
                check(rel.max() <= tol, f"LeNet {dtype}: card and CPU "
                                        f"losses differ by {rel.max()}")

    # max pooling must send a tied window's gradient to its first
    # largest entry (XLA's select_and_scatter) on the card too
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        LayerKind, NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import make_layer

    pool = make_layer(NeuralNetConfiguration(kind=LayerKind.SUBSAMPLING,
                                             pool_size=(2, 2)))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 3, (LENET_B, 28, 28, 20))
                         .astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(LENET_B, 14, 14, 20))
                          .astype(np.float32))
    grads = []
    for dev in ("cuda", "cpu"):
        xd = x.to(dev).requires_grad_(True)
        (pool.activate({}, xd) * dy.to(dev)).sum().backward()
        grads.append(xd.grad.cpu())
    print(f"  LeNet max pooling on a tie-heavy input: card and CPU "
          f"gradients {'equal' if torch.equal(*grads) else 'DIFFER'}")
    check(torch.equal(*grads), "max pooling routes ties differently on "
                               "the card")

    cuda_net = lenet_net(ln, "bfloat16", params, "cuda")
    cpu_net = lenet_net(ln, "bfloat16", params, "cpu")
    x = mnist_batches[0].features
    with torch.no_grad():
        h = cpu_net.feed_forward(cpu_net.params, x, upto=4)[-1]
        h = h.reshape(h.shape[0], -1)
        dense = cpu_net.layers[4]
        ref = dense.pre_output(cpu_net.params[4], h)
        matmul = torch.backends.cuda.matmul
        flag = matmul.allow_bf16_reduced_precision_reduction
        errs = {}
        for on in (True, False):
            matmul.allow_bf16_reduced_precision_reduction = on
            got = dense.pre_output(cuda_net.params[4], h.cuda()).cpu()
            errs[on] = float((got - ref).abs().max() / ref.abs().max())
        matmul.allow_bf16_reduced_precision_reduction = flag
    print(f"  LeNet bf16 dense 2450->500 at B={LENET_B}, card vs CPU, max "
          f"|diff| / max |ref|: {errs[True]:.3e} with cuBLAS's reduced-"
          f"precision bf16 reduction allowed, {errs[False]:.3e} without "
          f"(tolerance {LENET_DENSE_TOL:g}; the port leaves the flag at "
          f"{flag})")
    check(errs[flag] <= LENET_DENSE_TOL,
          f"bf16 dense product differs from the CPU's by {errs[flag]}")


def profile_kernels(torch, run):
    """{kernel name: (device ms, launches)} of one call of ``run``, and
    its wall ms (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return ({e.key: (e.self_device_time_total / 1e3, e.count)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.self_device_time_total > 0}, wall)


def lenet_kind(name: str) -> str:
    for kind, marks in LENET_KINDS:
        if any(m in name for m in marks):
            return kind
    return "elementwise and the rest"


def lenet_times(torch, ln, batches, steps_per_epoch: int,
                card: str) -> None:
    """Steady-state step time at B=128 on batches already on the card:
    the median of >= 200 steps on the host clock (each step synchronized
    by a listener reading its loss), the same steps unsynchronized
    between CUDA events, one
    profiled epoch's busy share and device ms by kernel kind, and the
    peak memory."""
    from deeplearning4j_tpu_torch.datasets.iterator import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.optimize.listeners import TimingListener

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    batches = [DataSet(b.features.cuda(), b.labels.cuda()) for b in batches]
    net = ln.lenet(device="cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 1e6
    torch.cuda.reset_peak_memory_stats()     # the warm-up captures the step
    net.fit_backprop(batches)                       # warm-up epoch
    torch.cuda.synchronize()
    timer = TimingListener()
    net.set_listeners([timer])
    net.fit_iterator(ListDataSetIterator(batches, LENET_B),
                     num_epochs=LENET_TIMED_EPOCHS)
    step_ms = [d * 1e3 for d in timer.durations[1:]]
    check(len(step_ms) >= 200, f"{len(step_ms)} timed steps")
    med = float(np.median(step_ms))
    net.set_listeners([])
    n_steps = LENET_TIMED_EPOCHS * steps_per_epoch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    net.fit_backprop(batches, num_epochs=LENET_TIMED_EPOCHS)
    end.record()
    end.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n_steps
    ev = start.elapsed_time(end) / n_steps
    peak = torch.cuda.max_memory_allocated() / 1e6
    flops = lenet_flops(LENET_B)
    print(f"  LeNet bf16 step at B={LENET_B} on {card}: {med:.3f} ms "
          f"median of "
          f"{len(step_ms)} (host clock, each step synchronized; min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}) = "
          f"{LENET_B / med * 1e3:.1f} samples/s; fit_backprop's staged "
          f"path, {n_steps} steps with no sync between: {ev:.3f} ms a "
          f"step between CUDA events ({wall:.3f} ms host clock) = "
          f"{LENET_B / ev * 1e3:.1f} samples/s; model FLOPs "
          f"{flops / 1e9:.2f} GFLOP a step = "
          f"{flops / (ev / 1e3) / PEAK_BF16_FLOPS:.3%} of 989 TFLOP/s; "
          f"peak memory {peak:.1f} MB, {held:.1f} MB of it allocated "
          f"before the warm-up (earlier phases' engine entries and the "
          f"batches)")

    by, wall = profile_kernels(torch, lambda: net.fit_backprop(batches))
    if not by:
        print("  LeNet profile: no device time reported (not measured)")
        return
    busy = sum(ms for ms, _ in by.values())
    launches = sum(n for _, n in by.values())
    kinds = {}
    for name, (ms, n) in by.items():
        k = kinds.setdefault(lenet_kind(name), [0.0, 0])
        k[0] += ms
        k[1] += n
    print(f"  LeNet profile of one epoch ({steps_per_epoch} steps) on "
          f"{card}: device "
          f"busy {busy:.3f} ms of {wall:.3f} ms wall = {busy / wall:.1%}; "
          f"{launches} kernels = {launches / steps_per_epoch:.1f} a step; "
          f"device ms a step by kind: " + "; ".join(
              f"{kind} {ms / steps_per_epoch:.4f} ms ({n / steps_per_epoch:.1f}"
              f" kernels)" for kind, (ms, n) in
              sorted(kinds.items(), key=lambda kv: -kv[1][0])))
    for name, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {ms / steps_per_epoch:8.4f} ms a step, {n:5d} launches  "
              f"{name[:100]}")


def lenet_serving_check(torch, ln, net, test) -> None:
    """A served mixed-size stream through the warmed engine (bf16, and
    the same params at fp32) against the unpadded forward."""
    for dtype in ("bfloat16", "float32"):
        snet = lenet_net(ln, dtype, net.params, "cuda")
        t0 = time.perf_counter()
        eng = ln.lenet_serving(snet)
        warm = (time.perf_counter() - t0) * 1e3
        worst, lat = 0.0, []
        for n in (1, 3, 17, 100, 128, 200, 300, 512):
            x = test.features[:n]
            t0 = time.perf_counter()
            out = eng.infer(x, sync=True)
            lat.append((n, (time.perf_counter() - t0) * 1e3))
            with torch.inference_mode():
                ref = snet.feed_forward(snet.params, x.cuda())[-1]
            check(tuple(out.shape) == (n, 10), f"served shape {out.shape}")
            worst = max(worst, float((out - ref).abs().max()))
        print(f"  LeNet serving {dtype}: {len(eng.buckets)} buckets "
              f"{eng.buckets} warmed in {warm:.1f} ms; stream of "
              + ", ".join(f"{n} rows {ms:.2f} ms" for n, ms in lat)
              + f" (host clock, synchronized); largest |diff| to the "
              f"unpadded forward {worst:.3e} (tolerance "
              f"{LENET_SERVE_TOL[dtype]:g})")
        check(worst <= LENET_SERVE_TOL[dtype],
              f"LeNet {dtype}: served rows differ from the unpadded "
              f"forward by {worst}")


def lenet_phase(torch, ln, card: str) -> None:
    """Phase 9 (see the module docstring)."""
    from deeplearning4j_tpu_torch.datasets.iterator import \
        MnistDataSetIterator

    t0 = time.perf_counter()
    train, test = mnist_split(True), mnist_split(False)
    batches = train.batch_by(LENET_B)
    print(f"  data/mnist: {train.num_examples()} train, "
          f"{test.num_examples()} test images; {len(batches)} batches of "
          f"{LENET_B}; read in {time.perf_counter() - t0:.2f} s")
    params = ln.lenet(device="cpu").params
    lenet_parity(torch, ln, params, batches[:10])

    for how in ("fit_backprop", "fit_iterator"):
        net = ln.lenet(device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if how == "fit_backprop":
            net.fit_backprop(batches, num_epochs=2)
        else:
            net.fit_iterator(MnistDataSetIterator(
                LENET_B, binarize=False, flatten=False), num_epochs=2)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        ev = net.evaluate(test)
        print(f"  LeNet bf16 {how}, 2 epochs: {sec:.3f} s (host clock, "
              f"synchronized); test accuracy {ev.accuracy():.4f}, f1 "
              f"{ev.f1():.4f} over {ev.confusion.total()} images (bar "
              f"{LENET_MIN_ACC}); guard skips {net.guard_skips}")
        check(ev.accuracy() >= LENET_MIN_ACC,
              f"LeNet {how}: test accuracy {ev.accuracy()}")
    lenet_serving_check(torch, ln, net, test)
    lenet_times(torch, ln, batches, len(batches), card)


# ---------------------------------------------------------------------------
# phase 10: GPT-2 small generation serving
# ---------------------------------------------------------------------------

#: the device phase 10 runs on (a CPU rehearsal substitutes "cpu")
GEN_DEVICE = "cuda"
GEN_PROMPTS, GEN_PROMPT_LEN, GEN_TOKENS = 4, 128, 64
#: teacher-forced decode logits vs the dense forward (phase 4's bf16 bar)
GEN_LOGITS_TOL = {"bfloat16": LOGITS_TOL, "float32": 1e-3}
GEN_SLOTS = 8
BURST, BURST_MIN, BURST_MAX, BURST_TOKENS, BURST_TEMP = 32, 16, 512, 64, 0.8
#: greedy parity with solo generate holds up to the first step whose
#: top-2 margin (solo run, fp32) is below this
PARITY_MARGIN = 1e-3
#: int8 logits, card vs CPU, of max(|CPU|, 1) (test_serving_tier2.py:204)
KV_DRIFT = 0.05
SCORING_T, SCORING_BUCKETS, SCORING_ROWS = 1024, (1, 2, 4), (1, 3, 4)


def gen_config(gpt):
    """GPT-2 small, bf16 (gpt.gpt_config())."""
    return gpt.gpt_config()


def top2_margin(torch, logits):
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def decode_against_dense(torch, gpt, cfg, params, say) -> None:
    """(a) generate's prefill and decode-step logits, teacher-forced,
    against forward_logits over the prompt and the generated tokens, in
    bf16 and fp32; greedy tokens against the dense argmax wherever its
    top-2 margin exceeds the bar."""
    rng = np.random.default_rng(7)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (GEN_PROMPTS, GEN_PROMPT_LEN)).astype(np.int32)
    ).to(GEN_DEVICE)
    for c in (cfg, dataclasses.replace(cfg, compute_dtype="float32")):
        bar = GEN_LOGITS_TOL[c.compute_dtype]
        t0 = time.perf_counter()
        toks, logits = gpt.generate(c, params, prompts, GEN_TOKENS,
                                    temperature=0.0, return_logits=True)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        with torch.inference_mode():
            dense = gpt.forward_logits(
                c, params, torch.cat([prompts, toks], dim=1))[
                    :, GEN_PROMPT_LEN - 1:GEN_PROMPT_LEN - 1 + GEN_TOKENS]
        err = (logits - dense).abs().max().item()
        resolved = top2_margin(torch, dense) > bar
        agree = (toks.long() == dense.argmax(-1))[resolved]
        say(f"(a) {c.compute_dtype}: generate {GEN_PROMPTS} x "
            f"{GEN_PROMPT_LEN} prompt tokens + {GEN_TOKENS} greedy tokens "
            f"in {sec:.3f} s; prefill and step logits vs forward_logits "
            f"max|diff| {err:.3e} (bar {bar}); greedy = dense argmax at "
            f"{int(agree.sum())}/{agree.numel()} positions whose top-2 "
            f"margin exceeds the bar ({toks.numel()} in all)")
        check(bool(torch.isfinite(logits).all()), "decode logits non-finite")
        check(torch.allclose(logits, dense, rtol=bar, atol=bar),
              f"{c.compute_dtype} decode logits differ from the dense "
              f"forward by {err} (bar {bar})")
        check(bool(agree.all()), f"{c.compute_dtype} greedy tokens differ "
                                 f"from the dense argmax where it resolves")


def burst_requests(cfg):
    """32 seeded requests: prompt lengths 16-512, even ones greedy, odd
    ones sampled at 0.8, each with its own seed."""
    rng = np.random.default_rng(8)
    reqs = []
    for i in range(BURST):
        n = int(rng.integers(BURST_MIN, BURST_MAX + 1))
        reqs.append((rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                     0.0 if i % 2 == 0 else BURST_TEMP, 1000 + i))
    return reqs


def serve_burst(torch, eng, reqs):
    """Every request submitted at once to a ContinuousBatcher over
    ``eng``: (outputs, wall s, decode_metrics snapshot)."""
    from deeplearning4j_tpu_torch.runtime.metrics import decode_metrics
    from deeplearning4j_tpu_torch.serving.decode import ContinuousBatcher

    decode_metrics.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ContinuousBatcher(eng, default_max_tokens=BURST_TOKENS) as cb:
        handles = [cb.submit(p, max_tokens=BURST_TOKENS, temperature=t,
                             seed=s) for p, t, s in reqs]
        outs = [h.result(timeout=600) for h in handles]
    wall = time.perf_counter() - t0
    for o in outs:
        check(o.shape == (BURST_TOKENS,), f"burst output shape {o.shape}")
        check(bool(((o >= 0) & (o < eng.cfg.vocab_size)).all()),
              "burst token out of the vocabulary")
    check(eng.n_active() == 0 and all(
        b.free_slot() == 0 for b in eng._buckets.values()),
        "slots not all free after the burst")
    return outs, wall, decode_metrics.snapshot()


def solo_generate(torch, gpt, cfg, params, eng, p, temp, seed,
                  return_logits=False):
    """One request alone through generate, in its engine bucket's
    cache length."""
    return gpt.generate(cfg, params, torch.from_numpy(p[None]).to(
        GEN_DEVICE), BURST_TOKENS, seed=seed, temperature=temp,
        max_len=eng.pick_bucket(p.size + BURST_TOKENS),
        return_logits=return_logits)


def busy_share_cuda(torch, run):
    """(device busy ms, wall ms) of ``run``: torch.profiler with device
    activity only, summed over the raw trace events (a burst launches
    ~10^5 kernels, too many to turn into profiler function events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    busy = sum(e.duration_ns()
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda) / 1e6
    return busy, wall


def decode_step_profile(torch, cfg, eng, say) -> None:
    """Host and device time of one decode step with every slot of the
    largest bucket active (prompts of 512, budgets of 64)."""
    bucket = eng.buckets[-1]
    rng = np.random.default_rng(9)
    placed = [eng.start(rng.integers(0, cfg.vocab_size, BURST_MAX),
                        max_tokens=BURST_TOKENS, temperature=BURST_TEMP,
                        seed=i)[:2] for i in range(GEN_SLOTS)]
    check(all(b == bucket for b, _ in placed), "profile slots off-bucket")
    for _ in range(3):
        eng.advance(bucket)
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        eng.advance(bucket)
        host.append((time.perf_counter() - t0) * 1e3)
    by, _ = profile_kernels(torch, lambda: eng.advance(bucket))
    for b, s in placed:
        eng.release(b, s)
    dev_ms = sum(ms for ms, _ in by.values())
    n_kernels = sum(n for _, n in by.values())
    kv = 2 * cfg.n_layers * GEN_SLOTS * bucket * cfg.hidden * 2
    weights = 2 * (12 * cfg.n_layers * cfg.hidden ** 2
                   + cfg.vocab_size * cfg.hidden)
    bound = (kv + weights) / PEAK_BYTES_PER_S * 1e3
    say(f"(b) one decode step, {GEN_SLOTS} slots active in bucket {bucket}: "
        f"host {np.median(host):.3f} ms (median of 10, synchronized by the "
        f"token fetch), device {dev_ms:.3f} ms in {n_kernels} kernels "
        f"(profiler; {dev_ms / np.median(host):.1%} busy); bound "
        f"{bound:.3f} ms ({(kv + weights) / 1e6:.0f} MB of bf16 weights "
        f"and KV at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s)")
    for key, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:6]:
        say(f"    {ms:8.3f} ms  {n:4d}x  {key[:90]}")


def continuous_batching(torch, gpt, cfg, params, reqs, say):
    """(b) the burst through DecodeEngine(n_slots=8) + ContinuousBatcher:
    bf16 timed and profiled, fp32 greedy parity with solo generate,
    sampled requests resubmitted alone, the burst again as sequential
    solo generate calls.  Returns the bf16 outputs."""
    from deeplearning4j_tpu_torch.serving.decode import (
        DecodeEngine, default_length_buckets)

    ladder = default_length_buckets(cfg.max_len)
    eng = DecodeEngine(cfg, params, n_slots=GEN_SLOTS, buckets=ladder,
                       device=GEN_DEVICE)
    w = eng.warmup()
    say(f"(b) DecodeEngine: {GEN_SLOTS} slots, buckets {list(ladder)}, "
        f"prefill chunk {eng.prefill_chunk}, warmup {w['warmup_ms']:.1f} "
        f"ms; kv_bytes_per_slot {eng.kv_bytes_per_slot} "
        f"({eng.kv_bytes_per_slot / 2 ** 20:.1f} MiB, bucket {ladder[-1]})")
    torch.cuda.reset_peak_memory_stats()
    outs, wall, snap = serve_burst(torch, eng, reqs)
    n_tok = BURST * BURST_TOKENS
    say(f"(b) bf16 burst of {BURST} requests (prompts {BURST_MIN}-"
        f"{BURST_MAX}, {BURST_TOKENS} tokens each, half sampled at "
        f"{BURST_TEMP}): {wall:.3f} s, {n_tok / wall:.1f} tokens/s; TTFT "
        f"p50 {snap['ttft_p50_ms']:.2f} ms p99 {snap['ttft_p99_ms']:.2f} "
        f"ms; per-step latency p50 {snap['tok_p50_ms']:.2f} ms p99 "
        f"{snap['tok_p99_ms']:.2f} ms; {snap['decode_dispatches']} decode "
        f"steps, {snap['prefill_dispatches']} prefill chunks, "
        f"{snap['joins']} mid-flight joins, slot occupancy "
        f"{snap['slot_occupancy']:.3f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check(snap["joins"] > 0, "no request joined mid-flight")
    check(snap["requests_completed"] == BURST, "burst incomplete")

    # the same burst as sequential solo generate calls (bench.py's
    # decode_serving comparison)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = [solo_generate(torch, gpt, cfg, params, eng, p, t, s)
           for p, t, s in reqs]
    torch.cuda.synchronize()
    seq_wall = time.perf_counter() - t0
    same = sum(int(np.array_equal(o, q[0].cpu().numpy()))
               for o, q in zip(outs, seq))
    say(f"(b) the same burst as {BURST} sequential solo generate calls: "
        f"{seq_wall:.3f} s, {n_tok / seq_wall:.1f} tokens/s; continuous "
        f"batching {seq_wall / wall:.2f}x its tokens/s; {same}/{BURST} "
        f"requests token-identical (bf16, printed, not held)")

    # sampled requests resubmitted alone reproduce bit for bit
    t0 = time.perf_counter()
    sampled = [i for i, (_, t, _) in enumerate(reqs) if t > 0]
    alone = serve_burst(torch, eng, [reqs[sampled[0]]])[0]
    for i in sampled[1:]:
        alone += serve_burst(torch, eng, [reqs[i]])[0]
    diff = [i for i, a in zip(sampled, alone) if not np.array_equal(
        a, outs[i])]
    say(f"(b) {len(sampled)} sampled requests resubmitted alone: "
        f"{len(sampled) - len(diff)} token-identical to their burst run "
        f"({time.perf_counter() - t0:.1f} s)")
    check(not diff, f"sampled requests {diff} changed when resubmitted "
                    f"alone")

    t0 = time.perf_counter()
    decode_step_profile(torch, cfg, eng, say)
    t1 = time.perf_counter()
    busy, wall_ms = busy_share_cuda(torch, lambda: serve_burst(
        torch, eng, reqs))
    say(f"(b) profiled burst: device busy {busy:.1f} ms of {wall_ms:.1f} "
        f"ms wall ({busy / wall_ms:.1%}; torch.profiler, device activity "
        f"only); the step profile took {t1 - t0:.1f} s, this "
        f"{time.perf_counter() - t1:.1f} s")
    del eng

    # fp32 greedy parity: each greedy request in the busy batch matches
    # its solo generate up to the solo run's first step of top-2 margin
    # below PARITY_MARGIN
    t0 = time.perf_counter()
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    eng32 = DecodeEngine(c32, params, n_slots=GEN_SLOTS, buckets=ladder,
                         device=GEN_DEVICE)
    eng32.warmup()
    outs32, wall32, snap32 = serve_burst(torch, eng32, reqs)
    held = total = cut = 0
    for i, (p, t, s) in enumerate(reqs):
        if t > 0:
            continue
        toks, logits = solo_generate(torch, gpt, c32, params, eng32, p, t,
                                     s, return_logits=True)
        low = (top2_margin(torch, logits[0]) < PARITY_MARGIN).nonzero()
        n = int(low[0, 0]) if low.numel() else BURST_TOKENS
        cut += int(n < BURST_TOKENS)
        check(np.array_equal(outs32[i][:n], toks[0, :n].cpu().numpy()),
              f"fp32 greedy request {i} differs from its solo generate "
              f"within its first {n} tokens")
        held += n
        total += BURST_TOKENS
    say(f"(b) fp32 burst: {wall32:.3f} s, {n_tok / wall32:.1f} tokens/s, "
        f"{snap32['joins']} joins; greedy parity with solo generate held "
        f"over {held}/{total} tokens of {BURST // 2} requests ({cut} cut "
        f"at a step of top-2 margin < {PARITY_MARGIN}); "
        f"{time.perf_counter() - t0:.1f} s in all")
    del eng32
    return outs


def int8_against_cpu(torch, gpt, qz, updaters, cfg, params, say) -> None:
    """The reference's int8 bars on the card against the port's CPU:
    every quantized leaf's round trip within scale / 2 and its payload
    equal to the CPU's but for ones at rounding boundaries
    (test_serving_tier2.py:70); prefill logits through int8 weights and
    the int8 KV cache within KV_DRIFT of the CPU's (:204)."""
    from deeplearning4j_tpu_torch.models import transformer as tfm

    cdt = tfm.compute_dtype(cfg)
    with torch.inference_mode():
        q_card = qz.quantize_tree(params, "int8")
        cpu_params = updaters.tree_map(lambda t: t.cpu(), params)
        q_cpu = qz.quantize_tree(cpu_params, "int8")
        worst_rt, off, n = 0.0, 0, 0
        for grp in params:
            for name, leaf in q_card[grp].items():
                if not isinstance(leaf, qz.QTensor):
                    continue
                sb = leaf.scale.reshape(qz._scale_bshape(leaf.q.ndim,
                                                         leaf.scale))
                rt = ((qz.dequantize_leaf(leaf) - params[grp][name]).abs()
                      / sb).max().item()
                worst_rt = max(worst_rt, rt)
                d = (leaf.q.cpu().int() - q_cpu[grp][name].q.int()).abs()
                check(int(d.max()) <= 1, f"int8 {grp}/{name}: card and "
                                         f"CPU payloads differ by {d.max()}")
                off += int((d > 0).sum())
                n += d.numel()
        check(worst_rt <= 0.5 + 1e-5, f"int8 round trip {worst_rt} scales")
        check(off <= 1e-3 * n, f"int8 payloads: {off} of {n} off by one")
        prompt = torch.from_numpy(np.random.default_rng(11).integers(
            0, cfg.vocab_size, (1, GEN_PROMPT_LEN)).astype(np.int32))
        logits = []
        for tree, dev in ((q_card, GEN_DEVICE), (q_cpu, "cpu")):
            cache = gpt.init_cache(cfg, 1, GEN_PROMPT_LEN, "int8", dev)
            logits.append(gpt._prefill_chunk(
                cfg, qz.dequantize_tree(tree, cdt), cache, prompt.to(dev),
                0)[1].cpu())
    err = (logits[0] - logits[1]).abs().max().item()
    scale = max(logits[1].abs().max().item(), 1.0)
    say(f"(c) int8 on the card vs the port's CPU: round trip <= "
        f"{worst_rt:.6f} scales (bar 0.5), payloads off by one at {off} "
        f"of {n}; int8 weights + int8 KV prefill logits of a "
        f"{GEN_PROMPT_LEN}-token prompt max|diff| {err:.3e} (bar "
        f"{KV_DRIFT} x {scale:.3f})")
    check(err <= KV_DRIFT * scale, f"int8 logits card vs CPU {err}")


def quantized_serving(torch, gpt, cfg, params, reqs, base, say) -> None:
    """(c) the burst with quantize="int8", kv_dtype="int8" and with
    quantize="bf16": tokens/s, kv_bytes_per_slot, greedy agreement with
    full precision, the dequantization's device ms a dispatch."""
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.runtime import quantize as qz
    from deeplearning4j_tpu_torch.serving.decode import (
        DecodeEngine, default_length_buckets)

    t0 = time.perf_counter()
    int8_against_cpu(torch, gpt, qz, updaters, cfg, params, say)
    say(f"(c) int8 against the CPU took {time.perf_counter() - t0:.1f} s")
    cdt = tfm.compute_dtype(cfg)
    for mode, kv in (("int8", "int8"), ("bf16", None)):
        eng = DecodeEngine(cfg, params, n_slots=GEN_SLOTS,
                           buckets=default_length_buckets(cfg.max_len),
                           quantize=mode, kv_dtype=kv, device=GEN_DEVICE)
        eng.warmup()
        outs, wall, snap = serve_burst(torch, eng, reqs)
        qp = eng.current_params()
        deq_ms = time_ms(torch, lambda: qz.dequantize_tree(qp, cdt),
                         iters=10)
        lead = []
        for i, (_, t, _) in enumerate(reqs):
            if t > 0:
                continue
            d = np.nonzero(outs[i] != base[i])[0]
            lead.append(int(d[0]) if d.size else BURST_TOKENS)
        say(f"(c) quantize={mode} kv_dtype={kv}: {wall:.3f} s, "
            f"{BURST * BURST_TOKENS / wall:.1f} tokens/s; "
            f"kv_bytes_per_slot {eng.kv_bytes_per_slot} "
            f"({eng.kv_bytes_per_slot / 2 ** 20:.1f} MiB); weights "
            f"{qz.tree_bytes(qp) / 1e6:.1f} MB; dequantization "
            f"{deq_ms:.4f} ms a dispatch (CUDA events); greedy tokens "
            f"equal to full precision's up to the first difference: "
            f"{sum(lead)}/{len(lead) * BURST_TOKENS} ({sum(x == BURST_TOKENS for x in lead)}/{len(lead)} "
            f"requests whole); TTFT p50 {snap['ttft_p50_ms']:.2f} ms, "
            f"per-step p50 {snap['tok_p50_ms']:.2f} ms")
        del eng


def gpt_scoring(torch, fa, gpt, cfg, params, say) -> int:
    """(d) GPT scoring through InferenceEngine(gpt.make_serving_apply) at
    T=1024 causal, buckets 1/2/4: logits within the bar of the
    plain-attention forward, B1 launched once per layer per dispatch;
    one more row through InferenceEngine(quantize="int8"), held to the
    plain-attention forward of the dequantized tree.  Returns the B1 launches of the counted
    dispatches."""
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.runtime import quantize as qz
    from deeplearning4j_tpu_torch.serving.engine import InferenceEngine

    apply_fn = gpt.make_serving_apply(cfg)
    eng = InferenceEngine(apply_fn, params, buckets=SCORING_BUCKETS,
                          device=GEN_DEVICE)
    w = eng.warmup(input_shape=(SCORING_T,), dtype=np.int32)
    q8 = InferenceEngine(apply_fn, params, buckets=(1,), quantize="int8",
                         device=GEN_DEVICE)
    q8.warmup(input_shape=(SCORING_T,), dtype=np.int32)
    rng = np.random.default_rng(12)
    reqs = [rng.integers(0, cfg.vocab_size, (n, SCORING_T)).astype(np.int32)
            for n in SCORING_ROWS]
    fa.reset_launches()
    t0 = time.perf_counter()
    outs = [eng.infer(x, sync=True) for x in reqs]
    sec = time.perf_counter() - t0
    q_out = q8.infer(reqs[0], sync=True)
    launches = fa.launch_counts()
    n_disp = len(reqs) + 1
    plain = gpt.make_serving_apply(cfg, attn_fn=tfm.attention)
    with torch.inference_mode():
        x0 = torch.from_numpy(reqs[0]).to(GEN_DEVICE)
        q_ref = plain(qz.dequantize_tree(q8.current_params()), x0)
        q_err = (q_out - q_ref).abs().max().item()
        q_ok = torch.allclose(q_out, q_ref, rtol=LOGITS_TOL, atol=LOGITS_TOL)
        del q_ref
    q_far = (q_out - outs[0]).abs().max().item()
    say(f"(d) InferenceEngine(quantize=\"int8\"), 1 row: max|diff| vs the "
        f"plain-attention forward of the dequantized tree {q_err:.3e} "
        f"(tolerance {LOGITS_TOL}), vs full precision {q_far:.3e}")
    check(q_ok, f"int8 scoring differs from the plain-attention forward of "
                f"the dequantized tree by {q_err}")
    check(q_far > 1e-3, "int8 scoring equals full precision: not quantized")
    err = 0.0
    with torch.inference_mode():
        for x, got in zip(reqs, outs):
            check(got.shape == (x.shape[0], SCORING_T, cfg.vocab_size),
                  f"scoring shape {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), "scoring non-finite")
            ref = plain(params, torch.from_numpy(x).to(GEN_DEVICE))
            e = (got - ref).abs().max().item()
            err = max(err, e)
            check(torch.allclose(got, ref, rtol=LOGITS_TOL, atol=LOGITS_TOL),
                  f"scoring logits differ from the plain forward by {e}")
            del ref
    say(f"(d) GPT scoring at T={SCORING_T} causal, buckets "
        f"{list(SCORING_BUCKETS)} (warmup {w['warmup_ms']:.1f} ms): "
        f"{len(reqs)} requests of {list(SCORING_ROWS)} rows in {sec:.3f} s "
        f"(host clock, synchronized; {sum(SCORING_ROWS) * SCORING_T / sec:.1f} "
        f"tokens/s); max|diff| vs the plain-attention forward {err:.3e} "
        f"(tolerance {LOGITS_TOL}); B1 launches {launches['launches']} "
        f"({cfg.n_layers} layers x {n_disp} dispatches, the int8 one "
        f"included)")
    check(launches["launches"] == cfg.n_layers * n_disp,
          f"B1 launched {launches['launches']} times for {n_disp} "
          f"scoring dispatches")
    check(launches["launches_dkv"] == launches["launches_dq"] == 0,
          "a backward kernel ran while scoring")
    return launches["launches"]


def generation_phase(torch, fa, card: str) -> int:
    """Phase 10 (see the module docstring).  Returns B1's launches."""
    from deeplearning4j_tpu_torch.models import gpt

    def say(msg):
        print(f"  {msg} [{card}]")

    cfg = gen_config(gpt)
    gen = torch.Generator(device=GEN_DEVICE)
    gen.manual_seed(0)
    params = gpt.init_params(gen, cfg, device=GEN_DEVICE)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    reqs = burst_requests(cfg)
    t0 = time.perf_counter()
    decode_against_dense(torch, gpt, cfg, params, say)
    t1 = time.perf_counter()
    base = continuous_batching(torch, gpt, cfg, params, reqs, say)
    t2 = time.perf_counter()
    quantized_serving(torch, gpt, cfg, params, reqs, base, say)
    t3 = time.perf_counter()
    hand = fa.launch_counts()
    check(not any(hand.values()), f"flash kernels ran on the decode "
                                  f"path: {hand}")
    n = gpt_scoring(torch, fa, gpt, cfg, params, say)
    say(f"phase 10 wall: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
        f"{t3 - t2:.1f} s, (d) {time.perf_counter() - t3:.1f} s")
    return n

# ---------------------------------------------------------------------------
# phase 11: the compile engine's CUDA graphs against the raw functions
# ---------------------------------------------------------------------------

#: captured against eager, each bar with its reason: LeNet fp32 runs the
#: same kernels in both (cuDNN deterministic for both); the transformer
#: steps (bf16 with dropout) ran bit-equal captured and eager, so the
#: loss and the parameters' change from the initial state (p_k - p_0) are
#: held at 1e-6 relative, a bar that a frozen AdamW count or frozen
#: dropout masks fail by orders of magnitude; decode logits fp32 / bf16;
#: B4 and B5 sum a row's hits with atomics in no fixed order
GRAPH_LENET_RTOL = 1e-6
GRAPH_TRAIN_RTOL = 1e-6
GRAPH_DECODE_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
GRAPH_EMBED_RTOL = 1e-4
GRAPH_LENET_STEPS, GRAPH_TRAIN_STEPS, GRAPH_DECODE_STEPS = 20, 10, 8
GRAPH_TIMED = {"lenet": 30, "train": 5, "decode": 20}


@contextlib.contextmanager
def eager_engine():
    """Every compile-engine entry runs its raw function (``call.fn``):
    the eager comparator, nothing captured or counted."""
    from deeplearning4j_tpu_torch.runtime import compile_cache

    call = compile_cache.GraphFn.__call__
    compile_cache.GraphFn.__call__ = lambda self, *a, **kw: self.fn(*a, **kw)
    try:
        yield
    finally:
        compile_cache.GraphFn.__call__ = call


def host_ms(torch, run, n: int) -> float:
    """Median host ms of ``n`` calls of ``run``, each synchronized."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def device_ms(torch, run, n: int):
    """(device ms, kernels) a call of ``run`` over ``n`` profiled calls
    (torch.profiler); (None, 0) when it reports no device time."""
    by, _ = profile_kernels(torch, lambda: [run() for _ in range(n)])
    if not by:
        return None, 0
    return (sum(ms for ms, _ in by.values()) / n,
            sum(k for _, k in by.values()) / n)


def graph_times(torch, what, runs, n_host, n_dev, say):
    """Host ms, device ms and busy share of each of ``runs`` ({"eager":
    fn, "captured": fn}), printed side by side."""
    rows = {}
    for how, run in runs.items():
        h = host_ms(torch, run, n_host)
        d, k = device_ms(torch, run, n_dev)
        rows[how] = (h, d, k)
    parts = []
    for how, (h, d, k) in rows.items():
        dev = ("device not measured" if d is None else
               f"device {d:.3f} ms in {k:.0f} kernels = {d / h:.1%} busy")
        parts.append(f"{how} host {h:.3f} ms, {dev}")
    say(f"{what}: " + "; ".join(parts)
        + f" (host: median of {n_host} synchronized calls; device: "
          f"profiler over {n_dev})")
    return rows


def graph_lenet(torch, ln, entries, say) -> None:
    """LeNet fp32 B=128: 20 steps through the raw step and through its
    graph from the same state and batches."""
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    net = lenet_net(ln, "float32", ln.lenet(device="cpu").params, "cuda")
    step = net._machinery()[0]
    entries.append(step)
    batches = [(torch.as_tensor(b.features).cuda(),
                torch.as_tensor(b.labels).cuda())
               for b in lenet_random_batches(GRAPH_LENET_STEPS, seed=3)]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        res, runs = {}, {}
        for how, fn in (("eager", step.fn), ("captured", step)):
            params, ustate, it, gen = net._fit_state(2)
            state = (params, ustate, it)
            losses = []
            for k, (x, y) in enumerate(batches):
                if k == 1:
                    c1 = compile_metrics.compile_count
                *state, loss, _ = fn(*state, x, y, gen)
                losses.append(float(loss))
            res[how] = (np.array(losses), state[0])
            if how == "captured":
                delta = compile_metrics.compile_count - c1
            runs[how] = (lambda fn=fn, st=state, g=gen: fn(
                *st, *batches[0], g))
        lrel = float(np.max(np.abs(res["captured"][0] - res["eager"][0])
                            / np.abs(res["eager"][0])))
        prel = max(float((c[k] - e[k]).abs().max() / e[k].abs().max())
                   for c, e in zip(res["captured"][1], res["eager"][1])
                   for k in e)
        say(f"LeNet fp32 B={LENET_B}, {GRAPH_LENET_STEPS} steps captured vs "
            f"eager (cuDNN deterministic for both): losses' largest relative "
            f"difference {lrel:.3e}, parameters' {prel:.3e} (bar "
            f"{GRAPH_LENET_RTOL:g}); captures over steps 2-"
            f"{GRAPH_LENET_STEPS}: {delta}")
        check(lrel <= GRAPH_LENET_RTOL and prel <= GRAPH_LENET_RTOL,
              f"LeNet: captured steps differ from eager ({lrel}, {prel})")
        check(delta == 0, f"LeNet: {delta} captures in the steady state")
        graph_times(torch, f"LeNet fp32 step B={LENET_B}", runs,
                    GRAPH_TIMED["lenet"], 10, say)
        del runs, res, state
        lenet_threads(torch, ln, say)
    finally:
        torch.backends.cudnn.deterministic = det


def lenet_threads(torch, ln, say) -> None:
    """Two LeNet networks of one conf fit at once, in two threads,
    through their shared ``multilayer.train_step``, in lockstep (a
    listener holds each step until the other thread's same step is
    done): each must end where its solo eager fit ends."""
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    batches = lenet_random_batches(GRAPH_LENET_STEPS, seed=5)
    last = batches[-1]
    # a ragged last batch: the per-step path, which calls the listeners
    # after every step
    batches[-1] = type(last)(last.features[:LENET_B // 2],
                             last.labels[:LENET_B // 2])
    inits = [ln.lenet(seed=s, device="cpu").params for s in (7, 8)]
    solo = []
    with eager_engine():
        for p in inits:
            net = lenet_net(ln, "float32", p, "cuda")
            net.fit_backprop(batches)
            solo.append(net.params_flat())
    lockstep = threading.Barrier(2, timeout=120)

    class Lockstep:
        def iteration_done(self, net, n, score):
            lockstep.wait()

    nets = [lenet_net(ln, "float32", p, "cuda") for p in inits]
    for net in nets:
        net.set_listeners([Lockstep()])
    c0 = compile_metrics.compile_count
    errors = []

    def fit(net):
        try:
            net.fit_backprop(batches)
        except Exception as e:          # reported below
            lockstep.abort()
            errors.append(e)

    threads = [threading.Thread(target=fit, args=(n,)) for n in nets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads) and not errors,
          f"LeNet threads: {errors}")
    caps = compile_metrics.compile_count - c0
    rels = [float((n.params_flat() - r).abs().max() / r.abs().max())
            for n, r in zip(nets, solo)]
    say(f"two same-conf LeNet fits ({GRAPH_LENET_STEPS} steps each, the "
        f"last batch {LENET_B // 2} rows) in two threads, in lockstep "
        f"through one shared train step, against each one's solo eager "
        f"fit: parameters' largest relative difference {rels[0]:.3e} and "
        f"{rels[1]:.3e} (bar {GRAPH_LENET_RTOL:g}); captures: {caps} (the "
        f"second live state's set, and the short batch on each set)")
    check(max(rels) <= GRAPH_LENET_RTOL,
          f"LeNet threads differ from their solo fits {rels}")
    check(caps >= 2, f"LeNet threads: {caps} captures, so the two fits "
                     f"did not run on two state sets at once")


def update_rel(torch, updaters, p0, got, ref) -> float:
    """Relative L2 of the parameters' change from ``p0``: ``|(got - p0)
    - (ref - p0)| / |ref - p0|`` over every leaf."""
    num = den = 0.0
    for a, c, e in zip(updaters.tree_leaves(p0), updaters.tree_leaves(got),
                       updaters.tree_leaves(ref)):
        d = e.double() - a.double()
        num += float((c.double() - e.double()).norm()) ** 2
        den += float(d.norm()) ** 2
    return (num / den) ** 0.5


def graph_train(torch, mod, cfg, batch, what, entries, say,
                interleave: bool = False) -> None:
    """A transformer step, bf16 with dropout: 10 steps through the raw
    step and through its graph from the same state and generator seed;
    with ``interleave``, two states stepped alternately through one
    ``step_fn``, each against its solo eager run."""
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    init_fn, step_fn = mod.make_train_step(cfg)
    graph = step_fn.graph
    entries.append(graph)
    s0 = init_fn(torch.Generator(device="cuda").manual_seed(0))
    res, runs = {}, {}
    for how, fn in (("eager", graph.fn), ("captured", graph)):
        # the raw step writes its state in place: it runs on a copy
        st = updaters.tree_map(torch.clone, (s0.params, s0.opt_state))
        gen = torch.Generator(device="cuda").manual_seed(1)
        losses = []
        for k in range(GRAPH_TRAIN_STEPS):
            if k == 1:
                c1 = compile_metrics.compile_count
            *st, loss = fn(*st, batch, gen)
            losses.append(float(loss))
        res[how] = (np.array(losses), st[0])
        if how == "captured":
            delta = compile_metrics.compile_count - c1
        runs[how] = lambda fn=fn, st=st, g=gen: fn(*st, batch, g)
    lrel = float(np.max(np.abs(res["captured"][0] - res["eager"][0])
                        / np.abs(res["eager"][0])))
    urel = update_rel(torch, updaters, s0.params, res["captured"][1],
                      res["eager"][1])
    say(f"{what}, {GRAPH_TRAIN_STEPS} steps captured vs eager (bf16, "
        f"dropout {cfg.dropout}): losses " + " / ".join(
            f"{a:.4f}:{b:.4f}" for a, b in zip(res["eager"][0],
                                               res["captured"][0]))
        + f"; largest relative loss difference {lrel:.3e}, relative L2 "
          f"of the parameters' change p_k - p_0 {urel:.3e} (bar "
          f"{GRAPH_TRAIN_RTOL:g}); captures over steps 2-"
          f"{GRAPH_TRAIN_STEPS}: {delta}")
    check(lrel <= GRAPH_TRAIN_RTOL and urel <= GRAPH_TRAIN_RTOL,
          f"{what}: captured steps differ from eager ({lrel}, {urel})")
    check(delta == 0, f"{what}: {delta} captures in the steady state")
    graph_times(torch, f"{what} step", runs, GRAPH_TIMED["train"], 2, say)
    del runs, res, st
    if interleave:
        graph_interleave(torch, updaters, init_fn, step_fn, batch, what,
                         say)


def graph_interleave(torch, updaters, init_fn, step_fn, batch, what,
                     say) -> None:
    """Two training states stepped alternately through one ``step_fn``
    (``a1 = f(a0); b1 = f(b0); a2 = f(a1)``, ...): each must end where
    its solo eager run ends, and the initial states must not change."""
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    n = 3
    inits = [init_fn(torch.Generator(device="cuda").manual_seed(s))
             for s in (2, 3)]
    kept = [updaters.tree_map(torch.clone, s.params) for s in inits]
    solo = []
    with eager_engine():
        for k, s in enumerate(inits):
            st = s._replace(params=updaters.tree_map(torch.clone, s.params),
                            opt_state=updaters.tree_map(torch.clone,
                                                        s.opt_state))
            gen = torch.Generator(device="cuda").manual_seed(10 + k)
            for _ in range(n):
                st, _ = step_fn(st, batch, gen)
            solo.append(st.params)
            del st
    c0 = compile_metrics.compile_count
    st = list(inits)
    gens = [torch.Generator(device="cuda").manual_seed(10 + k)
            for k in (0, 1)]
    for _ in range(n):
        for k in (0, 1):
            st[k], _ = step_fn(st[k], batch, gens[k])
    rels = [update_rel(torch, updaters, kept[k], st[k].params, solo[k])
            for k in (0, 1)]
    same0 = all(torch.equal(a, b) for k in (0, 1) for a, b in zip(
        updaters.tree_leaves(kept[k]), updaters.tree_leaves(inits[k].params)))
    caps = compile_metrics.compile_count - c0
    say(f"{what}: two states stepped alternately through one step_fn, "
        f"{n} steps each, against each one's solo eager run: relative L2 "
        f"of the change p_k - p_0 {rels[0]:.3e} and {rels[1]:.3e} (bar "
        f"{GRAPH_TRAIN_RTOL:g}); initial states unchanged: {same0}; "
        f"captures: {caps} (a state set each for two live states)")
    check(max(rels) <= GRAPH_TRAIN_RTOL,
          f"{what}: interleaved states differ from their solo runs {rels}")
    check(same0, f"{what}: a step wrote the caller's initial state")


def graph_decode(torch, gpt, entries, say) -> None:
    """GPT-2 small decoding: slot_decode's logits captured vs eager (8
    slots, bucket 1024, bf16 and fp32), then the engine's decode step
    and the 32-request burst with its entries captured and raw."""
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.runtime import compile_cache
    from deeplearning4j_tpu_torch.runtime import quantize as qz
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics
    from deeplearning4j_tpu_torch.serving.decode import (
        DecodeEngine, default_length_buckets)

    cfg = gen_config(gpt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = gpt.init_params(gen, cfg, device="cuda")
    rng = np.random.default_rng(11)
    T, C = cfg.max_len, gpt.PREFILL_CHUNK
    with torch.inference_mode():
        for c in (cfg, dataclasses.replace(cfg, compute_dtype="float32")):
            sp = gpt.serving_params(c, params)
            slots = gpt.init_slots(c, GEN_SLOTS, T, device="cuda")
            for s in range(GEN_SLOTS):
                toks = torch.from_numpy(rng.integers(
                    0, c.vocab_size, BURST_MAX).astype(np.int32)).cuda()
                for lo in range(0, BURST_MAX, C):
                    gpt.slot_prefill(c, sp, slots, toks[lo:lo + C], s, lo,
                                     C, 0.0, s)
            active = torch.ones(GEN_SLOTS, dtype=torch.bool, device="cuda")
            temps = torch.tensor([0.0, BURST_TEMP] * (GEN_SLOTS // 2),
                                 device="cuda")
            seeds = torch.arange(GEN_SLOTS, dtype=torch.int64,
                                 device="cuda")

            def fn(p, sl, a, t, sd, c=c):
                return gpt.slot_decode(c, p, sl, a, t, sd,
                                       return_logits=True)

            g = compile_cache.cached_graph(fn, label="slot_decode.logits",
                                           donate_argnums=(1,))
            entries.append(g)
            se = updaters.tree_map(torch.clone, slots)
            sc = updaters.tree_map(torch.clone, slots)
            worst, same = 0.0, 0
            for _ in range(GRAPH_DECODE_STEPS):
                _, te, le = fn(sp, se, active, temps, seeds)
                sc, tc, lc = g(sp, sc, active, temps, seeds)
                worst = max(worst, float((le - lc).abs().max()))
                same += int(torch.equal(te, tc))
            bar = GRAPH_DECODE_TOL[c.compute_dtype]
            say(f"slot_decode {c.compute_dtype}, {GEN_SLOTS} slots at "
                f"position {BURST_MAX}+ of bucket {T}: captured vs eager "
                f"logits max|diff| {worst:.3e} over {GRAPH_DECODE_STEPS} "
                f"steps (bar {bar:g}); tokens identical at {same}/"
                f"{GRAPH_DECODE_STEPS} steps")
            check(worst <= bar, f"slot_decode {c.compute_dtype}: captured "
                                f"logits differ from eager by {worst}")
            del slots, se, sc, g

    ladder = default_length_buckets(cfg.max_len)
    eng = DecodeEngine(cfg, params, n_slots=GEN_SLOTS, buckets=ladder,
                       device="cuda")
    entries.extend([eng._prefill, eng._decode])
    w = eng.warmup()
    say(f"DecodeEngine warm-up: {w['compiles']} captures for "
        f"{len(ladder)} buckets (prefill + step each) in "
        f"{w['warmup_ms']:.1f} ms")
    check(w["compiles"] == 2 * len(ladder), "decode warm-up captures != "
                                            "2 x buckets")
    reqs = burst_requests(cfg)
    c0 = compile_metrics.compile_count
    outs, wall, snap = serve_burst(torch, eng, reqs)
    with eager_engine():
        outs_e, wall_e, _ = serve_burst(torch, eng, reqs)
    n_tok = BURST * BURST_TOKENS
    same = sum(int(np.array_equal(a, b)) for a, b in zip(outs, outs_e))
    delta = compile_metrics.compile_count - c0
    say(f"the {BURST}-request burst (bf16): captured {wall:.3f} s = "
        f"{n_tok / wall:.1f} tokens/s, eager {wall_e:.3f} s = "
        f"{n_tok / wall_e:.1f} tokens/s ({wall_e / wall:.2f}x); "
        f"{same}/{BURST} requests token-identical; captures during the "
        f"captured burst: {delta}")
    check(delta == 0, f"decode: {delta} captures in the steady state")

    bucket = ladder[-1]
    placed = [eng.start(rng.integers(0, cfg.vocab_size, BURST_MAX),
                        max_tokens=BURST_TOKENS, temperature=BURST_TEMP,
                        seed=i)[:2] for i in range(GEN_SLOTS)]
    check(all(b == bucket for b, _ in placed), "decode slots off-bucket")

    eng.advance(bucket)             # takes the joins' slot vectors in
    b0 = eng._decode.copied_bytes
    for _ in range(5):
        eng.advance(bucket)
    per_step = (eng._decode.copied_bytes - b0) / 5
    say(f"bytes copied into the graphs' buffers per steady decode step: "
        f"{per_step:.0f} (the served weights, {qz.tree_bytes(eng.current_params())} "
        f"bytes, were copied once, at the warm-up)")
    check(per_step == 0, f"decode: a steady step copies {per_step} bytes")

    def eager_step():
        with eager_engine():
            eng.advance(bucket)

    graph_times(torch, f"GPT-2 small decode step, {GEN_SLOTS} slots in "
                       f"bucket {bucket}",
                {"eager": eager_step,
                 "captured": lambda: eng.advance(bucket)},
                GRAPH_TIMED["decode"], 3, say)
    for b, s in placed:
        eng.release(b, s)
    del eng
    inference_weights(torch, gpt, cfg, params, bucket, entries, rng, say)


def inference_weights(torch, gpt, cfg, params, bucket, entries, rng,
                      say) -> None:
    """The captured decode step with its served weights made under
    ``inference_mode``, as the engine's first design made them: an
    inference tensor has no version counter, so the engine copies it
    into the graph's buffers at every step.  Prints what that costs a
    step beside the main engine's numbers above."""
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine

    with torch.inference_mode():
        tree = gpt.serving_params(cfg, params)
    eng = DecodeEngine(cfg, tree, n_slots=GEN_SLOTS, buckets=(bucket,),
                       device="cuda")
    entries.extend([eng._prefill, eng._decode])
    eng.warmup()
    for i in range(GEN_SLOTS):
        eng.start(rng.integers(0, cfg.vocab_size, BURST_MAX),
                  max_tokens=BURST_TOKENS, temperature=BURST_TEMP, seed=i)
    eng.advance(bucket)
    b0 = eng._decode.copied_bytes
    for _ in range(5):
        eng.advance(bucket)
    per_step = (eng._decode.copied_bytes - b0) / 5
    h = host_ms(torch, lambda: eng.advance(bucket), GRAPH_TIMED["decode"])
    d, k = device_ms(torch, lambda: eng.advance(bucket), 3)
    dev = ("device not measured" if d is None else
           f"device {d:.3f} ms in {k:.0f} kernels = {d / h:.1%} busy")
    say(f"the same captured decode step with its served weights made under "
        f"inference_mode (no version counter): {per_step:.0f} bytes copied "
        f"in a step; host {h:.3f} ms, {dev}")
    del eng


def graph_embeddings(torch, t8, entries, say) -> None:
    """One word2vec epoch and one GloVe epoch on text8, warm (pairs and
    graphs ready), from the same tables and draws: captured vs eager."""
    from deeplearning4j_tpu_torch.nlp import glove as tglove
    from deeplearning4j_tpu_torch.nlp import word2vec as tw2v
    from deeplearning4j_tpu_torch.nlp.glove import (Glove, GloveConfig,
                                                    count_cooccurrences)
    from deeplearning4j_tpu_torch.nlp.vocab import build_vocab
    from deeplearning4j_tpu_torch.runtime import compile_cache
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    cfg = tw2v.Word2VecConfig(min_word_frequency=5, epochs=1, **W2V_CONFIG)
    w2v = tw2v.Word2Vec(t8, cfg, device="cuda")
    w2v.fit()                               # pairs, slabs and captures
    entries.append(compile_cache.cached_graph(
        tw2v._pair_chunk, key="word2vec.pair_chunk"))
    init = (w2v.syn0, w2v.syn1, w2v.syn1neg)
    c0 = compile_metrics.compile_count
    tabs, sec, busy = {}, {}, {}
    for how in ("captured", "eager"):
        ctx = eager_engine() if how == "eager" else contextlib.nullcontext()
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w2v.fit(initial_weights=init)
            torch.cuda.synchronize()
            sec[how] = time.perf_counter() - t0
            tabs[how] = (w2v.syn0, w2v.syn1, w2v.syn1neg)
            busy[how] = busy_share(torch, lambda: w2v.fit(
                initial_weights=init))
    delta = compile_metrics.compile_count - c0
    err, rel = rel_diff(torch, tabs["captured"], tabs["eager"])
    words = w2v._n_positions
    say(f"word2vec text8 epoch ({w2v.chunks} chunks), captured vs eager: "
        f"tables max|diff| {err:.3e}, relative L2 {rel:.3e} (bar "
        f"{GRAPH_EMBED_RTOL:g}); captured {sec['captured']:.3f} s = "
        f"{words / sec['captured']:.1f} words/s, eager {sec['eager']:.3f} "
        f"s = {words / sec['eager']:.1f} words/s; profiled epoch device "
        f"busy captured {busy['captured'][0]:.1f} of "
        f"{busy['captured'][1]:.1f} ms ({busy['captured'][0] / busy['captured'][1]:.1%}), "
        f"eager {busy['eager'][0]:.1f} of {busy['eager'][1]:.1f} ms "
        f"({busy['eager'][0] / busy['eager'][1]:.1%}); captures over the "
        f"warm epochs: {delta}")
    check(rel <= GRAPH_EMBED_RTOL, f"word2vec: captured epoch differs from "
                                   f"eager by {rel}")
    check(delta == 0, f"word2vec: {delta} captures in the steady state")

    gcfg = GloveConfig(epochs=1)
    g = Glove(t8, gcfg, device="cuda")
    g.cache = build_vocab(t8, g.tokenizer, gcfg.min_word_frequency)
    co = count_cooccurrences(t8, g.tokenizer, g.cache, gcfg.window,
                             gcfg.symmetric)
    g.fit(cooccurrences=co)                 # the capture
    entries.append(compile_cache.cached_graph(
        tglove._glove_chunk, key="glove.chunk"))
    c0 = compile_metrics.compile_count
    states, sec, busy = {}, {}, {}
    for how in ("captured", "eager"):
        ctx = eager_engine() if how == "eager" else contextlib.nullcontext()
        one = Glove(t8, gcfg, cache=g.cache, device="cuda")
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one.fit(initial_weights=g.state, cooccurrences=co)
            torch.cuda.synchronize()
            sec[how] = time.perf_counter() - t0
            states[how] = one.state
            busy[how] = busy_share(torch, lambda: Glove(
                t8, gcfg, cache=g.cache, device="cuda").fit(
                    initial_weights=g.state, cooccurrences=co))
    delta = compile_metrics.compile_count - c0
    err, rel = rel_diff(torch, states["captured"], states["eager"])
    P = co[0].size
    say(f"GloVe text8 epoch ({one.chunks} chunks), captured vs eager: state "
        f"max|diff| {err:.3e}, relative L2 {rel:.3e} (bar "
        f"{GRAPH_EMBED_RTOL:g}); captured {sec['captured']:.3f} s = "
        f"{P / sec['captured']:.1f} triples/s, eager {sec['eager']:.3f} s = "
        f"{P / sec['eager']:.1f} triples/s; profiled epoch device busy "
        f"captured {busy['captured'][0]:.1f} of {busy['captured'][1]:.1f} "
        f"ms ({busy['captured'][0] / busy['captured'][1]:.1%}), eager "
        f"{busy['eager'][0]:.1f} of {busy['eager'][1]:.1f} ms "
        f"({busy['eager'][0] / busy['eager'][1]:.1%}); captures over the "
        f"warm epochs: {delta}")
    check(rel <= GRAPH_EMBED_RTOL, f"GloVe: captured epoch differs from "
                                   f"eager by {rel}")
    check(delta == 0, f"GloVe: {delta} captures in the steady state")


def graph_phase(torch, ln, t8, card: str) -> None:
    """Phase 11 (see the module docstring)."""
    from deeplearning4j_tpu_torch.models import bert, gpt
    from deeplearning4j_tpu_torch.runtime import compile_cache
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    def say(msg):
        print(f"  {msg} [{card}]")

    compile_cache.clear()
    compile_metrics.reset()
    entries = []
    t0 = time.perf_counter()
    graph_lenet(torch, ln, entries, say)
    t1 = time.perf_counter()
    bcfg = bert.bert_base()
    graph_train(torch, bert, bcfg,
                bert.synthetic_batch(0, bcfg, 32, 128, device="cuda"),
                "BERT-base MLM B=32 T=128", entries, say, interleave=True)
    gcfg = gpt.gpt_config()
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, gcfg.vocab_size, (8, 1024)).astype(np.int32)).cuda()
    graph_train(torch, gpt, gcfg, ids, "GPT-2 small B=8 T=1024 (remat)",
                entries, say)
    t2 = time.perf_counter()
    graph_decode(torch, gpt, entries, say)
    t3 = time.perf_counter()
    graph_embeddings(torch, t8, entries, say)
    t4 = time.perf_counter()
    snap = compile_metrics.snapshot()
    traces = snap["traces"]
    held = {}
    for e in {id(e): e for e in entries}.values():
        if e.signatures():
            held[e.label] = held.get(e.label, 0) + e.signatures()
    say(f"captures per label {traces}; signatures the entries hold {held}; "
        f"{snap['compile_count']} captures took {snap['compile_ms']} ms "
        f"(warm-up runs, capture and first replay); "
        f"{snap['cached_dispatches']} replays")
    check(traces == held, "captures per label != signatures held")
    say(f"phase 11 wall: LeNet {t1 - t0:.1f} s, training {t2 - t1:.1f} s, "
        f"decoding {t3 - t2:.1f} s, embeddings {t4 - t3:.1f} s")


# ---------------------------------------------------------------------------
# phase 12: self-healing training, checkpoints and run telemetry
# ---------------------------------------------------------------------------

#: phase 12's LeNet run: data/mnist at B=128 (16 batches an epoch), the
#: poisoned batch (its first read only), the step the injected detector
#: fires at (in epoch 1, after the step-24 snapshot), the bounded slice
#: and the preemption request
RF_EPOCHS, RF_EVERY = 3, 8
RF_POISON_BATCH, RF_FIRE_CALL, RF_SLICE, RF_PREEMPT_AT = 5, 30, 20, 10
#: GPT-2 small: steps before the snapshot, steps dispatched behind it,
#: steps timed with no snapshot in flight
GPT_SNAP_AT, GPT_BEHIND, GPT_TIMED = 2, 2, 3


class PoisonOnce:
    """A batch whose first read comes back with a NaN (a transient
    fault: a flaky read), every later read clean.  Shared by a bounded
    slice and its resume, it poisons the same step an uninterrupted run
    does (its first visit, in epoch 0)."""

    def __init__(self, ds):
        self._ds = ds
        self.labels = ds.labels
        self.reads = 0

    @property
    def features(self):
        self.reads += 1
        if self.reads > 1:
            return self._ds.features
        x = self._ds.features.clone()
        x.view(-1)[0] = float("nan")
        return x


def fire_once_detector(at: int):
    """A loss-spike detector that reports one sustained anomaly at its
    ``at``-th observation (shared by a slice and its resume, it fires at
    the same step as in an uninterrupted run)."""
    from deeplearning4j_tpu_torch.runtime.resilience import LossSpikeDetector

    class FireOnce(LossSpikeDetector):
        def __init__(self):
            super().__init__()
            self.calls = 0

        def observe(self, loss):
            self.calls += 1
            return self.calls == at

    return FireOnce()


def rf_leaves(tree):
    from deeplearning4j_tpu_torch.runtime.checkpoint import \
        _flatten_with_paths

    return _flatten_with_paths(tree)


def resilient_lenet(torch, ln, tmp, say):
    """Part (a): ResilientFit over LeNet-MNIST (see the module
    docstring).  Returns the telemetry tracer of the run."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
    from deeplearning4j_tpu_torch.runtime import resilience, telemetry
    from deeplearning4j_tpu_torch.runtime.metrics import (checkpoint_metrics,
                                                          compile_metrics,
                                                          resilience_metrics)
    from deeplearning4j_tpu_torch.runtime.resilience import (
        PreemptionGuard, ResilienceConfig, ResilientFit)

    train = mnist_split(True)
    clean = [DataSet(torch.as_tensor(b.features).cuda(),
                     torch.as_tensor(b.labels).cuda())
             for b in train.batch_by(LENET_B)]
    steps = RF_EPOCHS * len(clean)
    params0 = ln.lenet(device="cpu").params

    def data():
        return [PoisonOnce(b) if i == RF_POISON_BATCH else b
                for i, b in enumerate(clean)]

    def run(name, batches, detector, **kw):
        net = lenet_net(ln, "bfloat16", params0, "cuda")
        drv = ResilientFit(net, ResilienceConfig(
            checkpoint_dir=os.path.join(tmp, name),
            checkpoint_every=RF_EVERY, max_to_keep=10, **kw),
            detector=detector)
        resilience_metrics.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drv.fit(batches, num_epochs=RF_EPOCHS, seed=5)
        torch.cuda.synchronize()
        return net, drv, time.perf_counter() - t0, \
            resilience_metrics.snapshot()

    # warm-up: the train step's capture and the restore check's
    warm = lenet_net(ln, "bfloat16", params0, "cuda")
    warm.fit_backprop(clean[0])
    check(resilience.compiled_all_finite(warm.params), "warm-up params")
    del warm
    c0 = compile_metrics.compile_count
    tracer = telemetry.enable(run_id="chip-smoke-phase-12a")

    checkpoint_metrics.reset()
    full, fdrv, sec, snap = run("full", data(), fire_once_detector(
        RF_FIRE_CALL))
    ck = checkpoint_metrics.snapshot()
    finite = bool(torch.isfinite(full.params_flat()).all())
    say(f"LeNet bf16 ResilientFit, data/mnist B={LENET_B}, {RF_EPOCHS} "
        f"epochs ({steps} steps), async snapshots every {RF_EVERY}: "
        f"{sec:.3f} s (host clock, synchronized) for {fdrv.steps_run} steps "
        f"run ({fdrv.steps_run / sec:.1f} steps/s, each with its loss read "
        f"on the host); steps_skipped {snap.get('steps_skipped', 0)} (bar "
        f"1), rollbacks {fdrv.rollbacks} (bar 1), final params finite "
        f"{finite}; {ck['snapshots_committed']} snapshots committed, "
        f"{ck['bytes_written']} bytes, staging {ck['stage_ms']:.3f} ms "
        f"summed over {ck['saves_async']} async saves, writer "
        f"{ck['write_ms']:.3f} ms summed, latest write-behind lag "
        f"{ck['write_behind_lag_ms']:.3f} ms, backpressure waits "
        f"{ck['backpressure_waits']}")
    check(snap.get("steps_skipped", 0) == 1 and full.guard_skips == 1,
          f"LeNet ResilientFit: steps_skipped {snap}")
    check(fdrv.rollbacks == 1 and snap.get("rollbacks") == 1,
          f"LeNet ResilientFit: rollbacks {fdrv.rollbacks}")
    check(finite, "LeNet ResilientFit: non-finite params")

    # kill and resume: the slice and its resume share the poisoned batch
    # and the detector, as one process's run would
    batches, det = data(), fire_once_detector(RF_FIRE_CALL)
    _, sdrv, s1, _ = run("split", batches, det, max_steps=RF_SLICE)
    check(sdrv.steps_run == RF_SLICE and sdrv.manager.latest_step()
          == RF_SLICE, f"slice stopped at {sdrv.manager.latest_step()}")
    part, rdrv, s2, rsnap = run("split", batches, det, resume=True)
    same_params = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        rf_leaves(full.params), rf_leaves(part.params)))
    # the newest snapshot both runs committed: params and optimizer state
    last = max(set(fdrv.manager.all_steps())
               & set(rdrv.manager.all_steps()))
    _, ups = full._backprop_machinery()
    tpl = ([{k: v.clone() for k, v in p.items()} for p in full.params],
           [u.init(p) for u, p in zip(ups, full.params)])
    fa_, _ = fdrv.manager.restore(step=last, like=tpl)
    ra_, _ = rdrv.manager.restore(step=last, like=tpl)
    pairs = list(zip(rf_leaves(fa_), rf_leaves(ra_)))
    same_snap = all(pa == pb and torch.equal(a, b)
                    for (pa, a), (pb, b) in pairs)
    n_ustate = sum(1 for (p, _), _ in pairs if p.startswith("1/"))
    say(f"kill at step {RF_SLICE} ({s1:.3f} s) and resume ({s2:.3f} s, "
        f"{rdrv.steps_run} steps, rollbacks {rdrv.rollbacks}, "
        f"steps_skipped {rsnap.get('steps_skipped', 0)} in the resume): "
        f"final params torch.equal to the uninterrupted run {same_params}; "
        f"snapshot {last} leaf for leaf ({len(pairs)} leaves, {n_ustate} of "
        f"them momentum and AdaGrad state) {same_snap} (cuDNN "
        f"deterministic)")
    check(same_params and same_snap, "LeNet: resume != uninterrupted run")

    # preemption: a programmatic notice at a step boundary
    guard = PreemptionGuard()

    class Notice(IterationListener):
        def iteration_done(self, model, iteration, score):
            if iteration == RF_PREEMPT_AT:
                guard.request()

    checkpoint_metrics.reset()
    net = lenet_net(ln, "bfloat16", params0, "cuda")
    net.set_listeners([Notice()])
    pdrv = ResilientFit(net, ResilienceConfig(
        checkpoint_dir=os.path.join(tmp, "preempt"),
        checkpoint_every=RF_EVERY), preemption_guard=guard)
    pdrv.fit(data(), num_epochs=RF_EPOCHS, seed=5)
    ck = checkpoint_metrics.snapshot()
    say(f"preemption requested at step {RF_PREEMPT_AT}: preempted "
        f"{pdrv.preempted} after {pdrv.steps_run} steps, latest snapshot "
        f"{pdrv.manager.latest_step()}, final sync snapshots "
        f"{ck['preemption_snapshots']}, sync saves {ck['saves_sync']}")
    check(pdrv.preempted and pdrv.steps_run == RF_PREEMPT_AT + 1
          and pdrv.manager.latest_step() == RF_PREEMPT_AT + 1
          and ck["preemption_snapshots"] == 1 and ck["saves_sync"] == 1,
          "LeNet: preemption did not stop with one final snapshot")
    delta = compile_metrics.compile_count - c0
    say(f"captures after warm-up, across the rollback, the resume and "
        f"the preemption: {delta} (traces {compile_metrics.traces})")
    check(delta == 0, f"LeNet ResilientFit: {delta} captures after warm-up")
    telemetry.disable()
    return tracer


def gpt_snapshot(torch, fa, tmp, say) -> dict:
    """Part (b): an async snapshot of GPT-2 small's training state with
    steps dispatched behind it, restored into a fresh run that replays
    them (see the module docstring).  Returns B1-B3's launches."""
    from deeplearning4j_tpu_torch.models import gpt
    from deeplearning4j_tpu_torch.models.transformer import TrainState
    from deeplearning4j_tpu_torch.runtime.checkpoint import (
        AsyncCheckpointer, CheckpointManager)
    from deeplearning4j_tpu_torch.runtime.metrics import (checkpoint_metrics,
                                                          compile_metrics)
    from deeplearning4j_tpu_torch.runtime.resilience import fold

    cfg = gpt.gpt_config()
    check(cfg.remat and cfg.dropout > 0, "GPT-2 small: remat and dropout")
    B, T = 8, 1024
    rng = np.random.default_rng(12)
    n = GPT_SNAP_AT + GPT_BEHIND + GPT_TIMED
    ids = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T))
                            .astype(np.int32)).cuda() for _ in range(n)]
    init_fn, step_fn = gpt.make_train_step(cfg)
    gen = torch.Generator(device="cuda")

    def step(state, k):
        # the step's dropout stream is a function of (seed, step), as
        # ResilientFit derives it: a restored run redraws it exactly
        gen.manual_seed(fold(7, 0, k))
        return step_fn(state, ids[k], gen)

    def event_ms(fn):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    fa.reset_launches()
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    mgr = CheckpointManager(os.path.join(tmp, "gpt"), max_to_keep=2)
    ac = AsyncCheckpointer(mgr, max_in_flight=1)
    # the snapshots' pinned host buffers, before training
    t0 = time.perf_counter()
    pool_bytes = ac.reserve(state)
    reserve_ms = (time.perf_counter() - t0) * 1e3
    for k in range(GPT_SNAP_AT):
        state, _ = step(state, k)
    torch.cuda.synchronize()
    checkpoint_metrics.reset()
    t0 = time.perf_counter()
    handle = ac.save(GPT_SNAP_AT, state, meta={"seed": 7})
    stage_ms = (time.perf_counter() - t0) * 1e3
    behind = []
    for k in range(GPT_SNAP_AT, GPT_SNAP_AT + GPT_BEHIND):
        (state, _), ms = event_ms(lambda k=k: step(state, k))
        behind.append(ms)
    in_flight_at_end = not handle.done()
    ac.wait_until_finished()
    ck = checkpoint_metrics.snapshot()
    nbytes = sum(t.numel() * t.element_size() for _, t in rf_leaves(state)
                 if isinstance(t, torch.Tensor))
    ref = [(p, t.clone() if isinstance(t, torch.Tensor) else t)
           for p, t in rf_leaves(state)]
    # drop the uninterrupted run's aliases: the restored state then lands
    # in the engine's free state set (no new capture)
    state = None
    c0 = compile_metrics.compile_count
    tpl = init_fn(torch.Generator(device="cuda").manual_seed(99))
    restored, meta = mgr.restore(like=tpl)
    tpl = None
    check(restored.step == GPT_SNAP_AT and meta["step"] == GPT_SNAP_AT,
          f"GPT snapshot step {meta['step']}")
    for k in range(GPT_SNAP_AT, GPT_SNAP_AT + GPT_BEHIND):
        restored, _ = step(restored, k)
    torch.cuda.synchronize()
    got = rf_leaves(restored)
    equal = [p for (p, a), (q, b) in zip(got, ref)
             if p != q or not (torch.equal(a, b) if isinstance(a, torch.Tensor)
                               else a == b)]
    captures = compile_metrics.compile_count - c0
    free = []
    for k in range(GPT_SNAP_AT + GPT_BEHIND, n):
        (restored, _), ms = event_ms(lambda k=k: step(restored, k))
        free.append(ms)
    launches = fa.launch_counts()
    # a second snapshot: the pool's buffers again, no allocation
    allocs = ac.pool.allocations
    t0 = time.perf_counter()
    ac.save(n, restored, meta={"seed": 7})
    stage2_ms = (time.perf_counter() - t0) * 1e3
    ac.close()
    say(f"GPT-2 small B={B} T={T} (remat, dropout {cfg.dropout}, adamw) "
        f"training state: {nbytes} bytes ({len(ref)} leaves: fp32 params, "
        f"mu and nu, the count, the step) a snapshot; pinned pool "
        f"reserved before training: {pool_bytes} bytes in {reserve_ms:.3f} "
        f"ms; training thread's staging {stage_ms:.3f} ms (clones + copies "
        f"to the pool's pinned buffers queued); writer's commit "
        f"{ck['write_ms']:.3f} ms ({ck['bytes_written']} "
        f"bytes on disk, fsync'd, crc32'd), write-behind lag "
        f"{ck['write_behind_lag_ms']:.3f} ms; snapshot still in flight "
        f"after the {GPT_BEHIND} steps behind it: {in_flight_at_end}; a "
        f"second snapshot's staging {stage2_ms:.3f} ms; pinned buffers "
        f"allocated by the saves {ac.pool.allocations - allocs} after "
        f"the reserve")
    check(stage_ms <= 5 * stage2_ms,
          f"GPT-2 small: first staging {stage_ms:.3f} ms > 5 x the second "
          f"{stage2_ms:.3f} ms")
    say(f"GPT-2 small step ms (CUDA events) with the snapshot in flight "
        + " / ".join(f"{x:.3f}" for x in behind) + ", without "
        + " / ".join(f"{x:.3f}" for x in free))
    say(f"restored at step {GPT_SNAP_AT} into a fresh run, {GPT_BEHIND} "
        f"steps replayed with the same batches and dropout streams: state "
        f"after step {GPT_SNAP_AT + GPT_BEHIND} bit-identical to the "
        f"uninterrupted run's {not equal} ({len(ref)} leaves; differing "
        f"{equal[:4]}); captures across the restore {captures}; B1/B2/B3 "
        f"launches {launches}")
    check(not equal, f"GPT-2 small: restored run differs at {equal[:4]}")
    check(captures == 0, f"GPT-2 small: {captures} captures after restore")
    check(launches["launches"] > 0 and launches["launches_dkv"] > 0
          and launches["launches_dq"] > 0, "B1-B3 did not launch")
    return launches


def telemetry_report(tracer, tmp, say) -> None:
    """Part (c): the registry's snapshot and part (a)'s journal and
    Chrome trace, summarized."""
    from deeplearning4j_tpu_torch.runtime import telemetry

    snap = telemetry.registry.snapshot()
    journal = os.path.join(tmp, "phase12a.jsonl")
    trace = os.path.join(tmp, "phase12a.trace.json")
    tracer.export_journal(journal, snapshot=snap)
    tracer.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    summary = telemetry.summarize_journal(telemetry.read_journal(journal),
                                          top_k=3)
    tree = {"/".join(r["path"]): (r["count"], r["total_ms"])
            for r in summary["tree"] if r["depth"] <= 1}
    say(f"registry families {sorted(snap['counters'])}; peak_bytes_in_use "
        f"{snap['device_memory']['peak_bytes_in_use']}; checkpoint "
        f"{snap['counters']['checkpoint']}; resilience "
        f"{snap['counters']['resilience']}; compile count "
        f"{snap['counters']['compile']['compile_count']}")
    say(f"journal of part (a): {summary['n_spans']} spans, "
        f"{summary['n_events']} events {summary['events']}; span tree "
        f"(count, total ms) {tree}; Chrome trace {len(events)} events, "
        f"{os.path.getsize(trace)} bytes")
    check(len(snap["counters"]) == 9 and summary["n_spans"] > 0
          and "resilience.rollback" in summary["events"]
          and any(e.get("ph") == "X" for e in events),
          "phase 12: telemetry incomplete")
    peaks = snap["device_memory"]["peak_bytes_in_use"]
    check(all(v is not None and v > 0 for v in peaks.values()),
          f"peak_bytes_in_use not reported: {peaks}")


def resilience_phase(torch, fa, ln, card: str) -> dict:
    """Phase 12 (see the module docstring).  Returns B1-B3's launches."""
    import shutil
    import tempfile

    def say(msg):
        print(f"  {msg} [{card}]")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        tracer = resilient_lenet(torch, ln, tmp, say)
        t1 = time.perf_counter()
        launches = gpt_snapshot(torch, fa, tmp, say)
        t2 = time.perf_counter()
        telemetry_report(tracer, tmp, say)
        say(f"phase 12 wall: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
            f"{time.perf_counter() - t2:.1f} s")
        return launches
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 13: fit, the solvers, greedy pretraining, Hessian-free and the CLI
# ---------------------------------------------------------------------------

#: the device phase 13 runs on (a CPU rehearsal substitutes "cpu")
FIT_DEVICE = "cuda"
#: card vs CPU on the same activations, fp32 (tests/test_torch_lenet.py)
FIT_SCORE_RTOL = 1e-4
#: Hinton, Osindero & Teh (2006)'s MNIST deep belief net, and the CD-1
#: steps each RBM (or autoencoder) takes a batch
DBN_WIDTHS, DBN_ITERS = (784, 500, 500, 2000), 10
#: CG and L-BFGS iterations on the DBN's output layer, and the score
#: below which card and CPU are no longer compared (fp32's resolution of
#: a cross-entropy near 0)
DBN_SOLVER_ITERS, SOLVER_FLOOR = 30, 1e-3
#: Martens (2010)'s curves deep autoencoder, its training size, and the
#: Hessian-free outer iterations; the score must fall below this share
#: of its start (tests/test_hessian_free.py:130)
CURVES_WIDTHS = (784, 400, 200, 100, 50, 25, 6, 25, 50, 100, 200, 400, 784)
CURVES_N, HF_ITERS, HF_BAR = 20000, 5, 0.9


def mnist_flat(train: bool):
    """data/mnist flattened to [N, 784] and binarized at 30/255 (the
    reference's default, MnistDataFetcher.java)."""
    from deeplearning4j_tpu_torch.datasets.fetchers import MnistDataFetcher

    f = MnistDataFetcher(train=train, flatten=True, binarize=True)
    check(not f.synthetic, "data/mnist not found")
    f.fetch(f.total)
    return f.next()


class PhaseScores:
    """Every listener call of a fit, with the model that made it (the
    network in pretrain and backprop, an optimizer in finetune)."""

    def __init__(self, on_first_solver=None):
        self.rows = []
        self.on_first_solver = on_first_solver

    def iteration_done(self, model, iteration, score):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        solver = not isinstance(model, MultiLayerNetwork)
        if solver and self.on_first_solver is not None \
                and not any(s for s, _, _ in self.rows):
            self.on_first_solver()
        self.rows.append((solver, iteration, score))

    def solver_scores(self):
        return [v for s, _, v in self.rows if s]

    def layer_runs(self):
        """The network-made scores split where the iteration restarts at
        0 (pretrain: a run a layer)."""
        runs = []
        for s, it, v in self.rows:
            if s:
                continue
            if it == 0:
                runs.append([])
            runs[-1].append(v)
        return runs


def sync_share(torch, opt, params, n: int) -> float:
    """The share of a gradient-descent solver iteration spent in its host
    read: ``n`` replays of its captured step with the read after each,
    against ``n`` with one read at the end."""
    ustate = opt.updater.init(params)
    it = torch.zeros((), dtype=torch.int32, device=FIT_DEVICE)
    p, u, it, *_ = opt._step(params, ustate, it, None)

    def run(read_each: bool) -> float:
        nonlocal p, u, it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            p, u, it, score, gnorm, _ = opt._step(p, u, it, None)
            if read_each:
                opt._read(score, gnorm)
        opt._read(score, gnorm)
        return (time.perf_counter() - t0) * 1e3 / n

    # alternate the two, 5 runs each: the host clock on a shared host
    # moves more than the read costs
    runs = {True: [], False: []}
    for _ in range(5):
        for read_each in (True, False):
            runs[read_each].append(run(read_each))
    with_read = float(np.median(runs[True]))
    without = float(np.median(runs[False]))
    return with_read, without, 1.0 - without / with_read


def lenet_fit(torch, ln, tmp, say) -> None:
    """Part (1): LeNet-MNIST through ``fit``; part (2):
    ``prepare_resilient_fit`` -> ``ResilientFit`` on the same conf."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics
    from deeplearning4j_tpu_torch.runtime.resilience import (ResilienceConfig,
                                                             ResilientFit)

    train, test = mnist_split(True), mnist_split(False)
    batches = train.batch_by(LENET_B)
    params0 = ln.lenet(device="cpu").params
    merged = DataSet.merge(batches)
    net = lenet_net(ln, "float32", params0, FIT_DEVICE)
    x = torch.as_tensor(merged.features).to(FIT_DEVICE)
    labels = torch.as_tensor(merged.labels).to(FIT_DEVICE)
    with torch.no_grad():
        h = net.hidden_activations(net.params, x)
    rec = PhaseScores()
    net.set_listeners([rec])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(batches, num_epochs=2)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ev = net.evaluate(test)
    ft = rec.solver_scores()
    n_ft = net.conf.confs[-1].num_iterations
    say(f"LeNet fp32 fit on data/mnist, B={LENET_B}, 2 epochs: finetune "
        f"(GD) ran {len(ft)} of {n_ft} iterations before a termination, "
        f"score {ft[0]:.6f} -> {ft[-1]:.6f}; then {len(rec.rows) - len(ft)} "
        f"backprop steps; {sec:.3f} s (host clock, synchronized); test "
        f"accuracy {ev.accuracy():.4f} (bar {LENET_MIN_ACC})")
    check(ft[-1] < ft[0], "LeNet fit: finetune's score did not fall")
    check(ev.accuracy() >= LENET_MIN_ACC,
          f"LeNet fit: test accuracy {ev.accuracy()}")

    # the card's finetune against the port's CPU finetune, same params
    # and the same (card) activations
    cpu = lenet_net(ln, "float32", params0, "cpu")
    _, cpu_opt = cpu.finetune_output(h.cpu(), labels.cpu())
    ref = cpu_opt.score_history
    worst = max(abs(a - b) / abs(b) for a, b in zip(ft, ref))
    say(f"finetune scores, card vs CPU on the card's activations: "
        f"{len(ft)} vs {len(ref)} iterations, worst relative difference "
        f"{worst:.3e} (bar {FIT_SCORE_RTOL})")
    check(len(ft) == len(ref) and worst <= FIT_SCORE_RTOL,
          f"LeNet finetune card vs CPU: {worst}")
    fresh = lenet_net(ln, "float32", params0, FIT_DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, opt = fresh.finetune_output(h, labels)
    torch.cuda.synchronize()
    ms_it = (time.perf_counter() - t0) * 1e3 / len(opt.score_history)
    with_read, without, share = sync_share(
        torch, opt, fresh.params[-1], 200)
    say(f"GD finetune iteration ([{h.shape[0]}, {h.shape[1]}] x "
        f"[{h.shape[1]}, 10] objective): {ms_it:.4f} ms in a run (the "
        f"first capture included); {with_read:.4f} ms a replay with the "
        f"host read, {without:.4f} ms without (medians of 5 alternating "
        f"runs of 200): the read's share {100 * share:.1f}%")

    # (2) prepare_resilient_fit -> ResilientFit
    a = lenet_net(ln, "float32", params0, FIT_DEVICE)
    a.finetune(merged)
    b = lenet_net(ln, "float32", params0, FIT_DEVICE)
    batch_list, mesh = b.prepare_resilient_fit(batches)
    same = all(torch.equal(p[k], q[k]) for p, q in zip(a.params, b.params)
               for k in p)
    c0 = compile_metrics.compile_count
    drv = ResilientFit(b, ResilienceConfig(
        checkpoint_dir=os.path.join(tmp, "rf"), checkpoint_every=8))
    drv.fit(batch_list, num_epochs=1, seed=3)
    torch.cuda.synchronize()
    captures = compile_metrics.compile_count - c0
    ev = b.evaluate(test)
    say(f"prepare_resilient_fit: mesh {mesh}, params torch.equal to "
        f"finetune's inside fit {same}; ResilientFit {drv.steps_run} steps, "
        f"{len(drv.manager.all_steps())} snapshots, captures after warm-up "
        f"{captures}, test accuracy {ev.accuracy():.4f}")
    check(mesh is None and same, "prepare_resilient_fit != finetune")
    check(captures == 0, f"ResilientFit after prepare: {captures} captures")


def dbn_conf(kind: str, algo: str = "gradient_descent"):
    """784-500-500-2000 with binary RBMs (CD-1) or denoising autoencoders
    (corruption 0.25, lr 0.01), a 10-way softmax, fp32 products."""
    from deeplearning4j_tpu_torch.nn.conf import (LayerKind,
                                                  NeuralNetConfiguration,
                                                  OptimizationAlgorithm)

    layer = {"rbm": {"kind": LayerKind.RBM, "k": 1},
             # the reconstruction cross-entropy sums over the inputs
             # (up to 784 a row): at lr 0.1 the 500- and 2000-wide layers
             # diverge, so the autoencoders take 0.01
             "autoencoder": {"kind": LayerKind.AUTOENCODER,
                             "corruption_level": 0.25, "lr": 0.01,
                             "activation": "sigmoid"}}[kind]
    b = (NeuralNetConfiguration.builder()
         .n_in(DBN_WIDTHS[0]).lr(0.1).momentum(0.5)
         .num_iterations(DBN_ITERS).use_adagrad(False)
         .activation("sigmoid").compute_dtype("float32")
         .list(len(DBN_WIDTHS)).hidden_layer_sizes(*DBN_WIDTHS[1:]))
    for i in range(len(DBN_WIDTHS) - 1):
        b = b.override(i, **layer)
    return (b.override(len(DBN_WIDTHS) - 1, kind=LayerKind.OUTPUT, n_out=10,
                       activation="softmax", loss_function="mcxent",
                       optimization_algo=OptimizationAlgorithm(algo),
                       num_iterations=(100 if algo == "gradient_descent"
                                       else DBN_SOLVER_ITERS))
            .pretrain(True).backward(True).build())


def falls(run) -> bool:
    """The mean of a run's last 10 scores is below that of its first 10."""
    return float(np.mean(run[-10:])) < float(np.mean(run[:10]))


def pretrain_step_ms(torch, net, i: int, batch) -> float:
    """Device ms of one captured CD-1 (or AE) step of layer ``i`` on a
    batch (CUDA events over replays of the engine's shared step)."""
    from deeplearning4j_tpu_torch.runtime import compile_cache

    step, updater = compile_cache.get_or_build(
        ("multilayer_pretrain_gd", i, net.conf.to_json()),
        lambda: check(False, "pretrain step not built"))
    with torch.no_grad():
        x = net.feed_forward(net.params, batch, upto=i)[-1]
    p, u = net.params[i], updater.init(net.params[i])
    it = torch.zeros((), dtype=torch.int32, device=FIT_DEVICE)
    gen = torch.Generator(device=FIT_DEVICE).manual_seed(0)
    state = [p, u, it]

    def once():
        state[0], state[1], state[2], _, _ = step(*state[:2], x, gen,
                                                  state[2])
    return time_ms(torch, once, iters=50)


def dbn(torch, say):
    """Part (3): the DBN and the AE stack; part (4): CG and L-BFGS on the
    DBN's output layer."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    train, test = mnist_flat(True), mnist_flat(False)
    batches = [DataSet(torch.as_tensor(b.features).to(FIT_DEVICE),
                       torch.as_tensor(b.labels).to(FIT_DEVICE))
               for b in train.batch_by(LENET_B)]
    init = MultiLayerNetwork(dbn_conf("rbm"), device="cpu").init(seed=11)
    params0 = init.params

    def fresh(kind, algo="gradient_descent", params=params0):
        return MultiLayerNetwork(dbn_conf(kind, algo), device=FIT_DEVICE,
                                 params=[{k: v.to(FIT_DEVICE)
                                          for k, v in p.items()}
                                         for p in params])

    net = fresh("rbm")
    snap = {}
    rec = PhaseScores(on_first_solver=lambda: snap.setdefault(
        "params", [{k: v.clone() for k, v in p.items()}
                   for p in net.params]))
    net.set_listeners([rec])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(batches, num_epochs=1)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ev = net.evaluate(test)
    runs = rec.layer_runs()
    steps_ms = [pretrain_step_ms(torch, net, i, batches[0].features)
                for i in range(len(DBN_WIDTHS) - 1)]
    say(f"DBN {'-'.join(map(str, DBN_WIDTHS))} (binary RBMs, CD-1, "
        f"{DBN_ITERS} steps a batch, B={LENET_B}) fit: pretrain, finetune "
        f"({len(rec.solver_scores())} GD iterations), 1 backprop epoch in "
        f"{sec:.3f} s (host clock, a score read a pretrain step); "
        f"reconstruction error first/last 10 steps a layer "
        + ", ".join(f"{np.mean(r[:10]):.4f}/{np.mean(r[-10:]):.4f}"
                    for r in runs[:3])
        + f"; CD-1 step device ms a layer "
        + " / ".join(f"{m:.4f}" for m in steps_ms)
        + f"; test accuracy {ev.accuracy():.4f}")
    check(len(runs) >= 3 and all(falls(r) for r in runs[:3]),
          "DBN: an RBM's reconstruction error did not fall")
    again = fresh("rbm")
    again.pretrain(batches)
    same = all(torch.equal(p[k], q[k]) for p, q in
               zip(snap["params"], again.params) for k in p)
    say(f"a second pretrain with the same seed: params torch.equal {same}")
    check(same, "DBN: same-seed pretrains differ")

    ae = fresh("autoencoder")
    arec = PhaseScores()
    ae.set_listeners([arec])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ae.pretrain(batches)
    torch.cuda.synchronize()
    aruns = arec.layer_runs()
    say(f"the same widths with denoising autoencoders (corruption 0.25): "
        f"pretrain {time.perf_counter() - t0:.3f} s, reconstruction loss "
        f"first/last 10 steps a layer "
        + ", ".join(f"{np.mean(r[:10]):.4f}/{np.mean(r[-10:]):.4f}"
                    for r in aruns))
    check(len(aruns) == 3 and all(falls(r) for r in aruns),
          "AE stack: a layer's reconstruction loss did not fall")

    # (4) CG and L-BFGS on the output layer, from where fit's finetune
    # started: the pretrained stack's activations of the merged rows
    merged = DataSet.merge(batches)
    pre = snap["params"]
    with torch.no_grad():
        h = net.hidden_activations(pre, merged.features)
    for algo in ("conjugate_gradient", "lbfgs"):
        card = fresh("rbm", algo, pre)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, opt = card.finetune_output(h, merged.labels)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        cpu = MultiLayerNetwork(dbn_conf("rbm", algo), device="cpu",
                                params=[{k: v.cpu() for k, v in p.items()}
                                        for p in pre])
        _, ref = cpu.finetune_output(h.cpu(), merged.labels.cpu())
        s, r = opt.score_history, ref.score_history
        # held where fp32 resolves the loss: up to the CPU run's first
        # score below SOLVER_FLOOR (L-BFGS drives this separable
        # objective to ~0, where the two devices' roundings decide)
        n = next((i for i, b in enumerate(r) if b < SOLVER_FLOOR), len(r))
        worst = max(abs(a - b) / abs(b) for a, b in zip(s[:n], r[:n]))
        rises = sum(b > a for a, b in zip(s, s[1:]))
        again = fresh("rbm", algo, pre)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again.finetune_output(h, merged.labels)
        torch.cuda.synchronize()
        warm = (time.perf_counter() - t0) * 1e3
        say(f"{algo} on the DBN's output layer ([{h.shape[0]}, "
            f"{h.shape[1]}] x [{h.shape[1]}, 10]), {len(s)} iterations: "
            f"score {s[0]:.6f} -> {s[-1]:.6f}, rises {rises}; trials per "
            f"iteration {opt.trials_history} (CPU "
            f"{'same' if opt.trials_history == ref.trials_history else ref.trials_history}); "
            f"card vs CPU over the {n} iterations before the CPU score "
            f"falls below {SOLVER_FLOOR}: worst relative difference "
            f"{worst:.3e} (bar {FIT_SCORE_RTOL}), trials "
            f"{'equal' if opt.trials_history[:n] == ref.trials_history[:n] else 'differ'}; "
            f"scores a tenth of the way "
            + " ".join(f"{a:.6g}/{b:.6g}" for a, b in
                       list(zip(s, r))[::max(1, len(s) // 10)])
            + f"; {ms / len(s):.3f} ms an iteration with "
            f"the captures, {warm / len(s):.3f} ms in a second run's "
            f"(a host read a trial and an iteration)")
        check(rises == 0, f"{algo}: the score rose")
        check(len(s) == len(r) and n >= 8 and worst <= FIT_SCORE_RTOL
              and opt.trials_history[:n] == ref.trials_history[:n],
              f"{algo}: card vs CPU {worst}, trials {opt.trials_history} "
              f"vs {ref.trials_history}")


def curves_conf():
    """The curves autoencoder with Martens (2010)'s objective for it:
    logistic outputs under cross-entropy (the fused sigmoid/xent pair),
    and each layer's weights drawn from N(0, 9 / fan_in).  Under mse
    (the reference's small test conf) the reference's HF, damping 1 at
    the start and CG stopping at r'r < 1e-10, takes this depth only to
    ~0.91 of its start in 5 iterations (CPU rehearsal, n=1000): mse's
    1/784 scale leaves CG 2-3 iterations an outer one.  Martens' sparse
    init (variance 15 / fan_in) finds no improving CG iterate in its
    first two iterations here."""
    from deeplearning4j_tpu_torch.nn.conf import (LayerKind,
                                                  NeuralNetConfiguration,
                                                  OptimizationAlgorithm,
                                                  WeightInit)

    b = (NeuralNetConfiguration.builder()
         .n_in(CURVES_WIDTHS[0]).compute_dtype("float32")
         .num_iterations(HF_ITERS).activation("sigmoid")
         .optimization_algo(OptimizationAlgorithm.HESSIAN_FREE)
         .list(len(CURVES_WIDTHS) - 1)
         .hidden_layer_sizes(*CURVES_WIDTHS[1:-1]))
    for i, fan_in in enumerate(CURVES_WIDTHS[:-1]):
        b = b.override(i, weight_init=WeightInit.DISTRIBUTION,
                       dist=("normal", 0.0, 3.0 / fan_in ** 0.5))
    return (b.override(len(CURVES_WIDTHS) - 2, kind=LayerKind.OUTPUT,
                       n_out=CURVES_WIDTHS[-1], activation="sigmoid",
                       loss_function="xent")
            .pretrain(False).backward(False).build())


def hessian_free(torch, say) -> None:
    """Part (5): HF on the curves deep autoencoder."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.fetchers import CurvesDataFetcher
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    f = CurvesDataFetcher(n=CURVES_N, dim=CURVES_WIDTHS[0])
    data = DataSet(torch.from_numpy(f.features).to(FIT_DEVICE),
                   torch.from_numpy(f.labels).to(FIT_DEVICE))
    net = MultiLayerNetwork(curves_conf(), device=FIT_DEVICE).init(seed=13)
    n_params = net.num_params()
    start = net.score(data)
    seen = {}

    class Rec:
        rows = []

        def iteration_done(self, model, iteration, score):
            seen["hf"] = model
            torch.cuda.synchronize()
            self.rows.append((time.perf_counter(), score,
                              compile_metrics.compile_count))

    rec = Rec()
    net.set_listeners([rec])
    torch.cuda.synchronize()
    ms0 = compile_metrics.compile_ms
    t0 = time.perf_counter()
    net.finetune(data)
    capture_ms = compile_metrics.compile_ms - ms0
    hf = seen["hf"]
    times = [t0] + [t for t, _, _ in rec.rows]
    outer = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
    new_captures = rec.rows[-1][2] - rec.rows[0][2]
    params = net.params
    v = [{k: torch.randn_like(t) for k, t in p.items()} for p in params]
    lam = torch.tensor(1.0, device=FIT_DEVICE)
    mv_ms = time_ms(torch, lambda: hf._damped_mv(params, v, lam), iters=10)
    end = rec.rows[-1][1]
    say(f"Hessian-free, curves deep autoencoder "
        f"{'-'.join(map(str, CURVES_WIDTHS))} ({n_params} params, sigmoid, "
        f"xent) on CurvesDataFetcher(n={CURVES_N}): score {start:.6f} -> "
        f"{end:.6f} ({end / start:.3f} of the start, bar {HF_BAR}) in "
        f"{len(rec.rows)} outer iterations; ms an outer iteration "
        + " / ".join(f"{m:.1f}" for m in outer)
        + f"; CG iterations {hf.cg_iterations}; lambda "
        + " / ".join(f"{x:.4f}" for x in hf.lambda_history)
        + f" (the first holds the captures of value, value_and_grad and "
          f"the damped product: {capture_ms:.1f} ms); a damped GN product "
          f"{mv_ms:.3f} ms (CUDA events); new captures after the first "
          f"outer iteration {new_captures}")
    check(end < HF_BAR * start, f"HF: {end} not below {HF_BAR} x {start}")
    check(new_captures == 0, f"HF: {new_captures} captures as lambda adapts")


def cli_runs(torch, ln, tmp, say) -> None:
    """Part (6): the CLI in subprocesses, on the card by default."""
    conf = os.path.join(tmp, "lenet.json")
    with open(conf, "w") as fh:
        fh.write(ln.lenet_conf().to_json())
    model, ck = os.path.join(tmp, "m.bin"), os.path.join(tmp, "ck")
    preds = os.path.join(tmp, "preds.txt")
    env = dict(os.environ, PYTHONPATH=REPO)
    device = [] if FIT_DEVICE == "cuda" else ["--device", FIT_DEVICE]

    def run(*args, ok=True):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", *args,
             *device], cwd=REPO, env=env, capture_output=True, text=True,
            timeout=600)
        sec = time.perf_counter() - t0
        if ok:
            check(res.returncode == 0,
                  f"cli {args[0]} failed: {res.stdout[-2000:]}"
                  f"{res.stderr[-2000:]}")
        return res, sec

    train = ("train", "--input", "mnist2d", "--conf", conf, "--epochs", "1",
             "--batch", str(LENET_B), "--raw-pixels")
    r, s_train = run(*train, "--output", model)
    acc_train = [ln_ for ln_ in r.stdout.splitlines()
                 if "accuracy" in ln_]
    r, s_test = run("test", "--input", "mnist2d-test", "--model", model,
                    "--raw-pixels")
    acc_test = [ln_.strip() for ln_ in r.stdout.splitlines()
                if "Accuracy" in ln_]
    r, s_pred = run("predict", "--input", "mnist2d-test", "--model", model,
                    "--raw-pixels", "--output", preds)
    test = mnist_split(False)
    got = np.loadtxt(preds, dtype=np.int64)
    acc_pred = float(np.mean(got == np.asarray(test.labels).argmax(1)))
    r, s_ck = run(*train, "--output", model, "--checkpoint-dir", ck,
                  "--checkpoint-every", "8")
    acc_ck = [ln_ for ln_ in r.stdout.splitlines() if "accuracy" in ln_]
    refused, s_ref = run(*train, "--output", model, "--checkpoint-dir", ck,
                         "--checkpoint-every", "8", ok=False)
    r, s_res = run(*train, "--output", model, "--checkpoint-dir", ck,
                   "--checkpoint-every", "8", "--resume", "--epochs", "2")
    acc_res = [ln_ for ln_ in r.stdout.splitlines() if "accuracy" in ln_]
    say(f"cli train {s_train:.1f} s ({acc_train}), test {s_test:.1f} s "
        f"({acc_test}), predict {s_pred:.1f} s (accuracy of the written "
        f"classes {acc_pred:.4f}), train --checkpoint-dir {s_ck:.1f} s "
        f"({acc_ck}), the same again {s_ref:.1f} s (exit "
        f"{refused.returncode}: {refused.stderr.strip()[-160:]!r}), "
        f"--resume {s_res:.1f} s ({acc_res}); wall time of each "
        f"subprocess, host clock")
    check(acc_train and acc_test and acc_ck and acc_res,
          "cli: an accuracy line is missing")
    # one model, one test split: predict's classes score what test says
    check(abs(acc_pred - float(acc_test[0].split()[-1])) < 1e-4,
          f"cli predict's accuracy {acc_pred} != test's {acc_test}")
    err = refused.stderr.strip().splitlines()
    check(refused.returncode == 1 and len(err) == 1
          and "already holds snapshots" in err[0],
          f"cli: a populated --checkpoint-dir was not refused in one line: "
          f"{refused.stderr[-400:]}")


def fit_phase(torch, ln, card: str) -> None:
    """Phase 13 (see the module docstring)."""
    import shutil
    import tempfile

    def say(msg):
        print(f"  {msg} [{card}]")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.cuda.reset_peak_memory_stats()
    try:
        t = [time.perf_counter()]
        for part in (lambda: lenet_fit(torch, ln, tmp, say),
                     lambda: dbn(torch, say),
                     lambda: hessian_free(torch, say),
                     lambda: cli_runs(torch, ln, tmp, say)):
            part()
            t.append(time.perf_counter())
        wall = [b - a for a, b in zip(t, t[1:])]
        say(f"phase 13 wall: LeNet fit + resilient {wall[0]:.1f} s, DBN + "
            f"AE + CG/L-BFGS {wall[1]:.1f} s, HF {wall[2]:.1f} s, CLI "
            f"{wall[3]:.1f} s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MB")
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch import resolve_device
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    resolve_device("cuda")         # fp32 products in full fp32 (no TF32)

    print("phase 1: environment")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device "
          f"{torch.cuda.get_device_name(0)}")

    print("phase 2: build")
    t0 = time.perf_counter()
    seconds = cuda_build.build()
    print(f"  built {sorted(seconds)} in {time.perf_counter() - t0:.1f} s")
    for name in seconds:
        log = cuda_build.library_path(name).with_name(
            cuda_build.library_path(name).name + ".log")
        for kernel, line, spilled in ptxas_summary(log.read_text()):
            print(f"  ptxas {name}: {line}")
            check(spilled == 0 or "wgmma" not in kernel,
                  f"{kernel} spills {spilled} bytes")
    for D in (64, 128):
        dkv, dq = fa.bwd_wgmma_smem(D)
        print(f"  wgmma B1 at D={D}: {fa.fwd_wgmma_smem(D)} bytes of dynamic "
              f"shared memory a CTA")
        print(f"  wgmma B2/B3 at D={D}: {dkv} / {dq} bytes of dynamic "
              f"shared memory a CTA")

    print("phase 3: kernels against their plain twins")
    worst = kernel_phase(torch, fa)
    time_flash(torch, F, fa, B=1, T=128)      # serving's smallest bucket
    time_flash(torch, F, fa, B=32, T=128)
    ms, plain_ms, lib_ms, bound_ms, bound_by = time_flash(
        torch, F, fa, B=32, T=512)
    time_flash(torch, F, fa, B=8, T=1024, causal=True)   # GPT-2 small's
    worst_bwd = kernel_bwd_phase(torch, fa)
    bwd_rows = time_flash_bwd(torch, F, fa, B=32, T=128)
    time_flash_bwd(torch, F, fa, B=8, T=512)
    time_flash_bwd(torch, F, fa, B=8, T=1024, causal=True)

    print("phase 3c: B4 (word2vec chunk) and B5 (GloVe chunk) against their "
          "plain twins")
    from deeplearning4j_tpu_torch.nlp.glove import count_cooccurrences
    from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory
    from deeplearning4j_tpu_torch.nlp.vocab import build_huffman, build_vocab
    from deeplearning4j_tpu_torch.nlp.word2vec import (corpus_pairs,
                                                       prepare_train_tables)
    from deeplearning4j_tpu_torch.ops import fused_glove as fg
    from deeplearning4j_tpu_torch.ops import fused_word2vec as fw

    t0 = time.perf_counter()
    tok = DefaultTokenizerFactory()
    t8 = text8_sentences()
    cache5 = build_vocab(t8, tok, 5)
    build_huffman(cache5)
    t8_tables = prepare_train_tables(cache5, 100_000)
    t8_idx = [np.asarray([cache5.index_of(w) for w in tok(s)
                          if w in cache5], np.int32) for s in t8]
    t8_pairs = corpus_pairs([a for a in t8_idx if a.size], 5)[:2]
    cache1 = build_vocab(t8, tok, 1)
    t8_triples = count_cooccurrences(t8, tok, cache1) + (len(cache1),)
    zipf_vocab = zipf_cache()
    zipf_sents = zipf_sentences()
    print(f"  corpora: text8 {len(t8)} sentences, V={len(cache5)} at min "
          f"count 5, Huffman depth {t8_tables[0].shape[1]}; Zipf "
          f"{len(zipf_sents)} sentences of 30 words; set-up "
          f"{time.perf_counter() - t0:.1f} s")
    worst_w2v, w2v_rows = w2v_kernel_phase(
        torch, fw, w2v_case_chunks(torch, t8_tables, t8_pairs, zipf_vocab))
    worst_glove, glove_rows = glove_kernel_phase(
        torch, fg, glove_case_chunks(torch, t8_triples, zipf_vocab[1]))

    # each main path runs with the counts set to 0 just before it and
    # read just after; the line below sums them
    print("phase 4: BERT-base fill-mask serving")
    launches = {"launches": serving_phase(torch, fa), "launches_dkv": 0,
                "launches_dq": 0}
    print("phase 5: BERT-base MLM training")
    for name, n in bert_train_phase(torch, fa).items():
        launches[name] += n
    print("phase 6: GPT-2 small causal-LM training")
    for name, n in gpt_train_phase(torch, fa).items():
        launches[name] += n
    print("phase 7: word2vec and ParagraphVectors training")
    launches_w2v = word2vec_phase(torch, fw, t8, zipf_sents)
    print("phase 8: GloVe training")
    launches_glove = glove_phase(torch, fg, t8, zipf_sents)
    print("phase 9: LeNet-MNIST training, evaluation and serving")
    from deeplearning4j_tpu_torch.models import lenet as ln

    for mod in (fa, fw, fg):
        mod.reset_launches()
    lenet_phase(torch, ln, card)
    hand = {**fa.launch_counts(), "w2v": fw.launches, "glove": fg.launches}
    print(f"  hand-kernel launches during phase 9: {hand} (no TPU kernel "
          f"lies on LeNet's path)")
    check(not any(hand.values()), f"a hand kernel ran on LeNet's path: "
                                  f"{hand}")
    print("phase 10: GPT-2 small generation serving")
    launches["launches"] += generation_phase(torch, fa, card)
    print("phase 11: the compile engine's CUDA graphs against the raw "
          "functions")
    graph_phase(torch, ln, t8, card)
    print("phase 12: self-healing training, checkpoints and run telemetry")
    for name, n in resilience_phase(torch, fa, ln, card).items():
        launches[name] += n
    print("phase 13: fit, the solvers, greedy pretraining, Hessian-free and "
          "the CLI")
    for mod in (fa, fw, fg):
        mod.reset_launches()
    fit_phase(torch, ln, card)
    hand = {**fa.launch_counts(), "w2v": fw.launches, "glove": fg.launches}
    print(f"  hand-kernel launches during phase 13: {hand} (no TPU kernel "
          f"lies on fit's path)")
    check(not any(hand.values()), f"a hand kernel ran during phase 13: "
                                  f"{hand}")

    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_attention.py:83",
        "launches": launches["launches"],
        "max_abs_err": worst,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
    }]
    for kernel, name, line, counter in (
            ("dkv", "flash_attention_bwd_dkv", 188, "launches_dkv"),
            ("dq", "flash_attention_bwd_dq", 240, "launches_dq")):
        k_ms, k_plain, k_lib, k_bound, k_by = bwd_rows[kernel]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"deeplearning4j_tpu/ops/pallas_attention.py:{line}",
            "launches": launches[counter],
            "max_abs_err": worst_bwd[kernel],
            "ms": k_ms,
            "kernel_ms": k_ms,
            "plain_ms": k_plain,
            "bound_ms": k_bound,
            "bound_by": k_by,
            "library_ms": k_lib,
        })
    # B4 and B5 at the text8 main-path shape (the first timed case): the
    # device time summed over every phase of one call (B5: one chunk
    # step); no single PyTorch call computes either function, so no
    # library time
    for name, source, replaces, n, worst_err, rows, extra in (
            ("word2vec_chunk", "word2vec_chunk.cu",
             "deeplearning4j_tpu/ops/pallas_word2vec.py:91", launches_w2v,
             worst_w2v, w2v_rows, "call_ms"),
            ("glove_chunk", "glove_chunk.cu",
             "deeplearning4j_tpu/ops/pallas_glove.py:64", launches_glove,
             worst_glove, glove_rows, "old_composition_ms")):
        _, k_ms, k_plain, k_bound, k_by, k_extra = rows[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"deeplearning4j_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": n,
            "max_abs_err": worst_err,
            "ms": k_ms,
            "kernel_ms": k_ms,
            extra: k_extra,
            "plain_ms": k_plain,
            "bound_ms": k_bound,
            "bound_by": k_by,
            "library_ms": None,
        })
    check(launches_w2v > 0 and launches_glove > 0,
          "B4 or B5 never launched on the main paths")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
