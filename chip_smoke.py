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
    for _ in range(WARMUP_STEPS):
        state, loss = step_fn(state, batch, dropout_gen)
        losses.append(float(loss))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

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
