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
   causal, ragged T, Tq != Tk, a fully masked row, fp32 and other head
   dims; then kernel, plain twin and F.scaled_dot_product_attention (a
   yardstick the port never calls) timed with CUDA events;
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
   width: 2 warm-up and 10 timed steps on a fixed batch.  Checks: the
   loss is finite and falls; B1, B2 and B3 each launch once per layer
   per step; one dropout-0 step's gradients through the kernels agree
   with the plain attention's (global relative L2 <= 3e-2), and for
   BERT an fp32-compute step at depth 2 within 1e-4.  Prints step ms,
   tokens/s, the model-FLOPs share of 989 TFLOP/s and a profile of one
   step (B1/B2/B3, forward and backward products, optimizer).

Phase 3 also holds the backward kernels B2 (dK/dV) and B3 (dQ) against
their plain twins on the same 14 cases (bf16 within 3e-2 of the case's
largest |grad|, fp32 5e-4), and times them (profiler, per kernel) beside
their twins, their bound and the backward of
F.scaled_dot_product_attention.

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
    """One line per kernel of an ``nvcc -Xptxas -v`` report: its name and
    template argument, registers, spill stores and loads."""
    import re

    out, kernel, spill = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = kernel = entry.group(1)
            spill = ""
            # <length><identifier> of the kernel, then its template int;
            # the digits before it may end a hex namespace hash
            for m in re.finditer(r"(\d+)(flash_\w+)", mangled):
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
            out.append(f"{kernel}: {regs.group(1) if regs else '?'} "
                       f"registers; {spill}")
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
]


def kernel_phase(torch, fa):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    worst = 0.0
    for name, B, NH, Tq, Tk, D, dt, causal, lens in KERNEL_CASES:
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
        o_ref, lse_ref = fa.flash_attention_fwd_plain(q4, k4, v4, bias,
                                                      causal)
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
        print(f"  kernel case {name!r}: B={B} NH={NH} Tq={Tq} Tk={Tk} "
              f"D={D} {dt} causal={causal}: max|o-o_plain|={err_o:.3e} "
              f"([B,T,NH,D] path {err_h:.3e}) max|lse-lse_plain|="
              f"{err_lse:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
        check(ok, f"flash kernel disagrees with its plain twin: {name}")
        worst = max(worst, err_o, err_h)
    return worst


def time_flash(torch, F, fa, B, T, NH=12, D=64):
    """Kernel, plain twin and SDPA at a serving shape (bf16, the all-live
    mask bias of the serving path)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    def rand():
        return torch.randn((B * NH, T, D), generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)

    q4, k4, v4 = rand(), rand(), rand()
    bias = torch.zeros((B, T), device="cuda", dtype=torch.float32)
    q_s, k_s, v_s = (x.view(B, NH, T, D) for x in (q4, k4, v4))
    with torch.inference_mode():
        ms = time_ms(torch, lambda: fa.flash_attention_fwd_cuda(
            q4, k4, v4, bias, False))
        plain_ms = time_ms(torch, lambda: fa.flash_attention_fwd_plain(
            q4, k4, v4, bias, False))
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q_s, k_s, v_s))
    bound_ms, bound_by = flash_bound(B, NH, T, T, D, 2, False)
    print(f"  flash fwd B={B} NH={NH} T={T} D={D} bf16: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})")
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
    """B2 and B3 on the 14 kernel cases, against the plain twins fed the same
    o and lse (B1's), through the [BH, T, D] entry point and through
    autograd on [B, T, NH, D]."""
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
            q4, k4, v4, bias, o, lse, do4, causal)
        dq_ref = fa.flash_attention_bwd_dq_plain(q4, k4, v4, bias, o, lse,
                                                 do4, causal)
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
        print(f"  backward case {name!r}: "
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
    print(f"  flash bwd B={B} NH={NH} T={T} D={D} bf16 causal={causal}: "
          f"B2 {rows['dkv'][0]:.4f} ms (bound {rows['dkv'][3]:.4f}, "
          f"{rows['dkv'][4]}), B3 {rows['dq'][0]:.4f} ms (bound "
          f"{rows['dq'][3]:.4f}, {rows['dq'][4]}) [profiler]; whole "
          f"backward call {call_ms:.4f} ms [events]; plain B2 "
          f"{dkv_plain:.4f} ms, plain B3 {dq_plain:.4f} ms; sdpa backward "
          f"{lib_ms:.4f} ms")
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
    for key, ms in sorted(step_k.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {ms:8.3f} ms  {key[:100]}")


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
          f"peak memory {peak_gb:.2f} GB")
    print(f"  {what}: launches over the {TIMED_STEPS} timed steps: {counts} "
          f"({cfg.n_layers} layers)")
    check(all(np.isfinite(losses)), f"{what}: non-finite loss {losses}")
    check(losses[-1] < losses[WARMUP_STEPS],
          f"{what}: loss did not fall over the timed steps: {losses}")
    for name, n in counts.items():
        check(n == cfg.n_layers * TIMED_STEPS,
              f"{what}: {name} = {n}, not {cfg.n_layers} per step")

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
    check(all(after[k] - before[k] == 2 for k in after),
          "fp32 step did not launch each kernel once per layer")
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
        for line in ptxas_summary(log.read_text()):
            print(f"  ptxas {name}: {line}")

    print("phase 3: kernels against their plain twins")
    worst = kernel_phase(torch, fa)
    time_flash(torch, F, fa, B=32, T=128)
    ms, plain_ms, lib_ms, bound_ms, bound_by = time_flash(
        torch, F, fa, B=32, T=512)
    worst_bwd = kernel_bwd_phase(torch, fa)
    bwd_rows = time_flash_bwd(torch, F, fa, B=32, T=128)
    time_flash_bwd(torch, F, fa, B=8, T=512)
    time_flash_bwd(torch, F, fa, B=8, T=1024, causal=True)

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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
