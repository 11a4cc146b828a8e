"""``attn_roofline_share``: the least time of the attention the traced
steps need (``counts/flops.attention_bound_s`` a layer, forward and
backward, every layer, every step) over the device time of the kernels
named in ``kernel_names/attention/*.txt``, in %.  A traced run in which
no kernel matches is an error, never a share of 0."""

from pathlib import Path

from benchmark.counts.flops import attention_bound_s

NAMES = Path(__file__).resolve().parents[1] / "kernel_names" / "attention"


def patterns():
    out = []
    for f in sorted(NAMES.glob("*.txt")):
        out += [ln.strip() for ln in f.read_text().splitlines()
                if ln.strip() and not ln.startswith("#")]
    return out


def read(m):
    trace, s = m.get("trace"), m.get("shape")
    if trace is None or s is None or not m.get("steps"):
        return None
    spent = trace.kernel_seconds(patterns())
    if spent <= 0.0:
        raise RuntimeError("no attention kernel in the traced window: "
                           "kernel_names/attention/ names none that ran")
    bound, _ = attention_bound_s(s["batch"], s["heads"], s["seq"],
                                 s["head_dim"], s["causal"], s["key_mask"])
    return 100.0 * bound * s["layers"] * m["steps"] / spent
