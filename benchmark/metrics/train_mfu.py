"""``train_mfu``: the training step's model FLOPs (``counts/flops.py``:
forward x 3, causal scores halved, no recomputation) times the steps of
the traced window, over the window and the card's bf16 peak, in %."""

from benchmark.counts.flops import PEAK_BF16_FLOPS


def read(m):
    if not m.get("steps") or "flops_per_step" not in m:
        return None
    return 100.0 * m["flops_per_step"] * m["steps"] / m["window_s"] \
        / PEAK_BF16_FLOPS
