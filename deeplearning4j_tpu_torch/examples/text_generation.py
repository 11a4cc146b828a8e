"""Char-level language modeling + sampling with GPT (KV-cache decode).

The port of ``examples/text_generation.py``.  Trains ``gpt_tiny`` on a
repeated phrase (T=32, 300 steps; on the card each step is one CUDA
graph through the flash-attention kernels B1-B3), then samples 40
tokens at temperature 0.3 through the KV-cache decode path.  It prints
one line the reference does not: the first step's loss, before the
final one.

    python -m deeplearning4j_tpu_torch.examples.text_generation \\
        [--device cuda|cpu]
"""
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import examples
from deeplearning4j_tpu_torch.models import gpt

TEXT = "the quick brown fox jumps over the lazy dog. " * 64


def main(argv: Optional[List[str]] = None) -> int:
    args = examples.parser(__doc__).parse_args(argv)
    dev = examples.device(args)
    examples.reset_launches()

    chars = sorted(set(TEXT))
    stoi = {c: i for i, c in enumerate(chars)}
    ids = np.asarray([stoi[c] for c in TEXT], np.int32)

    cfg = gpt.gpt_tiny(vocab_size=len(chars), max_len=64)
    init_fn, step_fn = gpt.make_train_step(cfg, device=dev)
    state = init_fn(torch.Generator(device=dev).manual_seed(0))

    T = 32
    # one device: the reference's data mesh over every device is one
    # rank here, so the batch is every whole window of the text
    n = max((ids.size - 1) // T, 1)
    x = torch.from_numpy(ids[:n * T].reshape(n, T)).to(dev)
    for epoch in range(300):
        state, loss = step_fn(state, x)
        if epoch == 0:
            print(f"first LM loss: {float(loss):.3f}")
    print(f"final LM loss: {float(loss):.3f}")

    prompt = "the quick "
    p = torch.tensor([[stoi[c] for c in prompt]], dtype=torch.int32,
                     device=dev)
    out = gpt.generate(cfg, state.params, p, n_tokens=40, seed=7,
                       temperature=0.3)
    text = "".join(chars[int(t)] for t in out[0].tolist())
    print("gpt continuation:", repr(prompt + text))
    examples.print_launches(examples.launch_counts())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
