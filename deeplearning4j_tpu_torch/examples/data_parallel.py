"""Data parallelism: one train step, N ranks, gradients summed.

The port of ``examples/data_parallel.py``.  BERT (``bert_tiny(512,
32)``) trains 5 steps with ``make_optimizer("adamw", 1e-3)`` on a data
mesh over every rank, each rank on its block of the global batch of 8
rows a rank.  A device of the reference is a rank here: ``--ranks N``
(default one a card; one on the CPU) spawns the ranks, gloo on the CPU
and for several ranks on one card, NCCL with one rank a card.  On the
card the attention runs the flash kernels B1-B3.

    python -m deeplearning4j_tpu_torch.examples.data_parallel \\
        [--ranks N] [--device cuda|cpu]
"""
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch import examples


def rank_main(rank: examples.Rank) -> dict:
    """One rank's 5 steps: rank 0's printed lines and the launches."""
    from deeplearning4j_tpu_torch.models import bert
    from deeplearning4j_tpu_torch.ops.updaters import make_optimizer
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    n = rank.world
    mesh = make_mesh(MeshSpec(data=n), device=rank.device)
    cfg = bert.bert_tiny(vocab_size=512, max_len=32)
    init_fn, step_fn = bert.make_train_step(
        cfg, mesh, optimizer=make_optimizer("adamw", 1e-3),
        device=rank.device)
    state = init_fn(torch.Generator(device=rank.device).manual_seed(0))
    batch = bert.synthetic_batch(1, cfg, 8 * n, 32, device=rank.device)
    examples.reset_launches()
    lines = []
    for i in range(5):
        state, loss = step_fn(state, batch)
        lines.append(f"step {i}: loss {float(loss):.4f}  "
                     f"(batch sharded over {n} device(s))")
    return {"lines": lines, "launches": examples.launch_counts()}


def main(argv: Optional[List[str]] = None) -> int:
    from deeplearning4j_tpu_torch.examples import data_parallel

    ap = examples.parser(__doc__)
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the data mesh (default: one a card; "
                         "one on the CPU)")
    args = ap.parse_args(argv)
    dev = examples.device(args)
    world = args.ranks or examples.default_ranks(dev)
    results = examples.run_ranks("data_parallel", data_parallel.rank_main,
                                 world, dev)
    for line in results[0]["lines"]:
        print(line)
    examples.print_launches(examples.add_counts(
        [r["launches"] for r in results]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
