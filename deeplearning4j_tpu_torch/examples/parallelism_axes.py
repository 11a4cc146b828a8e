"""Every parallelism axis training the real model, one mesh layout each.

The port of ``examples/parallelism_axes.py``, on 8 ranks (the
reference's 8 devices), which it spawns itself (gloo on the CPU and on
one card; NCCL with a card a rank).  The ranks start once and run the
four meshes in sequence:

- dp x tp : BERT, params split over ``model`` (heads and FFN columns)
- dp x pp : BERT, blocks staged over ``pipe`` (GPipe microbatch ring)
- dp x sp : BERT, ring attention rotating K/V over ``seq``
- dp x ep : MoE transformer LM, expert tables sharded over ``expert``

On the card the attention of each runs the flash kernels B1-B3.

    python -m deeplearning4j_tpu_torch.examples.parallelism_axes \\
        [--ranks 8] [--device cuda|cpu]
"""
import math
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch import examples


def tiny(n_layers=2, max_len=32):
    from deeplearning4j_tpu_torch.models import transformer as tfm

    return tfm.TransformerConfig(vocab_size=256, max_len=max_len,
                                 hidden=32, n_layers=n_layers, n_heads=4,
                                 ffn_dim=64, dropout=0.0)


def rank_main(rank: examples.Rank) -> dict:
    """The four meshes on this rank: rank 0's lines and the losses, and
    the launches."""
    from deeplearning4j_tpu_torch.models import bert, moe
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    dev = rank.device
    examples.reset_launches()
    lines, losses = [], []

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # dp=4 x tp=2: tensor-parallel heads and FFN
    mesh = make_mesh(MeshSpec(data=4, model=2), device=dev)
    cfg = tiny()
    init_fn, step_fn = bert.make_train_step(cfg, mesh, device=dev)
    state = init_fn(gen(0))
    batch = bert.synthetic_batch(1, cfg, 8, 32, device=dev)
    state, loss = step_fn(state, batch)
    losses.append(float(loss))
    lines.append(f"dp4 x tp2  BERT loss {losses[-1]:.4f}")

    # dp=2 x pp=4: GPipe pipeline over the same blocks
    mesh = make_mesh(MeshSpec(data=2, pipe=4), device=dev)
    cfg = tiny(n_layers=4)
    init_fn, step_fn = bert.make_pipeline_train_step(cfg, mesh, n_micro=2,
                                                     device=dev)
    state = init_fn(gen(3))
    state, loss = step_fn(state, batch)
    losses.append(float(loss))
    lines.append(f"dp2 x pp4  BERT loss {losses[-1]:.4f}")

    # dp=2 x sp=4: ring attention over the sequence
    mesh = make_mesh(MeshSpec(data=2, seq=4), device=dev)
    init_fn, step_fn = bert.make_sp_train_step(cfg, mesh, device=dev)
    state = init_fn(gen(4))
    state, loss = step_fn(state, batch)
    losses.append(float(loss))
    lines.append(f"dp2 x sp4  BERT loss {losses[-1]:.4f}")

    # dp=2 x ep=4: MoE transformer, experts sharded
    mesh = make_mesh(MeshSpec(data=2, expert=4), device=dev)
    mcfg = moe.MoETransformerConfig(vocab_size=256, max_len=32, hidden=32,
                                    n_layers=2, n_heads=4, d_ff=64,
                                    n_experts=8, top_k=2)
    init_fn, step_fn = moe.make_train_step(mcfg, mesh, device=dev)
    state = init_fn(gen(5))
    ids = moe.synthetic_ids(6, mcfg, 8, 32, device=dev)
    state, loss = step_fn(state, ids)
    losses.append(float(loss))
    lines.append(f"dp2 x ep4  MoE-LM loss {losses[-1]:.4f}")
    return {"lines": lines, "losses": losses,
            "launches": examples.launch_counts()}


def main(argv: Optional[List[str]] = None) -> int:
    from deeplearning4j_tpu_torch.examples import parallelism_axes

    ap = examples.parser(__doc__)
    ap.add_argument("--ranks", type=int, default=8,
                    help="ranks to spawn (the meshes take 8)")
    args = ap.parse_args(argv)
    if args.ranks != 8:
        raise SystemExit(f"parallelism_axes needs 8 ranks (its meshes are "
                         f"4x2 and 2x4), got --ranks {args.ranks}")
    dev = examples.device(args)
    results = examples.run_ranks("parallelism_axes",
                                 parallelism_axes.rank_main, 8, dev)
    for line in results[0]["lines"]:
        print(line)
    losses = results[0]["losses"]
    assert all(math.isfinite(x) for x in losses), losses
    print("all parallelism axes OK")
    examples.print_launches(examples.add_counts(
        [r["launches"] for r in results]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
