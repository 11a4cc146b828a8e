"""The scaleout runtime: jobs sharded over workers + fault injection.

The port of ``examples/distributed_runtime.py``.  Word counting over an
in-process runner (WordCountTest parity), then the same run with a 25%
injected crash rate: the requeue machinery delivers every job anyway.
Word counting is host work: no kernel runs, on any device.

    python -m deeplearning4j_tpu_torch.examples.distributed_runtime \\
        [--device cuda|cpu]
"""
from typing import List, Optional

from deeplearning4j_tpu_torch import examples
from deeplearning4j_tpu_torch.nlp.distributed import (
    WordCountAggregator, WordCountPerformer, word_count_distributed)
from deeplearning4j_tpu_torch.parallel import scaleout as so
from deeplearning4j_tpu_torch.parallel.chaos import chaos_factory

SENTENCES = ["to be or not to be", "that is the question",
             "to sleep perchance to dream"] * 10


def main(argv: Optional[List[str]] = None) -> int:
    args = examples.parser(__doc__).parse_args(argv)
    examples.device(args)
    examples.reset_launches()

    counts = word_count_distributed(SENTENCES, n_workers=3)
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:3]
    print("word counts (3 workers):", top)

    runner = so.DistributedRunner(
        so.CollectionJobIterator(list(SENTENCES)),
        chaos_factory(WordCountPerformer, p_fail=0.25, seed=7),
        WordCountAggregator(), n_workers=3,
        router_cls=so.HogWildWorkRouter, max_job_retries=100)
    chaotic = runner.run(timeout_s=60.0)
    print("with 25% injected crashes: identical result ->",
          chaotic == counts)
    examples.print_launches(examples.launch_counts())
    return 0 if chaotic == counts else 1


if __name__ == "__main__":
    raise SystemExit(main())
