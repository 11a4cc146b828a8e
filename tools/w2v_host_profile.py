#!/usr/bin/env python3
"""Where a warm word2vec epoch's host time goes on the card.

Run from the repo root on a machine with one CUDA card:

    python3 tools/w2v_host_profile.py

For the two word2vec corpora of ``chip_smoke.py`` (data/text8 at min
count 5 and the 2M-word Zipf corpus at min count 1, the bench config of
``chip_smoke.W2V_CONFIG``), fits one epoch cold (pairs, slabs and the
chunk graph's capture), once warm, then profiles a third, warm fit from
the same tables with cProfile and prints its wall ms, its chunk count
and the 18 functions with the most time of their own.  The chunks run
as CUDA-graph replays (``runtime/compile_cache``); what else a fit does
on the host (the Huffman tree, the training tables, the uploads) shows
beside them.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import cProfile
import io
import os
import pstats
import sys
import time


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("w2v_host_profile: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from deeplearning4j_tpu_torch import resolve_device
    from deeplearning4j_tpu_torch.nlp import word2vec as tw2v

    resolve_device("cuda")
    card = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    for name, sents, min_count in (("text8", cs.text8_sentences(), 5),
                                   ("Zipf", cs.zipf_sentences(), 1)):
        cfg = tw2v.Word2VecConfig(epochs=1, min_word_frequency=min_count,
                                  **cs.W2V_CONFIG)
        w2v = tw2v.Word2Vec(sents, cfg, device="cuda")
        w2v.fit()
        init = (w2v.syn0, w2v.syn1, w2v.syn1neg)
        w2v.fit(initial_weights=init)
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        w2v.fit(initial_weights=init)
        torch.cuda.synchronize()
        prof.disable()
        wall = (time.perf_counter() - t0) * 1e3
        print(f"{name}: warm one-epoch fit, {w2v.chunks} chunks, {wall:.1f} "
              f"ms wall under cProfile [{card}]")
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(18)
        print(out.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
