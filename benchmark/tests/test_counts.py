"""The yardstick's arithmetic: FLOPs, the attention bound, the union of
device intervals and the naming of idle gaps."""

import pytest

from benchmark.counts import flops, intervals


def test_gpt2_small_step_flops():
    # B=8, T=1024: products of QKV and out, the MLP, the causal scores
    # and values (halved) and the 50,257-wide readout, forward x 3
    got = flops.train_step_flops(12, 768, 3072, 50257, 8, 1024, True)
    assert got == pytest.approx(6.536e12, rel=5e-4)


def test_bert_base_step_flops():
    got = flops.train_step_flops(12, 768, 3072, 30522, 32, 128, False)
    assert got == pytest.approx(2.721e12, rel=5e-4)


def test_causal_halves_only_the_score_term():
    full = flops.train_step_flops(2, 64, 256, 100, 2, 32, False)
    causal = flops.train_step_flops(2, 64, 256, 100, 2, 32, True)
    assert full - causal == pytest.approx(3 * 2 * 2 * 2 * 32 * 32 * 64)


def test_attention_bounds():
    # GPT-2 small a layer: operations bound, 0.039 ms
    t, by = flops.attention_bound_s(8, 12, 1024, 64, True, False)
    assert by == "operations" and t * 1e3 == pytest.approx(0.0391, rel=1e-2)
    # BERT-base a layer: bytes bound, 0.015 ms
    t, by = flops.attention_bound_s(32, 12, 128, 64, False, True)
    assert by == "bytes" and t * 1e3 == pytest.approx(0.0151, rel=1e-2)


@pytest.mark.parametrize("spans,want", [
    ([(0, 10), (5, 15)], 15),                 # two streams overlapping
    ([(0, 10), (0, 10)], 10),                 # the same interval twice
    ([(0, 4), (6, 8), (7, 20)], 18),
    ([(-5, 3), (18, 40)], 5),                 # clipped to the window
])
def test_union_counts_overlap_once(spans, want):
    assert intervals.covered(intervals.union(spans, 0, 20)) == want


def test_busy_plus_idle_is_the_window():
    busy = intervals.union([(2, 5), (4, 9), (12, 13)], 0, 20)
    idle = intervals.gaps(busy, 0, 20)
    assert idle == [(0, 2), (9, 12), (13, 20)]
    assert intervals.covered(busy) + intervals.covered(idle) == 20


def test_gaps_named_by_innermost_host_span():
    spans = [(0, 100, "bench.step_fn"), (10, 20, "aten::copy_"),
             (50, 60, "cudaGraphLaunch")]
    idle = [(12, 14), (30, 35), (55, 56), (200, 210)]
    got = intervals.label_gaps(idle, spans)
    assert got == {"aten::copy_": 2, "bench.step_fn": 5,
                   "cudaGraphLaunch": 1, "no traced host call": 10}
