"""The reference's sampling rule draws the program's tokens: the same
noise from a request's seed and position, so a sampled token can be
judged like a greedy one."""

import pytest
import torch

from benchmark.reference import sampler


@pytest.mark.parametrize("temperature", [0.0, 0.5, 1.0])
def test_reference_rule_draws_the_programs_tokens(temperature):
    from deeplearning4j_tpu_torch.models import gpt

    g = torch.Generator().manual_seed(3)
    vocab = 1000
    logits = torch.randn(40, vocab, generator=g) * 2.0
    for seed in (0, 1, 2 ** 31 - 2, 123456789):
        pos = torch.arange(17, 57)
        want = gpt.sample_token(logits, gpt._slot_key(
            torch.full((40,), seed, dtype=torch.int64), pos), temperature)
        got = sampler.scores(logits, temperature, seed, pos).argmax(-1)
        assert torch.equal(got, want.long())
        # one row at a time, as the prefill's first token is drawn
        one = gpt.sample_token(logits[0], gpt._slot_key(seed, 17),
                               temperature)
        assert int(one) == int(got[0])


def test_another_seed_or_temperature_draws_other_tokens():
    g = torch.Generator().manual_seed(4)
    logits = torch.randn(64, 500, generator=g)
    pos = torch.arange(64)
    a = sampler.scores(logits, 1.0, 5, pos).argmax(-1)
    assert not torch.equal(a, sampler.scores(logits, 1.0, 6, pos).argmax(-1))
    assert not torch.equal(a, sampler.scores(logits, 0.5, 5, pos).argmax(-1))
