"""The sampling rule of a served request, written out plainly, so that the
tokens of sampled requests can be judged like greedy ones.

The engine's stated rule: a request of seed ``s`` at temperature ``T``
draws the token of the logits row at position ``p`` (the last prompt
position for the first token, one further for each token after) as the
Gumbel-max of ``logits / T``.  The noise of vocabulary index ``v`` is a
32-bit counter hash of ``(s, p, v)``, mapped to a uniform ``u`` in
(0, 1) and to ``-log(-log(u))`` in float64.  The hash is a fixed mixer
(two rounds of shift, xor and a product by an odd constant); this module
writes it again from that description and imports nothing of the
program.

Given the noise, a sampled token is a function of the logits alone, so
its gap is read as a greedy token's is: how far its perturbed score lies
below the best perturbed score of the float32 reference, in logits (the
scores times ``T``).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

M32 = 0xFFFFFFFF
MUL = 0x45D9F3B
SALT = 0x68E31DA4


def mix32(x: Tensor) -> Tensor:
    """The 32-bit mixer on int64 values in ``[0, 2**32)``."""
    x = ((x >> 16) ^ x) * MUL & M32
    x = ((x >> 16) ^ x) * MUL & M32
    return (x >> 16) ^ x


def gumbel(seed: int, positions: Tensor, vocab: int) -> Tensor:
    """``[n, vocab]`` float64 noise of a request of ``seed`` at the
    logits rows ``positions`` ``[n]`` (int64)."""
    dev = positions.device
    s = mix32(torch.tensor(int(seed) & M32, dtype=torch.int64, device=dev))
    keys = mix32(s ^ (positions.long() & M32))
    idx = torch.arange(vocab, dtype=torch.int64, device=dev)
    bits = mix32(mix32(idx + SALT)[None, :] ^ keys[:, None])
    u = (bits.double() + 0.5) * 2.0 ** -32
    return -torch.log(-torch.log(u))


def scores(logits: Tensor, temperature: float, seed: int,
           positions: Tensor) -> Tensor:
    """What the draw takes the argmax of, times ``temperature``, in
    float64: ``logits + T * noise`` at ``T > 0``, the logits at ``T <=
    0`` (greedy)."""
    if temperature <= 0.0:
        return logits.double()
    t = max(float(temperature), 1e-6)
    return logits.double() + t * gumbel(seed, positions, logits.shape[-1])
