"""Viterbi sequence decoding.

Port of ``deeplearning4j_tpu/utils/viterbi.py`` (reference parity:
``util/Viterbi.java:31``) — used with the moving-window NLP
featurization (nlp/moving_window) for sequence labeling: per-position
label log-probabilities from a classifier + a label-transition matrix.

The forward max-product runs as a loop over T on ``[B, K]`` tensors on
the emissions' device (``decode`` is ``decode_batch`` of one sequence);
the backpointers ``[T-1, B, K]`` come to the host in one copy and the
unwind runs there in numpy.  ``argmax`` ties resolve to the first index,
as ``jnp.argmax`` does; with no prior the default is ``-log K``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device

Tensor = torch.Tensor


def decode(emission_logp, transition_logp,
           prior_logp=None) -> Tuple[Tensor, Tensor]:
    """Most likely label path.

    emission_logp [T, K]: per-position log P(label) from the classifier;
    transition_logp [K, K]: log P(next | prev); prior_logp [K] initial.
    Returns (path int32 [T], path log-probability scalar), on the
    emissions' device.
    """
    paths, logp = decode_batch(torch.as_tensor(emission_logp)[None],
                               transition_logp, prior_logp)
    return paths[0], logp[0]


def decode_batch(emission_logp, transition_logp,
                 prior_logp=None) -> Tuple[Tensor, Tensor]:
    """emission_logp [B, T, K] -> (paths int32 [B, T], logp [B])."""
    em = torch.as_tensor(emission_logp)
    B, T, K = em.shape
    trans = torch.as_tensor(transition_logp, dtype=em.dtype).to(em.device)
    if prior_logp is None:
        prior = em.new_full((K,), -math.log(K))
    else:
        prior = torch.as_tensor(prior_logp, dtype=em.dtype).to(em.device)
    delta = prior + em[:, 0]                                # [B, K]
    backptrs = []
    for t in range(1, T):
        # delta [B, K]: best log-prob ending in each label at t-1
        scores = delta[:, :, None] + trans                  # [B, Kprev, K]
        backptrs.append(torch.argmax(scores, dim=1))        # first of ties
        delta = scores.amax(dim=1) + em[:, t]
    logp = delta.amax(dim=1)
    last = torch.argmax(delta, dim=1)
    bp = (torch.stack(backptrs).cpu().numpy() if backptrs
          else np.zeros((0, B, K), np.int64))               # [T-1, B, K]
    path = np.empty((B, T), np.int32)
    path[:, T - 1] = last.cpu().numpy()
    rows = np.arange(B)
    for t in range(T - 2, -1, -1):
        path[:, t] = bp[t][rows, path[:, t + 1]]
    return torch.from_numpy(path).to(em.device), logp


def transitions_from_labels(label_seqs, num_labels: int,
                            smoothing: float = 1.0,
                            device: DeviceLike = None) -> Tensor:
    """Count-based transition log-probs from training label sequences
    (the reference estimates transitions the same way, Viterbi.java).
    Counting is host-side numpy; the fp32 log-probabilities land on
    ``device``."""
    counts = np.full((num_labels, num_labels), float(smoothing))
    for seq in label_seqs:
        s = np.asarray(seq)
        np.add.at(counts, (s[:-1], s[1:]), 1.0)
    probs = np.asarray(counts / counts.sum(axis=1, keepdims=True),
                       np.float32)
    return torch.log(torch.from_numpy(probs).to(resolve_device(device)))
