"""The one general generator of the benchmark's inputs.  A traffic mix is
a JSON file beside this module (``<traffic>.json``) whose ``kind`` names
one of the makers below and whose other keys are its parameters; every
draw comes from the run's seed.

Sizes are block-stratified: each block of ``block``
consecutive draws is a permutation of the same ``block`` quantiles of
the stated distribution, drawn from the mix's own stream and not the
run's seed.  So every seed serves the same work in the same order, and
two runs differ by the system's noise alone; what the seed changes is
the content: the token ids, the segment splits and masked positions,
the sampling seeds (and, in the harness, the weights).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from statistics import NormalDist
from typing import Any, Dict, List, NamedTuple

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str) -> Dict[str, Any]:
    """The parameters of traffic mix ``name``."""
    return json.loads((HERE / f"{name}.json").read_text())


def _kind(p: Dict[str, Any], kind: str) -> None:
    if p.get("kind") != kind:
        raise ValueError(f"a {p.get('kind')!r} mix given to the {kind!r} "
                         f"maker")


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """An independent stream ``stream`` of the run's ``seed``."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), stream])


def schedule_rng(stream: int, p: Dict[str, Any]) -> np.random.Generator:
    """The stream the sizes are drawn from: the same under
    every seed (``schedule_seed`` in the mix's parameters moves it; only
    the readings that look at other schedules set it)."""
    return np.random.default_rng([p.get("schedule_seed", 0x5C4ED), stream])


def quantile(dist: Dict[str, Any], u: float) -> float:
    """The ``u`` quantile of a size distribution: ``uniform`` and
    ``loguniform`` over ``[lo, hi]``, ``lognormal`` with ``median`` and
    ``sigma``, ``exponential`` with ``mean``; clipped to ``[lo, hi]``
    where given."""
    kind = dist["dist"]
    if kind == "uniform":
        x = dist["lo"] + u * (dist["hi"] - dist["lo"])
    elif kind == "loguniform":
        x = math.exp(math.log(dist["lo"]) + u * (
            math.log(dist["hi"]) - math.log(dist["lo"])))
    elif kind == "lognormal":
        x = dist["median"] * math.exp(dist["sigma"] * NormalDist().inv_cdf(u))
    elif kind == "exponential":
        x = -math.log(1.0 - u) * dist["mean"]
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    if "lo" in dist:
        x = max(x, dist["lo"])
    if "hi" in dist:
        x = min(x, dist["hi"])
    return x


def stratified(dist: Dict[str, Any], n: int, block: int,
               rng: np.random.Generator, integer: bool = True) -> np.ndarray:
    """``n`` draws, each block of ``block`` a permutation of the block's
    midpoint quantiles."""
    q = np.array([quantile(dist, (i + 0.5) / block) for i in range(block)])
    if integer:
        q = np.rint(q)
    reps = -(-n // block)
    out = np.concatenate([rng.permutation(q) for _ in range(reps)])[:n]
    return out.astype(np.int64) if integer else out


# -- training ---------------------------------------------------------------

def lm_packed(p: Dict[str, Any], vocab: int, seed: int) -> np.ndarray:
    """``[n_batches, batch, seq]`` int32 token ids: documents of
    stratified lengths, each followed by ``eos_id``, packed end to end
    into one stream that is cut into rows, as GPT-2-style pretraining
    packs text.  Ids other than the separator are uniform over the rest
    of the vocabulary."""
    _kind(p, "lm_packed")
    rng = rng_of(seed, 1)
    n_tok = p["n_batches"] * p["batch"] * p["seq"]
    mean = p["doc_len"].get("median", p["doc_len"].get("lo", 1))
    n_docs = 4 * (n_tok // max(int(mean), 1) + 1)
    lengths = stratified(p["doc_len"], n_docs, p.get("block", 64),
                         schedule_rng(1, p))
    eos = p["eos_id"]
    body = rng.integers(0, vocab - 1, n_tok, dtype=np.int64)
    body = body + (body >= eos)            # every id but the separator
    ends = np.cumsum(lengths + 1) - 1
    ends = ends[ends < n_tok]
    body[ends] = eos
    return body.astype(np.int32).reshape(p["n_batches"], p["batch"],
                                         p["seq"])


class MLMBatch(NamedTuple):
    token_ids: np.ndarray       # [n, B, T] int32, corrupted
    attention_mask: np.ndarray  # [n, B, T] float32
    type_ids: np.ndarray        # [n, B, T] int32
    labels: np.ndarray          # [n, B, T] int32, original ids
    mlm_mask: np.ndarray        # [n, B, T] float32, 1 = predicted


def mlm_pairs(p: Dict[str, Any], vocab: int, seed: int) -> MLMBatch:
    """BERT pretraining batches as ``create_pretraining_data.py`` makes
    them: ``[CLS] A [SEP] B [SEP]`` with segment ids 0 then 1; a
    ``short_seq_prob`` share of sequences is shorter (uniform over
    ``[short_min, seq - 1]``) and padded, with the key mask 0 there;
    ``mask_prob`` of the real word positions are predicted, of which
    80% become ``[MASK]``, 10% a random word and 10% stay."""
    _kind(p, "mlm_pairs")
    rng = rng_of(seed, 2)
    n, B, T = p["n_batches"], p["batch"], p["seq"]
    cls, sep, msk, pad = p["cls_id"], p["sep_id"], p["mask_id"], p["pad_id"]
    lo = p["word_lo"]
    rows = n * B
    block = p.get("block", 64)
    # which rows are short, and their lengths: stratified like the sizes
    sched = schedule_rng(2, p)
    n_short = stratified({"dist": "uniform", "lo": 0.0, "hi": 1.0}, rows,
                         block, sched, integer=False) < p["short_seq_prob"]
    short_len = stratified({"dist": "uniform", "lo": p["short_min"],
                            "hi": T - 1}, rows, block, sched)
    lengths = np.where(n_short, short_len, T)
    ids = np.full((rows, T), pad, np.int32)
    types = np.zeros((rows, T), np.int32)
    att = np.zeros((rows, T), np.float32)
    pred = np.zeros((rows, T), np.float32)
    labels = np.full((rows, T), pad, np.int32)
    for r in range(rows):
        L = int(lengths[r])
        words = L - 3
        a = int(rng.integers(1, words))          # A's length, B gets the rest
        seq = np.concatenate([[cls], rng.integers(lo, vocab, a), [sep],
                              rng.integers(lo, vocab, words - a), [sep]])
        ids[r, :L] = seq
        labels[r, :L] = seq
        types[r, a + 2:L] = 1
        att[r, :L] = 1.0
        cand = np.flatnonzero((seq != cls) & (seq != sep))
        k = max(1, int(round(p["mask_prob"] * cand.size)))
        chosen = rng.choice(cand, k, replace=False)
        pred[r, chosen] = 1.0
        fate = rng.random(k)
        ids[r, chosen[fate < 0.8]] = msk
        rand = chosen[(fate >= 0.8) & (fate < 0.9)]
        ids[r, rand] = rng.integers(lo, vocab, rand.size)
    shape = (n, B, T)
    return MLMBatch(ids.reshape(shape), att.reshape(shape),
                    types.reshape(shape), labels.reshape(shape),
                    pred.reshape(shape))


# -- serving ----------------------------------------------------------------

class Request(NamedTuple):
    prompt: np.ndarray      # [T_p] int32
    max_tokens: int
    temperature: float      # 0: greedy
    seed: int               # the request's sampling seed


def requests(p: Dict[str, Any], vocab: int, seed: int, n: int
             ) -> List[Request]:
    """``n`` requests: stratified prompt and output lengths, each pair
    capped so that prompt + output <= ``max_total``; a ``greedy_share``
    of each block greedy, the rest sampled at ``temperature``, each with a
    sampling seed of its own; prompt ids uniform over the vocabulary."""
    _kind(p, "requests")
    rng = rng_of(seed, 3)
    sched = schedule_rng(3, p)
    block = p.get("block", 64)
    plen = stratified(p["prompt"], n, block, sched)
    olen = stratified(p["output"], n, block, sched)
    greedy = np.concatenate([sched.permutation(
        np.arange(block) < round(p["greedy_share"] * block))
        for _ in range(-(-n // block))])[:n]
    out = []
    for i in range(n):
        tp = int(plen[i])
        to = int(min(olen[i], p["max_total"] - tp))
        out.append(Request(
            rng.integers(0, vocab, tp, dtype=np.int64).astype(np.int32),
            to, 0.0 if greedy[i] else float(p["temperature"]),
            int(rng.integers(0, 2 ** 31 - 1))))
    return out

