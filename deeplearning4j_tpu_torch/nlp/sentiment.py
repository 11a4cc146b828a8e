"""SentiWordNet-style sentiment scoring.

Reference parity: ``text/corpora/sentiwordnet/SWN3.java`` — parses the
SentiWordNet 3.0 tab-separated format (POS, id, PosScore, NegScore,
``word#rank`` synset terms, gloss), folds per-sense polarity
(pos − neg) into one score per ``word#pos`` with 1/rank weighting
normalized by the harmonic sum (SWN3.java:80-118), scores token lists by
summing word polarities with a whole-sentence sign flip when a negation
word occurs (scoreTokens:174-190), and maps scores to the seven
sentiment classes.

Differences from the reference, on purpose:
- ``class_for_score`` uses monotone, non-overlapping buckets; the
  reference's branch chain (SWN3.java:150-164) has overlapping and
  unreachable conditions (e.g. ``score > 0 && score >= 0.25`` labeled
  "weak_positive") that we do not reproduce.
- the bundled lexicon is a small hand-authored file in the same format
  (data/sentiwordnet_mini.txt); pass ``path`` to load the real
  SentiWordNet 3.0 distribution.

Port of ``deeplearning4j_tpu/nlp/sentiment.py``: a copy; the lexicon is the port's own copy of
``nlp/data/sentiwordnet_mini.txt``.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence

_DEFAULT_LEXICON = os.path.join(os.path.dirname(__file__), "data",
                                "sentiwordnet_mini.txt")

#: SWN3.java:50 negation set (could/would/should/not/…n't)
NEGATION_WORDS = frozenset({
    "could", "would", "should", "not", "no", "never", "isn't", "aren't",
    "wasn't", "weren't", "haven't", "doesn't", "didn't", "don't", "won't",
    "can't", "cannot",
})

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")
_TOKEN = re.compile(r"[a-zA-Z']+")


class SentiWordNet:
    """Polarity dictionary + scorer (SWN3 parity)."""

    POS_TAGS = ("a", "n", "v", "r")

    def __init__(self, path: Optional[str] = None,
                 negation_words: Optional[Iterable[str]] = None):
        self.path = path or _DEFAULT_LEXICON
        self.negation_words = frozenset(
            negation_words if negation_words is not None else NEGATION_WORDS)
        self._dict: Dict[str, float] = {}
        self._load(self.path)

    # -- lexicon ------------------------------------------------------------
    def _load(self, path: str) -> None:
        senses: Dict[str, Dict[int, float]] = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                cols = line.split("\t")
                if len(cols) < 5 or not cols[2] or not cols[3]:
                    continue
                pos, _, pos_score, neg_score, terms = cols[:5]
                polarity = float(pos_score) - float(neg_score)
                for term in terms.split():
                    if "#" not in term:
                        continue
                    word, _, rank = term.rpartition("#")
                    key = f"{word.lower()}#{pos}"
                    senses.setdefault(key, {})[int(rank)] = polarity
        # 1/rank weighting over senses, normalized by the harmonic sum —
        # the reference's fold (SWN3.java:107-117)
        for key, by_rank in senses.items():
            score = sum(s / rank for rank, s in by_rank.items())
            norm = sum(1.0 / rank for rank in by_rank)
            self._dict[key] = score / norm if norm else 0.0

    def __len__(self) -> int:
        return len(self._dict)

    # -- scoring ------------------------------------------------------------
    def score_word(self, word: str, pos: Optional[str] = None) -> float:
        """Polarity in [-1, 1].  With ``pos`` (one of a/n/v/r) look up
        that entry; otherwise average the entries present across POS
        (the reference's ``extract`` probes each suffix)."""
        word = word.lower()
        if pos is not None:
            return self._dict.get(f"{word}#{pos}", 0.0)
        found = [self._dict[k] for k in (f"{word}#{p}"
                                         for p in self.POS_TAGS)
                 if k in self._dict]
        return sum(found) / len(found) if found else 0.0

    def score_tokens(self, tokens: Sequence[str]) -> float:
        """Sum of token polarities; the whole sentence flips sign when a
        negation word occurs (scoreTokens:185-188)."""
        total = 0.0
        negated = False
        for tok in tokens:
            low = tok.lower()
            total += self.score_word(low)
            if low in self.negation_words:
                negated = True
        return -total if negated else total

    def score(self, text: str) -> float:
        """Sentence-split, tokenize, sum per-sentence scores."""
        return sum(self.score_tokens(_TOKEN.findall(sent))
                   for sent in _SENT_SPLIT.split(text) if sent.strip())

    # -- classification -----------------------------------------------------
    @staticmethod
    def class_for_score(score: float) -> str:
        if score >= 0.75:
            return "strong_positive"
        if score > 0.25:
            return "positive"
        if score > 0.0:
            return "weak_positive"
        if score == 0.0:
            return "neutral"
        if score >= -0.25:
            return "weak_negative"
        if score > -0.75:
            return "negative"
        return "strong_negative"

    def classify(self, text: str) -> str:
        return self.class_for_score(self.score(text))


def harmonic_number(n: int) -> float:
    """H(n); exposed for tests documenting the sense-weighting fold."""
    return sum(1.0 / k for k in range(1, n + 1))
