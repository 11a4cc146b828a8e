"""Text infrastructure: tokenizer / sentence / document SPIs.

A copy of ``deeplearning4j_tpu/nlp/text.py``, which imports no JAX: the
port imports nothing of the JAX package, so it keeps its own copy.

Reference parity (SURVEY.md §2.6 "Text infra"):
- ``Tokenizer``/``TokenizerFactory`` (text/tokenization/) — here a factory is
  any callable ``str -> List[str]``; `DefaultTokenizerFactory` mirrors the
  default behavior (whitespace split after punctuation stripping +
  lowercase), `NGramTokenizerFactory` the n-gram variant.
- ``SentenceIterator`` SPI + File/Line/Collection impls and label-aware
  variants (text/sentenceiterator/).
- ``DocumentIterator`` (text/documentiterator/).

UIMA/Lucene engines are external services in the reference; their roles
(PoS-gated tokenization, inverted index) are covered by the pure-Python
tokenizers here and nlp/vectorizers.InvertedIndex.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

TokenPreProcess = Callable[[str], str]
Tokenizer = Callable[[str], List[str]]

_PUNCT = re.compile(r"[\.,:;!\?\"'\(\)\[\]\{\}<>]")
_WS = re.compile(r"\s+")

#: word / number / single-punctuation tokenization, shared by the
#: annotator pipeline and the tree parser so both produce the same token
#: stream for the same text
WORD_PUNCT = re.compile(r"[a-zA-Z']+|[0-9]+|[^\sa-zA-Z0-9]")


def word_punct_tokenize(text: str) -> List[str]:
    return WORD_PUNCT.findall(text)


def common_preprocessor(token: str) -> str:
    """CommonPreprocessor parity: lowercase + strip punctuation."""
    return _PUNCT.sub("", token.lower())


class DefaultTokenizerFactory:
    """Whitespace tokenizer with optional per-token preprocessing."""

    def __init__(self, pre: Optional[TokenPreProcess] = common_preprocessor):
        self.pre = pre

    def create(self, text: str) -> List[str]:
        toks = [t for t in _WS.split(text.strip()) if t]
        if self.pre:
            toks = [self.pre(t) for t in toks]
        return [t for t in toks if t]

    __call__ = create


class NGramTokenizerFactory:
    """NGramTokenizerFactory parity: emits n-grams joined by spaces."""

    def __init__(self, n_min: int = 1, n_max: int = 2,
                 pre: Optional[TokenPreProcess] = common_preprocessor):
        self.base = DefaultTokenizerFactory(pre)
        self.n_min, self.n_max = n_min, n_max

    def create(self, text: str) -> List[str]:
        toks = self.base.create(text)
        out: List[str] = []
        for n in range(self.n_min, self.n_max + 1):
            for i in range(len(toks) - n + 1):
                out.append(" ".join(toks[i:i + n]))
        return out

    __call__ = create


# -- sentence iterators -----------------------------------------------------

class SentenceIterator:
    """SPI: iterate sentences (strings), resettable; optional preprocessor."""

    def __init__(self, pre: Optional[Callable[[str], str]] = None):
        self.pre = pre

    def _sentences(self) -> Iterator[str]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[str]:
        for s in self._sentences():
            yield self.pre(s) if self.pre else s

    def reset(self) -> None:  # stateless impls: nothing to do
        pass


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Sequence[str], pre=None):
        super().__init__(pre)
        self.sentences = list(sentences)

    def _sentences(self):
        return iter(self.sentences)


class LineSentenceIterator(SentenceIterator):
    """One sentence per line of a file."""

    def __init__(self, path: str, pre=None):
        super().__init__(pre)
        self.path = path

    def _sentences(self):
        with open(self.path, encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line


class FileSentenceIterator(SentenceIterator):
    """All files under a directory, line by line."""

    def __init__(self, root: str, pre=None):
        super().__init__(pre)
        self.root = root

    def _sentences(self):
        for dirpath, _, files in sorted(os.walk(self.root)):
            for name in sorted(files):
                with open(os.path.join(dirpath, name), encoding="utf-8",
                          errors="replace") as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            yield line


class BasicLineIterator(LineSentenceIterator):
    pass


class LabelAwareSentenceIterator(SentenceIterator):
    """Yields sentences while exposing ``current_label`` — the contract
    ParagraphVectors trains against (labelled documents)."""

    def __init__(self, labelled: Sequence[Tuple[str, str]], pre=None):
        """labelled: sequence of (label, sentence)."""
        super().__init__(pre)
        self.labelled = list(labelled)
        self.current_label: Optional[str] = None

    def _sentences(self):
        for label, sent in self.labelled:
            self.current_label = label
            yield sent

    def labels(self) -> List[str]:
        return sorted({l for l, _ in self.labelled})


class DocumentIterator:
    """SPI: iterate whole documents (lists of sentences)."""

    def __init__(self, docs: Sequence[Sequence[str]]):
        self.docs = [list(d) for d in docs]

    def __iter__(self) -> Iterator[List[str]]:
        return iter(self.docs)
