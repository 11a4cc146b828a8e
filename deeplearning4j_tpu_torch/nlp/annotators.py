"""Annotation pipeline — the UIMA annotator suite as a plain SPI.

Reference parity: ``text/annotator/{SentenceAnnotator, TokenizerAnnotator,
PoStagger, StemmerAnnotator}.java`` — composable CAS annotators that
progressively enrich a document (sentences → tokens → PoS tags → stems),
plus the tokenizer factories that consume them
(``text/tokenization/tokenizer/PosUimaTokenizer.java`` keeps only tokens
whose tag is allowed, ``preprocessor/EndingPreProcessor`` normalizes
endings).  UIMA's CAS machinery is replaced by a plain ``Annotation``
dataclass threaded through ``Annotator.process`` stages.

Port of ``deeplearning4j_tpu/nlp/annotators.py``: a copy over the port's tagger, stemmer and tokenizer.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.nlp.pos import AveragedPerceptronTagger, default_tagger
from deeplearning4j_tpu_torch.nlp.stemmer import PorterStemmer
from deeplearning4j_tpu_torch.nlp.text import word_punct_tokenize

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")


@dataclasses.dataclass
class Annotation:
    """The document being enriched (the CAS role): each annotator fills
    the fields it is responsible for."""
    text: str
    sentences: Optional[List[str]] = None
    tokens: Optional[List[List[str]]] = None           # per sentence
    pos_tags: Optional[List[List[Tuple[str, str]]]] = None
    stems: Optional[List[List[str]]] = None


class Annotator:
    """process(annotation) -> annotation (CasAnnotator_ImplBase role)."""

    def process(self, ann: Annotation) -> Annotation:
        raise NotImplementedError


class SentenceAnnotator(Annotator):
    """Regex sentence segmentation (SentenceAnnotator.java role)."""

    def process(self, ann: Annotation) -> Annotation:
        ann.sentences = [s.strip() for s in _SENT_SPLIT.split(ann.text)
                         if s.strip()]
        return ann


class TokenizerAnnotator(Annotator):
    """Per-sentence tokenization (TokenizerAnnotator.java role)."""

    def process(self, ann: Annotation) -> Annotation:
        if ann.sentences is None:
            SentenceAnnotator().process(ann)
        ann.tokens = [word_punct_tokenize(s) for s in ann.sentences]
        return ann


class PoSAnnotator(Annotator):
    """Tag each sentence's tokens (PoStagger.java role)."""

    def __init__(self, tagger: Optional[AveragedPerceptronTagger] = None):
        self._tagger = tagger

    def process(self, ann: Annotation) -> Annotation:
        if ann.tokens is None:
            TokenizerAnnotator().process(ann)
        tagger = self._tagger or default_tagger()
        ann.pos_tags = [tagger.tag(toks) for toks in ann.tokens]
        return ann


class StemmerAnnotator(Annotator):
    """Porter-stem each token (StemmerAnnotator.java role)."""

    def __init__(self, stemmer: Optional[PorterStemmer] = None):
        self.stemmer = stemmer or PorterStemmer()

    def process(self, ann: Annotation) -> Annotation:
        if ann.tokens is None:
            TokenizerAnnotator().process(ann)
        ann.stems = [[self.stemmer.stem(t) for t in toks]
                     for toks in ann.tokens]
        return ann


class AnalysisPipeline:
    """Ordered annotator chain (the aggregate AnalysisEngine role).

    ``AnalysisPipeline.default()`` = sentences → tokens → PoS → stems,
    the reference's standard engine
    (UimaTokenizerFactory.defaultAnalysisEngine)."""

    def __init__(self, annotators: Sequence[Annotator]):
        self.annotators = list(annotators)

    @classmethod
    def default(cls) -> "AnalysisPipeline":
        return cls([SentenceAnnotator(), TokenizerAnnotator(),
                    PoSAnnotator(), StemmerAnnotator()])

    def process(self, text: str) -> Annotation:
        ann = Annotation(text=text)
        for a in self.annotators:
            a.process(ann)
        return ann


# ---------------------------------------------------------------------------
# Tokenizer factories consuming the annotators (SPI-compatible with
# nlp/text.py factories: create(text) -> tokens)
# ---------------------------------------------------------------------------

class PosFilterTokenizerFactory:
    """Keep only tokens whose PoS tag is in ``allowed`` — the others are
    dropped (PosUimaTokenizer.java behavior of masking disallowed
    tokens).  ``allowed`` uses PTB tags, prefix-matched so "NN" admits
    NN/NNS/NNP/NNPS."""

    def __init__(self, allowed: Sequence[str],
                 tagger: Optional[AveragedPerceptronTagger] = None,
                 lowercase: bool = True):
        self.allowed = tuple(allowed)
        self._tagger = tagger
        self.lowercase = lowercase

    def create(self, text: str) -> List[str]:
        tagger = self._tagger or default_tagger()
        toks = word_punct_tokenize(text)
        out = []
        for word, tag in tagger.tag(toks):
            if any(tag.startswith(a) for a in self.allowed):
                out.append(word.lower() if self.lowercase else word)
        return out

    __call__ = create


class StemmingTokenizerFactory:
    """Tokenize then Porter-stem (EndingPreProcessor/StemmerAnnotator as
    a tokenizer stage)."""

    def __init__(self, stemmer: Optional[PorterStemmer] = None,
                 lowercase: bool = True):
        self.stemmer = stemmer or PorterStemmer()
        self.lowercase = lowercase

    def create(self, text: str) -> List[str]:
        toks = word_punct_tokenize(text.lower() if self.lowercase
                                   else text)
        return [self.stemmer.stem(t) if t.isalpha() else t for t in toks]

    __call__ = create
