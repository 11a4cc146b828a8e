"""Raw-sentence → binary tree front-end for the RNTN.

Reference parity: ``text/corpora/treeparser/TreeParser.java`` (+ its
``transformer/{BinarizeTreeTransformer,CollapseUnaries}.java``) — the
reference turns plain sentences into binarized constituency trees the
RNTN can train on, via a CoreNLP/UIMA parser.  Zero-egress equivalent:
a TRAINED transition chunker (nlp/chunker.py, averaged perceptron over
B/I/O chunk actions — the trained-parse-model role) over the bundled
perceptron tagger (nlp/pos.py), followed by deterministic binarization,
producing :class:`deeplearning4j_tpu_torch.nlp.rntn.Tree` nodes directly —
already binary, so no separate binarize/collapse-unaries passes are
needed.  The round-4 tag-rule chunker remains as ``mode="rules"``.

Labels: constituency parsing gives structure, not sentiment; interior
nodes get ``neutral_label`` and the root gets the caller's sentence
label — exactly how the reference pipelines raw text into RNTN training
(tree structure from the parser, labels from the dataset).

Port of ``deeplearning4j_tpu/nlp/treeparser.py``: a copy whose trees are the port's ``rntn.Tree``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.nlp.pos import AveragedPerceptronTagger, default_tagger
from deeplearning4j_tpu_torch.nlp.rntn import Tree
from deeplearning4j_tpu_torch.nlp.text import word_punct_tokenize

# chunk grammar over PTB tags: maximal runs joined into one phrase
_NP_START = {"DT", "PRP$", "JJ", "JJR", "JJS", "CD"}
_NP_HEAD = {"NN", "NNS", "NNP", "NNPS", "PRP"}
_VP_START = {"MD", "RB", "RBR", "RBS"}
_VP_HEAD = {"VB", "VBD", "VBG", "VBN", "VBP", "VBZ"}


#: shared word/punct tokenizer (see nlp/text.py)
tokenize = word_punct_tokenize


def _chunk(tagged: Sequence[Tuple[str, str]]) -> List[List[str]]:
    """Greedy shallow chunking: [DT/JJ/... NN+] noun phrases and
    [MD/RB/VB...] verb groups; everything else is its own chunk."""
    chunks: List[List[str]] = []
    i = 0
    n = len(tagged)
    while i < n:
        word, tag = tagged[i]
        if tag in _NP_START or tag in _NP_HEAD:
            j = i
            saw_head = False
            while j < n:
                t = tagged[j][1]
                if t in _NP_HEAD:
                    saw_head = True
                    j += 1
                elif t in _NP_START and not saw_head:
                    j += 1
                else:
                    break
            if j > i:
                chunks.append([w for w, _ in tagged[i:j]])
                i = j
                continue
        if tag in _VP_START or tag in _VP_HEAD:
            j = i
            saw_verb = False
            while j < n:
                t = tagged[j][1]
                if t in _VP_HEAD:
                    saw_verb = True
                    j += 1
                elif t in _VP_START:
                    j += 1
                else:
                    break
            if saw_verb:
                chunks.append([w for w, _ in tagged[i:j]])
                i = j
                continue
        chunks.append([word])
        i += 1
    return chunks


def _binarize_right(nodes: List[Tree], label: int) -> Tree:
    """Right-branching binarization (head-final combination, the shape
    BinarizeTreeTransformer produces for flat constituents)."""
    node = nodes[-1]
    for left in reversed(nodes[:-1]):
        node = Tree(label=label, left=left, right=node)
    return node


class TreeParser:
    """``parse(sentence, label)`` → binary :class:`rntn.Tree`.

    ``mode="model"`` (default) chunks with the TRAINED transition
    chunker (nlp/chunker.py — the reference's trained-parse-model role,
    TreeParser.java:57); ``mode="rules"`` keeps the round-4 tag-rule
    heuristic as the zero-cost fallback.

    ``neutral_label`` fills interior/leaf nodes (class 2 of the 5-class
    sentiment scheme); the sentence-level ``label`` lands on the root.
    """

    def __init__(self, tagger: Optional[AveragedPerceptronTagger] = None,
                 neutral_label: int = 2, propagate_label: bool = True,
                 mode: str = "model", chunker=None):
        if mode not in ("model", "rules"):
            raise ValueError(f"mode must be 'model' or 'rules': {mode!r}")
        self._tagger = tagger
        self.neutral_label = neutral_label
        #: with only a sentence-level label available, propagate it to
        #: interior phrase nodes (leaves stay neutral) — the RNTN loss is
        #: per-node, so root-only labeling would drown in neutral targets
        self.propagate_label = propagate_label
        self.mode = mode
        self._chunker = chunker

    @property
    def tagger(self) -> AveragedPerceptronTagger:
        if self._tagger is None:
            self._tagger = default_tagger()
        return self._tagger

    @property
    def chunker(self):
        if self._chunker is None:
            if self._tagger is None:
                from deeplearning4j_tpu_torch.nlp.chunker import default_chunker
                self._chunker = default_chunker()
            else:
                # a custom tagger's tag distribution differs from the
                # bundled one the default chunker was trained on — train
                # a chunker on THIS tagger's output so the 't:'/'t2:'
                # features match what parse() will feed it
                from deeplearning4j_tpu_torch.nlp.chunker import (
                    ChunkPerceptron, annotated_corpus)
                self._chunker = ChunkPerceptron().train(
                    annotated_corpus(self._tagger))
        return self._chunker

    def _chunks(self, tagged) -> List[List[str]]:
        if self.mode == "model":
            return self.chunker.chunk(tagged)
        return _chunk(tagged)

    def parse(self, sentence: str, label: Optional[int] = None) -> Tree:
        tokens = tokenize(sentence)
        if not tokens:
            raise ValueError("empty sentence")
        neutral = self.neutral_label
        interior = (label if (label is not None and self.propagate_label)
                    else neutral)
        tagged = self.tagger.tag(tokens)
        phrase_trees: List[Tree] = []
        for chunk in self._chunks(tagged):
            leaves = [Tree(label=neutral, word=w) for w in chunk]
            phrase_trees.append(_binarize_right(leaves, interior))
        root = _binarize_right(phrase_trees, interior)
        root.label = neutral if label is None else label
        return root

    def parse_labeled(self, labeled: Sequence[Tuple[str, int]]) -> List[Tree]:
        """[(sentence, label)] → trees ready for ``RNTN.fit`` — the
        raw-text training path TreeParser.java enables."""
        return [self.parse(s, lab) for s, lab in labeled]


def trees_from_raw(labeled: Sequence[Tuple[str, int]],
                   tagger: Optional[AveragedPerceptronTagger] = None,
                   mode: str = "model") -> List[Tree]:
    """Module-level convenience: raw labeled sentences → RNTN trees
    (model-chunked by default; ``mode="rules"`` for the heuristic)."""
    return TreeParser(tagger, mode=mode).parse_labeled(labeled)
