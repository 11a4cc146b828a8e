"""NLP suite of the port: embeddings (Word2Vec/GloVe/ParagraphVectors),
vocab/Huffman, tokenization SPIs, similarity queries.

Port of ``deeplearning4j_tpu/nlp`` (exports as its ``__init__.py:8-27``);
the bag-of-words/TF-IDF vectorizers are not ported yet (ROADMAP A8).
The chunk updates run kernels B4 (word2vec) and B5 (GloVe) on CUDA.
"""

from deeplearning4j_tpu_torch.nlp.text import (  # noqa: F401
    CollectionSentenceIterator, DefaultTokenizerFactory, DocumentIterator,
    FileSentenceIterator, LabelAwareSentenceIterator, LineSentenceIterator,
    NGramTokenizerFactory, SentenceIterator, common_preprocessor,
)
from deeplearning4j_tpu_torch.nlp.vocab import (  # noqa: F401
    VocabCache, VocabWord, build_huffman, build_vocab, encode_hs_tables,
    unigram_table,
)
from deeplearning4j_tpu_torch.nlp.word_vectors import (  # noqa: F401
    WordVectors, load_word_vectors, write_word_vectors,
)
from deeplearning4j_tpu_torch.nlp.word2vec import (  # noqa: F401
    Word2Vec, Word2VecConfig,
)
from deeplearning4j_tpu_torch.nlp.glove import Glove, GloveConfig  # noqa: F401
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (  # noqa: F401
    ParagraphVectors, ParagraphVectorsConfig,
)
