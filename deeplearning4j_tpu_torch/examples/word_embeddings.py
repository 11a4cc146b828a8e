"""Word2Vec / GloVe / ParagraphVectors on a toy corpus.

The port of ``examples/word_embeddings.py``.  On the card, Word2Vec and
ParagraphVectors train through the word2vec chunk kernel (B4,
``csrc/word2vec_chunk.cu``) and GloVe through the GloVe chunk kernel
(B5, ``csrc/glove_chunk.cu``); ``--device cpu`` runs their plain twins.

    python -m deeplearning4j_tpu_torch.examples.word_embeddings \\
        [--device cuda|cpu]
"""
from typing import List, Optional

from deeplearning4j_tpu_torch import examples
from deeplearning4j_tpu_torch.nlp.glove import Glove, GloveConfig
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
    ParagraphVectors, ParagraphVectorsConfig)
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec, Word2VecConfig

CORPUS = [
    "the cat sat on the mat", "the dog sat on the rug",
    "a cat and a dog are friends", "the king rules the castle",
    "the queen rules the palace", "a king and a queen wear crowns",
    "waves crash on the beach", "the beach is near the sea",
] * 40


def main(argv: Optional[List[str]] = None) -> int:
    args = examples.parser(__doc__).parse_args(argv)
    dev = examples.device(args)
    examples.reset_launches()

    w2v = Word2Vec(CORPUS, Word2VecConfig(
        vector_size=48, window=3, epochs=60, negative=5, use_hs=True,
        batch_size=512, alpha=0.05), device=dev)
    wv = w2v.fit()
    print("word2vec nearest(sea):", wv.words_nearest("sea", 3))

    # pair_mode="device": the token stream uploads once and each epoch's
    # pairs are built on the device (best for large corpora).  Pass a
    # mesh to fit() to data-parallel it across ranks with per-epoch
    # parameter averaging.
    w2v_dev = Word2Vec(CORPUS, Word2VecConfig(
        vector_size=48, window=3, epochs=60, negative=5, use_hs=True,
        batch_size=4096, alpha=0.05, pair_mode="device"), device=dev)
    wv_dev = w2v_dev.fit()
    print("word2vec[device] nearest(sea):", wv_dev.words_nearest("sea", 3))

    glove = Glove(CORPUS, GloveConfig(vector_size=64, epochs=25), device=dev)
    gv = glove.fit()
    print("glove  sim(cat,dog) =", round(gv.similarity("cat", "dog"), 3),
          " sim(cat,crowns) =", round(gv.similarity("cat", "crowns"), 3))

    docs = [(f"doc{i}", s) for i, s in enumerate(CORPUS[:64])]
    pv = ParagraphVectors(docs, ParagraphVectorsConfig(
        vector_size=32, window=3, epochs=30, alpha=0.05, batch_size=512),
        device=dev)
    pv.fit()
    v = pv.infer_vector("the king and the queen", epochs=30)
    print("paragraph-vectors inferred vector norm:",
          round(float((v ** 2).sum()) ** 0.5, 4))
    examples.print_launches(examples.launch_counts())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
