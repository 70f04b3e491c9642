"""Word2Vec — tokenized-text front-end over the SequenceVectors engine
(port of `deeplearning4j_tpu/nlp/word2vec.py`).

Reference parity: `models/word2vec/Word2Vec.java` over
`models/sequencevectors/SequenceVectors.java` with learning algorithms
`models/embeddings/learning/impl/elements/{SkipGram,CBOW}.java` and storage
`models/embeddings/inmemory/InMemoryLookupTable.java` (syn0/syn1/syn1neg).

The whole training engine (vocab → Huffman/negative tables → batched
device steps) lives in `nlp/sequence_vectors.py` — shared with ParagraphVectors
and DeepWalk exactly as the reference shares SequenceVectors. This class
adds only the text pipeline: sentence iterators + tokenizer factory.
"""

from __future__ import annotations

from typing import List, Optional

from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory, SentenceIterator, TokenizerFactory,
    tokenize_corpus,
)


def _as_token_lists(corpus, tokenizer_factory) -> List[List[str]]:
    if isinstance(corpus, SentenceIterator):
        return tokenize_corpus(corpus, tokenizer_factory)
    corpus = list(corpus)
    if corpus and isinstance(corpus[0], str):
        return tokenize_corpus(corpus, tokenizer_factory)
    return [list(s) for s in corpus]


class Word2Vec(SequenceVectors):
    """Reference: `Word2Vec.Builder` surface mapped to kwargs."""

    def __init__(self, *, use_cbow: bool = False,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 **kw):
        kw.setdefault("learning_algorithm", "cbow" if use_cbow
                      else "skipgram")
        super().__init__(**kw)
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()

    def fit(self, corpus) -> "Word2Vec":
        """Reference: `SequenceVectors.fit():187` reached through the
        Word2Vec text pipeline (sentence iterator → tokenizer)."""
        sentences = _as_token_lists(corpus, self.tokenizer_factory)
        SequenceVectors.fit(self, sentences)
        return self
