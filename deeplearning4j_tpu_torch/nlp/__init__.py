"""NLP / embeddings (port of `deeplearning4j_tpu/nlp/`).

Reference parity: deeplearning4j-nlp-parent (SURVEY §2.5) — SequenceVectors,
Word2Vec, ParagraphVectors, GloVe, vocab construction + Huffman coding,
tokenization pipeline (sentence + document iterators, preprocessor stack),
word-vector serialization.

The reference trains embeddings with N hogwild threads doing lock-free
scatter updates into shared syn0/syn1 (SURVEY §3.5). Here each step is
ONE batch of (center, context, negatives) indices on the device
(`device=`, the CUDA device unless the caller asks for the CPU):
embedding gathers → sampled-softmax loss → the rows' summed gradients →
SGD. All randomness stays numpy on the host, in the JAX package's order,
so a fit here and a fit there from one seed see the same batches. The
generic trainer is `SequenceVectors` — Word2Vec, ParagraphVectors, and
DeepWalk all share it. The text pipeline (tokenizers, iterators, stop
words, bag of words, the CJK factories and the annotators) is the JAX
package's own host code, copied.

The package exports the JAX package's `__all__`, resolved at first use.
"""

from deeplearning4j_tpu_torch import _lazy_getattr

_EXPORTS = {
    "nlp.vocab": (
        "VocabCache", "VocabWord", "build_vocab", "HuffmanTree",
    ),
    "nlp.tokenization": (
        "DefaultTokenizerFactory", "CommonPreprocessor", "SentenceIterator",
        "CollectionSentenceIterator", "FileSentenceIterator",
        "LineSentenceIterator", "BasicLineIterator", "StreamLineIterator",
        "AggregatingSentenceIterator", "MultipleEpochsSentenceIterator",
        "PrefetchingSentenceIterator", "LabelAwareSentenceIterator",
        "LabelAwareListSentenceIterator",
    ),
    "nlp.stopwords": (
        "StopWords", "StopWordsRemovalPreprocessor",
    ),
    "nlp.documents": (
        "DocumentIterator", "CollectionDocumentIterator",
        "FileDocumentIterator", "LabelAwareIterator", "LabelledDocument",
        "LabelsSource", "SimpleLabelAwareIterator",
        "CollectionLabelAwareIterator", "FilenamesLabelAwareIterator",
        "LabelAwareDocumentIterator", "SentencePreProcessor",
        "LowCasePreProcessor", "StripSpecialCharsPreProcessor",
        "CompositePreProcessor", "FunctionPreProcessor",
    ),
    "nlp.sequence_vectors": (
        "SequenceVectors", "SequenceElement", "Sequence",
        "AbstractSequenceIterator", "ElementsLearningAlgorithm", "SkipGram",
        "CBOW", "LEARNING_ALGORITHMS",
    ),
    "nlp.word2vec": (
        "Word2Vec",
    ),
    "nlp.paragraph_vectors": (
        "ParagraphVectors",
    ),
    "nlp.glove": (
        "Glove",
    ),
    "nlp.serializer": (
        "write_word_vectors", "read_word_vectors", "write_binary",
        "read_binary",
    ),
    "nlp.bow": (
        "BagOfWordsVectorizer", "TfidfVectorizer",
    ),
}
_LAZY = {n: (f"deeplearning4j_tpu_torch.{m}", n)
         for m, names in _EXPORTS.items() for n in names}


__getattr__ = _lazy_getattr(__name__, _LAZY)

__all__ = list(_LAZY)
