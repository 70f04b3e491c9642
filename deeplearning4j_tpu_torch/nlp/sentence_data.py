"""Sentence → tensor iterators for text classification (port of
`deeplearning4j_tpu/nlp/sentence_data.py`, on the port's `DataSet` and
`DataSetIterator`).

Reference parity: `iterator/CnnSentenceDataSetIterator.java` (SURVEY §2.5)
— tokenizes sentences, looks up word vectors, pads/truncates to a common
length, and emits (features, labels, feature-mask) DataSets for CNN or RNN
sentence classifiers. This is the glue of BASELINE config #3 ("Word2Vec +
LSTM sentiment"): a fitted Word2Vec supplies the lookup; the produced
tensors feed LSTM/CNN stacks directly.

The batches are host numpy arrays, as every iterator's: the fit loop
moves each to the net's device. A fixed `max_length` keeps every batch
the same shape; masking carries variable length, matching the recurrent
layers' mask-hold semantics.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory, TokenizerFactory,
)


class WordVectorLookup:
    """Minimal lookup protocol: anything with word_vector(word) -> vec|None
    and a layer_size (Word2Vec, ParagraphVectors, GloVe all qualify)."""

    def __init__(self, model):
        self._m = model
        dim = int(getattr(model, "layer_size", 0) or 0)
        if not dim:
            vocab = getattr(model, "vocab", None)
            if vocab is None or not len(vocab):
                raise ValueError("cannot infer embedding dim from model")
            dim = len(model.word_vector(vocab.word_at(0)))
        self.dim = dim

    def get(self, word: str) -> Optional[np.ndarray]:
        return self._m.word_vector(word)


class SentenceDataSetIterator(DataSetIterator):
    """Labelled sentences → ([B, T, E] features, [B, n_cls] labels,
    [B, T] mask) batches.

    format="rnn" emits [B, T, E] (LSTM input); format="cnn" emits
    [B, T, E, 1]-style NHWC image tensors for 1-D conv sentence models
    (the reference's CNN path)."""

    def __init__(self, sentences: Sequence[str], labels: Sequence[int], *,
                 word_vectors, num_classes: Optional[int] = None,
                 batch_size: int = 32, max_length: int = 64,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 fmt: str = "rnn"):
        if len(sentences) != len(labels):
            raise ValueError("sentences and labels length mismatch")
        if fmt not in ("rnn", "cnn"):
            raise ValueError(f"unknown format {fmt!r}")
        self.sentences = list(sentences)
        self.labels = list(int(l) for l in labels)
        self.lookup = (word_vectors if isinstance(word_vectors,
                                                  WordVectorLookup)
                       else WordVectorLookup(word_vectors))
        self.num_classes = num_classes or (max(self.labels) + 1)
        bad = [y for y in self.labels if not 0 <= y < self.num_classes]
        if bad:
            raise ValueError(
                f"labels outside [0, {self.num_classes}): {sorted(set(bad))}")
        self._batch = batch_size
        self.max_length = max_length
        self.tf = tokenizer_factory or DefaultTokenizerFactory()
        self.fmt = fmt
        self._pos = 0

    @property
    def batch_size(self):
        return self._batch

    @property
    def num_outcomes(self):
        return self.num_classes

    def reset(self):
        self._pos = 0

    def _encode(self, sentence: str) -> Tuple[np.ndarray, int]:
        toks = self.tf.create(sentence).tokens()
        vecs: List[np.ndarray] = []
        for t in toks:
            v = self.lookup.get(t)
            if v is not None:
                vecs.append(np.asarray(v, np.float32))
            if len(vecs) == self.max_length:
                break
        out = np.zeros((self.max_length, self.lookup.dim), np.float32)
        if vecs:
            out[:len(vecs)] = np.stack(vecs)
        return out, len(vecs)

    def __next__(self) -> DataSet:
        if self._pos >= len(self.sentences):
            raise StopIteration
        lo = self._pos
        hi = min(lo + self._batch, len(self.sentences))
        self._pos = hi
        feats, masks, labs = [], [], []
        for s, y in zip(self.sentences[lo:hi], self.labels[lo:hi]):
            f, n = self._encode(s)
            feats.append(f)
            m = np.zeros((self.max_length,), np.float32)
            m[:max(n, 1)] = 1.0  # at least 1 valid step (all-OOV sentence)
            masks.append(m)
            labs.append(np.eye(self.num_classes, dtype=np.float32)[y])
        x = np.stack(feats)                       # [B, T, E]
        if self.fmt == "cnn":
            x = x[..., None]                      # [B, T, E, 1] NHWC
        return DataSet(x, np.stack(labs), features_mask=np.stack(masks))
