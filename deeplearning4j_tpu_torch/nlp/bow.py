"""Bag-of-words / TF-IDF vectorizers.

A copy of `deeplearning4j_tpu/nlp/bow.py`,
which imports nothing of JAX: the port keeps its own.

Reference parity: `bagofwords/vectorizer/` (BagOfWordsVectorizer,
TfidfVectorizer) — corpus → fixed-width count/tf-idf feature arrays keyed by
a VocabCache.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory, TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, build_vocab


class BagOfWordsVectorizer:
    def __init__(self, *, min_count: int = 1,
                 tokenizer_factory: Optional[TokenizerFactory] = None):
        self.min_count = min_count
        self.tf = tokenizer_factory or DefaultTokenizerFactory()
        self.vocab: Optional[VocabCache] = None

    def _tokens(self, texts):
        return [self.tf.create(t).tokens() if isinstance(t, str) else list(t)
                for t in texts]

    def fit(self, texts: Sequence) -> "BagOfWordsVectorizer":
        self.vocab = build_vocab(self._tokens(texts), min_count=self.min_count)
        return self

    def transform(self, texts: Sequence) -> np.ndarray:
        out = np.zeros((len(texts), len(self.vocab)), np.float32)
        for r, toks in enumerate(self._tokens(texts)):
            for t in toks:
                i = self.vocab.index_of(t)
                if i >= 0:
                    out[r, i] += 1
        return out

    def fit_transform(self, texts: Sequence) -> np.ndarray:
        return self.fit(texts).transform(texts)


class TfidfVectorizer(BagOfWordsVectorizer):
    """Reference: `bagofwords/vectorizer/TfidfVectorizer` (tf · log(N/df))."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.idf: Optional[np.ndarray] = None

    def fit(self, texts: Sequence) -> "TfidfVectorizer":
        toks = self._tokens(texts)
        self.vocab = build_vocab(toks, min_count=self.min_count)
        df = np.zeros(len(self.vocab), np.float64)
        for t in toks:
            for i in {self.vocab.index_of(w) for w in t}:
                if i >= 0:
                    df[i] += 1
        self.idf = np.log((1 + len(texts)) / (1 + df)).astype(np.float32) + 1
        return self

    def transform(self, texts: Sequence) -> np.ndarray:
        counts = super().transform(texts)
        tf = counts / np.maximum(counts.sum(axis=1, keepdims=True), 1)
        return tf * self.idf
