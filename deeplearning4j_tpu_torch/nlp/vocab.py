"""Vocabulary construction + Huffman coding.

A copy of `deeplearning4j_tpu/nlp/vocab.py`,
which imports nothing of JAX: the port keeps its own.

Reference parity: `models/word2vec/wordstore/` (VocabCache, VocabConstructor,
VocabularyHolder) and Huffman tree building in
`models/word2vec/Huffman.java` — word counts, min-frequency pruning,
special tokens, binary Huffman codes/points for hierarchical softmax.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class VocabWord:
    """Reference: `models/word2vec/VocabWord`."""

    word: str
    count: int = 0
    index: int = -1
    code: Optional[List[int]] = None    # Huffman code bits
    points: Optional[List[int]] = None  # Huffman inner-node indices


class VocabCache:
    """Reference: `wordstore/VocabCache` — index/word/count store."""

    def __init__(self):
        self.words: List[VocabWord] = []
        self._index: Dict[str, int] = {}
        self.total_count = 0

    def add(self, vw: VocabWord) -> None:
        vw.index = len(self.words)
        self.words.append(vw)
        self._index[vw.word] = vw.index
        self.total_count += vw.count

    def __contains__(self, word: str) -> bool:
        return word in self._index

    def __len__(self) -> int:
        return len(self.words)

    def index_of(self, word: str) -> int:
        return self._index.get(word, -1)

    def word_at(self, idx: int) -> str:
        return self.words[idx].word

    def count_of(self, word: str) -> int:
        i = self.index_of(word)
        return self.words[i].count if i >= 0 else 0

    def counts(self) -> np.ndarray:
        return np.array([w.count for w in self.words], dtype=np.int64)


def build_vocab(sentences: Iterable[Sequence[str]], *, min_count: int = 5,
                max_size: Optional[int] = None) -> VocabCache:
    """Corpus scan → pruned, frequency-sorted vocab. Reference:
    `wordstore/inmemory/VocabConstructor` (min word frequency)."""
    counts = Counter()
    for s in sentences:
        counts.update(s)
    vocab = VocabCache()
    items = [(w, c) for w, c in counts.items() if c >= min_count]
    items.sort(key=lambda t: (-t[1], t[0]))
    if max_size:
        items = items[:max_size]
    for w, c in items:
        vocab.add(VocabWord(word=w, count=c))
    return vocab


class HuffmanTree:
    """Binary Huffman coding over vocab counts. Reference:
    `models/word2vec/Huffman.java` — assigns each word a bit code and the
    list of inner-node indices (points) on its root path, used by
    hierarchical softmax."""

    def __init__(self, vocab: VocabCache):
        n = len(vocab)
        self.n_inner = max(n - 1, 1)
        if n == 0:
            return
        heap: List[Tuple[int, int]] = [(w.count, i) for i, w in
                                       enumerate(vocab.words)]
        heapq.heapify(heap)
        parent = {}
        binary = {}
        next_id = n
        while len(heap) > 1:
            c1, i1 = heapq.heappop(heap)
            c2, i2 = heapq.heappop(heap)
            parent[i1] = next_id
            parent[i2] = next_id
            binary[i1] = 0
            binary[i2] = 1
            heapq.heappush(heap, (c1 + c2, next_id))
            next_id += 1
        root = heap[0][1]
        for i, vw in enumerate(vocab.words):
            code, points = [], []
            node = i
            while node != root:
                code.append(binary[node])
                p = parent[node]
                points.append(p - n)  # inner-node index in [0, n-1)
                node = p
            vw.code = list(reversed(code))
            vw.points = list(reversed(points))

    @staticmethod
    def padded_codes(vocab: VocabCache, max_len: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(codes [V,L], points [V,L], lengths [V]) padded for batched
        hierarchical-softmax on device."""
        lens = np.array([len(w.code or []) for w in vocab.words])
        L = int(max_len or (lens.max() if len(lens) else 1))
        V = len(vocab)
        codes = np.zeros((V, L), dtype=np.int32)
        points = np.zeros((V, L), dtype=np.int32)
        for i, w in enumerate(vocab.words):
            c = (w.code or [])[:L]
            p = (w.points or [])[:L]
            codes[i, :len(c)] = c
            points[i, :len(p)] = p
        return codes, points, np.minimum(lens, L)


def unigram_table(vocab: VocabCache, power: float = 0.75) -> np.ndarray:
    """Negative-sampling distribution (counts^0.75) — reference: the unigram
    table in InMemoryLookupTable. Returned as a probability vector (we sample
    with np.random.choice instead of the reference's 100M-slot table)."""
    c = vocab.counts().astype(np.float64) ** power
    return (c / c.sum()).astype(np.float64)
