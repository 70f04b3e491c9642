"""Tokenization + sentence iteration pipeline.

A copy of `deeplearning4j_tpu/nlp/tokenization.py`,
which imports nothing of JAX: the port keeps its own.

Reference parity: `text/tokenization/` (TokenizerFactory SPI,
DefaultTokenizer, CommonPreprocessor lowercase/punct-strip) and
`text/sentenceiterator/` (13 impls in the reference; the load-bearing ones
here: collection, file, line).
"""

from __future__ import annotations

import os
import re
from typing import Callable, Iterable, Iterator, List, Optional, Sequence


class TokenPreProcess:
    """Reference: `tokenization/tokenizer/TokenPreProcess`."""

    def pre_process(self, token: str) -> str:
        return token


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits. Reference:
    `tokenizer/preprocessor/CommonPreprocessor`."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class Tokenizer:
    def __init__(self, text: str, pre: Optional[TokenPreProcess] = None):
        self._tokens = [t for t in text.split() if t]
        self._pre = pre

    def tokens(self) -> List[str]:
        out = []
        for t in self._tokens:
            if self._pre is not None:
                t = self._pre.pre_process(t)
            if t:
                out.append(t)
        return out


class TokenizerFactory:
    """Reference: `tokenization/tokenizerfactory/TokenizerFactory` SPI."""

    def __init__(self):
        self._pre: Optional[TokenPreProcess] = None

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self._pre = pre
        return self

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(text, self._pre)


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace tokenizer. Reference: DefaultTokenizerFactory."""


class NGramTokenizerFactory(TokenizerFactory):
    """Reference: NGramTokenizerFactory — emits n-grams joined by '_'."""

    def __init__(self, n_min: int = 1, n_max: int = 2):
        super().__init__()
        self.n_min, self.n_max = n_min, n_max

    def create(self, text: str) -> Tokenizer:
        base = Tokenizer(text, self._pre).tokens()
        out = []
        for n in range(self.n_min, self.n_max + 1):
            for i in range(len(base) - n + 1):
                out.append("_".join(base[i:i + n]))
        t = Tokenizer("", None)
        t._tokens = out
        return t


class SentenceIterator:
    """Reference: `text/sentenceiterator/SentenceIterator` (incl. the
    setPreProcessor seam — every sentence passes through it)."""

    _pre = None  # SentencePreProcessor

    def set_pre_processor(self, pre) -> "SentenceIterator":
        """Reference: SentenceIterator.setPreProcessor."""
        self._pre = pre
        return self

    def _apply_pre(self, sentence: str) -> str:
        return self._pre.pre_process(sentence) if self._pre else sentence

    def __iter__(self) -> Iterator[str]:
        raise NotImplementedError

    def reset(self):
        pass


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Sequence[str]):
        self._s = list(sentences)

    def __iter__(self):
        for s in self._s:
            yield self._apply_pre(s)


class FileSentenceIterator(SentenceIterator):
    """Iterate sentences (lines) of every file under a directory.
    Reference: FileSentenceIterator."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self):
        if os.path.isfile(self.path):
            files = [self.path]
        else:
            files = sorted(
                os.path.join(d, f)
                for d, _, fs in os.walk(self.path) for f in fs)
        for fp in files:
            with open(fp, "r", errors="replace") as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield self._apply_pre(line)


class LineSentenceIterator(FileSentenceIterator):
    """Reference: LineSentenceIterator (single file, line per sentence)."""


class BasicLineIterator(LineSentenceIterator):
    """Reference: BasicLineIterator — the workhorse single-file iterator."""


class StreamLineIterator(SentenceIterator):
    """Iterate lines of an already-open text stream (reference:
    StreamLineIterator). The stream is drained once; reset() replays the
    buffered lines."""

    def __init__(self, stream):
        self._lines = [l.strip() for l in stream if l.strip()]

    def __iter__(self):
        for l in self._lines:
            yield self._apply_pre(l)


class AggregatingSentenceIterator(SentenceIterator):
    """Chain several sentence iterators (reference:
    AggregatingSentenceIterator.Builder)."""

    def __init__(self, *iterators: SentenceIterator):
        self._its = list(iterators)

    def __iter__(self):
        for it in self._its:
            for s in it:
                yield self._apply_pre(s)

    def reset(self):
        for it in self._its:
            it.reset()


class MultipleEpochsSentenceIterator(SentenceIterator):
    """Replay an iterator N times (reference:
    MutipleEpochsSentenceIterator — [sic] the reference's typo)."""

    def __init__(self, inner: SentenceIterator, epochs: int):
        self._inner = inner
        self.epochs = epochs

    def __iter__(self):
        for _ in range(self.epochs):
            self._inner.reset()
            for s in self._inner:
                yield self._apply_pre(s)


class PrefetchingSentenceIterator(SentenceIterator):
    """Background-thread prefetch through a bounded queue (reference:
    PrefetchingSentenceIterator) — overlaps disk IO with tokenization."""

    def __init__(self, inner: SentenceIterator, buffer: int = 1024):
        self._inner = inner
        self.buffer = buffer

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.buffer)
        _END = object()
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that gives up when the consumer went away, so an
            # abandoned iteration can't leak a blocked producer thread
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for s in self._inner:
                    if not put(s):
                        return
                put(_END)
            except BaseException as e:  # surfaced to the consumer
                put(("__error__", e))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, tuple) and len(item) == 2 and \
                        item[0] == "__error__":
                    raise item[1]
                yield self._apply_pre(item)
        finally:
            stop.set()

    def reset(self):
        self._inner.reset()


class LabelAwareSentenceIterator(SentenceIterator):
    """Sentence iterator that also exposes the current sentence's label
    (reference: labelaware/LabelAwareSentenceIterator SPI)."""

    def current_label(self) -> str:
        raise NotImplementedError


class LabelAwareListSentenceIterator(LabelAwareSentenceIterator):
    """Sentences + parallel labels (reference:
    labelaware/LabelAwareListSentenceIterator)."""

    def __init__(self, sentences: Sequence[str], labels: Sequence[str]):
        if len(sentences) != len(labels):
            raise ValueError("sentences and labels must align")
        self._s = list(sentences)
        self._labels = list(labels)
        self._pos = -1

    def __iter__(self):
        for i, s in enumerate(self._s):
            self._pos = i
            yield self._apply_pre(s)

    def current_label(self) -> str:
        if self._pos < 0:
            raise RuntimeError(
                "current_label() before iteration — pull a sentence first")
        return self._labels[self._pos]


def tokenize_corpus(sentences: Iterable[str],
                    factory: Optional[TokenizerFactory] = None
                    ) -> List[List[str]]:
    factory = factory or DefaultTokenizerFactory()
    return [factory.create(s).tokens() for s in sentences]
