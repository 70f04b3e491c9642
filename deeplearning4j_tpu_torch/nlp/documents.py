"""Document iterators, label sources, and the sentence-preprocessor stack.

A copy of `deeplearning4j_tpu/nlp/documents.py`,
which imports nothing of JAX: the port keeps its own.

Reference parity: `text/documentiterator/` (11 impls — DocumentIterator,
FileDocumentIterator, LabelAwareIterator, LabelledDocument, LabelsSource,
SimpleLabelAwareIterator, FilenamesLabelAwareIterator, ...) and
`text/sentenceiterator/SentencePreProcessor` + the preprocessor
implementations the sentence/document iterators compose.

These feed ParagraphVectors/Word2Vec exactly as in the reference: a
document iterator yields `LabelledDocument`s whose content is tokenized by
the model's TokenizerFactory; `LabelsSource` generates/stores the document
labels that become doc-vector keys.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Iterable, Iterator, List, Optional, Sequence


# ----------------------------------------------------- preprocessor stack
class SentencePreProcessor:
    """Reference: `sentenceiterator/SentencePreProcessor` SPI."""

    def pre_process(self, sentence: str) -> str:
        return sentence


class LowCasePreProcessor(SentencePreProcessor):
    """Reference: prefetch/LowCasePreProcessor."""

    def pre_process(self, sentence: str) -> str:
        return sentence.lower()


class StripSpecialCharsPreProcessor(SentencePreProcessor):
    """Strip everything but word chars and whitespace (reference:
    StringCleaning.stripPunct used by the default pipelines)."""

    _RE = re.compile(r"[^\w\s]")

    def pre_process(self, sentence: str) -> str:
        return self._RE.sub("", sentence)


class CompositePreProcessor(SentencePreProcessor):
    """Apply a chain of preprocessors in order (reference: the
    preprocessor stacking done by TextPipeline)."""

    def __init__(self, *pres: SentencePreProcessor):
        self.pres = list(pres)

    def pre_process(self, sentence: str) -> str:
        for p in self.pres:
            sentence = p.pre_process(sentence)
        return sentence


class FunctionPreProcessor(SentencePreProcessor):
    """Wrap any str→str callable as a preprocessor."""

    def __init__(self, fn: Callable[[str], str]):
        self.fn = fn

    def pre_process(self, sentence: str) -> str:
        return self.fn(sentence)


# ------------------------------------------------------------- documents
@dataclasses.dataclass
class LabelledDocument:
    """Reference: `documentiterator/LabelledDocument` (content + labels)."""

    content: str
    labels: List[str] = dataclasses.field(default_factory=list)

    @property
    def label(self) -> Optional[str]:
        return self.labels[0] if self.labels else None


class LabelsSource:
    """Reference: `documentiterator/LabelsSource` — generates sequential
    labels (template with %d) and/or records every label seen."""

    def __init__(self, template: str = "DOC_%d",
                 labels: Optional[Sequence[str]] = None):
        self.template = template
        self._labels: List[str] = list(labels) if labels else []
        self._counter = 0

    def next_label(self) -> str:
        label = self.template % self._counter
        self._counter += 1
        self._labels.append(label)
        return label

    def store_label(self, label: str) -> None:
        if label not in self._labels:
            self._labels.append(label)

    @property
    def labels(self) -> List[str]:
        return list(self._labels)

    def reset(self) -> None:
        self._counter = 0
        self._labels = []


class DocumentIterator:
    """Reference: `documentiterator/DocumentIterator` SPI — a stream of
    documents (whole texts, vs sentence iterators' single sentences)."""

    def __iter__(self) -> Iterator[str]:
        raise NotImplementedError

    def reset(self):
        pass


class CollectionDocumentIterator(DocumentIterator):
    def __init__(self, docs: Sequence[str],
                 pre: Optional[SentencePreProcessor] = None):
        self._docs = list(docs)
        self._pre = pre

    def __iter__(self):
        for d in self._docs:
            yield self._pre.pre_process(d) if self._pre else d


class FileDocumentIterator(DocumentIterator):
    """One document per FILE under a path (the reference's
    FileDocumentIterator contract; FileSentenceIterator is per-line)."""

    def __init__(self, path: str,
                 pre: Optional[SentencePreProcessor] = None):
        self.path = path
        self._pre = pre

    def _files(self) -> List[str]:
        if os.path.isfile(self.path):
            return [self.path]
        return sorted(
            os.path.join(d, f)
            for d, _, fs in os.walk(self.path) for f in fs)

    def __iter__(self):
        for fp in self._files():
            with open(fp, "r", errors="replace") as f:
                text = f.read()
            yield self._pre.pre_process(text) if self._pre else text


# ---------------------------------------------------- label-aware layer
class LabelAwareIterator:
    """Reference: `documentiterator/LabelAwareIterator` SPI — yields
    LabelledDocuments and exposes the LabelsSource."""

    def __iter__(self) -> Iterator[LabelledDocument]:
        raise NotImplementedError

    @property
    def labels_source(self) -> LabelsSource:
        raise NotImplementedError

    def reset(self):
        pass


class SimpleLabelAwareIterator(LabelAwareIterator):
    """Wrap any iterable of LabelledDocuments (reference:
    SimpleLabelAwareIterator)."""

    def __init__(self, documents: Iterable[LabelledDocument]):
        self._docs = list(documents)
        self._source = LabelsSource()
        for d in self._docs:
            for l in d.labels:
                self._source.store_label(l)

    def __iter__(self):
        return iter(self._docs)

    @property
    def labels_source(self) -> LabelsSource:
        return self._source


class CollectionLabelAwareIterator(SimpleLabelAwareIterator):
    """Texts + auto-generated (or provided) labels."""

    def __init__(self, docs: Sequence[str],
                 labels: Optional[Sequence[str]] = None,
                 template: str = "DOC_%d"):
        src = LabelsSource(template)
        out = []
        for i, text in enumerate(docs):
            label = labels[i] if labels is not None else src.next_label()
            out.append(LabelledDocument(content=text, labels=[label]))
        super().__init__(out)
        if labels is None:
            self._source = src

    @property
    def labels_source(self) -> LabelsSource:
        return self._source


class FilenamesLabelAwareIterator(LabelAwareIterator):
    """One document per file, labelled by its filename (reference:
    FilenamesLabelAwareIterator)."""

    def __init__(self, path: str, *, absolute_labels: bool = False):
        self._inner = FileDocumentIterator(path)
        self.absolute_labels = absolute_labels
        self._source = LabelsSource()

    def __iter__(self):
        # single directory walk: label and content come from the SAME file
        # listing (a concurrent file add/remove can't misalign them)
        for fp in self._inner._files():
            with open(fp, "r", errors="replace") as f:
                text = f.read()
            label = fp if self.absolute_labels else os.path.basename(fp)
            self._source.store_label(label)
            yield LabelledDocument(content=text, labels=[label])

    @property
    def labels_source(self) -> LabelsSource:
        return self._source


class LabelAwareDocumentIterator(LabelAwareIterator):
    """Adapter: plain DocumentIterator + generated labels →
    LabelAwareIterator (reference: DocumentIteratorConverter)."""

    def __init__(self, documents: DocumentIterator,
                 template: str = "DOC_%d"):
        self._docs = documents
        self._source = LabelsSource(template)

    def __iter__(self):
        # deterministic labels across passes: each iteration restarts the
        # generator, so pass 2 re-yields D0, D1, ... for the same documents
        self._source.reset()
        for text in self._docs:
            yield LabelledDocument(content=text,
                                   labels=[self._source.next_label()])

    @property
    def labels_source(self) -> LabelsSource:
        return self._source

    def reset(self):
        self._docs.reset()
        self._source.reset()
