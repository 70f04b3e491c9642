"""ParagraphVectors (doc2vec): DM and DBOW (port of
`deeplearning4j_tpu/nlp/paragraph_vectors.py`).

Reference parity: `models/paragraphvectors/ParagraphVectors.java` (1,439
LoC) with sequence learning algorithms `impl/sequence/{DM,DBOW}.java` —
document/label vectors trained jointly with (DM) or instead of (DBOW) word
context, plus `inferVector` for unseen documents (gradient steps on a fresh
doc vector with frozen word tables).

The host code is the JAX package's (pairs, permutation, negatives and
the inferred vector's start from one numpy generator, in the same
order); the training step and `infer_vector`'s step run on the device
with their gradients written out, as `nlp/sequence_vectors.py`'s steps.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.sequence_vectors import (
    _ns_syn1_grad, _ns_terms, _table_grad, _to_host,
)
from deeplearning4j_tpu_torch.nlp.vocab import build_vocab, unigram_table
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec, _as_token_lists


def _infer_step_dm(dv, syn0, syn1, targets, negs, lr_):
    """One inferVector gradient step, DM flavour (doc + word context):
    h = (v + syn0[t]) / 2, so d/dv sums half of each row's d/dh."""
    h = 0.5 * (dv[None, :] + syn0[targets])
    gh, _, _ = _ns_terms(h, syn1[targets], syn1[negs])
    return dv - lr_ * torch.sum(0.5 * gh, dim=0)


def _infer_step_dbow(dv, syn0, syn1, targets, negs, lr_):
    """DBOW flavour: the doc vector alone predicts each target (syn0 is
    unused; the signature matches _infer_step_dm so callers dispatch on
    self.dm only)."""
    h = dv[None, :].expand(targets.shape[0], dv.shape[0])
    gh, _, _ = _ns_terms(h, syn1[targets], syn1[negs])
    return dv - lr_ * torch.sum(gh, dim=0)


class ParagraphVectors(Word2Vec):
    def __init__(self, *, dm: bool = True, **kw):
        kw.setdefault("min_count", 1)
        super().__init__(**kw)
        self.dm = dm
        self.doc_vectors: Optional[np.ndarray] = None
        self.labels: List[str] = []

    # ------------------------------------------------------------ fitting
    def fit(self, documents: Union[Sequence[str], Sequence[Sequence[str]]],
            labels: Optional[Sequence[str]] = None) -> "ParagraphVectors":
        from deeplearning4j_tpu_torch.nlp.documents import LabelAwareIterator

        if isinstance(documents, LabelAwareIterator):
            # reference: PV.Builder.iterate(LabelAwareIterator) — documents
            # carry their own labels (LabelsSource-backed)
            labelled = list(documents)
            labels = [d.label for d in labelled]
            documents = [d.content for d in labelled]
        docs = _as_token_lists(documents, self.tokenizer_factory)
        raw_labels = [
            (labels[i] if labels is not None and labels[i] is not None
             else f"DOC_{i}")
            for i in range(len(docs))]
        # One TRAINED VECTOR PER LABEL (reference semantics): repeated
        # labels share a vector, trained on all their documents' windows.
        self.labels = list(dict.fromkeys(raw_labels))
        label_ids = np.array([self.labels.index(l) for l in raw_labels],
                             dtype=np.int64)
        self.vocab = build_vocab(docs, min_count=self.min_count)
        V, D, N = len(self.vocab), self.layer_size, len(self.labels)
        rng = np.random.default_rng(self.seed)
        params = {
            "syn0": self._to_device((rng.random((V, D), dtype=np.float32)
                                     - .5) / D),
            "syn1": torch.zeros((V, D), dtype=torch.float32,
                                device=self.device),
            "docs": self._to_device((rng.random((N, D), dtype=np.float32)
                                     - .5) / D),
        }
        idx_docs = [
            np.array([self.vocab.index_of(w) for w in s], dtype=np.int64)
            for s in docs
        ]
        idx_docs = [s[s >= 0] for s in idx_docs]
        probs = unigram_table(self.vocab)
        step = self._make_pv_step()

        pairs = []  # (label_id, center, context)
        for d, s in enumerate(idx_docs):
            n = len(s)
            if n < 2:
                continue
            lid = label_ids[d]
            b = rng.integers(1, self.window + 1, n)
            for off in range(1, self.window + 1):
                if n <= off:
                    break
                i = np.arange(n - off)
                m = b[i + off] >= off
                pairs.append(np.stack([np.full(m.sum(), lid), s[i + off][m],
                                       s[i][m]], 1))
                m = b[i] >= off
                pairs.append(np.stack([np.full(m.sum(), lid), s[i][m],
                                       s[i + off][m]], 1))
        all_pairs = np.concatenate(pairs) if pairs else np.zeros((0, 3), np.int64)

        for epoch in range(self.epochs):
            order = rng.permutation(len(all_pairs))
            shuffled = all_pairs[order]
            frac_base = epoch / max(self.epochs, 1)
            for lo in range(0, len(shuffled), self.batch_size):
                chunk = shuffled[lo:lo + self.batch_size]
                if len(chunk) < 8:
                    continue
                negs = rng.choice(len(probs),
                                  size=(len(chunk), self.negative), p=probs)
                lr = max(self.lr * (1 - frac_base), self.min_lr)
                params = step(params, self._to_device(chunk[:, 0]),
                              self._to_device(chunk[:, 1]),
                              self._to_device(chunk[:, 2]),
                              self._to_device(negs),
                              float(np.float32(lr)))
        self.syn0 = _to_host(params["syn0"])
        self._syn1 = _to_host(params["syn1"])
        self.doc_vectors = _to_host(params["docs"])
        return self

    def _make_pv_step(self):
        dm = self.dm

        def step(params, doc_ids, centers, contexts, negatives, lr):
            docs, s0, s1 = params["docs"], params["syn0"], params["syn1"]
            dv = docs[doc_ids]                          # [B,D]
            if dm:
                h = 0.5 * (dv + s0[centers])            # DM: doc + word ctx
            else:
                h = dv                                  # DBOW: doc only
            # SUM: per-pair SGD semantics (see word2vec.py)
            gh, gp, gn = _ns_terms(h, s1[contexts], s1[negatives])
            g1 = _ns_syn1_grad(s1, h, contexts, negatives, gp, gn)
            gdoc = 0.5 * gh if dm else gh
            out = {"syn0": s0, "syn1": s1 - lr * g1,
                   "docs": docs - lr * _table_grad(docs, doc_ids, gdoc)}
            if dm:      # DBOW: syn0 takes no gradient (p - lr * 0 is p)
                out["syn0"] = s0 - lr * _table_grad(s0, centers, gdoc)
            return out

        return step

    # ------------------------------------------------------------ queries
    def doc_vector(self, label: str) -> Optional[np.ndarray]:
        try:
            return self.doc_vectors[self.labels.index(label)]
        except ValueError:
            return None

    def similarity_to_label(self, doc_a: str, doc_b: str) -> float:
        va, vb = self.doc_vector(doc_a), self.doc_vector(doc_b)
        if va is None or vb is None:
            return float("nan")
        return float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb) + 1e-12))

    def infer_vector(self, text: Union[str, Sequence[str]], *,
                     steps: int = 50, lr: float = 0.05) -> np.ndarray:
        """Reference: `ParagraphVectors.inferVector` — gradient-fit a fresh
        doc vector against frozen word tables."""
        tokens = (self.tokenizer_factory.create(text).tokens()
                  if isinstance(text, str) else list(text))
        idx = np.array([self.vocab.index_of(w) for w in tokens])
        idx = idx[idx >= 0]
        if len(idx) == 0:
            return np.zeros(self.layer_size, np.float32)
        rng = np.random.default_rng(self.seed)
        dv = self._to_device((rng.random(self.layer_size,
                                         dtype=np.float32) - .5)
                             / self.layer_size)
        syn0 = self._to_device(self.syn0)
        syn1 = self._to_device(self._syn1)
        probs = unigram_table(self.vocab)
        targets = self._to_device(idx)
        step_fn = _infer_step_dm if self.dm else _infer_step_dbow

        for s in range(steps):
            negs = rng.choice(len(probs), size=(len(idx), self.negative),
                              p=probs)
            dv = step_fn(dv, syn0, syn1, targets, self._to_device(negs),
                         float(np.float32(lr * (1 - s / steps))))
        return _to_host(dv)
