"""SequenceVectors — the generic sequence-embedding trainer SPI (port of
`deeplearning4j_tpu/nlp/sequence_vectors.py`).

Reference parity: `models/sequencevectors/SequenceVectors.java:51` — ONE
trainer (vocab build → Huffman/negative-sampling tables → training loop)
shared by every embedding model (Word2Vec, ParagraphVectors, DeepWalk,
Node2Vec), parameterized by an `ElementsLearningAlgorithm` /
`SequenceLearningAlgorithm` SPI (`:58-59`).

The host code is the JAX package's, line for line: vocab, Huffman
tables, subsampling, window pairs, the permutation and the negatives
all draw from one `np.random.default_rng(seed)` in the same order, so a
fit here and a fit there from the same seed see the same batches. Each
learning algorithm contributes ONE step over a batch of ~10⁴ pairs on
the device (`device=`, the CUDA device unless the caller asks for the
CPU): gathers of the rows, the gradient of the summed loss written out
by hand (d softplus(x)/dx is sigmoid(x)), the per-pair contributions
summed into a dense gradient table by `index_add_`, and the SGD update
`p - lr * g` over the whole table (`lr` a float32 value, as the JAX
step's `jnp.asarray(lr, jnp.float32)`), as the JAX step's autodiff
scatter-add and `tree_map` do: untouched rows come back bit-equal, and a
row hit twice in a batch has its contributions summed before its one
subtraction. A step is functional (new tables out, the old ones
untouched), so the distributed trainer can start every worker from the
same tables. The tables come back to the host as numpy arrays after the
fit (`syn0`, `_syn1`), and every query runs on them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence as Seq, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.vocab import (
    HuffmanTree, VocabCache, VocabWord, build_vocab, unigram_table,
)
from deeplearning4j_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class SequenceElement:
    """Reference: `sequencevectors/sequence/SequenceElement` — anything
    with a label and a frequency can be embedded (words, vertices,
    labels)."""

    label: str
    count: int = 1


@dataclasses.dataclass
class Sequence:
    """Reference: `sequencevectors/sequence/Sequence` — an ordered list of
    elements, optionally carrying sequence-level labels (doc2vec)."""

    elements: List[str]
    labels: List[str] = dataclasses.field(default_factory=list)


class AbstractSequenceIterator:
    """Reference: `interfaces/SequenceIterator` +
    AbstractSequenceIterator.Builder — adapts any iterable of sequences."""

    def __init__(self, sequences: Iterable):
        self._seqs = list(sequences)

    def __iter__(self):
        for s in self._seqs:
            yield s if isinstance(s, Sequence) else Sequence(list(s))

    def reset(self):
        pass


# ---------------------------------------------------------------- SPI
class ElementsLearningAlgorithm:
    """Reference: `learning/ElementsLearningAlgorithm` — pluggable
    per-element trainer. Implementations supply the device step."""

    name = "abstract"

    def make_step(self, model: "SequenceVectors", hs_tables=None):
        """Return a device step. Negative-sampling signature:
        step(params, centers, contexts, negatives, lr); hierarchical
        softmax: step(params, centers, contexts, lr)."""
        raise NotImplementedError


class SkipGram(ElementsLearningAlgorithm):
    """Center predicts context. Reference:
    `learning/impl/elements/SkipGram.java` (AggregateSkipGram batches)."""

    name = "skipgram"
    cbow = False

    def make_step(self, model, hs_tables=None):
        if model.hs:
            codes, points, lens = hs_tables
            return _hs_step(codes, points, lens, model.device)
        return _ns_step(cbow=self.cbow)


class CBOW(SkipGram):
    """Context predicts center. Reference:
    `learning/impl/elements/CBOW.java`."""

    name = "cbow"
    cbow = True


LEARNING_ALGORITHMS: Dict[str, type] = {
    "skipgram": SkipGram, "cbow": CBOW,
}


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _table_grad(like: torch.Tensor, rows: torch.Tensor,
                contrib: torch.Tensor) -> torch.Tensor:
    """The dense gradient of a table gathered at `rows`: each row's
    contributions summed (the transpose of the gather)."""
    return torch.zeros_like(like).index_add_(
        0, rows.reshape(-1), contrib.reshape(-1, like.shape[1]))


def _ns_terms(h, w_pos, w_neg):
    """Scores of the positive target and the negatives and their
    gradients under `sum(softplus(-pos)) + sum(softplus(neg))` (SUM, not
    mean: the per-pair update magnitude matches the reference's
    per-example SGD). d softplus(x)/dx is sigmoid(x) at every x
    (`jax.nn.softplus` is `logaddexp(x, 0)`; `F.softplus` turns linear
    past its threshold). Returns (d/dh [B,D], d/dpos [B], d/dneg
    [B,K])."""
    pos = torch.sum(h * w_pos, dim=1)
    neg = torch.sum(h[:, None, :] * w_neg, dim=2)
    gp = -torch.sigmoid(-pos)
    gn = torch.sigmoid(neg)
    gh = gp[:, None] * w_pos + torch.sum(gn[:, :, None] * w_neg, dim=1)
    return gh, gp, gn


def _ns_syn1_grad(s1, h, tgt, negatives, gp, gn):
    g1 = _table_grad(s1, tgt, gp[:, None] * h)
    return g1.index_add_(0, negatives.reshape(-1),
                         (gn[:, :, None] * h[:, None, :])
                         .reshape(-1, s1.shape[1]))


def _ns_step(cbow: bool):
    def step(params, centers, contexts, negatives, lr):
        s0, s1 = params["syn0"], params["syn1"]
        rows = contexts if cbow else centers
        tgt = centers if cbow else contexts
        h = s0[rows]
        gh, gp, gn = _ns_terms(h, s1[tgt], s1[negatives])
        g0 = _table_grad(s0, rows, gh)
        g1 = _ns_syn1_grad(s1, h, tgt, negatives, gp, gn)
        return {"syn0": s0 - lr * g0, "syn1": s1 - lr * g1}

    return step


def _hs_step(codes, points, lens, device):
    codes = torch.as_tensor(codes, device=device)
    points = torch.as_tensor(points, dtype=torch.int64, device=device)
    lens = torch.as_tensor(lens, dtype=torch.int64, device=device)
    steps = torch.arange(points.shape[1], device=device)

    def step(params, centers, contexts, lr):
        s0, s1 = params["syn0"], params["syn1"]
        h = s0[centers]                               # [B,D]
        pt = points[contexts]                         # [B,L]
        ln = lens[contexts]                           # [B]
        valid = steps[None, :] < ln[:, None]
        w = s1[pt]                                    # [B,L,D]
        logits = torch.sum(h[:, None, :] * w, dim=2)
        # code bit 1 → sigmoid target 0 (word2vec convention); padded
        # slots (point 0) are masked out of the loss: zero gradient
        up = codes[contexts] > 0
        z = torch.where(up, logits, -logits)
        gl = torch.where(valid, torch.where(up, 1.0, -1.0)
                         * torch.sigmoid(z), 0.0)
        gh = torch.sum(gl[:, :, None] * w, dim=1)
        g0 = _table_grad(s0, centers, gh)
        g1 = _table_grad(s1, pt, gl[:, :, None] * h[:, None, :])
        return {"syn0": s0 - lr * g0, "syn1": s1 - lr * g1}

    return step


# ------------------------------------------------------------- trainer
class SequenceVectors:
    """Reference: `SequenceVectors.java` Builder surface mapped to kwargs
    (`fit():187` = vocab build → Huffman → training). `device`: where the
    steps run, the CUDA device unless the caller passes `"cpu"` (no card
    and no explicit CPU raises)."""

    def __init__(self, *, layer_size: int = 100, window: int = 5,
                 min_count: int = 5, negative: int = 5,
                 hierarchic_softmax: bool = False,
                 subsampling: float = 1e-3, epochs: int = 1,
                 learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4,
                 batch_size: int = 8192, seed: int = 42,
                 dynamic_window: bool = True,
                 learning_algorithm="skipgram", device=None):
        self.device = resolve_device(device)
        self.layer_size = layer_size
        self.window = window
        self.min_count = min_count
        self.negative = negative
        self.hs = hierarchic_softmax
        self.subsampling = subsampling
        self.epochs = epochs
        self.lr = learning_rate
        self.min_lr = min_learning_rate
        self.batch_size = batch_size
        self.seed = seed
        self.dynamic_window = dynamic_window
        if isinstance(learning_algorithm, str):
            if learning_algorithm not in LEARNING_ALGORITHMS:
                raise ValueError(
                    f"Unknown learning algorithm {learning_algorithm!r}; "
                    f"known: {sorted(LEARNING_ALGORITHMS)}")
            learning_algorithm = LEARNING_ALGORITHMS[learning_algorithm]()
        self.algorithm: ElementsLearningAlgorithm = learning_algorithm
        self.vocab: Optional[VocabCache] = None
        self.syn0: Optional[np.ndarray] = None
        self._syn1: Optional[np.ndarray] = None
        # optional warm-start tables (DeepWalk.initialize() pre-allocates)
        self.initial_syn0: Optional[np.ndarray] = None
        self.initial_syn1: Optional[np.ndarray] = None

    # back-compat alias used by a few call sites / subclasses
    @property
    def cbow(self) -> bool:
        return getattr(self.algorithm, "cbow", False)

    # ------------------------------------------------------------ fitting
    def fit(self, sequences: Iterable,
            element_counts: Optional[Dict[str, int]] = None
            ) -> "SequenceVectors":
        """Train on sequences of string elements. `element_counts`
        overrides vocab frequencies (DeepWalk passes vertex degrees — the
        reference's GraphHuffman-over-degrees becomes the standard
        count-based Huffman path)."""
        seqs = [list(s.elements) if isinstance(s, Sequence) else list(s)
                for s in sequences]
        if element_counts is not None:
            self.vocab = VocabCache()
            for label, count in element_counts.items():
                self.vocab.add(VocabWord(word=str(label), count=int(count)))
        else:
            self.vocab = build_vocab(seqs, min_count=self.min_count)
        if len(self.vocab) == 0:
            raise ValueError("Empty vocabulary (min_count too high?)")
        return self._fit_engine(self._index_sequences(seqs))

    def fit_indexed(self, idx_sequences, counts) -> "SequenceVectors":
        """Fast path for sequences that are ALREADY vocab indices 0..V-1
        with per-index frequencies `counts` (DeepWalk's walk matrices) —
        skips the per-element string lookups entirely."""
        self.vocab = VocabCache()
        for i, c in enumerate(np.asarray(counts)):
            self.vocab.add(VocabWord(word=str(i), count=int(c)))
        idx = [np.asarray(s, np.int64) for s in idx_sequences]
        return self._fit_engine([s for s in idx if len(s) > 1])

    def _fit_engine(self, idx_sequences) -> "SequenceVectors":
        rng = np.random.default_rng(self.seed)
        setup = self._setup(rng)
        params = setup["params"]
        total_est = sum(len(s) for s in idx_sequences) * self.window \
            * max(self.epochs, 1)
        seen = 0
        for _ in range(self.epochs):
            params, seen = self._run_epoch(
                params, idx_sequences, setup, rng, seen, total_est)
        self.syn0 = _to_host(params["syn0"])
        self._syn1 = _to_host(params["syn1"])
        return self

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype), device=self.device)

    def _index_sequences(self, sequences):
        idx = [
            np.array([self.vocab.index_of(w) for w in s], dtype=np.int64)
            for s in sequences
        ]
        return [s[s >= 0] for s in idx if (s >= 0).sum() > 1]

    _index_sentences = _index_sequences  # word-flavored alias

    def _setup(self, rng=None):
        """Allocate syn0/syn1 + build the algorithm's device step from
        self.vocab. Shared by local fit() and the distributed trainer."""
        V, D = len(self.vocab), self.layer_size
        if rng is None:
            rng = np.random.default_rng(self.seed)
        syn0 = (self.initial_syn0 if self.initial_syn0 is not None
                else (rng.random((V, D), dtype=np.float32) - 0.5) / D)
        syn1 = np.zeros((V, D), dtype=np.float32)
        probs = unigram_table(self.vocab)
        counts = self.vocab.counts()
        total = counts.sum()
        hs_tables = None
        if self.hs:
            HuffmanTree(self.vocab)
            hs_tables = HuffmanTree.padded_codes(self.vocab)
            syn1 = np.zeros((max(V - 1, 1), D), dtype=np.float32)
        if self.initial_syn1 is not None:
            syn1 = self.initial_syn1
        step = self.algorithm.make_step(self, hs_tables)
        # subsampling keep probability (word2vec formula)
        t = self.subsampling
        freq = counts / max(total, 1)
        keep = (np.sqrt(freq / t) + 1) * (t / np.maximum(freq, 1e-12)) \
            if t > 0 else np.ones(V)
        params = {"syn0": self._to_device(syn0, np.float32),
                  "syn1": self._to_device(syn1, np.float32)}
        return {"params": params, "keep": np.clip(keep, 0, 1),
                "probs": probs, "step": step}

    def _run_epoch(self, params, idx_sequences, setup, rng, seen, total_est):
        """One pass over idx_sequences; returns (params, seen)."""
        keep, probs, step = setup["keep"], setup["probs"], setup["step"]
        centers, contexts = self._generate_pairs(idx_sequences, keep, rng)
        order = rng.permutation(len(centers))
        centers, contexts = centers[order], contexts[order]
        for lo in range(0, len(centers), self.batch_size):
            c = centers[lo:lo + self.batch_size]
            x = contexts[lo:lo + self.batch_size]
            # NOTE: the trailing partial batch trains at its natural size
            # — dropping it would silently skip data, and tiny corpora
            # would not train at all.
            frac = min(seen / max(total_est, 1), 1.0)
            lr = max(self.lr * (1.0 - frac), self.min_lr)
            if self.hs:
                params = step(params, self._to_device(c),
                              self._to_device(x), float(np.float32(lr)))
            else:
                negs = rng.choice(len(probs),
                                  size=(len(c), self.negative), p=probs)
                params = step(params, self._to_device(c),
                              self._to_device(x), self._to_device(negs),
                              float(np.float32(lr)))
            seen += len(c)
        return params, seen

    def _generate_pairs(self, idx_sequences, keep, rng
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """(center, context) pairs with frequency subsampling — vectorized
        host-side equivalent of the reference's per-thread sequence walk.
        dynamic_window=True shrinks each center's window uniformly (the
        word2vec convention); False uses the full window (DeepWalk)."""
        all_c, all_x = [], []
        for s in idx_sequences:
            if self.subsampling > 0:
                s = s[rng.random(len(s)) < keep[s]]
            n = len(s)
            if n < 2:
                continue
            if self.dynamic_window:
                b = rng.integers(1, self.window + 1, n)
            else:
                b = np.full(n, self.window)
            for off in range(1, self.window + 1):
                if n <= off:
                    break
                i = np.arange(n - off)
                m = b[i + off] >= off     # center i+off ← context i
                all_c.append(s[i + off][m])
                all_x.append(s[i][m])
                m = b[i] >= off           # center i ← context i+off
                all_c.append(s[i][m])
                all_x.append(s[i + off][m])
        if not all_c:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(all_c), np.concatenate(all_x)

    # ------------------------------------------------------------ queries
    def element_vector(self, label: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(label)
        return None if i < 0 else self.syn0[i]

    # word-flavored aliases (reference: WordVectors interface)
    word_vector = element_vector

    def similarity(self, a: str, b: str) -> float:
        """Reference: `WordVectors.similarity`."""
        va, vb = self.element_vector(a), self.element_vector(b)
        if va is None or vb is None:
            return float("nan")
        denom = np.linalg.norm(va) * np.linalg.norm(vb) + 1e-12
        return float(va @ vb / denom)

    def words_nearest(self, label_or_vec, n: int = 10) -> List[str]:
        """Reference: `WordVectors.wordsNearest`."""
        if isinstance(label_or_vec, str):
            v = self.element_vector(label_or_vec)
            exclude = {self.vocab.index_of(label_or_vec)}
            if v is None:
                return []
        else:
            v = np.asarray(label_or_vec, np.float32)
            exclude = set()
        norms = np.linalg.norm(self.syn0, axis=1) + 1e-12
        sims = self.syn0 @ v / (norms * (np.linalg.norm(v) + 1e-12))
        order = np.argsort(-sims)
        out = []
        for i in order:
            if i in exclude:
                continue
            out.append(self.vocab.word_at(int(i)))
            if len(out) >= n:
                break
        return out

    elements_nearest = words_nearest

    def accuracy(self, questions: Seq[Tuple[str, str, str, str]]) -> float:
        """Analogy accuracy (a:b :: c:d). Reference: Word2Vec accuracy
        tests."""
        good = total = 0
        for a, b, c, d in questions:
            va, vb, vc = (self.element_vector(w) for w in (a, b, c))
            if va is None or vb is None or vc is None:
                continue
            pred = self.words_nearest(vb - va + vc, 4)
            total += 1
            if d in pred:
                good += 1
        return good / max(total, 1)
