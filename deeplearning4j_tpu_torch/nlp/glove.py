"""GloVe — co-occurrence counting + weighted-least-squares embedding fit
(port of `deeplearning4j_tpu/nlp/glove.py`).

Reference parity: `models/glove/Glove.java` + `models/glove/count/`
(co-occurrence map) and the AdaGrad element updates in
`models/embeddings/learning/impl/elements/GloVe.java`. Counting stays on
host (hash map, like the reference's CountMap); the optimization is batched
AdaGrad in one device step over (i, j, X_ij) triples.

AdaGrad squares each row's SUMMED gradient: a word that occurs twice in
a batch (as `i` or as `j`) adds (g1 + g2)², not g1² + g2². The step sums
every contribution into a dense gradient table first (`index_add_`),
then updates history and parameters over the whole table, as the JAX
step does: untouched rows come back bit-equal.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.sequence_vectors import _table_grad, _to_host
from deeplearning4j_tpu_torch.nlp.vocab import build_vocab
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec, _as_token_lists


def _glove_step(params, hist, ii, jj, x, x_max, alpha, lr):
    """One AdaGrad step on sum(f(x) (w_i·c_j + b_i + c_j - log x)²)."""
    w, wc, b, bc = params["w"], params["wc"], params["b"], params["bc"]
    wi, wcj = w[ii], wc[jj]
    pred = torch.sum(wi * wcj, dim=1) + b[ii] + bc[jj]
    fw = torch.clamp((x / x_max) ** alpha, max=1.0)
    gpred = fw * (2.0 * (pred - torch.log(torch.clamp(x, min=1e-10))))
    grads = {
        "w": _table_grad(w, ii, gpred[:, None] * wcj),
        "wc": _table_grad(wc, jj, gpred[:, None] * wi),
        "b": torch.zeros_like(b).index_add_(0, ii, gpred),
        "bc": torch.zeros_like(bc).index_add_(0, jj, gpred),
    }
    new_hist = {k: hist[k] + grads[k] * grads[k] for k in params}
    new_params = {k: params[k] - lr * grads[k] / torch.sqrt(new_hist[k])
                  for k in params}
    return new_params, new_hist


class Glove(Word2Vec):
    def __init__(self, *, x_max: float = 100.0, alpha: float = 0.75, **kw):
        kw.setdefault("learning_rate", 0.05)
        super().__init__(**kw)
        self.x_max = x_max
        self.alpha = alpha

    def fit(self, corpus) -> "Glove":
        sentences = _as_token_lists(corpus, self.tokenizer_factory)
        self.vocab = build_vocab(sentences, min_count=self.min_count)
        V, D = len(self.vocab), self.layer_size

        # ---- co-occurrence accumulation (reference: CountMap/RoundCount)
        cooc: Dict[Tuple[int, int], float] = defaultdict(float)
        for s in sentences:
            idx = [self.vocab.index_of(w) for w in s]
            idx = [i for i in idx if i >= 0]
            for pos, ci in enumerate(idx):
                lo = max(0, pos - self.window)
                for off, cj in enumerate(idx[lo:pos]):
                    dist = pos - (lo + off)
                    w = 1.0 / dist
                    a, b = (ci, cj) if ci <= cj else (cj, ci)
                    cooc[(a, b)] += w
        if not cooc:
            raise ValueError("No co-occurrences")
        pairs = np.array(list(cooc.keys()), dtype=np.int64)
        xij = np.array(list(cooc.values()), dtype=np.float32)

        rng = np.random.default_rng(self.seed)
        params = {
            "w": self._to_device((rng.random((V, D), dtype=np.float32) - .5)
                                 / D),
            "wc": self._to_device((rng.random((V, D), dtype=np.float32) - .5)
                                  / D),
            "b": torch.zeros((V,), dtype=torch.float32, device=self.device),
            "bc": torch.zeros((V,), dtype=torch.float32, device=self.device),
        }
        hist = {k: torch.ones_like(a) * 1e-8 for k, a in params.items()}
        x_max, alpha, lr = self.x_max, self.alpha, self.lr

        for _ in range(max(self.epochs, 1)):
            order = rng.permutation(len(xij))
            for lo in range(0, len(order), self.batch_size):
                sel = order[lo:lo + self.batch_size]
                params, hist = _glove_step(
                    params, hist, self._to_device(pairs[sel, 0]),
                    self._to_device(pairs[sel, 1]),
                    self._to_device(xij[sel]), x_max, alpha, lr)

        self.syn0 = _to_host(params["w"] + params["wc"])  # standard sum
        self._syn1 = _to_host(params["wc"])
        return self
