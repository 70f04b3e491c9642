"""Distributed embedding training — dl4j-spark-nlp parity (port of
`deeplearning4j_tpu/nlp/distributed.py`).

Reference parity: `spark/models/embeddings/word2vec/` + `spark/text/
functions/TextPipeline.java` / `CountCumSum.java` (SURVEY §2.4): the
reference tokenizes an RDD, merges per-partition word counts through a
Spark accumulator, broadcasts the vocab, trains word vectors per partition,
and averages the vectors.

The same algorithm without Spark — partitions are logical workers on
the host; counts merge in-process (accumulator ↦ Counter reduction);
each round every worker advances its own copy of (syn0, syn1) over its
partition with the SAME device steps local Word2Vec uses (hogwild ↦
data-parallel local SGD; a step never writes the tables it was given),
and the copies are averaged between rounds — a plain sum over the
workers' tables in worker order, then the division, as the JAX
package's `tree_map` average — the ParameterAveragingTrainingMaster
scheme applied to embedding matrices.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence

import numpy as np

from deeplearning4j_tpu_torch.nlp.sequence_vectors import _to_host
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec, _as_token_lists


def merge_partition_counts(counters: Sequence[Counter], min_count: int
                           ) -> VocabCache:
    """Accumulator-equivalent: merge per-partition token counts into one
    vocab (reference: TextPipeline word-count accumulator + CountCumSum)."""
    merged: Counter = Counter()
    for c in counters:
        merged.update(c)
    vocab = VocabCache()
    for word, cnt in sorted(merged.items(), key=lambda kv: (-kv[1], kv[0])):
        if cnt >= min_count:
            vocab.add(VocabWord(word=word, count=int(cnt)))
    return vocab


class DistributedWord2Vec(Word2Vec):
    """Word2Vec over partitioned corpora with per-round vector averaging.

    Same query API as Word2Vec; `fit` distributes. num_workers partitions
    are trained independently each round from the current shared vectors,
    then syn0/syn1 are averaged — exactly the reference Spark scheme
    (per-partition training + vector averaging), with each worker's inner
    loop the batched device step rather than hogwild threads."""

    def __init__(self, *, num_workers: int = 4, **kwargs):
        super().__init__(**kwargs)
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.num_workers = num_workers

    def fit(self, corpus) -> "DistributedWord2Vec":
        sentences = _as_token_lists(corpus, self.tokenizer_factory)
        parts: List[List] = [sentences[i::self.num_workers]
                             for i in range(self.num_workers)]
        parts = [p for p in parts if p]
        # Phase 1: per-partition counts → accumulator merge → global vocab.
        self.vocab = merge_partition_counts(
            [Counter(w for s in part for w in s) for part in parts],
            self.min_count)
        if len(self.vocab) == 0:
            raise ValueError("Empty vocabulary (min_count too high?)")

        rng = np.random.default_rng(self.seed)
        setup = self._setup(rng)
        params = setup["params"]
        part_idx = [self._index_sentences(p) for p in parts]
        total_est = sum(len(s) for pi in part_idx for s in pi) \
            * self.window * max(self.epochs, 1)
        seen = 0
        # Phase 2: rounds of per-partition training + vector averaging.
        for epoch in range(self.epochs):
            results = []
            advanced = 0
            for w, pi in enumerate(part_idx):
                wrng = np.random.default_rng(
                    self.seed + 1009 * (epoch + 1) + w)
                p_w, seen_w = self._run_epoch(
                    params, pi, setup, wrng, seen, total_est)
                results.append(p_w)
                advanced += seen_w - seen
            # All workers' pairs count toward the global LR decay — total_est
            # sums across partitions, so `seen` must too, or the linear decay
            # would stall at ~1/num_workers of its schedule.
            seen += advanced
            n = len(results)
            params = {k: sum(r[k] for r in results) / n for k in params}
        self.syn0 = _to_host(params["syn0"])
        self._syn1 = _to_host(params["syn1"])
        return self
