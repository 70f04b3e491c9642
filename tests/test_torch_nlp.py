"""The port's embedding trainers against the JAX package's, on the CPU.

Every draw of a fit (subsampling, window pairs, the permutation, the
negatives, the initial tables, GloVe's init, `infer_vector`'s start) is
numpy on the host in both packages, in the same order, so a port fit and
a JAX fit from one seed see the same batches: their tables must agree
after the whole fit within float32 tolerance, `TABLE_RTOL` of each
table's largest |value| (the two sum a batch's gradients in other
orders). The corpora are tiny and every fit has at most two distinct
batch sizes (JAX compiles a step for each). Also here: vocab, Huffman
and unigram tables equal, the steps' hand-written gradients against
float64 autograd of the JAX loss, GloVe's AdaGrad over repeated rows,
`SentenceDataSetIterator`'s arrays and word-vector files across the
packages."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nlp as J
from deeplearning4j_tpu.nlp import distributed as j_dist
from deeplearning4j_tpu.nlp import sentence_data as j_sd
from deeplearning4j_tpu_torch import nlp as P
from deeplearning4j_tpu_torch.nlp import distributed as p_dist
from deeplearning4j_tpu_torch.nlp import glove as p_glove
from deeplearning4j_tpu_torch.nlp import sentence_data as p_sd
from deeplearning4j_tpu_torch.nlp import sequence_vectors as p_sv

TABLE_RTOL = 1e-5     # of the table's largest |value|, float32
STEP_TOL = 1e-10      # hand-written gradients against float64 autograd


def corpus(n=240, topics=2, words=12, length=10, seed=0):
    rng = np.random.default_rng(seed)
    vocab = [[f"t{t}w{i}" for i in range(words)] for t in range(topics)]
    return [[vocab[t][i] for i in rng.integers(0, words, length)]
            for t in rng.integers(0, topics, n)]


def assert_tables(got, want, what):
    scale = float(np.abs(want).max())
    gap = float(np.abs(got - want).max())
    assert got.shape == want.shape and got.dtype == want.dtype, what
    assert gap <= TABLE_RTOL * scale, f"{what}: {gap} of {scale}"


# ------------------------------------------------------------------ vocab
def test_vocab_huffman_and_unigram_equal():
    c = corpus(60)
    jv, pv = J.build_vocab(c, min_count=2), P.build_vocab(c, min_count=2)
    assert [(w.word, w.count) for w in jv.words] == \
        [(w.word, w.count) for w in pv.words]
    J.HuffmanTree(jv)
    P.HuffmanTree(pv)
    assert [(w.code, w.points) for w in jv.words] == \
        [(w.code, w.points) for w in pv.words]
    for a, b in zip(J.HuffmanTree.padded_codes(jv),
                    P.HuffmanTree.padded_codes(pv)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(J.HuffmanTree.padded_codes(jv, max_len=3),
                    P.HuffmanTree.padded_codes(pv, max_len=3)):
        assert np.array_equal(a, b)
    from deeplearning4j_tpu.nlp.vocab import unigram_table as j_uni
    from deeplearning4j_tpu_torch.nlp.vocab import unigram_table as p_uni
    assert np.array_equal(j_uni(jv), p_uni(pv))
    assert np.array_equal(j_uni(jv, 0.5), p_uni(pv, 0.5))


# ---------------------------------------------------------------- the steps
def _logaddexp_loss(h, pos_w, neg_w):
    pos = torch.sum(h * pos_w, 1)
    neg = torch.einsum("bd,bkd->bk", h, neg_w)
    zero = torch.zeros((), dtype=h.dtype)
    return (torch.logaddexp(-pos, zero).sum()
            + torch.logaddexp(neg, zero).sum())


@pytest.mark.parametrize("cbow", [False, True])
def test_ns_step_is_sgd_on_the_summed_loss(cbow):
    """`_ns_step` against float64 autograd of JAX's loss (softplus as
    logaddexp(x, 0)), with scores out to ±40 and rows repeated within
    the batch: untouched rows bit-equal, a repeated row's contributions
    summed before its one update."""
    g = torch.Generator().manual_seed(0)
    V, D, B, K = 9, 6, 12, 3
    s0 = torch.randn(V, D, generator=g, dtype=torch.float64) * 3
    s1 = torch.randn(V, D, generator=g, dtype=torch.float64) * 3
    c = torch.tensor([0, 1, 1, 2, 3, 3, 3, 4, 5, 1, 0, 2])
    x = torch.tensor([1, 2, 0, 0, 4, 5, 4, 3, 3, 2, 2, 1])
    negs = torch.randint(0, 7, (B, K), generator=g)   # rows 7, 8 untouched
    lr = 0.025
    out = p_sv._ns_step(cbow)({"syn0": s0, "syn1": s1}, c, x, negs, lr)
    a0, a1 = s0.clone().requires_grad_(), s1.clone().requires_grad_()
    rows, tgt = (x, c) if cbow else (c, x)
    _logaddexp_loss(a0[rows], a1[tgt], a1[negs]).backward()
    np.testing.assert_allclose(out["syn0"], s0 - lr * a0.grad,
                               rtol=0, atol=STEP_TOL)
    np.testing.assert_allclose(out["syn1"], s1 - lr * a1.grad,
                               rtol=0, atol=STEP_TOL)
    assert torch.equal(out["syn1"][7:], s1[7:])
    untouched = sorted(set(range(V)) - set(rows.tolist()))
    assert torch.equal(out["syn0"][untouched], s0[untouched])


def test_hs_step_masks_padded_slots():
    """`_hs_step`: padded code slots point at inner node 0 and must take
    no gradient; the rest against float64 autograd of JAX's masked BCE."""
    c = corpus(40, words=9)
    vocab = P.build_vocab(c, min_count=1)
    P.HuffmanTree(vocab)
    codes, points, lens = P.HuffmanTree.padded_codes(vocab)
    V, D = len(vocab), 5
    # contexts whose root paths avoid inner node 0 but are padded
    ctx = [i for i in range(V) if 0 not in vocab.words[i].points
           and lens[i] < points.shape[1]]
    assert ctx
    g = torch.Generator().manual_seed(1)
    s0 = torch.randn(V, D, generator=g, dtype=torch.float64)
    s1 = torch.randn(V - 1, D, generator=g, dtype=torch.float64) * 4
    cen = torch.tensor([(i * 5) % V for i in range(len(ctx))])
    x = torch.tensor(ctx)
    step = p_sv._hs_step(codes, points, lens, torch.device("cpu"))
    out = step({"syn0": s0, "syn1": s1}, cen, x, 0.05)
    assert torch.equal(out["syn1"][0], s1[0])
    a0, a1 = s0.clone().requires_grad_(), s1.clone().requires_grad_()
    pt = torch.as_tensor(points, dtype=torch.int64)[x]
    cd = torch.as_tensor(codes)[x]
    valid = torch.arange(pt.shape[1])[None] < torch.as_tensor(lens)[x][:, None]
    logits = torch.einsum("bd,bld->bl", a0[cen], a1[pt])
    z = torch.where(cd > 0, logits, -logits)
    loss = torch.where(valid, torch.logaddexp(z, torch.zeros(())), 0.0).sum()
    loss.backward()
    np.testing.assert_allclose(out["syn0"], s0 - 0.05 * a0.grad, atol=STEP_TOL)
    np.testing.assert_allclose(out["syn1"], s1 - 0.05 * a1.grad, atol=STEP_TOL)


def test_glove_step_squares_each_rows_summed_gradient():
    """AdaGrad's history takes (g1 + g2)² for a row that two pairs of a
    batch hit, not g1² + g2²: the step against float64 autograd of JAX's
    loss with every row repeated, and against the per-occurrence form,
    which must differ."""
    g = torch.Generator().manual_seed(2)
    V, D = 4, 3
    params = {"w": torch.randn(V, D, generator=g, dtype=torch.float64),
              "wc": torch.randn(V, D, generator=g, dtype=torch.float64),
              "b": torch.randn(V, generator=g, dtype=torch.float64),
              "bc": torch.randn(V, generator=g, dtype=torch.float64)}
    hist = {k: torch.full_like(v, 1e-8) for k, v in params.items()}
    ii = torch.tensor([0, 0, 1, 2, 2, 2])
    jj = torch.tensor([1, 3, 3, 0, 1, 1])
    x = torch.tensor([1.0, 2.0, 0.5, 150.0, 3.0, 3.0], dtype=torch.float64)
    new_p, new_h = p_glove._glove_step(params, hist, ii, jj, x, 100.0,
                                       0.75, 0.05)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    pred = (torch.sum(leaves["w"][ii] * leaves["wc"][jj], 1)
            + leaves["b"][ii] + leaves["bc"][jj])
    fw = torch.clamp((x / 100.0) ** 0.75, max=1.0)
    torch.sum(fw * (pred - torch.log(x)) ** 2).backward()
    per_occurrence = torch.zeros(V, dtype=torch.float64).index_add_(
        0, ii, (2 * fw * (pred - torch.log(x))).detach() ** 2)
    for k in params:
        gk = leaves[k].grad
        np.testing.assert_allclose(new_h[k], hist[k] + gk * gk,
                                   atol=STEP_TOL)
        np.testing.assert_allclose(
            new_p[k], params[k] - 0.05 * gk / torch.sqrt(hist[k] + gk * gk),
            atol=STEP_TOL)
    assert not torch.allclose(new_h["b"], hist["b"] + per_occurrence)
    assert torch.equal(new_p["wc"][2], params["wc"][2])   # never hit


# ------------------------------------------------------------------ the fits
KW = dict(layer_size=16, min_count=1, batch_size=512, seed=3, epochs=2)


@pytest.mark.parametrize("algo", [
    {}, {"use_cbow": True}, {"hierarchic_softmax": True},
    {"hierarchic_softmax": True, "use_cbow": True},
], ids=["skipgram_ns", "cbow_ns", "skipgram_hs", "cbow_hs"])
def test_word2vec_tables_match_jax(algo):
    c = corpus()
    a = J.Word2Vec(**KW, **algo).fit(c)
    b = P.Word2Vec(**KW, **algo, device="cpu").fit(c)
    assert [w.word for w in a.vocab.words] == [w.word for w in b.vocab.words]
    assert_tables(b.syn0, a.syn0, "syn0")
    assert_tables(b._syn1, a._syn1, "syn1")
    if algo.get("hierarchic_softmax"):
        assert b._syn1.shape[0] == len(b.vocab) - 1
    for w in ("t0w1", "t1w3"):
        assert a.words_nearest(w, 5) == b.words_nearest(w, 5)
        assert abs(a.similarity(w, "t0w2") - b.similarity(w, "t0w2")) < 1e-5


def test_sequence_vectors_element_counts_and_queries_match_jax():
    """The SPI path (`element_counts`, no subsampling, fixed window) and
    the query surface on its tables."""
    seqs = [J.Sequence(s) for s in corpus(120)]
    counts = {w: i + 1 for i, w in enumerate(sorted({t for s in seqs
                                                      for t in s.elements}))}
    kw = dict(layer_size=8, window=3, subsampling=0.0, batch_size=1024,
              seed=5, dynamic_window=False, min_count=1)
    a = J.SequenceVectors(**kw).fit(seqs, element_counts=counts)
    b = P.SequenceVectors(**kw, device="cpu").fit(
        [P.Sequence(s.elements) for s in seqs], element_counts=counts)
    assert_tables(b.syn0, a.syn0, "syn0")
    assert_tables(b._syn1, a._syn1, "syn1")
    q = [("t0w1", "t0w2", "t1w1", "t1w2"), ("t0w3", "t0w4", "t1w5", "t1w6")]
    assert a.accuracy(q) == b.accuracy(q)
    assert a.element_vector("zzz") is None and b.element_vector("zzz") is None


@pytest.mark.parametrize("dm", [True, False], ids=["dm", "dbow"])
def test_paragraph_vectors_and_infer_vector_match_jax(dm):
    docs = [" ".join(s) for s in corpus(60)]
    kw = dict(dm=dm, layer_size=16, batch_size=256, seed=3, epochs=2)
    a = J.ParagraphVectors(**kw).fit(docs)
    b = P.ParagraphVectors(**kw, device="cpu").fit(docs)
    assert a.labels == b.labels
    assert_tables(b.syn0, a.syn0, "syn0")
    assert_tables(b._syn1, a._syn1, "syn1")
    assert_tables(b.doc_vectors, a.doc_vectors, "doc_vectors")
    for text in (docs[0], docs[7].split()[:4], "t0w1 unknown t1w2"):
        assert_tables(b.infer_vector(text, steps=10),
                      a.infer_vector(text, steps=10), "infer_vector")
    assert np.array_equal(a.infer_vector("nothing known"),
                          b.infer_vector("nothing known"))


def test_paragraph_vectors_dbow_leaves_word_table_untouched():
    docs = [" ".join(s) for s in corpus(30)]
    pv = P.ParagraphVectors(dm=False, layer_size=8, batch_size=128, seed=1,
                            device="cpu")
    start = (np.random.default_rng(1).random((len(P.build_vocab(
        [d.split() for d in docs], min_count=1)), 8), dtype=np.float32)
        - .5) / 8
    pv.fit(docs)
    assert np.array_equal(pv.syn0, start)


def test_paragraph_vectors_label_aware_iterator_matches_jax():
    c = corpus(40)
    docs = [" ".join(s) for s in c]
    labels = [f"L{i % 4}" for i in range(len(docs))]
    a = J.ParagraphVectors(layer_size=8, batch_size=128, seed=2).fit(
        J.CollectionLabelAwareIterator(docs, labels))
    b = P.ParagraphVectors(layer_size=8, batch_size=128, seed=2,
                           device="cpu").fit(
        P.CollectionLabelAwareIterator(docs, labels))
    assert a.labels == b.labels == ["L0", "L1", "L2", "L3"]
    assert_tables(b.doc_vectors, a.doc_vectors, "doc_vectors")
    assert abs(a.similarity_to_label("L0", "L1")
               - b.similarity_to_label("L0", "L1")) < 1e-5


def test_glove_with_repeated_rows_matches_jax():
    """12 words, so every batch of 64 co-occurrence pairs repeats rows
    in `ii` and in `jj` (pigeonhole): AdaGrad's history must square the
    rows' summed gradients in both packages."""
    c = corpus(50)
    kw = dict(layer_size=16, min_count=1, batch_size=64, seed=3, epochs=2)
    a = J.Glove(**kw).fit(c)
    b = P.Glove(**kw, device="cpu").fit(c)
    assert len(b.vocab) * 2 < 64
    assert_tables(b.syn0, a.syn0, "syn0")
    assert_tables(b._syn1, a._syn1, "syn1")


def test_distributed_word2vec_matches_jax():
    c = corpus()
    kw = dict(num_workers=3, layer_size=16, min_count=1, batch_size=256,
              seed=3, epochs=2)
    a = j_dist.DistributedWord2Vec(**kw).fit(c)
    b = p_dist.DistributedWord2Vec(**kw, device="cpu").fit(c)
    assert [w.word for w in a.vocab.words] == [w.word for w in b.vocab.words]
    assert_tables(b.syn0, a.syn0, "syn0")
    assert_tables(b._syn1, a._syn1, "syn1")
    with pytest.raises(ValueError):
        p_dist.DistributedWord2Vec(num_workers=0, device="cpu")


def test_trainers_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (P.SequenceVectors, P.Word2Vec, P.ParagraphVectors, P.Glove,
                p_dist.DistributedWord2Vec):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls()
        assert cls(device="cpu").device == torch.device("cpu")


# ------------------------------------------------- iterator and files
def test_sentence_data_iterator_arrays_equal():
    c = corpus(50)
    model = P.Word2Vec(layer_size=6, min_count=1, seed=1,
                       device="cpu").fit(c)
    texts = [" ".join(s[:n]) for s, n in zip(c, range(1, 11))] + \
        ["unknown words only"]
    labels = [i % 3 for i in range(len(texts))]
    for fmt in ("rnn", "cnn"):
        a = j_sd.SentenceDataSetIterator(texts, labels, word_vectors=model,
                                         batch_size=4, max_length=7, fmt=fmt)
        b = p_sd.SentenceDataSetIterator(texts, labels, word_vectors=model,
                                         batch_size=4, max_length=7, fmt=fmt)
        got = [(x, y) for x, y in zip(a, b)]
        assert len(got) == 3 and (a.batch_size, a.num_outcomes) == \
            (b.batch_size, b.num_outcomes)
        for x, y in got:
            for k in ("features", "labels", "features_mask"):
                u, v = getattr(x, k), getattr(y, k)
                assert u.dtype == v.dtype and np.array_equal(u, v), k
    with pytest.raises(ValueError):
        p_sd.SentenceDataSetIterator(texts, [5] * len(texts),
                                     word_vectors=model, num_classes=3)


@pytest.fixture(scope="module")
def models():
    c = corpus()
    a = J.Word2Vec(layer_size=12, min_count=1, batch_size=512, seed=4).fit(c)
    b = P.Word2Vec(layer_size=12, min_count=1, batch_size=512, seed=4,
                   device="cpu").fit(c)
    b.syn0 = a.syn0.copy()     # one table, written by both packages
    return a, b


@pytest.mark.parametrize("fmt", ["binary", "text"])
def test_word_vector_files_cross_packages(models, fmt, tmp_path):
    a, b = models
    write, read = (("write_binary", "read_binary") if fmt == "binary"
                   else ("write_word_vectors", "read_word_vectors"))
    getattr(J, write)(a, str(tmp_path / "j"))
    getattr(P, write)(b, str(tmp_path / "p"))
    assert (tmp_path / "j").read_bytes() == (tmp_path / "p").read_bytes()
    for pkg in (J, P):
        va, ma = getattr(pkg, read)(str(tmp_path / "j"))
        vb, mb = getattr(pkg, read)(str(tmp_path / "p"))
        assert [w.word for w in va.words] == [w.word for w in vb.words] == \
            [w.word for w in a.vocab.words]
        assert np.array_equal(ma, mb)
        if fmt == "binary":
            assert np.array_equal(mb, a.syn0)
        else:
            assert np.abs(mb - a.syn0).max() <= 5e-7 + 1e-8


def test_c21_a_label_shared_by_many_documents_blows_up_at_a_large_batch():
    """C21 (reference-side): the update sums a batch's contributions to a
    row before its one step, so a label that ~4,000 pairs of one batch
    share takes ~4,000 of them at once and its vector runs away (DL4J
    applies them one pair after another). Both packages do the same:
    two labels over 300 documents, DBOW, at batch 8192 against 64. At
    8192 the run-away grows the packages' last-bit gaps with the values:
    there they agree within 1e-4 of the largest |value|."""
    rng = np.random.default_rng(0)
    docs = [[f"w{i}" for i in rng.integers(0, 40, 30)] for _ in range(300)]
    labels = ["A" if i % 2 else "B" for i in range(300)]
    largest = {}
    for bs in (8192, 64):
        kw = dict(dm=False, layer_size=16, batch_size=bs, seed=0)
        a = J.ParagraphVectors(**kw).fit(docs, labels)
        b = P.ParagraphVectors(**kw, device="cpu").fit(docs, labels)
        largest[bs] = float(np.abs(a.doc_vectors).max())
        gap = float(np.abs(b.doc_vectors - a.doc_vectors).max())
        assert gap <= (1e-4 if bs == 8192 else TABLE_RTOL) * largest[bs]
    assert largest[8192] > 1e6 and largest[64] < 10, largest
