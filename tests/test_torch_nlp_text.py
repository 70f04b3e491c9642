"""The port's text pipeline against the JAX package's: tokenizers and
their preprocessors, sentence and document iterators, stop words,
bag-of-words / TF-IDF, the CJK factories and analyzers (`nlp/lang.py`)
and the annotation pipeline (`nlp/annotation.py`), on English and CJK
samples. These modules are host code that both packages keep their own
copies of: every result must be equal, token for token and value for
value."""

import dataclasses

import numpy as np
import pytest

from deeplearning4j_tpu.nlp import annotation as j_ann
from deeplearning4j_tpu.nlp import bow as j_bow
from deeplearning4j_tpu.nlp import documents as j_doc
from deeplearning4j_tpu.nlp import lang as j_lang
from deeplearning4j_tpu.nlp import stopwords as j_stop
from deeplearning4j_tpu.nlp import tokenization as j_tok
from deeplearning4j_tpu_torch.nlp import annotation as p_ann
from deeplearning4j_tpu_torch.nlp import bow as p_bow
from deeplearning4j_tpu_torch.nlp import documents as p_doc
from deeplearning4j_tpu_torch.nlp import lang as p_lang
from deeplearning4j_tpu_torch.nlp import stopwords as p_stop
from deeplearning4j_tpu_torch.nlp import tokenization as p_tok

ENGLISH = [
    "The quick brown fox jumped over the lazy dog.",
    "Dr. Smith met Mr. Jones. They talked about GPUs, TPUs & caches!",
    "I can't believe it's not butter -- said nobody, ever (2024).",
    "Running runners ran; relational generalization conditionally.",
    "  spaces\tand\nnewlines  ",
    "",
]
CJK = [
    "私はTPUで学習します123",
    "これはペンです。あれは本です。",
    "コンピュータを勉強する",
    "我爱北京天安门",
    "我们研究生命的起源",
    "深度学习框架",
    "나는 학교에 간다",
    "같이 먹었어요",
]
SAMPLES = ENGLISH + CJK


def plain(x):
    """A comparable form: dataclasses as dicts, sequences as lists,
    arrays as lists, other objects by their attributes."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, np.ndarray):
        return [x.dtype.str, x.tolist()]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if hasattr(x, "__dict__") and not isinstance(x, type):
        return {type(x).__name__: plain(vars(x))}
    return x


def both(jmod, pmod, name, *args, **kw):
    return (getattr(jmod, name)(*args, **kw),
            getattr(pmod, name)(*args, **kw))


@pytest.mark.parametrize("text", SAMPLES)
@pytest.mark.parametrize("factory", [
    ("DefaultTokenizerFactory", {}),
    ("NGramTokenizerFactory", {"n_min": 1, "n_max": 2}),
])
def test_tokenizer_factories_equal(factory, text):
    name, kw = factory
    a, b = both(j_tok, p_tok, name, **kw)
    assert a.create(text).tokens() == b.create(text).tokens()
    a.set_token_pre_processor(j_tok.CommonPreprocessor())
    b.set_token_pre_processor(p_tok.CommonPreprocessor())
    assert a.create(text).tokens() == b.create(text).tokens()


@pytest.mark.parametrize("text", SAMPLES)
def test_common_preprocessor_and_tokenize_corpus_equal(text):
    assert (j_tok.CommonPreprocessor().pre_process(text)
            == p_tok.CommonPreprocessor().pre_process(text))
    assert j_tok.tokenize_corpus([text, text.upper()]) == \
        p_tok.tokenize_corpus([text, text.upper()])


def test_sentence_iterators_equal(tmp_path):
    f = tmp_path / "corpus.txt"
    f.write_text("\n".join(ENGLISH) + "\n", encoding="utf-8")
    (tmp_path / "more.txt").write_text("one\ntwo\n\nthree\n")
    for name, args in (("CollectionSentenceIterator", (ENGLISH,)),
                       ("LineSentenceIterator", (str(f),)),
                       ("BasicLineIterator", (str(f),)),
                       ("FileSentenceIterator", (str(tmp_path),))):
        a, b = both(j_tok, p_tok, name, *args)
        assert list(a) == list(b), name
    a = j_tok.MultipleEpochsSentenceIterator(
        j_tok.CollectionSentenceIterator(ENGLISH[:3]), 3)
    b = p_tok.MultipleEpochsSentenceIterator(
        p_tok.CollectionSentenceIterator(ENGLISH[:3]), 3)
    assert list(a) == list(b)
    a = j_tok.AggregatingSentenceIterator(
        j_tok.CollectionSentenceIterator(ENGLISH[:2]),
        j_tok.CollectionSentenceIterator(CJK[:2]))
    b = p_tok.AggregatingSentenceIterator(
        p_tok.CollectionSentenceIterator(ENGLISH[:2]),
        p_tok.CollectionSentenceIterator(CJK[:2]))
    assert list(a) == list(b)
    a = j_tok.StreamLineIterator(iter(SAMPLES))
    b = p_tok.StreamLineIterator(iter(SAMPLES))
    assert list(a) == list(b)
    a = j_tok.CollectionSentenceIterator(SAMPLES).set_pre_processor(
        j_doc.LowCasePreProcessor())
    b = p_tok.CollectionSentenceIterator(SAMPLES).set_pre_processor(
        p_doc.LowCasePreProcessor())
    assert list(a) == list(b)
    a = j_tok.PrefetchingSentenceIterator(
        j_tok.CollectionSentenceIterator(SAMPLES))
    b = p_tok.PrefetchingSentenceIterator(
        p_tok.CollectionSentenceIterator(SAMPLES))
    assert list(a) == list(b)
    a = j_tok.LabelAwareListSentenceIterator(ENGLISH[:3], ["x", "y", "x"])
    b = p_tok.LabelAwareListSentenceIterator(ENGLISH[:3], ["x", "y", "x"])
    got = []
    for it in (a, b):
        got.append([(s, it.current_label()) for s in it])
    assert got[0] == got[1]


def test_document_iterators_and_preprocessors_equal(tmp_path):
    for i, text in enumerate(SAMPLES[:6]):
        d = tmp_path / ("pos" if i % 2 else "neg")
        d.mkdir(exist_ok=True)
        (d / f"{i}.txt").write_text(text, encoding="utf-8")
    for name, args in (("CollectionDocumentIterator", (SAMPLES,)),
                       ("FileDocumentIterator", (str(tmp_path),))):
        a, b = both(j_doc, p_doc, name, *args)
        assert list(a) == list(b), name
    a = j_doc.FilenamesLabelAwareIterator(str(tmp_path))
    b = p_doc.FilenamesLabelAwareIterator(str(tmp_path))
    assert plain(list(a)) == plain(list(b))
    a = j_doc.CollectionLabelAwareIterator(SAMPLES, ["l"] * len(SAMPLES))
    b = p_doc.CollectionLabelAwareIterator(SAMPLES, ["l"] * len(SAMPLES))
    assert plain(list(a)) == plain(list(b))
    ja, pa = both(j_doc, p_doc, "LabelsSource", "DOC_%d")
    assert [ja.next_label() for _ in range(3)] == \
        [pa.next_label() for _ in range(3)]
    ja.store_label("x")
    pa.store_label("x")
    assert ja.labels == pa.labels
    a = j_doc.LabelAwareDocumentIterator(
        j_doc.CollectionDocumentIterator(SAMPLES))
    b = p_doc.LabelAwareDocumentIterator(
        p_doc.CollectionDocumentIterator(SAMPLES))
    assert plain(list(a)) == plain(list(b))
    chains = []
    for mod in (j_doc, p_doc):
        chains.append(mod.CompositePreProcessor(
            mod.StripSpecialCharsPreProcessor(), mod.LowCasePreProcessor(),
            mod.FunctionPreProcessor(str.strip)))
    for text in SAMPLES:
        assert chains[0].pre_process(text) == chains[1].pre_process(text)


@pytest.mark.parametrize("text", ENGLISH)
def test_stop_words_equal(text):
    assert (j_stop.StopWords.get_stop_words()
            == p_stop.StopWords.get_stop_words())
    a = j_tok.DefaultTokenizerFactory()
    a.set_token_pre_processor(j_stop.StopWordsRemovalPreprocessor(
        inner=j_tok.CommonPreprocessor()))
    b = p_tok.DefaultTokenizerFactory()
    b.set_token_pre_processor(p_stop.StopWordsRemovalPreprocessor(
        inner=p_tok.CommonPreprocessor()))
    assert a.create(text).tokens() == b.create(text).tokens()


@pytest.mark.parametrize("cls", ["BagOfWordsVectorizer", "TfidfVectorizer"])
def test_vectorizers_equal(cls):
    docs = ENGLISH[:4] + ["fox fox dog", "the the the"]
    a = getattr(j_bow, cls)(min_count=1).fit(docs)
    b = getattr(p_bow, cls)(min_count=1).fit(docs)
    assert [w.word for w in a.vocab.words] == [w.word for w in b.vocab.words]
    xa, xb = a.transform(docs + ["unseen words"]), \
        b.transform(docs + ["unseen words"])
    assert xa.dtype == xb.dtype and np.array_equal(xa, xb)
    if cls == "TfidfVectorizer":
        assert np.array_equal(a.idf, b.idf)


@pytest.mark.parametrize("text", SAMPLES)
@pytest.mark.parametrize("factory", [
    ("JapaneseTokenizerFactory", {}),
    ("JapaneseTokenizerFactory", {"user_dictionary": ["機械学習", "学習"]}),
    ("ChineseTokenizerFactory", {}),
    ("ChineseTokenizerFactory", {"base_lexicon": ()}),
    ("KoreanTokenizerFactory", {}),
    ("KoreanTokenizerFactory", {"strip_particles": False}),
    ("KoreanMorphologicalTokenizerFactory", {}),
    ("KoreanMorphologicalTokenizerFactory", {"keep_particles": True}),
])
def test_cjk_tokenizer_factories_equal(factory, text):
    name, kw = factory
    a, b = both(j_lang, p_lang, name, **kw)
    assert a.create(text).tokens() == b.create(text).tokens()


@pytest.mark.parametrize("text", SAMPLES)
@pytest.mark.parametrize("analyzer", [
    "JapaneseMorphologicalAnalyzer", "KoreanMorphologicalAnalyzer",
    "ChineseMorphologicalAnalyzer",
])
def test_cjk_analyzers_equal(analyzer, text):
    a, b = both(j_lang, p_lang, analyzer)
    assert plain(a.analyze(text)) == plain(b.analyze(text))


def test_lattice_segmenter_equal():
    words = ["北京", "天安门", "深度学习", "框架", "学习"]
    a = j_lang.LatticeSegmenter(words)
    b = p_lang.LatticeSegmenter(words)
    for text in CJK:
        assert a.segment(text) == b.segment(text)


@pytest.mark.parametrize("text", SAMPLES)
@pytest.mark.parametrize("stages", [(True, True), (True, False),
                                    (False, False)])
def test_annotation_pipeline_equal(stages, text):
    pos, stem = stages
    da = j_ann.AnnotationPipeline.default(pos=pos, stem=stem).process(text)
    db = p_ann.AnnotationPipeline.default(pos=pos, stem=stem).process(text)
    assert da.text == db.text
    assert plain(da.annotations) == plain(db.annotations)
    for t in (j_ann.TYPE_SENTENCE, j_ann.TYPE_TOKEN):
        assert plain(da.select(t)) == plain(db.select(t))


def test_stemmer_and_pos_filtered_tokenizer_equal():
    words = ("caresses ponies ties caress cats feed agreed plastered "
             "motoring sing conflated troubled sized hopping tanned falling "
             "hissing fizzed failing filing happy sky relational "
             "conditional rational valenci hesitanci digitizer conformabli "
             "radicalli differentli vileli analogousli vietnamization "
             "predication operator feudalism decisiveness hopefulness "
             "callousness formaliti sensitiviti sensibiliti triplicate "
             "formative formalize electriciti electrical hopeful goodness "
             "revival allowance inference airliner gyroscopic adjustable "
             "defensible irritant replacement adjustment dependent adoption "
             "homologou communism activate angulariti homologous effective "
             "bowdlerize probate rate cease controll roll").split()
    a, b = j_ann.PorterStemmer(), p_ann.PorterStemmer()
    assert [a.stem(w) for w in words] == [b.stem(w) for w in words]
    for text in ENGLISH:
        fa = j_ann.PosFilteredTokenizerFactory(["NN", "NNS", "JJ"])
        fb = p_ann.PosFilteredTokenizerFactory(["NN", "NNS", "JJ"])
        assert fa.create(text).tokens() == fb.create(text).tokens()
        sa = j_tok.DefaultTokenizerFactory()
        sa.set_token_pre_processor(j_ann.StemmingPreprocessor())
        sb = p_tok.DefaultTokenizerFactory()
        sb.set_token_pre_processor(p_ann.StemmingPreprocessor())
        assert sa.create(text).tokens() == sb.create(text).tokens()
    ia = j_ann.AnnotationSentenceIterator(ENGLISH)
    ib = p_ann.AnnotationSentenceIterator(ENGLISH)
    assert list(ia) == list(ib)
