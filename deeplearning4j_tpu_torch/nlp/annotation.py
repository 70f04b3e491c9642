"""Text annotation pipeline — the UIMA-module analogue.

A copy of `deeplearning4j_tpu/nlp/annotation.py`,
which imports nothing of JAX: the port keeps its own.

Reference parity: `deeplearning4j-nlp-uima/` wraps Apache UIMA analysis
engines (ClearTK/OpenNLP wrappers) behind DL4J's tokenizer SPI:
`text/annotator/{SentenceAnnotator,TokenizerAnnotator,PoStagger,
StemmerAnnotator}.java` compose into an AnalysisEngine held by
`text/uima/UimaResource.java`; `PosUimaTokenizer.java` keeps tokens whose
POS is allowed (others become "NONE", optionally stripped) and prefers
lemma/stem over surface; `UimaSentenceIterator.java` yields
pipeline-segmented sentences; `StemmingPreprocessor.java` plugs a
Snowball stemmer into the TokenPreProcess seam.

TPU redesign: UIMA is a Java component framework — its capability here is
the ANNOTATION PIPELINE, so that is what this module provides natively:
a CAS-like `AnnotatedDocument` (text + typed stand-off annotations), an
ordered `AnnotationPipeline` of `Annotator` stages, and concrete
sentence/token/POS/stem annotators (rule-lexicon POS baseline, real
Porter stemmer) that slot into the SAME TokenizerFactory /
TokenPreProcess / SentenceIterator SPIs the rest of nlp/ uses. Treebank
constituency parsing (`text/corpora/treeparser/`) is waived in PARITY.md.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Sequence

from deeplearning4j_tpu_torch.nlp.tokenization import (
    SentenceIterator, TokenPreProcess, Tokenizer, TokenizerFactory,
)

TYPE_SENTENCE = "sentence"
TYPE_TOKEN = "token"


@dataclasses.dataclass
class Annotation:
    """One stand-off annotation (UIMA AnnotationFS analogue): a typed
    [begin, end) span over the document text plus a feature map."""

    type: str
    begin: int
    end: int
    features: Dict[str, object] = dataclasses.field(default_factory=dict)

    def covered_text(self, text: str) -> str:
        return text[self.begin:self.end]


class AnnotatedDocument:
    """CAS analogue: the subject of analysis all annotators share."""

    def __init__(self, text: str):
        self.text = text
        self.annotations: List[Annotation] = []

    def add(self, ann: Annotation) -> Annotation:
        self.annotations.append(ann)
        return ann

    def select(self, type_: str) -> List[Annotation]:
        return sorted((a for a in self.annotations if a.type == type_),
                      key=lambda a: (a.begin, a.end))

    def select_covered(self, type_: str, cover: Annotation) -> List[Annotation]:
        """Annotations of `type_` inside `cover`'s span (JCasUtil
        .selectCovered analogue)."""
        return [a for a in self.select(type_)
                if a.begin >= cover.begin and a.end <= cover.end]


class Annotator:
    """One pipeline stage (UIMA AnalysisEngine analogue)."""

    def process(self, doc: AnnotatedDocument) -> None:
        raise NotImplementedError


class AnnotationPipeline:
    """Ordered annotators over one document (UimaResource analogue:
    `text/uima/UimaResource.java` process/newCas loop)."""

    def __init__(self, *annotators: Annotator):
        self.annotators = list(annotators)

    def process(self, text: str) -> AnnotatedDocument:
        doc = AnnotatedDocument(text)
        for a in self.annotators:
            a.process(doc)
        return doc

    @staticmethod
    def default(pos: bool = True, stem: bool = True) -> "AnnotationPipeline":
        """The UIMA module's stock engine: sentence → token → POS → stem
        (TokenizerAnnotator.getWithAllAnnotators analogue)."""
        stages: List[Annotator] = [SentenceAnnotator(), TokenAnnotator()]
        if pos:
            stages.append(PosAnnotator())
        if stem:
            stages.append(StemmerAnnotator())
        return AnnotationPipeline(*stages)


# ---------------------------------------------------------------- sentences
_ABBREV = {"mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc",
           "e.g", "i.e", "fig", "no", "inc", "ltd", "co", "corp", "u.s",
           "u.k"}

_SENT_END = re.compile(r"[.!?。！？]+[\"'”’)\]]*")


class SentenceAnnotator(Annotator):
    """Rule-based sentence segmentation (reference:
    `text/annotator/SentenceAnnotator.java`, a ClearTK wrapper). Handles
    terminal punctuation incl. CJK, trailing quotes/brackets, and a
    closed abbreviation list."""

    def process(self, doc: AnnotatedDocument) -> None:
        text = doc.text
        start, n = 0, len(text)
        for m in _SENT_END.finditer(text):
            end = m.end()
            word = text[max(start, m.start() - 12):m.start()]
            last = re.split(r"[\s(\[\"']+", word)[-1].lower().rstrip(".")
            if text[m.start()] == "." and (
                    last in _ABBREV
                    or re.fullmatch(r"[a-z]", last)          # initials
                    or (end < n and not text[end:end + 2].strip() == ""
                        and not text[end].isspace())):       # mid-token dot
                continue
            seg = text[start:end].strip()
            if seg:
                b = start + (len(text[start:end])
                             - len(text[start:end].lstrip()))
                doc.add(Annotation(TYPE_SENTENCE, b, end))
            start = end
        tail = text[start:].strip()
        if tail:
            b = start + (len(text[start:]) - len(text[start:].lstrip()))
            doc.add(Annotation(TYPE_SENTENCE, b, b + len(tail)))


# ------------------------------------------------------------------- tokens
_WORD_RE = re.compile(r"\w+|[^\w\s]+", re.UNICODE)


class TokenAnnotator(Annotator):
    """Spans tokens inside each sentence (reference:
    `text/annotator/TokenizerAnnotator.java`). Default: word/punctuation
    regex split with EXACT spans (punctuation becomes its own token, the
    Penn-style behavior the UIMA tokenizer gives); pass any
    TokenizerFactory to tokenize differently."""

    def __init__(self, factory: Optional[TokenizerFactory] = None):
        self.factory = factory

    def process(self, doc: AnnotatedDocument) -> None:
        sentences = doc.select(TYPE_SENTENCE) or [
            Annotation(TYPE_SENTENCE, 0, len(doc.text))]
        # case-insensitive fallback text, computed lazily on the first
        # failed exact find; offsets in it only map back when lowering is
        # length-preserving (e.g. Turkish dotted capital I lowers to two
        # code points) — otherwise the fallback stays disabled
        lowered: Optional[str] = None

        def _lowered() -> str:
            nonlocal lowered
            if lowered is None:
                lowered = doc.text.lower()
                if len(lowered) != len(doc.text):
                    lowered = ""
            return lowered

        for s in sentences:
            if self.factory is None:
                for m in _WORD_RE.finditer(doc.text[s.begin:s.end]):
                    doc.add(Annotation(
                        TYPE_TOKEN, s.begin + m.start(),
                        s.begin + m.end(), {"word": m.group()}))
                continue
            cursor = s.begin
            for tok in self.factory.create(
                    doc.text[s.begin:s.end]).tokens():
                at = doc.text.find(tok, cursor, s.end)
                ltok = tok.lower()
                if at < 0 and len(ltok) == len(tok) and _lowered():
                    # surface changed (e.g. lowercasing preprocessor):
                    # retry case-insensitively so spans still point at
                    # the right characters (only when the token's own
                    # lowering is length-preserving too)
                    at = _lowered().find(ltok, cursor, s.end)
                if at < 0:
                    # the preprocessor rewrote the token beyond recovery
                    # (stemming, n-grams): record a zero-width annotation
                    # at the cursor rather than spanning wrong characters
                    # — covered_text() is then "" instead of garbage
                    doc.add(Annotation(TYPE_TOKEN, cursor, cursor,
                                       {"word": tok}))
                    continue
                doc.add(Annotation(TYPE_TOKEN, at, at + len(tok),
                                   {"word": tok}))
                cursor = at + len(tok)


# --------------------------------------------------------------------- POS
# Closed-class lexicon + suffix rules — the classic deterministic baseline
# tagger (the reference delegates to an OpenNLP maxent model via ClearTK;
# shipping a model binary is out of scope, the seam + tagset match).
_POS_LEXICON: Dict[str, str] = {}
for _w in ("the a an this that these those".split()):
    _POS_LEXICON[_w] = "DT"
for _w in ("i you he she it we they me him her us them".split()):
    _POS_LEXICON[_w] = "PRP"
for _w in ("my your his its our their".split()):
    _POS_LEXICON[_w] = "PRP$"
for _w in ("in on at by for with from of to into over under about "
           "between through during against".split()):
    _POS_LEXICON[_w] = "IN"
for _w in ("and or but nor yet so".split()):
    _POS_LEXICON[_w] = "CC"
for _w in ("is are was were be been being am".split()):
    _POS_LEXICON[_w] = "VBZ" if _w in ("is",) else "VBP"
for _w in ("have has had do does did will would can could shall should "
           "may might must".split()):
    _POS_LEXICON[_w] = "MD" if _w in (
        "will", "would", "can", "could", "shall", "should", "may",
        "might", "must") else "VBP"
for _w in ("not n't never".split()):
    _POS_LEXICON[_w] = "RB"
for _w in ("very quite rather too also just only even still".split()):
    _POS_LEXICON[_w] = "RB"
for _w in ("good great new old big small long little high large quick "
           "brown lazy happy red blue".split()):
    _POS_LEXICON[_w] = "JJ"
for _w in ("run runs ran running jump jumps jumped jumping eat eats ate "
           "eating go goes went going say says said make makes made "
           "see sees saw take takes took".split()):
    _POS_LEXICON[_w] = "VB"


class PosAnnotator(Annotator):
    """Deterministic POS baseline (reference seam:
    `text/annotator/PoStagger.java`). Order: lexicon → shape → suffix →
    default NN; sets the `pos` feature on token annotations."""

    def process(self, doc: AnnotatedDocument) -> None:
        for s in doc.select(TYPE_SENTENCE) or [
                Annotation(TYPE_SENTENCE, 0, len(doc.text))]:
            toks = doc.select_covered(TYPE_TOKEN, s)
            for i, t in enumerate(toks):
                t.features["pos"] = self._tag(
                    t.covered_text(doc.text), first=(i == 0))

    @staticmethod
    def _tag(w: str, first: bool) -> str:
        lw = w.lower()
        if lw in _POS_LEXICON:
            return _POS_LEXICON[lw]
        if re.fullmatch(r"[-+]?\d[\d,.]*", w):
            return "CD"
        if not w[:1].isalpha():
            return "SYM"
        if w[:1].isupper() and not first:
            return "NNP"
        if lw.endswith("ly"):
            return "RB"
        if lw.endswith(("ing",)):
            return "VBG"
        if lw.endswith(("ed",)):
            return "VBD"
        if lw.endswith(("ous", "ful", "ive", "able", "ible", "al", "ic")):
            return "JJ"
        if lw.endswith("s") and not lw.endswith(("ss", "us", "is")):
            return "NNS"
        return "NN"


# ------------------------------------------------------------------ stemmer
class PorterStemmer:
    """The classic Porter (1980) algorithm, steps 1a-5b — the capability
    behind the reference's `StemmerAnnotator.java` (Snowball) and
    `StemmingPreprocessor.java`."""

    _V = "aeiou"

    def _cons(self, w: str, i: int) -> bool:
        c = w[i]
        if c in self._V:
            return False
        if c == "y":
            return i == 0 or not self._cons(w, i - 1)
        return True

    def _m(self, w: str) -> int:
        """Measure: number of VC sequences in `w`."""
        forms = "".join(
            "c" if self._cons(w, i) else "v" for i in range(len(w)))
        return len(re.findall("vc+", forms))

    def _has_vowel(self, w: str) -> bool:
        return any(not self._cons(w, i) for i in range(len(w)))

    def _double_cons(self, w: str) -> bool:
        return (len(w) >= 2 and w[-1] == w[-2] and self._cons(w, len(w) - 1))

    def _cvc(self, w: str) -> bool:
        return (len(w) >= 3 and self._cons(w, len(w) - 3)
                and not self._cons(w, len(w) - 2)
                and self._cons(w, len(w) - 1) and w[-1] not in "wxy")

    def stem(self, word: str) -> str:
        w = word.lower()
        if len(w) <= 2:
            return w
        # step 1a
        for suf, rep in (("sses", "ss"), ("ies", "i"), ("ss", "ss"),
                         ("s", "")):
            if w.endswith(suf):
                w = w[:-len(suf)] + rep
                break
        # step 1b
        if w.endswith("eed"):
            if self._m(w[:-3]) > 0:
                w = w[:-1]
        else:
            hit = None
            for suf in ("ed", "ing"):
                if w.endswith(suf) and self._has_vowel(w[:-len(suf)]):
                    hit = suf
                    break
            if hit:
                w = w[:-len(hit)]
                if w.endswith(("at", "bl", "iz")):
                    w += "e"
                elif self._double_cons(w) and w[-1] not in "lsz":
                    w = w[:-1]
                elif self._m(w) == 1 and self._cvc(w):
                    w += "e"
        # step 1c
        if w.endswith("y") and self._has_vowel(w[:-1]):
            w = w[:-1] + "i"
        # step 2
        for suf, rep in (("ational", "ate"), ("tional", "tion"),
                         ("enci", "ence"), ("anci", "ance"),
                         ("izer", "ize"), ("abli", "able"), ("alli", "al"),
                         ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
                         ("ization", "ize"), ("ation", "ate"),
                         ("ator", "ate"), ("alism", "al"),
                         ("iveness", "ive"), ("fulness", "ful"),
                         ("ousness", "ous"), ("aliti", "al"),
                         ("iviti", "ive"), ("biliti", "ble")):
            if w.endswith(suf):
                if self._m(w[:-len(suf)]) > 0:
                    w = w[:-len(suf)] + rep
                break
        # step 3
        for suf, rep in (("icate", "ic"), ("ative", ""), ("alize", "al"),
                         ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
                         ("ness", "")):
            if w.endswith(suf):
                if self._m(w[:-len(suf)]) > 0:
                    w = w[:-len(suf)] + rep
                break
        # step 4
        for suf in ("al", "ance", "ence", "er", "ic", "able", "ible",
                    "ant", "ement", "ment", "ent", "ou", "ism", "ate",
                    "iti", "ous", "ive", "ize"):
            if w.endswith(suf):
                if self._m(w[:-len(suf)]) > 1:
                    w = w[:-len(suf)]
                break
        else:
            if w.endswith("ion") and len(w) > 3 and w[-4] in "st" \
                    and self._m(w[:-3]) > 1:
                w = w[:-3]
        # step 5a
        if w.endswith("e"):
            stem = w[:-1]
            if self._m(stem) > 1 or (self._m(stem) == 1
                                     and not self._cvc(stem)):
                w = stem
        # step 5b
        if self._m(w) > 1 and self._double_cons(w) and w.endswith("l"):
            w = w[:-1]
        return w


class StemmerAnnotator(Annotator):
    """Sets the `stem` feature on tokens (reference:
    `text/annotator/StemmerAnnotator.java`)."""

    def __init__(self, stemmer: Optional[PorterStemmer] = None):
        self.stemmer = stemmer or PorterStemmer()

    def process(self, doc: AnnotatedDocument) -> None:
        for t in doc.select(TYPE_TOKEN):
            word = t.covered_text(doc.text)
            if word.isalpha():
                t.features["stem"] = self.stemmer.stem(word)


class StemmingPreprocessor(TokenPreProcess):
    """TokenPreProcess that stems (reference:
    `tokenizer/preprocessor/StemmingPreprocessor.java` — composes with
    the common preprocessor exactly like the reference subclasses it)."""

    def __init__(self, lowercase: bool = True):
        self.stemmer = PorterStemmer()
        self.lowercase = lowercase

    def pre_process(self, token: str) -> str:
        t = token.lower() if self.lowercase else token
        return self.stemmer.stem(t) if t.isalpha() else t


# ----------------------------------------------- POS-filtered tokenization
class PosFilteredTokenizerFactory(TokenizerFactory):
    """Keep tokens whose POS is allowed; others become "NONE" (or are
    stripped). Prefers stem over surface when available — mirroring
    `PosUimaTokenizer.java:40-75` + `PosUimaTokenizerFactory.java`."""

    def __init__(self, allowed_pos: Iterable[str], *,
                 strip_nones: bool = False, use_stem: bool = True,
                 pipeline: Optional[AnnotationPipeline] = None):
        super().__init__()
        self.allowed = set(allowed_pos)
        self.strip_nones = strip_nones
        self.use_stem = use_stem
        self.pipeline = pipeline or AnnotationPipeline.default()

    def create(self, text: str) -> Tokenizer:
        doc = self.pipeline.process(text)
        out: List[str] = []
        for t in doc.select(TYPE_TOKEN):
            if t.features.get("pos") in self.allowed:
                word = (t.features.get("stem") if self.use_stem else None) \
                    or t.covered_text(doc.text)
                out.append(word)
            elif not self.strip_nones:
                out.append("NONE")
        from deeplearning4j_tpu_torch.nlp.lang import _ListTokenizer

        return _ListTokenizer(out, self._pre)


# ------------------------------------------------------- sentence iterator
class AnnotationSentenceIterator(SentenceIterator):
    """Sentence iterator backed by the pipeline's segmentation
    (reference: `text/sentenceiterator/UimaSentenceIterator.java`)."""

    def __init__(self, documents: Sequence[str],
                 pipeline: Optional[AnnotationPipeline] = None):
        self.documents = list(documents)
        self.pipeline = pipeline or AnnotationPipeline(SentenceAnnotator())

    def __iter__(self):
        for text in self.documents:
            doc = self.pipeline.process(text)
            for a in doc.select(TYPE_SENTENCE):
                yield self._apply_pre(a.covered_text(text))
