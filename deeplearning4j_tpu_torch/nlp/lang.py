"""CJK tokenizer factories — language-pack parity.

A copy of `deeplearning4j_tpu/nlp/lang.py`,
which imports nothing of JAX: the port keeps its own.

Reference parity: sibling modules `deeplearning4j-nlp-{japanese,chinese,
korean}` (SURVEY §2.5) bundle heavyweight analyzers (a kuromoji fork for
ja, ansj for zh, a Korean twitter-text port). Those are dictionary-driven
morphological analyzers; shipping ~55 files of dictionary machinery is not
what the TPU port needs, so these factories implement the standard
lightweight equivalents:

- Japanese + Chinese: min-cost LATTICE segmentation (`LatticeSegmenter`,
  the kuromoji/ansj algorithm core — Viterbi over dictionary + unknown
  nodes, beating greedy longest-match on ambiguous spans like 研究生命),
  seeded with small embedded high-frequency lexicons (JA_COMMON /
  ZH_COMMON) and extended by user dictionaries (words or word→cost).
  Japanese groups OOV same-script runs (katakana loanwords stay one
  token); Chinese degrades to unigram characters on OOV spans, like the
  reference's ansj fallback (`base_lexicon=()` for pure unigrams).
- Korean: whitespace-delimited eojeol, optionally stripped of trailing
  particles (josa) from a small closed set.

All three plug into the same `TokenizerFactory` SPI as the default
tokenizer (reference seam: `tokenization/tokenizerfactory/`), so
Word2Vec/ParagraphVectors/BagOfWords accept them unchanged.
"""

from __future__ import annotations

import unicodedata
from typing import Iterable, List, Optional

from deeplearning4j_tpu_torch.nlp.tokenization import (
    Tokenizer, TokenizerFactory,
)


def _char_class(ch: str) -> str:
    code = ord(ch)
    if 0x4E00 <= code <= 0x9FFF or 0x3400 <= code <= 0x4DBF:
        return "kanji"
    if 0x3040 <= code <= 0x309F:
        return "hiragana"
    if 0x30A0 <= code <= 0x30FF or code == 0x30FC:
        return "katakana"
    if 0xAC00 <= code <= 0xD7AF:
        return "hangul"
    if ch.isdigit():
        return "digit"
    if ch.isalpha():
        return "latin"
    if ch.isspace():
        return "space"
    return "other"


def _runs(text: str) -> List[str]:
    out: List[str] = []
    cur, cls = "", None
    for ch in text:
        c = _char_class(ch)
        if c == cls and c not in ("space", "other"):
            cur += ch
        else:
            if cur:
                out.append(cur)
            cur = ch if c not in ("space",) else ""
            cls = c
            if c == "other" and cur:
                out.append(cur)
                cur = ""
    if cur:
        out.append(cur)
    return out


class LatticeSegmenter:
    """Min-cost lattice segmentation — the algorithmic core of the
    reference's kuromoji/ansj analyzers: build a lattice of dictionary
    entries + unknown-word nodes over the text and take the Viterbi
    (min total cost) path, instead of greedy longest-match (which
    mis-segments e.g. 研究生命 as 研究生|命 when 研究|生命 is cheaper).

    `lexicon`: word → cost (lower = preferred). Plain iterables get a
    default cost of `word_cost_base - word_cost_len * len(word)` so longer
    dictionary words win unless explicit costs say otherwise. Unknown
    characters cost `unk_cost` each, with a discount when they extend a
    same-character-class run (kuromoji's unknown-word grouping)."""

    def __init__(self, lexicon, *, unk_cost: float = 10.0,
                 unk_run_cost: float = 6.0,
                 word_cost_base: float = 8.0, word_cost_len: float = 3.0):
        if isinstance(lexicon, dict):
            self.costs = {w: float(c) for w, c in lexicon.items()}
        else:
            self.costs = {
                w: max(word_cost_base - word_cost_len * len(w), 1.0)
                for w in (lexicon or ())}
        self.max_len = max((len(w) for w in self.costs), default=1)
        self.unk_cost = unk_cost
        self.unk_run_cost = unk_run_cost

    def segment(self, text: str) -> List[str]:
        n = len(text)
        INF = float("inf")
        best = [INF] * (n + 1)
        back: List[Optional[int]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == INF:
                continue
            # dictionary edges
            for ln in range(1, min(self.max_len, n - i) + 1):
                w = text[i:i + ln]
                c = self.costs.get(w)
                if c is not None and best[i] + c < best[i + ln]:
                    best[i + ln] = best[i] + c
                    back[i + ln] = i
            # unknown single char; cheaper when continuing a same-class run
            # (so an OOV katakana loanword or digit string stays one token)
            cont = (i > 0 and back[i] == i - 1
                    and _char_class(text[i]) == _char_class(text[i - 1]))
            c = self.unk_run_cost if cont else self.unk_cost
            if best[i] + c < best[i + 1]:
                best[i + 1] = best[i] + c
                back[i + 1] = i
        # reconstruct, merging adjacent same-class unknown chars into runs
        cuts = []
        j = n
        while j > 0:
            cuts.append(j)
            j = back[j]
        cuts.append(0)
        cuts.reverse()
        pieces = [text[a:b] for a, b in zip(cuts, cuts[1:])]
        if self.unk_run_cost >= self.unk_cost:
            return pieces   # run-grouping disabled: unknowns stay unigram
        out: List[str] = []
        for p in pieces:
            if (out and len(p) == 1
                    and out[-1] not in self.costs and p not in self.costs
                    and _char_class(p) == _char_class(out[-1][-1])):
                out[-1] += p
            else:
                out.append(p)
        return out


# Small embedded starter lexicons (high-frequency words/particles) so the
# factories are useful out of the box; user dictionaries extend/override.
# The reference ships full analyzer dictionaries (~MBs); these cover the
# closed-class core the segmentation quality hinges on.
ZH_COMMON = (
    "的 了 是 在 不 我 有 他 这 中 大 来 上 国 个 到 说 们 为 子 和 你 地 出 道 "
    "也 时 年 得 就 那 要 下 以 生 会 自 着 去 之 过 家 学 对 可 她 里 后 小 么 "
    "我们 你们 他们 她们 这个 那个 什么 没有 知道 现在 时候 自己 大家 因为 "
    "所以 但是 可以 已经 还是 如果 虽然 时间 问题 工作 学习 学生 老师 朋友 "
    "中国 北京 研究 生命 科学 技术 经济 发展 社会 世界 国家 政府 人民 "
    "今天 明天 昨天 东西 地方 事情 开始 结束 喜欢 觉得 认为 希望 需要 "
    "音乐 电影"
).split()

JA_COMMON = (
    "の は が を に で と も か ら な だ です ます した する いる ある なる "
    "これ それ あれ この その あの ここ そこ どこ わたし あなた かれ かのじょ "
    "こと もの とき ひと 私 僕 彼 彼女 日本 東京 学生 先生 学校 会社 仕事 "
    "時間 今日 明日 昨日 毎日 今 年 月 日 人 何 言葉 勉強 研究 世界 国 家族 "
    "友達 ありがとう こんにちは さようなら ください から まで より など "
    "について"
).split()


def _build_lexicon(base_words, user) -> dict:
    """base + user lexicon merge with one shared cost formula (user words
    cost slightly less, so they beat the embedded core at equal length)."""
    def cost(w, base, floor):
        return max(base - 3.0 * len(w), floor)

    lex = {w: cost(w, 8.0, 1.0) for w in base_words}
    if isinstance(user, dict):
        lex.update({w: float(c) for w, c in user.items()})
    else:
        lex.update({w: cost(w, 7.0, 0.5) for w in (user or ())})
    return lex


def _spans(text: str, classes) -> List:
    """Partition into (is_target, span) with CONSECUTIVE target-class runs
    coalesced — Japanese words cross script boundaries (kanji+okurigana
    like 食べる), so the lattice must see the whole CJK span."""
    out: List = []
    for run in _runs(text):
        tgt = _char_class(run[0]) in classes
        if out and out[-1][0] and tgt:
            out[-1] = (True, out[-1][1] + run)
        else:
            out.append((tgt, run))
    return out


class JapaneseTokenizerFactory(TokenizerFactory):
    """Reference: `deeplearning4j-nlp-japanese` (kuromoji fork) — same
    algorithm class: min-cost lattice segmentation over a lexicon
    (LatticeSegmenter) seeded with the embedded JA_COMMON core; a user
    dictionary (iterable of words or word→cost dict) extends it."""

    _CJK = ("kanji", "hiragana", "katakana")

    def __init__(self, user_dictionary: Optional[Iterable[str]] = None, *,
                 base_lexicon: Optional[Iterable[str]] = None):
        super().__init__()
        base = JA_COMMON if base_lexicon is None else base_lexicon
        self._seg = LatticeSegmenter(_build_lexicon(base, user_dictionary))

    def create(self, text: str) -> Tokenizer:
        toks: List[str] = []
        for is_cjk, span in _spans(unicodedata.normalize("NFKC", text),
                                   self._CJK):
            if is_cjk:
                toks.extend(self._seg.segment(span))
            else:
                toks.append(span)
        return _ListTokenizer(toks, self._pre)


class ChineseTokenizerFactory(TokenizerFactory):
    """Reference: `deeplearning4j-nlp-chinese` (ansj analyzer) — min-cost
    lattice segmentation (ZH_COMMON core + user dictionary); degrades to
    unigram characters on fully-OOV spans like the reference."""

    def __init__(self, dictionary: Optional[Iterable[str]] = None, *,
                 base_lexicon: Optional[Iterable[str]] = None):
        super().__init__()
        base = ZH_COMMON if base_lexicon is None else base_lexicon
        # Chinese unknowns should NOT merge into runs (OOV hanzi stay
        # unigrams — the ansj fallback); a run discount would glue them.
        self._seg = LatticeSegmenter(_build_lexicon(base, dictionary),
                                     unk_run_cost=10.0)

    def create(self, text: str) -> Tokenizer:
        toks: List[str] = []
        for is_hanzi, span in _spans(unicodedata.normalize("NFKC", text),
                                     ("kanji",)):
            if is_hanzi:
                toks.extend(self._seg.segment(span))
            else:
                toks.append(span)
        return _ListTokenizer(toks, self._pre)


_JOSA = ("은", "는", "이", "가", "을", "를", "의", "에", "에서", "으로",
         "로", "와", "과", "도", "만", "까지", "부터", "에게")


class KoreanTokenizerFactory(TokenizerFactory):
    """Reference: `deeplearning4j-nlp-korean` (twitter-text port)."""

    def __init__(self, strip_particles: bool = True):
        super().__init__()
        self.strip_particles = strip_particles

    def create(self, text: str) -> Tokenizer:
        toks: List[str] = []
        for word in text.split():
            w = word.strip(".,!?…·()[]\"'")
            if not w:
                continue
            if self.strip_particles and _char_class(w[-1]) == "hangul":
                for josa in sorted(_JOSA, key=len, reverse=True):
                    if len(w) > len(josa) and w.endswith(josa):
                        w = w[:-len(josa)]
                        break
            toks.append(w)
        return _ListTokenizer(toks, self._pre)


class _ListTokenizer(Tokenizer):
    """Tokenizer over a precomputed token list (factories above)."""

    def __init__(self, toks: List[str], pre):
        self._toks = toks
        self._pre = pre

    def tokens(self) -> List[str]:
        out = [self._pre.pre_process(t) if self._pre else t
               for t in self._toks]
        return [t for t in out if t]


# --------------------------------------------------------------------------
# Japanese morphological analysis (POS + readings + base forms)
# --------------------------------------------------------------------------
import dataclasses as _dc


@_dc.dataclass(frozen=True)
class Morpheme:
    """One analyzed token — kuromoji Token analogue (reference:
    deeplearning4j-nlp-japanese bundles a kuromoji fork whose Token
    carries surface / part-of-speech / reading / base form)."""

    surface: str
    pos: str                      # kuromoji-style main category (動詞 etc.)
    reading: Optional[str] = None   # katakana
    base: Optional[str] = None      # dictionary (base) form


def _hira_to_kata(s: str) -> str:
    return "".join(chr(ord(c) + 0x60) if 0x3041 <= ord(c) <= 0x3096 else c
                   for c in s)


# surface -> (POS, katakana reading). Closed-class core + common verbs
# (verbs carry a conjugation class for inflection generation below:
# "1" ichidan, "5" godan, "irr" irregular).
JA_MORPH: dict = {}
for _w, _r in (("の", "ノ"), ("は", "ハ"), ("が", "ガ"), ("を", "ヲ"),
               ("に", "ニ"), ("で", "デ"), ("と", "ト"), ("も", "モ"),
               ("か", "カ"), ("から", "カラ"), ("まで", "マデ"),
               ("より", "ヨリ"), ("など", "ナド"), ("について", "ニツイテ")):
    JA_MORPH[_w] = ("助詞", _r)
for _w, _r in (("です", "デス"), ("ます", "マス"), ("ました", "マシタ"),
               ("ません", "マセン"), ("た", "タ"), ("だ", "ダ"),
               ("ない", "ナイ"), ("な", "ナ"), ("ら", "ラ")):
    JA_MORPH[_w] = ("助動詞", _r)
for _w, _r in (("これ", "コレ"), ("それ", "ソレ"), ("あれ", "アレ"),
               ("ここ", "ココ"), ("そこ", "ソコ"), ("どこ", "ドコ"),
               ("わたし", "ワタシ"), ("あなた", "アナタ"), ("私", "ワタシ"),
               ("僕", "ボク"), ("彼", "カレ"), ("彼女", "カノジョ"),
               ("かれ", "カレ"), ("かのじょ", "カノジョ")):
    JA_MORPH[_w] = ("代名詞", _r)
for _w, _r in (("日本", "ニホン"), ("東京", "トウキョウ"),
               ("学生", "ガクセイ"), ("先生", "センセイ"),
               ("学校", "ガッコウ"), ("会社", "カイシャ"),
               ("仕事", "シゴト"), ("時間", "ジカン"), ("今日", "キョウ"),
               ("明日", "アシタ"), ("昨日", "キノウ"), ("毎日", "マイニチ"),
               ("今", "イマ"),
               ("年", "トシ"), ("月", "ツキ"), ("日", "ヒ"), ("人", "ヒト"),
               ("何", "ナニ"), ("言葉", "コトバ"), ("勉強", "ベンキョウ"),
               ("研究", "ケンキュウ"), ("世界", "セカイ"), ("国", "クニ"),
               ("家族", "カゾク"), ("友達", "トモダチ"), ("こと", "コト"),
               ("もの", "モノ"), ("とき", "トキ"), ("ひと", "ヒト")):
    JA_MORPH[_w] = ("名詞", _r)
for _w, _r in (("ありがとう", "アリガトウ"), ("こんにちは", "コンニチハ"),
               ("さようなら", "サヨウナラ")):
    JA_MORPH[_w] = ("感動詞", _r)
JA_MORPH["ください"] = ("動詞", "クダサイ")

# verb dictionary: base form -> (reading, conjugation class)
JA_VERBS = {
    "する": ("スル", "irr"), "いる": ("イル", "1"), "ある": ("アル", "5"),
    "なる": ("ナル", "5"), "食べる": ("タベル", "1"), "見る": ("ミル", "1"),
    "行く": ("イク", "5"), "来る": ("クル", "irr"), "思う": ("オモウ", "5"),
    "言う": ("イウ", "5"), "分かる": ("ワカル", "5"), "書く": ("カク", "5"),
    "読む": ("ヨム", "5"), "話す": ("ハナス", "5"), "使う": ("ツカウ", "5"),
    "作る": ("ツクル", "5"), "持つ": ("モツ", "5"), "出る": ("デル", "1"),
    "入る": ("ハイル", "5"), "待つ": ("マツ", "5"), "買う": ("カウ", "5"),
    "飲む": ("ノム", "5"), "泳ぐ": ("オヨグ", "5"), "死ぬ": ("シヌ", "5"),
    "遊ぶ": ("アソブ", "5"), "休む": ("ヤスム", "5"),
}

# godan final-kana -> (masu-stem kana, ta/te euphonic past, negative stem)
_GODAN = {
    "う": ("い", "った", "わ"), "つ": ("ち", "った", "た"),
    "る": ("り", "った", "ら"), "む": ("み", "んだ", "ま"),
    "ぶ": ("び", "んだ", "ば"), "ぬ": ("に", "んだ", "な"),
    "く": ("き", "いた", "か"), "ぐ": ("ぎ", "いだ", "が"),
    "す": ("し", "した", "さ"),
}


def _inflections(base: str, reading: str, klass: str):
    """Generate common inflected (surface, reading) pairs for one verb.

    Regular verbs substitute only the FINAL kana, so readings follow the
    same substitution on the base reading. Irregular verbs (する/来る)
    carry explicit stem readings — 来る's stem kanji reads ク only in the
    dictionary form (来た=キタ, 来ない=コナイ), which no suffix rule can
    derive."""
    rstem = reading[:-1]              # reading minus the final ル/ウ row kana
    if klass == "irr":
        stems = {"する": (("し", "シ"), ("した", "シタ"), ("し", "シ")),
                 "来る": (("来", "キ"), ("来た", "キタ"), ("来", "コ"))}
        (stem, stem_r), (past, past_r), (neg, neg_r) = stems[base]
    elif klass == "1":
        stem, stem_r = base[:-1], rstem
        past, past_r = stem + "た", rstem + "タ"
        neg, neg_r = stem, rstem
    else:
        k = base[-1]
        ms, pa, ns = _GODAN[k]
        stem, stem_r = base[:-1] + ms, rstem + _hira_to_kata(ms)
        past, past_r = base[:-1] + pa, rstem + _hira_to_kata(pa)
        neg, neg_r = base[:-1] + ns, rstem + _hira_to_kata(ns)
        if base == "行く":        # the one godan euphonic exception
            past, past_r = "行った", "イッタ"
    yield base, reading
    yield past, past_r                            # plain past
    te = "で" if past.endswith("だ") else "て"
    yield past[:-1] + te, past_r[:-1] + _hira_to_kata(te)   # te-form
    for suf in ("ます", "ました", "ません", "ましょう"):
        yield stem + suf, stem_r + _hira_to_kata(suf)       # polite row
    yield neg + "ない", neg_r + "ナイ"            # plain negative


# inflected surface -> (base form, reading) — built once
JA_INFLECTED = {}
for _b, (_r, _k) in JA_VERBS.items():
    for _surf, _read in _inflections(_b, _r, _k):
        JA_INFLECTED.setdefault(_surf, (_b, _read))


class JapaneseMorphologicalAnalyzer:
    """kuromoji-capability analogue: segment + POS-tag + readings + base
    forms. Segmentation is the same min-cost lattice as
    JapaneseTokenizerFactory, with the verb dictionary's generated
    inflected surfaces added so conjugated verbs stay one token
    (kuromoji's dictionary stores inflected entries the same way)."""

    def __init__(self, user_dictionary=None):
        words = dict(_build_lexicon(JA_COMMON, user_dictionary))
        for surf in JA_INFLECTED:
            words.setdefault(surf, max(8.0 - 3.0 * len(surf), 0.4))
        self._seg = LatticeSegmenter(words)

    def analyze(self, text: str) -> List[Morpheme]:
        # same NFKC normalization as JapaneseTokenizerFactory.create, so
        # half-width katakana / full-width latin take the same path
        text = unicodedata.normalize("NFKC", text)
        out: List[Morpheme] = []
        for is_cjk, span in _spans(text, ("kanji", "hiragana", "katakana")):
            if not is_cjk:
                for tok in span.split():
                    if tok:
                        out.append(Morpheme(
                            tok, "名詞" if tok[0].isalnum() else "記号"))
                continue
            for tok in self._seg.segment(span):
                out.append(self._morpheme(tok))
        return out

    def _morpheme(self, tok: str) -> Morpheme:
        if tok in JA_INFLECTED:
            base, reading = JA_INFLECTED[tok]
            return Morpheme(tok, "動詞", reading, base)
        if tok in JA_MORPH:
            pos, reading = JA_MORPH[tok]
            return Morpheme(tok, pos, reading, tok)
        cls = _char_class(tok[0])
        if cls == "katakana":
            return Morpheme(tok, "名詞", tok, tok)
        if cls == "hiragana":
            return Morpheme(tok, "助詞", _hira_to_kata(tok), tok)
        return Morpheme(tok, "名詞", None, tok)   # unknown kanji


# --------------------------------------------------------------------------
# Korean morphological analysis (stem/josa/eomi decomposition + POS)
# --------------------------------------------------------------------------
# Reference: `deeplearning4j-nlp-korean/.../KoreanTokenizer.java:34` wraps
# twitter-korean-text, whose tokenizer is MORPHOLOGY-based: each eojeol
# (space unit) decomposes into stem + particle (josa) / verb ending
# (eomi), tagged with KoreanPos (Noun, Verb, Adjective, Josa, Eomi,
# Number, Foreign, Punctuation, ...), with conjugated verbs recovered to
# their dictionary form. Same capability here on an embedded dictionary
# core (like JA above): jamo-aware de-conjugation handles the 았/었
# contraction (가+았→갔, 하+았→했, ...) arithmetically.

_HANGUL_BASE = 0xAC00
_JUNGSEONG = 21
_JONGSEONG = 28
# jongseong (final consonant) index of ㅆ in the syllable formula
_JONG_SS = 20


def _hangul_decompose(ch: str):
    """Syllable -> (initial, vowel, final) indices, or None."""
    code = ord(ch) - _HANGUL_BASE
    if not 0 <= code < 11172:
        return None
    return (code // (_JUNGSEONG * _JONGSEONG),
            (code // _JONGSEONG) % _JUNGSEONG,
            code % _JONGSEONG)


def _hangul_compose(ini: int, vow: int, fin: int) -> str:
    return chr(_HANGUL_BASE + (ini * _JUNGSEONG + vow) * _JONGSEONG + fin)


# contracted-syllable vowel -> [(stem vowel, 았/었), ...] candidates:
# the ㅆ-final syllable's vowel encodes which stem vowel absorbed the
# 아/어 row.  가+았→갔 (ㅏ→ㅏ), 하+였→했 (ㅐ→ㅏ irregular), 오+았→왔 /
# 보+았→봤 (ㅘ→ㅗ), 주+었→줬 (ㅝ→ㅜ), 되+었→됐 (ㅙ→ㅚ), 마시+었→마셨
# (ㅕ→ㅣ), 서+었→섰 (ㅓ→ㅓ). Multiple candidates (e.g. ㅐ could be a
# genuine ㅐ stem) are all tried against the stem dictionary.
_PAST_BY_VOWEL = {
    0: [(0, "았")],               # ㅏ
    1: [(0, "았"), (1, "었")],    # ㅐ: 하-irregular first, ㅐ stems second
    9: [(8, "았")],               # ㅘ -> ㅗ
    4: [(4, "었")],               # ㅓ
    14: [(13, "었")],             # ㅝ -> ㅜ
    10: [(11, "었")],             # ㅙ -> ㅚ
    6: [(20, "었")],              # ㅕ -> ㅣ
    20: [(20, "었")],             # ㅣ
}

KO_NOUNS = set(
    "학교 학생 선생님 친구 사람 시간 오늘 내일 어제 한국 서울 책 물 밥 집 "
    "회사 일 말 나라 세계 문제 공부 연구 영화 음식 음악 아침 저녁 점심 "
    "이름 생각 마음 이야기 가족 아버지 어머니 동생 언니 형 누나".split())
KO_PRONOUNS = set("나 너 저 우리 그 그녀 누구 무엇 이것 그것 저것".split())
KO_ADVERBS = set("매우 아주 너무 잘 못 더 다시 같이 빨리 천천히 많이".split())
# verb/adjective STEMS -> (dictionary form, pos)
KO_STEMS = {}
for _stem in "가 오 하 먹 보 있 없 되 주 받 만나 사 배우 읽 듣 마시 만들".split():
    KO_STEMS[_stem] = (_stem + "다", "Verb")
for _stem in "좋 크 작 예쁘 많 적 높 낮 길 짧".split():
    KO_STEMS[_stem] = (_stem + "다", "Adjective")
for _stem in "좋아하 공부하 일하 사랑하 말하 생각하".split():
    KO_STEMS[_stem] = (_stem + "다", "Verb")

# verb endings (eomi), matched longest-first AFTER de-contraction
_KO_EOMI = ("습니다", "ㅂ니다", "었습니다", "았습니다", "어요", "아요",
            "었어요", "았어요", "었다", "았다", "는다", "ㄴ다", "지만",
            "어서", "아서", "으면", "고", "면", "게", "기", "며", "다")
_KO_EOMI_BY_LEN = tuple(sorted(_KO_EOMI, key=len, reverse=True))
_JOSA_BY_LEN = tuple(sorted(_JOSA, key=len, reverse=True))


@_dc.dataclass(frozen=True)
class KoMorpheme:
    """twitter-korean-text KoreanToken analogue: surface + KoreanPos tag
    + dictionary base form for inflected stems."""

    surface: str
    pos: str                      # Noun/Verb/Adjective/Josa/Eomi/...
    base: Optional[str] = None    # 가 -> 가다 for verb/adjective stems


class KoreanMorphologicalAnalyzer:
    """Morphology-based Korean analysis (the reference tokenizer's
    capability): eojeol -> stem + josa / eomi with POS tags and
    de-conjugated dictionary forms."""

    def __init__(self, user_nouns=None):
        self.nouns = set(KO_NOUNS)
        if user_nouns:
            self.nouns.update(user_nouns)

    # ---- de-contraction: expand 갔 -> 가았, 왔 -> 오았, 했 -> 하았 ----
    @staticmethod
    def _expand_past(word: str) -> List[str]:
        out: List[str] = []
        for i, ch in enumerate(word):
            d = _hangul_decompose(ch)
            if d is None or d[2] != _JONG_SS:
                continue
            ini, vow, _ = d
            for stem_vow, past in _PAST_BY_VOWEL.get(vow, ()):
                stem_ch = _hangul_compose(ini, stem_vow, 0)
                out.append(word[:i] + stem_ch + past + word[i + 1:])
        return out

    # batchim-contracted eomi: the ending's initial consonant fuses into
    # the stem's final open syllable as a jongseong — 배우+ㄴ다→배운다,
    # 일하+ㅂ니다→일합니다. Decompose arithmetically like the past
    # contraction: (jongseong index, compatibility-jamo ending prefix).
    _BATCHIM_EOMI = ((4, "ㄴ"), (17, "ㅂ"))   # ㄴ(는다 row), ㅂ(니다 row)

    @classmethod
    def _expand_batchim(cls, word: str) -> List[str]:
        out: List[str] = []
        for i, ch in enumerate(word):
            d = _hangul_decompose(ch)
            if d is None:
                continue
            ini, vow, fin = d
            for jong, jamo in cls._BATCHIM_EOMI:
                if fin == jong:
                    out.append(word[:i] + _hangul_compose(ini, vow, 0)
                               + jamo + word[i + 1:])
        return out

    def _try_stem(self, w: str):
        """Match stem + eomi (after de-contraction); None if not verbal."""
        for cand in (w, *self._expand_past(w), *self._expand_batchim(w)):
            for eomi in _KO_EOMI_BY_LEN:
                if not cand.endswith(eomi) or len(cand) <= len(eomi):
                    continue
                stem = cand[:-len(eomi)]
                if stem in KO_STEMS:
                    base, pos = KO_STEMS[stem]
                    return [KoMorpheme(stem, pos, base),
                            KoMorpheme(eomi, "Eomi")]
        return None

    def _split_josa(self, w: str):
        for josa in _JOSA_BY_LEN:
            if len(w) > len(josa) and w.endswith(josa):
                return w[:-len(josa)], josa
        return w, None

    def analyze(self, text: str) -> List[KoMorpheme]:
        out: List[KoMorpheme] = []
        for word in text.split():
            core = word.strip(".,!?…·()[]\"'")
            at = word.find(core) if core else len(word)
            for ch in word[:at]:
                out.append(KoMorpheme(ch, "Punctuation"))
            if core:
                out.extend(self._analyze_word(core))
            for ch in word[at + len(core):]:
                out.append(KoMorpheme(ch, "Punctuation"))
        return out

    def _analyze_word(self, w: str) -> List[KoMorpheme]:
        if w.isdigit():
            return [KoMorpheme(w, "Number")]
        if all(_char_class(c) != "hangul" for c in w):
            return [KoMorpheme(w, "Foreign")]
        verbal = self._try_stem(w)
        if verbal is not None:
            return verbal
        # closed-class exact matches BEFORE the josa split: 같이 is the
        # adverb, not 같+이 (noun+josa)
        if w in KO_PRONOUNS:
            return [KoMorpheme(w, "Pronoun")]
        if w in KO_ADVERBS:
            return [KoMorpheme(w, "Adverb")]
        stem, josa = self._split_josa(w)
        if josa is not None:
            morphs = (self._try_stem(stem)
                      if stem not in self.nouns
                      and stem not in KO_PRONOUNS else None)
            if morphs is None:
                pos = "Pronoun" if stem in KO_PRONOUNS else "Noun"
                morphs = [KoMorpheme(stem, pos)]
            return morphs + [KoMorpheme(josa, "Josa")]
        return [KoMorpheme(w, "Noun")]


class KoreanMorphologicalTokenizerFactory(TokenizerFactory):
    """Tokenizer over the morphological analysis (the reference
    KoreanTokenizer emits every morpheme — stems AND particles — as
    tokens; `KoreanTokenizer.java:41-48`)."""

    def __init__(self, keep_particles: bool = False, user_nouns=None):
        super().__init__()
        self.keep_particles = keep_particles
        self._an = KoreanMorphologicalAnalyzer(user_nouns)

    def create(self, text: str) -> Tokenizer:
        toks = []
        for m in self._an.analyze(text):
            if m.pos == "Punctuation":
                continue
            if not self.keep_particles and m.pos in ("Josa", "Eomi"):
                continue
            toks.append(m.surface)
        return _ListTokenizer(toks, self._pre)


# --------------------------------------------------------------------------
# Chinese part-of-speech tagging (ansj nature analogue)
# --------------------------------------------------------------------------
# Reference: `deeplearning4j-nlp-chinese/.../ChineseTokenizer.java` wraps
# the ansj analyzer, whose terms carry a "nature" POS tag (n/v/a/d/r/
# m/q/p/c/u/w/en). Same tag alphabet here over the lattice segmentation.

_ZH_POS: dict = {}
for _w in "的 了 着 过 之 地 得 吗 呢 吧 啊".split():
    _ZH_POS[_w] = "u"        # particle (incl. sentence-final 吗/呢/吧/啊)
for _w in ("我 你 他 她 它 我们 你们 他们 她们 自己 大家 这 那 这个 那个 "
           "什么 谁").split():
    _ZH_POS[_w] = "r"        # pronoun
for _w in ("是 有 来 到 说 去 会 要 知道 喜欢 觉得 认为 希望 需要 学习 "
           "工作 研究 发展 开始 结束 出 可以 没有 听 看 想 走 吃 喝 写 "
           "买 卖 读 用").split():
    _ZH_POS[_w] = "v"        # verb
for _w in "大 小 好 新 高 美 多 少 长 短 快 慢".split():
    _ZH_POS[_w] = "a"        # adjective
for _w in "很 也 就 都 不 还 已经 再 只 更 最".split():
    _ZH_POS[_w] = "d"        # adverb
for _w in "在 从 对 为 把 被 向 于 给".split():
    _ZH_POS[_w] = "p"        # preposition
for _w in "和 与 或 但是 因为 所以 如果 虽然 而且".split():
    _ZH_POS[_w] = "c"        # conjunction
for _w in "个 只 本 张 条 件 位 次 种 年 岁".split():
    _ZH_POS[_w] = "q"        # measure word (incl. time-quantity 年/岁)
for _w in "一 二 三 四 五 六 七 八 九 十 百 千 万 亿 两".split():
    _ZH_POS[_w] = "m"        # numeral


@_dc.dataclass(frozen=True)
class ZhTerm:
    """ansj Term analogue: surface + nature (POS) tag."""

    surface: str
    nature: str


class ChineseMorphologicalAnalyzer:
    """Segmentation + ansj-style nature tagging: dictionary tags for the
    closed classes, digit/latin/punct detection, noun default (ansj's
    unknown-word behavior)."""

    def __init__(self, dictionary=None, user_pos=None):
        self._factory = ChineseTokenizerFactory(dictionary)
        self._pos = dict(_ZH_POS)
        if user_pos:
            self._pos.update(user_pos)

    def analyze(self, text: str) -> List[ZhTerm]:
        out: List[ZhTerm] = []
        for tok in self._factory.create(text).tokens():
            for piece in tok.split():
                out.append(ZhTerm(piece, self._tag(piece)))
        return out

    def _tag(self, w: str) -> str:
        if w in self._pos:
            return self._pos[w]
        if any(c.isdigit() for c in w) and all(
                c in "0123456789.%" for c in w):
            return "m"
        if all(ord(c) < 128 for c in w):
            return "en" if w[0].isalpha() else "w"
        if all(not c.isalnum() for c in w):
            return "w"
        return "n"
