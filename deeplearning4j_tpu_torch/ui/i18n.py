"""UI internationalization layer.

A copy of `deeplearning4j_tpu/ui/i18n.py`, which imports nothing of JAX:
the port keeps its own.

Reference parity: `ui/i18n/I18N.java` + `DefaultI18N.java` (singleton,
`getMessage(key)` / `getMessage(langCode, key)`, current-language state,
"en" fallback when a key is missing in the selected language) and the
`dl4j_i18n/train.<lang>` property resources. The reference loads
`key=value` property files per language from the classpath; here the
same key naming (`train.nav.*`, `train.pagetitle`, ...) is served from
in-module tables, and `load_properties` ingests external `key=value`
text for user-supplied languages — the DEFAULT_I8N_RESOURCES_DIR seam.
"""

from __future__ import annotations

from typing import Dict, Optional

DEFAULT_LANGUAGE = "en"
FALLBACK_LANGUAGE = "en"

# Page-chrome messages for the six languages the reference ships
# (dl4j_i18n/train.{de,en,ja,ko,ru,zh}); keys follow the reference's
# naming so Keras-era muscle memory (and tests) transfer.
_MESSAGES: Dict[str, Dict[str, str]] = {
    "en": {
        "train.pagetitle": "DL4J-TPU Training UI",
        "train.nav.overview": "Overview",
        "train.nav.model": "Model",
        "train.nav.system": "System",
        "train.nav.histogram": "Histograms",
        "train.nav.flow": "Flow",
        "train.nav.tsne": "t-SNE",
        "train.nav.activations": "Activations",
        "train.nav.language": "Language",
        "train.session.label": "Session",
        "train.session.worker.label": "Worker",
        "train.overview.chart.scoreTitle": "Score vs. Iteration",
        "train.activations.title": "Convolutional layer activations",
    },
    "de": {
        "train.pagetitle": "DL4J-TPU Trainings-UI",
        "train.nav.overview": "Übersicht",
        "train.nav.model": "Modell",
        "train.nav.system": "System",
        "train.nav.histogram": "Histogramme",
        "train.nav.flow": "Fluss",
        "train.nav.tsne": "t-SNE",
        "train.nav.activations": "Aktivierungen",
        "train.nav.language": "Sprache",
        "train.session.label": "Sitzung",
        "train.session.worker.label": "Arbeiter",
        "train.overview.chart.scoreTitle": "Score pro Iteration",
        "train.activations.title": "Aktivierungen der Faltungsschichten",
    },
    "ja": {
        "train.pagetitle": "DL4J-TPU トレーニングUI",
        "train.nav.overview": "概要",
        "train.nav.model": "モデル",
        "train.nav.system": "システム",
        "train.nav.histogram": "ヒストグラム",
        "train.nav.flow": "フロー",
        "train.nav.tsne": "t-SNE",
        "train.nav.activations": "活性化",
        "train.nav.language": "言語",
        "train.session.label": "セッション",
        "train.session.worker.label": "ワーカー",
        "train.overview.chart.scoreTitle": "スコア対反復",
        "train.activations.title": "畳み込み層の活性化",
    },
    "ko": {
        "train.pagetitle": "DL4J-TPU 트레이닝 UI",
        "train.nav.overview": "개요",
        "train.nav.model": "모델",
        "train.nav.system": "시스템",
        "train.nav.histogram": "히스토그램",
        "train.nav.flow": "플로우",
        "train.nav.tsne": "t-SNE",
        "train.nav.activations": "활성화",
        "train.nav.language": "언어",
        "train.session.label": "세션",
        "train.session.worker.label": "워커",
        "train.overview.chart.scoreTitle": "반복별 점수",
        "train.activations.title": "합성곱 계층 활성화",
    },
    "ru": {
        "train.pagetitle": "DL4J-TPU интерфейс обучения",
        "train.nav.overview": "Обзор",
        "train.nav.model": "Модель",
        "train.nav.system": "Система",
        "train.nav.histogram": "Гистограммы",
        "train.nav.flow": "Поток",
        "train.nav.tsne": "t-SNE",
        "train.nav.activations": "Активации",
        "train.nav.language": "Язык",
        "train.session.label": "Сессия",
        "train.session.worker.label": "Воркер",
        "train.overview.chart.scoreTitle": "Оценка по итерациям",
        "train.activations.title": "Активации сверточных слоев",
    },
    "zh": {
        "train.pagetitle": "DL4J-TPU 训练界面",
        "train.nav.overview": "概览",
        "train.nav.model": "模型",
        "train.nav.system": "系统",
        "train.nav.histogram": "直方图",
        "train.nav.flow": "流程",
        "train.nav.tsne": "t-SNE",
        "train.nav.activations": "激活",
        "train.nav.language": "语言",
        "train.session.label": "会话",
        "train.session.worker.label": "工作器",
        "train.overview.chart.scoreTitle": "每次迭代的得分",
        "train.activations.title": "卷积层激活",
    },
}


class DefaultI18N:
    """Singleton i18n service (reference: `DefaultI18N.getInstance()`)."""

    _instance: Optional["DefaultI18N"] = None

    def __init__(self):
        self._messages: Dict[str, Dict[str, str]] = {
            lang: dict(table) for lang, table in _MESSAGES.items()
        }
        self._current = DEFAULT_LANGUAGE

    @classmethod
    def get_instance(cls) -> "DefaultI18N":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    # ---- reference I18N interface ----
    def get_message(self, key: str, lang: Optional[str] = None) -> str:
        """getMessage(key) / getMessage(langCode, key): selected language,
        then the "en" fallback, then the key itself (so a missing
        translation degrades visibly but harmlessly)."""
        lang = lang or self._current
        for table in (self._messages.get(lang),
                      self._messages.get(FALLBACK_LANGUAGE)):
            if table and key in table:
                return table[key]
        return key

    def get_default_language(self) -> str:
        return self._current

    def set_default_language(self, lang: str) -> None:
        self._current = lang

    def languages(self):
        return sorted(self._messages)

    def load_properties(self, lang: str, text: str) -> None:
        """Ingest a `key=value` properties blob for a language — the
        analogue of dropping a `train.<lang>` file into
        DEFAULT_I8N_RESOURCES_DIR."""
        table = self._messages.setdefault(lang, {})
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, _, v = line.partition("=")
            table[k.strip()] = v.strip()


def i18n() -> DefaultI18N:
    return DefaultI18N.get_instance()
