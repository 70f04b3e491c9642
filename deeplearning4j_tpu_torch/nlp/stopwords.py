"""Stop-word list + filtering preprocessor.

A copy of `deeplearning4j_tpu/nlp/stopwords.py`,
which imports nothing of JAX: the port keeps its own.

Reference parity: `deeplearning4j-nlp/src/main/resources/stopwords.txt`
loaded by `text/stopwords/StopWords.java` (getStopWords()) and applied in
the Word2Vec/vocab pipelines. The embedded list here is the standard
English closed-class set (articles, pronouns, auxiliaries, prepositions,
conjunctions — the usual NLTK-style inventory), not a copy of the
reference resource; `StopWords.get_stop_words(extra=...)` extends it.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Set

from deeplearning4j_tpu_torch.nlp.tokenization import TokenPreProcess

_ENGLISH = """
a about above after again against all am an and any are aren't as at be
because been before being below between both but by can't cannot could
couldn't did didn't do does doesn't doing don't down during each few for
from further had hadn't has hasn't have haven't having he he'd he'll he's
her here here's hers herself him himself his how how's i i'd i'll i'm
i've if in into is isn't it it's its itself let's me more most mustn't
my myself no nor not of off on once only or other ought our ours
ourselves out over own same shan't she she'd she'll she's should
shouldn't so some such than that that's the their theirs them themselves
then there there's these they they'd they'll they're they've this those
through to too under until up very was wasn't we we'd we'll we're we've
were weren't what what's when when's where where's which while who who's
whom why why's with won't would wouldn't you you'd you'll you're you've
your yours yourself yourselves
""".split()


class StopWords:
    """Reference: `text/stopwords/StopWords.java` — getStopWords()."""

    @staticmethod
    def get_stop_words(extra: Optional[Iterable[str]] = None) -> List[str]:
        return list(_ENGLISH) + (list(extra) if extra else [])


class StopWordsRemovalPreprocessor(TokenPreProcess):
    """TokenPreProcess mapping stop words to "" (tokenizers drop empty
    tokens), composing with any inner preprocessor — how the reference
    pipelines filter stop words before vocab construction.

    The stop set is normalized THROUGH the inner preprocessor, so e.g.
    CommonPreprocessor stripping apostrophes ("don't" -> "dont") can't
    let contraction stop words slip past the lookup."""

    def __init__(self, stop_words: Optional[Iterable[str]] = None,
                 inner: Optional[TokenPreProcess] = None,
                 case_sensitive: bool = False):
        words = (list(stop_words) if stop_words is not None
                 else StopWords.get_stop_words())
        self.case_sensitive = case_sensitive
        self.inner = inner
        norm = (lambda w: w) if case_sensitive else str.lower
        self._set: Set[str] = set()
        for w in words:
            self._set.add(norm(w))
            if inner is not None:
                self._set.add(norm(inner.pre_process(w)))
        self._set.discard("")

    def pre_process(self, token: str) -> str:
        if self.inner is not None:
            token = self.inner.pre_process(token)
        key = token if self.case_sensitive else token.lower()
        return "" if key in self._set else token
