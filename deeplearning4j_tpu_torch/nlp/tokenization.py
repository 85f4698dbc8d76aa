"""Tokenizers + token preprocessors (parity: deeplearning4j-nlp
text/tokenization/tokenizer/ — DefaultTokenizerFactory,
CommonPreprocessor, EndingPreProcessor, NGramTokenizerFactory).

The port's counterpart (host-only; a copy of
deeplearning4j_tpu/nlp/tokenization.py)."""

from __future__ import annotations

import re
from typing import List, Optional


class TokenPreProcess:
    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits (ref: CommonPreprocessor)."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


class EndingPreProcessor(TokenPreProcess):
    """Crude stemmer used by the reference examples
    (ref: EndingPreProcessor.java)."""

    def pre_process(self, token: str) -> str:
        for suf in ("sses", "ies", "ing", "ed", "s"):
            if token.endswith(suf) and len(token) > len(suf) + 2:
                if suf == "sses":
                    return token[:-2]
                if suf == "ies":
                    return token[:-3] + "y"
                return token[: -len(suf)]
        return token


_DEFAULT_STOP_WORDS = frozenset("""
a an and are as at be but by for if in into is it no not of on or such
that the their then there these they this to was will with i you he she
we me him her his hers its our your yours them what which who whom
""".split())


class StopWords:
    """Default English stop-word list (ref: text/stopwords/StopWords.java
    loading stopwords from the bundled resource)."""

    @staticmethod
    def get_stop_words() -> List[str]:
        return sorted(_DEFAULT_STOP_WORDS)


class StopWordsPreProcessor(TokenPreProcess):
    """Drops stop words (returns '' so the Tokenizer filters them);
    composes with a base preprocessor applied first."""

    def __init__(self, stop_words=None,
                 base: Optional[TokenPreProcess] = None):
        self.stop = frozenset(w.lower() for w in (
            stop_words if stop_words is not None else _DEFAULT_STOP_WORDS))
        self.base = base

    def pre_process(self, token: str) -> str:
        if self.base is not None:
            token = self.base.pre_process(token)
        return "" if token.lower() in self.stop else token


class Tokenizer:
    def __init__(self, tokens: List[str],
                 preprocessor: Optional[TokenPreProcess] = None):
        self._tokens = tokens
        self._pre = preprocessor

    def get_tokens(self) -> List[str]:
        if self._pre is None:
            return [t for t in self._tokens if t]
        out = []
        for t in self._tokens:
            t = self._pre.pre_process(t)
            if t:
                out.append(t)
        return out

    def count_tokens(self) -> int:
        return len(self.get_tokens())


class DefaultTokenizerFactory:
    """Whitespace/streaming tokenizer (ref: DefaultTokenizerFactory.java)."""

    def __init__(self):
        self._pre: Optional[TokenPreProcess] = None

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self._pre = pre
        return self

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(text.split(), self._pre)


class NGramTokenizerFactory:
    """Word n-grams over a base tokenizer (ref: NGramTokenizerFactory.java)."""

    def __init__(self, base: DefaultTokenizerFactory, min_n: int, max_n: int):
        self.base = base
        self.min_n = min_n
        self.max_n = max_n

    def create(self, text: str) -> Tokenizer:
        toks = self.base.create(text).get_tokens()
        out = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(toks) - n + 1):
                out.append(" ".join(toks[i:i + n]))
        return Tokenizer(out)
