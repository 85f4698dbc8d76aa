"""Count-based vectorizers (parity: deeplearning4j-nlp
bagofwords/vectorizer/ — BagOfWordsVectorizer, TfidfVectorizer).

The port's counterpart (host-only NumPy; a copy of
deeplearning4j_tpu/nlp/vectorizers.py)."""

from __future__ import annotations

import math
from typing import Iterable, List

import numpy as np

from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import AbstractCache


class BagOfWordsVectorizer:
    def __init__(self, tokenizer_factory=None, min_word_frequency: int = 1):
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.vocab = AbstractCache(min_word_frequency)
        self._doc_freq = {}
        self.n_docs = 0

    def fit(self, documents: Iterable[str]):
        for doc in documents:
            self.n_docs += 1
            toks = self.tokenizer_factory.create(doc).get_tokens()
            for t in toks:
                self.vocab.add_token(t)
            for t in set(toks):
                self._doc_freq[t] = self._doc_freq.get(t, 0) + 1
        self.vocab.finalize_vocab()
        return self

    def transform(self, documents) -> np.ndarray:
        if isinstance(documents, str):
            documents = [documents]
        V = self.vocab.num_words()
        out = np.zeros((len(documents), V), np.float32)
        for di, doc in enumerate(documents):
            for t in self.tokenizer_factory.create(doc).get_tokens():
                i = self.vocab.index_of(t)
                if i >= 0:
                    out[di, i] += self._weight(t, out[di, i])
        return out

    def _weight(self, token, current):
        return 1.0  # raw count increments

    def fit_transform(self, documents: List[str]) -> np.ndarray:
        self.fit(documents)
        return self.transform(documents)


class TfidfVectorizer(BagOfWordsVectorizer):
    def transform(self, documents) -> np.ndarray:
        counts = super().transform(documents)
        V = self.vocab.num_words()
        idf = np.zeros(V, np.float32)
        for i in range(V):
            df = self._doc_freq.get(self.vocab.word_at_index(i), 0)
            idf[i] = math.log((1 + self.n_docs) / (1 + df)) + 1.0
        tf = counts / np.maximum(counts.sum(axis=1, keepdims=True), 1.0)
        return tf * idf
