"""Word2Vec (counterpart of deeplearning4j_tpu/nlp/word2vec.py; parity:
models/word2vec/Word2Vec.java — a Builder facade over the SequenceVectors
framework)."""

from __future__ import annotations

from typing import Iterable, Optional

from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory


class Word2Vec(SequenceVectors):
    """Train word embeddings from a sentence iterator + tokenizer."""

    def __init__(self, **kw):
        self._sentence_iterator = kw.pop("sentence_iterator", None)
        self._tokenizer_factory = kw.pop("tokenizer_factory",
                                         DefaultTokenizerFactory())
        super().__init__(**kw)

    class Builder:
        def __init__(self):
            self._kw = {}
            self._iter = None
            self._tok = None

        def layer_size(self, v):
            self._kw["layer_size"] = int(v)
            return self

        def window_size(self, v):
            self._kw["window"] = int(v)
            return self

        def negative_sample(self, v):
            self._kw["negative"] = int(v)
            return self

        def use_hierarchic_softmax(self, v=True):
            self._kw["use_hierarchic_softmax"] = bool(v)
            return self

        def elements_learning_algorithm(self, name):
            """'SkipGram' (default) or 'CBOW'
            (ref Word2Vec.Builder.elementsLearningAlgorithm)."""
            n = str(name).lower()
            if n not in ("skipgram", "cbow"):
                raise ValueError(
                    f"unknown elements learning algorithm '{name}' "
                    "(SkipGram | CBOW)")
            self._kw["use_cbow"] = n == "cbow"
            return self

        def use_cbow(self, v=True):
            self._kw["use_cbow"] = bool(v)
            return self

        def mode(self, v):
            """Training tier: None (auto), 'scan' (sequential-fidelity
            chunked updates) or 'dense' (native epoch builder + slab
            device updates; the high-throughput path)."""
            self._kw["mode"] = v
            return self

        def min_word_frequency(self, v):
            self._kw["min_word_frequency"] = int(v)
            return self

        def learning_rate(self, v):
            self._kw["learning_rate"] = float(v)
            return self

        def min_learning_rate(self, v):
            self._kw["min_learning_rate"] = float(v)
            return self

        def epochs(self, v):
            self._kw["epochs"] = int(v)
            return self

        def iterations(self, v):
            return self  # per-batch iterations: legacy no-op

        def batch_size(self, v):
            self._kw["batch_size"] = int(v)
            return self

        def sampling(self, v):
            self._kw["sampling"] = float(v)
            return self

        def seed(self, v):
            self._kw["seed"] = int(v)
            return self

        def device(self, v):
            """Where the tables train (None: CUDA; "cpu" as asked)."""
            self._kw["device"] = v
            return self

        def iterate(self, sentence_iterator):
            self._iter = sentence_iterator
            return self

        def tokenizer_factory(self, tf):
            self._tok = tf
            return self

        def build(self) -> "Word2Vec":
            w2v = Word2Vec(**self._kw)
            w2v._sentence_iterator = self._iter
            if self._tok is not None:
                w2v._tokenizer_factory = self._tok
            return w2v

    def _sequences(self) -> Iterable:
        if self._sentence_iterator is None:
            raise ValueError("no sentence iterator configured (.iterate())")
        for sentence in self._sentence_iterator:
            toks = self._tokenizer_factory.create(sentence).get_tokens()
            if toks:
                yield toks

    def fit(self, sequences: Optional[Iterable] = None):
        if sequences is None:
            sequences = list(self._sequences())
        return super().fit(sequences)
