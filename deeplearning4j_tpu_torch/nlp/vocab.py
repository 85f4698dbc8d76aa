"""Vocabulary: VocabWord, vocab cache, Huffman coding (parity:
models/word2vec/wordstore/inmemory/AbstractCache.java,
models/word2vec/VocabWord.java, graph/huffman/ Huffman tree used for
hierarchical softmax).

The port's counterpart (host-only; a copy of
deeplearning4j_tpu/nlp/vocab.py: the Huffman codes and points are the
JAX package's exactly)."""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional

import numpy as np


class VocabWord:
    __slots__ = ("word", "count", "index", "codes", "points")

    def __init__(self, word: str, count: float = 1.0):
        self.word = word
        self.count = count
        self.index = -1
        self.codes: List[int] = []    # Huffman code (0/1 per tree level)
        self.points: List[int] = []   # inner-node indices along the path

    def increment(self, by: float = 1.0):
        self.count += by

    def __repr__(self):
        return f"VocabWord({self.word!r}, n={self.count})"


class AbstractCache:
    """In-memory vocab cache (ref: AbstractCache.java)."""

    def __init__(self, min_word_frequency: int = 1):
        self.min_word_frequency = min_word_frequency
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []
        self.total_word_count = 0.0

    def add_token(self, word: str, by: float = 1.0):
        vw = self._words.get(word)
        if vw is None:
            vw = VocabWord(word, 0.0)
            self._words[word] = vw
        vw.increment(by)
        self.total_word_count += by
        return vw

    def finalize_vocab(self):
        """Apply min frequency, sort by count desc, assign indices."""
        kept = [w for w in self._words.values()
                if w.count >= self.min_word_frequency]
        kept.sort(key=lambda w: (-w.count, w.word))
        self._by_index = kept
        self._words = {w.word: w for w in kept}
        for i, w in enumerate(kept):
            w.index = i
        return self

    def contains_word(self, word: str) -> bool:
        return word in self._words

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return -1 if vw is None else vw.index

    def word_at_index(self, idx: int) -> str:
        return self._by_index[idx].word

    def num_words(self) -> int:
        return len(self._by_index)

    def words(self) -> List[str]:
        return [w.word for w in self._by_index]

    def vocab_words(self) -> List[VocabWord]:
        return list(self._by_index)

    def counts(self) -> np.ndarray:
        return np.asarray([w.count for w in self._by_index], np.float64)


def build_huffman(cache: AbstractCache) -> int:
    """Assign Huffman codes/points to every vocab word; returns the max
    code length (ref: the Huffman build inside buildVocab —
    SequenceVectors.java:207 area / graph/huffman/GraphHuffman.java).

    Inner nodes are numbered 0..V-2; each word's `points` lists the inner
    nodes from root to its leaf's parent, `codes` the 0/1 branch taken.
    """
    words = cache.vocab_words()
    V = len(words)
    if V == 0:
        return 0
    # heap of (count, uid, node); node = leaf index i<V or inner V+j
    heap = [(w.count, i, i) for i, w in enumerate(words)]
    heapq.heapify(heap)
    parent = {}
    binary = {}
    next_inner = V
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        inner = next_inner
        next_inner += 1
        parent[n1] = inner
        parent[n2] = inner
        binary[n1] = 0
        binary[n2] = 1
        heapq.heappush(heap, (c1 + c2, inner, inner))
    max_len = 0
    for i, w in enumerate(words):
        codes, points = [], []
        node = i
        while node in parent:
            codes.append(binary[node])
            points.append(parent[node] - V)  # inner-node id 0..V-2
            node = parent[node]
        codes.reverse()
        points.reverse()
        w.codes = codes
        w.points = points
        max_len = max(max_len, len(codes))
    return max_len
