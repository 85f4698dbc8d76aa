"""WordVectorSerializer (counterpart of deeplearning4j_tpu/nlp/serializer.py;
parity: models/embeddings/loader/WordVectorSerializer.java): Google
word2vec-compatible text AND binary formats + a native npz format carrying
the full training state. The files are the JAX package's byte for byte,
so each package reads what the other writes. `vectors_from_arrays`
builds a model from tables held as arrays (the JAX package's, say).

Reading and writing are host work: a model read from a file keeps its
tables on the host until a fit takes them to its device."""

from __future__ import annotations

import gzip
import io
from typing import Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device

from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.vocab import AbstractCache


class WordVectorSerializer:
    # ---------------- text (w2v-compatible) ----------------
    @staticmethod
    def write_word_vectors(model: SequenceVectors, path):
        """First line: "<vocab> <dim>", then "word v1 v2 ..." per word."""
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "wt", encoding="utf-8") as f:
            V, D = model.syn0.shape
            f.write(f"{V} {D}\n")
            for i in range(V):
                word = model.vocab.word_at_index(i)
                vec = " ".join(f"{v:.6f}" for v in model.syn0[i])
                f.write(f"{word} {vec}\n")

    writeWordVectors = write_word_vectors

    # ---------------- binary (Google word2vec .bin) ----------------
    @staticmethod
    def write_word_vectors_binary(model: SequenceVectors, path):
        """Google word2vec .bin layout (the loadGoogleModel/
        writeWordVectors binary path): "<vocab> <dim>\n" header, then
        per word: "<word> " + dim little-endian f32s + "\n"."""
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "wb") as f:
            V, D = model.syn0.shape
            f.write(f"{V} {D}\n".encode())
            for i in range(V):
                f.write(model.vocab.word_at_index(i).encode("utf-8"))
                f.write(b" ")
                f.write(np.asarray(model.syn0[i],
                                   "<f4").tobytes())
                f.write(b"\n")

    @staticmethod
    def read_word_vectors_binary(path) -> SequenceVectors:
        """Read a Google word2vec .bin (incl. files written by the
        original C tool: the trailing newline after each vector is
        optional there, so it is consumed only if present)."""
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rb") as raw:
            f = raw if str(path).endswith(".gz") \
                else io.BufferedReader(raw)
            header = f.readline().split()
            V, D = int(header[0]), int(header[1])
            words, vecs = [], np.empty((V, D), np.float32)
            for i in range(V):
                chars = []
                while True:
                    c = f.read(1)
                    if not c or c == b" ":
                        break
                    if c == b"\n":       # some writers pad with \n
                        continue
                    chars.append(c)
                words.append(b"".join(chars).decode("utf-8"))
                vecs[i] = np.frombuffer(f.read(4 * D), "<f4")
            if len(set(words)) != len(words):
                raise ValueError(
                    "duplicate words in binary word-vector file")
            model = SequenceVectors(layer_size=D)
            for w in words:
                model.vocab.add_token(w)
            model.vocab.finalize_vocab()
            # preserve file order: map rows by vocab index
            syn0 = np.empty_like(vecs)
            for w, v in zip(words, vecs):
                syn0[model.vocab.index_of(w)] = v
            model.syn0 = syn0
            return model

    writeWordVectorsBinary = write_word_vectors_binary
    readWordVectorsBinary = read_word_vectors_binary

    @staticmethod
    def read_word_vectors(path) -> SequenceVectors:
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            first = f.readline().split()
            has_header = len(first) == 2
            if has_header:
                V, D = int(first[0]), int(first[1])
                rows = []
            else:
                rows = [first]
                D = len(first) - 1
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) >= 2:
                    rows.append(parts)
        model = SequenceVectors(layer_size=D)
        vecs = [np.asarray([float(v) for v in r[1:]], np.float32)
                for r in rows]
        # file order, not finalize's (count, then alphabetical)
        model.vocab = _ordered_cache([r[0] for r in rows])
        model.syn0 = np.stack(vecs)
        return model

    loadTxtVectors = read_word_vectors

    # ---------------- native (full state) ----------------
    @staticmethod
    def write_full_model(model: SequenceVectors, path):
        words = "\n".join(model.vocab.words())
        counts = model.vocab.counts()
        arrays = {"syn0": model.syn0, "counts": counts,
                  "words": np.frombuffer(words.encode(), np.uint8)}
        if model.syn1 is not None:
            arrays["syn1"] = model.syn1
        if model.syn1neg is not None:
            arrays["syn1neg"] = model.syn1neg
        np.savez_compressed(path, **arrays)

    @staticmethod
    def read_full_model(path) -> SequenceVectors:
        with np.load(path) as z:
            words = bytes(z["words"]).decode().split("\n")
            counts = z["counts"]
            syn0 = z["syn0"]
            syn1 = z["syn1"] if "syn1" in z.files else None
            syn1neg = z["syn1neg"] if "syn1neg" in z.files else None
        model = SequenceVectors(layer_size=syn0.shape[1])
        model.vocab = _ordered_cache(words, counts)
        model.syn0 = syn0
        model.syn1 = syn1
        model.syn1neg = syn1neg
        return model


def _ordered_cache(words, counts=None) -> AbstractCache:
    """A finalized vocab whose indices follow `words`' order (finalize
    sorts by count, then alphabetically)."""
    cache = AbstractCache()
    for i, w in enumerate(words):
        cache.add_token(w, 1.0 if counts is None else float(counts[i]))
    cache.finalize_vocab()
    cache._by_index = [cache._words[w] for w in words]
    for i, vw in enumerate(cache._by_index):
        vw.index = i
    return cache


def vectors_from_arrays(words: Sequence[str], counts, syn0, syn1=None,
                        syn1neg=None, device=None) -> SequenceVectors:
    """The port's model from tables held as arrays — a trained JAX
    model's `vocab.words()`, `vocab.counts()`, `syn0`, `syn1`, `syn1neg`,
    say — with row i of each table belonging to words[i]. The tables are
    copied onto `device` (None: CUDA); the vocab keeps the given order and
    counts, and gets its Huffman codes when syn1 is given (hierarchical
    softmax) and its negative-sampling distribution when syn1neg is given,
    so a fit can continue from this state once the training settings
    (window, epochs, seed, ...) are set on the model."""
    dev = resolve_device(device)
    words = [str(w) for w in words]
    if len(set(words)) != len(words):
        raise ValueError("duplicate words")
    syn0 = np.asarray(syn0, np.float32)
    if syn0.ndim != 2 or syn0.shape[0] != len(words):
        raise ValueError(f"syn0 {syn0.shape} for {len(words)} words")
    model = SequenceVectors(layer_size=syn0.shape[1],
                            negative=5 if syn1neg is not None else 0,
                            use_hierarchic_softmax=syn1 is not None,
                            device=dev)
    model.vocab = _ordered_cache(words, np.asarray(counts, np.float64))
    model._vocab_tables()
    model._syn0_dev = torch.tensor(syn0, device=dev)
    if syn1 is not None:
        model._syn1_dev = torch.tensor(np.asarray(syn1, np.float32),
                                       device=dev)
    if syn1neg is not None:
        model._syn1neg_dev = torch.tensor(np.asarray(syn1neg, np.float32),
                                          device=dev)
    return model
