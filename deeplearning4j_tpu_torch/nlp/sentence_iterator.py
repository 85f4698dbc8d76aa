"""Sentence/document iterators (parity: deeplearning4j-nlp
text/sentenceiterator/ — BasicLineIterator, CollectionSentenceIterator,
with optional SentencePreProcessor) and LabelAwareIterator for
ParagraphVectors (text/documentiterator/).

The port's counterpart (host-only; a copy of
deeplearning4j_tpu/nlp/sentence_iterator.py)."""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional


class SentenceIterator:
    def __iter__(self):
        self.reset()
        return self._gen()

    def _gen(self):
        raise NotImplementedError

    def reset(self):
        pass


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Iterable[str],
                 preprocessor: Optional[Callable[[str], str]] = None):
        self.sentences = list(sentences)
        self.preprocessor = preprocessor

    def _gen(self):
        for s in self.sentences:
            yield self.preprocessor(s) if self.preprocessor else s


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a file (ref: BasicLineIterator.java)."""

    def __init__(self, path,
                 preprocessor: Optional[Callable[[str], str]] = None):
        self.path = str(path)
        self.preprocessor = preprocessor

    def _gen(self):
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield (self.preprocessor(line) if self.preprocessor
                           else line)


class LabelledDocument:
    def __init__(self, content: str, labels: List[str]):
        self.content = content
        self.labels = labels


class SimpleLabelAwareIterator:
    """Documents with labels for ParagraphVectors
    (ref: text/documentiterator/SimpleLabelAwareIterator.java)."""

    def __init__(self, documents: Iterable[LabelledDocument]):
        self.documents = list(documents)

    def __iter__(self):
        return iter(self.documents)

    def reset(self):
        pass


class FileSentenceIterator(SentenceIterator):
    """All files under a directory, one sentence per line
    (ref: FileSentenceIterator.java)."""

    def __init__(self, directory,
                 preprocessor: Optional[Callable[[str], str]] = None):
        import os

        self.directory = str(directory)
        self.preprocessor = preprocessor
        self._files = sorted(
            os.path.join(self.directory, f)
            for f in os.listdir(self.directory)
            if os.path.isfile(os.path.join(self.directory, f)))

    def _gen(self):
        for path in self._files:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield (self.preprocessor(line)
                               if self.preprocessor else line)


class MovingWindowIterator:
    """Fixed-size sliding token windows over sentences
    (ref: text/movingwindow/Windows.java + Window.java): each window is
    `window_size` tokens with the focus word centered; edges are padded
    with <s> / </s> like the reference."""

    PAD_START = "<s>"
    PAD_END = "</s>"

    def __init__(self, sentences: Iterable[str], tokenizer_factory,
                 window_size: int = 5):
        if window_size % 2 == 0:
            raise ValueError("window_size must be odd (centered focus)")
        self.sentences = sentences
        self.tokenizer_factory = tokenizer_factory
        self.window_size = window_size

    def __iter__(self):
        half = self.window_size // 2
        for sentence in self.sentences:
            toks = self.tokenizer_factory.create(sentence).get_tokens()
            if not toks:
                continue
            padded = ([self.PAD_START] * half + toks
                      + [self.PAD_END] * half)
            for i in range(len(toks)):
                window = padded[i:i + self.window_size]
                yield {"words": window, "focus": toks[i],
                       "focus_index": half}
