"""Record-reader data bridge (counterpart of
deeplearning4j_tpu/datasets/records.py; the DataVec role).

Parity: deeplearning4j-core datasets/datavec/
RecordReaderDataSetIterator.java (record stream -> DataSet batches with
label one-hot / regression columns),
SequenceRecordReaderDataSetIterator.java (sequence files -> padded+masked
[B,T,*] batches) and RecordReaderMultiDataSetIterator.java (named
readers + column-range subsets -> MultiDataSet); readers mirror DataVec's
CSVRecordReader / CSVSequenceRecordReader / CollectionRecordReader.

Batches are host numpy DataSets, as the JAX package's; the training
engine's input pipeline stages them on the card. Ragged sequences become
padded batches with masks. `CSVRecordReader.to_matrix` parses a whole
all-numeric file through the port's native loader
(deeplearning4j_tpu_torch/native), which falls back to NumPy with the
same results where no compiler is found.
"""

from __future__ import annotations

import csv
import io
from typing import Iterable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator


# ------------------------------------------------------------------ readers

class RecordReader:
    """A stream of records (lists of string/number values)."""

    def records(self) -> Iterable[List[str]]:
        raise NotImplementedError

    def __iter__(self):
        return iter(self.records())


class CSVRecordReader(RecordReader):
    """ref DataVec CSVRecordReader: optional skipped header lines,
    configurable delimiter/quote."""

    def __init__(self, path: Optional[str] = None, skip_lines: int = 0,
                 delimiter: str = ",", quotechar: str = '"',
                 text: Optional[str] = None):
        if (path is None) == (text is None):
            raise ValueError("give exactly one of path= or text=")
        self.path = path
        self.text = text
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self.quotechar = quotechar

    def records(self):
        fh = open(self.path) if self.path else io.StringIO(self.text)
        try:
            reader = csv.reader(fh, delimiter=self.delimiter,
                                quotechar=self.quotechar)
            for i, row in enumerate(reader):
                if i < self.skip_lines or not row:
                    continue
                yield [v.strip() for v in row]
        finally:
            fh.close()

    def to_matrix(self):
        """Whole-file all-numeric fast path: native C++ CSV->f32 parse
        (native/dl4j_tpu_native.cpp, through the port's loader). Returns
        None when the content needs the general row path (non-numeric
        cells, quoting, or skip_lines)."""
        if self.skip_lines:
            return None
        try:
            from deeplearning4j_tpu_torch.native import parse_csv_f32

            if self.path:
                with open(self.path, "rb") as f:
                    data = f.read()
            else:
                data = self.text.encode()
            if self.quotechar.encode() in data:
                return None
            return parse_csv_f32(data, self.delimiter)
        except ValueError:
            return None


class CollectionRecordReader(RecordReader):
    """In-memory records (ref CollectionRecordReader.java)."""

    def __init__(self, rows: Sequence[Sequence]):
        self.rows = [list(r) for r in rows]

    def records(self):
        return iter(self.rows)


class CSVSequenceRecordReader:
    """One CSV file per sequence; each line is one timestep
    (ref DataVec CSVSequenceRecordReader)."""

    def __init__(self, paths: Sequence[str], skip_lines: int = 0,
                 delimiter: str = ","):
        self.paths = list(paths)
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def sequences(self) -> Iterable[List[List[str]]]:
        for p in self.paths:
            reader = CSVRecordReader(p, self.skip_lines, self.delimiter)
            yield list(reader.records())

    def __iter__(self):
        return iter(self.sequences())


class CollectionSequenceRecordReader:
    """In-memory sequences of records."""

    def __init__(self, seqs: Sequence[Sequence[Sequence]]):
        self.seqs = [[list(r) for r in s] for s in seqs]

    def sequences(self):
        return iter(self.seqs)

    def __iter__(self):
        return iter(self.sequences())


# ----------------------------------------------------------- DataSet bridge

def _one_hot(idx: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((len(idx), n), np.float32)
    out[np.arange(len(idx)), idx.astype(int)] = 1.0
    return out


class RecordReaderDataSetIterator(DataSetIterator):
    """records -> DataSet batches
    (ref RecordReaderDataSetIterator.java).

    Classification: `label_index` column -> one-hot over `num_classes`.
    Regression: `regression=True` with `label_index`(..`label_index_to`)
    as continuous label columns. No label args -> features only."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 label_index_to: Optional[int] = None):
        if label_index is not None and not regression \
                and num_classes is None:
            raise ValueError(
                "classification needs num_classes (or set regression=True)")
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.label_index_to = label_index_to
        self._it = None
        self._buf: Optional[DataSet] = None
        self._native_checked = False
        self._native_batches = None

    def reset(self):
        self._it = None
        self._buf = None
        self._native_checked = False
        self._native_batches = None

    def _rows(self):
        if self._it is None:
            self._it = iter(self.reader)
        return self._it

    def _split(self, rows) -> DataSet:
        """A batch of records (lists of strings or numbers), or a float32
        block of the native path, split into features and labels."""
        arr = (rows if isinstance(rows, np.ndarray)
               else np.asarray(rows, dtype=object))
        li = self.label_index
        if li is None:
            return DataSet(np.asarray(arr, np.float32))
        lto = self.label_index_to if self.label_index_to is not None else li
        cols = list(range(arr.shape[1]))
        label_cols = [c for c in cols if li <= c <= lto]
        feat_cols = [c for c in cols if c not in label_cols]
        feats = arr[:, feat_cols].astype(np.float32)
        labels = arr[:, label_cols].astype(np.float32)
        if not self.regression:
            labels = _one_hot(labels[:, 0], self.num_classes)
        return DataSet(feats, labels)

    def _try_native(self):
        """One-shot whole-file native parse; leaves per-row iteration as
        the fallback. Populates a batch queue."""
        if self._native_checked:
            return
        self._native_checked = True
        m = getattr(self.reader, "to_matrix", lambda: None)()
        if m is None or m.size == 0:
            return
        self._native_batches = [
            m[i:i + self.batch_size]
            for i in range(0, m.shape[0], self.batch_size)]

    def has_next(self) -> bool:
        if self._buf is not None:
            return True
        self._try_native()
        if self._native_batches is not None:
            if not self._native_batches:
                return False
            self._buf = self._split(self._native_batches.pop(0))
            return True
        rows = []
        for row in self._rows():
            rows.append(row)
            if len(rows) == self.batch_size:
                break
        if not rows:
            return False
        self._buf = self._split(rows)
        return True

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        out, self._buf = self._buf, None
        return out


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """sequences -> padded+masked [B, T, *] DataSet batches
    (ref SequenceRecordReaderDataSetIterator.java ALIGN_END=False;
    variable lengths produce masks, the TPU static-shape idiom)."""

    def __init__(self, reader, batch_size: int,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 regression: bool = False):
        if label_index is not None and not regression \
                and num_classes is None:
            raise ValueError(
                "classification needs num_classes (or set regression=True)")
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self._it = None
        self._buf = None

    def reset(self):
        self._it = None
        self._buf = None

    def _seqs(self):
        if self._it is None:
            self._it = iter(self.reader.sequences())
        return self._it

    def _build(self, seqs) -> DataSet:
        B = len(seqs)
        T = max(len(s) for s in seqs)
        li = self.label_index
        n_cols = len(seqs[0][0])
        f_dim = n_cols - (0 if li is None else 1)
        feats = np.zeros((B, T, f_dim), np.float32)
        fmask = np.zeros((B, T), np.float32)
        labels = None
        lmask = None
        if li is not None:
            ldim = 1 if self.regression else self.num_classes
            labels = np.zeros((B, T, ldim), np.float32)
            lmask = np.zeros((B, T), np.float32)
        for b, seq in enumerate(seqs):
            for t, row in enumerate(seq):
                vals = [float(v) for v in row]
                if li is None:
                    feats[b, t] = vals
                else:
                    lab = vals.pop(li)
                    feats[b, t] = vals
                    if self.regression:
                        labels[b, t, 0] = lab
                    else:
                        labels[b, t, int(lab)] = 1.0
                    lmask[b, t] = 1.0
                fmask[b, t] = 1.0
        return DataSet(feats, labels, fmask, lmask if li is not None
                       else None)

    def has_next(self) -> bool:
        if self._buf is not None:
            return True
        seqs = []
        for s in self._seqs():
            seqs.append(s)
            if len(seqs) == self.batch_size:
                break
        if not seqs:
            return False
        self._buf = self._build(seqs)
        return True

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        out, self._buf = self._buf, None
        return out


class RecordReaderMultiDataSetIterator:
    """Named readers + column-range subsets -> MultiDataSet batches
    (ref RecordReaderMultiDataSetIterator.java Builder:
    addReader / addInput(name, from, to) / addOutputOneHot /
    addOutput)."""

    class Builder:
        def __init__(self, batch_size: int):
            self.batch_size = batch_size
            self._readers = {}
            self._inputs = []   # (reader, from, to)
            self._outputs = []  # (reader, from, to, one_hot_classes|None)

        def add_reader(self, name: str, reader: RecordReader):
            self._readers[name] = reader
            return self

        def add_input(self, name: str, col_from: Optional[int] = None,
                      col_to: Optional[int] = None):
            self._inputs.append((name, col_from, col_to))
            return self

        def add_output(self, name: str, col_from: int, col_to: int):
            self._outputs.append((name, col_from, col_to, None))
            return self

        def add_output_one_hot(self, name: str, col: int,
                               num_classes: int):
            self._outputs.append((name, col, col, num_classes))
            return self

        def build(self) -> "RecordReaderMultiDataSetIterator":
            if not self._inputs or not self._outputs:
                raise ValueError("need at least one input and one output")
            for name, *_ in self._inputs + self._outputs:
                if name not in self._readers:
                    raise ValueError(f"no reader named '{name}'")
            return RecordReaderMultiDataSetIterator(self)

    def __init__(self, builder: "RecordReaderMultiDataSetIterator.Builder"):
        self._b = builder
        self._its = None

    def reset(self):
        self._its = None

    def _rows(self):
        if self._its is None:
            self._its = {n: iter(r) for n, r in self._b._readers.items()}
        return self._its

    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> MultiDataSet:
        its = self._rows()
        rows = {n: [] for n in its}
        for _ in range(self._b.batch_size):
            try:
                vals = {n: next(it) for n, it in its.items()}
            except StopIteration:
                break
            for n, v in vals.items():
                rows[n].append(v)
        if not next(iter(rows.values())):
            raise StopIteration
        arrays = {n: np.asarray(r, dtype=object) for n, r in rows.items()}

        def cols(arr, f, t):
            f = 0 if f is None else f
            t = arr.shape[1] - 1 if t is None else t
            return arr[:, f:t + 1].astype(np.float32)

        feats = [cols(arrays[n], f, t) for n, f, t in self._b._inputs]
        labs = []
        for n, f, t, oh in self._b._outputs:
            c = cols(arrays[n], f, t)
            labs.append(_one_hot(c[:, 0], oh) if oh else c)
        return MultiDataSet(feats, labs)
