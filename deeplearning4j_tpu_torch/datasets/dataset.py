"""DataSet / MultiDataSet containers (a copy of
deeplearning4j_tpu/datasets/dataset.py). Plain numpy holders — device
placement happens in the train step or in the input pipeline's staging
(datasets/iterators.DevicePrefetchIterator)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class DataSet:
    def __init__(self, features, labels=None, features_mask=None,
                 labels_mask=None):
        self.features = np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)
        self.features_mask = (None if features_mask is None
                              else np.asarray(features_mask))
        self.labels_mask = (None if labels_mask is None
                            else np.asarray(labels_mask))

    def num_examples(self) -> int:
        return self.features.shape[0]

    def split_test_and_train(self, n_train: int):
        tr = DataSet(self.features[:n_train],
                     None if self.labels is None else self.labels[:n_train])
        te = DataSet(self.features[n_train:],
                     None if self.labels is None else self.labels[n_train:])
        return tr, te

    def shuffle(self, seed: Optional[int] = None):
        idx = np.random.default_rng(seed).permutation(self.num_examples())
        self.features = self.features[idx]
        if self.labels is not None:
            self.labels = self.labels[idx]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[idx]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[idx]
        return self

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        out = []
        for i in range(0, self.num_examples(), batch_size):
            out.append(DataSet(
                self.features[i:i + batch_size],
                None if self.labels is None else self.labels[i:i + batch_size],
                None if self.features_mask is None
                else self.features_mask[i:i + batch_size],
                None if self.labels_mask is None
                else self.labels_mask[i:i + batch_size]))
        return out

    def __iter__(self):
        # tuple-unpacking compatibility: (x, y, fm, lm)
        return iter((self.features, self.labels, self.features_mask,
                     self.labels_mask))


class MultiDataSet:
    """Multiple input/label arrays (parity: ND4J MultiDataSet used by
    ComputationGraph.fit(MultiDataSetIterator), ComputationGraph.java:907)."""

    def __init__(self, features: Sequence, labels: Sequence,
                 features_masks: Optional[Sequence] = None,
                 labels_masks: Optional[Sequence] = None):
        self.features = [np.asarray(f) for f in features]
        self.labels = [np.asarray(l) for l in labels]
        self.features_mask = (None if features_masks is None else
                              [None if m is None else np.asarray(m)
                               for m in features_masks])
        self.labels_mask = (None if labels_masks is None else
                            [None if m is None else np.asarray(m)
                             for m in labels_masks])

    def num_examples(self) -> int:
        return self.features[0].shape[0]
