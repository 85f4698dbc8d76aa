"""ImageNet class labels and top-k prediction decoding (counterpart of
deeplearning4j_tpu/zoo/util/imagenet.py).

The labels come from a class-index JSON file ({"0": ["n01440764",
"tench"], ...}, the map published with keras-applications), parsed once
per source path and cached. The port reads it from a local path only:
`source`, else the cache file the JAX package writes after its first
download (`~/.dl4j_tpu/imagenet_class_index.json`). It fetches nothing.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

DEFAULT_CACHE = os.path.expanduser("~/.dl4j_tpu/imagenet_class_index.json")

_CACHE: dict = {}


def _load_class_index(source: Optional[str]) -> List[Tuple[str, str]]:
    """-> [(wnid, label)] ordered by class index 0..N-1."""
    source = source or DEFAULT_CACHE
    if source in _CACHE:
        return _CACHE[source]
    if not os.path.exists(source):
        raise FileNotFoundError(
            f"ImageNet class index {source} not found; pass the local path "
            "of imagenet_class_index.json as `source`")
    with open(source) as f:
        raw = json.load(f)
    labels = [(raw[str(i)][0], raw[str(i)][1]) for i in range(len(raw))]
    _CACHE[source] = labels
    return labels


class ImageNetLabels:
    """Class labels from a local class-index JSON (`source`)."""

    def __init__(self, source: Optional[str] = None):
        self._labels = _load_class_index(source)

    def __len__(self):
        return len(self._labels)

    def get_label(self, n: int) -> str:
        """Description of the nth class."""
        return self._labels[n][1]

    def get_wnid(self, n: int) -> str:
        return self._labels[n][0]

    def decode_predictions(self, predictions, top: int = 5):
        """[(class_idx, wnid, label, prob)] per batch row."""
        return decode_predictions(predictions, top=top, labels=self)

    def decode_predictions_str(self, predictions, top: int = 5) -> str:
        """The human-readable report: one "Predictions for batch" block
        per row, a percentage and label per line."""
        preds = _as_rows(predictions)
        out = []
        for b, rows in enumerate(self.decode_predictions(preds, top)):
            head = "Predictions for batch "
            if preds.shape[0] > 1:
                head += str(b)
            head += " :"
            out.append(head + "".join(
                f"\n\t{100.0 * p:3f}%, {label}"
                for (_, _, label, p) in rows))
        return "\n".join(out)

    # camelCase parity
    getLabel = get_label
    decodePredictions = decode_predictions_str


def _as_rows(predictions) -> np.ndarray:
    """[B, C] f32 numpy rows of a numpy array or tensor (a [C] vector is
    one row)."""
    if hasattr(predictions, "detach"):
        predictions = predictions.detach().float().cpu().numpy()
    preds = np.asarray(predictions, np.float32)
    return preds[None, :] if preds.ndim == 1 else preds


def decode_predictions(predictions, top: int = 5,
                       labels: Optional[ImageNetLabels] = None,
                       source: Optional[str] = None
                       ) -> List[List[Tuple[int, str, str, float]]]:
    """Top-`top` (class_idx, wnid, label, probability) per row, sorted
    descending, over a [B, C] probability array or tensor."""
    labels = labels or ImageNetLabels(source)
    preds = _as_rows(predictions)
    if preds.shape[-1] != len(labels):
        raise ValueError(
            f"predictions have {preds.shape[-1]} classes, label table "
            f"has {len(labels)}")
    k = min(top, preds.shape[-1])
    top_idx = np.argpartition(-preds, k - 1, axis=-1)[:, :k]
    out = []
    for row, idx in zip(preds, top_idx):
        idx = idx[np.argsort(-row[idx])]
        out.append([(int(i), labels.get_wnid(int(i)),
                     labels.get_label(int(i)), float(row[i]))
                    for i in idx])
    return out
