"""Data normalizers (counterpart of deeplearning4j_tpu/datasets/normalizers.py;
parity: ND4J NormalizerStandardize / NormalizerMinMaxScaler /
ImagePreProcessingScaler / VGG16ImagePreProcessor, persisted as
normalizer.json in model zips — util/ModelSerializer.java:40-41).

Each normalizer transforms a DataSet-like object (its `features`) or a
bare array, numpy or torch on any device:
- numpy features follow the JAX package's arithmetic exactly (its dtype
  promotion included), so both packages give the same bits;
- a torch tensor stays on its device and in its floating dtype (integer
  tensors, such as uint8 images, become float32): the statistics are
  converted to that device and dtype.
Statistics are host numpy arrays, as in the JAX package, so `to_dict`
writes the same JSON and `normalizer_from_dict` reads either package's.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.eval._tensors import host

_REGISTRY = {}


def register(cls):
    _REGISTRY[cls.__name__] = cls
    return cls


def normalizer_from_dict(d: dict):
    d = dict(d)
    kind = d.pop("type")
    if kind not in _REGISTRY:
        raise ValueError(f"Unknown normalizer '{kind}'; known {sorted(_REGISTRY)}")
    n = _REGISTRY[kind]()
    n.__dict__.update({k: (np.asarray(v) if isinstance(v, list) else v)
                       for k, v in d.items()})
    return n


def _like(stat, x: torch.Tensor):
    """A statistic as a tensor on x's device in x's dtype (a scalar stays
    a Python number)."""
    if not isinstance(stat, np.ndarray):
        return stat
    return torch.as_tensor(stat).to(device=x.device, dtype=x.dtype)


def _float(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() else x.to(torch.float32)


class Normalizer:
    """`transform` (and `pre_process`) take a DataSet-like object, whose
    features are replaced, or a bare array or tensor, which is returned
    transformed. Subclasses define `_apply(x, xp)`, `xp` being the stats
    converter: identity for numpy, `_like` for tensors."""

    def fit(self, data):
        raise NotImplementedError

    def _apply(self, x, stat):
        raise NotImplementedError

    def _transform_array(self, x):
        if isinstance(x, torch.Tensor):
            x = _float(x)
            return self._apply(x, lambda s: _like(s, x))
        return self._apply(x, lambda s: s)

    def transform(self, data):
        if hasattr(data, "features"):
            data.features = self._transform_array(data.features)
            return data
        return self._transform_array(data)

    def pre_process(self, data):
        return self.transform(data)

    def to_dict(self) -> dict:
        d = {"type": type(self).__name__}
        for k, v in self.__dict__.items():
            if not k.startswith("_"):
                # analyze: allow=jit-host-sync — host-numpy stats serialization
                d[k] = v.tolist() if isinstance(v, np.ndarray) else v
        return d

    @staticmethod
    def _features(data) -> np.ndarray:
        """All of the data's features on the host: a DataSet-like object,
        an iterator of them or of (features, labels) pairs, or an array."""
        if hasattr(data, "features"):
            return host(data.features)
        if isinstance(data, (np.ndarray, torch.Tensor)):
            return host(data)
        return np.concatenate([host(b.features if hasattr(b, "features")
                                     else b[0]) for b in data], axis=0)


@register
class NormalizerStandardize(Normalizer):
    """Zero-mean unit-variance per feature."""

    def __init__(self):
        self.mean = None
        self.std = None

    def fit(self, data):
        feats = self._features(data)
        axes = tuple(range(feats.ndim - 1))
        self.mean = feats.mean(axis=axes)
        self.std = feats.std(axis=axes) + 1e-8
        return self

    def _apply(self, x, stat):
        return (x - stat(self.mean)) / stat(self.std)

    def revert_features(self, x):
        if isinstance(x, torch.Tensor):
            return x * _like(self.std, x) + _like(self.mean, x)
        return x * self.std + self.mean


@register
class NormalizerMinMaxScaler(Normalizer):
    """Scale features into [min_range, max_range]."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = min_range
        self.max_range = max_range
        self.data_min = None
        self.data_max = None

    def fit(self, data):
        feats = self._features(data)
        axes = tuple(range(feats.ndim - 1))
        self.data_min = feats.min(axis=axes)
        self.data_max = feats.max(axis=axes)
        return self

    def _apply(self, x, stat):
        span = np.maximum(self.data_max - self.data_min, 1e-8)
        scaled = (x - stat(self.data_min)) / stat(span)
        return scaled * (self.max_range - self.min_range) + self.min_range


@register
class ImagePreProcessingScaler(Normalizer):
    """Pixel scale [0, max_pixel] -> [a, b] (default [0,1]); stateless."""

    def __init__(self, a: float = 0.0, b: float = 1.0,
                 max_pixel: float = 255.0):
        self.a = a
        self.b = b
        self.max_pixel = max_pixel

    def fit(self, data):
        return self

    def _apply(self, x, stat):
        return (x / self.max_pixel) * (self.b - self.a) + self.a


@register
class VGG16ImagePreProcessor(Normalizer):
    """ImageNet mean subtraction for VGG16-family inputs (ref
    TrainedModels.VGG16.getPreProcessor / VGG16ImagePreProcessor.java):
    subtracts the per-channel dataset mean, no scaling. Channel order
    follows the tensor's last axis (NHWC RGB by default, matching the
    importer's layout)."""

    MEAN_RGB = (123.68, 116.779, 103.939)

    def __init__(self, mean=None):
        self.mean = np.asarray(self.MEAN_RGB if mean is None else mean,
                               np.float32)

    def fit(self, data):
        return self

    def _apply(self, x, stat):
        return x - stat(self.mean)
