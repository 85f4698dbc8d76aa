"""Dataset fetchers/iterators: MNIST (IDX format), Iris, CIFAR-10, LFW,
Curves (counterpart of deeplearning4j_tpu/datasets/fetchers.py; parity:
deeplearning4j-core datasets/fetchers/MnistDataFetcher.java,
datasets/iterator/impl/{Mnist,Iris,Cifar,LFW,Curves}DataSetIterator.java).

The port never downloads. The JAX package's `_fetch` tries HTTP where no
cached file exists; here a fetcher reads the local file under
$DL4J_TPU_DATA_DIR (default ~/.deeplearning4j_tpu/data; the JAX package
caches its downloads under the same names) or, where there is none and
`synthetic_fallback` allows it, builds the JAX package's deterministic
synthetic stand-in, bit for bit the same arrays. Iris is embedded.
Batches are host numpy DataSets.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator


def data_dir() -> str:
    """Where fetchers look for local files (read only; never created)."""
    return os.environ.get(
        "DL4J_TPU_DATA_DIR",
        os.path.join(os.path.expanduser("~"), ".deeplearning4j_tpu", "data"))


def parse_idx(data: bytes) -> np.ndarray:
    """Parse the IDX binary format (the MnistDbFile role)."""
    magic = struct.unpack(">I", data[:4])[0]
    dtype_code = (magic >> 8) & 0xFF
    ndim = magic & 0xFF
    dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
              0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}
    if dtype_code not in dtypes:
        raise ValueError(f"bad IDX dtype 0x{dtype_code:02x}")
    dims = struct.unpack(">" + "I" * ndim, data[4:4 + 4 * ndim])
    arr = np.frombuffer(data, dtypes[dtype_code], offset=4 + 4 * ndim)
    return arr.reshape(dims)


def _fetch(fname: str) -> Optional[bytes]:
    """The bytes of `fname` under data_dir(), or None (no download)."""
    path = os.path.join(data_dir(), fname)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return f.read()


def load_mnist(train: bool = True, synthetic_fallback: bool = True):
    """Returns (images [N,28,28,1] float32 in [0,1], labels one-hot [N,10])."""
    kind = "train" if train else "test"
    img_raw = _fetch(f"mnist_{kind}_images.gz")
    lab_raw = _fetch(f"mnist_{kind}_labels.gz")
    if img_raw is not None and lab_raw is not None:
        from deeplearning4j_tpu_torch.native import u8_to_f32

        imgs = u8_to_f32(parse_idx(gzip.decompress(img_raw)))  # /255 fused
        labs = parse_idx(gzip.decompress(lab_raw))
        x = imgs[..., None]
        y = np.eye(10, dtype=np.float32)[labs]
        return x, y
    if not synthetic_fallback:
        raise RuntimeError(
            "MNIST not on disk (the port never downloads); place "
            f"mnist_{kind}_images.gz / mnist_{kind}_labels.gz (IDX) in "
            f"{data_dir()} or pass synthetic_fallback=True")
    # deterministic synthetic stand-in: 10 shared class-templates + noise
    n = 8192 if train else 1024
    templates = np.random.default_rng(42).normal(size=(10, 28, 28)) > 1.0
    rng = np.random.default_rng(0 if train else 1)
    labs = rng.integers(0, 10, n)
    x = (templates[labs] * 0.9
         + rng.normal(scale=0.1, size=(n, 28, 28))).astype(np.float32)
    x = np.clip(x, 0, 1)[..., None]
    y = np.eye(10, dtype=np.float32)[labs]
    return x, y


class MnistDataSetIterator(ListDataSetIterator):
    """(ref: datasets/iterator/impl/MnistDataSetIterator.java)."""

    def __init__(self, batch_size: int, train: bool = True,
                 shuffle: bool = True, seed: int = 6,
                 synthetic_fallback: bool = True,
                 num_examples: Optional[int] = None):
        x, y = load_mnist(train, synthetic_fallback)
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        super().__init__(DataSet(x, y), batch_size, shuffle, seed)


# Fisher's Iris, embedded (150 rows, the reference ships it as a resource)
_IRIS = None


def _iris_data():
    global _IRIS
    if _IRIS is None:
        # generated deterministically from the canonical dataset statistics
        # (sepal/petal length/width per class); values are the real UCI rows
        from deeplearning4j_tpu_torch.datasets._iris_data import IRIS_ROWS
        arr = np.asarray(IRIS_ROWS, np.float32)
        _IRIS = (arr[:, :4], np.eye(3, dtype=np.float32)[arr[:, 4].astype(int)])
    return _IRIS


class IrisDataSetIterator(ListDataSetIterator):
    """(ref: datasets/iterator/impl/IrisDataSetIterator.java)."""

    def __init__(self, batch_size: int = 150, num_examples: int = 150,
                 shuffle: bool = False, seed: int = 6):
        x, y = _iris_data()
        super().__init__(DataSet(x[:num_examples], y[:num_examples]),
                         batch_size, shuffle, seed)


class CifarDataSetIterator(ListDataSetIterator):
    """CIFAR-10 (ref: datasets/iterator/impl/CifarDataSetIterator.java).
    Loads cached python-pickle batches if present; else synthetic."""

    def __init__(self, batch_size: int, train: bool = True,
                 num_examples: Optional[int] = None, shuffle: bool = True,
                 seed: int = 6, synthetic_fallback: bool = True):
        x, y = self._load(train, synthetic_fallback)
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        super().__init__(DataSet(x, y), batch_size, shuffle, seed)

    @staticmethod
    def _load(train, synthetic_fallback):
        import pickle

        root = os.path.join(data_dir(), "cifar-10-batches-py")
        files = ([f"data_batch_{i}" for i in range(1, 6)] if train
                 else ["test_batch"])
        if os.path.isdir(root):
            from deeplearning4j_tpu_torch.native import chw_u8_to_hwc_f32

            xs, ys = [], []
            for f in files:
                with open(os.path.join(root, f), "rb") as fh:
                    d = pickle.load(fh, encoding="bytes")
                xs.append(np.asarray(d[b"data"], np.uint8))
                ys.append(np.asarray(d[b"labels"]))
            # CHW pickle layout -> HWC f32, normalization fused (native)
            x = chw_u8_to_hwc_f32(
                np.concatenate(xs).reshape(-1, 3, 32, 32))
            y = np.eye(10, dtype=np.float32)[np.concatenate(ys)]
            return x, y
        if not synthetic_fallback:
            raise RuntimeError(f"CIFAR-10 not cached under {root}")
        n = 4096 if train else 512
        templates = np.random.default_rng(43).normal(size=(10, 32, 32, 3))
        rng = np.random.default_rng(2 if train else 3)
        labs = rng.integers(0, 10, n)
        x = (templates[labs] * 0.5
             + rng.normal(scale=0.3, size=(n, 32, 32, 3))).astype(np.float32)
        return x, np.eye(10, dtype=np.float32)[labs]


class LFWDataSetIterator(ListDataSetIterator):
    """LFW faces iterator (ref: datasets/iterator/impl/
    LFWDataSetIterator.java + fetchers/LFWDataFetcher.java). The real
    dataset needs network egress; this generates
    deterministic synthetic face-shaped data (same fallback contract as
    CifarDataSetIterator) — shape parity [B, H, W, 3] + one-hot labels."""

    def __init__(self, batch_size: int, num_examples: int = 200,
                 image_shape=(64, 64, 3), num_labels: int = 10,
                 train: bool = True, seed: int = 42):
        h, w, c = image_shape
        rng = np.random.default_rng(seed + (0 if train else 1))
        labels = rng.integers(0, num_labels, num_examples)
        x = np.zeros((num_examples, h, w, c), np.float32)
        for i, lab in enumerate(labels):
            # label-dependent "face": oval + eye blobs, lightly jittered
            yy, xx = np.mgrid[0:h, 0:w]
            cy, cx = h / 2 + lab % 3, w / 2 - lab % 2
            oval = (((yy - cy) / (h * 0.35)) ** 2
                    + ((xx - cx) / (w * 0.28)) ** 2) < 1.0
            x[i, :, :, :] = rng.normal(0.1, 0.05, (h, w, c))
            x[i, oval] += 0.5 + 0.03 * lab
        y = np.eye(num_labels, dtype=np.float32)[labels]
        super().__init__(DataSet(x, y), batch_size)


class CurvesDataSetIterator(ListDataSetIterator):
    """Synthetic 'curves' autoencoder dataset (ref: datasets/iterator/
    impl/CurvesDataSetIterator.java — the deep-autoencoder benchmark
    input; the original served a fixed binary file). Deterministic
    synthetic parametric curves rasterized to 28x28, features==labels
    (autoencoder convention)."""

    def __init__(self, batch_size: int, num_examples: int = 200,
                 seed: int = 17):
        rng = np.random.default_rng(seed)
        side = 28
        x = np.zeros((num_examples, side * side), np.float32)
        t = np.linspace(0, 1, 60)
        for i in range(num_examples):
            # random cubic Bezier curve through the unit square
            pts = rng.random((4, 2))
            b = ((1 - t)[:, None] ** 3 * pts[0]
                 + 3 * ((1 - t) ** 2 * t)[:, None] * pts[1]
                 + 3 * ((1 - t) * t ** 2)[:, None] * pts[2]
                 + (t ** 3)[:, None] * pts[3])
            ij = np.clip((b * (side - 1)).astype(int), 0, side - 1)
            img = np.zeros((side, side), np.float32)
            img[ij[:, 1], ij[:, 0]] = 1.0
            x[i] = img.reshape(-1)
        super().__init__(DataSet(x, x.copy()), batch_size)
