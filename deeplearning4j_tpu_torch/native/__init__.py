"""ctypes bindings of the native host data-path library (counterpart of
deeplearning4j_tpu/native/__init__.py, a loader of the port's own).

native/dl4j_tpu_native.cpp (the repo's C++ host library: CSV -> f32
parsing, u8 -> f32 normalization and the CHW -> HWC layout fix-up) is
compiled with native/build.sh's flags into deeplearning4j_tpu_torch/_build/
at first use, never at import, and loaded with ctypes. Every entry point
has a NumPy fallback with the same results, taken where no compiler is
found; `available()` says which path is active.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(os.path.dirname(_PKG), "native")
_BUILD_DIR = os.path.join(_PKG, "_build")
_LIB_NAME = "libdl4j_tpu_native.so"

_ABI_VERSION = 3

_lock = threading.Lock()
_lib = None
_tried = False


def _build(out: str) -> None:
    """native/build.sh into a private file, then renamed into place, so
    processes building at once never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["sh", os.path.join(_SRC_DIR, "build.sh"), tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _build_and_load() -> Optional[ctypes.CDLL]:
    src = os.path.join(_SRC_DIR, "dl4j_tpu_native.cpp")
    if not os.path.exists(src):
        return None
    out = os.path.join(_BUILD_DIR, _LIB_NAME)
    try:
        if not os.path.exists(out) or (os.path.getmtime(out)
                                       < os.path.getmtime(src)):
            _build(out)
        return _bind(ctypes.CDLL(out))
    except (OSError, subprocess.SubprocessError):
        return None
    except AttributeError:
        # a stale library (a missing symbol or another ABI): rebuild once
        # from the current source, else fall back to NumPy
        try:
            _build(out)
            return _bind(ctypes.CDLL(out))
        except (OSError, subprocess.SubprocessError, AttributeError):
            return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.dl4j_native_abi_version() != _ABI_VERSION:
        raise AttributeError(
            f"native ABI {lib.dl4j_native_abi_version()} != {_ABI_VERSION}")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.c_int64
    lib.dl4j_parse_csv_f32.restype = ctypes.c_int
    lib.dl4j_parse_csv_f32.argtypes = [
        ctypes.c_char_p, i64, ctypes.c_char, f32p, i64,
        ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.dl4j_u8_to_f32.restype = None
    lib.dl4j_u8_to_f32.argtypes = [u8p, f32p, i64, ctypes.c_float,
                                   ctypes.c_float]
    lib.dl4j_chw_u8_to_hwc_f32.restype = None
    lib.dl4j_chw_u8_to_hwc_f32.argtypes = [
        u8p, f32p, i64, i64, i64, i64, ctypes.c_float, ctypes.c_float]
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            _lib = _build_and_load()
            _tried = True
    return _lib


def available() -> bool:
    """True when the C++ library is built and loaded (else every entry
    point takes its NumPy fallback)."""
    return _get() is not None


def parse_csv_f32(text, delimiter: str = ",") -> np.ndarray:
    """Parse an all-numeric delimited text into a float32 [N, C] array.
    '#'-comment and blank lines are skipped. Raises ValueError on ragged
    or non-numeric input (both paths)."""
    if isinstance(text, str):
        text = text.encode()
    lib = _get()
    if lib is None:
        return parse_csv_fallback(text, delimiter)
    # capacity: numbers can't be denser than 2 bytes each ("1,1,...")
    max_vals = max(len(text) // 2 + 16, 16)
    out = np.empty(max_vals, np.float32)
    n_rows = ctypes.c_int64()
    n_cols = ctypes.c_int64()
    rc = lib.dl4j_parse_csv_f32(
        text, len(text), delimiter.encode()[0:1] or b",",
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_vals,
        ctypes.byref(n_rows), ctypes.byref(n_cols))
    if rc == -2:
        raise ValueError("ragged rows in CSV input")
    if rc == -3:
        raise ValueError("non-numeric value in CSV input")
    if rc != 0:
        raise ValueError(f"native CSV parse failed (code {rc})")
    r, c = n_rows.value, n_cols.value
    return out[:r * c].reshape(r, c).copy()


def parse_csv_fallback(data: bytes, delimiter: str = ",") -> np.ndarray:
    """The NumPy path of `parse_csv_f32` (each value parsed to a double,
    then rounded to float32, as the C++ path does)."""
    rows = []
    ncols = None
    for line in data.decode().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(v) for v in line.split(delimiter)]
        if ncols is None:
            ncols = len(vals)
        elif len(vals) != ncols:
            raise ValueError("ragged rows in CSV input")
        rows.append(vals)
    if not rows:
        return np.zeros((0, 0), np.float32)
    return np.asarray(rows, np.float32)


def u8_to_f32(src: np.ndarray, scale: float = 1.0 / 255.0,
              shift: float = 0.0) -> np.ndarray:
    """u8 -> f32 affine normalize, single fused pass."""
    src = np.ascontiguousarray(src, np.uint8)
    lib = _get()
    if lib is None:
        return src.astype(np.float32) * scale + shift
    dst = np.empty(src.shape, np.float32)
    lib.dl4j_u8_to_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        src.size, scale, shift)
    return dst


def chw_u8_to_hwc_f32(src: np.ndarray, scale: float = 1.0 / 255.0,
                      shift: float = 0.0) -> np.ndarray:
    """[N, C, H, W] u8 -> [N, H, W, C] f32 with fused normalization
    (the CIFAR-pickle layout fix-up)."""
    src = np.ascontiguousarray(src, np.uint8)
    if src.ndim != 4:
        raise ValueError(f"expected [N, C, H, W], got shape {src.shape}")
    n, c, h, w = src.shape
    lib = _get()
    if lib is None:
        return (np.transpose(src, (0, 2, 3, 1)).astype(np.float32)
                * scale + shift)
    dst = np.empty((n, h, w, c), np.float32)
    lib.dl4j_chw_u8_to_hwc_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, c, h, w, scale, shift)
    return dst
