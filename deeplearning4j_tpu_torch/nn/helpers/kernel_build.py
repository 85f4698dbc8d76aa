"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each kernel source is compiled by `nvcc` for sm_90a into its own shared
library with a plain C interface and loaded with ctypes — no PyTorch
headers, so a build takes seconds. Builds happen at first use, into
`deeplearning4j_tpu_torch/_build/` (listed in .gitignore); the library
name carries a digest of the sources, so an edited source is never
served by a stale build. `build_all()` starts one nvcc per source
together.

Nothing here runs at import time: the CPU tests import every module on a
host that has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

KERNEL_SOURCES = {
    "fused_conv1x1": "fused_conv1x1.cu",
    "fused_conv3x3": "fused_conv3x3.cu",
}
_HEADERS = ("fused_conv_common.cuh",)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point of each library: (name, argtypes); every one returns the
# cudaError_t of its launches as an int
_ENTRY_POINTS = {
    "fused_conv1x1": ("fused_conv1x1_launch",
                      [_I] + [_P] * 11 + [_I] * 4 + [_P]),
    "fused_conv3x3": ("fused_conv3x3_launch",
                      [_I] + [_P] * 9 + [_I] * 6 + [_P]),
}
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for f in (KERNEL_SOURCES[name],) + _HEADERS:
        h.update((CSRC_DIR / f).read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def _command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out),
            str(CSRC_DIR / KERNEL_SOURCES[name])]


def build_all(names=None, verbose: bool = False) -> Dict[str, float]:
    """Compile every kernel whose library is missing, one nvcc process per
    source, all started together. Returns seconds per kernel built.
    Raises with nvcc's output if any build fails."""
    names = list(names or KERNEL_SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    seconds = {}
    failed = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        seconds[name] = time.perf_counter() - t0
        if p.returncode != 0:
            failed.append(f"{name}: nvcc exit {p.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        if verbose:
            print(f"[build] {name}: {seconds[name]:.1f}s\n{log.strip()}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
            lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
            lib.dl4j_conv_row_tile.restype = ctypes.c_int
            lib.dl4j_conv_row_tile.argtypes = []
            entry, argtypes = _ENTRY_POINTS[name]
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.dl4j_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
