"""Device facts, the chips a cell asks for, and the no-JAX guard."""

from __future__ import annotations

import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "deeplearning4j_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (the part before the first
    dot), compared whole, is JAX's or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN})


def require_cards(n: int):
    """The torch module once `n` CUDA cards are visible; else SystemExit
    with a message (no result is printed)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("benchmark: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"benchmark: the cell needs {n} CUDA cards, "
                         f"{torch.cuda.device_count()} are visible")
    return torch


def power_limit_w():
    """The card's power limit from nvidia-smi (None where it cannot be
    read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def facts(count: int, memory_peak_bytes: int):
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(memory_peak_bytes)}
