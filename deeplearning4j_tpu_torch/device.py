"""Device policy of the port: CUDA unless the caller asks for the CPU.

There is no fallback. An entry point called without `device` on a host
without a usable GPU raises, so a run that was meant for the card can
never finish quietly on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means "cuda". A CUDA device is checked for availability;
    "cpu" is taken as asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deeplearning4j_tpu_torch runs on CUDA by default and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev

