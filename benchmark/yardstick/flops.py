"""Operations and bytes of the model's layers, counted from the
configuration's shapes alone (never from the program).

Conventions: 2 FLOPs per multiply-add; a kernel call's bytes are each
input read once and each output written once (activations and weights
in the compute dtype, a weight gradient in float32), whatever the
kernel reads again; a call's bound is the larger of FLOPs over the peak
rate and bytes over the memory rate (peaks.py).

The program's four hand-written kernels take these calls (the program's
launch counters are checked against the count before a share is
reported, metrics/_kernels.py):
  fused_conv1x1   forward of every 1x1 stride-1 convolution
  fused_conv3x3   forward of every 3x3 stride-1 convolution
  dgrad_conv1x1, wgrad_conv1x1   the input and weight gradients of every
                  1x1 stride-1 convolution, in training
"""

from __future__ import annotations

import re
from typing import Dict, List

from reference.net import infer_shapes
from yardstick import peaks

# device kernel names of the hand-written kernels, by direction
FORWARD_KERNELS = re.compile(
    r"\b(conv1x1_wgmma_kernel|conv3x3_wgmma_kernel|fused_gemm_kernel|"
    r"stats_reduce_kernel)\b")
BACKWARD_KERNELS = re.compile(
    r"\b(dgrad_wgmma_kernel|dgrad_kernel|wgrad_wgmma_kernel|wgrad_kernel|"
    r"split_sum_kernel|tile_sum_kernel)\b")


def kernel_direction(name: str):
    """"fwd", "bwd" or None (not a hand-written kernel)."""
    if FORWARD_KERNELS.search(name):
        return "fwd"
    if BACKWARD_KERNELS.search(name):
        return "bwd"
    return None


def conv_calls(nodes: List[dict]) -> List[dict]:
    """Every convolution with its per-image shapes: h, w (output), cin,
    cout, k, s, and `kernel` (the hand-written forward kernel that takes
    it, or None)."""
    shapes = infer_shapes(nodes)
    out = []
    for n in nodes:
        if n["op"] != "conv":
            continue
        h, w, cout = shapes[n["name"]]
        cin = shapes[n["inputs"][0]][-1]
        k, s = tuple(n["k"]), tuple(n["s"])
        kernel = None
        if s == (1, 1) and k == (1, 1):
            kernel = "fused_conv1x1"
        elif s == (1, 1) and k == (3, 3):
            kernel = "fused_conv3x3"
        out.append({"name": n["name"], "h": h, "w": w, "cin": cin,
                    "cout": cout, "k": k, "s": s, "kernel": kernel})
    return out


def forward_macs(nodes: List[dict]) -> float:
    """Multiply-adds of one image's forward pass: every convolution and
    the output layer's product."""
    shapes = infer_shapes(nodes)
    macs = 0.0
    for c in conv_calls(nodes):
        macs += c["h"] * c["w"] * c["k"][0] * c["k"][1] * c["cin"] \
            * c["cout"]
    for n in nodes:
        if n["op"] == "output":
            macs += shapes[n["inputs"][0]][-1] * n["cout"]
    return macs


def forward_call(c: dict, rows: int, itemsize: int = 2):
    """(FLOPs, bytes) of one convolution's forward over `rows` images."""
    m = rows * c["h"] * c["w"]
    kk = c["k"][0] * c["k"][1]
    flops = 2.0 * m * kk * c["cin"] * c["cout"]
    nbytes = itemsize * (m * c["cin"] * c["s"][0] * c["s"][1]
                         + kk * c["cin"] * c["cout"] + m * c["cout"])
    return flops, float(nbytes)


def dgrad_call(c: dict, rows: int, itemsize: int = 2):
    """dx = dy @ W^T of a 1x1 stride-1 convolution: reads dy and W,
    writes dx."""
    m = rows * c["h"] * c["w"]
    flops = 2.0 * m * c["cin"] * c["cout"]
    return flops, float(itemsize * (m * c["cout"] + c["cin"] * c["cout"]
                                    + m * c["cin"]))


def wgrad_call(c: dict, rows: int, itemsize: int = 2):
    """dW = u^T @ dy of a 1x1 stride-1 convolution: reads u and dy,
    writes dW in float32."""
    m = rows * c["h"] * c["w"]
    flops = 2.0 * m * c["cin"] * c["cout"]
    return flops, float(itemsize * (m * c["cin"] + m * c["cout"])
                        + 4 * c["cin"] * c["cout"])


def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16"):
    """(least seconds, "operations" | "bytes")."""
    t_ops = flops / peaks.flops_peak(dtype)
    t_bytes = nbytes / peaks.HBM_BYTES
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def hand_kernel_work(nodes: List[dict], rows: int, train: bool) -> Dict:
    """{"fwd"|"bwd": {"bound_s", "calls": {kernel: count}}} of one step
    (train) or one forward over `rows` images."""
    out = {"fwd": {"bound_s": 0.0, "calls": {}},
           "bwd": {"bound_s": 0.0, "calls": {}}}

    def add(direction, kernel, fb):
        d = out[direction]
        d["bound_s"] += bound_s(*fb)[0]
        d["calls"][kernel] = d["calls"].get(kernel, 0) + 1

    for c in conv_calls(nodes):
        if c["kernel"] is None:
            continue
        add("fwd", c["kernel"], forward_call(c, rows))
        if train and c["kernel"] == "fused_conv1x1":
            add("bwd", "dgrad_conv1x1", dgrad_call(c, rows))
            add("bwd", "wgrad_conv1x1", wgrad_call(c, rows))
    return out
