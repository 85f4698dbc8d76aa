"""Seeded weights and inputs, made on the device in a few large calls.

Weights: He-normal kernels (std sqrt(2 / fan_in)), small random biases,
BatchNorm gamma near 1 (near 0.2 on the layers a configuration's
reference marks with `small_gamma`, as trained residual networks have)
and beta near 0, all float32 (the master weights the program trains and
serves from). The BatchNorm running statistics are set near the
per-channel statistics a calibration batch produces at each layer, with
seeded noise, and the output layer is scaled so the logits spread by
about one: the network's activations and answers stay at a realistic
scale, and softmax is not saturated.

Images: standard-normal pixels with a per-image brightness and contrast,
so every row differs. Labels: seeded classes, one-hot.
"""

from __future__ import annotations

import contextlib

import torch

from reference import net as refnet

CALIBRATION_ROWS = 8


@contextlib.contextmanager
def exact_float32():
    """TF32 off and deterministic cuDNN inside, the settings restored
    after (the program's own settings are not touched)."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             b.cudnn.deterministic, b.cudnn.benchmark)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    b.cudnn.deterministic, b.cudnn.benchmark = True, False
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
         b.cudnn.deterministic, b.cudnn.benchmark) = saved


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on `device` for one purpose (`stream`) of one seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + stream) % (2 ** 63))


def images(gen, rows: int, shape, device) -> torch.Tensor:
    """[rows, H, W, C] float32 images on `device`."""
    loc = torch.rand(rows, 1, 1, 1, generator=gen, device=device) * 2 - 1
    scale = torch.rand(rows, 1, 1, 1, generator=gen, device=device) * 1.5 \
        + 0.5
    return loc + scale * torch.randn(rows, *shape, generator=gen,
                                     device=device)


def labels(gen, rows: int, classes: int, device) -> torch.Tensor:
    """[rows, classes] one-hot float32 labels."""
    cls = torch.randint(classes, (rows,), generator=gen, device=device)
    return torch.nn.functional.one_hot(cls, classes).float()


def make(nodes, seed: int, device, small_gamma=lambda name: False):
    """(params, states) in the program's layout, float32 on `device`."""
    gen = generator(seed, device, 1)
    shapes = refnet.param_shapes(nodes)
    kernels = [(k, j, s) for k in shapes for j, s in shapes[k].items()
               if j == "W"]
    vectors = [(k, j, s) for k in shapes for j, s in shapes[k].items()
               if j != "W"]
    numel = lambda s: int(torch.Size(s).numel())
    flat_w = torch.randn(sum(numel(s) for *_, s in kernels), generator=gen,
                         device=device)
    flat_v = torch.randn(sum(numel(s) for *_, s in vectors), generator=gen,
                         device=device)
    params = {k: {} for k in shapes}
    off = 0
    for k, j, s in kernels:
        n = numel(s)
        fan_in = n // s[-1]
        std = (2.0 / fan_in) ** 0.5 if len(s) == 4 else (1.0 / fan_in) ** 0.5
        params[k][j] = flat_w[off:off + n].view(s) * std
        off += n
    off = 0
    for k, j, s in vectors:
        n = numel(s)
        r = flat_v[off:off + n].view(s)
        off += n
        if j == "gamma":
            params[k][j] = (0.2 if small_gamma(k) else 1.0) * (1 + 0.1 * r)
        elif j == "beta":
            params[k][j] = 0.1 * r
        else:   # biases
            params[k][j] = 0.01 * r
    bns = [n["name"] for n in nodes if n["op"] == "bn"]
    states = {k: {"mean": torch.zeros_like(params[k]["gamma"]),
                  "var": torch.ones_like(params[k]["gamma"])} for k in bns}
    x = images(gen, CALIBRATION_ROWS, nodes[0]["shape"], device)
    with torch.no_grad(), exact_float32():
        logits, batch = refnet.forward(nodes, params, states, x,
                                       train=False, batch_stats=True)
    out = [n for n in nodes if n["op"] == "output"][0]["name"]
    params[out]["W"] = params[out]["W"] / float(logits.std())
    noise = torch.rand(2 * sum(states[k]["mean"].numel() for k in bns),
                       generator=gen, device=device)
    off = 0
    for k in bns:
        m, v = batch[k]["mean"], batch[k]["var"]
        c = m.numel()
        nm = noise[off:off + c] * 2 - 1
        nv = noise[off + c:off + 2 * c]
        off += 2 * c
        states[k] = {"mean": m + 0.1 * v.clamp_min(1e-6).sqrt() * nm,
                     "var": v * (0.8 + 0.45 * nv) + 1e-3}
    return params, states
