"""CausalTransformer: the zoo's minimal decoder-only transformer
(counterpart of deeplearning4j_tpu/zoo/decoder.py).

A GPT-style causal LM decoder whose job is to feed the continuous-
batching serving path (serving/continuous.py) a real autoregressive
workload: token embedding + learned positions, N pre-LN decoder blocks
(causal self-attention + GELU MLP, residual throughout), tied LM head.

It builds no NeuralNetConfiguration — generation is served, not fit:
the model owns a plain parameter tree of f32 tensors on its device plus
the package-standard `JitCache` (build forensics, precision-policy
registration), and engine/decode_program.DecodeProgram builds its
chunk-prefill / decode / page-copy programs from the nn/attention.py
primitives. Greedy (argmax) sampling keeps every emitted token a
deterministic function of the prompt — the property the bitwise
slot-churn oracle pins.

`device=None` means "cuda" and raises without a GPU; pass "cpu" to run
on the host. `init()` draws the 0.02-std normals from an explicit
`torch.Generator(seed)` on the CPU and moves them to the device, so a
seed gives the same weights on either device. The JAX package draws
its own from `jax.random`: carry its weights over with
`load_jax_params`.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.jit_cache import JitCache
from deeplearning4j_tpu_torch.util.tree import leaves


class CausalTransformer:
    """Decoder-only causal transformer LM (weights + forensics cache;
    programs live in engine/decode_program.DecodeProgram)."""

    def __init__(self, vocab_size: int = 256, d_model: int = 64,
                 n_heads: int = 4, n_layers: int = 2,
                 d_ff: int = 0, max_ctx: int = 128, seed: int = 123,
                 compute_dtype=None, device=None):
        if d_model % n_heads != 0:
            raise ValueError(
                f"d_model {d_model} not divisible by n_heads {n_heads}")
        if max_ctx & (max_ctx - 1):
            raise ValueError(f"max_ctx must be a power of two "
                             f"(pow2 prefill buckets): {max_ctx}")
        self.device = resolve_device(device)
        self.vocab_size = int(vocab_size)
        self.d_model = int(d_model)
        self.n_heads = int(n_heads)
        self.n_layers = int(n_layers)
        self.d_ff = int(d_ff) if d_ff else 4 * self.d_model
        self.max_ctx = int(max_ctx)
        self.seed = int(seed)
        self.compute_dtype = compute_dtype
        self.dtype = np.float32
        self.params = None
        self._jit_cache = JitCache()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    # ------------------------------------------------------------ init
    def init(self) -> "CausalTransformer":
        """Initialize the parameter tree (0.02-std normals for
        projections/embeddings, unit gains / zero biases for norms —
        the small-GPT convention), drawn in a fixed order from one
        CPU generator seeded with `seed`."""
        gen = torch.Generator().manual_seed(self.seed)
        d, f, std = self.d_model, self.d_ff, 0.02
        dev = self.device

        def normal(*shape):
            w = torch.randn(shape, generator=gen, dtype=torch.float32)
            return (w * std).to(dev)

        def ones(n):
            return torch.ones(n, dtype=torch.float32, device=dev)

        def zeros(n):
            return torch.zeros(n, dtype=torch.float32, device=dev)

        params = {"tok_emb": normal(self.vocab_size, d),
                  "pos_emb": normal(self.max_ctx, d),
                  "lnf_g": ones(d), "lnf_b": zeros(d)}
        layers = []
        for _ in range(self.n_layers):
            wq, wk, wv, wo = (normal(d, d) for _ in range(4))
            layers.append({
                "ln1_g": ones(d), "ln1_b": zeros(d),
                "wq": wq, "wk": wk, "wv": wv, "wo": wo,
                "ln2_g": ones(d), "ln2_b": zeros(d),
                "w1": normal(d, f), "b1": zeros(f),
                "w2": normal(f, d), "b2": zeros(d),
            })
        params["layers"] = tuple(layers)
        self.params = params
        return self

    def load_jax_params(self, params) -> "CausalTransformer":
        """Take the JAX package's `CausalTransformer.params` tree (numpy
        or jax arrays, a `layers` tuple of per-block dicts) as this
        model's weights, as f32 tensors on the model's device (through
        `util.model_serializer.params_from_jax`). Shapes must match
        this model's configuration."""
        from deeplearning4j_tpu_torch.util.model_serializer import (
            params_from_jax,
        )

        tree, _ = params_from_jax(params, device=self.device)
        tree["layers"] = tuple(tree["layers"])
        want = {"tok_emb": (self.vocab_size, self.d_model),
                "pos_emb": (self.max_ctx, self.d_model)}
        for name, shape in want.items():
            if tuple(tree[name].shape) != shape:
                raise ValueError(f"{name} has shape "
                                 f"{tuple(tree[name].shape)}, this model "
                                 f"needs {shape}")
        if len(tree["layers"]) != self.n_layers:
            raise ValueError(f"{len(tree['layers'])} layers given, this "
                             f"model has {self.n_layers}")
        self.params = tree
        return self

    # ----------------------------------------------------------- facts
    def num_params(self) -> int:
        if self.params is None:
            return 0
        return sum(int(t.numel()) for t in leaves(self.params))

    def config(self) -> dict:
        return {"vocab_size": self.vocab_size, "d_model": self.d_model,
                "n_heads": self.n_heads, "n_layers": self.n_layers,
                "d_ff": self.d_ff, "max_ctx": self.max_ctx,
                "seed": self.seed}
