"""Graph vertex types (counterpart of deeplearning4j_tpu/nn/conf/graph_vertices.py).

A vertex is a stateless function over its input tensors plus shape
inference and serde. This slice ports the registry, ElementWiseVertex
(the residual add of ResNet) and MergeVertex (channel concatenation).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Sequence

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeConvolutional,
    InputTypeFeedForward,
    InputTypeRecurrent,
)

_VERTEX_REGISTRY = {}


def register_vertex(cls):
    _VERTEX_REGISTRY[cls.__name__] = cls
    return cls


def vertex_from_dict(d: dict):
    d = dict(d)
    kind = d.pop("type")
    if kind not in _VERTEX_REGISTRY:
        raise ValueError(
            f"Unknown vertex type '{kind}'. "
            f"Registered: {sorted(_VERTEX_REGISTRY)}")
    return _VERTEX_REGISTRY[kind](**d)


@dataclass
class GraphVertex:
    def n_inputs(self):  # (min, max) accepted input count
        return (1, 1)

    def output_type(self, input_types: List[InputType]) -> InputType:
        return input_types[0]

    def apply(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = {"type": type(self).__name__}
        for f in dataclasses.fields(self):
            d[f.name] = getattr(self, f.name)
        return d


def _same_types(input_types):
    first = input_types[0]
    for t in input_types[1:]:
        if t.to_dict() != first.to_dict():
            raise ValueError(
                f"vertex inputs must have identical types, got {input_types}")
    return first


@register_vertex
@dataclass
class ElementWiseVertex(GraphVertex):
    """Pointwise add/average/subtract/product/max over same-shaped inputs."""

    op: str = "add"

    def n_inputs(self):
        return (2, None) if self.op != "subtract" else (2, 2)

    def output_type(self, input_types):
        return _same_types(input_types)

    def apply(self, inputs):
        op = self.op.lower()
        if op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if op == "average":
            return sum(inputs) / len(inputs)
        if op == "subtract":
            return inputs[0] - inputs[1]
        if op == "product":
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(f"Unknown ElementWiseVertex op '{self.op}'")


@register_vertex
@dataclass
class MergeVertex(GraphVertex):
    """Concatenate along the feature/channel (last) axis."""

    def n_inputs(self):
        return (1, None)

    def output_type(self, input_types):
        first = input_types[0]
        if isinstance(first, InputTypeFeedForward):
            return InputType.feed_forward(sum(t.size for t in input_types))
        if isinstance(first, InputTypeRecurrent):
            return InputType.recurrent(
                sum(t.size for t in input_types), first.timeseries_length)
        if isinstance(first, InputTypeConvolutional):
            for t in input_types[1:]:
                if (t.height, t.width) != (first.height, first.width):
                    raise ValueError(
                        f"MergeVertex conv inputs must share HxW: {input_types}")
            return InputType.convolutional(
                first.height, first.width,
                sum(t.channels for t in input_types))
        raise ValueError(f"MergeVertex: unsupported input type {first}")

    def apply(self, inputs):
        return torch.cat(list(inputs), dim=-1)
