"""Graph vertex types (counterpart of deeplearning4j_tpu/nn/conf/graph_vertices.py).

A vertex is a stateless function over its input tensors plus shape
inference, feature-mask propagation and serde: ElementWiseVertex,
MergeVertex, SubsetVertex, L2NormalizeVertex, L2Vertex, ScaleVertex,
ShiftVertex, StackVertex, UnstackVertex, ReshapeVertex,
PreprocessorVertex, PoolHelperVertex, and the recurrent pair
LastTimeStepVertex and DuplicateToTimeSeriesVertex.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence

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
    if kind == "PreprocessorVertex" and isinstance(d.get("preprocessor"),
                                                   dict):
        from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
            preprocessor_from_dict,
        )
        d["preprocessor"] = preprocessor_from_dict(d["preprocessor"])
    return _VERTEX_REGISTRY[kind](**d)


@dataclass
class GraphVertex:
    def n_inputs(self):  # (min, max) accepted input count
        return (1, 1)

    def output_type(self, input_types: List[InputType]) -> InputType:
        return input_types[0]

    def apply(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def feed_forward_mask(self, masks, input_types):
        """The feature mask passed on: the first input's that has one."""
        for m in masks:
            if m is not None:
                return m
        return None

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


@register_vertex
@dataclass
class SubsetVertex(GraphVertex):
    """Feature range [from_index, to_index], inclusive."""

    from_index: int = 0
    to_index: int = 0

    def output_type(self, input_types):
        n = self.to_index - self.from_index + 1
        t = input_types[0]
        if isinstance(t, InputTypeRecurrent):
            return InputType.recurrent(n, t.timeseries_length)
        if isinstance(t, InputTypeConvolutional):
            return InputType.convolutional(t.height, t.width, n)
        return InputType.feed_forward(n)

    def apply(self, inputs):
        return inputs[0][..., self.from_index:self.to_index + 1]


@register_vertex
@dataclass
class L2NormalizeVertex(GraphVertex):
    """x / (||x||_2 + eps) over all non-batch dims."""

    eps: float = 1e-8

    def apply(self, inputs):
        x = inputs[0]
        axes = tuple(range(1, x.ndim))
        return x / (torch.sqrt(torch.sum(x * x, dim=axes, keepdim=True))
                    + self.eps)


@register_vertex
@dataclass
class L2Vertex(GraphVertex):
    """The L2 distance of two inputs -> [B, 1]."""

    eps: float = 1e-8

    def n_inputs(self):
        return (2, 2)

    def output_type(self, input_types):
        return InputType.feed_forward(1)

    def apply(self, inputs):
        a, b = inputs
        d = (a - b).reshape(a.shape[0], -1)
        return torch.sqrt(torch.sum(d * d, dim=1, keepdim=True) + self.eps)


@register_vertex
@dataclass
class ScaleVertex(GraphVertex):
    """x * scale_factor."""

    scale_factor: float = 1.0

    def apply(self, inputs):
        return inputs[0] * self.scale_factor


@register_vertex
@dataclass
class ShiftVertex(GraphVertex):
    """x + shift_factor."""

    shift_factor: float = 0.0

    def apply(self, inputs):
        return inputs[0] + self.shift_factor


@register_vertex
@dataclass
class StackVertex(GraphVertex):
    """N inputs stacked along the batch dim."""

    def n_inputs(self):
        return (2, None)

    def output_type(self, input_types):
        return _same_types(input_types)

    def apply(self, inputs):
        return torch.cat(list(inputs), dim=0)


@register_vertex
@dataclass
class UnstackVertex(GraphVertex):
    """Batch chunk `from_index` of `stack_size` equal chunks."""

    from_index: int = 0
    stack_size: int = 1

    def apply(self, inputs):
        x = inputs[0]
        n = x.shape[0] // self.stack_size
        return x[self.from_index * n:(self.from_index + 1) * n]


@register_vertex
@dataclass
class ReshapeVertex(GraphVertex):
    """Reshape the non-batch dims to `new_shape` (batch dim excluded)."""

    new_shape: Sequence[int] = ()

    def output_type(self, input_types):
        s = tuple(self.new_shape)
        if len(s) == 1:
            return InputType.feed_forward(s[0])
        if len(s) == 2:
            return InputType.recurrent(s[1], s[0])
        if len(s) == 3:
            return InputType.convolutional(s[0], s[1], s[2])
        raise ValueError(f"ReshapeVertex: bad new_shape {s}")

    def apply(self, inputs):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.new_shape))


@register_vertex
@dataclass
class PreprocessorVertex(GraphVertex):
    """An InputPreProcessor as a vertex of its own."""

    preprocessor: object = None

    def output_type(self, input_types):
        return self.preprocessor.output_type(input_types[0])

    def apply(self, inputs):
        return self.preprocessor.preprocess(inputs[0])

    def to_dict(self):
        return {"type": "PreprocessorVertex",
                "preprocessor": self.preprocessor.to_dict()}


@register_vertex
@dataclass
class PoolHelperVertex(GraphVertex):
    """Drops the first row and column of a conv activation (the
    GoogLeNet-import shim)."""

    def output_type(self, input_types):
        t = input_types[0]
        return InputType.convolutional(t.height - 1, t.width - 1, t.channels)

    def apply(self, inputs):
        return inputs[0][:, 1:, 1:, :]


@register_vertex
@dataclass
class LastTimeStepVertex(GraphVertex):
    """[B, T, C] -> [B, C] at each example's last unmasked step.
    `mask_input` names the network input whose feature mask to use
    (default: the mask reaching this vertex)."""

    mask_input: Optional[str] = None

    def output_type(self, input_types):
        return InputType.feed_forward(input_types[0].size)

    def apply(self, inputs, mask=None):
        x = inputs[0]
        if mask is None:
            return x[:, -1, :]
        idx = torch.clamp_min(
            torch.sum(mask > 0, dim=1).to(torch.long) - 1, 0)
        return x[torch.arange(x.shape[0], device=x.device), idx, :]

    def feed_forward_mask(self, masks, input_types):
        return None   # the output is not a time series


@register_vertex
@dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """[B, C] -> [B, T, C], broadcast over the time length of the node or
    input `ts_input`; the graph builder wires `ts_input` in as a second
    input edge, so `apply` receives the reference time series."""

    ts_input: Optional[str] = None

    def n_inputs(self):
        return (2, 2)

    def output_type(self, input_types):
        ts_len = None
        for t in input_types[1:]:
            if isinstance(t, InputTypeRecurrent):
                ts_len = t.timeseries_length
        return InputType.recurrent(input_types[0].size, ts_len)

    def apply(self, inputs):
        if len(inputs) < 2:
            raise ValueError(
                "DuplicateToTimeSeriesVertex needs the reference time-series "
                "array as its second input")
        x = inputs[0]
        return x[:, None, :].expand(x.shape[0], inputs[1].shape[1],
                                    x.shape[1])
