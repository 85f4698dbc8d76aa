"""InputType: static shape propagation (counterpart of
deeplearning4j_tpu/nn/conf/inputs.py).

Layouts are the JAX package's: convolutional activations are NHWC,
recurrent ones [batch, time, features]. The serialized form
(`to_dict`/`from_dict`) is identical, so configurations cross between
the two packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


class InputType:
    """Factory + base class for input type descriptors."""

    @staticmethod
    def feed_forward(size: int) -> "InputTypeFeedForward":
        return InputTypeFeedForward(size)

    @staticmethod
    def recurrent(size: int, timeseries_length: Optional[int] = None
                  ) -> "InputTypeRecurrent":
        return InputTypeRecurrent(size, timeseries_length)

    @staticmethod
    def convolutional(height: int, width: int, channels: int
                      ) -> "InputTypeConvolutional":
        return InputTypeConvolutional(height, width, channels)

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int
                           ) -> "InputTypeConvolutionalFlat":
        return InputTypeConvolutionalFlat(height, width, channels)

    def arrays_per_example(self) -> int:
        raise NotImplementedError

    def batch_shape(self, batch_size: int) -> Tuple[int, ...]:
        """Concrete tensor shape for a batch of this type."""
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = {"type": type(self).__name__}
        d.update(self.__dict__)
        return d

    @staticmethod
    def from_dict(d: dict) -> "InputType":
        d = dict(d)
        kind = d.pop("type")
        cls = {
            "InputTypeFeedForward": InputTypeFeedForward,
            "InputTypeRecurrent": InputTypeRecurrent,
            "InputTypeConvolutional": InputTypeConvolutional,
            "InputTypeConvolutionalFlat": InputTypeConvolutionalFlat,
        }[kind]
        return cls(**d)


@dataclass(frozen=True)
class InputTypeFeedForward(InputType):
    size: int

    def arrays_per_example(self):
        return self.size

    def batch_shape(self, batch_size):
        return (batch_size, self.size)


@dataclass(frozen=True)
class InputTypeRecurrent(InputType):
    size: int
    timeseries_length: Optional[int] = None

    def arrays_per_example(self):
        if self.timeseries_length is None:
            raise ValueError("Recurrent input with unknown time length")
        return self.size * self.timeseries_length

    def batch_shape(self, batch_size):
        t = self.timeseries_length if self.timeseries_length is not None else 1
        return (batch_size, t, self.size)


@dataclass(frozen=True)
class InputTypeConvolutional(InputType):
    height: int
    width: int
    channels: int

    def arrays_per_example(self):
        return self.height * self.width * self.channels

    def batch_shape(self, batch_size):
        return (batch_size, self.height, self.width, self.channels)


@dataclass(frozen=True)
class InputTypeConvolutionalFlat(InputType):
    """Flattened image rows, e.g. raw MNIST [batch, h*w*c]."""

    height: int
    width: int
    channels: int

    def arrays_per_example(self):
        return self.height * self.width * self.channels

    def flattened_size(self):
        return self.height * self.width * self.channels

    def batch_shape(self, batch_size):
        return (batch_size, self.flattened_size())
