"""Zoo architectures (counterpart of deeplearning4j_tpu/zoo/models.py).

This slice ports ResNet50 and the `_conv_bn` block it is built from; the
configuration it builds serializes to the JAX package's JSON exactly.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer,
    BatchNormalization,
    ConvolutionLayer,
    GlobalPoolingLayer,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.zoo.base import ZooModel


def _graph_builder(self):
    return (NeuralNetConfiguration.Builder()
            .seed(self.seed).updater(self.updater)
            .learning_rate(self.learning_rate)
            .activation("relu").weight_init("relu")
            .graph_builder())


def _conv_bn(gb, name, inp, n_out, kernel, stride=(1, 1), mode="same",
             activation="relu"):
    """conv -> BN -> relu block used across ResNet/Inception."""
    gb.add_layer(f"{name}_conv",
                 ConvolutionLayer(n_out=n_out, kernel_size=kernel,
                                  stride=stride, convolution_mode=mode,
                                  activation="identity"), inp)
    gb.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
    if activation:
        gb.add_layer(f"{name}_act", ActivationLayer(activation=activation),
                     f"{name}_bn")
        return f"{name}_act"
    return f"{name}_bn"


class ResNet50(ZooModel):
    """ResNet-50: bottleneck residual stages [3, 4, 6, 3]."""

    num_classes = 1000
    input_shape = (224, 224, 3)

    def _identity_block(self, gb, name, inp, filters):
        f1, f2, f3 = filters
        x = _conv_bn(gb, f"{name}_a", inp, f1, (1, 1))
        x = _conv_bn(gb, f"{name}_b", x, f2, (3, 3))
        x = _conv_bn(gb, f"{name}_c", x, f3, (1, 1), activation=None)
        gb.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, inp)
        gb.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                     f"{name}_add")
        return f"{name}_out"

    def _conv_block(self, gb, name, inp, filters, stride):
        f1, f2, f3 = filters
        x = _conv_bn(gb, f"{name}_a", inp, f1, (1, 1), stride=stride)
        x = _conv_bn(gb, f"{name}_b", x, f2, (3, 3))
        x = _conv_bn(gb, f"{name}_c", x, f3, (1, 1), activation=None)
        sc = _conv_bn(gb, f"{name}_sc", inp, f3, (1, 1), stride=stride,
                      activation=None)
        gb.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, sc)
        gb.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                     f"{name}_add")
        return f"{name}_out"

    def conf(self):
        h, w, c = self.input_shape
        gb = _graph_builder(self).add_inputs("input")
        x = _conv_bn(gb, "stem", "input", 64, (7, 7), stride=(2, 2))
        gb.add_layer("stem_pool",
                     SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                      convolution_mode="same"), x)
        x = "stem_pool"
        stages = [
            ("s2", [64, 64, 256], 3, (1, 1)),
            ("s3", [128, 128, 512], 4, (2, 2)),
            ("s4", [256, 256, 1024], 6, (2, 2)),
            ("s5", [512, 512, 2048], 3, (2, 2)),
        ]
        for sname, filters, blocks, stride in stages:
            x = self._conv_block(gb, f"{sname}b0", x, filters, stride)
            for i in range(1, blocks):
                x = self._identity_block(gb, f"{sname}b{i}", x, filters)
        gb.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        gb.add_layer("output",
                     OutputLayer(n_out=self.num_classes, loss="mcxent"),
                     "avgpool")
        gb.set_outputs("output")
        gb.set_input_types(input=InputType.convolutional(h, w, c))
        return gb.build()
