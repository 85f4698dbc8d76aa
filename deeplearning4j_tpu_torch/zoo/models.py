"""Zoo architectures (counterpart of deeplearning4j_tpu/zoo/models.py).

Ported: the layer-list models LeNet, SimpleCNN, AlexNet, VGG16, VGG19 and
TextGenerationLSTM (MultiLayerNetwork) and the graph model ResNet50 with
the `_conv_bn` block it is built from. Each configuration serializes to the JAX
package's JSON exactly.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer,
    BatchNormalization,
    ConvolutionLayer,
    DenseLayer,
    GlobalPoolingLayer,
    GravesLSTM,
    LocalResponseNormalization,
    OutputLayer,
    RnnOutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.zoo.base import ZooModel


def _list_builder(self, activation, weight_init):
    return (NeuralNetConfiguration.Builder()
            .seed(self.seed).updater(self.updater)
            .learning_rate(self.learning_rate)
            .activation(activation).weight_init(weight_init)
            .list())


class LeNet(ZooModel):
    """LeNet-5 for MNIST-class tasks (ref: zoo/model/LeNet.java)."""

    num_classes = 10
    input_shape = (28, 28, 1)

    def conf(self):
        h, w, c = self.input_shape
        return (_list_builder(self, "identity", "xavier")
                .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                        stride=(1, 1),
                                        convolution_mode="same",
                                        activation="identity"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                        stride=(1, 1),
                                        convolution_mode="same",
                                        activation="identity"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.num_classes, loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


class SimpleCNN(ZooModel):
    """Compact CNN (ref: zoo/model/SimpleCNN.java; 48x48x3 default)."""

    num_classes = 10
    input_shape = (48, 48, 3)

    def conf(self):
        h, w, c = self.input_shape
        b = _list_builder(self, "relu", "relu")
        for n_out, do in ((16, 0.0), (16, 0.0), (32, 0.0),
                          (32, 0.0), (64, 0.5), (64, 0.5)):
            b = b.layer(ConvolutionLayer(
                n_out=n_out, kernel_size=(3, 3), convolution_mode="same",
                dropout=do))
        b = (b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
             .layer(DenseLayer(n_out=256, dropout=0.5))
             .layer(OutputLayer(n_out=self.num_classes, loss="mcxent")))
        return b.set_input_type(InputType.convolutional(h, w, c)).build()


class AlexNet(ZooModel):
    """AlexNet with LRN (ref: zoo/model/AlexNet.java)."""

    num_classes = 1000
    input_shape = (224, 224, 3)

    def conf(self):
        h, w, c = self.input_shape
        return (_list_builder(self, "relu", "relu")
                .layer(ConvolutionLayer(n_out=96, kernel_size=(11, 11),
                                        stride=(4, 4),
                                        convolution_mode="same"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(5, 5),
                                        convolution_mode="same"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                        convolution_mode="same"))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                        convolution_mode="same"))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3),
                                        convolution_mode="same"))
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(DenseLayer(n_out=4096, dropout=0.5))
                .layer(DenseLayer(n_out=4096, dropout=0.5))
                .layer(OutputLayer(n_out=self.num_classes, loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


def _vgg(blocks, self):
    h, w, c = self.input_shape
    b = _list_builder(self, "relu", "relu")
    for n_convs, n_out in blocks:
        for _ in range(n_convs):
            b = b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                         convolution_mode="same"))
        b = b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
    b = (b.layer(DenseLayer(n_out=4096, dropout=0.5))
         .layer(DenseLayer(n_out=4096, dropout=0.5))
         .layer(OutputLayer(n_out=self.num_classes, loss="mcxent")))
    return b.set_input_type(InputType.convolutional(h, w, c)).build()


class VGG16(ZooModel):
    """VGG-16 (ref: zoo/model/VGG16.java)."""

    def conf(self):
        return _vgg([(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)], self)


class VGG19(ZooModel):
    """VGG-19 (ref: zoo/model/VGG19.java)."""

    def conf(self):
        return _vgg([(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)], self)


class TextGenerationLSTM(ZooModel):
    """Char-level text generation: 2x GravesLSTM(256) + RnnOutputLayer
    (mcxent), rmsprop, truncated BPTT 50/50."""

    num_classes = 26          # vocab size
    input_shape = (50, 26)    # (max length, vocab)
    bptt_remat = False        # LSTM.bptt_remat; set before init_model

    def conf(self):
        t, v = self.input_shape
        return (NeuralNetConfiguration.Builder()
                .seed(self.seed).updater("rmsprop")
                .learning_rate(self.learning_rate)
                .activation("tanh").weight_init("xavier")
                .list()
                .layer(GravesLSTM(n_out=256, bptt_remat=self.bptt_remat))
                .layer(GravesLSTM(n_out=256, bptt_remat=self.bptt_remat))
                .layer(RnnOutputLayer(n_out=self.num_classes, loss="mcxent"))
                .backprop_type("truncated_bptt")
                .t_bptt_forward_length(50)
                .t_bptt_backward_length(50)
                .set_input_type(InputType.recurrent(v, t))
                .build())


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
