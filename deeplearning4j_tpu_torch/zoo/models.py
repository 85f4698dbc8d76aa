"""Zoo architectures (counterpart of deeplearning4j_tpu/zoo/models.py).

The layer-list models LeNet, SimpleCNN, AlexNet, VGG16, VGG19 and
TextGenerationLSTM (MultiLayerNetwork) and the graph models ResNet50,
GoogLeNet, InceptionResNetV1 and FaceNetNN4Small2, built from the
`_conv_bn` block. Each configuration serializes to the JAX package's JSON
exactly.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import (
    ElementWiseVertex,
    L2NormalizeVertex,
    MergeVertex,
    ScaleVertex,
)
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer,
    BatchNormalization,
    CenterLossOutputLayer,
    ConvolutionLayer,
    DenseLayer,
    DropoutLayer,
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


def _pool_same(gb, name, inp, stride):
    """A 3x3 SAME max pool at `stride` (the inception stems and branches)."""
    gb.add_layer(name, SubsamplingLayer(kernel_size=(3, 3), stride=stride,
                                        convolution_mode="same"), inp)
    return name


def _embedding_head(self, gb, x, out_name):
    """Global average pool, a linear bottleneck to `embedding_size`, L2
    normalized embeddings and a center-loss softmax head."""
    gb.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
    gb.add_layer("bottleneck",
                 DenseLayer(n_out=self.embedding_size,
                            activation="identity"), "avgpool")
    gb.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
    gb.add_layer(out_name,
                 CenterLossOutputLayer(n_out=self.num_classes,
                                       loss="mcxent"), "embeddings")
    gb.set_outputs(out_name)


class GoogLeNet(ZooModel):
    """GoogLeNet / Inception-v1: inception modules (1x1, 1x1->3x3,
    1x1->5x5 and a stride-1 SAME max pool->1x1, merged), dropout 0.4
    before the head."""

    num_classes = 1000
    input_shape = (224, 224, 3)

    def _inception(self, gb, name, inp, f1, f3r, f3, f5r, f5, pp):
        b1 = _conv_bn(gb, f"{name}_1x1", inp, f1, (1, 1))
        b3 = _conv_bn(gb, f"{name}_3x3r", inp, f3r, (1, 1))
        b3 = _conv_bn(gb, f"{name}_3x3", b3, f3, (3, 3))
        b5 = _conv_bn(gb, f"{name}_5x5r", inp, f5r, (1, 1))
        b5 = _conv_bn(gb, f"{name}_5x5", b5, f5, (5, 5))
        pool = _pool_same(gb, f"{name}_pool", inp, (1, 1))
        bp = _conv_bn(gb, f"{name}_poolproj", pool, pp, (1, 1))
        gb.add_vertex(f"{name}_concat", MergeVertex(), b1, b3, b5, bp)
        return f"{name}_concat"

    def conf(self):
        h, w, c = self.input_shape
        gb = _graph_builder(self).add_inputs("input")
        x = _conv_bn(gb, "c1", "input", 64, (7, 7), stride=(2, 2))
        _pool_same(gb, "p1", x, (2, 2))
        x = _conv_bn(gb, "c2r", "p1", 64, (1, 1))
        x = _conv_bn(gb, "c2", x, 192, (3, 3))
        _pool_same(gb, "p2", x, (2, 2))
        x = self._inception(gb, "i3a", "p2", 64, 96, 128, 16, 32, 32)
        x = self._inception(gb, "i3b", x, 128, 128, 192, 32, 96, 64)
        _pool_same(gb, "p3", x, (2, 2))
        x = self._inception(gb, "i4a", "p3", 192, 96, 208, 16, 48, 64)
        x = self._inception(gb, "i4b", x, 160, 112, 224, 24, 64, 64)
        x = self._inception(gb, "i4c", x, 128, 128, 256, 24, 64, 64)
        x = self._inception(gb, "i4d", x, 112, 144, 288, 32, 64, 64)
        x = self._inception(gb, "i4e", x, 256, 160, 320, 32, 128, 128)
        _pool_same(gb, "p4", x, (2, 2))
        x = self._inception(gb, "i5a", "p4", 256, 160, 320, 32, 128, 128)
        x = self._inception(gb, "i5b", x, 384, 192, 384, 48, 128, 128)
        gb.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        gb.add_layer("drop", DropoutLayer(dropout=0.4), "avgpool")
        gb.add_layer("output",
                     OutputLayer(n_out=self.num_classes, loss="mcxent"),
                     "drop")
        gb.set_outputs("output")
        gb.set_input_types(input=InputType.convolutional(h, w, c))
        return gb.build()


class InceptionResNetV1(ZooModel):
    """Inception-ResNet v1 embedding net: a conv stem, 5 / 10 / 5
    residual inception blocks (A, B with 1x7/7x1, C with 1x3/3x1; each
    branch merge projected back to the block's width, scaled and added
    to its input) with strided reductions between, L2-normalized
    embeddings and a center-loss head."""

    num_classes = 1000
    input_shape = (160, 160, 3)
    embedding_size = 128

    def _res_block(self, gb, name, inp, branch_defs, n_out, scale=0.17):
        outs = []
        for bi, branch in enumerate(branch_defs):
            x = inp
            for li, (f, k) in enumerate(branch):
                x = _conv_bn(gb, f"{name}_b{bi}_{li}", x, f, k)
            outs.append(x)
        gb.add_vertex(f"{name}_cat", MergeVertex(), *outs)
        up = _conv_bn(gb, f"{name}_up", f"{name}_cat", n_out, (1, 1),
                      activation=None)
        gb.add_vertex(f"{name}_scale", ScaleVertex(scale_factor=scale), up)
        gb.add_vertex(f"{name}_add", ElementWiseVertex(op="add"),
                      inp, f"{name}_scale")
        gb.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                     f"{name}_add")
        return f"{name}_out"

    def conf(self):
        h, w, c = self.input_shape
        gb = _graph_builder(self).add_inputs("input")
        x = _conv_bn(gb, "stem1", "input", 32, (3, 3), stride=(2, 2))
        x = _conv_bn(gb, "stem2", x, 32, (3, 3))
        x = _conv_bn(gb, "stem3", x, 64, (3, 3))
        x = _pool_same(gb, "stem_pool", x, (2, 2))
        x = _conv_bn(gb, "stem4", x, 80, (1, 1))
        x = _conv_bn(gb, "stem5", x, 192, (3, 3))
        x = _conv_bn(gb, "stem6", x, 256, (3, 3), stride=(2, 2))
        for i in range(5):
            x = self._res_block(
                gb, f"irA{i}", x,
                [[(32, (1, 1))], [(32, (1, 1)), (32, (3, 3))],
                 [(32, (1, 1)), (32, (3, 3)), (32, (3, 3))]], 256)
        x = _conv_bn(gb, "redA", x, 512, (3, 3), stride=(2, 2))
        for i in range(10):
            x = self._res_block(
                gb, f"irB{i}", x,
                [[(64, (1, 1))], [(64, (1, 1)), (64, (1, 7)), (64, (7, 1))]],
                512, scale=0.10)
        x = _conv_bn(gb, "redB", x, 896, (3, 3), stride=(2, 2))
        for i in range(5):
            x = self._res_block(
                gb, f"irC{i}", x,
                [[(96, (1, 1))], [(96, (1, 1)), (96, (1, 3)), (96, (3, 1))]],
                896, scale=0.20)
        _embedding_head(self, gb, x, "output")
        gb.set_input_types(input=InputType.convolutional(h, w, c))
        return gb.build()


class FaceNetNN4Small2(ZooModel):
    """FaceNet NN4.small2 embedding net: inception modules whose 1x1 and
    5x5 branches may be absent (0 filters) and whose pool branch may go
    unprojected, L2-normalized embeddings and a center-loss head."""

    num_classes = 1000
    input_shape = (96, 96, 3)
    embedding_size = 128

    def _inception(self, gb, name, inp, f1, f3r, f3, f5r, f5, pp):
        outs = []
        if f1:
            outs.append(_conv_bn(gb, f"{name}_1x1", inp, f1, (1, 1)))
        b3 = _conv_bn(gb, f"{name}_3x3r", inp, f3r, (1, 1))
        outs.append(_conv_bn(gb, f"{name}_3x3", b3, f3, (3, 3)))
        if f5r and f5:
            b5 = _conv_bn(gb, f"{name}_5x5r", inp, f5r, (1, 1))
            outs.append(_conv_bn(gb, f"{name}_5x5", b5, f5, (5, 5)))
        pool = _pool_same(gb, f"{name}_pool", inp, (1, 1))
        outs.append(_conv_bn(gb, f"{name}_pp", pool, pp, (1, 1)) if pp
                    else pool)
        gb.add_vertex(f"{name}_cat", MergeVertex(), *outs)
        return f"{name}_cat"

    def conf(self):
        h, w, c = self.input_shape
        gb = _graph_builder(self).add_inputs("input")
        x = _conv_bn(gb, "c1", "input", 64, (7, 7), stride=(2, 2))
        _pool_same(gb, "p1", x, (2, 2))
        x = _conv_bn(gb, "c2", "p1", 64, (1, 1))
        x = _conv_bn(gb, "c3", x, 192, (3, 3))
        _pool_same(gb, "p2", x, (2, 2))
        x = self._inception(gb, "i3a", "p2", 64, 96, 128, 16, 32, 32)
        x = self._inception(gb, "i3b", x, 64, 96, 128, 32, 64, 64)
        _pool_same(gb, "p3", x, (2, 2))
        x = self._inception(gb, "i4a", "p3", 256, 96, 192, 32, 64, 128)
        x = self._inception(gb, "i4e", x, 0, 160, 256, 64, 128, 0)
        _pool_same(gb, "p4", x, (2, 2))
        x = self._inception(gb, "i5a", "p4", 256, 96, 384, 0, 0, 96)
        x = self._inception(gb, "i5b", x, 256, 96, 384, 0, 0, 96)
        _embedding_head(self, gb, x, "lossLayer")
        gb.set_input_types(input=InputType.convolutional(h, w, c))
        return gb.build()
