"""Generate the Keras fixtures of the PyTorch port's tests and chip run.

Run by hand from the repo root, where tensorflow/keras are installed (the
test suite never imports them):

    python tests/fixtures/torch/gen_torch_keras_fixtures.py

Writes into tests/fixtures/torch/:
- keras_resblock.h5 and keras_resblock_expected.npz: a small functional
  residual block as Keras ResNet50 builds its blocks (ZeroPadding2D stem,
  convolutions with bias, BatchNormalization with epsilon 1.001e-5,
  Activation relu, Add), with non-trivial BatchNorm statistics, and
  Keras's own predictions on seeded inputs;
- keras_vgg16_config.json and keras_resnet50_config.json: the
  `model_config` attribute that `model.save("x.h5")` writes for
  `keras.applications.VGG16(weights=None)` and `ResNet50(weights=None)`,
  verbatim. Their weights (553 MB and 103 MB) are not committed: the chip
  run writes seeded weights beside each config into a whole-model .h5.
"""

import os
import sys
import tempfile

os.environ["CUDA_VISIBLE_DEVICES"] = ""

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def resblock(keras, layers, rng):
    inp = keras.Input((10, 10, 3), name="img")
    x = layers.ZeroPadding2D(1, name="stem_pad")(inp)
    x = layers.Conv2D(8, 3, strides=2, name="stem_conv")(x)
    x = layers.BatchNormalization(epsilon=1.001e-5, name="stem_bn")(x)
    x = layers.Activation("relu", name="stem_relu")(x)
    s = layers.Conv2D(16, 1, name="b_0_conv")(x)
    s = layers.BatchNormalization(epsilon=1.001e-5, name="b_0_bn")(s)
    y = layers.Conv2D(8, 1, name="b_1_conv")(x)
    y = layers.BatchNormalization(epsilon=1.001e-5, name="b_1_bn")(y)
    y = layers.Activation("relu", name="b_1_relu")(y)
    y = layers.Conv2D(8, 3, padding="same", name="b_2_conv")(y)
    y = layers.BatchNormalization(epsilon=1.001e-5, name="b_2_bn")(y)
    y = layers.Activation("relu", name="b_2_relu")(y)
    y = layers.Conv2D(16, 1, name="b_3_conv")(y)
    y = layers.BatchNormalization(epsilon=1.001e-5, name="b_3_bn")(y)
    y = layers.Add(name="b_add")([s, y])
    y = layers.Activation("relu", name="b_out")(y)
    y = layers.GlobalAveragePooling2D(name="avg_pool")(y)
    out = layers.Dense(5, activation="softmax", name="predictions")(y)
    m = keras.Model(inp, out, name="resblock")
    for layer in m.layers:
        if isinstance(layer, layers.BatchNormalization):
            c = layer.get_weights()[0].shape[0]
            layer.set_weights([
                rng.normal(1.0, 0.2, c).astype(np.float32),
                rng.normal(0.0, 0.2, c).astype(np.float32),
                rng.normal(0.0, 0.5, c).astype(np.float32),
                rng.uniform(0.5, 2.0, c).astype(np.float32)])
        elif isinstance(layer, layers.Conv2D):
            k, b = layer.get_weights()
            layer.set_weights([k, rng.normal(0.0, 0.3, b.shape)
                               .astype(np.float32)])
    return m


def saved_config(h5py, model, tmp):
    path = os.path.join(tmp, "m.h5")
    model.save(path)
    with h5py.File(path, "r") as f:
        raw = f.attrs["model_config"]
    os.remove(path)
    return raw.decode() if isinstance(raw, bytes) else raw


def main():
    import h5py
    from tensorflow import keras
    from tensorflow.keras import layers

    rng = np.random.default_rng(11)
    m = resblock(keras, layers, rng)
    m.compile(loss="categorical_crossentropy", optimizer="sgd")
    x = rng.normal(size=(4, 10, 10, 3)).astype(np.float32)
    m.save(os.path.join(HERE, "keras_resblock.h5"))
    np.savez(os.path.join(HERE, "keras_resblock_expected.npz"),
             x=x, y=m.predict(x, verbose=0))

    with tempfile.TemporaryDirectory() as tmp:
        for name, build in (("vgg16", keras.applications.VGG16),
                            ("resnet50", keras.applications.ResNet50)):
            cfg = saved_config(h5py, build(weights=None), tmp)
            with open(os.path.join(HERE, f"keras_{name}_config.json"),
                      "w") as f:
                f.write(cfg)
            keras.backend.clear_session()
    print("fixtures written to", HERE)


if __name__ == "__main__":
    sys.exit(main())
