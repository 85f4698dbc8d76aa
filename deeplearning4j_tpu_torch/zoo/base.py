"""ZooModel base and ModelSelector (counterpart of
deeplearning4j_tpu/zoo/base.py).

A zoo model builds its configuration (`conf()`) and an initialized
network (`init_model(device=None)`, on CUDA unless device="cpu"): a
ComputationGraph for a graph configuration, a MultiLayerNetwork for a
layer list. Pretrained weights are not bundled: `load_pretrained` reads
a model zip (the JAX package's or the port's) through
util/model_guesser.py, from `pretrained_path()` — the same
`$DL4J_TPU_PRETRAINED_DIR/<class name>.zip` lookup as the JAX package,
so a zip dropped for one package is found by the other.
`init_pretrained` checks a registered md5 (`PRETRAINED`) first and
removes a file that fails it.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Dict, Optional, Sequence, Type


class ZooType:
    ALEXNET = "alexnet"
    FACENETNN4SMALL2 = "facenetnn4small2"
    GOOGLENET = "googlenet"
    INCEPTIONRESNETV1 = "inceptionresnetv1"
    LENET = "lenet"
    RESNET50 = "resnet50"
    SIMPLECNN = "simplecnn"
    TEXTGENLSTM = "textgenlstm"
    VGG16 = "vgg16"
    VGG19 = "vgg19"
    ALL = "all"
    CNN = "cnn"
    RNN = "rnn"


def _pretrained_root() -> str:
    return os.environ.get("DL4J_TPU_PRETRAINED_DIR",
                          os.path.expanduser("~/.deeplearning4j_tpu"))


class ZooModel:
    num_classes: int = 1000
    input_shape: Sequence[int] = (224, 224, 3)
    # pretrained kind -> (url, md5) of a published zip; file drops under
    # $DL4J_TPU_PRETRAINED_DIR are accepted without an entry
    PRETRAINED: Dict[str, tuple] = {}

    def __init__(self, num_classes: Optional[int] = None,
                 input_shape: Optional[Sequence[int]] = None,
                 seed: int = 123, updater: str = "nesterovs",
                 learning_rate: float = 1e-2, compute_dtype=None,
                 helpers: Optional[str] = None):
        if num_classes is not None:
            self.num_classes = num_classes
        if input_shape is not None:
            self.input_shape = tuple(input_shape)
        self.seed = seed
        self.updater = updater
        self.learning_rate = learning_rate
        self.compute_dtype = compute_dtype   # e.g. "bfloat16"
        self.helpers = helpers               # helper tier (nn/helpers)

    def conf(self):
        raise NotImplementedError

    def init_model(self, device=None):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.helpers import validate_helper_mode
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        c = self.conf()
        is_graph = hasattr(c, "helper_mode")
        if self.helpers is not None:
            mode = validate_helper_mode(self.helpers)
            if is_graph:
                c.helper_mode = mode
            else:
                logging.getLogger("deeplearning4j_tpu_torch").warning(
                    "%s: helpers=%r requested but the model is layer-list "
                    "based; the helper tier applies to ComputationGraph "
                    "models only", type(self).__name__, self.helpers)
        cls = ComputationGraph if is_graph else MultiLayerNetwork
        return cls(c, compute_dtype=self.compute_dtype, device=device).init()

    # ------------------------------------------------------- pretrained
    def pretrained_available(self) -> bool:
        return self.pretrained_path() is not None

    def pretrained_path(self) -> Optional[str]:
        p = os.path.join(_pretrained_root(),
                         f"{type(self).__name__.lower()}.zip")
        return p if os.path.exists(p) else None

    def pretrained_url(self, kind: str = "imagenet"):
        entry = self.PRETRAINED.get(kind)
        return entry[0] if entry else None

    def pretrained_checksum(self, kind: str = "imagenet"):
        entry = self.PRETRAINED.get(kind)
        return entry[1] if entry else None

    def init_pretrained(self, kind: str = "imagenet",
                        path: Optional[str] = None, device=None):
        """Load pretrained weights after an md5 check against
        `pretrained_checksum(kind)` (a file that fails it is removed and
        IOError raised). The file is `path`, or the dropped zip
        (`pretrained_path`). Where neither exists the JAX package
        downloads `pretrained_url(kind)`; the port reads no network and
        raises FileNotFoundError naming the URL to fetch."""
        path = path or self.pretrained_path()
        if path is None:
            url = self.pretrained_url(kind)
            where = (f"fetch {url} to " if url else "place a model zip at ")
            raise FileNotFoundError(
                f"No pretrained weights for {type(self).__name__} ({kind}) "
                f"on disk; {where}"
                f"{os.path.join(_pretrained_root(), type(self).__name__.lower() + '.zip')}")
        expect = self.pretrained_checksum(kind)
        if expect is not None:
            with open(path, "rb") as f:
                got = hashlib.md5(f.read()).hexdigest()
            if got != expect:
                os.remove(path)
                raise IOError(
                    f"pretrained checksum mismatch for {path}: "
                    f"{got} != {expect} (corrupt download removed)")
        return self.load_pretrained(path, device=device)

    def load_pretrained(self, path: Optional[str] = None, device=None):
        from deeplearning4j_tpu_torch.util.model_guesser import ModelGuesser

        path = path or self.pretrained_path()
        if path is None:
            raise FileNotFoundError(
                f"No pretrained weights for {type(self).__name__}; place a "
                "model zip under $DL4J_TPU_PRETRAINED_DIR")
        return ModelGuesser.load_model_guess(path, device=device)


class ModelSelector:
    """Select zoo models by type: ALL, CNN, RNN or one model's name."""

    @staticmethod
    def registry() -> Dict[str, Type[ZooModel]]:
        from deeplearning4j_tpu_torch.zoo import models as m

        return {
            ZooType.ALEXNET: m.AlexNet,
            ZooType.FACENETNN4SMALL2: m.FaceNetNN4Small2,
            ZooType.GOOGLENET: m.GoogLeNet,
            ZooType.INCEPTIONRESNETV1: m.InceptionResNetV1,
            ZooType.LENET: m.LeNet,
            ZooType.RESNET50: m.ResNet50,
            ZooType.SIMPLECNN: m.SimpleCNN,
            ZooType.TEXTGENLSTM: m.TextGenerationLSTM,
            ZooType.VGG16: m.VGG16,
            ZooType.VGG19: m.VGG19,
        }

    @staticmethod
    def select(zoo_type: str, **kwargs) -> Dict[str, ZooModel]:
        reg = ModelSelector.registry()
        if zoo_type == ZooType.ALL:
            names = list(reg)
        elif zoo_type == ZooType.CNN:
            names = [n for n in reg if n != ZooType.TEXTGENLSTM]
        elif zoo_type == ZooType.RNN:
            names = [ZooType.TEXTGENLSTM]
        elif zoo_type in reg:
            names = [zoo_type]
        else:
            raise ValueError(
                f"Unknown zoo type '{zoo_type}'; known: {sorted(reg)}")
        return {n: reg[n](**kwargs) for n in names}
