"""ZooModel base (counterpart of deeplearning4j_tpu/zoo/base.py).

A zoo model builds its configuration (`conf()`) and an initialized
network (`init_model(device=None)`, on CUDA unless device="cpu"): a
ComputationGraph for a graph configuration, a MultiLayerNetwork for a
layer list. Pretrained weights are not bundled; a JAX-package model zip
loads through util/model_serializer.restore_model.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence


class ZooModel:
    num_classes: int = 1000
    input_shape: Sequence[int] = (224, 224, 3)

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
