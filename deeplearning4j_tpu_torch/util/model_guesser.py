"""ModelGuesser: load a model or a configuration from a file by sniffing
its kind (counterpart of deeplearning4j_tpu/util/model_guesser.py).

A model zip (the JAX package's or the port's `write_model`) loads as the
network its `meta.json` names — a ComputationGraph or a
MultiLayerNetwork — on `device` (CUDA unless "cpu"); a JSON file loads
as the configuration it holds.
"""

from __future__ import annotations

import json
import zipfile


class ModelGuesser:
    @staticmethod
    def load_model_guess(path, device=None, compute_dtype=None):
        """A network (MultiLayerNetwork or ComputationGraph) from a model
        zip, or a bare configuration from a JSON file."""
        from deeplearning4j_tpu_torch.util.model_serializer import (
            META_ENTRY,
            restore_computation_graph,
            restore_multi_layer_network,
        )

        if zipfile.is_zipfile(path):
            with zipfile.ZipFile(path) as z:
                meta = (json.loads(z.read(META_ENTRY).decode())
                        if META_ENTRY in z.namelist() else {})
            restore = (restore_computation_graph
                       if meta.get("model_type") == "ComputationGraph"
                       else restore_multi_layer_network)
            return restore(path, device=device, compute_dtype=compute_dtype)
        return ModelGuesser.load_config_guess(path)

    @staticmethod
    def load_config_guess(path):
        with open(path) as f:
            return ModelGuesser.load_config_guess_dict(json.load(f))

    @staticmethod
    def load_config_guess_dict(d: dict):
        if "vertices" in d or "network_inputs" in d:
            from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
                ComputationGraphConfiguration,
            )
            return ComputationGraphConfiguration.from_dict(d)
        from deeplearning4j_tpu_torch.nn.conf.network import (
            MultiLayerConfiguration,
        )
        return MultiLayerConfiguration.from_dict(d)
