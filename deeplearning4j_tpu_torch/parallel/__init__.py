"""Parallel training and inference (counterpart of
deeplearning4j_tpu/parallel/): ParallelInference (with InferenceMode),
ModelServer and ModelClient, TrainingMaster and ParallelWrapper (data and
tensor parallelism), the five-axis mesh (`make_mesh`, `MeshSpec`, the
sharding rules), the local-SGD and stale-gradient trainers, ring
attention over the sp axis, the DCN model and the partitioners. One
process per rank, one device per process: `collectives` is the one module
that calls torch.distributed.

The exports load on first use (PEP 562), so the engine and the layers
can import `parallel.collectives` without importing the trainers that
import them.
"""

import importlib

_EXPORTS = {
    "make_mesh": "mesh", "MeshSpec": "mesh",
    "batch_sharding": "sharding", "param_shardings": "sharding",
    "replicated": "sharding", "shard_params": "sharding",
    "gather_params": "sharding",
    "TensorParallel": "tensor_parallel",
    "ring_self_attention": "ring_attention",
    "LocalStepTrainer": "wrapper", "ParallelWrapper": "wrapper",
    "StaleGradientTrainer": "wrapper",
    "InferenceMode": "inference", "ParallelInference": "inference",
    "ModelClient": "serving", "ModelServer": "serving",
    "TrainingMaster": "training_master",
    "DcnLink": "dcn_model", "allreduce_ms": "dcn_model",
    "crossover_report": "dcn_model", "dcn_sweep": ("dcn_model", "sweep"),
    "BalancedPartitioner": "repartition",
    "HashingBalancedPartitioner": "repartition",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    where = _EXPORTS.get(name)
    if where is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    mod, attr = where if isinstance(where, tuple) else (where, name)
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
