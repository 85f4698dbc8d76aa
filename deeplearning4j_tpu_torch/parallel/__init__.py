from deeplearning4j_tpu_torch.parallel.inference import ParallelInference  # noqa: F401
