from deeplearning4j_tpu_torch.resilience.errors import (  # noqa: F401
    CheckpointIntegrityError,
    DeadlineExceededError,
    InferenceUnavailableError,
    OverloadedError,
    ResilienceError,
    ShutdownError,
)
