from deeplearning4j_tpu_torch.resilience.errors import (  # noqa: F401
    CheckpointIntegrityError,
    DeadlineExceededError,
    FaultInjectedError,
    InferenceUnavailableError,
    NonFiniteLossError,
    OverloadedError,
    PreemptedError,
    ResilienceError,
    ShutdownError,
)
from deeplearning4j_tpu_torch.resilience.faults import (  # noqa: F401
    REGISTERED_POINTS,
    FaultInjector,
    FaultSpec,
    fire,
    injector,
)
from deeplearning4j_tpu_torch.resilience.supervisor import (  # noqa: F401
    NonFiniteGuard,
    PeriodicSnapshotter,
    PreemptionHandler,
)
