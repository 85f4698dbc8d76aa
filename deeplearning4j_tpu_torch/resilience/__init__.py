"""Resilience (counterpart of deeplearning4j_tpu/resilience/): typed
errors, fault injection, Retry/CircuitBreaker, crash-safe checkpoint
integrity (single host), the training guard, snapshotter, step watchdog,
preemption handler and Supervisor. The cluster supervisor waits (ROADMAP
queues 8-9)."""

from deeplearning4j_tpu_torch.resilience.errors import (  # noqa: F401
    CheckpointIntegrityError,
    CircuitOpenError,
    DeadlineExceededError,
    FaultInjectedError,
    InferenceUnavailableError,
    NonFiniteLossError,
    OverloadedError,
    PreemptedError,
    ResilienceError,
    RestartsExhaustedError,
    RetriesExhaustedError,
    ShutdownError,
    StepHangError,
)
from deeplearning4j_tpu_torch.resilience.faults import (  # noqa: F401
    REGISTERED_POINTS,
    FaultInjector,
    FaultSpec,
    fire,
    injector,
)
from deeplearning4j_tpu_torch.resilience.checkpoint_integrity import (  # noqa: F401
    apply_retention,
    atomic_write_bytes,
    atomic_write_json,
    atomic_writer,
    compute_state_digest,
    list_all_checkpoints,
    list_step_checkpoints,
    newest_valid_checkpoint,
    read_manifest,
    record_checksum,
    require_valid,
    require_valid_tree,
    sha256_file,
    state_digest,
    step_filename,
    validate_file,
    validate_tree,
    write_tree_manifest,
)
from deeplearning4j_tpu_torch.resilience.retry import (  # noqa: F401
    CircuitBreaker,
    Retry,
)
from deeplearning4j_tpu_torch.resilience.supervisor import (  # noqa: F401
    NonFiniteGuard,
    PeriodicSnapshotter,
    PreemptionHandler,
    StepWatchdog,
    Supervisor,
    fire_hang_hard,
)
