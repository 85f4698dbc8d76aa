"""Resilience (counterpart of deeplearning4j_tpu/resilience/): typed
errors, fault injection, Retry/CircuitBreaker, crash-safe checkpoint
integrity (single host), the training guard, snapshotter, step watchdog,
preemption handler and Supervisor, and the cluster supervisor with its
heartbeat leases and the per-rank divergence quorum."""

from deeplearning4j_tpu_torch.resilience.errors import (  # noqa: F401
    CheckpointDivergenceError,
    CheckpointIntegrityError,
    CircuitOpenError,
    DeadlineExceededError,
    FaultInjectedError,
    GenerationPoisonedError,
    InferenceUnavailableError,
    ModelNotFoundError,
    NoHealthyReplicaError,
    NonFiniteLossError,
    OverloadedError,
    PreemptedError,
    QuotaExceededError,
    ResilienceError,
    RestartsExhaustedError,
    RetriesExhaustedError,
    RolloutHeldError,
    ServingError,
    ShutdownError,
    StepHangError,
)
from deeplearning4j_tpu_torch.resilience.faults import (  # noqa: F401
    ENV_VAR as FAULTS_ENV_VAR,
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
    collect_sharded_slices,
    compute_state_digest,
    divergence_quorum,
    list_all_checkpoints,
    list_step_checkpoints,
    newest_valid_checkpoint,
    quorum_resume_step,
    rank_checkpoint_dir,
    read_manifest,
    record_checksum,
    shard_sidecar_filename,
    sharded_quorum_resume_step,
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
from deeplearning4j_tpu_torch.resilience.cluster import (  # noqa: F401
    EXIT_HANG,
    EXIT_NAN,
    ClusterSupervisor,
    HeartbeatFile,
    heartbeat_path,
    reap_stray_workers,
)
