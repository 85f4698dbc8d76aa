"""Serving control plane and decode serving (counterpart of
deeplearning4j_tpu/serving/):

  registry.py    ModelRegistry — N named models × versions, verified
                 loads, zero-downtime hot-swap, one-call rollback,
                 background drain/retire;
  admission.py   AdmissionController — per-tenant token-bucket quotas
                 and priority classes, shedding the lowest class first
                 in front of the bounded queue;
  router.py      ReplicaRouter — least-outstanding spreading over N
                 ModelServer replicas with CircuitBreaker health,
                 failover, generation migration and runtime membership;
  controller.py  FleetController — canary/ramp rollouts rolled back on
                 SLO breach (hold-down ledger), autoscaling, replica
                 death detection and backfill, fleet metric aggregation;

  continuous.py  DecodeEngine — continuous batching over a paged KV
                 pool (prefix sharing, copy-on-write, ring wrap,
                 eviction/quarantine replay, deadlines, watchdog
                 restart), GenerationHandle, PagePool, PrefixTrie, and
                 the per-request oracle `sequential_decode`;
  flight.py      FlightRecorder — the engine's last-N-steps ring with
                 atomic crash dumps;
  journal.py     GenerationJournal — the write-ahead generation journal
                 (the JAX package's record framing, so either package
                 recovers the other's journal).

The HTTP surface (the /v1/models routes) lives on ModelServer in
parallel/serving.py, which consumes all of these.
"""

from deeplearning4j_tpu_torch.serving.admission import (  # noqa: F401
    DEFAULT_SHED_THRESHOLDS,
    PRIORITY_CLASSES,
    AdmissionController,
    TenantConfig,
    TokenBucket,
)
from deeplearning4j_tpu_torch.serving.registry import (  # noqa: F401
    ModelEntry,
    ModelRegistry,
)
from deeplearning4j_tpu_torch.serving.router import ReplicaRouter  # noqa: F401
from deeplearning4j_tpu_torch.serving.controller import (  # noqa: F401
    ROLLOUT_STATES,
    FleetController,
    HttpReplica,
    LocalReplica,
    SLOPolicy,
    slo_sample,
)
from deeplearning4j_tpu_torch.serving.continuous import (  # noqa: F401
    DecodeEngine,
    GenerationHandle,
    PagePool,
    PrefixTrie,
    reap_stray_engines,
    sequential_decode,
)
from deeplearning4j_tpu_torch.serving.flight import (  # noqa: F401
    FlightRecorder,
    install_signal_dump,
    load_dump,
    reap_stray_flight_dumps,
)
from deeplearning4j_tpu_torch.serving.journal import (  # noqa: F401
    GenerationJournal,
    ephemeral_journal_dir,
    frame_record,
    read_records,
    reap_stray_journals,
    write_records,
)

__all__ = [
    "DEFAULT_SHED_THRESHOLDS", "PRIORITY_CLASSES", "ROLLOUT_STATES",
    "AdmissionController", "TenantConfig", "TokenBucket",
    "ModelEntry", "ModelRegistry", "ReplicaRouter",
    "FleetController", "HttpReplica", "LocalReplica", "SLOPolicy",
    "slo_sample",
    "DecodeEngine", "GenerationHandle", "PagePool", "PrefixTrie",
    "reap_stray_engines", "sequential_decode",
    "FlightRecorder", "install_signal_dump", "load_dump",
    "reap_stray_flight_dumps",
    "GenerationJournal", "ephemeral_journal_dir", "frame_record",
    "read_records", "reap_stray_journals", "write_records",
]
