"""Decode serving (counterpart of deeplearning4j_tpu/serving/, the
decode-serving part):

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

The control plane (registry, admission, router, controller) and the
HTTP surface wait for ROADMAP item 7.
"""

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
    "DecodeEngine", "GenerationHandle", "PagePool", "PrefixTrie",
    "reap_stray_engines", "sequential_decode",
    "FlightRecorder", "install_signal_dump", "load_dump",
    "reap_stray_flight_dumps",
    "GenerationJournal", "ephemeral_journal_dir", "frame_record",
    "read_records", "reap_stray_journals", "write_records",
]
