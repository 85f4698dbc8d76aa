"""EarlyStoppingParallelTrainer: early stopping driven through
ParallelWrapper (counterpart of
deeplearning4j_tpu/earlystopping/parallel_trainer.py; parity:
deeplearning4j-scaleout-parallelwrapper EarlyStoppingParallelTrainer.java —
same termination/saver semantics, training delegated to ParallelWrapper
over the live process group: `workers` (default world // tp), `tp`
(tensor parallelism: each flush's fit holds this rank's param slices and
ends with the params whole), a `mesh`, `averaging_frequency`)."""

from __future__ import annotations

from deeplearning4j_tpu_torch.earlystopping.trainer import EarlyStoppingTrainer
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    def __init__(self, config, net, train_iterator, workers=None,
                 tp: int = 1, mesh=None, averaging_frequency: int = 1,
                 guard=None, pipeline=None):
        super().__init__(config, net, train_iterator, guard=guard,
                         pipeline=pipeline)
        # the trainer's own pipeline already overlaps ETL; the inner
        # wrapper fits tiny buffered groups, where spinning up a
        # producer thread per flush would cost more than it hides
        self.wrapper = ParallelWrapper(
            net, workers=workers, tp=tp, mesh=mesh,
            averaging_frequency=averaging_frequency, pipeline=False)
        self._group = []

    def _pipeline_host_only(self) -> bool:
        # buffered batches are staged by the wrapper
        return True

    def _fit_batch(self, batch):
        # buffer to the wrapper's averaging frequency;
        # wrapper.fit's epoch counter is neutralized (the trainer owns
        # the epoch count)
        self._group.append(batch)
        if len(self._group) >= self.wrapper.averaging_frequency:
            self._flush()

    def _flush(self):
        if not self._group:
            return
        e = self.net.epoch
        self.wrapper.fit(self._group)
        self.net.epoch = e
        self._group = []

    def _on_epoch_data_end(self):
        self._flush()
