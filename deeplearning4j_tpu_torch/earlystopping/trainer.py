"""EarlyStoppingTrainer (counterpart of
deeplearning4j_tpu/earlystopping/trainer.py; parity: earlystopping/trainer/
EarlyStoppingTrainer.java / BaseEarlyStoppingTrainer.java): epoch loop
with per-iteration abort conditions, per-epoch held-out scoring, best-
model checkpointing, on the engine's StepHarness. EarlyStoppingParallelTrainer
(earlystopping/parallel_trainer.py) overrides its batch and end-of-epoch
hooks to train through ParallelWrapper."""

from __future__ import annotations

import logging

from deeplearning4j_tpu_torch.earlystopping.config import (
    EarlyStoppingResult,
    TerminationReason,
)

logger = logging.getLogger("deeplearning4j_tpu_torch")


class EarlyStoppingTrainer:
    def __init__(self, config, net, train_iterator, guard=None,
                 snapshot_every: int = 0,
                 pipeline=None, pipeline_depth: int = 2):
        """`guard` (resilience.NonFiniteGuard) checks the net after
        (sampled) training batches: a non-finite/spiking batch is
        skipped with the pre-batch state restored (policy='skip_step')
        or aborts the fit (policy='abort'). 'rollback' needs a
        rollback target: pass `snapshot_every=N` and an in-memory
        device snapshot (resilience.PeriodicSnapshotter) refreshed
        every N guarded batches is restored instead — no checkpoint
        directory required. `pipeline` (default on) stages the training
        batches through the harness's input pipeline
        (engine/pipeline.IteratorPipeline) onto the net's device."""
        self._snapshotter = None
        if guard is not None and guard.policy == "rollback":
            if snapshot_every <= 0:
                raise ValueError(
                    "NonFiniteGuard(policy='rollback') under "
                    "EarlyStoppingTrainer needs snapshot_every=N > 0 "
                    "(an in-memory rollback target)")
            from deeplearning4j_tpu_torch.resilience.supervisor import (
                PeriodicSnapshotter,
            )

            self._snapshotter = PeriodicSnapshotter(
                guard, every=snapshot_every)
        from deeplearning4j_tpu_torch.engine import StepHarness

        self.config = config
        self.net = net
        self.train_iterator = train_iterator
        self.pipeline = pipeline
        self.pipeline_depth = max(1, int(pipeline_depth))
        # the shared supervisor (engine/); this trainer's rollback
        # target is the in-memory snapshotter
        self._harness = StepHarness(net, guard=guard,
                                    snapshotter=self._snapshotter)
        self.guard = self._harness.guard

    def _pipeline_enabled(self) -> bool:
        return True if self.pipeline is None else bool(self.pipeline)

    def _pipeline_host_only(self) -> bool:
        """Device staging suits the plain trainer (fit_batch consumes
        the staged tuple directly); the parallel trainer re-buffers
        host batches for its wrapper and overrides this to True."""
        return False

    def _fit_batch(self, batch):
        """One training batch through the shared StepProgram (full
        fit_batch semantics); EarlyStoppingParallelTrainer overrides it
        to route through ParallelWrapper. Uses the fit_batch path so the
        net's epoch counter stays under THIS trainer's control."""
        self._harness.program.run_batch(batch)

    def _fit_batch_guarded(self, batch) -> bool:
        """Run one batch under the shared harness's guard dispatch
        (engine.StepHarness.guarded); False = batch rejected (state
        restored), so the caller skips score/termination checks."""
        if self.guard is None:
            self._fit_batch(batch)
            return True
        return self._harness.guarded(
            lambda: self._fit_batch(batch),
            context=f"at epoch {self.net.epoch}", observe=False)

    def _on_epoch_data_end(self):
        """Hook after the epoch's batch loop (the parallel trainer
        flushes its buffered batches here)."""

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        net = self.net
        if not net._initialized():
            net.init()
        for c in (cfg.epoch_termination_conditions
                  + cfg.iteration_termination_conditions):
            c.initialize()
        score_vs_epoch = {}
        best_score = None
        best_epoch = -1
        epoch = 0
        reason = None
        details = ""

        # shared session lifecycle: flush + close the train iterator's
        # prefetch thread (AsyncDataSetIterator.close) even when a
        # termination condition or the guard aborts the fit
        self._data = self.train_iterator
        if self._pipeline_enabled():
            self._data = self._harness.build_iterator_pipeline(
                self.train_iterator, depth=self.pipeline_depth,
                host_only=self._pipeline_host_only())
        else:
            self._harness.attach_data(self.train_iterator)
        with self._harness.session():
            reason, details, best_score, best_epoch, epoch = \
                self._fit_epochs(cfg, net, score_vs_epoch, best_score,
                                 best_epoch, epoch, reason, details)

        logger.info("Early stopping: %s (%s); best epoch %d score %s",
                    reason, details, best_epoch, best_score)
        best_model = cfg.model_saver.get_best_model(like_net=net)
        return EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            score_vs_epoch=score_vs_epoch,
            best_model_epoch=best_epoch,
            best_model_score=(float("nan") if best_score is None
                              else best_score),
            total_epochs=epoch,
            best_model=best_model,
        )

    def _fit_epochs(self, cfg, net, score_vs_epoch, best_score,
                    best_epoch, epoch, reason, details):
        data = getattr(self, "_data", self.train_iterator)
        while reason is None:
            net.epoch = epoch
            if hasattr(data, "reset"):
                data.reset()
            for batch in data:
                if not self._fit_batch_guarded(batch):
                    continue   # guard rejected the batch: state restored
                score = net.score()
                if score is None:
                    # no step has run yet (the parallel trainer buffers
                    # batches): the iteration conditions are only
                    # defined on real scores
                    continue
                for c in cfg.iteration_termination_conditions:
                    if c.terminate(score):
                        reason = TerminationReason.ITERATION_TERMINATION
                        details = f"{type(c).__name__} at score {score}"
                        break
                if reason:
                    break
            if reason:
                break
            self._on_epoch_data_end()

            if epoch % cfg.evaluate_every_n_epochs == 0:
                if cfg.score_calculator is not None:
                    score = cfg.score_calculator.calculate_score(net)
                else:
                    score = net.score()
                score_vs_epoch[epoch] = score
                if best_score is None or score < best_score:
                    best_score = score
                    best_epoch = epoch
                    cfg.model_saver.save_best_model(net, score)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(net, score)
                for c in cfg.epoch_termination_conditions:
                    if c.terminate(epoch, score):
                        reason = TerminationReason.EPOCH_TERMINATION
                        details = f"{type(c).__name__} at epoch {epoch}"
                        break
            epoch += 1
        return reason, details, best_score, best_epoch, epoch
