"""Training engine (counterpart of deeplearning4j_tpu/engine/): ONE step
program + ONE host supervisor.

  StepProgram   the step half — one train step on an explicit carry
                (the network's `_step`, nn/base_network.py), in every
                grouping: `run` / `run_batch` (one step) and `run_group`
                (k steps in one dispatch: one replay of a CUDA graph
                holding k captured train steps on the card, the body
                itself on the CPU),
                with the per-inner-step losses preserved so a
                NonFiniteGuard can condemn ONE poisoned inner step.
  StepHarness   the host half — one supervisor owning the guard-verdict
                dispatch (skip / rollback / abort), preemption checks,
                the StepAccumulator every per-step metric batches
                through, the watchdog, tracer and phase-profiler hooks,
                the input pipeline, and teardown (flush, close attached
                data iterators). TrainingMaster,
                ParallelWrapper and EarlyStoppingTrainer drive their
                loops through it.
  pipeline      the harness-owned input pipeline (engine/pipeline.py):
                StepPrefetcher (TrainingMaster's batch_fn) and
                IteratorPipeline (iterator-driven fits) run fetch and
                host-side staging ahead of the compute; stack_staged
                stacks a k-window on the card.

The mesh/sharding subsystem (ZeRO-1) and the decode program wait
(ROADMAP queues 9 and 6).
"""

from deeplearning4j_tpu_torch.engine.harness import StepHarness
from deeplearning4j_tpu_torch.engine.pipeline import (
    SKIPPED,
    IteratorPipeline,
    StepPrefetcher,
    stack_staged,
)
from deeplearning4j_tpu_torch.engine.step_program import (
    StepProgram,
    make_loss_and_apply,
)

__all__ = ["StepProgram", "StepHarness", "make_loss_and_apply",
           "StepPrefetcher", "IteratorPipeline", "stack_staged", "SKIPPED"]
