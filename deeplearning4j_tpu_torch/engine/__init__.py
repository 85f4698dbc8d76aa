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

  decode_program  DecodeProgram (engine/decode_program.py): the
                decode-serving programs over a paged KV pool — the
                batched decode step, the chunk prefill and the page
                copy — run eagerly, updating the pool in place.

  mesh          MeshManager (engine/mesh.py): the live dp mesh over the
                process group and the ZeRO-1 placement policy;
  sharding      the ZeRO-1 slice arithmetic (numpy, shared with the
                checkpoints) and the sharded train step
                (engine/sharding.py), which `StepProgram.attach_mesh`
                routes every grouping through.
"""

from deeplearning4j_tpu_torch.engine.decode_program import DecodeProgram
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

from deeplearning4j_tpu_torch.engine.mesh import MeshManager  # noqa: E402

__all__ = ["DecodeProgram", "StepProgram", "StepHarness", "make_loss_and_apply",
           "StepPrefetcher", "IteratorPipeline", "stack_staged", "SKIPPED",
           "MeshManager"]
