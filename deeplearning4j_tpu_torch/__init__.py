"""deeplearning4j_tpu_torch: the PyTorch + CUDA port of deeplearning4j_tpu.

The JAX package `deeplearning4j_tpu` is the reference; this package mirrors
its module layout (nn/, nn/conf/, nn/layers/, nn/helpers/, zoo/, util/,
parallel/, resilience/) so every module has a findable counterpart. It
imports torch, numpy and the standard library only — never jax, and never
anything of the JAX package.

Device policy: entry points run on "cuda" unless the caller passes
device="cpu". Without a GPU and without device="cpu" they raise; nothing
falls back to the CPU silently. Layouts stay NHWC (activations) and HWIO
(conv weights) at every public function, as in the JAX package.

Ported so far: ResNet-50 inference through ComputationGraph.output, the
fused helper tier (helpers="fused"/"pallas"), the hand-written CUDA
kernels of the fused 1x1 and 3x3 convolutions and of the 1x1 backward
(nn/helpers/pallas_conv.py, sources in csrc/), training (fit, the losses,
updaters and schedules), the model files (util/model_serializer.py:
the JAX package's zips both ways), batched serving
(parallel/inference.py), and the training engine: engine/ (StepProgram,
whose run_group replays a CUDA graph of k captured steps; StepHarness;
the input pipeline), resilience/ (the non-finite guard), datasets/,
observability/metrics.py and earlystopping/.
"""

from deeplearning4j_tpu_torch.device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
