"""The plain reference: float32 PyTorch, no kernel, cache or batching of
the program under test, and nothing imported from it.

`net.py` runs a model described as a list of nodes (the format below);
each configuration's own file (`<config>.py`) builds that list from the
configuration's published widths. Parameters and BatchNorm statistics
use the program's public layout (NHWC activations, HWIO kernels, one
dict per layer keyed by the layer's name), so the benchmark hands the
same seeded tensors to both sides.
"""
