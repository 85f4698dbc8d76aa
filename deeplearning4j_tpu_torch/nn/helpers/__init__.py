"""Accelerated helper tier (counterpart of deeplearning4j_tpu/nn/helpers/).

The helper modes are the JAX package's, unchanged, so configurations
cross between the packages: "none" runs each layer through torch ops;
"fused" runs the graph-level conv+BN+act(+add) fusion (fused_graph.py)
with torch convolutions; "pallas" runs the same fusion with the
hand-written kernels of pallas_conv.py (CUDA C++ for sm_90a) wherever
their geometry applies.
"""

HELPER_MODES = ("none", "fused", "pallas")


def validate_helper_mode(mode: str) -> str:
    """Shared whitelist for the helper tier ('' / None = unset)."""
    if mode in ("", None):
        return ""
    if mode not in HELPER_MODES:
        raise ValueError(
            f"Unknown helper mode '{mode}'. "
            f"Known: {', '.join(HELPER_MODES)}")
    return mode


from deeplearning4j_tpu_torch.nn.helpers.fused_ops import (  # noqa: E402
    bn_affine,
    fused_conv,
)
from deeplearning4j_tpu_torch.nn.helpers.pallas_conv import (  # noqa: E402
    dgrad_conv1x1,
    fused_conv_bn_act,
    fused_conv1x1,
    fused_conv3x3,
    wgrad_conv1x1,
)

__all__ = ["HELPER_MODES", "validate_helper_mode", "bn_affine",
           "dgrad_conv1x1", "fused_conv", "fused_conv_bn_act",
           "fused_conv1x1", "fused_conv3x3", "wgrad_conv1x1"]
