"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit). Shares of a roofline or of the
peak are stated against these, with the card's power limit beside them."""

BF16_FLOPS = 989e12     # bf16 / fp16 tensor cores
TF32_FLOPS = 495e12
F32_FLOPS = 67e12       # float32 outside the tensor cores
FP8_FLOPS = 1979e12
HBM_BYTES = 3.35e12     # bytes per second
HBM_CAPACITY = 80e9


def flops_peak(dtype: str) -> float:
    return {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS,
            "float32": F32_FLOPS, "tf32": TF32_FLOPS}[dtype]
