"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): the yardstick of every roofline and MFU share."""

BF16_FLOPS = 989e12          # dense bf16 / fp16 tensor-core FLOP/s
F32_FLOPS = 67e12            # float32 outside the tensor cores
HBM_BYTES = 3.35e12          # HBM3 bytes/s


def least_seconds(flops: float, nbytes: float, peak_flops: float = BF16_FLOPS) -> float:
    """The least time the chip could take for the work: the larger of its
    operations over the peak FLOP/s and its bytes over the peak bytes/s."""
    return max(flops / peak_flops, nbytes / HBM_BYTES)
