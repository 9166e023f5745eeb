"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet; dense
rates, no sparsity), at its full 700 W power limit.  Kept with the benchmark
so that the yardstick does not move when the program changes."""

F32_FLOPS = 67e12  # f32 on the CUDA cores, outside the tensor cores
BF16_FLOPS = 989e12  # bf16 / fp16 on the tensor cores
INT8_OPS = 1979e12  # int8 on the tensor cores
HBM_BYTES = 3.35e12  # HBM3 bytes/s


def bound_s(ops: float, nbytes: float, peak_ops: float = F32_FLOPS) -> float:
    """The least time the chip could take: the larger of operations over the
    peak rate and bytes over the memory bandwidth."""
    return max(ops / peak_ops, nbytes / HBM_BYTES)
