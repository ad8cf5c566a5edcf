"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit) and the least time a piece of work can take on it."""
from __future__ import annotations

PEAK_INT8_OPS = 1979e12     # int8 tensor-core operations a second
PEAK_CUDA_CORE_OPS = 67e12  # operations a second outside the tensor cores
PEAK_BYTES = 3.35e12        # HBM3 bytes a second


def bound_s(nbytes: float, tc_ops: float, cc_ops: float = 0.0) -> float:
    """Seconds the work needs at least: the larger of its bytes at the
    memory rate, its tensor-core operations at the int8 rate and its
    operations outside the tensor cores (depthwise taps) at theirs."""
    return max(nbytes / PEAK_BYTES, tc_ops / PEAK_INT8_OPS,
               cc_ops / PEAK_CUDA_CORE_OPS)
