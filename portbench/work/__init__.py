"""The work a call needs, counted from shapes and valid lengths alone, and the
one peak every cell is held to: ``work/<kind>.py`` holds ``count(shape)``,
which returns (operations, bytes) of one call.

Peaks: NVIDIA H100 SXM data sheet, dense bf16 989 TFLOP/s and HBM3 3.35 TB/s.
One peak for every cell, so that an implementation that reaches the exact
answer through bf16 tensor cores cannot read above 100%.
"""

PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the chip could take: operations or bytes at peak."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)
