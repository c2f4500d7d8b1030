"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the roofline's two ceilings."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least time of ``nbytes`` moved and ``ops`` float32 operations:
    the longer of the two at the peaks."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
