"""glue.device_ms: device ms a frame of every device op in the profiled
segment that is not one of the port's hand-written kernels (the
kernels are listed in ``tracing.PORT_KERNELS``: raster_kernel,
shade_kernel, sort_cluster, sort_onesweep, overlay_kernel,
gbuffer_shade_kernel, sample_block_kernel, sample_block_pair_kernel,
sample_small_kernel, mip_block_kernel, raster_earlyz_kernel,
raster_gw_kernel, raster_fine_kernel; copies and fills count as glue)."""

from h100_bench.tracing import port_kernel


def read(run):
    d = run.device
    if d is None or not d.frames:
        return None
    us = sum(b - a for name, a, b in d.ops if port_kernel(name) is None)
    return us / 1e3 / d.frames if us > 0 else None
