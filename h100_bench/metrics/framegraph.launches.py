"""framegraph.launches: kernel launches a frame (``cudaLaunchKernel`` and
``cudaLaunchKernelEx`` calls in the profiled segment over its frames):
the torch glue's and the port's kernels together."""


def read(run):
    d = run.device
    if d is None or not d.frames or not d.launches:
        return None
    return d.launches / d.frames
