"""framegraph.host_syncs: the mean, over the window frames, of the
program's ``host_syncs`` counter under its ``framegraph.frame`` span
(blocking device-to-host reads and synchronous pageable host-to-device
copies, counted where they happen)."""

from h100_bench import program_trace


def read(run):
    return program_trace.host_syncs(run)
