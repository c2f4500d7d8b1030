#!/usr/bin/env python3
"""The benchmark of ``bibim_tpu_torch`` on an NVIDIA GPU: one run of one
cell of ``BENCHMARK.json``.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Writes the seed's stand-in resource set (``h100_bench/.cache/``) on its
first use in a checkout, warms the cell's path up, drives the viewer
loop for ``--seconds``, compares a sample of the frames it handed back
with the plain reference, and prints
one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics, read from spans and a
``torch.profiler`` segment), ``device`` (and with ``--trace 1``
``breakdown``), and ``checks``, the compared numbers with their limits,
which also end standard error. Exits non-zero, printing no result, without
the cards the cell asks for, or if the JAX package or JAX was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# Top-level module names the process must not hold once the window has
# closed: JAX and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "bibim_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    from h100_bench.cells import load_cell
    from h100_bench.harness import run_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); this "
            f"machine has {torch.cuda.device_count()}")
        return 2
    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_PROCESS, log)
    found = forbidden_modules()
    if found:
        log(f"modules loaded that the benchmark must not load: {found}")
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
