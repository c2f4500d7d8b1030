#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, on the card:

- the program's: a short window of the cell's own run for each seed of
  ``--seeds``, the sampled frames against the reference, as a run
  compares them;
- the control's: the reference computed in bfloat16 (the precision below
  the float32 the configuration states) put in the program's place, on
  the frames that the first ``--control-seeds`` seeds' runs compared;
- on the same frames, faults planted in the reference put in the
  program's place: each of the reference module's ``FAULTS`` (for the
  ShaderBall reference the light spheres and the gizmo left out, together
  and apart), and a 16 x 16 block inverted.

    python3 h100_bench/control.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 4] [--control-seeds 3]

Prints one JSON line a reading and, last, the largest program reading and
the smallest control and fault readings of each number. Not run by the benchmark's
own runs.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def inverted_block(img):
    """``img`` with a 16 x 16 block at its centre inverted."""
    out = img.copy()
    y, x = img.shape[0] // 2, img.shape[1] // 2
    out[y:y + 16, x:x + 16] = 255 - out[y:y + 16, x:x + 16]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control-seeds", type=int, default=3)
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    from h100_bench import check, harness
    from h100_bench.cells import load_cell

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    program, control, faults = [], [], {}
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        kept = {}
        result, checks = harness.run_cell(
            cell, seed, args.seconds, False, "cuda", t0,
            log=lambda m: print(m, file=sys.stderr, flush=True), keep=kept)
        row = {"seed": seed, "side": "program", "correct": result["correct"],
               "attempted": result["attempted"], "failed": result["failed"],
               **kept["readings"]}
        program.append(row)
        print(json.dumps(row), flush=True)
        if k < args.control_seeds:
            ref = harness.make_reference(cell.config, kept["root"], "cuda",
                                         dirs=cell.dirs)
            low = harness.make_reference(cell.config, kept["root"], "cuda",
                                         torch.bfloat16, dirs=cell.dirs)
            with torch.no_grad():
                read = check.readings(
                    lambda pose: harness.reference_frame(ref, pose),
                    [(harness.reference_frame(low, pose)[0], pose)
                     for pose in kept["poses"]])
            row = {"seed": seed, "side": "control", **read}
            control.append(row)
            print(json.dumps(row), flush=True)
            # Faults planted in the reference put in the program's place,
            # at the cell's own size: each of its module's FAULTS, and a
            # 16 x 16 block of each frame inverted where it is produced.
            planted = harness.reference_module(cell.config,
                                               cell.dirs).FAULTS
            for name in [*planted, "block"]:
                bad = ref if name == "block" else harness.make_reference(
                    dict(cell.config, **planted[name]), kept["root"], "cuda",
                    dirs=cell.dirs)
                with torch.no_grad():
                    frames = [harness.reference_frame(bad, pose)[0]
                              for pose in kept["poses"]]
                    if name == "block":
                        frames = [inverted_block(img) for img in frames]
                    read = check.readings(
                        lambda pose: harness.reference_frame(ref, pose),
                        list(zip(frames, kept["poses"])))
                faults.setdefault(name, []).append(read)
                print(json.dumps({"seed": seed, "side": name, **read}),
                      flush=True)
                del bad
            del ref, low
            torch.cuda.empty_cache()
    names = list(check.NAMES)
    print(json.dumps({
        "workload": args.workload, "seeds": len(program),
        "program_max": {n: max(r[n] for r in program) for n in names},
        "control_min": {n: min(r[n] for r in control) for n in names}
        if control else None,
        **{f"{f}_min": {n: min(r[n] for r in rows) for n in names}
           for f, rows in faults.items()},
        "limits": cell.config["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
