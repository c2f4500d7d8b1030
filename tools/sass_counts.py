#!/usr/bin/env python3
"""Static SASS instruction counts of the port's kernels on one NVIDIA GPU
machine (needs ``nvcc`` and ``cuobjdump``; no GPU work is launched).

Run from the repository root: ``python3 tools/sass_counts.py [NAME ...]``.
It builds (or reuses) the kernel library, disassembles it with
``cuobjdump -sass`` and prints one JSON line per kernel function whose
demangled name contains one of NAME (default: every kernel): its
instruction count and its most frequent opcodes. Counts are static — a
loop body counts once — so they bound the work per pixel from below.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def demangle(names: list) -> dict:
    if not names or not shutil.which("c++filt"):
        return {n: n for n in names}
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True, timeout=60)
    return dict(zip(names, out.stdout.splitlines()))


def main() -> int:
    from bibim_tpu_torch import _build

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(_build.build())],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", line)
        if m and fn:
            counts[fn][m.group(1)] += 1
    names = demangle(list(counts))
    want = sys.argv[1:]
    for mangled, c in counts.items():
        name = names[mangled]
        if want and not any(w in name for w in want):
            continue
        print(json.dumps({"kernel": name, "instructions": sum(c.values()),
                          "opcodes": dict(c.most_common(16))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
