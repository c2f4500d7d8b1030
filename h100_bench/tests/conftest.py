"""Fixtures of the benchmark's tests: a throwaway cell at a small frame
size, written into a temporary directory beside the benchmark's own
files (the data-driven path a later cell takes)."""

import json
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def small_cell(tmp: Path, config: str, traffic: str, width: int,
               height: int, path_over=None, warmup=None, config_over=None,
               **traffic_over):
    """A cell ``<config>-small.<traffic>-small`` of ``config`` at
    ``width`` × ``height`` under ``traffic`` with a one-pose warm-up (or
    ``warmup``), ``path_over`` over its path's parameters and
    ``config_over`` over the configuration's settings, its files in
    ``tmp``; returns the loaded cell."""
    from h100_bench import cells

    (tmp / "configs").mkdir(exist_ok=True)
    (tmp / "traffic").mkdir(exist_ok=True)
    c = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    c.update(name=f"{config}-small", width=width, height=height,
             **(config_over or {}))
    (tmp / "configs" / f"{config}-small.json").write_text(json.dumps(c))
    t = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    t["path"]["warmup"] = warmup or {k: 1 for k in t["path"]["warmup"]}
    t["path"].update(path_over or {})
    t.update(traffic_over)
    (tmp / "traffic" / f"{traffic}-small.json").write_text(json.dumps(t))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = f"{config}-small.{traffic}-small"
    bench["workloads"].append({"name": name, "config": f"{config}-small",
                               "traffic": f"{traffic}-small", "chips": 1,
                               "why": "a small copy for tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return cells.load_cell(name, tmp / "BENCHMARK.json", (tmp, BENCH))


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
