"""Cells, found by name: a cell of ``BENCHMARK.json`` names a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); its per-layer metrics are readers
``metrics/<metric>.py``, its traffic's driver ``drivers/<driver>.py``,
and the plain reference its configuration names (``"reference"``, by
default ``render``) ``reference/<name>.py``. A later cell, mix,
configuration, metric or reference is a new file; nothing here lists
them.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    dirs: tuple  # where its files were found


def _find(dirs, *parts) -> Path:
    for d in dirs:
        p = Path(d).joinpath(*parts)
        if p.is_file():
            return p
    raise FileNotFoundError("/".join(parts))


def _reports(metric: dict, cell: str, e2e: dict) -> bool:
    """Whether the cell reports a metric: its ``workloads`` list names the
    cell, or, without one, the cell reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return _reports(e2e[metric["moves"]], cell, e2e)
    return True


def load_cell(name: str, benchmark=BENCHMARK, dirs=(HERE,)) -> Cell:
    """The cell ``name`` of ``benchmark``, its files looked up in ``dirs``
    in order."""
    bench = json.loads(Path(benchmark).read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {benchmark}")
    config = json.loads(_find(dirs, "configs",
                              f"{entry['config']}.json").read_text())
    traffic = json.loads(_find(dirs, "traffic",
                               f"{entry['traffic']}.json").read_text())
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(entry["chips"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name, e2e)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name, e2e)],
                dirs=tuple(dirs))


def load_module(cell, kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the cell's directories
    (``cell`` a :class:`Cell` or the directories themselves), the first
    that holds one."""
    dirs = cell.dirs if isinstance(cell, Cell) else cell
    path = _find(dirs, kind, f"{name}.py")
    key = f"h100_bench_{kind}_{name.replace('.', '_')}"
    mod = sys.modules.get(key)
    if mod is not None and mod.__file__ == str(path):
        return mod  # loaded once a process (a reference's bind state)
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod
