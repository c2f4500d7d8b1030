"""What the benchmark runs imports neither JAX nor the JAX package, and
the reference imports nothing of the program either, compared by whole
top-level module name (``bibim_tpu_torch`` begins with ``bibim_tpu``)."""

import ast
import subprocess
import sys

import pytest

from h100_bench.tests.conftest import BENCH, ROOT

JAX = {"jax", "jaxlib", "flax", "bibim_tpu"}


def module_file(name: str):
    """The repository file of module ``name``, if it is one."""
    parts = name.split(".")
    base = ROOT.joinpath(*parts)
    for p in (base.with_suffix(".py"), base / "__init__.py"):
        if p.is_file():
            return p
    return None


def imports_of(path) -> set:
    """Every module name ``path`` imports (relative imports resolved)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
            out |= {f"{node.module}.{a.name}" for a in node.names}
    return out


def closure(files) -> set:
    """Top-level names of every module the files import, following the
    repository's own modules."""
    seen, todo, tops = set(), list(files), set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in imports_of(path):
            tops.add(name.split(".")[0])
            f = module_file(name)
            if f is not None:
                todo.append(f)
    return tops


def bench_files(*parts):
    base = BENCH.joinpath(*parts)
    return [p for p in base.rglob("*.py") if "tests" not in p.parts]


def test_run_imports_no_jax():
    tops = closure([BENCH / "run.py", *bench_files()])
    assert "bibim_tpu_torch" in tops
    assert not tops & JAX, tops & JAX


def test_reference_imports_no_program():
    tops = closure(bench_files("reference"))
    assert not tops & (JAX | {"bibim_tpu_torch"}), tops


def test_reference_loads_no_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import h100_bench.reference.render; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    loaded = set(eval(out))
    assert not loaded & (JAX | {"bibim_tpu_torch"})


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (BENCH / "reference").glob("*.py")
    if p.stem not in ("__init__", "render")))
def test_each_reference_loads_no_program(name):
    """Every other reference module, loaded as the harness loads it
    (``cells.load_module``)."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from h100_bench import cells; "
            "mod = cells.load_module([%r], 'reference', %r); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % (str(ROOT), str(BENCH), name))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    loaded = set(eval(out))
    assert not loaded & (JAX | {"bibim_tpu_torch"})
