"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's); the
plain reference imports nothing of the program."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from rtbench import main, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "cg_raytracer_tpu"}


def sources(*parts):
    root = os.path.join(spec.BENCH_DIR, *parts)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p,
                                                                                  spec.BENCH_DIR))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert not top_level_imports(path) & {"cg_raytracer_tpu_torch", "rtbench"}, path


def test_forbidden_modules_by_whole_top_level_name():
    mods = ["cg_raytracer_tpu_torch", "cg_raytracer_tpu_torch.ops.soft", "jaxtyping", "numpy"]
    assert main.forbidden_modules(mods) == []
    assert main.forbidden_modules(mods + ["cg_raytracer_tpu.ops"]) == ["cg_raytracer_tpu"]
    assert main.forbidden_modules(mods + ["jax._src.core", "flax"]) == ["flax", "jax"]


def test_what_a_run_loads_holds_none():
    """Import what ``run.py`` loads, the port and every metric reader, and
    list the forbidden modules that appeared (a fresh interpreter)."""
    code = (
        "import sys; before = set(sys.modules)\n"
        "sys.path[:0] = [%r, %r]\n"
        "from rtbench import main, spec, fit, orbit, tracing, traffic, yard\n"
        "import cg_raytracer_tpu_torch\n"
        "from cg_raytracer_tpu_torch.optim import inverse\n"
        "from cg_raytracer_tpu_torch.utils import graphs\n"
        "from reference import render, train, philox, blur\n"
        "bench = spec.load()\n"
        "for w in bench['workloads']:\n"
        "    c = spec.cell(w['name'], bench)\n"
        "    c.geometry()\n"
        "    [c.reader(m['name']) for m in c.per_layer]\n"
        "new = set(sys.modules) - before\n"
        "print(sorted({m.split('.')[0] for m in new} & %r))\n"
    ) % (spec.BENCH_DIR, spec.ROOT, FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
