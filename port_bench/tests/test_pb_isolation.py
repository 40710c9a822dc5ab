"""No module of the benchmark imports JAX or the JAX package (each import's
top-level name compared whole), and the reference imports nothing of the
program."""

import ast
import os
import subprocess
import sys

from port_bench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "add_gym_tpu"}
HERE = spec.HERE


def _modules(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax():
    bad = {p: sorted(set(_imports(p)) & FORBIDDEN) for p in _modules(HERE)}
    assert not {p: v for p, v in bad.items() if v}


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    bad = {p: sorted(set(_imports(p)) & (FORBIDDEN | {"add_gym_torch"})) for p in _modules(ref)}
    assert not {p: v for p, v in bad.items() if v}
    assert len(list(_modules(ref))) >= 20


def test_harness_loads_no_jax():
    """Importing every module of the harness, the program's builder with
    it, leaves no JAX in ``sys.modules`` (whole top-level names)."""
    mods = sorted({os.path.relpath(p, spec.ROOT)[:-3].replace(os.sep, ".")
                   for p in _modules(HERE) if "tests" not in p and not p.endswith("__init__.py")})
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "import add_gym_torch.builder\n"
            + "from port_bench.run import loaded_forbidden\nprint(loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    """Without a CUDA device the run exits non-zero and prints nothing."""
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "g1_add.cloud",
                          "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
