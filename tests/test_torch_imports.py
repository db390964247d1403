"""The port imports no JAX: a static (AST) scan of every module of
``mpgan_torch/`` and of ``chip_smoke.py``.

Static because the interpreter that runs the tests may import jax at start
(see tests/conftest.py), so ``sys.modules`` cannot tell who imported it.
"""

import ast
import os

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "mpgan_tpu"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "mpgan_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_module_imports_no_jax(path):
    assert os.path.exists(path), path
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_scan_sees_every_import_form(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom flax import linen\n"
                 "import importlib\nimportlib.import_module('orbax.x')\n"
                 "def f():\n    from mpgan_tpu.ops import warp\n")
    assert {m for m, _ in _imported_roots(str(p))} >= {
        "jax", "flax", "orbax", "mpgan_tpu"}
