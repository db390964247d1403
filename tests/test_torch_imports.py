"""The port imports no JAX: a static (AST) scan of every module of
``mpgan_torch/`` and of ``chip_smoke.py``. The same scan holds the
program layer's imports to point down: no solver module imports
``mpgan_torch.infer``, and ``mpgan_torch/train/graphed.py`` imports neither
``mpgan_torch.infer`` nor a kernel module of ``mpgan_torch.ops``. And the
supervising parents of
``python -m mpgan_torch.cli ... retryOnError N`` and ``python -m
mpgan_torch.datagen ... retryOnError N`` never touch CUDA.

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


def _imported(path):
    """(module name, line) of each import in ``path``; ``from m import
    a`` gives ``m`` and ``m.a``."""
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module, node.lineno
            for a in node.names:
                yield f"{node.module}.{a.name}", node.lineno
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value), node.lineno


def _imported_roots(path):
    for name, line in _imported(path):
        yield name.split(".")[0], line


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_module_imports_no_jax(path):
    assert os.path.exists(path), path
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


# (files under a path of the repo, packages they may not import)
LAYERS = [("mpgan_torch/solver", ("mpgan_torch.infer",)),
          ("mpgan_torch/train/graphed.py",
           ("mpgan_torch.infer", "mpgan_torch.ops"))]


@pytest.mark.parametrize("where,below", LAYERS, ids=[w for w, _ in LAYERS])
def test_program_layer_imports_point_down(where, below):
    path = os.path.join(ROOT, where)
    files = [path] if path.endswith(".py") else [
        os.path.join(path, n) for n in sorted(os.listdir(path))
        if n.endswith(".py")]
    bad = [(os.path.relpath(f, ROOT), m, ln) for f in files
           for m, ln in _imported(f)
           if any(m == b or m.startswith(b + ".") for b in below)]
    assert files and not bad, bad


def test_scan_sees_every_import_form(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom flax import linen\n"
                 "import importlib\nimportlib.import_module('orbax.x')\n"
                 "def f():\n    from mpgan_tpu.ops import warp\n")
    assert {m for m, _ in _imported_roots(str(p))} >= {
        "jax", "flax", "orbax", "mpgan_tpu"}


def test_supervisor_gate_initialises_no_cuda(monkeypatch, tmp_path):
    """Importing the supervisor and running the CLI's gate up to its child
    (replaced by a stub) calls neither CUDA's lazy initialisation nor its
    device query, and leaves ``torch.cuda.is_initialized()`` false."""
    import torch

    from mpgan_torch import cli
    from mpgan_torch.utils import supervise

    touched = []
    monkeypatch.setattr(torch.cuda, "_lazy_init",
                        lambda: touched.append("_lazy_init"))
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: touched.append("is_available") or False)
    children = []
    monkeypatch.setattr(supervise, "run_child",
                        lambda cmd, env: children.append(cmd) or 0)
    monkeypatch.delenv("MPGAN_TRAIN_CHILD", raising=False)
    with pytest.raises(SystemExit) as e:
        cli.main(["out", "0", "testPath", str(tmp_path), "retryOnError", "1",
                  "trainingIters", "4"])
    assert e.value.code == 0
    assert children and children[0][1:3] == ["-m", "mpgan_torch.cli"]
    assert touched == [] and not torch.cuda.is_initialized()


def test_datagen_supervisor_initialises_no_cuda(monkeypatch, tmp_path):
    """``python -m mpgan_torch.datagen ... retryOnError 1``: the parent
    relaunches itself as a child (stubbed here) without touching CUDA, and
    a restart adds ``skipExisting 1``."""
    import torch

    from mpgan_torch import datagen
    from mpgan_torch.utils import supervise

    touched = []
    monkeypatch.setattr(torch.cuda, "_lazy_init",
                        lambda: touched.append("_lazy_init"))
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: touched.append("is_available") or False)
    children = []
    monkeypatch.setattr(supervise, "run_child",
                        lambda cmd, env: children.append(cmd) or 2 - len(
                            children))            # rc 1, then rc 0
    monkeypatch.setenv("MPGAN_RETRY_DELAY_S", "0")
    monkeypatch.delenv("MPGAN_DATAGEN_CHILD", raising=False)
    with pytest.raises(SystemExit) as e:
        datagen.main(["basePath", str(tmp_path), "retryOnError", "1"])
    assert e.value.code == 0 and len(children) == 2
    assert children[0][1:3] == ["-m", "mpgan_torch.datagen"]
    assert "skipExisting" not in children[0]
    assert children[1][-2:] == ["skipExisting", "1"]
    assert touched == [] and not torch.cuda.is_initialized()
