"""The port imports no JAX: a static (AST) scan of every module of
``mpgan_torch/`` and of ``chip_smoke.py``. And the supervising parents of
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
