"""The control comes out not correct: the plain reference put in the
program's place, its convolutions on float8 e4m3 operands (the precision
below the configurations' bfloat16), fails at least one of each cell's
numbers against its limit. On the CPU at a tiny size, and on the card at
the cells' own sizes on three seeds (``control.py`` is the same reading
for any seeds)."""

from __future__ import annotations

import pytest
import torch

from port_bench import control, manifest, run
from port_bench.tests import tiny

# cell → (traffic, reading)
CELLS = {"mpgan-4x.frames": ("frames", control.frames_readings),
         "mpgan-8x.frames-4card": ("frames-4card", control.frames_readings),
         "mpgan-4x.train": ("train", control.train_readings)}


def _fails(cell: str, numbers: dict) -> bool:
    limits = run.load_limits(cell)
    return any(numbers[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_fails_at_a_tiny_size(cell):
    kind, read = CELLS[cell]
    readings = read(tiny.context(kind, seed=424242))
    assert _fails(cell, readings["control"])


def test_the_half_batch_fails_at_a_tiny_size():
    readings = control.train_readings(tiny.context("train", seed=77))
    assert _fails("mpgan-4x.train", readings["half_batch"])


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.device_count()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mpgan-4x.frames", "mpgan-4x.train",
                                  "mpgan-8x.frames-4card"])
def test_the_control_fails_at_the_cells_size(cards, cell):
    spec = manifest.cell(manifest.load(), cell)
    n = spec["traffic"].get("devices", 1)
    if cards < n:
        pytest.skip(f"needs {n} cards")
    devices = [torch.device("cuda", i) for i in range(n)]
    for seed in (2718281828, 3141592653, 1414213562):
        ctx = {"seed": seed, "config": spec["config"],
               "traffic": spec["traffic"], "devices": devices,
               "trace": False}
        readings = CELLS[cell][1](ctx)
        assert _fails(cell, readings["control"]), seed
        if "half_batch" in readings:
            assert _fails(cell, readings["half_batch"]), seed
        torch.cuda.empty_cache()
