"""Each cell's run, driven past the look for a card with the timed path
broken underneath, comes out not correct: one test per fault the cell can
have. A tiny size on the CPU (the CUDA-graph primitive replaced by an eager
stand-in), float32, each cell's own limits."""

from __future__ import annotations

import pytest
import torch

from port_bench import manifest, run
from port_bench.drivers import frames, train
from port_bench.tests import tiny


@pytest.fixture
def stub_graphs(monkeypatch):
    from mpgan_torch.train import graphed
    monkeypatch.setattr(graphed, "Graph", tiny.EagerGraph)


def verdict(cell: str, res: dict) -> bool:
    spec = manifest.cell(manifest.load(), cell)
    out = run.result(res, spec, run.load_limits(cell), False,
                     {"platform": "gpu", "kind": "test", "count": 1})
    return out["correct"]


def _alter(monkeypatch):
    """A block of the output slices altered where pass 2 produces them."""
    from mpgan_torch.infer import assemble
    real = assemble.pass2_volume

    def altered(*a, **k):
        out = real(*a, **k).clone()
        out[:, : max(out.shape[1] // 8, 1)] += 0.25
        return out
    monkeypatch.setattr(assemble, "pass2_volume", altered)


def _half_slices(monkeypatch):
    """Each pass computes the first half of its slices; the rest are 0."""
    from mpgan_torch.infer import assemble
    real = assemble.apply_sliced

    def half(fn, slices, *a, **k):
        n = slices.shape[0]
        out = real(fn, slices[: n // 2], *a, **k)
        return torch.cat([out, out.new_zeros((n - n // 2, *out.shape[1:]))])
    monkeypatch.setattr(assemble, "apply_sliced", half)


def _no_exchange(monkeypatch):
    """The last card's share never reaches the first card."""
    from mpgan_torch.infer import assemble
    real = assemble._split_apply

    def dropped(share_fn, x, devices):
        out = real(share_fn, x, devices)
        keep = sum(p.shape[0] for p in torch.tensor_split(
            x, len(devices))[:-1])
        out[keep:] = 0
        return out
    monkeypatch.setattr(assemble, "_split_apply", dropped)


def test_a_sound_frames_run_is_correct(stub_graphs):
    assert verdict("mpgan-4x.frames", frames.run(tiny.context("frames")))


@pytest.mark.parametrize("fault", [_alter, _half_slices])
def test_frames_faults_are_not_correct(stub_graphs, monkeypatch, fault):
    fault(monkeypatch)
    assert not verdict("mpgan-4x.frames", frames.run(tiny.context("frames")))


@pytest.mark.parametrize("fault", [_alter, _half_slices, _no_exchange])
def test_four_card_faults_are_not_correct(stub_graphs, monkeypatch, fault):
    fault(monkeypatch)
    devices = [torch.device("cpu", i) for i in range(4)]
    res = frames.run(tiny.context("frames-4card", devices=devices))
    assert not verdict("mpgan-8x.frames-4card", res)


def _unchanged(monkeypatch):
    """Every update computes its gradients and leaves the state as it
    was."""
    from mpgan_torch.train import loop

    def no_step(opt, params, loss, nan_check=None, share=None):
        for p in params:
            p.grad = None
        loss.backward(inputs=params)
    monkeypatch.setattr(loop, "_update", no_step)


def _half_batch(monkeypatch):
    """Every batch keeps its first half of the rows: each loss is the mean
    over the rest."""
    from mpgan_torch.train import loop
    real = loop.make_sampler

    def half(*a, **k):
        draw = real(*a, **k)
        return lambda rng: {key: v[: v.shape[0] // 2]
                            for key, v in draw(rng).items()}
    monkeypatch.setattr(loop, "make_sampler", half)


def _altered_loss(monkeypatch):
    """The generator's L1 term altered where it is produced."""
    from mpgan_torch.train import losses
    real = losses.l1_loss
    monkeypatch.setattr(losses, "l1_loss", lambda a, b: real(a, b) * 1.5)


def test_a_sound_train_run_is_correct():
    assert verdict("mpgan-4x.train", train.run(tiny.context("train")))


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_loss])
def test_train_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not verdict("mpgan-4x.train", train.run(tiny.context("train")))
