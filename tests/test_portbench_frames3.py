"""The benchmark's three-pass 8x cell and its one-card two-pass 8x cell on
the CPU, at a tiny size in float32, one thread, with the CUDA-graph
primitive replaced by an eager stand-in (``port_bench/tests/tiny.py``):

- the plain reference's G3 equals the program's pass-3 refiner
  (``make_pass3``) on the same weights;
- the ``frames3`` driver, with the program underneath, reads gaps at
  rounding level and comes out correct, as does the frames driver with
  the 8x configuration on one card;
- a run whose pass 3 is skipped, takes its slices as xz planes, or stages
  its velocity channels in pass 2's order is not correct, nor is a
  two-pass 8x run whose pass 2 is altered, nor is the float8 control of
  either cell.
"""

from __future__ import annotations

import copy

import pytest
import torch

from port_bench import manifest, run
from port_bench.drivers import common, frames, frames3
from port_bench.reference import nets
from port_bench.tests import tiny

torch.set_num_threads(1)


@pytest.fixture
def stub_graphs(monkeypatch):
    from mpgan_torch.train import graphed
    monkeypatch.setattr(graphed, "Graph", tiny.EagerGraph)


def tiny_8x(name: str) -> dict:
    """The configuration ``name`` at base width 8."""
    cfg = copy.deepcopy(tiny.load("configs", name))
    cfg["dtype"] = "float32"
    for g in ("generator_pass1", "generator_pass2", "generator_pass3"):
        if g in cfg:
            cfg[g]["base_filters"] = 8
    return cfg


def context(config: str, traffic: str, seed: int = 12345) -> dict:
    """A 4³ → 32³ cell."""
    tr = dict(tiny.load("traffic", traffic))
    tr.update(lr_size=4, n_frames=3, check_frames=1, check_span=2,
              ref_block=4)
    return {**tiny.context("frames", seed=seed), "config": tiny_8x(config),
            "traffic": tr}


def verdict(cell: str, res: dict) -> bool:
    spec = manifest.cell(manifest.load(), cell)
    out = run.result(res, spec, run.load_limits(cell), False,
                     {"platform": "gpu", "kind": "test", "count": 1})
    return out["correct"]


@pytest.mark.parametrize("base", [8, 32])
def test_the_reference_g3_equals_the_program_refiner(base):
    cfg = copy.deepcopy(tiny.load("configs", "mpgan-8x-3pass"))
    cfg["generator_pass3"]["base_filters"] = base
    p3, d3 = frames3.pass3_weights(cfg, 7, "cpu")
    gen = frames3.port_pass3(d3, p3, torch.float32, None, "cpu")
    x = torch.rand((3, 6, 5, 4))
    with torch.no_grad():
        torch.testing.assert_close(nets.generator(p3, d3, x), gen(x),
                                   rtol=1e-5, atol=1e-6)


def test_g3_draws_its_own_stream_after_the_two_pass_weights():
    cfg = tiny_8x("mpgan-8x-3pass")
    p1, _, p2, _ = common.frame_weights(cfg, 99, "cpu")
    q1, _, q2, _ = common.frame_weights(tiny_8x("mpgan-8x"), 99, "cpu")
    for a, b in ((p1, q1), (p2, q2)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    p3, _ = frames3.pass3_weights(cfg, 99, "cpu")
    assert not torch.equal(p3["stem.weight"].flatten()[:64],
                           p1["stem.weight"].flatten()[:64])


@pytest.mark.parametrize("cell", ["mpgan-8x-3pass.frames",
                                  "mpgan-8x.frames"])
def test_a_sound_run_reads_rounding_gaps_and_is_correct(stub_graphs, cell):
    if cell == "mpgan-8x-3pass.frames":
        res = frames3.run(context("mpgan-8x-3pass", "frames3"))
        # per output pixel: the stem 4→8, four 3×3 convs 8→8, the head
        # 8→1; 32 yz slices of 32 × 32
        per_px = 2 * 9 * (4 * 8 + 4 * 8 * 8 + 8)
        assert res["record"]["pass3_flops_per_unit"] == 32 ** 3 * per_px
        assert res["record"]["pass3_bytes_per_unit"] == 32 ** 3 * 5 * 4
    else:
        res = frames.run(context("mpgan-8x", "frames"))
    assert res["attempted"] > 0 and res["checked"] >= 1
    assert res["numbers"]["frame_rel_rms"] < 1e-5
    assert verdict(cell, res)


def _skip_pass3(monkeypatch):
    from mpgan_torch.infer import assemble
    monkeypatch.setattr(assemble, "pass3_volume",
                        lambda gen3, vol, lr_vel, **k: vol)


def _pass3_as(perm: list[int], plane: tuple[int, ...]):
    """Pass 3 with its velocity channels in the order ``perm`` and its
    slices taken by ``plane``."""
    def fault(monkeypatch):
        from mpgan_torch.infer import assemble

        def pass3(gen3, vol, lr_vel, chunk=0, devices=None, programs=None):
            vol_in = assemble._with_velocity(vol, lr_vel, perm, gen3.dtype)
            out = assemble.apply_sliced(
                assemble._per_device(gen3, devices, programs),
                vol_in.permute(*plane), chunk, devices)
            return out.permute(*plane)
        monkeypatch.setattr(assemble, "pass3_volume", pass3)
    return fault


@pytest.mark.parametrize("fault", [
    _skip_pass3,
    _pass3_as([2, 1, 0], (1, 0, 2, 3)),        # xz planes
    _pass3_as([0, 2, 1], (2, 1, 0, 3)),        # pass 2's channel order
], ids=["skipped", "xz_planes", "pass2_velocity_order"])
def test_a_broken_pass3_is_not_correct(stub_graphs, monkeypatch, fault):
    fault(monkeypatch)
    res = frames3.run(context("mpgan-8x-3pass", "frames3"))
    assert not verdict("mpgan-8x-3pass.frames", res)


def test_the_sound_pass3_stand_in_is_correct(stub_graphs, monkeypatch):
    """The stand-in the faults are made from, with the program's own
    plane and channel order, passes: the faults fail for what they
    change."""
    _pass3_as([2, 1, 0], (2, 1, 0, 3))(monkeypatch)
    res = frames3.run(context("mpgan-8x-3pass", "frames3"))
    assert verdict("mpgan-8x-3pass.frames", res)


def test_an_altered_two_pass_8x_frame_is_not_correct(stub_graphs,
                                                     monkeypatch):
    from mpgan_torch.infer import assemble
    real = assemble.pass2_volume

    def altered(*a, **k):
        out = real(*a, **k).clone()
        out[:, : max(out.shape[1] // 8, 1)] += 0.25
        return out
    monkeypatch.setattr(assemble, "pass2_volume", altered)
    res = frames.run(context("mpgan-8x", "frames"))
    assert not verdict("mpgan-8x.frames", res)


@pytest.mark.parametrize("cell,config,traffic", [
    ("mpgan-8x-3pass.frames", "mpgan-8x-3pass", "frames3"),
    ("mpgan-8x.frames", "mpgan-8x", "frames")])
def test_the_control_fails_at_a_tiny_size(cell, config, traffic):
    """The control's numbers, dressed as a run of the cell, come out not
    correct through the harness's own comparison."""
    from port_bench import control, control3
    read = (control3.frames3_readings if traffic == "frames3"
            else control.frames_readings)
    ctx = context(config, traffic, seed=424242)
    numbers = read(ctx)["control"]
    res = {"numbers": numbers, "checked": len(frames.picks(ctx)),
           "failed": 0, "attempted": ctx["traffic"]["n_frames"],
           "memory_peak_bytes": 0, "setup_s": 0.0,
           "e2e": {"frame_vox_per_s": 1.0}}
    assert not verdict(cell, res)
    # the same run with gaps of 0 in their place passes
    assert verdict(cell, {**res, "numbers": {k: 0.0 for k in numbers}})
