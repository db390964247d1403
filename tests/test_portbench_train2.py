"""The benchmark's pass-2 train cell (``mpgan-8x-pass2.train``, kind
``train2``) on the CPU, in float32, one thread:

- the plain reference's xz-plane batch equals the program's
  ``assemble_pass2`` on the same draws (LR 8³, up 4, tile 4), and its
  velocity equals ``loop.vel_hr`` for pass 2 at every growth stage;
- a tiny run of the cell through the driver (the trainer's captured
  programs stood in for by ``tests/_torch_graph_stub.py``) reads gaps at
  rounding level and comes out correct;
- a run with the program broken is not correct: the velocity channels in
  pass 1's (xy) order, Ds conditioned isotropically, G2 fed ``hrz`` in
  place of the intermediate volumes, lazy R1 skipped at its steps, the
  velocity's w left in LR cells; nor is
  the float8 control (pass 1's isotropic velocity units are no fault at
  the last stage, where they equal pass 2's);
- the step's convolution operations against a hand count at a tiny width,
  and 81.24 GFLOP at the configuration's widths.

The tiny cell is the configuration at base width 8, tiles of 4 LR pixels,
batch 4, 8³ LR volumes (64³ HR), with the recipe's lazy-R1 interval cut
to 2 and its output interval to 8 (so that the replayed R1 step is step 4
and the window ends at step 8), R1's γ raised to 100 (at base width 8 and
γ = 10 the R1 term moves Ds's gradient about as much as bf16 rounding
does: skipping it read 2.3 of the cell's units), and the program's
clamped warp on the CPU
(``warpBackend pallas``: on a card ``auto`` takes it; on the CPU ``auto``
takes the unclamped warp, which the reference, following the card, does
not model).
"""

from __future__ import annotations

import copy
import math
import time

import pytest
import torch

from _torch_graph_stub import install
from mpgan_torch.data import pipeline
from mpgan_torch.models import discriminator as D
from mpgan_torch.train import loop, recipe
from port_bench import manifest, run
from port_bench.drivers import train2
from port_bench.reference import train2 as ref_train2
from port_bench.tests import tiny

torch.set_num_threads(1)

CELL = "mpgan-8x-pass2.train"


@pytest.fixture
def tiny_cell(monkeypatch):
    """Graphs stood in for; the recipe's intervals cut and the clamped warp
    taken on the CPU."""
    install(monkeypatch)
    real = recipe.flagship_config

    def cut(*a, **k):
        cfg = real(*a, **k)
        cfg.loss.r1_gamma, cfg.loss.r1_interval = 100.0, 2
        cfg.train.output_interval = 8
        cfg.loss.warp_backend = "pallas"
        return cfg
    monkeypatch.setattr(recipe, "flagship_config", cut)


def context(seed: int = 12345) -> dict:
    cfg = copy.deepcopy(tiny.load("configs", "mpgan-8x-pass2"))
    cfg["dtype"] = "float32"
    for g in ("generator_pass1", "generator_pass2"):
        cfg[g]["base_filters"] = 8
    for d in ("spatial_disc", "temporal_disc"):
        cfg[d].update(in_hw=[32, 32], base_filters=8)
    cfg["recipe"].update(batch=4, tile_lr=4, r1_gamma=100.0, r1_interval=2,
                         output_interval=8)
    tr = dict(tiny.load("traffic", "train2"))
    tr.update(n_sims=1, n_frames=4, lr_size=8, replay_step=4)
    return {"seed": seed, "seconds": 0.05, "trace": False, "config": cfg,
            "traffic": tr, "cell": {}, "devices": [torch.device("cpu")],
            "t0": time.perf_counter()}


def verdict(res: dict) -> bool:
    spec = manifest.cell(manifest.load(), CELL)
    out = run.result(res, spec, run.load_limits(CELL), False,
                     {"platform": "gpu", "kind": "test", "count": 1})
    return out["correct"]


def test_the_reference_batch_equals_assemble_pass2():
    ds = recipe.synthetic_dataset(n_sims=1, n_frames=4, size=8, up=4,
                                  seed=3)
    interm = torch.rand((4, 8, 32, 32, 1),
                        generator=torch.Generator().manual_seed(1))
    tc = pipeline.TileCreator(ds, 4, density_threshold=0.0, device="cpu",
                              interm=interm)
    rec = dict(batch=3, tile_lr=4, up_res=4, scale_min=0.85,
               scale_max=1.15, density_threshold=0.0, n_frames=4)
    data = ref_train2.pass2_data(torch.from_numpy(ds.lr), interm,
                                 torch.from_numpy(ds.hr), rec)
    gen = torch.Generator().manual_seed(5)
    draws = pipeline.draw(gen, 3, tc.dense_idx_t, tc.st)
    got = pipeline.assemble_pass2(tc.lr, tc.interm, tc.hr, tc.dense_idx_t,
                                  draws, "xz", True, tc.st)
    want = ref_train2.sample(data, gen.manual_seed(5), rec)
    assert sorted(got) == sorted(want)
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_the_reference_velocity_is_pass_2_s(stage):
    """Resized by (s_in, 1); w in units of ``up_res`` (its input grid is
    HR already), h of s_in. At the last stage (s_in = up_res) the two
    units coincide: pass 1's isotropic units (s_in on both axes) equal
    pass 2's there, and differ below it."""
    lr_vel = torch.randn((3, 4, 32, 3),
                         generator=torch.Generator().manual_seed(stage))
    got = loop.vel_hr({"lr_vel": lr_vel}, 2, stage, 8)
    want = ref_train2.velocity(lr_vel, 2 ** stage, 8)
    assert got.shape == (3, 4 * 2 ** stage, 32, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    isotropic = ref_train2.velocity(lr_vel, 2 ** stage, 2 ** stage)
    assert torch.equal(isotropic, want) == (stage == 3)


def test_a_sound_run_reads_rounding_gaps_and_is_correct(tiny_cell):
    res = train2.run(context())
    assert res["attempted"] > 0 and res["checked"] == 4
    n = res["numbers"]
    assert n["train_loss_gap"] < 1e-4
    assert n["train_grad_err_ratio"] < 0.05
    assert n["train_change_gap_median"] < 1e-4
    assert n["train_warp_gap"] < 1e-5
    assert n["train_net_err_ratio_first"] < 0.05
    assert any(w.startswith("step 4") for w in res["where"].values())
    assert verdict(res)


def _pass1_velocity_order(monkeypatch):
    """The xz plane's velocity channels in the xy plane's order: (vx, vy,
    vz) for (v_w, v_h, v_out), so G2 and the warp read vy as v_h."""
    monkeypatch.setitem(pipeline._VEL_PERM, "xz", (0, 1, 2, 3))


def _ds_conditioned_isotropically(monkeypatch):
    """G2's input resized by (s_in, s_in), as pass 1's, and cut to the HR
    patch's width."""
    def condition(lr, hr, fh, fw):
        up = D.upsample_any(lr, fh, fh)[:, :, :hr.shape[2]]
        return torch.cat([up, hr.to(lr.dtype)], dim=-1)
    monkeypatch.setattr(D, "condition_ds_input", condition)


def _hrz_for_interm(monkeypatch):
    monkeypatch.setattr(pipeline.TileCreator, "interm",
                        property(lambda self: self.hrz))


def _r1_skipped(monkeypatch):
    monkeypatch.setattr(loop.TrainStep, "r1_due", lambda self: False)


def _w_velocity_in_lr_cells(monkeypatch):
    """The velocity's w left in LR cells: the warp moves the triplet's
    outer frames ``up_res`` times too little along x."""
    real = loop.vel_hr

    def vel_hr(batch, pass_no, stage, up_res):
        v = real(batch, pass_no, stage, up_res)
        return torch.cat([v[..., 0:1] / up_res, v[..., 1:2]], dim=-1)
    monkeypatch.setattr(loop, "vel_hr", vel_hr)


@pytest.mark.parametrize("fault", [
    _pass1_velocity_order, _ds_conditioned_isotropically, _hrz_for_interm,
    _r1_skipped, _w_velocity_in_lr_cells],
    ids=["pass1_velocity_order", "ds_isotropic", "hrz_for_interm",
         "r1_skipped", "w_velocity_in_lr_cells"])
def test_a_broken_pass2_step_is_not_correct(tiny_cell, monkeypatch, fault):
    fault(monkeypatch)
    assert not verdict(train2.run(context()))


def test_the_control_fails_the_limits():
    """The control's numbers, dressed as a run of the cell, come out not
    correct through the harness's comparison; gaps of 0 in their place
    pass."""
    from port_bench import control_train2
    ctx = context(seed=424242)
    numbers = control_train2.readings(ctx)["control"]
    numbers.pop("where")
    res = {"numbers": numbers, "checked": 4, "failed": 0, "attempted": 8,
           "memory_peak_bytes": 0, "setup_s": 0.0,
           "e2e": {"train_samples_per_s": 1.0}}
    assert not verdict(res)
    assert verdict({**res, "numbers": {k: 0.0 for k in numbers}})


def test_step_flops_by_hand_and_at_the_configuration():
    """One (2, 1) stage of base 8 from 2 × 4 input pixels: the stem (4→8)
    on 8 input pixels, two 3×3 convs 8→8 and the head 8→1 on 16 output
    pixels; each discriminator's from-input conv on 4 × 4 pixels, its down
    and conv layers 8→8 on 2 × 4, the dense head from 2·4·8."""
    g = dict(in_channels=4, factors=[(2, 1)], base_filters=8, min_filters=8,
             n_res_blocks=1, out_channels=1)
    d = dict(in_hw=[4, 4], factors=[(2, 1)], base_filters=8, min_filters=8,
             max_filters=256)
    cfg = {"generator": g, "spatial_disc": {**d, "in_channels": 5},
           "temporal_disc": {**d, "in_channels": 3},
           "recipe": {"batch": 2, "tile_lr": 2, "up_res": 2,
                      "r1_interval": 4}}
    gf = 2 * 9 * 4 * 8 * 8 + (2 * 2 * 9 * 8 * 8 + 2 * 9 * 8) * 16
    dsf = 2 * 9 * 5 * 8 * 16 + 2 * 2 * 9 * 8 * 8 * 8 + 2 * 8 * 8
    dtf = 2 * 9 * 3 * 8 * 16 + 2 * 2 * 9 * 8 * 8 * 8 + 2 * 8 * 8
    b = 2
    want = {"d_run": 3 * b * gf + 6 * b * (dsf + dtf),
            "g_run": 9 * b * gf + 4 * b * dsf + 3 * b * dtf,
            "r1": 9 * b * (dsf + dtf) / 4}
    got = train2.step_flops(cfg)
    assert got == {**want, "step": sum(want.values())}
    full = train2.step_flops(train2.descriptions(
        tiny.load("configs", "mpgan-8x-pass2")))
    assert [round(full[k] / 1e9, 2) for k in ("step", "d_run", "g_run",
                                             "r1")] \
        == [81.24, 32.94, 46.26, 2.04]
    assert math.isclose(full["step"], 81.23973632e9, rel_tol=1e-12)


def test_the_kink_terms_sum_to_the_hinge_gradient_and_widen_the_unit():
    """Every hinge term of the first step's D updates taken as a kink term
    (``kink_delta`` past every margin): the terms of positive margin sum
    to the discriminator's gradient (R1 skipped, so that the hinge is the
    whole loss); none taken under a ``kink_delta`` of 0. The widened
    unit's leaf gap from the reference is the unit's own plus the terms'
    norms, along the unit's own difference."""
    ctx = context(seed=777)
    state = train2.inputs(ctx)
    state["interm"] = train2.intermediates(ctx, state)
    p = state["params"]
    state["stretches"] = [{"it": 0, "losses": [None],
                           "before": {**p, "ema": p["gen"]}}]
    ref, = train2.reference(ctx, state, fault="no_r1", kink_delta=1e9)
    none, = train2.reference(ctx, state, fault="no_r1", kink_delta=0.0)
    b = ctx["config"]["recipe"]["batch"]
    # G's gradient moved by each term counted the other way, every term
    # of both discriminators in turn
    assert not none["kinks_gen"] and len(ref["kinks_gen"]) == 4 * b
    assert all(mv.keys() == ref["grads0"]["gen"].keys()
               for mv in ref["kinks_gen"])
    assert any(float(mv["head_2.weight"].abs().max()) > 0
               for mv in ref["kinks_gen"])
    for name in ("ds", "dt"):
        m = ref["margins"][name]
        assert m.shape == (2 * b,) and not none["kinks"][name]
        terms = ref["kinks"][name]
        assert [t[0] for t in terms] == list(range(2 * b))
        assert all(math.isclose(t[1], float(m[t[0]])) for t in terms)
        for k, g in ref["grads0"][name].items():
            torch.testing.assert_close(
                sum(t[2][k] for t in terms if t[1] > 0), g,
                rtol=1e-4, atol=1e-6)
        unit = {k: g + 1e-3 * torch.ones_like(g)
                for k, g in ref["grads0"][name].items()}
        moves = [t[2] for t in terms[:2]]
        wide = train2.widened(unit, ref["grads0"][name], moves)
        for k, g in ref["grads0"][name].items():
            gap = float((wide[k] - g).double().norm())
            want = (float((unit[k] - g).double().norm())
                    + sum(float(mv[k].double().norm()) for mv in moves))
            assert math.isclose(gap, want, rel_tol=1e-5)
            assert float(torch.nn.functional.cosine_similarity(
                (wide[k] - g).flatten(), (unit[k] - g).flatten(),
                dim=0)) > 0.9999
        same = train2.widened(unit, ref["grads0"][name], [])
        for k, g in unit.items():
            torch.testing.assert_close(same[k], g, rtol=1e-6, atol=1e-9)
