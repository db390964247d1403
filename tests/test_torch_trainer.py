"""The port's Trainer on the CPU at a small size (LR tile 4, base 8,
1 res block, disc base 8, B = 2, 2 sims × 4 frames of 8³ LR at 4×):
growth across a stage boundary with fade, strict migration with the Dense
head re-initialised, the warp call count per step, the checks the JAX
trainer makes, ``debugNans`` and ``profileDir``. One test needs a card
(marked ``cuda``; skips without one); this file imports no JAX, so on a
card's machine run it with
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_trainer.py -m cuda``.
"""

import json
import os

import numpy as np
import pytest
import torch

from mpgan_torch.data import pipeline as tpipeline
from mpgan_torch.models import growing
from mpgan_torch.ops import warp_kernel
from mpgan_torch.train import loop as tloop
from mpgan_torch.train import losses as tlosses
from mpgan_torch.train import recipe

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)


def _config(**train_kw):
    cfg = recipe.flagship_config("float32", batch=2, tile=4)
    cfg.model.n_base_filters = 8
    cfg.model.n_res_blocks = 1
    cfg.model.disc_base_filters = 8
    for k, v in train_kw.items():
        setattr(cfg.train, k, v)
    return cfg


def _tc(channels=4, **kw):
    ds = recipe.synthetic_dataset(size=8, up=4, channels=channels, seed=2)
    return tpipeline.TileCreator(ds, 4, density_threshold=0.0, device="cpu",
                                 **kw)


def test_growth_crosses_a_stage_boundary_with_fade():
    cfg = _config(use_growing=True, alpha_iters=2, stable_iters=2)
    tr = tloop.Trainer(cfg, _tc(), device="cpu")
    out = tr.fit(7, log_every=1)
    stages = [m["stage"] for m in tr.metrics_log]
    alphas = [m["alpha"] for m in tr.metrics_log if m["stage"] == 2]
    assert stages == [1, 1, 1, 1, 2, 2, 2]
    assert alphas == [0.0, 0.5, 1.0]
    assert tr.rt.step == 7 and tr.rt.gen.factors == ((2, 2), (2, 2))
    assert all(np.isfinite(out[k]) for k in ("d_loss", "dt_loss", "g_loss",
                                             "g_adv", "l1", "feat", "g_t",
                                             "psnr"))
    assert out["steps_per_sec"] > 0 and out["steps_per_dispatch"] == 1


def test_stage_migration_is_strict_and_reinitialises_out():
    cfg = _config(use_growing=True, alpha_iters=2, stable_iters=2)
    tr = tloop.Trainer(cfg, _tc(), device="cpu")
    tr.fit(3, log_every=3)
    old = tr.rt
    new = tr._init_stage(2, old)
    assert new.step == old.step == 3
    for net in ("gen", "ds", "dt"):
        o, n = getattr(old, net).state_dict(), getattr(new, net).state_dict()
        assert growing.subtree_check(o, n) and set(n) > set(o), net
        for k, v in o.items():
            if k.startswith("out.") and net != "gen":
                continue
            assert torch.equal(n[k], v), (net, k)
        if net != "gen":
            # same width (t·t·base), fresh values: flax re-initialises it
            assert n["out.weight"].shape == o["out.weight"].shape
            assert not torch.equal(n["out.weight"], o["out.weight"])
            assert not n["out.bias"].any()
    for k, v in old.ema.items():
        assert torch.equal(new.ema[k], v), k
        assert new.ema[k] is not v
    assert set(new.ema) == {k for k, _ in new.gen.named_parameters()}
    with pytest.raises(KeyError):
        growing.migrate_params(new.gen.state_dict(), old.gen.state_dict())


@pytest.mark.parametrize("backend,fn,per_call",
                         [("auto", "advect_2d", 1),
                          ("pallas", "align_triplet_fast", 2)])
def test_six_warps_per_step(monkeypatch, backend, fn, per_call):
    """6 fields warped per step: 4 in the D-run (fake and real triplets), 2
    in the G-run — one per call on the plain path (auto on the CPU), two per
    call on the clamped one, which warps a triplet's both neighbours in one
    call (one kernel launch on a card: 3 forward launches per step, and 1
    backward for the G-run). The CUDA kernels' counters stay at 0 on the
    CPU."""
    calls = [0]
    orig = getattr(tlosses, fn)

    def counted(*a, **k):
        calls[0] += per_call
        return orig(*a, **k)

    monkeypatch.setattr(tlosses, fn, counted)
    cfg = _config()
    cfg.loss.warp_backend = backend
    tr = tloop.Trainer(cfg, _tc(), device="cpu")
    n0 = (warp_kernel.launches, warp_kernel.bwd_launches)
    tr.fit(3, log_every=3)
    assert calls[0] == 18
    assert (warp_kernel.launches, warp_kernel.bwd_launches) == n0
    step = tr.rt.step_stable
    assert (step.warps_per_step, step.warp_bwds_per_step) == (3, 1)


def test_temporal_d_needs_velocities():
    tc = _tc(channels=1)
    with pytest.raises(ValueError, match="useTempoD"):
        tloop.Trainer(_config(), tc, device="cpu").runtime()
    out = tloop.Trainer(_config(use_temporal_disc=False), tc,
                        device="cpu").fit(2, log_every=2)
    assert out["dt_loss"] == 0.0 and out["g_t"] == 0.0


def test_trainer_checks_device_and_pass():
    with pytest.raises(ValueError, match="pass 4"):
        tloop.Trainer(_config(), _tc(), device="cpu", pass_no=4)
    # no card: CUDA is refused; a card: the CPU tile creator is
    with pytest.raises((RuntimeError, ValueError)):
        tloop.Trainer(_config(), _tc(), device="cuda")


def test_training_is_reproducible_and_moves_the_ema():
    """Equal seeds give equal runs; the EMA trails G."""
    runs = []
    for _ in range(2):
        tr = tloop.Trainer(_config(), _tc(), device="cpu")
        runs.append((tr.fit(3, log_every=1), tr))
    (a, tra), (b, trb) = runs
    for k in ("d_loss", "dt_loss", "g_loss", "l1", "psnr"):
        assert a[k] == b[k], k
    assert len(tra.metrics_log) == 3
    gap = max(float((tra.rt.ema[k] - p.detach()).abs().max())
              for k, p in tra.rt.gen.named_parameters())
    assert 0 < gap < 0.1


def test_debug_nans_names_the_first_non_finite_update():
    tr = tloop.Trainer(_config(debug_nans=True), _tc(), device="cpu")
    tr.fit(2, log_every=1)                      # finite steps go through
    with torch.no_grad():
        next(tr.rt.gen.parameters()).fill_(float("nan"))
    with pytest.raises(FloatingPointError,
                       match=r"debugNans: .* in the Ds update at step 2"):
        tr.fit(3, start_it=2)


def test_profile_dir_writes_a_trace(tmp_path):
    out = tmp_path / "prof"
    tr = tloop.Trainer(_config(profile_dir=str(out)), _tc(), device="cpu")
    tr.fit(1)
    traces = [f for f in os.listdir(out) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(out / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)


def test_fake_triplet_equals_separate_generator_calls():
    tc = _tc()
    tr = tloop.Trainer(_config(), tc, device="cpu")
    gen = tr.runtime().gen
    b = tc.sample_pass1(torch.Generator().manual_seed(0), 2, temporal=True)
    with torch.no_grad():
        got = tloop.fake_triplet(gen, b, 1, 2)
        want = [gen(b["lr_prev"]), gen(b["lr"]), gen(b["lr_next"])]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_cuda_step_launches_the_warp_kernel_six_times():
    """Two steps on a card: 3 forward launches per step (one per triplet)
    and 1 backward (the G-run) — the six warps of a step in three fused
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ds = recipe.synthetic_dataset(size=8, up=4, seed=2)
    tc = tpipeline.TileCreator(ds, 4, density_threshold=0.0, device="cuda")
    tr = tloop.Trainer(_config(), tc, device="cuda")
    n0, nb0 = warp_kernel.launches, warp_kernel.bwd_launches
    out = tr.fit(2, log_every=2)
    assert warp_kernel.launches - n0 == 6
    assert warp_kernel.bwd_launches - nb0 == 2
    assert np.isfinite(out["g_loss"]) and np.isfinite(out["dt_loss"])
