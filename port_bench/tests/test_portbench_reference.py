"""The plain reference against the program at a tiny size on the CPU, in
float32, where the two compute the same sums: each cell's driver, run with
the program underneath (the CUDA-graph primitive replaced by an eager
stand-in on the CPU), reads gaps at rounding level; and the reference's
networks equal the program's modules on the same weights."""

from __future__ import annotations

import pytest
import torch

from port_bench.drivers import common, frames, train
from port_bench.reference import nets
from port_bench.tests import tiny


@pytest.fixture
def stub_graphs(monkeypatch):
    from mpgan_torch.train import graphed
    monkeypatch.setattr(graphed, "Graph", tiny.EagerGraph)


def test_generators_equal_the_program_modules():
    cfg = tiny.tiny_config()
    p1, d1, p2, d2 = common.frame_weights(cfg, 7, "cpu")
    for p, d, pass_no, shape in ((p1, d1, 1, (3, 6, 5, 4)),
                                 (p2, d2, 2, (3, 6, 20, 4))):
        gen = common.port_generator(d, pass_no, p, torch.float32, None,
                                    "cpu")
        x = torch.rand(shape)
        with torch.no_grad():
            torch.testing.assert_close(nets.generator(p, d, x), gen(x),
                                       rtol=1e-5, atol=1e-6)


def test_discriminators_equal_the_program_modules():
    from mpgan_torch.models import discriminator as D
    cfg = train.descriptions(tiny.tiny_config())
    gen = torch.Generator().manual_seed(3)
    for key, make in (("spatial_disc", lambda: D.make_spatial(
            2, 5, (16, 16), base_filters=8)),
            ("temporal_disc", lambda: D.make_temporal(
                2, (16, 16), base_filters=8))):
        d = cfg[key]
        p = nets.make_weights(nets.discriminator_layout(d), gen, "cpu")
        net = make()
        net.load_state_dict(p, strict=True)
        x = torch.rand(4, 16, 16, d["in_channels"])
        with torch.no_grad():
            logits, feats = net(x, return_features=True)
            r_logits, r_feats = nets.discriminator(p, d, x, features=True)
        torch.testing.assert_close(r_logits, logits, rtol=1e-5, atol=1e-6)
        for a, b in zip(r_feats, feats, strict=True):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cards", [1, 4])
def test_frames_cell_reads_rounding_gaps(stub_graphs, cards):
    kind = "frames" if cards == 1 else "frames-4card"
    devices = [torch.device("cpu", i) for i in range(cards)]
    res = frames.run(tiny.context(kind, devices=devices))
    assert res["attempted"] > 0 and res["checked"] >= 1
    assert res["numbers"]["frame_rel_rms"] < 1e-5


def test_train_cell_reads_rounding_gaps():
    """The trainer steps eagerly on the CPU; the reference follows its
    first three steps (R1 in the first) from the same weights and data,
    and the R1 step at ``replay_step`` from the program's state."""
    res = train.run(tiny.context("train"))
    assert res["attempted"] > 0 and res["checked"] == 4
    n = res["numbers"]
    assert n["train_loss_gap"] < 1e-5
    assert n["train_grad_gap"] < 1e-5
    assert n["train_change_gap"] < 1e-3
    assert any(w.startswith("step 32") for w in res["where"].values())


def test_the_replayed_step_is_compared(monkeypatch):
    """A fault planted in the R1 step at ``replay_step`` alone (the R1
    term doubled there), where the first steps are sound, reads far above
    the sound run's gap on that step's gradient."""
    from mpgan_torch.train import losses, loop
    real = losses.r1_penalty
    calls = {"n": 0}

    def doubled(*a, **k):
        calls["n"] += 1
        out = real(*a, **k)
        return out * 2.0 if calls["n"] > 2 else out
    monkeypatch.setattr(losses, "r1_penalty", doubled)
    monkeypatch.setattr(loop.losses, "r1_penalty", doubled)
    where: dict = {}
    res = train.run(tiny.context("train"))
    where = res["where"]
    assert res["numbers"]["train_grad_gap"] > 1e-3
    assert where["train_grad_gap"].startswith("step 32")


def test_sampled_batches_are_the_programs():
    """The reference's tiles, drawn from a generator seeded as the program
    seeds each iteration, are the program's tile creator's."""
    from mpgan_torch.data.loader import FluidDataset
    from mpgan_torch.data.pipeline import TileCreator
    from port_bench.reference import train as ref_train
    ctx = tiny.context("train")
    state = train.inputs(ctx)
    rec = {**ctx["config"]["recipe"], "n_frames": 4}
    ds = FluidDataset(lr=state["lr"].numpy(), hr=state["hr"], n_sims=1,
                      n_frames=4, up_res=4)
    tc = TileCreator(ds, rec["tile_lr"], density_threshold=0.0,
                     device="cpu")
    data = ref_train.pass1_data(state["lr"], state["hr"], rec)
    g1, g2 = torch.Generator(), torch.Generator()
    for it in range(3):
        seed = ref_train.step_seed(ctx["seed"], it)
        g1.manual_seed(seed)
        g2.manual_seed(seed)
        got = tc.sample_pass1(g1, rec["batch"], temporal=True)
        want = ref_train.sample(data, g2, rec)
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(want[k], got[k], rtol=1e-5,
                                       atol=1e-5)
