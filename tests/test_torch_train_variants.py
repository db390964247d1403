"""One train step of the port vs the JAX package in the configurations
beside the flagship recipe: sce with label smoothing, pure L1 (no
discriminator runs) and pass 2. Same method and tolerances as
tests/test_torch_train_step.py, whose :func:`step_pair` runs both sides.
"""

import numpy as np
import pytest
import torch

from mpgan_torch.data import pipeline as tpipeline
from mpgan_torch.train import loop as tloop
from mpgan_torch.train import recipe
from test_torch_train_step import small_config, step_pair


def test_sce_with_label_smoothing_matches_jax(monkeypatch):
    tm, _, _ = step_pair(monkeypatch,
                         small_config(gan_loss="sce", label_smooth=0.1,
                                      r1_gamma=0.0))
    assert tm["dt_loss"] > 0


def test_pure_l1_matches_jax_and_skips_discriminators(monkeypatch):
    tm, _, rt = step_pair(monkeypatch,
                          small_config(lambda_adv=0.0, lambda_t=0.0,
                                       lambda_f=0.0))
    assert tm["d_loss"] == tm["dt_loss"] == tm["g_adv"] == tm["g_t"] == 0.0
    assert rt.step_stable.d_runs == 0
    # no D-run: the discriminators' optimizers never stepped
    assert not rt.opt_ds.state and not rt.opt_dt.state


def test_pass2_matches_jax(monkeypatch):
    tm, _, rt = step_pair(monkeypatch, small_config(), pass_no=2)
    assert rt.gen.factors == ((2, 1), (2, 1))
    assert np.isfinite(tm["g_loss"]) and tm["dt_loss"] != 0.0


@pytest.mark.parametrize("mode", ["hinge", "wgan"])
def test_hinge_and_wgan_refuse_label_smoothing(mode):
    """As in the JAX package: these losses would ignore the smoothing."""
    cfg = small_config(gan_loss=mode, label_smooth=0.1, r1_gamma=0.0)
    tc = tpipeline.TileCreator(recipe.synthetic_dataset(size=8), 4,
                               density_threshold=0.0, device="cpu")
    rt = tloop.Trainer(cfg, tc, device="cpu").runtime()
    with pytest.raises(ValueError, match="labelSmooth"):
        rt.step_stable(1.0, torch.Generator())
