"""The port's own copies of the jax-free modules (``.uni`` codec, CLI
params, config) agree with the JAX package's originals."""

import os

import numpy as np
import pytest

from mpgan_torch import config as tconfig
from mpgan_torch.data import loader as tloader
from mpgan_torch.io import uni as tuni
from mpgan_torch.utils import params as tph
from mpgan_tpu import config as jconfig
from mpgan_tpu.data import loader as jloader
from mpgan_tpu.io import uni as juni

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "examples", "data")


@pytest.mark.parametrize("name", ["density_low_0030.uni",
                                  "velocity_low_0030.uni",
                                  "density_high_0030.uni"])
def test_read_uni_equals_jax_package(name):
    path = os.path.join(DATA, "sim_3020", name)
    h_t, a_t = tuni.readUni(path, recenter=True)
    h_j, a_j = juni.readUni(path, recenter=True)
    np.testing.assert_array_equal(a_t, a_j)
    assert h_t == h_j
    assert tuni.read_gridtype(path) == juni.read_gridtype(path)


def test_write_read_round_trip_and_mac_recenter(tmp_path):
    rng = np.random.default_rng(0)
    vel = rng.standard_normal((3, 4, 5, 3)).astype(np.float32)
    p = str(tmp_path / "v.uni")
    tuni.writeUni(p, tuni.make_header(vel, grid_type=tuni.TYPE_MAC), vel)
    _, raw = juni.readUni(p)
    np.testing.assert_array_equal(raw, vel)
    np.testing.assert_array_equal(tuni.readUni(p, recenter=True)[1],
                                  juni.recenter_mac(vel))


def test_vorticity_and_file_names_match():
    vel = np.random.default_rng(1).standard_normal((4, 5, 6, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(tloader.vorticity(vel),
                                  jloader.vorticity(vel))
    for k in ("LOW_DENSITY", "LOW_VELOCITY", "HIGH_DENSITY"):
        assert getattr(tloader, k) == getattr(jloader, k)


def test_params_unused_flag_aborts():
    tph.setParams(["upRes", "8", "typoFlag", "1"])
    assert tph.getParam("upRes", 4) == "8"
    with pytest.raises(SystemExit):
        tph.checkUnusedParams()
    tph.setParams(["upRes", "8"])
    assert tph.get_typed("upRes", 4) == 8
    tph.checkUnusedParams()


def test_from_cli_matches_jax_config():
    """Every field of the data, model, loss and train sections parses to the
    JAX package's value, defaults and flags alike; an unknown flag aborts."""
    import dataclasses
    argv = ["upRes", "8", "tileSizeLow", "12", "useVorticities", "1",
            "macRecenter", "1", "genFilters", "16", "genBlocks", "3",
            "dtype", "float32", "sliceChunk", "64", "basePath", "d/",
            "fromSim", "3", "toSim", "5", "frameMax", "9",
            "densityThreshold", "0.01", "rot", "1", "discFilters", "12",
            "ganLoss", "hinge", "r1Gamma", "10", "r1Interval", "16",
            "kAdv", "0.5", "kt", "0", "lrgan", "1e-3", "lrdisc", "4e-4",
            "adamEps", "1e-6", "useTempoD", "0", "emaDecay", "0.999",
            "useGrowing", "1", "alphaIters", "7", "randSeed", "3",
            "profileDir", "p/", "debugNans", "1", "saveInterval", "0"]
    t = tconfig.from_cli(argv)
    j = jconfig.from_cli(argv)
    for sect in ("data", "model", "loss", "train"):
        for f in dataclasses.fields(getattr(t, sect)):
            assert getattr(getattr(t, sect), f.name) == \
                getattr(getattr(j, sect), f.name), (sect, f.name)
    assert t.infer.slice_chunk == j.infer.slice_chunk == 64
    assert t.model.stages == 3
    with pytest.raises(SystemExit):
        tconfig.from_cli(["upRes", "4", "bogusFlag", "1"])
