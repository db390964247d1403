"""The port's evaluation CLI, ``mpgan_torch.eval.main``, against the JAX
package's ``scripts/eval.py`` ``main``, both in process on the CPU.

One tiny ``.uni`` dataset (1 sim, frames 0-6 of 8³ LR → 32³ HR, density +
velocity) with two gaps: frame 2 has no HR density and frame 4 no LR
density, so frames 0, 1, 3, 5 and 6 are scored and the temporal pairs are
0→1 and 5→6. The same random generators (base 8, one res block, 4×,
float32) are saved in each package's run-dir format: orbax for JAX, the
port's ``.npz`` for the port. Every JSON key must agree: PSNR to 1e-3 dB,
SSIM to 1e-5, tdiff to 1e-6 (the keys are rounded to 3, 4 and 5
decimals).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgan_torch import convert
from mpgan_torch import eval as teval
from mpgan_torch.data import loader
from mpgan_torch.io import uni
from mpgan_torch.train import checkpoint as tckpt
from mpgan_tpu.models import generator as JG
from mpgan_tpu.train import checkpoint as jckpt

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
MODEL = "upRes 4 genFilters 8 genBlocks 1 dtype float32 compileCache 0"
TOL = {"psnr_mean": 1e-3, "psnr_min": 1e-3, "psnr_max": 1e-3,
       "trilinear_psnr_mean": 1e-3, "ssim_mean": 1e-5,
       "trilinear_ssim_mean": 1e-5, "tdiff_mean": 1e-6,
       "tdiff_gt_mean": 1e-6}


def _jax_eval():
    spec = importlib.util.spec_from_file_location(
        "jax_eval_script", os.path.join(ROOT, "scripts", "eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    base = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(0)
    d = base / "data" / "sim_1000"
    d.mkdir(parents=True)
    for f in range(7):
        lr = rng.random((8, 8, 8), dtype=np.float32)
        hr = np.repeat(np.repeat(np.repeat(lr, 4, 0), 4, 1), 4, 2)
        hr = hr + 0.05 * rng.random((32, 32, 32), dtype=np.float32)
        if f != 4:
            uni.write_density(str(d / (loader.LOW_DENSITY % f)), lr)
        uni.write_velocity(str(d / (loader.LOW_VELOCITY % f)),
                           rng.random((8, 8, 8, 3), dtype=np.float32) - 0.5)
        if f != 2:
            uni.write_density(str(d / (loader.HIGH_DENSITY % f)), hr)
    gens = [(JG.make_pass1(2, 8, 1), (1, 8, 8, 4)),
            (JG.make_pass2(2, 8, 1), (1, 8, 32, 4)),
            (JG.make_pass3(8, 1), (1, 32, 32, 4))]
    for i, (g, shape) in enumerate(gens):
        params = g.init(jax.random.PRNGKey(i), jnp.zeros(shape))
        jckpt.save_gen(jckpt.run_dir(str(base / "jax_runs"), i), 0, params)
        sd = convert.flax_to_state_dict(jax.tree.map(np.asarray, params))
        tckpt.save_gen(tckpt.run_dir(str(base / "port_runs"), i), 0, sd,
                       {"pass_no": i + 1, "stage": 2 if i < 2 else 1,
                        "up_res": 4})
    return base


@pytest.mark.parametrize("passes", [
    "load_model_test 0",                                       # pass 1 only
    "load_model_test 0 load_model_test2 1 load_model_test3 2",
], ids=["one_pass", "three_pass"])
def test_eval_matches_jax_eval(workdir, passes, capsys):
    common = (f"basePath {workdir}/data/ fromSim 1000 toSim 1000 frameMin 0 "
              f"frameMax 7 {MODEL} {passes} ")
    want = _jax_eval().main((common + f"testPath {workdir}/jax_runs/").split())
    got = teval.main((common + f"testPath {workdir}/port_runs/ "
                      "device cpu").split())
    assert set(got) == set(want)
    assert got["frames"] == want["frames"] == 5
    assert "tdiff_mean" in got
    for k in ("two_pass", "three_pass"):
        assert got[k] == want[k]
    for k, tol in TOL.items():
        assert abs(got[k] - want[k]) <= tol + 1e-12, (k, got[k], want[k])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        '{"frames": 5')


def test_eval_exits_when_no_frame_can_be_evaluated(workdir):
    with pytest.raises(SystemExit, match="no evaluable frames"):
        teval.main((f"basePath {workdir}/data/ fromSim 1000 toSim 1000 "
                    f"frameMin 40 frameMax 42 {MODEL} load_model_test 0 "
                    f"testPath {workdir}/port_runs/ device cpu").split())
