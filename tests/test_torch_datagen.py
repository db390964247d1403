"""The port's datagen (mpgan_torch.solver.datagen, python -m
mpgan_torch.datagen) on the CPU.

``generate_sim`` at 16³, upRes 2, 3 frames after 2 warm-up steps, on the
JAX package's scene and noise injected, writes the files JAX's
``generate_sim`` writes: the same names and headers (but the timestamp),
every array within 1e-5 (five solver steps, each within 1e-5 of JAX's in
tests/test_torch_solver.py, compound) and the flags equal. Then the 2D
scenes, the flags encoding, the scene policy, ``skipExisting``, both
packages' loaders on the port's files, the CLI in process and one
supervised restart (a child process pair, about 10 s).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgan_torch import datagen as tcli
from mpgan_torch.data import loader as tloader
from mpgan_torch.io import uni
from mpgan_torch.solver import datagen as tdatagen
from mpgan_torch.solver import smoke as tsmoke
from mpgan_tpu.data import loader as jloader
from mpgan_tpu.solver import datagen as jdatagen
from mpgan_tpu.solver import noise as jnoise

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RES, UP, FRAMES, WARMUP = 16, 2, 3, 2


def _jax_scene(seed, scene):
    """JAX's scene for ``seed`` as a port Scene, and JAX's inflow of step t
    as a callable."""
    key = jax.random.PRNGKey(seed)
    strength, solid_at = 1.0, None
    if scene == "plume":
        state, inflow, params = jdatagen.plume_scene(key, RES, True)
    else:
        state, inflow, params, strength, solid_at = \
            jdatagen.varied_plume_scene(key, RES, scene)

    def t(x):
        return torch.from_numpy(np.array(x))
    sc = tdatagen.Scene(
        tsmoke.SmokeState(*map(t, state)), t(inflow),
        tsmoke.SmokeParams(**params.__dict__), strength,
        None if solid_at is None else
        (lambda step: t(solid_at(jnp.float32(step)))))
    return sc, lambda step: t(jnoise.time_varying_inflow(
        key, inflow, step, strength=strength))


@pytest.mark.parametrize("scene,seed", [("plume", 1), ("moving", 7)])
def test_generate_sim_matches_jax_files(tmp_path, scene, seed):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jdatagen.generate_sim(jdir, seed, RES, UP, FRAMES, warmup=WARMUP,
                          with_obstacle=scene == "plume", save_flags=True,
                          scene=scene)
    sc, inflow_at = _jax_scene(seed, scene)
    stats = tdatagen.generate_sim(tdir, seed, RES, UP, FRAMES, WARMUP,
                                  save_flags=True, device="cpu",
                                  injected=sc, inflow_at=inflow_at)
    assert stats["frames"] == FRAMES and stats["steps"] == FRAMES + WARMUP
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == 5 * FRAMES
    for n in names:
        hj, aj = uni.readUni(os.path.join(jdir, n))
        ht, at = uni.readUni(os.path.join(tdir, n))
        for k in ("dimX", "dimY", "dimZ", "gridType", "elementType",
                  "bytesPerElement", "dimT"):
            assert hj[k] == ht[k], (n, k)
        assert at.dtype == aj.dtype and at.shape == aj.shape
        if n.startswith("flags"):
            np.testing.assert_array_equal(at, aj)
        else:
            np.testing.assert_allclose(at, aj, rtol=0, atol=1e-5,
                                       err_msg=n)
    assert uni.readUni(os.path.join(tdir, "density_high_0002.uni"))[1].max() \
        > 0.05


def test_2d_datagen_writes_z1_volumes(tmp_path):
    stats = tdatagen.generate_sim_2d(str(tmp_path / "sim_1000"), 0, 32, 4, 2,
                                     warmup=2, device="cpu")
    assert stats["frame_device_ms"] is None and stats["frames"] == 2
    for mod in (tloader, jloader):
        ds = mod.FluidDataLoader(str(tmp_path), 1000, 1000, frame_max=2).get()
        assert ds.lr.shape == (2, 1, 8, 8, 4)
        assert ds.hr.shape == (2, 1, 32, 32, 1) and ds.up_res == 4
        assert np.all(ds.lr[..., 3] == 0)            # vz of a 2D scene
    assert ds.hr.max() > 0.1


def test_flags_file_uses_mantaflow_encoding(tmp_path):
    sim_dir = str(tmp_path / "sim_0000")
    tdatagen.generate_sim(sim_dir, 1, 16, 2, 1, warmup=0, with_obstacle=True,
                          save_flags=True, device="cpu")
    head, flags = uni.readUni(os.path.join(sim_dir, "flags_0000.uni"))
    assert head["gridType"] == uni.TYPE_FLAGS and flags.dtype == np.int32
    assert set(np.unique(flags).tolist()) == {1, 2}


def test_scene_policy_matches_jax_and_is_range_stable():
    full = {s: tdatagen.with_obstacle(s, 3) for s in range(1000, 1010)}
    resumed = {s: tdatagen.with_obstacle(s, 3) for s in range(1005, 1010)}
    assert all(v == full[s] for s, v in resumed.items())
    assert sum(full.values()) == 3
    for scene in tdatagen.SCENES:
        for sim in range(1000, 1008):
            for every in (0, 2, 3):
                assert tdatagen.sim_scene_policy(scene, sim, every) == \
                    jdatagen.sim_scene_policy(scene, sim, every)
    assert tdatagen.SCENES == jdatagen.SCENES


def test_varied_scenes_draw_per_seed():
    a = tdatagen.make_scene(1, 16, "varied")
    b = tdatagen.make_scene(2, 16, "varied")
    assert a.params.buoyancy != b.params.buoyancy
    assert a.params.vorticity_eps != b.params.vorticity_eps
    assert a.strength != b.strength
    assert not torch.equal(a.inflow, b.inflow)
    again = tdatagen.make_scene(1, 16, "varied")
    assert again.params == a.params and torch.equal(again.inflow, a.inflow)
    one = tdatagen.make_scene(3, 24, "varied")
    dual = tdatagen.make_scene(3, 24, "varied-dual")
    assert float(dual.inflow.sum()) > float(one.inflow.sum())
    mv = tdatagen.make_scene(4, 24, "moving")
    s0, s10 = mv.solid_at(0), mv.solid_at(10)
    assert not torch.equal(s0, s10) and torch.equal(mv.state.solid, s0)
    assert abs(float(s0.sum() - s10.sum())) / max(float(s0.sum()), 1) < 0.25


def _cli(base, *extra):
    return (f"basePath {base}/ resHigh 16 upRes 2 frames 2 warmup 1 "
            "device cpu " + " ".join(extra)).split()


def test_cli_in_process_and_both_loaders(tmp_path, capsys):
    """`main` in process: plume with an obstacle every 2nd sim, a varied sim
    with CG and a moving sim; both packages' loaders read the files back
    alike; skipExisting skips complete sims and rewrites nothing."""
    base = str(tmp_path)
    out = tcli.main(_cli(base, "fromSim 1000 toSim 1001 obstacles 2"))
    out += tcli.main(_cli(base, "fromSim 1002 toSim 1002 scene varied "
                                "pressureSolver cg"))
    out += tcli.main(_cli(base, "fromSim 1003 toSim 1003 scene moving"))
    assert [(o["sim"], o["obstacle"], o["solver"]) for o in out] == [
        (1000, False, "jacobi"), (1001, True, "jacobi"), (1002, False, "cg"),
        (1003, False, "jacobi")]
    assert os.path.exists(f"{base}/sim_1001/flags_0001.uni")
    assert not os.path.exists(f"{base}/sim_1000/flags_0001.uni")
    assert os.path.exists(f"{base}/sim_1003/flags_0001.uni")
    port = tloader.FluidDataLoader(base, 1000, 1003, frame_max=2).get()
    ref = jloader.FluidDataLoader(base, 1000, 1003, frame_max=2).get()
    assert port.lr.shape == (8, 8, 8, 8, 4) and port.hr.shape == (8, 16, 16,
                                                                 16, 1)
    np.testing.assert_array_equal(port.lr, ref.lr)
    np.testing.assert_array_equal(port.hr, ref.hr)
    assert np.isfinite(port.lr).all() and port.hr.max() > 0.05
    mtime = os.path.getmtime(f"{base}/sim_1001/density_high_0001.uni")
    capsys.readouterr()
    assert tcli.main(_cli(base, "fromSim 1000 toSim 1001 obstacles 2 "
                                "skipExisting 1")) == []
    assert capsys.readouterr().out.count("skipped") == 2
    assert os.path.getmtime(f"{base}/sim_1001/density_high_0001.uni") == mtime
    # an incomplete sim is generated again
    os.remove(f"{base}/sim_1001/flags_0001.uni")
    assert [o["sim"] for o in tcli.main(_cli(
        base, "fromSim 1000 toSim 1001 obstacles 2 skipExisting 1"))] == [1001]
    with pytest.raises(SystemExit):
        tcli.main(_cli(base, "fromSim 1000 pressureSolver sor"))
    with pytest.raises(SystemExit):
        tcli.main(_cli(base, "fromSim 1000 resHihg 8"))


def test_generate_dataset_writes_what_the_cli_writes(tmp_path):
    """The library sweep and the CLI share the scene policy and the seeds:
    the same flags give the same files."""
    a, b = str(tmp_path / "lib"), str(tmp_path / "cli")
    tdatagen.generate_dataset(a, 1000, 1001, 16, 2, 2, seed=3,
                              obstacles_every=2, device="cpu")
    tcli.main(f"basePath {b}/ fromSim 1000 toSim 1001 resHigh 16 upRes 2 "
              "frames 2 obstacles 2 randSeed 3 device cpu".split())
    for sim in ("sim_1000", "sim_1001"):
        names = sorted(os.listdir(os.path.join(a, sim)))
        assert names == sorted(os.listdir(os.path.join(b, sim)))
        for n in names:
            np.testing.assert_array_equal(
                uni.readUni(os.path.join(a, sim, n))[1],
                uni.readUni(os.path.join(b, sim, n))[1])
    assert "flags_0001.uni" in os.listdir(os.path.join(a, "sim_1001"))


def test_supervised_restart_after_a_crash(tmp_path):
    """`python -m mpgan_torch.datagen ... retryOnError 1` with
    MPGAN_FAIL_ONCE: the child dies after its first frame, the parent
    restarts it with skipExisting 1, and the sweep completes."""
    base, flag = str(tmp_path / "data"), str(tmp_path / "fail_once")
    env = dict(os.environ, MPGAN_FAIL_ONCE=flag, MPGAN_RETRY_DELAY_S="0",
               PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "mpgan_torch.datagen",
                        *_cli(base, "fromSim 1000 toSim 1001 retryOnError 1")],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert os.path.exists(flag)
    assert "retryOnError: child died" in r.stdout, r.stdout
    assert tcli._sim_complete(f"{base}/sim_1000", 2, False)
    assert tcli._sim_complete(f"{base}/sim_1001", 2, False)
