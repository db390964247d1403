"""The port's data path vs the JAX package (CPU, float32): trilinear
sampling, blur + downsample, augmentation transforms, the dense-cell index,
batch assembly for passes 1 and 2 on injected draws, the draws' statistics,
``hrz`` and the ``.uni`` dataset loader.

The JAX samplers draw with ``jax.random``; the port with a
``torch.Generator``. The two cannot give the same bits, so the assembly is
compared on injected draws: the JAX sampler's own function runs with its
``randint``/``uniform`` and ``_transforms`` replaced by the injected values.

Tolerance: atol 1e-6 for every float comparison (the same float32
arithmetic, partly in another order); the index and the loader are exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgan_torch.data import loader as tloader
from mpgan_torch.data import pipeline as tpipeline
from mpgan_torch.io import uni as tuni
from mpgan_torch.ops import augment as taug
from mpgan_torch.ops import interp as tinterp
from mpgan_torch.ops import resample as tresample
from mpgan_torch.train import recipe
from mpgan_tpu.data import loader as jloader
from mpgan_tpu.data import pipeline as jpipeline
from mpgan_tpu.ops import augment as jaug
from mpgan_tpu.ops import interp as jinterp
from mpgan_tpu.ops import resample as jresample

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)

ATOL = 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def test_trilinear_sample_matches_jax():
    rng = _rng(0)
    vol = rng.standard_normal((5, 6, 7, 3)).astype(np.float32)
    coords = (rng.random((4, 9, 3)) * 10 - 2).astype(np.float32)  # beyond
    want = jinterp.trilinear_sample(jnp.asarray(vol), jnp.asarray(coords))
    got = tinterp.trilinear_sample(torch.from_numpy(vol),
                                   torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_trilinear_sample_stack_reads_each_samples_volume():
    rng = _rng(1)
    vols = rng.standard_normal((4, 5, 6, 7, 2)).astype(np.float32)
    idx = np.array([3, 0, 3, 1, 2])
    coords = (rng.random((5, 3, 8, 3)) * 8 - 1).astype(np.float32)
    want = jax.vmap(jinterp.trilinear_sample)(jnp.asarray(vols[idx]),
                                              jnp.asarray(coords))
    got = tinterp.trilinear_sample_stack(torch.from_numpy(vols),
                                         torch.from_numpy(idx),
                                         torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_grid_coords_3d_matches_jax():
    np.testing.assert_array_equal(tinterp.grid_coords_3d(3, 4, 5).numpy(),
                                  np.asarray(jinterp.grid_coords_3d(3, 4, 5)))


@pytest.mark.parametrize("factor,axis,sigma", [
    (2, 0, None), (4, 0, None), (4, 2, None), (1, 1, None), (1, 1, 0.7)])
def test_downsample_axis_matches_jax(factor, axis, sigma):
    vol = _rng(2).random((8, 12, 16, 1), dtype=np.float32)
    want = jresample.downsample_axis(jnp.asarray(vol), factor, axis, sigma)
    got = tresample.downsample_axis(torch.from_numpy(vol), factor, axis,
                                    sigma)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def _transforms(b, seed):
    rng = _rng(seed)
    theta = torch.from_numpy(rng.random(b).astype(np.float32) * 6.28)
    flips = torch.from_numpy(np.where(rng.random((b, 2)) < 0.5, -1.0,
                                      1.0).astype(np.float32))
    sigma = torch.from_numpy(0.85 + 0.3 * rng.random(b).astype(np.float32))
    return taug.transform_matrices(theta, flips[:, 0], flips[:, 1], sigma)


def test_transform_matrices_match_jax(monkeypatch):
    """For the same (θ, flips, σ) the port's (A, A⁻¹) equal the matrices
    JAX's ``sample_transform`` builds (its draws replaced by those
    values), and A·A⁻¹ = I."""
    rng = _rng(3)
    theta = rng.random(6).astype(np.float32) * 6.28
    flips = rng.random((6, 2)) < 0.5
    sigma = (0.85 + 0.3 * rng.random(6)).astype(np.float32)
    a, ainv = taug.transform_matrices(
        torch.from_numpy(theta),
        torch.from_numpy(np.where(flips[:, 0], -1.0, 1.0).astype(np.float32)),
        torch.from_numpy(np.where(flips[:, 1], -1.0, 1.0).astype(np.float32)),
        torch.from_numpy(sigma))
    for i in range(6):
        uniform = iter([jnp.float32(theta[i]), jnp.float32(sigma[i])])
        bern = iter([jnp.bool_(flips[i, 0]), jnp.bool_(flips[i, 1])])
        monkeypatch.setattr(jax.random, "uniform",
                            lambda *a, **k: next(uniform))
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda *a, **k: next(bern))
        ja, jainv = jaug.sample_transform(jax.random.PRNGKey(0), 2, 0.85,
                                          1.15)
        np.testing.assert_allclose(a[i].numpy(), np.asarray(ja), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(ainv[i].numpy(), np.asarray(jainv),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(a[i].numpy() @ ainv[i].numpy(),
                                   np.eye(2), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_vel", [2, 3])
def test_transform_vectors_and_pseudovectors_match_jax(n_vel):
    rng = _rng(4)
    patch = rng.standard_normal((5, 6, 7, 8)).astype(np.float32)
    _, ainv = _transforms(5, 5)
    want_v = jax.vmap(lambda p, m: jaug.transform_vectors(p, m, n_vel))(
        jnp.asarray(patch), jnp.asarray(ainv.numpy()))
    got_v = taug.transform_vectors(torch.from_numpy(patch), ainv, n_vel)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=ATOL)
    want_w = jax.vmap(lambda p, m: jaug.transform_pseudovectors(
        p, m, 4, n_vel))(jnp.asarray(patch), jnp.asarray(ainv.numpy()))
    got_w = taug.transform_pseudovectors(torch.from_numpy(patch), ainv, 4,
                                         n_vel)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=0,
                               atol=ATOL)


def _datasets(channels=4, seed=6):
    """(port dataset, JAX dataset): 2 sims × 4 frames of 8³ LR at 4×."""
    ds = recipe.synthetic_dataset(size=8, up=4, channels=channels, seed=seed)
    return ds, jloader.FluidDataset(lr=ds.lr, hr=ds.hr, n_sims=ds.n_sims,
                                    n_frames=ds.n_frames, up_res=ds.up_res)


def test_dense_index_equals_jax():
    tds, jds = _datasets()
    tc = tpipeline.TileCreator(tds, 4, density_threshold=0.55, device="cpu")
    jc = jpipeline.TileCreator(jds, 4, density_threshold=0.55)
    assert 0 < tc.dense_idx.shape[0] < 8 * 4 ** 3      # some cells rejected
    np.testing.assert_array_equal(tc.dense_idx.numpy(),
                                  np.asarray(jc.dense_idx))
    np.testing.assert_array_equal(tc.dense_idx_t.numpy(),
                                  np.asarray(jc.dense_idx_t))
    assert tuple(tc.st) == tuple(jc.st)


def test_hrz_equals_jax():
    tds, jds = _datasets()
    tc = tpipeline.TileCreator(tds, 4, device="cpu")
    jc = jpipeline.TileCreator(jds, 4)
    assert "hr" not in tc._dev                       # pass 1 leaves hr home
    np.testing.assert_allclose(tc.hrz.numpy(), np.asarray(jc.hrz), rtol=0,
                               atol=ATOL)
    assert "hr" not in tc._dev


def _injected(tc, batch, seed, temporal):
    rng = _rng(seed)
    didx = tc._idx(temporal)
    pick = rng.integers(0, didx.shape[0], batch)
    jitter = rng.random((batch, 3), dtype=np.float32)
    a, ainv = _transforms(batch, seed + 1)
    return tpipeline.Draws(torch.from_numpy(pick), torch.from_numpy(jitter),
                           a, ainv)


def _jax_sample(monkeypatch, fn, draws, *args):
    """The JAX sampler's own (unjitted) function with its draws replaced."""
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(draws.pick.numpy(),
                                                    jnp.int32))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(draws.jitter.numpy()))
    monkeypatch.setattr(jpipeline, "_transforms", lambda *a, **k: (
        jnp.asarray(draws.a.numpy()), jnp.asarray(draws.ainv.numpy())))
    return fn.__wrapped__(*args)


@pytest.mark.parametrize("channels,augment", [(4, True), (7, True),
                                              (4, False)])
def test_sample_pass1_assembly_matches_jax(monkeypatch, channels, augment):
    tds, jds = _datasets(channels)
    tc = tpipeline.TileCreator(tds, 4, density_threshold=0.0,
                               augment=augment, device="cpu")
    jc = jpipeline.TileCreator(jds, 4, density_threshold=0.0,
                               augment=augment)
    draws = _injected(tc, 3, 7, True)
    if not augment:
        eye = torch.eye(2).expand(3, 2, 2)
        draws = draws._replace(a=eye, ainv=eye)
    got = tpipeline.assemble_pass1(tc.lr, tc.hrz, tc.dense_idx_t, draws,
                                   "xy", True, tc.st)
    want = _jax_sample(monkeypatch, jpipeline._sample_pass1, draws, jc.lr,
                       jc.hrz, jc.dense_idx_t, jax.random.PRNGKey(0), 3,
                       "xy", True, jc.st)
    assert set(got) == set(want) == {"lr", "hr", "lr_prev", "hr_prev",
                                     "lr_next", "hr_next"}
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
    assert got["lr"].shape == (3, 4, 4, channels)
    assert got["hr"].shape == (3, 16, 16, 1)


def test_sample_pass2_assembly_matches_jax(monkeypatch):
    tds, jds = _datasets()
    tc = tpipeline.TileCreator(tds, 4, density_threshold=0.0, device="cpu")
    jc = jpipeline.TileCreator(jds, 4, density_threshold=0.0)
    draws = _injected(tc, 3, 8, True)
    got = tpipeline.assemble_pass2(tc.lr, tc.hrz, tc.hr, tc.dense_idx_t,
                                   draws, "xz", True, tc.st)
    want = _jax_sample(monkeypatch, jpipeline._sample_pass2, draws, jc.lr,
                       jc.interm, jc.hr, jc.dense_idx_t,
                       jax.random.PRNGKey(0), 3, "xz", True, jc.st)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
    assert got["interm"].shape == (3, 4, 16, 1)
    assert got["lr_vel"].shape == (3, 4, 16, 3)


@pytest.mark.parametrize("rot_mode", [2, 1])
def test_draw_statistics(rot_mode):
    """Centres lie inside the margin on the in-plane axes and on the
    lattice along the normal; A·A⁻¹ = I; σ in range; angles on the
    quarter-turn lattice for rot 1."""
    tds, _ = _datasets()
    tc = tpipeline.TileCreator(tds, 4, density_threshold=0.0,
                               rot_mode=rot_mode, device="cpu")
    st = tc.st
    d = tpipeline.draw(torch.Generator().manual_seed(0), 512,
                       tc.dense_idx_t, st)
    vol, c = tpipeline._candidates(d.pick, d.jitter, "xy", tc.dense_idx_t,
                                   st)
    m = tpipeline._margin(st)
    for ax in (1, 2):                      # in-plane for xy: y, x
        # clipped to [m, max(size-1-m, m)], then snapped down to the
        # half-integer lattice (at most 1 cell)
        assert float(c[:, ax].min()) >= m - 1.0
        assert float(c[:, ax].max()) <= max(st.dims_zyx[ax] - 1 - m, m)
        assert torch.equal(c[:, ax] - 1.5, torch.floor(c[:, ax] - 1.5))
    assert torch.equal(c[:, 0], torch.round(c[:, 0]))  # z on the lattice
    frames = vol % st.n_frames
    assert int(frames.min()) >= 1 and int(frames.max()) <= st.n_frames - 2
    eye = torch.eye(2).expand(512, 2, 2)
    torch.testing.assert_close(d.a @ d.ainv, eye, rtol=0, atol=1e-5)
    sigma = torch.sqrt(torch.abs(torch.linalg.det(d.a)))
    assert float(sigma.min()) >= 0.85 - 1e-6
    assert float(sigma.max()) <= 1.15 + 1e-6
    dets = torch.linalg.det(d.a)
    assert bool((dets > 0).any()) and bool((dets < 0).any())    # flips
    if rot_mode == 1:
        r = d.a / sigma[:, None, None]
        assert torch.allclose(r.abs().round(), r.abs(), atol=1e-5)
    assert 0.2 < float(d.jitter.mean()) < 0.8


def test_sample_pass1_on_the_tile_creator():
    tds, _ = _datasets()
    tc = tpipeline.TileCreator(tds, 4, density_threshold=0.0, device="cpu")
    b = tc.sample_pass1(torch.Generator().manual_seed(1), 5, temporal=True)
    assert b["lr"].shape == (5, 4, 4, 4) and b["hr_next"].shape == (
        5, 16, 16, 1)
    assert all(bool(torch.isfinite(v).all()) for v in b.values())


# ---------------------------------------------------------------- loader

def _write_frames(base, sim, frames, mac=False, rng=None):
    d = os.path.join(base, f"sim_{sim:04d}")
    os.makedirs(d, exist_ok=True)
    for f in frames:
        tuni.write_density(os.path.join(d, tloader.LOW_DENSITY % f),
                           rng.random((4, 4, 4), dtype=np.float32))
        vel = rng.random((4, 4, 4, 3), dtype=np.float32)
        path = os.path.join(d, tloader.LOW_VELOCITY % f)
        if mac:
            tuni.writeUni(path, tuni.make_header(
                vel, grid_type=tuni.TYPE_MAC | tuni.TYPE_VEC3), vel)
        else:
            tuni.write_velocity(path, vel)
        tuni.write_density(os.path.join(d, tloader.HIGH_DENSITY % f),
                           rng.random((8, 8, 8), dtype=np.float32))


@pytest.mark.parametrize("kw", [{}, {"use_vorticities": True},
                                {"mac_recenter": True},
                                {"use_velocities": False},
                                {"data_fraction": 0.5}])
def test_loader_equals_jax(tmp_path, kw):
    """Sim 1000 has frames 0-4 with a gap at 5 then 6-7 (truncated at the
    gap); sim 1001 has 0-2 and MAC-tagged velocities (every sim is cut to
    3 frames)."""
    rng = _rng(9)
    _write_frames(str(tmp_path), 1000, [0, 1, 2, 3, 4, 6, 7], rng=rng)
    _write_frames(str(tmp_path), 1001, [0, 1, 2], mac=True, rng=rng)
    with pytest.warns(UserWarning, match="truncating"):
        got = tloader.FluidDataLoader(str(tmp_path), 1000, 1001,
                                      frame_max=8, **kw).get()
    want = jloader.FluidDataLoader(str(tmp_path), 1000, 1001, frame_max=8,
                                   **kw).get()
    for f in ("n_sims", "n_frames", "up_res"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.lr, want.lr)
    np.testing.assert_array_equal(got.hr, want.hr)
    assert got.up_res == 2
    assert got.n_frames == (1 if kw.get("data_fraction") else 3)


def test_loader_missing_sim_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tloader.FluidDataLoader(str(tmp_path), 5, 5).get()
