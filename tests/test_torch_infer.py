"""The port's weight files, loading and volume assembly vs the JAX package
(CPU, float32, TF32 off).

Tolerances: atol 1e-5 for the small random-weight chains (conv summation
order); atol 1e-4 for the bundled 4x chain at 32³→128³ (a deep stack);
the exported weights must equal the orbax restore bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgan_torch import config as tconfig
from mpgan_torch import convert
from mpgan_torch.device import resolve_device
from mpgan_torch.infer import assemble as TA
from mpgan_torch.infer import load as TL
from mpgan_torch.models import generator as TG
from mpgan_tpu import config as jconfig
from mpgan_tpu.infer import assemble as JA
from mpgan_tpu.infer import load as JL
from mpgan_tpu.models import generator as JG

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DATA = os.path.join(ROOT, "examples", "data")


def _torch_gen(jgen, params, tgen):
    tgen.load_state_dict(convert.flax_to_state_dict(
        jax.tree.map(np.asarray, params)))
    return tgen.eval()


@pytest.fixture(scope="module")
def small_chain():
    """Random flax generators at base 8, one res block, 4x; converted."""
    jg1, jg2, jg3 = (JG.make_pass1(2, 8, 1), JG.make_pass2(2, 8, 1),
                     JG.make_pass3(8, 1))
    p1 = jg1.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)))
    p2 = jg2.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 32, 4)))
    p3 = jg3.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 4)))
    t1 = _torch_gen(jg1, p1, TG.make_pass1(2, 8, 1))
    t2 = _torch_gen(jg2, p2, TG.make_pass2(2, 8, 1))
    t3 = _torch_gen(jg3, p3, TG.make_pass3(8, 1))
    return (jg1, p1, t1), (jg2, p2, t2), (jg3, p3, t3)


CASES = {  # name: (lr shape, chunk, use gen2, use gen3)
    "two_pass": ((8, 8, 8, 4), 0, True, False),
    "two_pass_chunked": ((8, 8, 8, 4), 3, True, False),
    "three_pass": ((8, 8, 8, 4), 0, True, True),
    "three_pass_chunked": ((8, 8, 8, 4), 5, True, True),
    "z1_early_return": ((1, 8, 8, 4), 0, True, True),
    "no_gen2": ((8, 8, 8, 4), 0, False, False),
    "no_gen2_with_gen3": ((8, 8, 8, 4), 3, False, True),
    "density_only": ((8, 8, 8, 1), 0, None, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_upscale_volume_matches_jax(small_chain, case):
    shape, chunk, use2, use3 = CASES[case]
    (jg1, p1, t1), (jg2, p2, t2), (jg3, p3, t3) = small_chain
    if use2 is None:  # density-only models: 1-channel stems
        jg1, jg2 = JG.make_pass1(2, 8, 1), JG.make_pass2(2, 8, 1)
        p1 = jg1.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 1)))
        p2 = jg2.init(jax.random.PRNGKey(4), jnp.zeros((1, 8, 32, 1)))
        t1 = _torch_gen(jg1, p1, TG.make_pass1(2, 8, 1, in_channels=1))
        t2 = _torch_gen(jg2, p2, TG.make_pass2(2, 8, 1, in_channels=1))
        use2, use3 = True, False
    lr = np.random.default_rng(5).random(shape, dtype=np.float32)
    want = np.asarray(JA.upscale_volume(
        jg1, p1, jg2 if use2 else None, p2 if use2 else None,
        jnp.asarray(lr), up_res=4, chunk=chunk,
        gen3=jg3 if use3 else None, params3=p3 if use3 else None))
    with torch.no_grad():
        got = TA.upscale_volume(t1, t2 if use2 else None, torch.from_numpy(lr),
                                4, chunk=chunk,
                                gen3=t3 if use3 else None).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_apply_sliced_chunks_equal_one_batch():
    calls = []

    def fn(x):
        calls.append(x.shape[0])
        return x * 2
    x = torch.arange(7 * 2 * 2 * 1, dtype=torch.float32).reshape(7, 2, 2, 1)
    out = TA.apply_sliced(fn, x, chunk=3)
    assert torch.equal(out, x * 2)
    assert calls == [3, 3, 3]  # last chunk zero-padded to the chunk size


def test_psnr_volume_matches_jax():
    rng = np.random.default_rng(6)
    a, b = (rng.random((4, 4, 4, 1), dtype=np.float32) for _ in range(2))
    assert TA.psnr_volume(torch.from_numpy(a).to(torch.bfloat16), b) == \
        JA.psnr_volume(np.asarray(torch.from_numpy(a).to(torch.bfloat16)
                                  .float()), b)
    assert TA.psnr_volume(a, b) == JA.psnr_volume(a, b)


def _orbax_restore(name):
    """The JAX generator and its params, restored as tests/test_quality.py
    restores a bundle."""
    import orbax.checkpoint as ocp
    meta = json.load(open(os.path.join(ROOT, "examples", "checkpoints",
                                       f"{name}.json")))
    if meta["pass_no"] == 1:
        g, shape = JG.make_pass1(meta["stage"], 32, 2), (1, 16, 16, 4)
    else:
        g, shape = JG.make_pass2(meta["stage"], 32, 2), (1, 16, 64, 4)
    template = g.init(jax.random.PRNGKey(0), jnp.zeros(shape))
    abstract = jax.tree.map(ocp.utils.to_shape_dtype_struct, template)
    path = os.path.abspath(os.path.join(ROOT, "examples", "checkpoints", name))
    return g, ocp.StandardCheckpointer().restore(path, abstract)


@pytest.mark.parametrize("name", ["g1_l1_4x", "g2_l1_4x"])
def test_exported_weights_equal_orbax_restore(name):
    _, params = _orbax_restore(name)
    flat, meta = convert.load_npz(TL.bundled_weights(name))
    want = convert.flatten_params(jax.tree.map(np.asarray, params))
    assert set(flat) == set(want)
    for k in want:
        assert flat[k].dtype == np.float32
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
    src = json.load(open(os.path.join(ROOT, "examples", "checkpoints",
                                      f"{name}.json")))
    assert {k: meta[k] for k in ("pass_no", "stage", "up_res")} == \
        {k: src[k] for k in ("pass_no", "stage", "up_res")}


def test_bundled_4x_chain_matches_jax_and_keeps_floors():
    """The exported canonical 4x L1 pair on sim_1010c frame 12: the torch
    f32 chain equals the JAX chain and keeps test_quality's PSNR floors."""
    cfg = tconfig.Config()
    cfg.model.dtype = "float32"
    g1 = TL.load_generator_npz(TL.bundled_weights("g1_l1_4x"), 1, cfg, "cpu")
    g2 = TL.load_generator_npz(TL.bundled_weights("g2_l1_4x"), 2, cfg, "cpu")
    lr = TL.read_lr_frame(cfg, os.path.join(DATA, "sim_1010c"), 12)
    with torch.inference_mode():
        got = TA.upscale_volume(g1, g2, torch.from_numpy(lr), 4).numpy()
    jg1, p1 = _orbax_restore("g1_l1_4x")
    jg2, p2 = _orbax_restore("g2_l1_4x")
    want = np.asarray(JA.upscale_volume(jg1, p1, jg2, p2, jnp.asarray(lr),
                                        up_res=4))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    from mpgan_torch.io import uni
    gt = uni.readUni(os.path.join(DATA, "sim_1010c",
                                  "density_high_0012.uni"))[1]
    tri = np.asarray(jax.image.resize(jnp.asarray(lr[..., :1]),
                                      (128, 128, 128, 1), "linear"))
    psnr, psnr_tri = TA.psnr_volume(got, gt), TA.psnr_volume(tri, gt)
    assert psnr >= psnr_tri + 5.0, (psnr, psnr_tri)
    assert psnr >= 34.5, psnr


def test_loader_rejects_wrong_pass():
    with pytest.raises(ValueError, match="pass-1"):
        TL.load_generator_npz(TL.bundled_weights("g1_l1_4x"), 2,
                              tconfig.Config(), "cpu")


def test_loader_builds_mid_growth_stage(tmp_path):
    """A stage-1 export under a 4x config rebuilds a 1-stage (2x) model;
    the model computes and returns cfg.model.dtype."""
    jg = JG.make_pass1(1, 32, 2)
    params = jg.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)))
    path = str(tmp_path / "g1_mid.npz")
    convert.save_npz(path, jax.tree.map(np.asarray, params),
                     {"pass_no": 1, "stage": 1, "up_res": 4})
    gen = TL.load_generator_npz(path, 1, tconfig.Config(), "cpu")
    assert len(gen.factors) == 1 and gen.dtype == torch.bfloat16
    x = np.random.default_rng(7).random((2, 8, 8, 4), dtype=np.float32)
    with torch.no_grad():
        out = gen(torch.from_numpy(x))
    assert out.shape == (2, 16, 16, 1) and out.dtype == torch.bfloat16
    want = np.asarray(jg.apply(params, jnp.asarray(x)))
    assert float(np.abs(out.float().numpy() - want).max()) < 0.1


@pytest.mark.parametrize("vort,mac", [(False, False), (True, False),
                                      (False, True)])
def test_read_lr_frame_matches_jax(vort, mac):
    tcfg, jcfg = tconfig.Config(), jconfig.Config()
    for c in (tcfg, jcfg):
        c.data.use_vorticities, c.data.mac_recenter = vort, mac
    sim = os.path.join(DATA, "sim_3020")
    got = TL.read_lr_frame(tcfg, sim, 30)
    want = JL.read_lr_frame(jcfg, sim, 30)
    assert got.shape == want.shape == (16, 16, 16, 7 if vort else 4)
    np.testing.assert_array_equal(got, want)
    assert TL.read_lr_frame(tcfg, sim, 99) is None
    assert TL.input_channels(tcfg, 1) == (7 if vort else 4)
    assert TL.input_channels(tcfg, 2) == 4


def test_resolve_device():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda:0")


@pytest.mark.parametrize("chunk", [4, 5, 16, 40])   # divides Ys, does not, > Ys
def test_upscale_volume_streamed_matches_jax_and_in_memory(chunk):
    """The host-streamed assembly (pass 2 chunk by chunk, each chunk's
    velocity window from LR rows with a margin) against JAX's
    upscale_volume_streamed and the port's upscale_volume (atol 2e-6, as
    tests/test_infer.py holds JAX's)."""
    jg1, jg2 = JG.make_pass1(1, 8, 1), JG.make_pass2(1, 8, 1)
    p1 = jg1.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)))
    p2 = jg2.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 16, 4)))
    t1 = _torch_gen(jg1, p1, TG.make_pass1(1, 8, 1))
    t2 = _torch_gen(jg2, p2, TG.make_pass2(1, 8, 1))
    lr = np.random.default_rng(7).random((6, 8, 10, 4), np.float32)
    want = JA.upscale_volume_streamed(jg1, p1, jg2, p2, jnp.asarray(lr),
                                      up_res=2, chunk=chunk)
    with torch.no_grad():
        ref = TA.upscale_volume(t1, t2, torch.from_numpy(lr), 2).numpy()
        got = TA.upscale_volume_streamed(t1, t2, torch.from_numpy(lr), 2,
                                         chunk=chunk, chunk1=3)
    assert got.shape == want.shape == (12, 16, 20, 1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_upscale_volume_streamed_density_only_and_4x():
    jg1, jg2 = JG.make_pass1(2, 8, 1), JG.make_pass2(2, 8, 1)
    for c, seed in ((1, 3), (4, 4)):
        p1 = jg1.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, c)))
        p2 = jg2.init(jax.random.PRNGKey(seed + 1), jnp.zeros((1, 8, 32, c)))
        t1 = _torch_gen(jg1, p1, TG.make_pass1(2, 8, 1, in_channels=c))
        t2 = _torch_gen(jg2, p2, TG.make_pass2(2, 8, 1, in_channels=c))
        lr = np.random.default_rng(seed).random((5, 7, 6, c), np.float32)
        want = JA.upscale_volume_streamed(jg1, p1, jg2, p2, jnp.asarray(lr),
                                          up_res=4, chunk=6)
        with torch.no_grad():
            ref = TA.upscale_volume(t1, t2, torch.from_numpy(lr), 4).numpy()
            got = TA.upscale_volume_streamed(t1, t2, torch.from_numpy(lr), 4,
                                             chunk=6)
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_streamed_velocity_window_equals_the_full_resize():
    """Every row window of _velocity_rows is the full resize's rows, bit
    for bit, at 2x, 4x and 8x."""
    from mpgan_torch.ops.upsample import resize_volume
    vel = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, 9, 5, 3)).astype(np.float32))
    for up in (2, 4, 8):
        full = resize_volume(vel, (3, 9 * up, 5 * up))
        for y0, rows in ((0, 1), (0, 9 * up), (up - 1, up + 3),
                         (3 * up + 1, 2 * up), (9 * up - 3, 3)):
            win = TA._velocity_rows(vel, y0, rows, up, torch.float32)
            assert torch.equal(win, full[:, y0:y0 + rows]), (up, y0, rows)
