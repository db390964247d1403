"""The port's zero-setup demo (``python -m mpgan_torch.demo``, the
counterpart of examples/demo.py) on the CPU, in float32:

- its mode table names the chains and frames of the quality gates that
  hold the same chains (mpgan_torch.quality.GATES, tests/test_quality.py);
- on an 8³ LR crop of each mode's frame, its output equals
  ``quality.upscale`` over the same bundles bit for bit, and its PSNR and
  trilinear figures equal mpgan_tpu's ``psnr_volume`` and
  ``jax.image.resize`` on the same arrays within 1e-5, its SSIM figures
  ``ssim_volume``'s algorithm run in float64 within 1e-5 (the function
  itself blurs in float32, within 2e-4 as in tests/test_torch_metrics.py);
  its strip is examples/demo.py's formula (``:89-93``) bit for bit;
- ``device cpu`` runs on the CPU and writes the strip as a PNG in the
  working directory; without it and without a card the demo raises.
"""

import numpy as np
import pytest
import torch

from mpgan_torch import demo, quality
from mpgan_torch.utils import preview
from test_torch_metrics import _ssim_reference_float64

torch.set_num_threads(1)

TOL = 1e-5
CROP = 8


def test_modes_are_the_gates_chains_and_frames():
    for mode, m in demo.MODES.items():
        gate = quality.GATES[m.gate]
        assert (gate.sim, gate.frames, gate.up) == (m.sim, (m.frame,), m.up)
        assert gate.chains[0][:len(m.chain)] == m.chain, mode
    assert demo.MODES["l1"].gate == "test_4x_two_pass_bundled_psnr_floor"
    assert demo.MODES["gan"].gate == "test_4x_gan_ema_demo_pair_psnr_floor"
    assert {demo.MODES[k].gate for k in ("8x", "8x3")} == {
        "test_8x_progressive_bundled_psnr_floor"}
    assert [len(demo.MODES[k].chain) for k in ("l1", "gan", "8x", "8x3")] \
        == [2, 2, 2, 3]


def _crop(mode):
    m = demo.MODES[mode]
    lr, gt = quality.read_frame(m.sim, m.frame)
    n = CROP * m.up
    return (np.ascontiguousarray(lr[:CROP, :CROP, :CROP]),
            np.ascontiguousarray(gt[:n, :n, :n]))


def _jax_strip(tri, out, gt):
    """examples/demo.py:89-93."""
    mid = gt.shape[2] // 2

    def sl(a):
        return np.clip(a[:, :, mid, 0][::-1] * 255 / max(gt.max(), 1e-6),
                       0, 255).astype(np.uint8)
    return np.concatenate([sl(tri), sl(out), sl(gt)], axis=1)


@pytest.mark.parametrize("mode", sorted(demo.MODES))
def test_demo_on_a_crop_equals_quality_and_jax(mode):
    import jax
    import jax.numpy as jnp
    from mpgan_tpu.infer import assemble as JA
    from mpgan_tpu.utils import metrics as JM

    m = demo.MODES[mode]
    lr, gt = _crop(mode)
    res = demo.upscale_frame(mode, lr, gt, "cpu")
    chain = quality.load_chain(m.chain, "cpu")
    want = quality.upscale(chain, torch.from_numpy(lr), m.up, len(m.chain))
    assert res["out"].shape == gt.shape == (CROP * m.up,) * 3 + (1,)
    np.testing.assert_array_equal(res["out"], want.numpy())
    tri = np.asarray(jax.image.resize(jnp.asarray(lr[..., :1]), gt.shape,
                                      "linear"))
    np.testing.assert_allclose(res["tri"], tri, rtol=0, atol=TOL)
    for key, a in (("psnr", res["out"]), ("psnr_tri", tri)):
        assert abs(res[key] - JA.psnr_volume(a, gt)) <= TOL, key
    for key, a in (("ssim", res["out"]), ("ssim_tri", tri)):
        # mpgan_tpu's ssim_volume blurs in float32, where E[x²] − E[x]²
        # cancels (tests/test_torch_metrics.py): its algorithm in float64
        # within TOL, the function itself within that file's 2e-4
        with jax.enable_x64(True):
            exact = _ssim_reference_float64(a, gt)
        assert abs(res[key] - exact) <= TOL, (key, res[key], exact)
        assert abs(res[key] - JM.ssim_volume(a, gt)) <= 2e-4, key
    np.testing.assert_array_equal(res["strip"],
                                  _jax_strip(res["tri"], res["out"], gt))
    assert res["label"] == " + ".join(m.chain)


def test_device_cpu_runs_and_writes_the_strip(monkeypatch, tmp_path,
                                              capsys):
    crop = _crop("8x3")
    monkeypatch.setattr(quality, "read_frame", lambda sim, frame: crop)
    monkeypatch.chdir(tmp_path)
    res = demo.main(["8x3", "device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"model (g1_gan8 + g2_gan8 + g3_l18): PSNR "
                      f"{res['psnr']:.2f} dB  SSIM {res['ssim']:.4f}")
    assert out[1].startswith("trilinear baseline:      PSNR ")
    assert out[2] == "wrote demo_out.png  [trilinear | model | ground truth]"
    png = preview.decode_png((tmp_path / "demo_out.png").read_bytes())
    assert png.shape == (64, 3 * 64)
    np.testing.assert_array_equal(png, res["strip"])


def test_without_a_card_the_demo_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the demo runs on it")
    for argv in ([], ["gan"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            demo.main(argv)
    for argv in (["4x"], ["l1", "device"], ["l1", "cpu"]):
        with pytest.raises(SystemExit):
            demo.main(argv)
