"""Zero-setup demo: the shipped generators on the bundled smoke frames —
counterpart of ``examples/demo.py``.

    python -m mpgan_torch.demo            # 4x: L1 pair, 32³ -> 128³
    python -m mpgan_torch.demo gan        # 4x with the GAN fine-tune's EMA G1
    python -m mpgan_torch.demo 8x         # 8x progressive GAN pair, 16³ -> 128³
    python -m mpgan_torch.demo 8x3        # 8x + the L1-trained yz refiner
    python -m mpgan_torch.demo l1 device cpu

Loads the exports of the bundles (``mpgan_torch/weights``), upscales the
bundled LR frame with the upscaler the server uses
(:func:`mpgan_torch.serve.make_upscaler`; one frame is its first use,
which runs eagerly, as a shape's first request does), prints PSNR and SSIM
against the bundled ground truth and against trilinear upsampling, and
writes the ``[trilinear | model | ground truth]`` mid-slice strip to
``demo_out.png`` in the working directory. It runs in bf16 on a card and
in float32 on the CPU, as the JAX demo does on its accelerator and the
CPU. Without a card it raises unless asked for the CPU.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

from mpgan_torch import quality, serve
from mpgan_torch.device import resolve_device
from mpgan_torch.infer import assemble
from mpgan_torch.ops.upsample import resize_volume
from mpgan_torch.utils import preview
from mpgan_torch.utils.metrics import ssim_volume

USAGE = "usage: python -m mpgan_torch.demo [l1|gan|8x|8x3] [device cpu]"
PNG = "demo_out.png"


@dataclass(frozen=True)
class Mode:
    """A demo mode: frame ``frame`` of ``sim`` upscaled ``up``× by the
    shipped generators ``chain`` (2 or 3 passes); ``gate`` names the
    quality gate (:data:`mpgan_torch.quality.GATES`) that holds the same
    chain on the same frame."""
    sim: str
    frame: int
    up: int
    chain: tuple[str, ...]
    gate: str


# examples/demo.py:39-70
MODES = {
    "l1": Mode("sim_1010", 12, 4, ("g1_l1", "g2_l1"),
               "test_4x_two_pass_bundled_psnr_floor"),
    "gan": Mode("sim_1010", 12, 4, ("g1_gan", "g2_l1"),
                "test_4x_gan_ema_demo_pair_psnr_floor"),
    "8x": Mode("sim_2010", 24, 8, ("g1_gan8", "g2_gan8"),
               "test_8x_progressive_bundled_psnr_floor"),
    "8x3": Mode("sim_2010", 24, 8, ("g1_gan8", "g2_gan8", "g3_l18"),
                "test_8x_progressive_bundled_psnr_floor"),
}


def strip(tri: np.ndarray, out: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """The ``[trilinear | model | ground truth]`` uint8 strip: each
    volume's x mid-slice, y up, on the ground truth's scale."""
    mid = gt.shape[2] // 2
    peak = float(gt.max())
    return np.concatenate([preview.norm_u8(a[:, :, mid, 0][::-1], peak)
                           for a in (tri, out, gt)], axis=1)


def upscale_frame(mode: str, lr: np.ndarray, gt: np.ndarray, device=None,
                  dtype: str | None = None) -> dict:
    """The demo's work on one LR frame ``lr`` (Z, Y, X, 4) and its ground
    truth ``gt``: → ``out`` and ``tri`` (float32 numpy), ``psnr``,
    ``ssim``, ``psnr_tri``, ``ssim_tri``, the ``strip`` and the chain's
    ``label``. ``dtype`` defaults to bf16 on a card, float32 on the CPU."""
    m = MODES[mode]
    dev = resolve_device(device)
    if dtype is None:
        dtype = "bfloat16" if dev.type == "cuda" else "float32"
    chain = quality.load_chain(m.chain, dev, dtype)
    upscale = serve.make_upscaler(chain, dev, up_res=m.up)
    lr_t = torch.from_numpy(np.ascontiguousarray(lr, np.float32)).to(dev)
    gt_t = torch.from_numpy(np.ascontiguousarray(gt, np.float32)).to(dev)
    with torch.inference_mode():
        out_t = upscale(lr)
        z, y, x, _ = lr.shape
        tri_t = resize_volume(lr_t[..., :1], (z * m.up, y * m.up, x * m.up))
    out, tri = serve._to_host(out_t), serve._to_host(tri_t)
    # scored on the device (SSIM widens a bf16 volume to float32 first)
    return {"out": out, "tri": tri,
            "psnr": assemble.psnr_volume(out, gt),
            "ssim": ssim_volume(out_t, gt_t),
            "psnr_tri": assemble.psnr_volume(tri, gt),
            "ssim_tri": ssim_volume(tri_t, gt_t),
            "strip": strip(tri, out, gt),
            "label": f"{m.chain[0]} + {' + '.join(m.chain[1:])}"}


def run(mode: str = "l1", device=None, dtype: str | None = None,
        png: str = PNG) -> dict:
    """Upscale ``mode``'s bundled frame, print the model's and the
    trilinear baseline's PSNR and SSIM, write the strip to ``png`` →
    :func:`upscale_frame`'s record."""
    if mode not in MODES:
        raise SystemExit(f"unknown mode {mode!r}; {USAGE}")
    m = MODES[mode]
    lr, gt = quality.read_frame(m.sim, m.frame)
    res = upscale_frame(mode, lr, gt, device, dtype)
    print(f"model ({res['label']}): PSNR {res['psnr']:.2f} dB"
          f"  SSIM {res['ssim']:.4f}")
    print(f"trilinear baseline:      PSNR {res['psnr_tri']:.2f} dB"
          f"  SSIM {res['ssim_tri']:.4f}")
    preview.save_png(png, res["strip"])
    print(f"wrote {png}  [trilinear | model | ground truth]")
    return res


def main(argv=None) -> dict:
    """``[mode] [device <dev>]`` → :func:`run`'s record."""
    args = list(sys.argv[1:] if argv is None else argv)
    mode = args.pop(0) if args and args[0] != "device" else "l1"
    device = None
    if args[:1] == ["device"] and len(args) == 2:
        device = args[1]
    elif args:
        raise SystemExit(f"unexpected arguments {args}; {USAGE}")
    return run(mode, device)


if __name__ == "__main__":
    main()
