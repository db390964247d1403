"""Quality evaluation of a trained pass chain — counterpart of
``scripts/eval.py``: PSNR, volumetric SSIM and the temporal coherence
``tdiff`` of super-resolved frames against the ground-truth HR frames, for
the model and for the trilinear baseline.

    python -m mpgan_torch.eval basePath data/ fromSim 1000 toSim 1000 \\
        frameMin 0 frameMax 20 upRes 4 useVelocities 1 \\
        load_model_test 0 load_model_no 4 [load_model_test2 1 \\
        load_model_no2 4] [load_model_test3 2] testPath runs/ [device cpu]

Prints one JSON line: ``frames``, ``psnr_mean``/``min``/``max``,
``trilinear_psnr_mean``, ``ssim_mean``, ``trilinear_ssim_mean``,
``two_pass``, ``three_pass`` and, with velocities, ``tdiff_mean`` and
``tdiff_gt_mean`` (mean |d_t − A(d_{t−1}; v_t)|, tempoGAN's T_diff; lower
is smoother; a missing frame breaks the temporal adjacency). Models load
from the port's run dirs (:func:`mpgan_torch.infer.load.load_pass_chain`);
the frames are read as training reads them
(:func:`mpgan_torch.infer.load.read_lr_frame`). Everything runs on the
card unless ``device cpu`` is given; ``compileCache`` is accepted and has
no effect.

SSIM is :func:`mpgan_torch.utils.metrics.ssim_volume`, computed in
float64: on 128³ frames it can read about 1e-4 below ``scripts/eval.py``'s,
whose float32 blur loses digits to cancellation in the variance.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from mpgan_torch import config as cfgmod
from mpgan_torch.data import loader
from mpgan_torch.device import resolve_device
from mpgan_torch.infer import assemble
from mpgan_torch.infer.load import (load_pass_chain, make_default_upscaler,
                                    read_lr_frame, read_uni_volume)
from mpgan_torch.ops.upsample import resize_volume
from mpgan_torch.ops.warp import advect_3d
from mpgan_torch.serve import _to_host
from mpgan_torch.utils import params as ph
from mpgan_torch.utils.metrics import ssim_volume


def main(argv=None) -> dict:
    if argv is not None:
        ph.setParams(argv)
    ph.getParam("compileCache", "")          # a JAX compile cache: no effect
    dev = resolve_device(ph.getParam("device", "cuda"))
    load_test2 = int(ph.getParam("load_model_test2", -1))
    load_no2 = int(ph.getParam("load_model_no2", -1))
    load_test3 = int(ph.getParam("load_model_test3", -1))
    load_no3 = int(ph.getParam("load_model_no3", -1))
    cfg = cfgmod.from_cli(None)

    chain = load_pass_chain(cfg, load_test2, load_no2, load_test3, load_no3,
                            device=dev)
    upscale = make_default_upscaler(cfg, chain, dev)
    s = cfg.data.up_res

    psnrs, psnrs_tri = [], []
    ssims, ssims_tri = [], []
    tdiffs, tdiffs_gt = [], []
    for sim in range(cfg.data.from_sim, cfg.data.to_sim + 1):
        sim_dir = os.path.join(cfg.data.base_path, f"sim_{sim:04d}")
        prev_out = prev_gt = None
        for f in range(cfg.infer.frame_min, cfg.infer.frame_max):
            hpath = os.path.join(sim_dir, loader.HIGH_DENSITY % f)
            lr_np = read_lr_frame(cfg, sim_dir, f)
            if lr_np is None or not os.path.exists(hpath):
                # a gap breaks temporal adjacency: the tdiff warp assumes
                # dt = 1 between the two frames it compares
                prev_out = prev_gt = None
                continue
            # widen on the host: a bf16 model returns a bf16 volume
            out_host = _to_host(upscale(lr_np))
            out = torch.from_numpy(out_host).to(dev)
            gt = torch.tensor(read_uni_volume(hpath), device=dev)
            lr = torch.from_numpy(lr_np).to(dev)
            z, y, x, _ = lr.shape
            hr_shape = (z * s, y * s, x * s)
            tri = resize_volume(lr[..., :1], hr_shape)
            psnrs.append(assemble.psnr_volume(out_host, gt))
            psnrs_tri.append(assemble.psnr_volume(tri, gt))
            ssims.append(ssim_volume(out, gt))
            ssims_tri.append(ssim_volume(tri, gt))
            if cfg.data.use_velocities and prev_out is not None:
                v_hr = resize_volume(lr[..., 1:4], hr_shape) * s
                warp_prev = advect_3d(prev_out, v_hr, 1.0)
                tdiffs.append(float((out - warp_prev).abs().mean()))
                warp_gt = advect_3d(prev_gt, v_hr, 1.0)
                tdiffs_gt.append(float((gt - warp_gt).abs().mean()))
            prev_out, prev_gt = out, gt

    if not psnrs:
        sys.exit(f"no evaluable frames: no (density_low, density_high) pairs "
                 f"for sims {cfg.data.from_sim}..{cfg.data.to_sim}, frames "
                 f"{cfg.infer.frame_min}..{cfg.infer.frame_max} under "
                 f"{cfg.data.base_path!r} — check basePath/sim/frame ranges")
    result = {
        "frames": len(psnrs),
        "psnr_mean": round(float(np.mean(psnrs)), 3),
        "psnr_min": round(float(np.min(psnrs)), 3),
        "psnr_max": round(float(np.max(psnrs)), 3),
        "trilinear_psnr_mean": round(float(np.mean(psnrs_tri)), 3),
        "ssim_mean": round(float(np.mean(ssims)), 4),
        "trilinear_ssim_mean": round(float(np.mean(ssims_tri)), 4),
        "two_pass": chain[1] is not None,
        "three_pass": chain[2] is not None,
    }
    if tdiffs:
        result["tdiff_mean"] = round(float(np.mean(tdiffs)), 5)
        result["tdiff_gt_mean"] = round(float(np.mean(tdiffs_gt)), 5)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
