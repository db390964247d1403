"""The quality gates of ``tests/test_quality.py``, run by the port.

Each gate upscales a bundled held-out frame of ``examples/data`` with
generators shipped in ``mpgan_torch/weights`` (the exports of the bundles
of ``examples/checkpoints``) and holds PSNR, SSIM or the temporal
coherence ``tdiff`` to the JAX gate's floors, at the same frames and with
the same floors. :data:`GATES` maps each JAX gate's name to its frames,
its pass chains and its floors; :func:`run_gate` runs one on a device in
float32 with TF32 off and returns every value beside its floor.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

import numpy as np
import torch

from mpgan_torch.device import resolve_device
from mpgan_torch.infer import assemble, load
from mpgan_torch.io import uni
from mpgan_torch.ops.upsample import resize_volume
from mpgan_torch.ops.warp import advect_3d
from mpgan_torch.utils.metrics import ssim_volume

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "data")


@dataclass(frozen=True)
class Gate:
    """One gate: ``chains`` of shipped generator names (2 or 3 passes)
    upscale frame(s) ``frames`` of ``sim`` at ``up``×; each floor
    ``(value, minus, op, bound)`` reads ``value − minus op bound`` over the
    chain's values (``minus`` None = 0). Values: ``psnr``/``ssim`` of two
    passes, ``psnr3``/``ssim3`` with the third, ``tri``/``ssim_tri`` of
    the trilinear baseline, ``tdiff_ratio`` = tdiff / tdiff of the ground
    truth over consecutive frames."""
    sim: str
    frames: tuple[int, ...]
    up: int
    chains: tuple[tuple[str, ...], ...]
    floors: tuple[tuple[str, str | None, str, float], ...]


def _two_pass_floors(over_tri, psnr=None, ssim_over_tri=None, ssim=None):
    out = [("psnr", "tri", ">=", over_tri)]
    if psnr is not None:
        out.append(("psnr", None, ">=", psnr))
    if ssim_over_tri is not None:
        out.append(("ssim", "ssim_tri", ">=", ssim_over_tri))
    if ssim is not None:
        out.append(("ssim", None, ">=", ssim))
    return tuple(out)


# tests/test_quality.py, gate by gate (the line of each JAX gate)
GATES = {
    "test_4x_two_pass_bundled_psnr_floor": Gate(                    # :67
        "sim_1010", (12,), 4, (("g1_l1", "g2_l1"),),
        _two_pass_floors(4.0, 34.0, 0.02, 0.985)),
    "test_4x_canonical_twopass_l1_bundled_floor": Gate(             # :174
        "sim_1010c", (12,), 4, (("g1_l1_4x", "g2_l1_4x"),),
        _two_pass_floors(5.0, 34.5, 0.02, 0.985)),
    "test_4x_canonical_ganft_bundled_floor": Gate(                  # :188
        "sim_1010c", (12,), 4, (("g1_ganft_4x", "g2_l1_4x"),
                                ("g1_ganft_ema_4x", "g2_l1_4x")),
        _two_pass_floors(5.0, 34.0, 0.02)),
    "test_4x_canonical_scratch_bundled_floor": Gate(                # :200
        "sim_1010c", (12,), 4, (("g1_scratch_4x", "g2_scratch_4x"),),
        _two_pass_floors(5.0, 34.0, 0.02)),
    "test_4x_canonical_threepass_bundled_floor": Gate(              # :211
        "sim_1010c", (12,), 4, (("g1_l1_4x", "g2_l1_4x", "g3_l1p3_4x"),),
        (("psnr3", "tri", ">=", 5.0), ("psnr3", "psnr", ">=", -0.2))),
    "test_4x_gan_ema_demo_pair_psnr_floor": Gate(                   # :235
        "sim_1010", (12,), 4, (("g1_gan", "g2_l1"),),
        _two_pass_floors(4.0, 34.0, 0.02)),
    "test_4x_diverse_model_temporal_coherence": Gate(               # :269
        "sim_3020", (29, 30, 31), 4, (("g1_div", "g2_div"),),
        (("tdiff_ratio", None, ">=", 0.45),
         ("tdiff_ratio", None, "<=", 1.35))),
    "test_4x_diverse_model_ood_generalization_floor": Gate(         # :295
        "sim_3020", (30,), 4, (("g1_div", "g2_div"),),
        _two_pass_floors(2.0, None, 0.0)),
    "test_8x_canonical_twopass_l1_bundled_floor": Gate(             # :318
        "sim_2010c", (24,), 8, (("g1_l1_8x", "g2_l1_8x"),),
        _two_pass_floors(3.5, 26.0, 0.10)),
    "test_8x_canonical_ganft_bundled_floor": Gate(                  # :330
        "sim_2010c", (24,), 8, (("g1_ganft_8x", "g2_l1_8x"),
                                ("g1_ganft_ema_8x", "g2_l1_8x")),
        _two_pass_floors(3.0, 25.5, 0.10)),
    "test_8x_canonical_scratch_bundled_floor": Gate(                # :342
        "sim_2010c", (24,), 8, (("g1_scratch_8x", "g2_scratch_8x"),),
        _two_pass_floors(1.8, 24.0, 0.08)),
    "test_8x_canonical_threepass_bundled_floor": Gate(              # :356
        "sim_2010c", (24,), 8, (("g1_l1_8x", "g2_l1_8x", "g3_l1p3_8x"),),
        (("psnr3", "tri", ">=", 4.0), ("psnr3", "psnr", ">=", -0.1),
         ("psnr3", None, ">=", 26.5))),
    "test_8x_progressive_bundled_psnr_floor": Gate(                 # :381
        "sim_2010", (24,), 8, (("g1_gan8", "g2_gan8", "g3_l18"),),
        _two_pass_floors(2.0, 27.5, 0.05, 0.94)
        + (("psnr3", "psnr", ">=", -0.1), ("ssim3", "ssim", ">=", -0.005))),
}


@contextlib.contextmanager
def full_f32():
    """float32 convolutions and products without TF32, restored after."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def read_frame(sim: str, frame: int, data_dir: str = DATA_DIR):
    """→ (LR (Z, Y, X, 4) [density, velocity], HR ground truth
    (Z·s, Y·s, X·s, 1)) of a bundled frame, float32 numpy."""
    d = os.path.join(data_dir, sim)

    def read(stem):
        return uni.readUni(os.path.join(d, f"{stem}_{frame:04d}.uni"))[1]
    lr = np.concatenate([read("density_low"), read("velocity_low")], -1)
    return lr.astype(np.float32), read("density_high").astype(np.float32)


def upscale(chain, lr: torch.Tensor, up: int, passes: int) -> torch.Tensor:
    """``lr`` through the first ``passes`` generators of ``chain`` → the
    float32 HR volume on ``lr``'s device."""
    with torch.inference_mode():
        return assemble.upscale_volume(
            chain[0], chain[1], lr, up,
            gen3=chain[2] if passes == 3 else None).float()


def tdiff(vols, vels) -> float:
    """Mean over consecutive pairs of mean |d_t − A(d_{t−1}; v_t)| (the
    tempoGAN T_diff of ``scripts/eval.py:87-98``)."""
    return float(np.mean([
        float((vols[i] - advect_3d(vols[i - 1], vels[i], 1.0)).abs().mean())
        for i in range(1, len(vols))]))


def chain_values(gate: Gate, chain, device, data_dir: str = DATA_DIR
                 ) -> dict[str, float]:
    """Every value the gate's floors read, for one loaded chain."""
    up, passes = gate.up, len(chain) - (chain[2] is None)
    outs, gts, vels, vals = [], [], [], {}
    for f in gate.frames:
        lr_np, gt_np = read_frame(gate.sim, f, data_dir)
        lr = torch.from_numpy(lr_np).to(device)
        gt = torch.from_numpy(gt_np).to(device)
        hr_shape = tuple(s * up for s in lr.shape[:3])
        outs.append(upscale(chain, lr, up, 2))
        gts.append(gt)
        vels.append(resize_volume(lr[..., 1:4], hr_shape) * up)
    if len(gate.frames) > 1:
        vals["tdiff"] = tdiff(outs, vels)
        vals["tdiff_gt"] = tdiff(gts, vels)
        vals["tdiff_ratio"] = vals["tdiff"] / vals["tdiff_gt"]
        return vals
    out, gt = outs[0], gts[0]
    tri = resize_volume(lr[..., :1], hr_shape)
    vals.update(psnr=assemble.psnr_volume(out, gt),
                ssim=ssim_volume(out, gt),
                tri=assemble.psnr_volume(tri, gt),
                ssim_tri=ssim_volume(tri, gt))
    if passes == 3:
        out3 = upscale(chain, lr, up, 3)
        vals.update(psnr3=assemble.psnr_volume(out3, gt),
                    ssim3=ssim_volume(out3, gt))
    return vals


def load_chain(names, device, dtype: str = "float32"):
    gens = [load.load_bundled(n, dtype, device) for n in names]
    return tuple(gens + [None] * (3 - len(gens)))


def run_gate(name: str, device=None, data_dir: str = DATA_DIR) -> list[dict]:
    """Run gate ``name`` in float32 with TF32 off → one record per chain:
    ``{"gate", "chain", "values", "floors": [{"check", "value", "bound",
    "ok"}]}``."""
    gate = GATES[name]
    dev = resolve_device(device)
    records = []
    with full_f32():
        for names in gate.chains:
            vals = chain_values(gate, load_chain(names, dev), dev, data_dir)
            records.append({"gate": name, "chain": list(names),
                            "values": vals,
                            "floors": check_floors(gate.floors, vals)})
    return records


def check_floors(floors, vals: dict) -> list[dict]:
    """Each floor ``(value, minus, op, bound)`` (:class:`Gate`) read over
    ``vals`` → ``{"check", "value", "bound", "ok"}``."""
    out = []
    for key, minus, op, bound in floors:
        v = vals[key] - (vals[minus] if minus else 0.0)
        ok = v >= bound if op == ">=" else v <= bound
        check = f"{key} - {minus}" if minus else key
        out.append({"check": f"{check} {op} {bound:g}", "value": v,
                    "bound": bound, "ok": bool(ok)})
    return out

