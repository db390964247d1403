"""Weights → generator loading, and LR input frames as the trainer saw them.

Counterpart of ``mpgan_tpu/infer/load.py``. The JAX package restores orbax
run dirs (``test_%04d/gen_%04d``); the port reads the ``.npz`` exports of
:mod:`mpgan_torch.convert` instead (its own checkpoint format arrives with
the trainer). What carries over: the input-channel rule and the mid-growth
stage from the sidecar.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from mpgan_torch import convert
from mpgan_torch.data import loader
from mpgan_torch.device import resolve_device
from mpgan_torch.io import uni
from mpgan_torch.models import generator as G

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights")


def bundled_weights(name: str) -> str:
    """Path of a weight file shipped with the package, e.g. ``g1_l1_4x``."""
    return os.path.join(WEIGHTS_DIR, f"{name}.npz")


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def input_channels(cfg, pass_no: int) -> int:
    """Pass 1 sees the full LR stack (d + vel + vorticity → up to 7
    channels); passes 2/3 see [density, velocity] only."""
    c_in = 1
    if cfg.data.use_velocities:
        c_in += 3
        if cfg.data.use_vorticities and pass_no == 1:
            c_in += 3
    return c_in


def load_generator_npz(path: str, pass_no: int, cfg,
                       device=None) -> G.Generator:
    """Build the pass-``pass_no`` generator of ``cfg`` and load ``path``.

    A mid-growth export (sidecar ``stage`` below ``cfg.model.stages``) is
    rebuilt with that many stages; its factor is then 2^stage. The model
    computes in ``cfg.model.dtype`` and returns that dtype.
    """
    dev = resolve_device(device)
    flat, meta = convert.load_npz(path)
    if int(meta["pass_no"]) != pass_no:
        raise ValueError(f"{path} holds a pass-{meta['pass_no']} generator, "
                         f"not pass {pass_no}")
    mcfg = cfg.model
    stages = mcfg.stages
    saved_stage = int(meta["stage"])
    if pass_no != 3 and 1 <= saved_stage < stages:
        print(f"  {path}: mid-growth export (stage {saved_stage}/{stages}); "
              f"effective factor {2 ** saved_stage}x", file=sys.stderr)
        stages = saved_stage
    dtype = torch_dtype(mcfg.dtype)
    c_in = input_channels(cfg, pass_no)
    kw = dict(base_filters=mcfg.n_base_filters,
              n_res_blocks=mcfg.n_res_blocks, dtype=dtype, out_dtype=dtype,
              in_channels=c_in)
    if pass_no == 1:
        gen = G.make_pass1(stages, **kw)
    elif pass_no == 2:
        gen = G.make_pass2(stages, **kw)
    else:
        gen = G.make_pass3(**kw)
    gen.load_state_dict(convert.flax_to_state_dict(flat), strict=True)
    return gen.to(dev).eval().requires_grad_(False)


def read_uni_volume(path: str, mac_recenter: bool = False) -> np.ndarray:
    """Decode one .uni volume (pure-Python codec); with ``mac_recenter``,
    staggered MAC velocity grids (TypeMAC header bit) are averaged to cell
    centres and other grids pass through."""
    return uni.readUni(path, recenter=mac_recenter)[1]


def read_lr_frame(cfg, sim_dir: str, f: int) -> np.ndarray | None:
    """One LR input frame exactly as the training loader builds it:
    density (+ velocity) (+ vorticity of that velocity), (Z, Y, X, C)
    float32; None when the density file is absent."""
    dpath = os.path.join(sim_dir, loader.LOW_DENSITY % f)
    if not os.path.exists(dpath):
        return None
    chans = [read_uni_volume(dpath).astype(np.float32)]
    if cfg.data.use_velocities:
        vel = read_uni_volume(
            os.path.join(sim_dir, loader.LOW_VELOCITY % f),
            mac_recenter=cfg.data.mac_recenter).astype(np.float32)
        chans.append(vel)
        if cfg.data.use_vorticities:
            chans.append(loader.vorticity(vel))
    return np.concatenate(chans, axis=-1)
