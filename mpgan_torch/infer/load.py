"""Weights → generator loading, and LR input frames as the trainer saw them.

Counterpart of ``mpgan_tpu/infer/load.py``. The JAX package restores orbax
run dirs; the port's run dirs (``test_%04d/gen_%04d``, ``gen_ema_%04d``,
:mod:`mpgan_torch.train.checkpoint`) hold the same ``.npz`` + sidecar pair
as the exports of :mod:`mpgan_torch.convert`, so one loader serves both:
:func:`load_generator_npz` reads a file, :func:`load_generator` a run dir
(``-1`` discovery, ``useEma`` with its fallback, the mid-growth stage from
the ``model_%04d.json`` sidecar), :func:`load_pass_chain` the chain the
reference-style flags name. What carries over: the input-channel rule and
the mid-growth stage.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from mpgan_torch import convert
from mpgan_torch.data import loader
from mpgan_torch.device import resolve_device
from mpgan_torch.io import native, uni
from mpgan_torch.models import generator as G
from mpgan_torch.train import checkpoint as ckpt

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights")


def bundled_weights(name: str) -> str:
    """Path of a weight file shipped with the package, e.g. ``g1_l1_4x``."""
    return os.path.join(WEIGHTS_DIR, f"{name}.npz")


def bundled_names() -> list[str]:
    """Every generator shipped with the package: the exports of the 22
    bundles of ``examples/checkpoints``."""
    return sorted(n[:-4] for n in os.listdir(WEIGHTS_DIR)
                  if n.endswith(".npz"))


def load_bundled(name: str, dtype: str = "float32",
                 device=None) -> G.Generator:
    """A shipped generator by name (``g1_l1_4x``, ``g2_gan8``, ``g3_l18``,
    …), built as every bundle was trained (base 32, 2 res blocks) at the
    pass and factor its sidecar records: 2 stages at 4×, 3 at 8×."""
    from mpgan_torch.config import Config

    path = bundled_weights(name)
    meta = ckpt.read_json(convert.sidecar_path(path))
    if meta is None:
        raise FileNotFoundError(f"no shipped generator {name!r} "
                                f"(have {bundled_names()})")
    cfg = Config()
    cfg.data.up_res = int(meta["up_res"])          # 4 or 8
    cfg.model.stages = cfg.data.up_res.bit_length() - 1
    cfg.model.dtype = dtype
    return load_generator_npz(path, int(meta["pass_no"]), cfg, device)


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


def load_generator_npz(path: str, pass_no: int, cfg, device=None,
                       stage: int | None = None) -> G.Generator:
    """Build the pass-``pass_no`` generator of ``cfg`` and load ``path``.

    A mid-growth save (``stage``, by default the sidecar's, below
    ``cfg.model.stages``) is rebuilt with that many stages; its factor is
    then 2^stage. The model computes in ``cfg.model.dtype`` and returns
    that dtype.
    """
    dev = resolve_device(device)
    flat, meta = convert.load_npz(path)
    if int(meta["pass_no"]) != pass_no:
        raise ValueError(f"{path} holds a pass-{meta['pass_no']} generator, "
                         f"not pass {pass_no}")
    mcfg = cfg.model
    stages = mcfg.stages
    saved_stage = int(meta["stage"]) if stage is None else stage
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


def load_generator(cfg, pass_no: int, run_idx: int, model_no: int,
                   device=None) -> G.Generator:
    """The generator of a saved run (JAX ``:15-110``).

    ``run_idx``/``model_no`` name the ``test_%04d`` run dir under
    ``cfg.train.test_path`` and the checkpoint number; -1 takes the newest
    run and the newest ``model_%04d`` (else the newest ``gen_%04d``, for
    gen-only runs). With ``cfg.infer.use_ema`` the EMA weights
    (``gen_ema_%04d``) are preferred, falling back to the raw weights of a
    run trained without ``emaDecay``. The stage recorded in the
    ``model_%04d.json`` sidecar rebuilds a mid-growth checkpoint.
    """
    if run_idx < 0:
        newest = ckpt.latest_run_idx(cfg.train.test_path)
        if newest is None:
            raise FileNotFoundError(
                f"load_model_test not given and no test_%04d runs under "
                f"{cfg.train.test_path!r} to default to")
        run_idx = newest
    run = ckpt.run_dir(cfg.train.test_path, run_idx)
    if model_no < 0:
        latest = ckpt.latest_model_no(run)
        if latest is None:
            latest = ckpt.latest_gen_no(run)
        if latest is None:
            raise FileNotFoundError(
                f"no saved checkpoints in {run} (the run holds no "
                "model_%04d/gen_%04d: still training, or died before its "
                "first save?)")
        model_no = latest
    meta = ckpt.read_json(ckpt.model_dir(run, model_no) + ".json") or {}
    try:
        stage = int(meta["stage"])
    except (KeyError, TypeError, ValueError):
        stage = None  # no usable sidecar: the gen save's own stage
    path = ckpt.gen_path(run, model_no)
    if cfg.infer.use_ema:
        ema = ckpt.gen_path(run, model_no, "gen_ema")
        if os.path.exists(ema):
            path = ema
        else:
            print(f"  useEma: no gen_ema_{model_no:04d} in {run}; using "
                  "gen_", file=sys.stderr)
    return load_generator_npz(path, pass_no, cfg, device, stage=stage)


def load_pass_chain(cfg, load_test2: int = -1, load_no2: int = -1,
                    load_test3: int = -1, load_no3: int = -1, device=None):
    """The generator chain the reference-style flags name (JAX
    ``:113-130``): pass 1 from ``cfg.train.load_model_test/no``, passes 2
    and 3 from ``load_test2/no2`` and ``load_test3/no3`` (-1 = the pass is
    absent). → ``(gen1, gen2, gen3)``, None for an absent pass; a port
    generator owns its parameters."""
    gen1 = load_generator(cfg, 1, cfg.train.load_model_test,
                          cfg.train.load_model_no, device)
    gen2 = (load_generator(cfg, 2, load_test2, load_no2, device)
            if load_test2 >= 0 else None)
    gen3 = (load_generator(cfg, 3, load_test3, load_no3, device)
            if load_test3 >= 0 else None)
    return gen1, gen2, gen3


def make_default_upscaler(cfg, chain, device=None):
    """The volume upscaler over a loaded pass chain (JAX ``:133-144``):
    :func:`mpgan_torch.serve.make_upscaler`, a captured program per input
    shape on one card, eager over several cards and on the CPU."""
    from mpgan_torch import serve

    return serve.make_upscaler(chain, device, cfg.data.up_res,
                               cfg.infer.slice_chunk)


def read_uni_volume(path: str, mac_recenter: bool = False) -> np.ndarray:
    """Decode one .uni volume, with the native codec when it is built
    (:mod:`mpgan_torch.io.native`), else the pure-Python one; with
    ``mac_recenter``, staggered MAC velocity grids (TypeMAC header bit) are
    averaged to cell centres and other grids pass through."""
    use_native = native.available()
    arr = native.read(path) if use_native else uni.readUni(path)[1]
    if mac_recenter and arr.ndim == 4 and arr.shape[-1] == 3:
        gt = (native.read_gridtype(path) if use_native
              else uni.read_gridtype(path))
        if gt & uni.TYPE_MAC:
            arr = uni.recenter_mac(arr)
    return arr


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
