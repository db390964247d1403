"""Flax generator and discriminator parameters (as numpy) → torch
``state_dict``, and the ``.npz`` weight files the port reads.

The JAX package stores generators as orbax checkpoints, which the port
cannot read (it imports no JAX). ``scripts/export_torch_weights.py`` — a
JAX-side script the port never imports — restores a checkpoint and writes
its parameter tree here as flat ``stem/kernel``-style keys, with a JSON
sidecar (``pass_no``, ``stage``, ``up_res``). :func:`flax_to_state_dict`
is the one function that maps the JAX package's parameters into the port's;
:func:`state_dict_to_flax` is its inverse, with which the port's trainer
writes its generators in the same ``.npz`` layout, so that one weight
format serves export, training, inference and serving.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping

import numpy as np
import torch


def flatten_params(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested flax params → ``{"stem/kernel": array, ...}`` (a top-level
    ``params`` collection is unwrapped)."""
    if not prefix and set(tree) == {"params"}:
        tree = tree["params"]
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def flax_to_state_dict(params_np: dict) -> dict[str, torch.Tensor]:
    """Flax param tree (nested dict of numpy arrays, or its flat
    ``a/b/kernel`` form) → torch ``state_dict``.

    Conv kernels go HWIO → OIHW and Dense kernels (in, out) → (out, in);
    ``kernel`` becomes ``weight`` and ``/`` becomes ``.``
    (``block_0_0/conv1/kernel`` → ``block_0_0.conv1.weight``). This takes
    the generator's trees and the discriminators' (whose ``out`` is a
    Dense over an NHWC flatten, which the port's Discriminator flattens in
    the same order).
    """
    flat = (params_np if all(isinstance(v, np.ndarray)
                             for v in params_np.values())
            else flatten_params(params_np))
    sd = {}
    for key, arr in flat.items():
        *mod, leaf = key.split("/")
        if leaf == "kernel":
            if arr.ndim == 4:
                t = torch.from_numpy(np.array(arr.transpose(3, 2, 0, 1)))
            elif arr.ndim == 2:
                t = torch.from_numpy(np.array(arr.T))
            else:
                raise ValueError(f"{key}: expected an HWIO conv or (in, out) "
                                 f"dense kernel, got shape {arr.shape}")
            name = "weight"
        elif leaf == "bias":
            t = torch.from_numpy(np.array(arr))
            name = "bias"
        else:
            raise ValueError(f"unexpected flax leaf {key!r}")
        sd[".".join([*mod, name])] = t.to(torch.float32)
    return sd


def state_dict_to_flax(sd: Mapping[str, torch.Tensor]
                       ) -> dict[str, np.ndarray]:
    """Torch ``state_dict`` → flat flax params ``{"a/b/kernel": array}``:
    the exact inverse of :func:`flax_to_state_dict` (OIHW → HWIO,
    (out, in) → (in, out), ``weight`` → ``kernel``), float32."""
    flat = {}
    for key, t in sd.items():
        *mod, leaf = key.split(".")
        arr = t.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"{key}: expected an OIHW conv or (out, in) "
                                 f"dense weight, got shape {arr.shape}")
            leaf = "kernel"
        elif leaf != "bias":
            raise ValueError(f"unexpected state_dict entry {key!r}")
        flat["/".join([*mod, leaf])] = np.ascontiguousarray(arr)
    return flat


def sidecar_path(npz_path: str) -> str:
    return os.path.splitext(npz_path)[0] + ".json"


def save_npz(path: str, params_np: dict, meta: dict) -> None:
    """Write a flax param tree as flat ``a/b/kernel`` keys plus its sidecar
    (``meta`` must hold ``pass_no``, ``stage`` and ``up_res``)."""
    missing = {"pass_no", "stage", "up_res"} - set(meta)
    if missing:
        raise ValueError(f"sidecar lacks {sorted(missing)}")
    np.savez(path, **flatten_params(params_np))
    with open(sidecar_path(path), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.write("\n")


def load_npz(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """→ (flat ``a/b/kernel`` params, sidecar dict)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    with open(sidecar_path(path)) as f:
        meta = json.load(f)
    return flat, meta
