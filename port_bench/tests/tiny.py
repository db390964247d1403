"""Tiny cells for the CPU tests: the benchmark's drivers at a size a test
run holds, with the program's CUDA-graph primitive replaced by a stand-in
that runs the captured function again at every replay (the CPU has no CUDA
graphs)."""

from __future__ import annotations

import copy
import json
import os
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


class EagerGraph:
    """``mpgan_torch.train.graphed.Graph``'s stand-in on the CPU."""

    @staticmethod
    def available(device):
        return True

    def __init__(self, fn, device, generator=None):
        self.fn = fn
        held = None if generator is None else generator.get_state()
        self.out = fn()
        if held is not None:
            generator.set_state(held)
        self.launches = (0, 0)

    def replay(self):
        new = self.fn()
        if isinstance(new, torch.Tensor):
            self.out.copy_(new)
        elif isinstance(new, dict):
            for k, v in new.items():
                if isinstance(v, torch.Tensor):
                    self.out[k].copy_(v)
        else:
            for o, n in zip(self.out, new, strict=True):
                o.copy_(n)
        return self.out

    def reset(self):
        self.out = None


def load(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH, kind, f"{name}.json")) as fh:
        return json.load(fh)


def tiny_config(dtype: str = "float32") -> dict:
    """mpgan-4x's configuration at a tiny size: base width 8, tiles of 4 LR
    pixels, batch 4."""
    cfg = copy.deepcopy(load("configs", "mpgan-4x"))
    cfg["dtype"] = dtype
    for g in ("generator_pass1", "generator_pass2"):
        cfg[g]["base_filters"] = 8
    for d in ("spatial_disc", "temporal_disc"):
        cfg[d].update(in_hw=[16, 16], base_filters=8)
    cfg["recipe"].update(batch=4, tile_lr=4)
    return cfg


def tiny_traffic(kind: str) -> dict:
    tr = dict(load("traffic", kind))
    if kind in ("frames", "frames-4card"):
        tr.update(lr_size=8, n_frames=3, check_frames=1, check_span=2,
                  ref_block=4)
    elif kind == "train":
        tr.update(n_sims=1, n_frames=4, lr_size=8)
    return tr


def context(kind: str, seed: int = 12345, seconds: float = 0.3,
            devices=None, dtype: str = "float32") -> dict:
    if devices is None:
        devices = [torch.device("cpu")]
    return {"seed": seed, "seconds": seconds, "trace": False,
            "config": tiny_config(dtype), "traffic": tiny_traffic(kind),
            "cell": {}, "devices": devices, "t0": time.perf_counter()}
