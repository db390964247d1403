"""Where the PyTorch port's device time goes, on one CUDA card.

    python3 -m mpgan_torch.profiling [out.json]

Profiles (torch.profiler, CPU + CUDA activities) after warm-up:
- the main path: two-pass 4x 64³→256³ bf16 with the bundled 4x L1 pair,
  5 frames; the top 15 kernels by device time and the top 15 aten ops by
  inclusive device time (nested ops each list their children's time),
  and the device busy share (summed kernel time over the window's wall
  time);
- the warp kernel alone at the trainer's shape (B=16, 64²) and at
  B=256, 256², 100 launches each: device time per launch, against the
  host-side time per call between CUDA events;
- the train step of the flagship recipe (mpgan_torch.train.recipe: pass 1,
  4x, B=16, tile 16, temporal D, hinge + lazy R1 + TTUR + EMA, bf16),
  through Trainer.fit after 3 warm-up steps: first 16 steps without the
  profiler (wall ms per step between CUDA events, and the host time spent
  inside the warp wrapper, timed by wrapping it), then 8 steps under the
  profiler (kernel time by name, the warp kernel's device time and
  launches, device busy share). The profiler adds host cost to every op,
  so its busy share is a lower bound for the unprofiled run.

Prints one JSON object, and also writes it to ``out.json`` when a path is
given. Needs a card; imports no JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mpgan_torch import config
from mpgan_torch.data.pipeline import TileCreator
from mpgan_torch.infer import assemble, load
from mpgan_torch.ops import warp_kernel as wk
from mpgan_torch.train import loop, recipe


def profiled(fn, n):
    """Profile ``n`` calls of ``fn`` → (kernels by self device µs, aten ops
    by inclusive device µs, summed kernel µs, window wall µs). Rows are
    (name, µs, count)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    kernels = sorted(((e.key, e.self_device_time_total, e.count)
                      for e in avgs
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda r: -r[1])
    ops = sorted(((e.key, e.device_time_total, e.count) for e in avgs
                  if e.key.startswith("aten::")), key=lambda r: -r[1])
    return kernels, ops, sum(r[1] for r in kernels), wall_us


def _table(rows, n, per="frame", k=15):
    return [{"name": name, f"device_ms_per_{per}": us / n / 1e3,
             f"calls_per_{per}": c / n} for name, us, c in rows[:k] if us > 0]


def train_breakdown(dev) -> dict:
    """The flagship train step: unprofiled times, then a profile."""
    tc = TileCreator(recipe.synthetic_dataset(), 16, density_threshold=0.0,
                     device=dev)
    tr = loop.Trainer(recipe.flagship_config("bfloat16"), tc, device=dev)
    tr.fit(3, log_every=3)
    it = 3

    kernel_fn = wk.advect_2d_kernel
    host_s = [0.0]

    def timed_kernel(*a, **k):
        t = time.perf_counter()
        try:
            return kernel_fn(*a, **k)
        finally:
            host_s[0] += time.perf_counter() - t

    n = 16
    wk.advect_2d_kernel = timed_kernel
    try:
        wk.launches = 0
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tr.fit(it + n, start_it=it, log_every=n)
        end.record()
        torch.cuda.synchronize()
        it += n
    finally:
        wk.advect_2d_kernel = kernel_fn
    step_ms = start.elapsed_time(end) / n
    warp_host_ms = host_s[0] * 1e3 / n

    m = 8
    wk.launches = 0
    kernels, ops, kern_us, wall_us = profiled(
        lambda: tr.fit(it + m, start_it=it, log_every=m), 1)
    warp = [r for r in kernels if "warp2d_kernel" in r[0]]
    warp_us = sum(r[1] for r in warp)
    return {
        "recipe": "flagship pass 1 4x, B=16 tile 16, bf16, temporal D, "
                  "hinge + lazy R1 (16) + TTUR + EMA",
        "unprofiled": {
            "steps": n, "ms_per_step": step_ms,
            "steps_per_s": 1e3 / step_ms, "samples_per_s": 16e3 / step_ms,
            "warp_host_ms_per_step": warp_host_ms,
            "warp_host_share": warp_host_ms / step_ms},
        "profiled": {
            "steps": m, "wall_ms_per_step": wall_us / m / 1e3,
            "kernel_ms_per_step": kern_us / m / 1e3,
            "device_busy_share": kern_us / wall_us,
            "kernel_launches_per_step": sum(r[2] for r in kernels) / m,
            "warp_launches_per_step": wk.launches / m,
            "warp_device_ms_per_step": warp_us / m / 1e3,
            "warp_device_share": warp_us / kern_us,
            "top_kernels": _table(kernels, m, "step"),
            "top_aten_ops": _table(ops, m, "step")}}


def main():
    if not torch.cuda.is_available():
        print("mpgan_torch.profiling: needs a CUDA card", file=sys.stderr)
        return 2
    out_path = sys.argv[1] if len(sys.argv) > 1 else None
    dev = torch.device("cuda")
    cfg = config.Config()
    g1 = load.load_generator_npz(load.bundled_weights("g1_l1_4x"), 1, cfg, dev)
    g2 = load.load_generator_npz(load.bundled_weights("g2_l1_4x"), 2, cfg, dev)
    lr = torch.from_numpy(np.random.default_rng(0).random(
        (64, 64, 64, 4), dtype=np.float32)).to(dev)
    n = 5
    with torch.inference_mode():
        for _ in range(3):
            assemble.upscale_volume(g1, g2, lr, 4)
        kernels, ops, kern_us, wall_us = profiled(
            lambda: assemble.upscale_volume(g1, g2, lr, 4), n)
    result = {"main_path": {
        "frames": n, "wall_ms_per_frame": wall_us / n / 1e3,
        "kernel_ms_per_frame": kern_us / n / 1e3,
        "device_busy_share": kern_us / wall_us,
        "top_kernels": _table(kernels, n), "top_aten_ops": _table(ops, n)}}

    result["warp"] = []
    for b, h, w in ((16, 64, 64), (256, 256, 256)):
        g = torch.Generator(device=dev).manual_seed(0)
        f = torch.rand((b, h, w, 1), generator=g, device=dev)
        v = torch.randn((b, h, w, 2), generator=g, device=dev) * 1.5
        for _ in range(10):
            wk.advect_2d_kernel(f, v, 1.0)
        launches = 100
        kernels, _, kern_us, wall_us = profiled(
            lambda: wk.advect_2d_kernel(f, v, 1.0), launches)
        warp_us = sum(us for k, us, _ in kernels if "warp2d_kernel" in k)
        result["warp"].append({
            "shape": [b, h, w],
            "device_us_per_launch": warp_us / launches,
            "wall_us_per_call": wall_us / launches,
            "device_busy_share": kern_us / wall_us})

    result["train_step"] = train_breakdown(dev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    result["card"] = smi.stdout.strip().splitlines()[0]
    result["torch"] = torch.__version__
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
