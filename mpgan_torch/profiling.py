"""Where the PyTorch port's device time goes, on one CUDA card.

    python3 -m mpgan_torch.profiling [out.json]

Profiles (torch.profiler, CPU + CUDA activities) after warm-up:
- the main path: two-pass 4x 64³→256³ bf16 with the bundled 4x L1 pair,
  5 frames; the top 15 kernels by device time and the top 15 aten ops by
  inclusive device time (nested ops each list their children's time),
  and the device busy share (summed kernel time over the window's wall
  time);
- each warp kernel alone (single-field forward, triplet forward, triplet
  backward) at the trainer's shape (B=16, 64²) and at B=256, 256², 100
  calls each: device time per call against the host-side time per call;
- the train step of the flagship recipe (mpgan_torch.train.recipe: pass 1,
  4x, B=16, tile 16, temporal D, hinge + lazy R1 + TTUR + EMA, bf16),
  through Trainer.fit after 3 warm-up steps: first 16 steps without the
  profiler (wall ms per step between CUDA events, and the host time of
  the warp path, forward and backward apart, timed by wrapping them:
  :func:`warp_path_probe`), then 8 steps under the profiler (kernel time
  by name, device busy share, and the warp path's device launches and
  device time, forward and backward apart, from ``record_function``
  ranges around the same wrapped calls; the backward kernel's, which the
  trace leaves out of its range, by name and by its launch counter).
  The profiler adds host cost to every op, so its busy share is a lower
  bound for the unprofiled run.

Prints one JSON object, and also writes it to ``out.json`` when a path is
given. Needs a card; imports no JAX.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mpgan_torch import config
from mpgan_torch.data.pipeline import TileCreator
from mpgan_torch.infer import assemble, load
from mpgan_torch.ops import warp_kernel as wk
from mpgan_torch.train import loop, losses, recipe

# record_function ranges of warp_path_probe
PROBE_RANGES = ("warp_path_fwd", "warp_path_bwd")


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
    return (*_tables(prof.key_averages()), wall_us)


def _tables(avgs):
    """key_averages → (kernels by self device µs, aten ops by inclusive
    device µs, summed kernel µs). The device side of a ``record_function``
    range (:func:`warp_path_probe`) is a span, not a kernel, and is left
    out."""
    kernels = sorted(((e.key, e.self_device_time_total, e.count)
                      for e in avgs
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.key not in PROBE_RANGES),
                     key=lambda r: -r[1])
    ops = sorted(((e.key, e.device_time_total, e.count) for e in avgs
                  if e.key.startswith("aten::")), key=lambda r: -r[1])
    return kernels, ops, sum(r[1] for r in kernels)


def _table(rows, n, per="frame", k=15):
    return [{"name": name, f"device_ms_per_{per}": us / n / 1e3,
             f"calls_per_{per}": c / n} for name, us, c in rows[:k] if us > 0]


@contextlib.contextmanager
def warp_path_probe(ranges: bool):
    """Wrap the train step's warp path while the block runs: its forward
    (``losses.align_triplet``, the whole alignment of a triplet) and the
    backward of the warp's autograd Functions. Yields the host seconds
    spent inside each, ``{"fwd": s, "bwd": s}``; with ``ranges`` every call
    also runs inside a ``record_function`` range ``warp_path_fwd`` /
    ``warp_path_bwd``, which the profiler's trace attributes the device
    work to."""
    host = {"fwd": 0.0, "bwd": 0.0}

    def wrap(fn, key):
        name = f"warp_path_{key}"

        def wrapped(*a, **k):
            t = time.perf_counter()
            try:
                if ranges:
                    with record_function(name):
                        return fn(*a, **k)
                return fn(*a, **k)
            finally:
                host[key] += time.perf_counter() - t
        return wrapped

    fns = (wk.AdvectFast, wk.AlignTripletFast)
    saved = [(losses, "align_triplet", losses.align_triplet)] + [
        (c, "backward", c.__dict__["backward"]) for c in fns]
    losses.align_triplet = wrap(losses.align_triplet, "fwd")
    for c in fns:
        c.backward = staticmethod(wrap(c.backward, "bwd"))
    try:
        yield host
    finally:
        for obj, attr, val in saved:
            setattr(obj, attr, val)


def _range_device(events, name) -> tuple[float, int]:
    """(device µs, device activities) launched inside every CPU range
    ``name`` of a trace, children included."""
    def walk(e):
        us = sum(k.duration for k in e.kernels)
        n = len(e.kernels)
        for ch in e.cpu_children:
            c_us, c_n = walk(ch)
            us, n = us + c_us, n + c_n
        return us, n
    us, n = 0.0, 0
    for e in events:
        if e.name == name and e.device_type == torch.autograd.DeviceType.CPU:
            e_us, e_n = walk(e)
            us, n = us + e_us, n + e_n
    return us, n


def train_breakdown(dev) -> dict:
    """The flagship train step: unprofiled times, then a profile."""
    tc = TileCreator(recipe.synthetic_dataset(), 16, density_threshold=0.0,
                     device=dev)
    tr = loop.Trainer(recipe.flagship_config("bfloat16"), tc, device=dev)
    tr.fit(3, log_every=3)
    it = 3

    n = 16
    with warp_path_probe(ranges=False) as host:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tr.fit(it + n, start_it=it, log_every=n)
        end.record()
        torch.cuda.synchronize()
        it += n
    step_ms = start.elapsed_time(end) / n
    fwd_host_ms = host["fwd"] * 1e3 / n
    bwd_host_ms = host["bwd"] * 1e3 / n

    m = 8
    wk.launches = wk.bwd_launches = 0
    with warp_path_probe(ranges=True):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.fit(it + m, start_it=it, log_every=m)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    kernels, ops, kern_us = _tables(prof.key_averages())
    fwd_us, fwd_n = _range_device(events, "warp_path_fwd")
    bwd_us, bwd_n = _range_device(events, "warp_path_bwd")
    warp_us = sum(r[1] for r in kernels if "warp2d" in r[0])
    # by name: the profiler leaves a launch made through ctypes in the
    # autograd engine's thread out of the range around it
    warp_bwd_us = sum(r[1] for r in kernels if "warp2d_bwd" in r[0])
    return {
        "recipe": "flagship pass 1 4x, B=16 tile 16, bf16, temporal D, "
                  "hinge + lazy R1 (16) + TTUR + EMA",
        "unprofiled": {
            "steps": n, "ms_per_step": step_ms,
            "steps_per_s": 1e3 / step_ms, "samples_per_s": 16e3 / step_ms,
            "warp_path_fwd_host_ms_per_step": fwd_host_ms,
            "warp_path_bwd_host_ms_per_step": bwd_host_ms,
            "warp_path_host_share": (fwd_host_ms + bwd_host_ms) / step_ms},
        "profiled": {
            "steps": m, "wall_ms_per_step": wall_us / m / 1e3,
            "kernel_ms_per_step": kern_us / m / 1e3,
            "device_busy_share": kern_us / wall_us,
            "kernel_launches_per_step": sum(r[2] for r in kernels) / m,
            "warp_path_fwd_launches_per_step": fwd_n / m,
            "warp_path_fwd_device_ms_per_step": fwd_us / m / 1e3,
            "warp_path_bwd_launches_per_step": bwd_n / m,
            "warp_path_bwd_device_ms_per_step": bwd_us / m / 1e3,
            "warp_kernel_launches_per_step": wk.launches / m,
            "warp_bwd_kernel_launches_per_step": wk.bwd_launches / m,
            "warp_kernel_device_ms_per_step": warp_us / m / 1e3,
            "warp_bwd_kernel_device_ms_per_step": warp_bwd_us / m / 1e3,
            "warp_kernel_device_share": warp_us / kern_us,
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
        p, c, f = (torch.rand((b, h, w, 1), generator=g, device=dev)
                   for _ in range(3))
        v = torch.randn((b, h, w, 2), generator=g, device=dev) * 1.5
        # the gradient as Dt's backward hands it over: NCHW strides
        gt = torch.randn((b, 3, h, w), generator=g,
                         device=dev).permute(0, 2, 3, 1)
        calls = {"warp2d": lambda: wk.advect_2d_kernel(f, v, 1.0),
                 "warp2d_triplet": lambda: wk.align_triplet_kernel(p, c, f, v),
                 "warp2d_triplet_bwd": lambda: wk.align_triplet_kernel_bwd(
                     gt, p, f, v)}
        for name, fn in calls.items():
            for _ in range(10):
                fn()
            n_calls = 100
            kernels, _, kern_us, wall_us = profiled(fn, n_calls)
            result["warp"].append({
                "kernel": name, "shape": [b, h, w],
                "device_us_per_call": kern_us / n_calls,
                "device_activities_per_call":
                    sum(r[2] for r in kernels) / n_calls,
                "wall_us_per_call": wall_us / n_calls,
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
