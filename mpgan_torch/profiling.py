"""Where the PyTorch port's device time goes, on one CUDA card.

    python3 -m mpgan_torch.profiling [out.json]

Profiles (torch.profiler, CPU + CUDA activities) after warm-up:
- the main path: two-pass 4x 64³→256³ bf16 with the bundled 4x L1 pair,
  5 frames; the top 15 kernels by device time and the top 15 aten ops by
  inclusive device time (nested ops each list their children's time),
  and the device busy share (summed kernel time over the window's wall
  time); then the same frames and 32³→128³ ones eagerly and through the
  graphed upscaler (:func:`infer_profile`: busy share and host launches
  per frame);
- each warp kernel alone (single-field forward and backward, triplet
  forward and backward) at the trainer's shape (B=16, 64²) and at B=256,
  256², 100 calls each: device time per call against the host-side time
  per call;
- the train step of the flagship recipe (mpgan_torch.train.recipe: pass 1,
  4x, B=16, tile 16, temporal D, hinge + lazy R1 + TTUR + EMA, bf16), and
  the same recipe as a pass-3 refiner (64² full-resolution patches, the
  HR volumes as its input source), through Trainer.fit, stepping eagerly
  and replaying CUDA graphs, each after 17 warm-up steps (every program
  captured): first 16 steps without the profiler (wall ms per step
  between CUDA events; stepping eagerly also the host time of the warp
  path, forward and backward apart: the program's spans ``warp.align``
  and ``warp.bwd``, :mod:`mpgan_torch.tracing`), then 8 steps under the
  profiler (:func:`train_profile`: kernel time by name, device busy
  share, host launches per step, the warp kernels per step by name;
  stepping eagerly also the warp path's device launches and device time,
  forward and backward apart, from the same spans' ranges in the trace,
  the backward kernel's, which the trace leaves out of its range, by name
  and by its launch counter; and NCCL's kernels by name, which a rank of
  a process group runs). The profiler adds host cost to every op, so its
  busy share is a lower bound for the unprofiled run.

Prints one JSON object, and also writes it to ``out.json`` when a path is
given. Needs a card; imports no JAX. :func:`solver_profile` (a solver
step's busy share and host launches) serves ``chip_smoke.py`` phase 12d.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mpgan_torch import config, tracing
from mpgan_torch.data.pipeline import TileCreator
from mpgan_torch.infer import assemble, load
from mpgan_torch.ops import warp_kernel as wk
from mpgan_torch.train import loop, recipe

# the program's spans around the warp path's forward and backward
PROBE_RANGES = ("warp.align", "warp.bwd")
# the CUDA API calls (cuda* and cu*) that put work on a stream: a step's
# host launches
LAUNCH_CALLS = re.compile(
    r"cu(da)?(LaunchKernel\w*|GraphLaunch|Memcpy\w*Async|Memset\w*Async)")
# the warp kernels as the trace names them → the names chip_smoke.py and
# PERF.md give them (a forward runs one thread per pixel, warp2d_kernel or
# warp2d_triplet_kernel, or in tiles, warp2d_fwd_kernel<fields>)
WARP_TRACE_NAMES = (("warp2d_triplet_kernel", "warp2d_triplet"),
                    ("warp2d_fwd_kernel<2", "warp2d_triplet"),
                    ("warp2d_bwd_kernel<2", "warp2d_triplet_bwd"),
                    ("warp2d_bwd_kernel<1", "warp2d_bwd"),
                    ("warp2d_fwd_kernel<1", "warp2d"),
                    ("warp2d_kernel", "warp2d"))
# NCCL's kernels as the trace names them (a one-rank reduction is
# oneRankReduce)
NCCL_KERNELS = re.compile(r"nccl|onerankreduce", re.IGNORECASE)
# steps before a flagship window: every program has run and been captured
# (lazy R1 every 16 steps: the program with R1 is captured at step 16)
TRAIN_WARMUP = 17


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
    range (a span of :mod:`mpgan_torch.tracing`) is a span, not a kernel,
    and is left out."""
    kernels = sorted(((e.key, e.self_device_time_total, e.count)
                      for e in avgs
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda r: -r[1])
    ops = sorted(((e.key, e.device_time_total, e.count) for e in avgs
                  if e.key.startswith("aten::")), key=lambda r: -r[1])
    return kernels, ops, sum(r[1] for r in kernels)


def _table(rows, n, per="frame", k=15):
    return [{"name": name, f"device_ms_per_{per}": us / n / 1e3,
             f"calls_per_{per}": c / n} for name, us, c in rows[:k] if us > 0]


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


def warp_name(trace_name: str) -> str | None:
    """The warp kernel a trace's kernel name is, or None."""
    for key, name in WARP_TRACE_NAMES:
        if key in trace_name:
            return name
    return None


def _launches(avgs, n: int) -> dict[str, float]:
    """Host launch calls per unit (step or frame), by name."""
    return {e.key: e.count / n for e in avgs
            if e.device_type == torch.autograd.DeviceType.CPU
            and LAUNCH_CALLS.fullmatch(e.key)}


def _calls_profile(fn, n: int, per: str) -> dict:
    """Profile ``n`` calls of ``fn()`` → wall and kernel ms per call, the
    device busy share, host launches per call (by name and their sum) and
    device activities per call, the keys named per ``per``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    kernels, _, kern_us = _tables(avgs)
    launches = _launches(avgs, n)
    return {f"{per}s": n, f"wall_ms_per_{per}": wall_us / n / 1e3,
            f"kernel_ms_per_{per}": kern_us / n / 1e3,
            "device_busy_share": kern_us / wall_us,
            f"host_launches_per_{per}": sum(launches.values()),
            "host_launches_by_call": launches,
            f"device_activities_per_{per}": sum(r[2] for r in kernels) / n}


def infer_profile(frame, n: int) -> dict:
    """Profile ``n`` calls of ``frame()``, one upscaled frame each (after
    its warm-up; a graphed upscaler's program captured) → wall and kernel
    ms per frame, the device busy share, host launches per frame (by call
    and their sum) and device activities per frame."""
    return _calls_profile(frame, n, "frame")


def solver_profile(step, n: int) -> dict:
    """Profile ``n`` calls of ``step()``, one solver step (or datagen
    frame) each, after its warm-up (a graphed step's program captured) →
    wall and kernel ms per step, the device busy share, host launches per
    step (by call and their sum) and device activities per step: what a
    graph removes from the eager step's host side."""
    return _calls_profile(step, n, "step")


def train_profile(tr, it: int, n: int):
    """Profile ``n`` steps of the trainer ``tr`` from iteration ``it``
    (after its warm-up) → (summary, the profiler's events). The summary:
    wall and kernel ms per step, the device busy share, host launches per
    step (the calls that put work on a stream, by name, and their sum),
    device activities per step, the warp kernels per step and their
    device ms by name, NCCL's kernels per step and their device µs by
    name, and the top kernels and aten ops."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.fit(it + n, start_it=it, log_every=n)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    kernels, ops, kern_us = _tables(avgs)
    launches = _launches(avgs, n)
    warp: dict[str, float] = {}
    warp_ms: dict[str, float] = {}
    for name, us, count in kernels:
        if warp_name(name):
            k = warp_name(name)
            warp[k] = warp.get(k, 0) + count / n
            warp_ms[k] = warp_ms.get(k, 0) + us / n / 1e3
    nccl = {name: count / n for name, _, count in kernels
            if NCCL_KERNELS.search(name)}
    nccl_us = {name: us / n for name, us, _ in kernels
               if NCCL_KERNELS.search(name)}
    return {
        "steps": n, "wall_ms_per_step": wall_us / n / 1e3,
        "kernel_ms_per_step": kern_us / n / 1e3,
        "device_busy_share": kern_us / wall_us,
        "host_launches_per_step": sum(launches.values()),
        "host_launches_by_call": launches,
        "device_activities_per_step": sum(r[2] for r in kernels) / n,
        "warp_kernels_per_step": warp,
        "warp_kernel_device_ms_per_step": sum(warp_ms.values()),
        "warp_kernel_device_ms_by_name": warp_ms,
        "nccl_kernels_per_step": nccl,
        "nccl_kernel_device_us_per_step_by_name": nccl_us,
        "top_kernels": _table(kernels, n, "step"),
        "top_aten_ops": _table(ops, n, "step")}, prof.events()


def train_breakdown(dev, pass_no: int = 1, graphs: bool = False) -> dict:
    """The flagship train step of pass ``pass_no``, stepping eagerly or
    replaying CUDA graphs: unprofiled times, then a profile."""
    tc = TileCreator(recipe.synthetic_dataset(), 16, density_threshold=0.0,
                     device=dev)
    tr = loop.Trainer(recipe.flagship_config("bfloat16"), tc, device=dev,
                      pass_no=pass_no, graphs=graphs)
    it = TRAIN_WARMUP
    tr.fit(it, log_every=it)

    n = 16
    tracing.clear()
    with tracing.enable():
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tr.fit(it + n, start_it=it, log_every=n)
        end.record()
        torch.cuda.synchronize()
        it += n
    step_ms = start.elapsed_time(end) / n
    fwd_host_ms, bwd_host_ms = (
        sum(s["host_end_ns"] - s["host_start_ns"] for s in tracing.spans()
            if s["name"] == name) / 1e6 / n for name in PROBE_RANGES)
    tracing.clear()

    m = 8
    wk.launches = wk.bwd_launches = 0
    # a replay runs no Python: the spans, and their ranges, run only
    # where the trainer steps eagerly
    prof, events = train_profile(tr, it, m)
    fwd_us, fwd_n = _range_device(events, PROBE_RANGES[0])
    bwd_us, bwd_n = _range_device(events, PROBE_RANGES[1])
    # by name: the profiler leaves a launch made through ctypes in the
    # autograd engine's thread out of the range around it
    warp_bwd_ms = sum(v for k, v in prof["warp_kernel_device_ms_by_name"]
                      .items() if k.endswith("_bwd"))
    prof.update(
        warp_path_fwd_launches_per_step=fwd_n / m,
        warp_path_fwd_device_ms_per_step=fwd_us / m / 1e3,
        warp_path_bwd_launches_per_step=bwd_n / m,
        warp_path_bwd_device_ms_per_step=bwd_us / m / 1e3,
        warp_kernel_launches_per_step=wk.launches / m,
        warp_bwd_kernel_launches_per_step=wk.bwd_launches / m,
        warp_bwd_kernel_device_ms_per_step=warp_bwd_ms,
        warp_kernel_device_share=(prof["warp_kernel_device_ms_per_step"]
                                  / prof["kernel_ms_per_step"]))
    return {
        "recipe": f"flagship pass {pass_no} 4x, B=16 tile 16, bf16, "
                  "temporal D, hinge + lazy R1 (16) + TTUR + EMA",
        "graphs": tr.graphs,
        "unprofiled": {
            "steps": n, "ms_per_step": step_ms,
            "steps_per_s": 1e3 / step_ms, "samples_per_s": 16e3 / step_ms,
            "warp_path_fwd_host_ms_per_step": fwd_host_ms,
            "warp_path_bwd_host_ms_per_step": bwd_host_ms,
            "warp_path_host_share": (fwd_host_ms + bwd_host_ms) / step_ms},
        "profiled": prof}


def infer_turns(g1, g2, dev, n: int) -> dict:
    """The two-pass chain at 64³→256³ and 32³→128³ eagerly and through the
    graphed upscaler (three warm-up calls each: the program is captured),
    each profiled over ``n`` frames (:func:`infer_profile`)."""
    out = {}
    for size in (64, 32):
        lr = torch.from_numpy(np.random.default_rng(size).random(
            (size, size, size, 4), dtype=np.float32)).to(dev)
        graphed = assemble.make_graphed_upscaler(g1, g2, 4)

        def eager():
            with torch.inference_mode():
                return assemble.upscale_volume(g1, g2, lr, 4)
        for name, fn in (("eager", eager), ("graphed", lambda: graphed(lr))):
            for _ in range(3):
                fn()
            out[f"{size}^3_{name}"] = infer_profile(fn, n)
    return out


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
    result["main_path_eager_vs_graphed"] = infer_turns(g1, g2, dev, n)

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
                 "warp2d_bwd": lambda: wk.advect_2d_kernel_bwd(
                     gt[..., :1], f, v, 1.0),
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

    for graphs in (False, True):
        how = "graphed" if graphs else "eager"
        result[f"train_step_{how}"] = train_breakdown(dev, 1, graphs)
        result[f"train_step_pass3_{how}"] = train_breakdown(dev, 3, graphs)

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
