"""The warp kernels and their wrappers in this tree against another tree's,
on one CUDA card, in one process, in turns (other, this, this, other).

    python3 -m mpgan_torch.warp_compare OTHER_ROOT [out.json]

``OTHER_ROOT`` is an unpacked tree of the repository, for example the
parent commit's (``git archive <commit> | tar -x -C OTHER_ROOT``). Its
``mpgan_torch/_build.py`` and ``ops/warp_kernel.py`` are loaded under
private names, so that its kernels are built from its own sources into its
own ``_build/``, and its ``chip_smoke.py`` gives its ``warp_times``. (Two
trees that both register the forward operators, ``torch.ops.mpgan_warp``,
cannot share a process: the second registration is refused.)

A torch.profiler session can leave later calls slower on the host (every
run measures it: ``host_us_before_and_after_profiler``), so the run has
two parts. First, without the profiler, in turns, for each of the four
wrappers at B=16 64² and B=256 256²: ``warp_times`` of that tree's
``chip_smoke.py`` (ms per call, the median of 5 windows of CUDA events,
with the plain version's, the library call's and the bound), and the host
µs per call of the wrapper and of the library call in alternation (this
tree's ``chip_smoke.host_us_pair``, the median of 5 rounds of 400
back-to-back calls); then, for this tree, the host µs of each piece of the
forward launchers at B=16 64² (:func:`launcher_split`, the median of 5
rounds). Then, with the profiler, in turns: the device µs per call of each
wrapper (:func:`mpgan_torch.profiling.profiled`, 100 calls); both trees'
forwards on the same inputs, their largest difference and whether their
bits agree; and for this tree the forwards' device µs with each tile of
:data:`FWD_TILE_SWEEP` forced in place of ``fwd_tile``'s choice
(:data:`FWD_SWEEP_SHAPES`; (0, 0) is one thread per pixel), and the
backwards' with each tile of :data:`TILE_SWEEP` in place of ``bwd_tile``'s.

Prints one JSON object, with the card's name and power limit, and writes it
to ``out.json`` when a path is given. Needs a card; imports no JAX.
"""

import importlib.util
import json
import os
import statistics
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from mpgan_torch import profiling
from mpgan_torch.ops import warp_kernel

ROOT = Path(__file__).resolve().parent.parent
SHAPES = ((16, 64, 64, 200), (256, 256, 256, 20))  # B, H, W, timed calls
ORDER = ("other", "this", "this", "other")
TILE_SWEEP = ((64, 64), (32, 64), (32, 32), (16, 64), (16, 32), (8, 64))
FWD_TILE_SWEEP = ((0, 0), (64, 64), (32, 64), (32, 32), (16, 64), (16, 32),
                  (8, 64), (8, 32), (4, 64))
# the two shapes and four between them, in 32x64 tiles: 4 x 256² (128
# blocks), 64 x 128² (512), 128 x 128² (1024), 64 x 256² (2048)
FWD_SWEEP_SHAPES = SHAPES + ((4, 256, 256, 20), (64, 128, 128, 20),
                             (128, 128, 128, 20), (64, 256, 256, 20))
DEVICE_CALLS = 100


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_tree(root: Path, tag: str):
    """(warp_kernel, chip_smoke) of the tree at ``root``, under private
    names; its warp_kernel builds its own csrc/warp.cu."""
    build = _load(f"_{tag}_build", root / "mpgan_torch" / "_build.py")
    wk = _load(f"_{tag}_warp_kernel",
               root / "mpgan_torch" / "ops" / "warp_kernel.py")
    wk._build, wk._lib = build, None
    return wk, _load(f"_{tag}_chip_smoke", root / "chip_smoke.py")


def _calls(wk, smoke, b, h, w, dev):
    p, c, n, v, gy = smoke.warp_inputs(b, h, w, 1.5, 3, dev)
    g1 = gy[..., :1]
    return {"warp2d": lambda: wk.advect_2d_kernel(p, v, 1.0),
            "warp2d_bwd": lambda: wk.advect_2d_kernel_bwd(g1, p, v, 1.0),
            "warp2d_triplet": lambda: wk.align_triplet_kernel(p, c, n, v),
            "warp2d_triplet_bwd": lambda: wk.align_triplet_kernel_bwd(
                gy, p, n, v)}


def host_turn(wk, smoke, this_smoke, dev) -> dict:
    """Every wrapper of one tree at both shapes, without the profiler:
    that tree's ``warp_times`` (ms per call), and the host µs per call of
    the wrapper and of the library call by this tree's
    :func:`chip_smoke.host_us_pair`, the same for both trees."""
    rows = {}
    for b, h, w, iters in SHAPES:
        calls = _calls(wk, smoke, b, h, w, dev)
        libs, _ = this_smoke.warp_calls(warp_kernel, b, h, w, dev)
        for name, t in smoke.warp_times(wk, b, h, w, iters, dev).items():
            row = {k: t[k] for k in ("ms", "ms_min", "ms_max", "plain_ms",
                                     "library_ms", "bound_ms")}
            row["host_us_per_call"], row["library_host_us_per_call"] = (
                this_smoke.host_us_pair(calls[name], libs[name][2]))
            rows[f"{name}@{b}x{h}x{w}"] = row
    return rows


def device_turn(wk, smoke, dev) -> dict:
    """Every wrapper of one tree at both shapes: device µs per call."""
    rows = {}
    for b, h, w, _ in SHAPES:
        for name, fn in _calls(wk, smoke, b, h, w, dev).items():
            kernels, _, kern_us, _ = profiling.profiled(fn, DEVICE_CALLS)
            rows[f"{name}@{b}x{h}x{w}"] = {
                "device_us_per_call": kern_us / DEVICE_CALLS,
                "device_activities_per_call":
                    sum(r[2] for r in kernels) / DEVICE_CALLS}
    return rows


def launcher_split(smoke, dev, rounds=5) -> dict:
    """Host µs per call of each piece of this tree's forward launchers at
    B=16 64², beside the whole calls and grid_sample's: the median of
    ``rounds`` rounds of 1000 calls each, the pieces interleaved."""
    wk = warp_kernel
    p, c, n, v, _ = smoke.warp_inputs(16, 64, 64, 1.5, 3, dev)
    dev_i = v.get_device()
    single, triplet = wk._operators()
    ns = torch.ops.mpgan_warp
    th1, tw1 = wk.fwd_tile(16, 64, 64, 1)
    th3, tw3 = wk.fwd_tile(16, 64, 64, 2)
    out = wk.align_triplet_kernel(p, c, n, v)
    fn = wk._kernels().mpgan_warp2d_triplet
    args = (p.data_ptr(), c.data_ptr(), n.data_ptr(), v.data_ptr(),
            out.data_ptr(), 16, 64, 64, th3, tw3, 8.0, dev_i,
            wk._stream(dev_i))
    grid = smoke.grid_for(v, 1.0, wk.DEFAULT_MAX_DISP)
    one = p.permute(0, 3, 1, 2)
    two = torch.cat([p, n]).permute(0, 3, 1, 2)
    grid2 = torch.cat([grid, smoke.grid_for(v, -1.0, wk.DEFAULT_MAX_DISP)])

    def gs(x, g):
        return F.grid_sample(x, g, mode="bilinear", padding_mode="border",
                             align_corners=True)

    pieces = {
        "whole_call": lambda: wk.align_triplet_kernel(p, c, n, v),
        "warp2d_whole_call": lambda: wk.advect_2d_kernel(p, v, 1.0),
        "operator": lambda: triplet(p, c, n, v, 8, th3, tw3),
        "operator_through_opoverload": lambda: ns.warp2d_triplet.default(
            p, c, n, v, 8, th3, tw3),
        "warp2d_operator": lambda: single(p, v, 1.0, 8, th1, tw1),
        "tile_of_shape": lambda: wk._tile_of(v.shape, 2),
        "new_empty": lambda: v.new_empty((16, 64, 64, 3)),
        "stream": lambda: wk._stream(dev_i),
        "ctypes_call_and_launch": lambda: fn(*args),
        "grid_sample_one_field": lambda: gs(one, grid),
        "grid_sample_two_fields": lambda: gs(two, grid2),
        "aten_grid_sampler_2d_two_fields": lambda: torch.grid_sampler_2d(
            two, grid2, 0, 1, True),
    }
    runs = {k: [] for k in pieces}
    for _ in range(rounds):
        for k, f in pieces.items():
            runs[k].append(smoke.host_us(f))
    return {k: statistics.median(x) for k, x in runs.items()}


def profiler_probe(smoke, dev) -> dict:
    """Host µs per call of this tree's triplet forward and of grid_sample
    on two fields at B=16 64² (:func:`chip_smoke.host_us_pair`): "before"
    now, and ``measure`` to call again after the profiler has run."""
    calls, _ = smoke.warp_calls(warp_kernel, 16, 64, 64, dev)
    kern, lib = calls["warp2d_triplet"][0], calls["warp2d_triplet"][2]

    def measure():
        host, lib_host = smoke.host_us_pair(kern, lib)
        return {"triplet_wrapper": host, "grid_sample_two_fields": lib_host}

    return {"before": measure(), "measure": measure}


def fwd_tile_sweep(smoke, dev) -> dict:
    """The forwards' device µs per call with each tile of
    :data:`FWD_TILE_SWEEP` forced, at each of :data:`FWD_SWEEP_SHAPES`."""
    wk = warp_kernel
    chosen = wk.fwd_tile
    res = {}
    try:
        for b, h, w, _ in FWD_SWEEP_SHAPES:
            calls = _calls(wk, smoke, b, h, w, dev)
            for tile in FWD_TILE_SWEEP:
                wk.fwd_tile = lambda *_, t=tile: t
                wk._tile_of.cache_clear()
                for name in ("warp2d", "warp2d_triplet"):
                    us = profiling.profiled(calls[name], DEVICE_CALLS)[2]
                    res[f"{name}@{b}x{h}x{w}@{tile[0]}x{tile[1]}"] = (
                        us / DEVICE_CALLS)
    finally:
        wk.fwd_tile = chosen
        wk._tile_of.cache_clear()
    res["chosen"] = {f"{b}x{h}x{w}": [list(chosen(b, h, w, f)) for f in (1, 2)]
                     for b, h, w, _ in FWD_SWEEP_SHAPES}
    return res


def tile_sweep(smoke, dev) -> dict:
    """The backwards' device µs per call with each tile of
    :data:`TILE_SWEEP` forced, at both shapes."""
    wk = warp_kernel
    chosen = wk.bwd_tile
    res = {}
    try:
        for b, h, w, _ in SHAPES:
            calls = _calls(wk, smoke, b, h, w, dev)
            for tile in TILE_SWEEP:
                wk.bwd_tile = lambda *_, t=tile: t
                for name in ("warp2d_bwd", "warp2d_triplet_bwd"):
                    us = profiling.profiled(calls[name], DEVICE_CALLS)[2]
                    res[f"{name}@{b}x{h}x{w}@{tile[0]}x{tile[1]}"] = (
                        us / DEVICE_CALLS)
    finally:
        wk.bwd_tile = chosen
    res["chosen"] = {f"{b}x{h}x{w}": [list(chosen(b, h, w, f)) for f in (1, 2)]
                     for b, h, w, _ in SHAPES}
    return res


def forwards_agree(trees, smoke, dev) -> dict:
    """Both trees' forwards on the same inputs (velocity scales 1.5, 12
    and 0, both shapes): the largest |Δ| and whether every bit agrees."""
    res = {}
    (wk_a, _), (wk_b, _) = trees.values()
    for b, h, w, _ in SHAPES:
        for vscale in (1.5, 12.0, 0.0):
            p, c, n, v, _ = smoke.warp_inputs(b, h, w, vscale, 7, dev)
            for name, call in (
                    ("warp2d", lambda k: k.advect_2d_kernel(p, v, -1.0)),
                    ("warp2d_triplet",
                     lambda k: k.align_triplet_kernel(p, c, n, v))):
                x, y = call(wk_a), call(wk_b)
                res[f"{name}@{b}x{h}x{w}@v{vscale}"] = {
                    "max_abs_diff": float((x - y).abs().max()),
                    "equal_bits": bool(torch.equal(x, y))}
    return res


def _turns(trees, fn) -> dict:
    """``fn(wk, smoke)`` of each tree in :data:`ORDER` → tag → runs."""
    runs = {"other": [], "this": []}
    for tag in ORDER:
        wk, tree_smoke = trees[tag]
        runs[tag].append(fn(wk, tree_smoke))
    return runs


def main():
    if not torch.cuda.is_available():
        print("mpgan_torch.warp_compare: needs a CUDA card", file=sys.stderr)
        return 2
    other_root = Path(sys.argv[1]).resolve()
    out_path = sys.argv[2] if len(sys.argv) > 2 else None
    dev = torch.device("cuda")
    smoke = _load("_this_chip_smoke", ROOT / "chip_smoke.py")
    trees = {"other": load_tree(other_root, "other"),
             "this": (warp_kernel, smoke)}
    for wk, _ in trees.values():  # build both before anything is timed
        wk._kernels()
        if hasattr(wk, "_operators"):
            wk._operators()
    # 1. without the profiler
    host = _turns(trees, lambda wk, s: host_turn(wk, s, smoke, dev))
    split = launcher_split(smoke, dev)
    probe = profiler_probe(smoke, dev)
    # 2. with it
    device = _turns(trees, lambda wk, s: device_turn(wk, s, dev))
    probe["after"] = probe["measure"]()
    summary = {}
    for tag in ("other", "this"):
        for key in host[tag][0]:
            summary.setdefault(key, {})[tag] = {
                "ms": statistics.mean(r[key]["ms"] for r in host[tag]),
                "host_us_per_call": statistics.mean(
                    r[key]["host_us_per_call"] for r in host[tag]),
                "library_host_us_per_call": statistics.mean(
                    r[key]["library_host_us_per_call"] for r in host[tag]),
                "device_us_per_call": statistics.mean(
                    r[key]["device_us_per_call"] for r in device[tag])}
    result = {"card": smoke.nvidia_smi(), "torch": torch.__version__,
              "other_root": str(other_root),
              "stream_source": warp_kernel.STREAM_SOURCE,
              "summary_mean_of_two_turns": summary,
              "host_turns": host, "device_turns": device,
              "launcher_split_us": split,
              "host_us_before_and_after_profiler": {
                  k: probe[k] for k in ("before", "after")},
              "forwards_agree": forwards_agree(trees, smoke, dev),
              "fwd_tile_sweep_device_us": fwd_tile_sweep(smoke, dev),
              "tile_sweep_device_us": tile_sweep(smoke, dev)}
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
