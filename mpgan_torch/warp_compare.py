"""The warp kernels and their wrappers in this tree against another tree's,
on one CUDA card, in one process, in turns (other, this, this, other).

    python3 -m mpgan_torch.warp_compare OTHER_ROOT [out.json]

``OTHER_ROOT`` is an unpacked tree of the repository, for example the
parent commit's (``git archive <commit> | tar -x -C OTHER_ROOT``). Its
``mpgan_torch/_build.py`` and ``ops/warp_kernel.py`` are loaded under
private names, so that its kernels are built from its own sources into its
own ``_build/``, and its ``chip_smoke.py`` gives its ``warp_times``.

Each turn measures, for each of the four wrappers at B=16 64² and B=256
256²: ``warp_times`` of that tree's ``chip_smoke.py`` (ms per call, the
median of 5 windows of CUDA events, with the plain version's, the library
call's and the bound), the host µs per call (:func:`chip_smoke.host_us`
of this tree, the same for both) and the device µs per call
(:func:`mpgan_torch.profiling.profiled`, 100 calls). Then, for this tree
only: the host µs of each piece of the triplet forward's launcher at B=16
64², and the backwards' device µs per call (100 calls) with each tile of
:data:`TILE_SWEEP` forced in place of ``bwd_tile``'s choice.

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

from mpgan_torch import profiling
from mpgan_torch.ops import warp_kernel

ROOT = Path(__file__).resolve().parent.parent
SHAPES = ((16, 64, 64, 200), (256, 256, 256, 20))  # B, H, W, timed calls
TILE_SWEEP = ((64, 64), (32, 64), (32, 32), (16, 64), (16, 32), (8, 64))


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


def turn(wk, smoke, host_us, dev) -> dict:
    """Every wrapper of one tree at both shapes."""
    rows = {}
    for b, h, w, iters in SHAPES:
        times = smoke.warp_times(wk, b, h, w, iters, dev)
        for name, fn in _calls(wk, smoke, b, h, w, dev).items():
            host = host_us(fn)  # before the profiler, which slows the host
            kernels, _, kern_us, _ = profiling.profiled(fn, 100)
            t = times[name]
            rows[f"{name}@{b}x{h}x{w}"] = {
                "ms": t["ms"], "ms_min": t["ms_min"], "ms_max": t["ms_max"],
                "host_us_per_call": host,
                "device_us_per_call": kern_us / 100,
                "device_activities_per_call":
                    sum(r[2] for r in kernels) / 100,
                "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
                "bound_ms": t["bound_ms"]}
    return rows


def launcher_split(smoke, dev) -> dict:
    """Host µs per call of each piece of this tree's triplet forward
    launcher at B=16 64² (1000 calls each), beside the whole call and
    grid_sample's."""
    wk = warp_kernel
    p, c, n, v, _ = smoke.warp_inputs(16, 64, 64, 1.5, 3, dev)
    dev_i = v.get_device()
    out = wk.align_triplet_kernel(p, c, n, v)
    fn = wk._kernels().mpgan_warp2d_triplet
    args = (p.data_ptr(), c.data_ptr(), n.data_ptr(), v.data_ptr(),
            out.data_ptr(), 16, 64, 64, 8.0, dev_i, wk._stream(dev_i))
    grid = smoke.grid_for(v, 1.0, wk.DEFAULT_MAX_DISP)
    two = torch.cat([p, n]).permute(0, 3, 1, 2)
    grid2 = torch.cat([grid, smoke.grid_for(v, -1.0, wk.DEFAULT_MAX_DISP)])
    pieces = {
        "whole_call": lambda: wk.align_triplet_kernel(p, c, n, v),
        "check": lambda: wk._check("align_triplet_kernel", v, (p, c, n),
                                   ("prev", "cur", "nxt")),
        "new_empty": lambda: v.new_empty((16, 64, 64, 3)),
        "torch_empty": lambda: torch.empty((16, 64, 64, 3),
                                           dtype=torch.float32, device=dev),
        "data_ptr_x5": lambda: (p.data_ptr(), c.data_ptr(), n.data_ptr(),
                                v.data_ptr(), out.data_ptr()),
        "stream": lambda: wk._stream(dev_i),
        "ctypes_call_and_launch": lambda: fn(*args),
        "grid_sample_two_fields": lambda: torch.nn.functional.grid_sample(
            two, grid2, mode="bilinear", padding_mode="border",
            align_corners=True),
    }
    return {k: smoke.host_us(f) for k, f in pieces.items()}


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
                    us = profiling.profiled(calls[name], 100)[2] / 100
                    res[f"{name}@{b}x{h}x{w}@{tile[0]}x{tile[1]}"] = us
    finally:
        wk.bwd_tile = chosen
    res["chosen"] = {f"{b}x{h}x{w}": [list(chosen(b, h, w, f)) for f in (1, 2)]
                     for b, h, w, _ in SHAPES}
    return res


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
    for wk, _ in trees.values():
        wk._kernels()  # build both before anything is timed
    turns = {"other": [], "this": []}
    for tag in ("other", "this", "this", "other"):
        wk, tree_smoke = trees[tag]
        turns[tag].append(turn(wk, tree_smoke, smoke.host_us, dev))
    summary = {}
    for tag, runs in turns.items():
        for key in runs[0]:
            summary.setdefault(key, {})[tag] = {
                m: statistics.mean(r[key][m] for r in runs)
                for m in ("ms", "host_us_per_call", "device_us_per_call")}
    result = {"card": smoke.nvidia_smi(), "torch": torch.__version__,
              "other_root": str(other_root),
              "stream_source": warp_kernel.STREAM_SOURCE,
              "summary_mean_of_two_turns": summary, "turns": turns,
              "launcher_split_us": launcher_split(smoke, dev),
              "tile_sweep_device_us": tile_sweep(smoke, dev)}
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
