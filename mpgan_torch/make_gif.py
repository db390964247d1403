"""Assemble an inference sweep's ``.uni`` volumes into an animated GIF
(counterpart of ``scripts/make_gif.py``).

    python -m mpgan_torch.make_gif dir runs/test_0001 out smoke.gif \\
        axis z fps 15 [pattern 'source_*.uni'] [index -1]

Takes the middle slice (or ``index``) along ``axis`` of every volume
matching ``pattern`` in ``dir`` (sorted by name, which is frame order),
normalises all frames by one global maximum so that brightness compares
across time, and writes an animated GIF with PIL (imported only here).
"""

from __future__ import annotations

import glob
import os
import re
import sys

import numpy as np

from mpgan_torch.utils import params as ph


def _slice(vol: np.ndarray, axis: int, index: int) -> np.ndarray:
    if index < 0:
        index = vol.shape[axis] // 2
    sl = np.take(vol[..., 0], index, axis=axis)
    return sl[::-1]  # y up for display, as the preview PNGs


def main(argv: list[str] | None = None) -> str:
    if argv is not None:
        ph.setParams(argv)
    run_dir = ph.getParam("dir", "")
    out_path = ph.getParam("out", "")
    axis_name = str(ph.getParam("axis", "z")).lower()
    index = int(ph.getParam("index", -1))
    fps = float(ph.getParam("fps", 15))
    pattern = ph.getParam("pattern", "source_*.uni")
    ph.checkUnusedParams()
    if not run_dir or not os.path.isdir(run_dir):
        sys.exit(f"dir {run_dir!r} is not a directory")
    if axis_name not in ("z", "y", "x"):
        sys.exit(f"axis must be z|y|x, got {axis_name!r}")
    axis = {"z": 0, "y": 1, "x": 2}[axis_name]
    if not out_path:
        out_path = os.path.join(run_dir, "preview.gif")

    from PIL import Image

    from mpgan_torch.io import uni
    from mpgan_torch.utils.preview import norm_u8

    paths = sorted(glob.glob(os.path.join(run_dir, pattern)))
    if not paths:
        sys.exit(f"no volumes matching {pattern!r} under {run_dir!r}")
    # source_<sim>_<frame>.uni of several sims all match the default
    # pattern and would be stitched into one animation: warn, don't guess
    stems = {re.sub(r"\d+(?=\.\w+$)", "", os.path.basename(p)) for p in paths}
    if len(stems) > 1:
        print(f"warning: {pattern!r} matches {len(stems)} distinct name "
              f"groups ({sorted(stems)}); frames from different sims will "
              "be stitched into one GIF — narrow `pattern` (e.g. "
              "'source_1000_*.uni') to animate a single sim", file=sys.stderr)
    slices = [_slice(np.asarray(uni.readUni(p)[1], np.float32), axis, index)
              for p in paths]
    peak = max(float(s.max()) for s in slices)
    frames = [Image.fromarray(norm_u8(s, peak)) for s in slices]
    frames[0].save(out_path + ".tmp", "GIF", save_all=True,
                   append_images=frames[1:],
                   duration=max(int(1000.0 / max(fps, 1e-3)), 20), loop=0)
    os.replace(out_path + ".tmp", out_path)
    print(f"wrote {out_path} ({len(frames)} frames, "
          f"{frames[0].width}x{frames[0].height}, {axis_name}-slice)")
    return out_path


if __name__ == "__main__":
    main()
