"""The control of the three-pass frames traffic (kind ``frames3``): the
plain three-pass reference put in the program's place and computed one
precision below the configuration's (float8 e4m3 operands for every
convolution where it states bfloat16), read as the cell reads the program.
The benchmark's own runs never run this; cells of the other kinds are
read by ``control.py``.

    python3 port_bench/control3.py --workload mpgan-8x-3pass.frames \
        --seeds 1 2 3

Prints one JSON object per seed: the numbers the cell compares, as the
control reads them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def frames3_readings(ctx: dict) -> dict:
    import torch
    from port_bench.drivers import common, frames, frames3
    from port_bench.reference import frames3 as ref_frames3
    from port_bench.reference import nets
    state = frames3.inputs(ctx)
    p1, d1, p2, d2 = state["weights"]
    p3, d3 = state["pass3"]
    kept = {}
    with torch.no_grad(), common.strict_float32():
        for k in sorted(frames.picks(ctx)):
            kept[k] = ref_frames3.upscale(
                p1, d1, p2, d2, p3, d3,
                state["lr"][k % state["lr"].shape[0]],
                ctx["config"]["up_res"], ctx["traffic"]["ref_block"],
                nets.fp8_quant)
    return {"control": frames3.check(ctx, state, kept)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from port_bench import manifest
    spec = manifest.cell(manifest.load(ROOT), args.workload, ROOT)
    if spec["traffic"]["kind"] != "frames3":
        ap.error(f"{args.workload} is read by port_bench/control.py")
    devices = [torch.device("cuda", i)
               for i in range(spec["traffic"].get("devices", 1))]
    for seed in args.seeds:
        t = time.perf_counter()
        ctx = {"seed": seed, "config": spec["config"],
               "traffic": spec["traffic"], "devices": devices,
               "trace": False}
        res = frames3_readings(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed, **res,
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
