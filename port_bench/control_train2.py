"""The readings the pass-2 train cell's limits are set from (kind
``train2``), at the cell's own size on the card: the control (the plain
pass-2 reference put in the program's place and computed one precision
below the configuration's, float8 e4m3 operands for every convolution
where it states bfloat16) and three planted faults (every loss over half
of the batch; lazy R1 skipped at its steps; the velocity's w left in LR
cells), each read as the cell reads the program. The benchmark's own runs never run this; cells of the other kinds
are read by ``control.py`` and ``control3.py``.

    python3 port_bench/control_train2.py --workload mpgan-8x-pass2.train \
        --seeds 1 2 3

Prints one JSON object per seed: the numbers the cell compares, as the
control and the faults read them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(ctx: dict) -> dict:
    """The control's and the three faults' numbers over the cell's two
    stretches, as :func:`control.train_readings` reads the pass-1 cell's:
    the first steps from the benchmark's weights, and the replayed R1 step
    from the float32 reference's own state after them. The intermediate
    volumes are the program's frozen-G1 sweep, the data the program
    trains on."""
    from port_bench import control
    from port_bench.drivers import train2
    from port_bench.reference import nets
    tr = ctx["traffic"]
    state = train2.inputs(ctx)
    state["interm"] = train2.intermediates(ctx, state)
    p = state["params"]
    first = {"it": 0, "losses": [None] * tr["check_steps"],
             "before": {**p, "ema": p["gen"]}}
    state["stretches"] = [first]
    r0 = train2.reference(ctx, state)[0]
    replay = {"it": tr["replay_step"], "losses": [None],
              "before": {**r0["params"], "ema": r0["ema"]},
              "opt": r0["opt"]}
    stretches = [first, replay]
    out = {}
    for name, kw in (("control", {"quant": nets.fp8_quant}),
                     ("half_batch", {"fault": "half_batch"}),
                     ("no_r1", {"fault": "no_r1"}),
                     ("w_units", {"fault": "w_units"})):
        state["stretches"] = stretches
        other = train2.reference(ctx, state, **kw)
        # compared as the cell compares a program's run
        state["stretches"] = [
            {**control.as_stretch(o, s), "triplet": o["triplet"]}
            for o, s in zip(other, stretches)]
        ref, unit = train2.references(ctx, state)
        where: dict = {}
        nums = train2.compare(state["stretches"], ref, unit, where)
        out[name] = {**nums, "where": where}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from port_bench import manifest
    spec = manifest.cell(manifest.load(ROOT), args.workload, ROOT)
    if spec["traffic"]["kind"] != "train2":
        ap.error(f"{args.workload} is not a pass-2 train cell")
    devices = [torch.device("cuda", i)
               for i in range(spec["traffic"].get("devices", 1))]
    for seed in args.seeds:
        t = time.perf_counter()
        ctx = {"seed": seed, "config": spec["config"],
               "traffic": spec["traffic"], "devices": devices,
               "trace": False}
        res = readings(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed, **res,
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
