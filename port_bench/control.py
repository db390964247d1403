"""The readings a cell's limits are set from, at the cell's own size on the
card: the control (the plain reference put in the program's place and
computed one precision below the configuration's, float8 e4m3 operands for
every convolution where the configuration states bfloat16) and, for the
train cell, the planted faults. The benchmark's own runs never run this.

    python3 port_bench/control.py --workload mpgan-4x.frames --seeds 1 2 3

Prints one JSON object per seed: the numbers the cell compares, as the
control reads them (and, for the train cell, as each fault reads them: the
losses taken over half of the batch; a step that leaves the state
unchanged reads 1 on ``train_change_gap`` by the measure's definition).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def frames_readings(ctx: dict) -> dict:
    import torch
    from port_bench.drivers import common, frames
    from port_bench.reference import frames as ref_frames
    from port_bench.reference import nets
    state = frames.inputs(ctx)
    p1, d1, p2, d2 = state["weights"]
    kept = {}
    with torch.no_grad(), common.strict_float32():
        for k in sorted(frames.picks(ctx)):
            kept[k] = ref_frames.upscale(
                p1, d1, p2, d2, state["lr"][k % state["lr"].shape[0]],
                ctx["config"]["up_res"], ctx["traffic"]["ref_block"],
                nets.fp8_quant)
    return {"control": frames.check(ctx, state, kept)}


def as_stretch(run: dict, stretch: dict) -> dict:
    """A reference run dressed as the program's record of a stretch of
    steps (:func:`port_bench.drivers.train.compare`)."""
    return {**stretch,
            "losses": [{k: float(run[k][i])
                        for k in ("d_loss", "dt_loss", "g_loss")}
                       for i in range(len(stretch["losses"]))],
            "grads": run["grads0"],
            "after": {**run["params"], "ema": run["ema"]}}


def train_readings(ctx: dict) -> dict:
    """The control's and the half batch's numbers over the cell's two
    stretches: the first steps from the benchmark's weights, and the
    replayed R1 step from the float32 reference's own state after those
    steps (standing in for the program's state before ``replay_step``)."""
    from port_bench.drivers import train
    from port_bench.reference import nets
    tr = ctx["traffic"]
    state = train.inputs(ctx)
    p = state["params"]
    first = {"it": 0, "losses": [None] * tr["check_steps"],
             "before": {**p, "ema": p["gen"]}}
    state["stretches"] = [first]
    r0 = train.reference(ctx, state)[0]
    replay = {"it": tr["replay_step"], "losses": [None],
              "before": {**r0["params"], "ema": r0["ema"]},
              "opt": r0["opt"]}
    state["stretches"] = [first, replay]
    ref = train.reference(ctx, state)
    unit = train.reference(ctx, state, quant=nets.bf16_round)
    out = {}
    for name, kw in (("control", {"quant": nets.fp8_quant}),
                     ("half_batch", {"fault": "half_batch"})):
        other = train.reference(ctx, state, **kw)
        where: dict = {}
        nums = train.compare([as_stretch(o, s) for o, s in
                              zip(other, state["stretches"])], ref, unit,
                             where)
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
    kind = spec["traffic"]["kind"]
    read = {"frames": frames_readings, "train": train_readings}[kind]
    devices = [torch.device("cuda", i)
               for i in range(spec["traffic"].get("devices", 1))]
    for seed in args.seeds:
        t = time.perf_counter()
        ctx = {"seed": seed, "config": spec["config"],
               "traffic": spec["traffic"], "devices": devices,
               "trace": False}
        res = read(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed, **res,
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
