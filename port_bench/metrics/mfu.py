"""Model step (``mfu.frames``, ``mfu.train``): the model's convolution
FLOPs per frame or train step (counted from the configuration's shapes,
port_bench/counts.py) times the frames or steps completed in the traced
window, over the window's seconds and the bf16 dense peak of every card
used, in %."""

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "peaks.json")


def read(record):
    if not record.get("units") or not record.get("window_s"):
        return None
    with open(PEAKS) as fh:
        peak = json.load(fh)["bf16_dense_flops_per_s"]
    done = record["flops_per_unit"] * record["units"] / record["window_s"]
    return 100.0 * done / (peak * record["n_devices"])
