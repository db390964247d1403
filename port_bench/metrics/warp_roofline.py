"""Warp kernels: the least time of a step's warp launches (each byte they
must read once and each byte they must write once at the card's HBM
bandwidth, port_bench/counts.py) times the steps of the traced window, over
the device time of the warp kernels found by name in the trace, in %."""

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "peaks.json")
# the warp kernels as the trace names them (a copy of the program's
# pattern: one thread per pixel, or tiles)
WARP_TRACE_NAMES = ("warp2d_triplet_kernel", "warp2d_fwd_kernel<2",
                    "warp2d_bwd_kernel<2", "warp2d_bwd_kernel<1",
                    "warp2d_fwd_kernel<1", "warp2d_kernel")


def read(record):
    kernels = record.get("summary", {}).get("kernel_s", {})
    device_s = sum(s for name, s in kernels.items()
                   if any(k in name for k in WARP_TRACE_NAMES))
    if device_s <= 0 or not record.get("units"):
        return None
    with open(PEAKS) as fh:
        bw = json.load(fh)["hbm_bytes_per_s"]
    least = record["warp_bytes_per_unit"] * record["units"] / bw
    return 100.0 * least / device_s
