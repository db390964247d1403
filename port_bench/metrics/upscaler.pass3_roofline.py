"""Graphed upscaler and assembly, three passes on one card: pass 3's least
time over its device time, in %. The least time is the larger of its
convolutions' operations at the card's bf16 dense peak and its input (4
channels) read once plus its output written once at the card's HBM
bandwidth (port_bench/drivers/frames3.py, ``pass3_counts``); the device
time is that of the ``upscale.pass`` spans of ``pass_no`` 3."""

import json
import os

from port_bench import spans as sp

PEAKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "peaks.json")


def read(record, spans=None):
    rows = [s for s in sp.named(sp.load() if spans is None else spans,
                                "upscale.pass")
            if s["attrs"].get("pass_no") == 3 and s["device"] is not None]
    if not rows or not record.get("pass3_flops_per_unit"):
        return None
    with open(PEAKS) as fh:
        peaks = json.load(fh)
    least_s = max(record["pass3_flops_per_unit"]
                  / peaks["bf16_dense_flops_per_s"],
                  record["pass3_bytes_per_unit"] / peaks["hbm_bytes_per_s"])
    device_s = sum(sp.device_ms(s) for s in rows) * 1e-3
    return 100.0 * least_s * len(rows) / device_s
