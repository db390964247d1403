"""Graphed upscaler and assembly, three passes on one card: pass 3's device
milliseconds per frame (the program's ``upscale.pass`` spans of
``pass_no`` 3 timed on the card, captured in the frame's program and read
at its replays: the velocity resize and staging of the yz slices, G3 over
them, and the transpose back)."""

from port_bench import spans as sp


def read(record, spans=None):
    rows = [s for s in sp.named(sp.load() if spans is None else spans,
                                "upscale.pass")
            if s["attrs"].get("pass_no") == 3 and s["device"] is not None]
    if not rows or not record.get("units"):
        return None
    return sum(sp.device_ms(s) for s in rows) / len(rows)
