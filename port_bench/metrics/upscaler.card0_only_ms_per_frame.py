"""Graphed upscaler and assembly, over several cards: the first card's
work alone per frame, in device milliseconds: the copies of the other
cards' shares to them and its work between the passes once their results
are back (the program's ``upscale.scatter`` and ``upscale.between``
spans)."""

from port_bench import spans as sp


def read(record, spans=None):
    alone = [s for s in sp.named(sp.load() if spans is None else spans,
                                 "upscale.scatter", "upscale.between")
             if s["device"] is not None]
    if not alone or not record.get("units"):
        return None
    return sum(sp.device_ms(s) for s in alone) / record["units"]
