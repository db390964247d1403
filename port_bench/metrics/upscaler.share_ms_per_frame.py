"""Graphed upscaler and assembly, over several cards: each card's own work
per frame, in device milliseconds on its stream: its call or replay on its
shares and the copies of its results back to the first card (the
program's ``upscale.share`` and ``upscale.gather`` spans), the mean over
the cards."""

from port_bench import spans as sp


def read(record, spans=None):
    own = [s for s in sp.named(sp.load() if spans is None else spans,
                               "upscale.share", "upscale.gather")
           if s["device"] is not None]
    if not own or not record.get("units"):
        return None
    cards = {s["attrs"]["card"] for s in own}
    return sum(sp.device_ms(s) for s in own) / len(cards) / record["units"]
