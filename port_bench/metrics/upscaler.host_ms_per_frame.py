"""Graphed upscaler and assembly: the host's milliseconds per frame in the
upscaler's call, the mean duration of the program's ``upscale.frame``
spans."""

from port_bench import spans as sp


def read(record, spans=None):
    frames = sp.named(sp.load() if spans is None else spans,
                      "upscale.frame")
    if not frames:
        return None
    return sum(sp.host_ms(s) for s in frames) / len(frames)
