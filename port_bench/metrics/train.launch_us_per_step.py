"""Trainer and graphed programs: the host's microseconds to launch one
train step, the mean duration of the program's ``train.replay`` spans (the
generator's state put in place and the graph launched, with any wait for
room in the card's queue when the host is ahead of the card)."""

from port_bench import spans as sp


def read(record, spans=None):
    replays = sp.named(sp.load() if spans is None else spans,
                       "train.replay")
    if not replays:
        return None
    return 1e3 * sum(sp.host_ms(s) for s in replays) / len(replays)
