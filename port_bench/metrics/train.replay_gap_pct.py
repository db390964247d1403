"""Trainer and graphed programs: the card's time between one train step's
graph replay and the next (the device start of the next program's
``train.replay`` span less the device end of this one's, summed over
consecutive replays on a card), over the traced window's seconds, in %,
the mean over the cards. Whatever runs on the card there, such as a read of the metrics, counts
with the idle time."""

from port_bench import spans as sp


def read(record, spans=None):
    replays = [s for s in sp.named(sp.load() if spans is None else spans,
                                   "train.replay")
               if s["device"] is not None]
    if len(replays) < 2 or not record.get("window_s"):
        return None
    gap_ms = 0.0
    cards = {s["device"] for s in replays}
    for card in cards:
        mine = sorted((s for s in replays if s["device"] == card),
                      key=lambda s: s["device_start_ms"])
        gap_ms += sum(max(b["device_start_ms"] - a["device_end_ms"], 0.0)
                      for a, b in zip(mine, mine[1:]))
    return 100.0 * gap_ms * 1e-3 / len(cards) / record["window_s"]
