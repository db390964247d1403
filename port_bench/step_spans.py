"""The train step's spans, as the readers of ``metrics/train.*_ms_per_step``
take them: a span inside the step (``train.sample``, ``train.d_run``) is
timed on the card inside each captured program and read for the program's
last traced replay (:mod:`mpgan_torch.tracing`). A step is one of two
programs, lazy R1 on or off, which the ``r1`` attribute of its rows and of
the window's ``train.replay`` spans tells apart; a row's ``it`` attribute
is the step it timed."""

from __future__ import annotations

from collections import Counter, defaultdict

from port_bench import spans as sp


def ms_per_step(spans: list[dict] | None, name: str) -> float | None:
    """The device ms per step of the spans ``name``: per program, their sum
    over the steps read, over the number of those steps; the programs
    weighted by their replays in the window (by the steps read where the
    window has no replays, as when the step runs eagerly). None where no
    such span was timed on a card."""
    rows = [s for s in sp.named(spans, name) if s["device"] is not None]
    if not rows:
        return None
    ms, steps = defaultdict(float), defaultdict(set)
    for s in rows:
        key = s["attrs"].get("r1")
        ms[key] += sp.device_ms(s)
        steps[key].add(s["attrs"].get("it"))
    runs = Counter(s["attrs"].get("r1")
                   for s in sp.named(spans, "train.replay"))
    weight = {k: runs.get(k) or len(steps[k]) for k in ms}
    return sum(weight[k] * ms[k] / len(steps[k]) for k in ms) \
        / sum(weight.values())
