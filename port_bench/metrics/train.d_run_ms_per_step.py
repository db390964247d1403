"""Trainer and graphed programs: the device milliseconds per train step of
the D-run, the program's ``train.d_run`` span (its batch, G's fake
triplet, the warps and the updates of Ds and Dt, with lazy R1 on its
steps), timed on the card inside the captured step and read for each
program's last traced replay (port_bench/step_spans.py)."""

from port_bench import spans as sp
from port_bench import step_spans


def read(record, spans=None):
    return step_spans.ms_per_step(sp.load() if spans is None else spans,
                                  "train.d_run")
