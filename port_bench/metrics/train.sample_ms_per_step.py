"""Sampling: the device milliseconds per train step of the tile creator's
batch assembly, the program's ``train.sample`` spans (one a D-run and one
a G-run, each drawing and gathering a batch from the resident volumes),
timed on the card inside the captured step and read for each program's
last traced replay (port_bench/step_spans.py)."""

from port_bench import spans as sp
from port_bench import step_spans


def read(record, spans=None):
    return step_spans.ms_per_step(sp.load() if spans is None else spans,
                                  "train.sample")
