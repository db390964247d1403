"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration (``configs/<file>``, as
the entry of ``configs`` gives it) and a traffic mix
(``traffic/<traffic>.json``); a per-layer metric is read by
``metrics/<name>.py``, or by the reader of its stem (:func:`reader_path`). A later cell or metric is added by adding files and
entries; none of this code changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _by_name(items: list[dict], name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str, root: str = ROOT) -> dict:
    """The cell ``name`` with its configuration, traffic and metrics:
    ``{"cell", "config", "traffic", "end_to_end", "per_layer"}``. A metric
    belongs to the cell when its ``workloads`` list names it, or it has no
    such list and moves an end-to-end metric the cell reports."""
    wl = _by_name(bench["workloads"], name, "workload")
    entry = _by_name(bench["configs"], wl["config"], "configuration")
    with open(os.path.join(root, entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(HERE, "traffic", f"{wl['traffic']}.json")) as fh:
        traffic = json.load(fh)

    def mine(m):
        return name in m.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if mine(m) and ("workloads" in m or m["moves"] in names)]
    return {"cell": wl, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": per_layer}


def reader_path(metric: str) -> str:
    """``metrics/<metric>.py``, or where there is none, the reader of the
    name's stem before its first dot (``metrics/mfu.py`` reads
    ``mfu.frames`` and ``mfu.train``)."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    if os.path.exists(path):
        return path
    return os.path.join(HERE, "metrics", f"{metric.split('.', 1)[0]}.py")


def reader(metric: str):
    """The ``read(record)`` function of the metric's reader."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
