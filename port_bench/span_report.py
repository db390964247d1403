"""One run of a benchmark cell, as ``run.py`` makes it, with the program's
spans read over its measured window.

    python3 port_bench/span_report.py --workload mpgan-4x.train \
        --seed 7 --seconds 30 --tracing 1 [--out report.json]

``--tracing 0``: the run exactly as ``run.py --trace 0`` makes it (the
untraced side of an on-cost comparison). ``--tracing 1``: the same run
with ``mpgan_torch.tracing.enable()`` in force over the measured window
only (the store emptied at its start), no profiler. ``--tracing 2``: the
traced run (``run.py --trace 1``), whose profiler turns the spans on as
``record_function`` ranges; the trace is then read per card.

After ``run.py``'s own result line, prints one JSON line (and writes it
to ``--out``): the window's seconds and, from the spans, per frame the
host's ms in the upscaler's call, each card's device ms in its shares and
gathers, the first card's ms alone (scatters and the work between the
passes) and a frame's device ms on the first card; per 100 train steps the
replay's device ms, the gaps between replays, the host's launch µs and
the steps per second. With ``--tracing 2`` also, per card, the busy
seconds, the busy seconds inside each span's device-side range, and the
idle seconds by the innermost span the host was in when each idle stretch
began ("none": outside every span).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
from collections import defaultdict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracing", type=int, choices=(0, 1, 2), default=1)
    ap.add_argument("--out")
    return ap.parse_args(argv)


def windows(tracing_on: bool) -> list:
    """Makes every measured window of the run record its spans (the store
    emptied at its start; with ``tracing_on`` under ``tracing.enable()``)
    and keep its profiler; → the list the windows are appended to."""
    from mpgan_torch import tracing
    from port_bench import trace
    seen = []
    base = trace.Window

    class Window(base):
        def __enter__(self):
            tracing.clear()
            self.on = tracing.enable() if tracing_on else None
            if self.on is not None:
                self.on.__enter__()
            seen.append(self)
            return super().__enter__()

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            if self.on is not None:
                self.on.__exit__(*exc)
            return out
    trace.Window = Window
    return seen


def frames(spans: list[dict]) -> dict:
    from port_bench import spans as sp
    n = len(sp.named(spans, "upscale.frame"))
    if not n:
        return {}
    per_card: dict[int, float] = defaultdict(float)
    for s in sp.named(spans, "upscale.share", "upscale.gather"):
        if s["device"] is not None:
            per_card[s["attrs"]["card"]] += sp.device_ms(s) / n
    alone = defaultdict(float)
    for s in sp.named(spans, "upscale.scatter", "upscale.between"):
        if s["device"] is not None:
            alone[s["name"]] += sp.device_ms(s) / n
    frame = [s for s in sp.named(spans, "upscale.frame")
             if s["device"] is not None]
    return {"frames": n,
            "host_ms_per_frame": statistics.fmean(
                sp.host_ms(s) for s in sp.named(spans, "upscale.frame")),
            "frame_device_ms": statistics.fmean(
                sp.device_ms(s) for s in frame) if frame else None,
            "share_ms_per_frame_by_card": dict(sorted(per_card.items())),
            "card0_only_ms_per_frame": dict(alone)}


def train(spans: list[dict], every: int = 100) -> list[dict]:
    """Per ``every`` steps (by the step's ``it``): the replays' mean device
    ms, the summed gaps before each replay after the group's first, the
    mean launch µs, the first replay's (after a read of the metrics, with
    nothing queued on the card) and the least, and the steps per second
    between the first step's start and the last's end on the host."""
    from port_bench import spans as sp
    groups: dict[int, dict] = defaultdict(lambda: {"replays": [],
                                                   "steps": []})
    for s in sp.named(spans, "train.replay"):
        groups[s["attrs"]["it"] // every]["replays"].append(s)
    for s in sp.named(spans, "train.step"):
        groups[s["attrs"]["it"] // every]["steps"].append(s)
    out = []
    for g in sorted(groups):
        reps = sorted((s for s in groups[g]["replays"]
                       if s["device"] is not None),
                      key=lambda s: s["device_start_ms"])
        steps = groups[g]["steps"]
        if not reps or not steps:
            continue
        wall_s = (max(s["host_end_ns"] for s in steps)
                  - min(s["host_start_ns"] for s in steps)) * 1e-9
        out.append({
            "from_it": g * every, "steps": len(steps),
            "steps_per_s": len(steps) / wall_s,
            "replay_device_ms": statistics.fmean(
                sp.device_ms(s) for s in reps),
            "gap_ms": sum(b["device_start_ms"] - a["device_end_ms"]
                          for a, b in zip(reps, reps[1:])),
            "launch_us": 1e3 * statistics.fmean(
                sp.host_ms(s) for s in groups[g]["replays"]),
            "launch_us_first": 1e3 * sp.host_ms(reps[0]),
            "launch_us_min": 1e3 * min(sp.host_ms(s) for s in reps)})
    return out


def by_span(prof, names: set[str], device_ids: list[int]) -> dict:
    """Per card from the profiler's events: busy seconds (the union of its
    operations), busy seconds inside each span's device-side range, and
    idle seconds by the innermost span open on the host when each idle
    stretch began."""
    import torch
    from port_bench import trace
    ops: dict[int, list] = defaultdict(list)
    ranges: dict[int, dict[str, list]] = defaultdict(lambda: defaultdict(
        list))
    host: list[tuple[int, int, str]] = []
    lo = hi = None
    for e in prof.profiler.kineto_results.events():
        s, d, name = trace._ns(e, "start"), trace._ns(e, "duration"), e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if trace._is_device(e):
                ops[e.device_index()].append((s, s + d))
            elif name in names:
                ranges[e.device_index()][name].append((s, s + d))
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            lo = s if lo is None else min(lo, s)
            hi = s + d if hi is None else max(hi, s + d)
            if name in names:
                host.append((s, s + d, name))
    host.sort()
    starts = [h[0] for h in host]
    out = {}
    for i in device_ids:
        busy = trace._merge(ops.get(i, []))
        inside = {}
        for name, iv in ranges[i].items():
            span_iv = trace._merge(iv)
            inside[name] = _overlap(busy, span_iv) * 1e-9
        idle: dict[str, float] = defaultdict(float)
        edges = ([(lo, busy[0][0])] + [(busy[k][1], busy[k + 1][0])
                                       for k in range(len(busy) - 1)]
                 + [(busy[-1][1], hi)]) if busy else [(lo, hi)]
        for g0, g1 in edges:
            if g1 > g0:
                idle[_innermost(host, starts, g0)] += (g1 - g0) * 1e-9
        out[i] = {"busy_s": sum(b - a for a, b in busy) * 1e-9,
                  "busy_s_inside": inside,
                  "idle_s_by_host_span": dict(idle)}
    return {"window_s": (hi - lo) * 1e-9 if lo is not None else None,
            "cards": out}


def _overlap(a: list, b: list) -> int:
    """Nanoseconds in both of two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _innermost(host, starts, t: int) -> str:
    k = bisect.bisect_right(starts, t)
    for j in range(k - 1, -1, -1):
        s, e, name = host[j]
        if s <= t < e:
            return name
    return "none"


SPAN_NAMES = {"upscale.frame", "upscale.pass", "upscale.scatter",
              "upscale.share", "upscale.gather", "upscale.between",
              "train.step", "train.replay", "train.eager",
              "train.read_metrics", "graph.capture", "warp.align",
              "warp.bwd"}


def main(argv=None) -> int:
    args = parse(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from port_bench import run
    run._environment()
    from mpgan_torch import tracing
    seen = windows(args.tracing == 1)
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds),
                   "--trace", "1" if args.tracing == 2 else "0"])
    if rc:
        return rc
    w = seen[-1]
    spans = tracing.spans()
    report = {"workload": args.workload, "seed": args.seed,
              "tracing": args.tracing, "window_s": w.wall_s,
              "spans": len(spans), "frames": frames(spans),
              "train_per_100": train(spans)}
    if w.prof is not None:
        report["by_span"] = by_span(w.prof, SPAN_NAMES,
                                    [d.index for d in w.devices])
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
