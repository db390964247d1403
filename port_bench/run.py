"""Run one cell of the port's benchmark once and print its result.

    python3 port_bench/run.py --workload mpgan-4x.frames --seed 7 \
        --seconds 10 --trace 0

Loads the cell that ``BENCHMARK.json`` names (its configuration, traffic
mix and metrics, each found by name), makes the weights and inputs on the
card from ``--seed``, warms up the cell's own shapes, measures for
``--seconds`` (``--trace 1``: a shorter window under the profiler, for the
per-layer metrics), compares what the timed path produced with the plain
reference, and prints one JSON object as the last line of its output:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (with
``--trace 1`` also ``breakdown``) and, last, ``checks``, each number
compared beside its limit (the same lines end its standard error).

Exits non-zero and prints no result when there is no CUDA card, fewer
cards than the cell asks for, when the program cannot be imported, or when
a module of JAX or of the JAX package was loaded (top-level names compared
whole). Build and kernel caches stay in ``.portbench_cache/`` of the
checkout.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")


def _environment() -> None:
    """Fixed cache directories inside the checkout, set before torch is
    imported; no library is let to load JAX."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_limits(cell: str) -> dict:
    path = os.path.join(ROOT, "port_bench", "limits", f"{cell}.json")
    with open(path) as fh:
        return json.load(fh)


def per_layer(spec: list[dict], record: dict) -> dict:
    """Each per-layer metric's reader over the run's record; a reader that
    finds nothing returns None, and the metric is left out."""
    from port_bench import manifest
    out = {}
    for m in spec:
        value = manifest.reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(devices) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(devices[0]),
            "count": len(devices)}


def result(res: dict, spec: dict, limits: dict, traced: bool,
           device: dict) -> dict:
    """The result line of a driver's run: ``correct`` when something was
    compared, nothing failed and every number is within its limit; with
    ``traced`` the per-layer metrics, the device's busy and window seconds
    and the breakdown, else the end-to-end metrics; ``checks`` last."""
    from port_bench import trace
    checks = {k: {"value": res["numbers"][k], "limit": limits[k]}
              for k in limits if k in res["numbers"]}
    correct = (res["checked"] > 0 and res["failed"] == 0
               and set(checks) == set(limits)
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    dev = {**device, "memory_peak_bytes": int(res["memory_peak_bytes"])}
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"])}
    if traced:
        summary = res["record"]["summary"]
        busy = summary.get("busy_s", {})
        dev["busy_s"] = sum(busy.values()) / max(len(busy), 1)
        dev["window_s"] = res["record"]["window_s"]
        out["metrics"] = per_layer(spec["per_layer"], res["record"])
        out["device"] = dev
        out["breakdown"] = trace.breakdown(summary)
    else:
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        out["metrics"] = {"setup_s": {"value": res["setup_s"], "unit": "s"},
                          **{k: {"value": v, "unit": units[k]}
                             for k, v in res["e2e"].items()}}
        out["device"] = dev
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    _environment()
    args = parse(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from port_bench import guard, manifest
    guard.check("before the run")
    spec = manifest.cell(manifest.load(ROOT), args.workload, ROOT)
    limits = load_limits(args.workload)
    import torch
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available():
        print("port_bench: no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"port_bench: the cell asks for {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    import importlib
    driver = importlib.import_module(
        f"port_bench.drivers.{spec['traffic']['kind']}")
    devices = [torch.device("cuda", i)
               for i in range(spec["traffic"].get("devices", 1))]
    ctx = {"seed": args.seed, "seconds": args.seconds,
           "trace": bool(args.trace), "config": spec["config"],
           "traffic": spec["traffic"], "cell": spec["cell"],
           "devices": devices, "t0": T0}
    res = driver.run(ctx)
    guard.check("after the window")
    out = result(res, spec, limits, bool(args.trace),
                 device_info(devices))
    where = res.get("where", {})
    for line in ctx.get("notes", []):
        print(line, file=sys.stderr)
    print(f"compared {res['checked']} outputs, {res['failed']} failed",
          file=sys.stderr)
    for k, v in res["numbers"].items():
        if k not in out["checks"]:
            at = f" (worst {where[k]})" if k in where else ""
            print(f"reading {k} {v!r}, not compared{at}", file=sys.stderr)
    for k, c in out["checks"].items():
        at = f" (worst {where[k]})" if k in where else ""
        print(f"check {k} {c['value']!r} limit {c['limit']!r}{at}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
