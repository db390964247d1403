"""BENCHMARK.json against the benchmark's contract, the discovery of each
cell's files by name, the check for JAX's modules, and the result line."""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys

import pytest

from port_bench import guard, manifest, run
from port_bench.tests import tiny

ROOT = manifest.ROOT
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load(ROOT)


def test_top_level_keys_and_size(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word
        assert not word.startswith("/") and ".." not in word.split("/")
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert os.path.isdir(os.path.join(ROOT, p))
    script = bench["command"][1]
    assert any(script.startswith(p + "/") for p in bench["paths"])


def _names(items):
    return [i["name"] for i in items]


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_allowed_and_distinct(bench, section):
    names = _names(bench[section])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.fullmatch(n), n
    if section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            assert UNIT.fullmatch(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES


def test_entries_have_only_the_contract_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.fullmatch(k)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.fullmatch(w["traffic"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    for item in bench["configs"] + bench["workloads"]:
        assert 1 <= len(item["why"]) <= 200 and "\n" not in item["why"]
        assert "\t" not in item["why"]


def test_four_chip_cells_are_at_most_a_quarter(bench):
    cells = bench["workloads"]
    four = sum(1 for w in cells if w["chips"] == 4)
    assert four <= max(len(cells) // 4, 1)


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    used = set()
    for w in bench["workloads"]:
        spec = manifest.cell(bench, w["name"], ROOT)
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"], w["name"]
        for m in spec["per_layer"]:
            assert m["moves"] in names
        used.add(w["config"])
    assert used == set(_names(bench["configs"]))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_layers_are_named_alike(bench):
    by_layer = {}
    for m in bench["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_shares_of_a_roofline_or_a_peak_are_named_so(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any(m["name"].startswith("mfu") for m in bench["per_layer"])


def test_configuration_files_lie_under_paths(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("cell", ["mpgan-4x.frames", "mpgan-4x.train",
                                  "mpgan-8x.frames-4card"])
def test_each_cell_finds_its_files_by_name(bench, cell):
    spec = manifest.cell(bench, cell, ROOT)
    assert spec["cell"]["name"] == cell
    assert spec["traffic"]["kind"] in ("frames", "train")
    assert spec["traffic"].get("devices", 1) <= spec["cell"]["chips"]
    limits = run.load_limits(cell)
    assert limits and all(v > 0 for v in limits.values())
    for m in spec["per_layer"]:
        read = manifest.reader(m["name"])
        assert read({}) is None
        assert read({"summary": {}, "units": 0, "window_s": 0}) is None


@pytest.mark.parametrize("metric,file", [
    ("mfu.frames", "mfu.py"), ("mfu.train", "mfu.py"),
    ("device_idle_pct.frames", "device_idle_pct.py"),
    ("device_idle_pct.train", "device_idle_pct.py"),
    ("upscaler.launches_per_frame", "upscaler.launches_per_frame.py"),
    ("warp_roofline", "warp_roofline.py")])
def test_a_metric_finds_its_reader_by_name_or_stem(metric, file):
    path = manifest.reader_path(metric)
    assert os.path.basename(path) == file and os.path.exists(path)


def test_every_reader_serves_a_metric(bench):
    """No reader file is left that no per-layer metric reads."""
    used = {os.path.basename(manifest.reader_path(m["name"]))
            for m in bench["per_layer"]}
    files = {f for f in os.listdir(os.path.join(ROOT, "port_bench",
                                                "metrics"))
             if f.endswith(".py")}
    assert files == used


def test_an_unknown_cell_is_refused(bench):
    with pytest.raises(KeyError):
        manifest.cell(bench, "no-such.cell", ROOT)


def test_forbidden_modules_are_compared_by_whole_top_level_name():
    mods = ["mpgan_torch", "mpgan_torch.serve", "mpgan_tpu_extra",
            "jaxtyping", "jax", "jax.numpy", "flax.linen", "optax",
            "orbax.checkpoint", "jaxlib.xla_client", "mpgan_tpu.models"]
    assert guard.loaded_forbidden(mods) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "mpgan_tpu.models", "optax", "orbax.checkpoint"]


def test_the_harness_loads_no_jax():
    """Everything a run imports, in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import port_bench.run, port_bench.control, port_bench.trace\n"
        "import port_bench.drivers.frames, port_bench.drivers.train\n"
        "import mpgan_torch.infer.assemble\n"
        "import mpgan_torch.train.loop, mpgan_torch.data.pipeline\n"
        "from port_bench import guard\n"
        "print(guard.loaded_forbidden())\n" % ROOT)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_prints_no_result():
    """This sandbox has no CUDA card: the run exits non-zero, silently on
    its standard output."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "port_bench", "run.py"),
         "--workload", "mpgan-4x.frames", "--seed", "3000000000",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    assert out.returncode != 0 and out.stdout.strip() == ""


def _tiny_result(monkeypatch, traced: bool):
    from mpgan_torch.train import graphed
    from port_bench.drivers import frames
    monkeypatch.setattr(graphed, "Graph", tiny.EagerGraph)
    ctx = tiny.context("frames")
    res = frames.run(ctx)
    if traced:
        res["record"]["summary"] = {
            "busy_s": {0: 0.05}, "kernel_s": {"k": 0.05}, "launches":
            {"cudaGraphLaunch": res["attempted"]}, "idle_gaps": {"python":
                                                                  0.01}}
    bench = manifest.load(ROOT)
    spec = manifest.cell(bench, "mpgan-4x.frames", ROOT)
    return run.result(res, spec, run.load_limits("mpgan-4x.frames"), traced,
                      {"platform": "gpu", "kind": "test", "count": 1})


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line(monkeypatch, traced):
    out = _tiny_result(monkeypatch, traced)
    keys = list(out)
    assert keys[:3] == ["correct", "attempted", "failed"]
    assert keys[-1] == "checks"
    assert {"metrics", "device"} <= set(keys)
    assert out["correct"] is True
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["metrics"]) == {"upscaler.launches_per_frame",
                                       "mfu.frames", "device_idle_pct.frames"}
        assert out["metrics"]["upscaler.launches_per_frame"]["value"] == 1.0
        bd = out["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in bd.values())
    else:
        assert set(out["metrics"]) == {"setup_s", "frame_vox_per_s"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out, allow_nan=False)
