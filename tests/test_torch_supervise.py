"""The port's supervisor (``retryOnError``, ``hangTimeout``) on the CPU.

- the CLI's flag helpers equal ``scripts/multipass_gan.py``'s on the same
  inputs;
- ``supervise_restartable`` adds its retry flags on a restart only (its
  child runner replaced, no process);
- three tests start processes: ``run_child_watched`` kills a stub child
  that stops heartbeating; ``retryOnError 1`` with ``MPGAN_FAIL_ONCE``
  recovers a tiny ``out 0 ... device cpu`` whose final checkpoint equals
  an uninterrupted run's; ``hangTimeout`` kills a child hung by
  ``MPGAN_HANG_ONCE`` and the restart finishes the run;
- ``MPGAN_FAIL_ONCE`` in ``out 1`` crashes after the first written frame,
  and a ``writeTest`` rerun skips it (in process).

The children import a stub ``tensorboard`` that refuses to load, so that
the run's metrics writer skips the TensorBoard mirror (its import costs
seconds); ``MPGAN_RETRY_DELAY_S`` is 0.
"""

import importlib.util
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mpgan_torch import cli
from mpgan_torch.data import loader
from mpgan_torch.io import uni
from mpgan_torch.train import checkpoint as ckpt
from mpgan_torch.utils import preview, supervise

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TRAIN = ("out 0 fromSim 1000 toSim 1000 frameMax 4 upRes 4 tileSizeLow 4 "
         "batchSize 2 trainingIters 4 saveInterval 2 outputInterval 2 "
         "genFilters 8 discFilters 8 genBlocks 1 dtype float32 useTempoD 1 "
         "randSeed 5 device cpu")


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_multipass_gan", os.path.join(ROOT, "scripts", "multipass_gan.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("sup")
    rng = np.random.default_rng(0)
    d = base / "data" / "sim_1000"
    d.mkdir(parents=True)
    for f in range(4):
        uni.write_density(str(d / (loader.LOW_DENSITY % f)),
                          rng.random((8, 8, 8), dtype=np.float32))
        uni.write_velocity(str(d / (loader.LOW_VELOCITY % f)),
                           rng.random((8, 8, 8, 3), dtype=np.float32) - 0.5)
        uni.write_density(str(d / (loader.HIGH_DENSITY % f)),
                          rng.random((32, 32, 32), dtype=np.float32))
    stub = base / "stub"
    stub.mkdir()
    for name in ("tensorboard", "tensorboardX"):
        (stub / f"{name}.py").write_text(
            "raise ImportError('TensorBoard is off in this test')\n")
    return base


def _child_env(data, **extra):
    env = dict(os.environ, MPGAN_RETRY_DELAY_S="0",
               PYTHONPATH=os.pathsep.join([str(data / "stub"), ROOT]))
    env.update(extra)
    return env


def _supervised(data, args, env, timeout=600):
    r = subprocess.run([sys.executable, "-m", "mpgan_torch.cli"]
                       + args.split(), capture_output=True, text=True,
                       cwd=str(data), env=env, timeout=timeout)
    assert r.returncode == 0, f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}"
    return r


def _final_state(run):
    state, meta = ckpt.restore(run, ckpt.latest_model_no(run), "cpu")
    flat = {}

    def walk(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{prefix}/{i}", v)
        elif torch.is_tensor(x):
            flat[prefix] = x.float()
    walk("", state)
    return flat, meta


@pytest.mark.parametrize("argv,name", [
    ("out 0 resumeLatest 1 trainingIters 4", "resumeLatest"),
    ("out 0 ResumeLatest 1 resumeIndex 3 x", "resumeindex"),
    ("out 1 writeTest 2", "writeTest"),
    ("out 0 retryOnError", "retryOnError"),
    ("", "out"),
])
def test_flag_helpers_match_the_jax_cli(argv, name, tmp_path):
    jcli = _jax_cli()
    toks = argv.split()
    assert cli._strip_flag(toks, name) == jcli._strip_flag(toks, name)
    assert cli._has_flag(toks, name) == jcli._has_flag(toks, name)
    for tree in ("full", "empty"):
        subs = (("test_0000", "test_0003", "test_12", "test_x", "model_0009")
                if tree == "full" else ())
        for side in ("jax", "port"):
            os.makedirs(tmp_path / side / tree)
            for sub in subs:
                (tmp_path / side / tree / sub).mkdir()
        for create in (False, True, True):
            want = jcli._next_run_index(str(tmp_path / "jax" / tree), create)
            got = cli._next_run_index(str(tmp_path / "port" / tree), create)
            assert got == want
        assert sorted(os.listdir(tmp_path / "port" / tree)) == sorted(
            os.listdir(tmp_path / "jax" / tree))
    assert cli._next_run_index(str(tmp_path / "port" / "new")) == 0


def test_supervise_restartable_adds_retry_flags_on_restart(monkeypatch,
                                                           tmp_path):
    cmds, rcs = [], iter([1, 0])

    def fake_run(cmd, env):
        cmds.append((cmd, env.get("CHILD")))
        return next(rcs)
    monkeypatch.setattr(supervise, "run_child", fake_run)
    monkeypatch.setenv("MPGAN_RETRY_DELAY_S", "0")
    rc = supervise.supervise_restartable(
        "mpgan_torch.datagen", ["a", "1", "SKIPEXISTING", "0"], 1, 0.0,
        "CHILD", str(tmp_path), ("skipExisting", "1", "resume", "1"))
    assert rc == 0
    assert [c[1] for c in cmds] == ["1", "1"]
    assert cmds[0][0][1:] == ["-m", "mpgan_torch.datagen", "a", "1",
                              "SKIPEXISTING", "0"]
    assert cmds[1][0][3:] == ["a", "1", "SKIPEXISTING", "0", "resume", "1"]


def test_run_child_watched_kills_a_silent_child(tmp_path, monkeypatch):
    """A child that touches its heartbeat once and then sleeps is killed,
    with its group, after hangTimeout plus the drain window."""
    monkeypatch.setenv("MPGAN_STARTUP_GRACE_S", "1")
    hb = str(tmp_path / "hb")
    env = dict(os.environ, MPGAN_HEARTBEAT=hb)
    code = ("import os, time; time.sleep(0.2); "
            "os.utime(os.environ['MPGAN_HEARTBEAT']); time.sleep(300)")
    t = time.time()
    rc = supervise.run_child_watched([sys.executable, "-c", code], env, 1.0,
                                     hb)
    assert rc == -9
    assert time.time() - t < 60


def test_retry_on_error_recovers_out0_to_the_uninterrupted_state(data,
                                                                  capsys):
    sentinel = str(data / "fail_once")
    args = (f"{TRAIN} basePath {data}/data/ testPath {data}/sup_runs/ "
            "retryOnError 1")
    r = _supervised(data, args, _child_env(data, MPGAN_FAIL_ONCE=sentinel))
    assert os.path.exists(sentinel)                   # the fault fired
    assert "injected fault after the checkpoint at it=2" in r.stderr
    assert "retryOnError: training child died" in r.stdout
    assert "resumeIndex 0: resuming model_0001" in r.stdout
    assert not any(f.startswith((".rundir", ".heartbeat"))
                   for f in os.listdir(data / "sup_runs"))
    # the same run in process, uninterrupted
    with pytest.MonkeyPatch.context() as m:
        m.setattr(preview, "summary_writer_class", lambda: None)
        cli.main(f"{TRAIN} basePath {data}/data/ testPath {data}/plain/"
                 .split())
    capsys.readouterr()
    got, meta = _final_state(ckpt.run_dir(str(data / "sup_runs"), 0))
    want, want_meta = _final_state(ckpt.run_dir(str(data / "plain"), 0))
    assert meta == want_meta and meta["it"] == 4
    assert set(got) == set(want)
    gap = max(float((got[k] - want[k]).abs().max()) for k in want)
    assert gap <= 1e-6, gap


def test_hang_timeout_kills_a_hung_child_and_resumes(data):
    sentinel = str(data / "hang_once")
    args = (f"{TRAIN} basePath {data}/data/ testPath {data}/hang_runs/ "
            "retryOnError 1 hangTimeout 3")
    r = _supervised(data, args, _child_env(data, MPGAN_HANG_ONCE=sentinel))
    assert os.path.exists(sentinel)
    assert "MPGAN_HANG_ONCE: hanging at it=2" in r.stdout
    assert "; killing it" in r.stdout
    assert "retryOnError: training child died (rc=-9)" in r.stdout
    assert "resumeIndex 0: resuming model_0001" in r.stdout
    run = ckpt.run_dir(str(data / "hang_runs"), 0)
    assert ckpt.read_json(ckpt.model_dir(run, 2) + ".json")["it"] == 4
    assert not any(f.startswith(".heartbeat")
                   for f in os.listdir(data / "hang_runs"))


def test_fail_once_in_out1_then_write_test_skips_the_frame(data, capsys,
                                                          monkeypatch):
    monkeypatch.setattr(preview, "summary_writer_class", lambda: None)
    runs = f"{data}/infer_runs/"
    common = (f"basePath {data}/data/ fromSim 1000 toSim 1000 frameMax 4 "
              "upRes 4 genFilters 8 discFilters 8 genBlocks 1 dtype float32 "
              f"testPath {runs} device cpu ")
    cli.main((common + "out 0 tileSizeLow 4 batchSize 2 trainingIters 1 "
              "useTempoD 0").split())
    sentinel = str(data / "fail_once_out1")
    monkeypatch.setenv("MPGAN_FAIL_ONCE", sentinel)
    infer = common + "out 1 load_model_test 0 outFrameMin 0 outFrameMax 3 "
    with pytest.raises(RuntimeError, match="after writing sim 1000 frame 0"):
        cli.main((infer + "writeTest 5").split())
    out_dir = os.path.join(runs, "test_0005")
    assert os.listdir(out_dir) == ["source_1000_0000.uni"]
    assert os.path.exists(sentinel)
    capsys.readouterr()
    cli.main((infer + "writeTest 5").split())
    assert "writeTest 5: skipping 1 already-written frames" in \
        capsys.readouterr().out
    assert sorted(os.listdir(out_dir)) == [
        f"source_1000_{f:04d}.uni" for f in range(3)]
