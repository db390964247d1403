"""The port's reference-style CLI, ``mpgan_torch.cli.main``, in process on
the CPU (``device cpu``), on ``.uni`` files written by the port's writer:
1 sim × 5 frames, 8³ LR (density + velocity) → 32³ HR, generators at base
8 with one res block, float32. The cases of ``tests/test_cli.py``: ``out
0`` writes a run dir (params.json, metrics, periodic and final
checkpoints); ``out 1`` writes volumes equal to ``upscale_volume`` of the
chain ``load_pass_chain`` loads; ``useEma`` falls back, ``writeTest``
skips done frames; ``resumeIndex`` and ``resumeLatest`` find finished
runs, ``resumeTest`` continues one and ``warmStartTest`` starts from its
generator; ``pass2Source g1`` and ``trainPass 3 pass3Source model`` train, and
a 3-pass ``out 1`` runs; unknown flags, incomplete multi-host flags and
the supervisor on a multi-host job abort. TensorBoard
mirroring is switched off (its import costs seconds here).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from mpgan_torch import cli, config
from mpgan_torch.data import loader
from mpgan_torch.infer import assemble, load
from mpgan_torch.io import uni
from mpgan_torch.train import checkpoint as ckpt
from mpgan_torch.utils import preview

torch.set_num_threads(1)

MODEL = ("upRes 4 tileSizeLow 4 useVelocities 1 genFilters 8 discFilters 8 "
         "genBlocks 1 dtype float32 device cpu")


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setattr(preview, "summary_writer_class", lambda: None)


def _run(capsys, args: str) -> str:
    cli.main(args.split())
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    d = base / "data" / "sim_1000"
    d.mkdir(parents=True)
    for f in range(5):
        uni.write_density(str(d / (loader.LOW_DENSITY % f)),
                          rng.random((8, 8, 8), dtype=np.float32))
        uni.write_velocity(str(d / (loader.LOW_VELOCITY % f)),
                           rng.random((8, 8, 8, 3), dtype=np.float32) - 0.5)
        uni.write_density(str(d / (loader.HIGH_DENSITY % f)),
                          rng.random((32, 32, 32), dtype=np.float32))
    return base


def _common(base, tp="runs"):
    return (f"basePath {base}/data/ fromSim 1000 toSim 1000 frameMax 5 "
            f"{MODEL} batchSize 2 testPath {base}/{tp}/ ")


def _config(base, tp="runs", extra=""):
    """The CLI's configuration of these flags (``device`` is the CLI's
    own flag, not the config's)."""
    args = _common(base, tp).replace("device cpu", "") + extra
    return config.from_cli(args.split())


@pytest.fixture(scope="module")
def trained(data):
    """Pass 1 with temporal D into runs/test_0000: 4 iterations, saves at
    2 and at the end; no EMA."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(preview, "summary_writer_class", lambda: None)
        cli.main((_common(data) + "out 0 trainingIters 4 saveInterval 2 "
                  "outputInterval 2 useTempoD 1 firstNN 1 randSeed 3"
                  ).split())
    return data


def test_out0_writes_the_run_dir(trained):
    run = os.path.join(trained, "runs", "test_0000")
    files = set(os.listdir(run))
    assert {"params.json", "metrics.csv", "metrics.jsonl", "model_0001",
            "model_0001.json", "gen_0001", "model_0002", "model_0002.json",
            "gen_0002", "preview_000002.png", "preview_000004.png"} <= files
    assert not any(f.startswith("gen_ema") or f.endswith(".tmp")
                   for f in files)
    assert ckpt.read_json(os.path.join(run, "params.json"))["pass_no"] == 1
    assert ckpt.read_json(os.path.join(run, "model_0002.json")) == {
        "it": 4, "stage": 2, "pass_no": 1, "up_res": 4, "total_iters": 4}
    assert ckpt.read_json(os.path.join(run, "model_0001.json"))["it"] == 2
    with open(os.path.join(run, "metrics.csv")) as f:
        rows = f.read().splitlines()
    assert len(rows) == 3 and "g_loss" in rows[0]
    # the generator save is the .npz pair the loaders read
    gen = load.load_generator_npz(ckpt.gen_path(run, 2), 1,
                                  _config(trained), "cpu")
    assert gen.factors == ((2, 2), (2, 2))


def _direct(base, chain, f):
    cfg = config.Config()
    lr = load.read_lr_frame(cfg, os.path.join(base, "data", "sim_1000"), f)
    with torch.inference_mode():
        return assemble.upscale_volume(*chain[:2], torch.from_numpy(lr), 4,
                                       gen3=chain[2]).numpy()


def test_out1_equals_upscale_volume_of_the_chain(trained, capsys):
    out = _run(capsys, _common(trained) + "out 1 load_model_test 0 "
               "outFrameMin 3 outFrameMax 5 writePng 1")
    out_dir = out.strip().splitlines()[-1].split()[-1]
    assert os.path.basename(out_dir) == "test_0001"
    chain = load.load_pass_chain(_config(trained, extra="load_model_test 0"),
                                 device="cpu")
    assert chain[1] is None and chain[2] is None
    for f in (3, 4):
        vol = uni.readUni(os.path.join(out_dir,
                                       f"source_1000_{f:04d}.uni"))[1]
        assert vol.shape == (32, 32, 32, 1)
        np.testing.assert_array_equal(vol, _direct(trained, chain, f))
        assert os.path.exists(os.path.join(out_dir,
                                           f"source_1000_{f:04d}.png"))


def test_use_ema_falls_back_and_write_test_skips_done_frames(trained,
                                                             capsys):
    args = _common(trained) + "out 1 load_model_test 0 useEma 1 writeTest 7 "
    cli.main((args + "outFrameMin 3 outFrameMax 4").split())
    cap = capsys.readouterr()
    assert "useEma: no gen_ema_0002" in cap.err
    out = _run(capsys, args + "outFrameMin 2 outFrameMax 5")
    assert "writeTest 7: skipping 1 already-written frames" in out
    out_dir = os.path.join(trained, "runs", "test_0007")
    assert sorted(os.listdir(out_dir)) == [
        f"source_1000_{f:04d}.uni" for f in (2, 3, 4)]


def test_resume_index_and_resume_latest_find_finished_runs(trained, capsys):
    out = _run(capsys, _common(trained) + "out 0 trainingIters 4 "
               "firstNN 1 resumeIndex 0")
    assert "resumeIndex 0: budget complete" in out
    assert "nothing to do" in out
    # a copy of the finished run, and a newer run of pass 2: resumeLatest
    # takes the newest run of its own pass and trains nothing
    tp = os.path.join(trained, "latest")
    shutil.copytree(os.path.join(trained, "runs", "test_0000"),
                    os.path.join(tp, "test_0000"))
    decoy = ckpt.model_dir(os.path.join(tp, "test_0001"), 0)
    os.makedirs(decoy)
    ckpt.write_json(decoy + ".json", {"pass_no": 2, "it": 9})
    before = sorted(os.listdir(os.path.join(tp, "test_0000")))
    out = _run(capsys, _common(trained, "latest") + "out 0 trainingIters 4 "
               "firstNN 1 saveInterval 2 resumeLatest 1 useTempoD 1")
    assert "resumeLatest: test_0000/model_0002" in out
    assert "budget already complete (model_0002)" in out
    assert sorted(os.listdir(os.path.join(tp, "test_0000"))) == before
    # resumeTest trains trainingIters more, into a new run dir
    out = _run(capsys, _common(trained, "latest") + "out 0 trainingIters 2 "
               "firstNN 1 saveInterval 0 resumeTest 0 useTempoD 1")
    assert "at iter 4; training to 6" in out
    assert ckpt.read_json(os.path.join(tp, "test_0002",
                                       "model_0000.json"))["it"] == 6
    # a generator-only warm start: fresh optimizers, iteration 0
    out = _run(capsys, _common(trained, "latest") + "out 0 trainingIters 1 "
               "firstNN 1 saveInterval 0 warmStartTest 0 useTempoD 1")
    assert "warm-started generator from" in out and "gen_0002" in out
    assert ckpt.read_json(os.path.join(tp, "test_0003",
                                       "model_0000.json"))["it"] == 1
    # a pinned index that holds another pass is refused
    with pytest.raises(SystemExit, match="another pass"):
        cli.main((_common(trained, "latest") + "out 0 firstNN 1 "
                  "resumeIndex 1").split())


def test_pass2_g1_and_pass3_model_train_then_three_pass_out1(trained,
                                                              capsys):
    tp = os.path.join(trained, "chain")
    shutil.copytree(os.path.join(trained, "runs", "test_0000"),
                    os.path.join(tp, "test_0000"))
    common = _common(trained, "chain") + "trainingIters 2 saveInterval 0 "
    out = _run(capsys, common + "out 0 firstNN 0 pass2Source g1 "
               "load_model_test 0 emaDecay 0.9")
    assert "precomputed 5 G1 intermediate volumes" in out
    assert "pass 2" in out and "done:" in out
    out = _run(capsys, common + "out 0 trainPass 3 pass3Source model "
               "load_model_test 0 load_model_test2 1")
    assert "precomputed 5 two-pass output volumes" in out
    assert "pass 3" in out and "done:" in out
    assert ckpt.read_json(os.path.join(tp, "test_0002", "model_0000.json")
                          )["pass_no"] == 3
    out = _run(capsys, _common(trained, "chain") + "out 1 load_model_test 0 "
               "load_model_test2 1 load_model_test3 2 outFrameMin 3 "
               "outFrameMax 4 useEma 1")
    cfg = _config(trained, "chain", "load_model_test 0 useEma 1")
    chain = load.load_pass_chain(cfg, 1, -1, 2, -1, device="cpu")
    assert chain[1].factors == ((2, 1), (2, 1))
    assert chain[2].factors == ((1, 1),)
    vol = uni.readUni(os.path.join(tp, "test_0003", "source_1000_0003.uni"))[1]
    assert vol.shape == (32, 32, 32, 1)
    np.testing.assert_array_equal(vol, _direct(trained, chain, 3))


@pytest.mark.parametrize("flags,match", [
    ("bogusFlag 1", None),
    # the supervisor refuses multi-host jobs
    pytest.param("retryOnError 1 numProcesses 2", "retryOnError",
                 id="retryOnError 1-retryOnError"),
    pytest.param("hangTimeout 30 coordinator localhost:1234", "hangTimeout",
                 id="hangTimeout 30-hangTimeout"),
    # a multi-host job needs both the coordinator and the process count
    ("coordinator localhost:1234", "coordinator"),
    ("numProcesses 2", "numProcesses"),
    ("pass2Source hr", "pass2Source"),
])
def test_unknown_and_unported_flags_abort(data, capsys, flags, match):
    with pytest.raises(SystemExit) as e:
        cli.main((_common(data) + "out 0 " + flags).split())
    if match:
        assert match in str(e.value)
    else:
        assert "bogusFlag" in capsys.readouterr().out
    assert not os.path.exists(os.path.join(data, "runs", "test_0009"))


def test_pipeline_split_and_compile_cache_are_accepted(trained, capsys):
    out = _run(capsys, _common(trained) + "out 1 load_model_test 0 "
               "outFrameMin 4 outFrameMax 5 pipelineSplit auto "
               "compileCache /nonexistent writeTest 8")
    assert "inference outputs" in out


def test_default_device_is_the_card(data):
    """Without ``device cpu`` the CLI asks for CUDA, and raises without
    it rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = _common(data).replace("device cpu", "") + "out 0"
    with pytest.raises(RuntimeError):
        cli.main(args.split())


def test_stdlib_png_decodes_with_pil(tmp_path):
    image = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(3).integers(0, 256, (7, 13), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    preview.save_png(path, img)
    with image.open(path) as im:
        assert im.mode == "L" and im.size == (13, 7)
        np.testing.assert_array_equal(np.asarray(im), img)
    cols = [np.random.default_rng(i).random((5, 4 << i, 4 << i, 1),
                                            dtype=np.float32)
            for i in range(3)]
    preview.save_patch_grid(str(tmp_path / "g.png"), cols)
    with image.open(str(tmp_path / "g.png")) as im:   # 4 rows of 3 columns
        assert im.size == (3 * 16, 4 * 16)
