"""Data parallelism of the port on the CPU over gloo: the process-group
helpers (``mpgan_torch.parallel.mesh``), sharded residency against the
JAX package's ``_shard_dense``, slice-sharded assembly over a device list,
the lead-gated run dir, the CLI flags, and two child-process runs: two
ranks against one process (1e-5, float sums in another order) and
``dryrun_multichip(2)``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dp_child as C
from mpgan_torch import cli
from mpgan_torch.data import pipeline as TP
from mpgan_torch.dryrun import dryrun_multichip
from mpgan_torch.infer import assemble
from mpgan_torch.models import generator as G
from mpgan_torch.parallel import mesh as pmesh
from mpgan_torch.train import checkpoint as ckpt
from mpgan_torch.train import loop
from mpgan_torch.utils import preview
from mpgan_tpu.data import pipeline as JP

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")


@pytest.fixture
def group(tmp_path):
    """This process as the only rank of a gloo group (a FileStore)."""
    pmesh.init_distributed("file://" + str(tmp_path / "store"), 1, 0,
                           "gloo")
    try:
        yield
    finally:
        pmesh.shutdown()


def _dense(n_vols, seed, empty_vols=()):
    rng = np.random.default_rng(seed)
    cells = np.argwhere(rng.random((n_vols, 3, 4, 4)) > 0.6)
    keep = ~np.isin(cells[:, 0], list(empty_vols))
    return cells[keep].astype(np.int32)


@pytest.mark.parametrize("n_shards,empty,temporal", [
    (2, (), None), (4, (), 3), (2, (3, 4, 5), None), (3, (2, 3), 2)])
def test_shard_dense_matches_jax(n_shards, empty, temporal):
    """Equal arrays, including a shard with no dense cell (the uniform
    lattice, subsampled; its temporal frame filter)."""
    n_vols = 6 if n_shards != 4 else 12
    dense = _dense(n_vols, 11, empty)
    args = (dense, n_shards, n_vols // n_shards, (3, 4, 4))
    got = TP._shard_dense(*args, temporal_frames=temporal)
    want = JP._shard_dense(*args, temporal_frames=temporal)
    np.testing.assert_array_equal(got, want)


def test_shard_over_keeps_a_block_of_whole_sims():
    ds = C.dp_dataset()
    tc = TP.TileCreator(ds, 4, 0.0, device="cpu")
    whole = tc.dense_idx_t.numpy()
    assert not tc.shard_over(4, 0)             # 2 sims over 4: whole stays
    assert tc.shard_over(2, 1) and tc.shard_over(2, 1)
    with pytest.raises(RuntimeError):
        tc.shard_over(2, 0)
    np.testing.assert_array_equal(tc.lr.numpy(), ds.lr[3:])
    np.testing.assert_array_equal(tc.hrz.shape, (3, 8, 16, 16, 1))
    blocks = JP._shard_dense(whole.astype(np.int32), 2, 3, (4, 4, 4),
                             temporal_frames=3)
    np.testing.assert_array_equal(tc.dense_idx_t.numpy(),
                                  blocks[len(blocks) // 2:])
    b = tc.sample_pass1(torch.Generator().manual_seed(0), 4, True)
    assert b["lr"].shape == (4, 4, 4, 4)


def test_sharded_sampler_needs_a_dividing_batch():
    tc = TP.TileCreator(C.dp_dataset(), 4, 0.0, device="cpu")
    tc.shard_over(2, 0)
    with pytest.raises(ValueError, match="must divide"):
        loop.make_sampler(tc, 1, 7, False, data_sharded=True)
    assert loop.make_sampler(tc, 1, 8, False, True)(
        torch.Generator().manual_seed(1))["lr"].shape[0] == 4


def test_rows_and_device_lists():
    assert [pmesh.row_range(10, 4, r) for r in range(4)] == [
        (0, 3), (3, 6), (6, 8), (8, 10)]
    x = torch.arange(10)
    assert torch.equal(torch.cat([pmesh.shard_rows(x, 4, r)
                                  for r in range(4)]), x)
    with pytest.raises(ValueError):
        pmesh.row_range(2, 4, 0)
    assert pmesh.make_mesh(3, [CPU] * 4) == [CPU] * 3
    with pytest.raises(RuntimeError, match="requested 5"):
        pmesh.make_mesh(5, [CPU] * 4)
    assert (pmesh.world(), pmesh.rank(), pmesh.is_lead()) == (1, 0, True)


@pytest.mark.parametrize("chunk", [0, 7])
def test_apply_sliced_over_devices_equals_one_device(chunk):
    """13 slices (not a multiple of 4) over [cpu] * 4 equal the
    one-device call, unchunked and in chunks."""
    gen = G.make_pass1(2, base_filters=8, n_res_blocks=1)
    x = torch.from_numpy(np.random.default_rng(2).random(
        (13, 8, 8, 4), dtype=np.float32))
    with torch.inference_mode():
        want = assemble.pass1_volume(gen, x, chunk=chunk)
        got = assemble.pass1_volume(gen, x, chunk=chunk, devices=[CPU] * 4)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_world_of_one_collectives_and_run_dir(group, tmp_path):
    """In a group of one: the mean is the tensor, the share weighs it, a
    replicated set passes its check, and rank 0 allocates the run dir."""
    a = torch.tensor([1.0, 2.0])
    b = torch.tensor([[3.0]], dtype=torch.float64)
    pmesh.all_reduce_mean([a, b])
    assert a.tolist() == [1.0, 2.0] and b.item() == 3.0
    pmesh.all_reduce_mean([a], share=0.25)
    assert a.tolist() == [0.25, 0.5]
    pmesh.replicate([a, b])
    pmesh.check_replicated([a, b])
    assert pmesh.broadcast_int(7) == 7 and pmesh.world() == 1
    base = str(tmp_path / "runs")
    assert os.path.basename(ckpt.next_run_dir(base)) == "test_0000"
    assert os.path.basename(ckpt.next_run_dir(base)) == "test_0001"
    with pytest.raises(RuntimeError, match="already joined"):
        pmesh.init_distributed("file://" + str(tmp_path / "x"), 1, 0, "gloo")


def test_cli_world_of_one_equals_no_flags(tmp_path, monkeypatch):
    """``out 0`` with ``coordinator``/``numProcesses 1``/``processId 0``
    trains through a gloo group of one and ends in the state of the run
    without them; ``out 1`` refuses the flags."""
    from mpgan_torch.data import loader
    from mpgan_torch.io import uni

    monkeypatch.setattr(preview, "summary_writer_class", lambda: None)
    rng = np.random.default_rng(0)
    d = tmp_path / "data" / "sim_1000"
    d.mkdir(parents=True)
    for f in range(3):
        uni.write_density(str(d / (loader.LOW_DENSITY % f)),
                          rng.random((8, 8, 8), dtype=np.float32))
        uni.write_velocity(str(d / (loader.LOW_VELOCITY % f)),
                           rng.random((8, 8, 8, 3), dtype=np.float32) - 0.5)
        uni.write_density(str(d / (loader.HIGH_DENSITY % f)),
                          rng.random((16, 16, 16), dtype=np.float32))
    common = (f"basePath {tmp_path}/data/ fromSim 1000 toSim 1000 frameMax 3 "
              "upRes 2 tileSizeLow 4 genFilters 8 discFilters 8 genBlocks 1 "
              "dtype float32 device cpu batchSize 2 trainingIters 2 out 0 ")
    store = f"file://{tmp_path}/store"
    cli.main((common + f"testPath {tmp_path}/a/ coordinator {store} "
              "numProcesses 1 processId 0").split())
    assert not pmesh.distributed()
    cli.main((common + f"testPath {tmp_path}/b/").split())
    got, want = (ckpt.restore(ckpt.run_dir(f"{tmp_path}/{n}", 0), 0, "cpu")
                 for n in "ab")
    assert got[1] == want[1]
    for net in ("gen", "ds", "dt"):
        for k, v in want[0][net].items():
            assert torch.equal(got[0][net][k], v), (net, k)
    with pytest.raises(SystemExit, match="one host"):
        cli.main((common.replace("out 0", "out 1") + f"testPath "
                  f"{tmp_path}/c/ coordinator {store} numProcesses 1").split())


def test_two_gloo_ranks_equal_one_process(tmp_path):
    """Two ranks at global batch 8 (replicated residency) end where one
    process at batch 8 ends (1e-5, and within 1e-2 of how far that run
    moved from the initial state), while a planted fault (gradients
    summed over the ranks, not averaged) lands beyond both limits;
    sharded residency engages with half the volumes per rank and the
    ranks agree; both ranks use one run dir and restore one
    checkpoint."""
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dp_child.py"), str(r),
         "2", str(tmp_path / "store"), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out[-2000:] + err[-3000:]
    res = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    assert [r["world"] for r in res] == [2, 2]
    assert not res[0]["replicated_sharded"]
    assert all(r["sharded"] and r["local_vols"] == 3 for r in res)
    assert res[0]["sharded_g_loss"] == res[1]["sharded_g_loss"]
    assert {r["run"] for r in res} == {"test_0000"}
    assert res[0]["leaf"] == res[1]["leaf"]
    assert res[0]["restored_it"] == res[1]["restored_it"] == 2
    assert os.path.isdir(tmp_path / "runs" / "test_0000" / "model_0000")

    cfg = C.dp_config()
    tc = TP.TileCreator(C.dp_dataset(), 4, 0.0, device="cpu")
    tr = loop.Trainer(cfg, tc, device="cpu")
    tr.runtime()
    init = C.state_of(tr)
    one = tr.fit(2)
    want = C.state_of(tr)

    def gap_to_one(got):
        assert set(got) == set(want)
        return max(float((got[k] - want[k]).abs().max()) for k in want)

    moved = gap_to_one(init)
    for r in range(2):
        gap = gap_to_one(torch.load(tmp_path / f"rank{r}_replicated.pt"))
        assert gap <= 1e-5 and gap <= 1e-2 * moved, (r, gap, moved)
        fault = gap_to_one(torch.load(tmp_path / f"rank{r}_summed.pt"))
        assert fault > 1e-5 and fault > 1e-2 * moved, (r, fault, moved)
    assert res[0]["replicated_g_loss"] == pytest.approx(one["g_loss"],
                                                        rel=1e-5)


@pytest.mark.parametrize("device, share, err", [
    ("tpu", False, ValueError), ("cuda", False, RuntimeError),
    ("cuda", True, RuntimeError)])
def test_dryrun_multichip_refuses_without_its_device(device, share, err,
                                                    monkeypatch):
    """No CPU fallback: without a card the CUDA dry run raises (shared
    or not), as does a device that is neither CUDA nor the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(err):
        dryrun_multichip(2, device, share_cards=share)


def test_dryrun_multichip_two_ranks():
    """The flagship shape over two gloo ranks: stages 1 and 2, a fade α
    below 1 then 1, finite losses, sharded residency, ranks agreeing."""
    out = dryrun_multichip(2, "cpu")
    assert out["ranks"] == 2 and out["data_sharded"]
    assert out["stages"] == [1, 2] and out["vols_per_rank"] == 3
    assert min(out["alphas_stage2"]) < 1.0 == max(out["alphas_stage2"])
