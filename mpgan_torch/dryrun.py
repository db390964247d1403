"""Multi-rank dry run of the flagship training shape — counterpart of
``__graft_entry__.py`` ``dryrun_multichip``.

    python -m mpgan_torch.dryrun 2 [cuda|cpu] [share]

``dryrun_multichip(n)`` starts ``n`` ranks (spawned processes) and runs the
flagship configuration's shape at tiny sizes through the data-parallel
trainer: progressive growing across the stage 1→2 boundary (parameter and
EMA migration, then re-replication), the fade and stable stage-2 steps,
the temporal discriminator with the warp, bf16 models and sharded
residency (one sim per rank). It checks what the JAX dry run checks:
stages {1, 2} seen, a fade α below 1 then 1, finite losses, and the ranks
agreeing (their nets and EMA bit for bit, the all-reduced metrics
exactly). → rank 0's summary.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch


def _rank_body(rank: int, n: int, device: str, backend: str, url: str,
               out_dir: str) -> None:
    from mpgan_torch.config import (Config, DataConfig, LossConfig,
                                    ModelConfig, TrainConfig)
    from mpgan_torch.data.loader import FluidDataset
    from mpgan_torch.data.pipeline import TileCreator
    from mpgan_torch.parallel import mesh as pmesh
    from mpgan_torch.train import loop

    torch.set_num_threads(1)
    if device == "cpu":
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    pmesh.init_distributed(url, n, rank, backend)
    try:
        rng = np.random.default_rng(0)
        s, n_vols = 4, 3 * n
        lr = rng.random((n_vols, 8, 16, 16, 4), dtype=np.float32)
        hr = rng.random((n_vols, 8 * s, 16 * s, 16 * s, 1), dtype=np.float32)
        ds = FluidDataset(lr=lr, hr=hr, n_sims=n, n_frames=3, up_res=s)
        tc = TileCreator(ds, 8, density_threshold=0.0, device=dev)
        cfg = Config(
            data=DataConfig(tile_size_low=8, up_res=s),
            model=ModelConfig(n_base_filters=8, n_res_blocks=1,
                              disc_base_filters=8, stages=2,
                              dtype="bfloat16"),
            loss=LossConfig(),
            train=TrainConfig(batch_size=2 * n, use_temporal_disc=True,
                              use_growing=True, alpha_iters=2,
                              stable_iters=2, ema_decay=0.9,
                              training_iters=7, output_interval=1,
                              save_interval=0))
        tr = loop.Trainer(cfg, tc, device=dev)
        assert n == 1 or tr.data_sharded, "sharded residency must engage"
        assert tc.lr.shape[0] == n_vols // n, tc.lr.shape
        # its 0-3: stage 1; 4-5: stage 2 fading in (α 0, 0.5); 6: stable
        tr.fit(iters=7, log_every=1)
        log = tr.metrics_log
        stages = sorted({m["stage"] for m in log})
        assert stages == [1, 2], stages
        alphas2 = [m["alpha"] for m in log if m["stage"] == 2]
        assert min(alphas2) < 1.0 and max(alphas2) == 1.0, alphas2
        for m in log:
            assert np.isfinite(m["g_loss"]) and np.isfinite(m["dt_loss"]), m
        rt = tr.rt
        pmesh.check_replicated(
            [t for net in (rt.gen, rt.ds, rt.dt)
             for t in net.state_dict().values()] + list(rt.ema.values()))
        losses = torch.tensor([[m[k] for k in ("d_loss", "dt_loss",
                                               "g_loss")] for m in log],
                              dtype=torch.float64, device=dev)
        pmesh.check_replicated([losses])
        summary = {"ranks": n, "backend": backend, "device": str(dev),
                   "data_sharded": tr.data_sharded, "stages": stages,
                   "alphas_stage2": alphas2,
                   "vols_per_rank": int(tc.lr.shape[0]),
                   "metrics": [{k: m[k] for k in ("it", "stage", "alpha",
                                                  "d_loss", "dt_loss",
                                                  "g_loss")} for m in log]}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(summary, f)
    finally:
        pmesh.shutdown()


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     share_cards: bool = False) -> dict:
    """Run the dry run over ``n_devices`` ranks → rank 0's summary.

    ``device="cuda"``: one card per rank over NCCL; raises when no card or
    fewer than ``n_devices`` cards are visible, unless ``share_cards``,
    which puts the ranks on the visible cards round robin over gloo (NCCL
    refuses two ranks on one card). ``"cpu"``: gloo ranks on the CPU (the
    JAX dry run's virtual CPU mesh)."""
    if device == "cpu":
        backend = "gloo"
    elif device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA card is visible; "
                               "pass device='cpu' to run on the CPU")
        cards = torch.cuda.device_count()
        if cards >= n_devices:
            backend = "nccl"
        elif share_cards:
            backend = "gloo"
        else:
            raise RuntimeError(
                f"dryrun_multichip: {n_devices} ranks but {cards} visible "
                "cards; pass share_cards=True to share them over gloo")
    else:
        raise ValueError(f"dryrun_multichip: device {device!r} is not "
                         "'cuda' or 'cpu'")
    with tempfile.TemporaryDirectory() as d:
        url = "file://" + os.path.join(d, "store")
        torch.multiprocessing.start_processes(
            _rank_body, args=(n_devices, device, backend, url, d),
            nprocs=n_devices, start_method="spawn")
        with open(os.path.join(d, "rank0.json")) as f:
            out = json.load(f)
    print(f"dryrun_multichip({n_devices}): ok ({out['backend']} on "
          f"{device}, data_sharded={out['data_sharded']}, bf16, growing 2 "
          "stages)")
    for m in out["metrics"]:
        print(f"  it {m['it']}: stage {m['stage']} alpha {m['alpha']:.2f} "
              f"g_loss {m['g_loss']:.4f} d_loss {m['d_loss']:.4f} "
              f"dt_loss {m['dt_loss']:.4f}")
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda",
                     share_cards=sys.argv[3:4] == ["share"])
