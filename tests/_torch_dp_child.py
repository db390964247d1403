"""One rank of the two-rank data-parallel test
(``tests/test_torch_parallel.py``), on the CPU over gloo.

Usage: python tests/_torch_dp_child.py <rank> <world> <store> <out_dir>

(a) replicated residency: 2 steps at the test's global batch, the final
state saved for the parent to hold against a one-process run; (b) sharded
residency: the rank's card (here its tensors) holds half of the volumes,
2 steps, ranks agree bit for bit; (c) rank 0 allocates one run dir for
both, the lead saves a checkpoint, every rank restores it; (d) a planted
fault: (a) again with each gradient summed over the ranks instead of
averaged, which the parent's check must catch. Writes ``rank<r>.json``,
``rank<r>_replicated.pt`` and ``rank<r>_summed.pt`` into ``out_dir``.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)


def dp_config():
    """Pass 1, one stage (2×), base 8, temporal D, global batch 8, float32
    with adamEps 1 and ganLoss sce, where the update is smooth in the
    gradient and float sums in another order stay within 1e-5."""
    from mpgan_torch.config import (Config, DataConfig, LossConfig,
                                    ModelConfig, TrainConfig)

    return Config(
        data=DataConfig(tile_size_low=4, up_res=2, density_threshold=0.0),
        model=ModelConfig(n_base_filters=8, n_res_blocks=1,
                          disc_base_filters=8, stages=1, dtype="float32"),
        loss=LossConfig(gan_loss="sce", gp_weight=1.0),
        train=TrainConfig(batch_size=8, use_temporal_disc=True,
                          adam_eps=1.0, ema_decay=0.9, save_interval=0,
                          output_interval=1, rand_seed=3))


def dp_dataset():
    """2 sims × 3 frames, 8³ LR (density + velocity) → 16³ HR."""
    from mpgan_torch.data.loader import FluidDataset

    rng = np.random.default_rng(7)
    lr = rng.random((6, 8, 8, 8, 4), dtype=np.float32)
    hr = rng.random((6, 16, 16, 16, 1), dtype=np.float32)
    return FluidDataset(lr=lr, hr=hr, n_sims=2, n_frames=3, up_res=2)


def state_of(tr):
    """Every net parameter and EMA tensor of a trainer, by name."""
    rt = tr.rt
    out = {f"{n}.{k}": v.detach().clone() for n in ("gen", "ds", "dt")
           for k, v in getattr(rt, n).state_dict().items()}
    out.update({f"ema.{k}": v.clone() for k, v in rt.ema.items()})
    return out


def main():
    rank, world, store, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4])
    from mpgan_torch.data.pipeline import TileCreator
    from mpgan_torch.parallel import mesh as pmesh
    from mpgan_torch.train import checkpoint as ckpt
    from mpgan_torch.train import loop

    pmesh.init_distributed("file://" + store, world, rank, "gloo")
    try:
        cfg, ds = dp_config(), dp_dataset()
        res = {"rank": rank, "world": pmesh.world()}

        tc = TileCreator(ds, cfg.data.tile_size_low, 0.0, device="cpu")
        tr = loop.Trainer(cfg, tc, device="cpu", shard_data=False)
        res["replicated_sharded"] = tr.data_sharded
        out = tr.fit(2)
        res["replicated_g_loss"] = out["g_loss"]
        torch.save(state_of(tr), os.path.join(out_dir,
                                                f"rank{rank}_replicated.pt"))

        tc = TileCreator(ds, cfg.data.tile_size_low, 0.0, device="cpu")
        tr = loop.Trainer(cfg, tc, device="cpu")
        res["sharded"] = tr.data_sharded
        res["local_vols"] = int(tc.lr.shape[0])
        out = tr.fit(2)
        res["sharded_g_loss"] = out["g_loss"]
        pmesh.check_replicated(list(state_of(tr).values()))

        run = ckpt.next_run_dir(os.path.join(out_dir, "runs"))
        tr.save(run, 0, 2)
        it = tr.restore(run, 0)
        res.update(run=os.path.basename(run), restored_it=it,
                   leaf=float(next(iter(tr.rt.gen.parameters())).view(-1)[0]))

        mean = pmesh.all_reduce_mean
        pmesh.all_reduce_mean = lambda ts, share=None: mean(ts, 1.0)
        tc = TileCreator(ds, cfg.data.tile_size_low, 0.0, device="cpu")
        tr = loop.Trainer(cfg, tc, device="cpu", shard_data=False)
        tr.fit(2)
        pmesh.all_reduce_mean = mean
        torch.save(state_of(tr), os.path.join(out_dir,
                                                f"rank{rank}_summed.pt"))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        pmesh.shutdown()


if __name__ == "__main__":
    main()
