"""The flagship training recipe and its synthetic dataset.

The configuration the JAX package's training benchmark measures
(``bench.py`` ``train_point``, the documented flagship recipe): pass 1, 4×
(2 stages), generator base 32 with 2 res blocks, discriminator base 32,
bf16 models, batch 16, LR tile 16, temporal discriminator on, hinge loss,
lazy R1 (γ = 10 every 16 steps), TTUR (``lrdisc`` 4e-4 against ``lrgan``
2e-4), generator EMA 0.999; data: 2 sims × 4 frames of uniform random
values at 32³ LR (density + velocity) and 128³ HR, density threshold 0
(throughput does not depend on the values).
"""

from __future__ import annotations

import numpy as np

from mpgan_torch.config import (Config, DataConfig, LossConfig, ModelConfig,
                                TrainConfig)
from mpgan_torch.data.loader import FluidDataset


def flagship_config(dtype: str = "bfloat16", batch: int = 16,
                    tile: int = 16) -> Config:
    """The flagship recipe's configuration (``bench.py`` ``train_point``)."""
    return Config(
        data=DataConfig(tile_size_low=tile, up_res=4, density_threshold=0.0),
        model=ModelConfig(stages=2, dtype=dtype),
        loss=LossConfig(gan_loss="hinge", r1_gamma=10.0, r1_interval=16),
        train=TrainConfig(batch_size=batch, use_temporal_disc=True,
                          lr_disc=4e-4, ema_decay=0.999, save_interval=0,
                          rand_seed=0),
    )


def synthetic_dataset(n_sims: int = 2, n_frames: int = 4, size: int = 32,
                      up: int = 4, channels: int = 4,
                      seed: int = 0) -> FluidDataset:
    """Uniform random LR (N, size³, channels) and HR (N, (size·up)³, 1)
    stacks, N = n_sims·n_frames, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    n = n_sims * n_frames
    lr = rng.random((n, size, size, size, channels), dtype=np.float32)
    hr = rng.random((n, size * up, size * up, size * up, 1),
                    dtype=np.float32)
    return FluidDataset(lr=lr, hr=hr, n_sims=n_sims, n_frames=n_frames,
                        up_res=up)
