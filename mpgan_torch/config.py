"""Typed configuration + reference-compatible CLI mapping (the port's part).

A copy of the dataclass fields and flags of ``mpgan_tpu/config.py`` that the
port reads so far — inference widths, input channels, the model dtype, the
slice chunk and the temporal-warp settings — with the same flag names and
defaults. The port imports nothing of the JAX package, so it keeps its own
copy; fields of the trainer join as the trainer is ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from mpgan_torch.utils import params as ph


@dataclass
class DataConfig:
    up_res: int = 4                 # total SR factor (2/4/8)
    tile_size_low: int = 16         # LR patch edge
    use_velocities: bool = True
    use_vorticities: bool = False
    mac_recenter: bool = False      # average staggered MAC velocity faces to
    # cell centers on load (io.uni.recenter_mac)


@dataclass
class ModelConfig:
    n_base_filters: int = 32        # stem width of G
    n_res_blocks: int = 2           # residual blocks per growth stage
    stages: int = 2                 # log2(up_res): 1→2x, 2→4x, 3→8x
    dtype: str = "bfloat16"         # compute dtype (params stay float32)


@dataclass
class LossConfig:
    # temporal-warp backend: "auto" = the CUDA kernel for CUDA tensors and
    # the plain version for CPU tensors; "pallas" (the JAX package's name,
    # accepted as is) = the kernel; "xla" = the plain version
    warp_backend: str = "auto"      # auto | pallas | xla
    warp_max_disp: int = 8          # warp displacement clamp (HR px)


@dataclass
class InferConfig:
    slice_chunk: int = 0            # slices per generator call; 0 = one batch


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    infer: InferConfig = field(default_factory=InferConfig)


def _log2i(x: int) -> int:
    n = 0
    while (1 << n) < x:
        n += 1
    if (1 << n) != x:
        raise ValueError(f"upRes must be a power of two, got {x}")
    return n


def from_cli(argv: list[str] | None = None) -> Config:
    """Parse a reference-style ``name value`` command line into a Config.

    Flag names are the JAX package's (``upRes``, ``tileSizeLow``,
    ``useVelocities``, ``useVorticities``, ``macRecenter``, ``genFilters``,
    ``genBlocks``, ``dtype``, ``sliceChunk``); an unknown flag aborts.
    """
    if argv is not None:
        ph.setParams(argv)

    g = ph.get_typed
    data = DataConfig(
        up_res=g("upRes", DataConfig.up_res),
        tile_size_low=g("tileSizeLow", DataConfig.tile_size_low),
        use_velocities=bool(g("useVelocities", 1)),
        use_vorticities=bool(g("useVorticities", 0)),
        mac_recenter=bool(g("macRecenter", 0)),
    )
    model = ModelConfig(
        n_base_filters=g("genFilters", ModelConfig.n_base_filters),
        n_res_blocks=g("genBlocks", ModelConfig.n_res_blocks),
        stages=_log2i(data.up_res),
        dtype=g("dtype", ModelConfig.dtype),
    )
    infer = InferConfig(slice_chunk=g("sliceChunk", InferConfig.slice_chunk))
    ph.checkUnusedParams()
    return Config(data=data, model=model, infer=infer)
