"""Typed configuration + reference-compatible CLI mapping.

A copy of the dataclasses and flags of ``mpgan_tpu/config.py`` that the
port reads — data, model, losses and training — with the same flag names
and defaults. The port imports nothing of the JAX package, so it keeps its
own copy. An unknown flag aborts.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from mpgan_torch.utils import params as ph


@dataclass
class DataConfig:
    base_path: str = "data/"
    from_sim: int = 1000
    to_sim: int = 1000              # inclusive, like the reference
    frame_min: int = 0
    frame_max: int = 120            # exclusive
    data_dim: int = 3               # 2 or 3
    up_res: int = 4                 # total SR factor (2/4/8)
    tile_size_low: int = 16         # LR patch edge
    use_velocities: bool = True
    use_vorticities: bool = False
    data_fraction: float = 1.0      # fraction of frames loaded to host RAM
    mac_recenter: bool = False      # average staggered MAC velocity faces to
    # cell centers on load (io.uni.recenter_mac)
    density_threshold: float = 0.002  # near-empty tile rejection
    augment: bool = True
    rot_mode: int = 2               # 0 none, 1 90°-only, 2 continuous
    scale_min: float = 0.85
    scale_max: float = 1.15


@dataclass
class ModelConfig:
    n_base_filters: int = 32        # stem width of G
    n_res_blocks: int = 2           # residual blocks per growth stage
    disc_base_filters: int = 32
    gen_out_channels: int = 1       # density
    stages: int = 2                 # log2(up_res): 1→2x, 2→4x, 3→8x
    use_second_pass: bool = True
    dtype: str = "bfloat16"         # compute dtype (params stay float32)
    param_dtype: str = "float32"
    remat: bool = False             # torch.utils.checkpoint on G res-blocks


@dataclass
class LossConfig:
    # tempoGAN-style lambdas; names mirror the reference k-flags
    lambda_l1: float = 5.0          # k / kL1  — L1 content loss
    lambda_adv: float = 1.0         # kAdv — adversarial (spatial)
    lambda_t: float = 1.0           # kt — temporal adversarial
    lambda_f: float = 1e-5          # kf — Ds feature-space loss
    gan_loss: str = "sce"           # sce | lsgan | hinge | wgan
    label_smooth: float = 0.0       # one-sided D label smoothing (real→1−ε)
    r1_gamma: float = 0.0           # R1 penalty γ on D real-input grads (0=off)
    r1_interval: int = 1            # lazy R1: apply every k-th step, γ ×k
    gp_weight: float = 0.0          # WGAN-GP weight (0=off; pair with wgan)
    # temporal-warp backend: "auto" = the CUDA kernel for CUDA tensors and
    # the plain version for CPU tensors; "pallas" (the JAX package's name,
    # accepted as is) = the clamped fast warp; "xla" = the plain version
    warp_backend: str = "auto"      # auto | pallas | xla
    warp_max_disp: int = 8          # warp displacement clamp (HR px)


@dataclass
class TrainConfig:
    training_iters: int = 10000
    batch_size: int = 16
    learning_rate: float = 2e-4     # lrgan
    lr_disc: float = -1.0           # lrdisc — D learning rate (TTUR); -1 = lrgan
    beta1: float = 0.5
    adam_eps: float = 1e-8
    disc_runs: int = 1
    gen_runs: int = 1
    first_gen_run: bool = True      # train pass-1 (else pass-2)
    use_temporal_disc: bool = True
    save_interval: int = 1000
    output_interval: int = 100
    rand_seed: int = 42
    test_path: str = "test_out/"
    load_model_test: int = -1
    load_model_no: int = -1
    # progressive growing
    use_growing: bool = False
    alpha_iters: int = 2000         # fade-in iterations per new stage
    stable_iters: int = 2000        # post-fade iterations per stage
    # generator weight EMA (0 = off, typical 0.999)
    ema_decay: float = 0.0
    data_axis: str = "data"
    # steps per device dispatch in the JAX package; the port dispatches
    # one step at a time whatever the value (a CUDA graph replay on a card,
    # which waits on nothing on the host, so there is nothing to amortise)
    steps_per_dispatch: int = 0
    profile_dir: str = ""           # torch.profiler trace of fit, "" = off
    debug_nans: bool = False        # raise at the first non-finite update


@dataclass
class InferConfig:
    output_only: bool = False       # 'out 1' in the reference CLI
    frame_min: int = 0
    frame_max: int = 120
    slice_chunk: int = 0            # slices per generator call; 0 = one batch
    write_uni: bool = True
    write_png: bool = False
    use_ema: bool = False           # load gen_ema_%04d instead of gen_%04d
    # the JAX package's pipeline-parallel split; one device here, so it is
    # parsed and changes nothing
    pipeline_split: str = ""
    # idempotent sweeps: write into an existing test_%04d run dir, skipping
    # frames whose output exists (-1 = allocate a fresh dir)
    write_test: int = -1


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
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

    Flag names are the JAX package's (``basePath``, ``fromSim``, ``upRes``,
    ``tileSizeLow``, ``genFilters``, ``discFilters``, ``k``, ``kAdv``,
    ``kt``, ``kf``, ``ganLoss``, ``r1Gamma``, ``lrgan``, ``lrdisc``,
    ``batchSize``, ``useTempoD``, ``emaDecay``, ``sliceChunk``, …); an
    unknown flag aborts.
    """
    if argv is not None:
        ph.setParams(argv)

    g = ph.get_typed
    data = DataConfig(
        base_path=g("basePath", DataConfig.base_path),
        from_sim=g("fromSim", DataConfig.from_sim),
        to_sim=g("toSim", DataConfig.to_sim),
        frame_min=g("frameMin", DataConfig.frame_min),
        frame_max=g("frameMax", DataConfig.frame_max),
        data_dim=g("dataDim", DataConfig.data_dim),
        up_res=g("upRes", DataConfig.up_res),
        tile_size_low=g("tileSizeLow", DataConfig.tile_size_low),
        use_velocities=bool(g("useVelocities", 1)),
        use_vorticities=bool(g("useVorticities", 0)),
        data_fraction=g("dataFraction", DataConfig.data_fraction),
        mac_recenter=bool(g("macRecenter", 0)),
        density_threshold=g("densityThreshold", DataConfig.density_threshold),
        augment=bool(g("augment", 1)),
        rot_mode=g("rot", DataConfig.rot_mode),
        scale_min=g("minScale", DataConfig.scale_min),
        scale_max=g("maxScale", DataConfig.scale_max),
    )
    model = ModelConfig(
        n_base_filters=g("genFilters", ModelConfig.n_base_filters),
        n_res_blocks=g("genBlocks", ModelConfig.n_res_blocks),
        disc_base_filters=g("discFilters", ModelConfig.disc_base_filters),
        stages=_log2i(data.up_res),
        use_second_pass=bool(g("secondPass", 1)),
        dtype=g("dtype", ModelConfig.dtype),
        remat=bool(g("remat", 0)),
    )
    loss = LossConfig(
        lambda_l1=g("k", LossConfig.lambda_l1),
        lambda_adv=g("kAdv", LossConfig.lambda_adv),
        lambda_t=g("kt", LossConfig.lambda_t),
        lambda_f=g("kf", LossConfig.lambda_f),
        gan_loss=g("ganLoss", LossConfig.gan_loss),
        label_smooth=g("labelSmooth", LossConfig.label_smooth),
        r1_gamma=g("r1Gamma", LossConfig.r1_gamma),
        r1_interval=g("r1Interval", LossConfig.r1_interval),
        gp_weight=g("gpWeight", LossConfig.gp_weight),
    )
    train = TrainConfig(
        # trainingEpochs / learningRate are the upstream-tempoGAN spellings
        training_iters=g("trainingIters",
                         g("trainingEpochs", TrainConfig.training_iters)),
        batch_size=g("batchSize", TrainConfig.batch_size),
        learning_rate=g("lrgan", g("learningRate",
                                   TrainConfig.learning_rate)),
        lr_disc=g("lrdisc", TrainConfig.lr_disc),
        beta1=g("beta1", TrainConfig.beta1),
        adam_eps=g("adamEps", TrainConfig.adam_eps),
        disc_runs=g("discRuns", TrainConfig.disc_runs),
        gen_runs=g("genRuns", TrainConfig.gen_runs),
        first_gen_run=bool(g("firstNN", 1)),
        use_temporal_disc=bool(g("useTempoD", 1)),
        save_interval=g("saveInterval", TrainConfig.save_interval),
        output_interval=g("outputInterval", TrainConfig.output_interval),
        rand_seed=g("randSeed", TrainConfig.rand_seed),
        test_path=g("testPath", TrainConfig.test_path),
        load_model_test=g("load_model_test", TrainConfig.load_model_test),
        load_model_no=g("load_model_no", TrainConfig.load_model_no),
        use_growing=bool(g("useGrowing", 0)),
        alpha_iters=g("alphaIters", TrainConfig.alpha_iters),
        stable_iters=g("stableIters", TrainConfig.stable_iters),
        ema_decay=g("emaDecay", TrainConfig.ema_decay),
        steps_per_dispatch=g("stepsPerDispatch",
                             TrainConfig.steps_per_dispatch),
        profile_dir=g("profileDir", TrainConfig.profile_dir),
        debug_nans=bool(g("debugNans", 0)),
    )
    infer = InferConfig(
        # outputOnly is the upstream-tempoGAN spelling of `out`
        output_only=bool(g("out", g("outputOnly", 0))),
        frame_min=g("outFrameMin", data.frame_min),
        frame_max=g("outFrameMax", data.frame_max),
        slice_chunk=g("sliceChunk", InferConfig.slice_chunk),
        write_uni=bool(g("writeUni", 1)),
        write_png=bool(g("writePng", 0)),
        use_ema=bool(g("useEma", 0)),
        pipeline_split=str(g("pipelineSplit", "")),
        write_test=g("writeTest", InferConfig.write_test),
    )
    ph.checkUnusedParams()
    return Config(data=data, model=model, loss=loss, train=train, infer=infer)
