"""Pass-2 train traffic (kind ``train2``): the flagship recipe's second
pass through the program's ``Trainer(..., pass_no=2).fit`` (graphed on a
card), as a user's ``out 0 ... firstNN 0 pass2Source g1`` runs it: G2
trains over xz slices of the frozen G1's outputs, the training set
resident on the card.

Traffic keys: those of :mod:`train` (``n_sims``, ``n_frames``,
``lr_size``, ``velocity``, ``check_steps``, ``replay_step``,
``trace_seconds``, ``devices``) and ``pass2_source`` (``"g1"``: G2's
input is the frozen G1's sweep over the set, the only source this traffic
runs).

Set-up draws the three trained nets (G2, Ds, Dt) and the training set from
the seed as :mod:`train` does, and the frozen G1 from a stream of the seed
of its own; sweeps G1 over every LR volume with the program's
``precompute_intermediates`` (its graphed inference path); builds the
tile creator over the LR, HR and intermediate volumes and the pass-2
trainer; then drives the trainer through its first steps and the replayed
R1 step, and measures the window, as :mod:`train` does. After the window
the plain pass-2 reference (:mod:`port_bench.reference.train2`) follows
the same steps from the same weights and data, the intermediate volumes
the program trained on included, and the numbers are compared as in
:mod:`train`.
"""

from __future__ import annotations

import math
import time

import torch

from port_bench import counts
from port_bench.drivers import common
from port_bench.drivers import train as train1
from port_bench.reference import nets
from port_bench.reference import train2 as ref_train2

# the frozen G1's weights: a stream of the seed of its own, apart from the
# trained nets' and the data's
PASS1_STREAM = 0x61A5
# a hinge margin the bf16 program may put on either side of 0: twice the
# largest gap of the program's margins from the float32 reference's read
# on an H100 (0.1256, Dt at step 32 over ten seeds)
KINK_DELTA = 0.25


def descriptions(cfg: dict) -> dict:
    """The reference's view of the configuration's training networks: G2
    is the trained generator."""
    return {**train1.descriptions(cfg),
            "generator": common.generator_desc(cfg["generator_pass2"])}


def program_config(cfg: dict, seed: int):
    """The program's flagship configuration at the recipe's batch, tile and
    ``up_res`` (log2 of it growth stages), G2's widths, sampling from
    ``seed``; refused unless every number of the recipe, G2's stages and
    the discriminators' input size are what the program will run."""
    from mpgan_torch.train import recipe
    rec, g = cfg["recipe"], cfg["generator_pass2"]
    pcfg = recipe.flagship_config(cfg["dtype"], batch=rec["batch"],
                                  tile=rec["tile_lr"])
    pcfg.train.rand_seed = seed
    pcfg.train.first_gen_run = False
    pcfg.data.up_res = rec["up_res"]
    pcfg.model.stages = len(g["factors"])
    pcfg.model.n_base_filters = g["base_filters"]
    pcfg.model.n_res_blocks = g["n_res_blocks"]
    pcfg.model.disc_base_filters = cfg["spatial_disc"]["base_filters"]
    for key, (sec, attr) in train1.PROGRAM_KEYS.items():
        got = getattr(getattr(pcfg, sec), attr)
        if got != rec[key]:
            raise ValueError(f"the program's recipe has {sec}.{attr} = "
                             f"{got!r}, the configuration {key} = "
                             f"{rec[key]!r}")
    stages = len(g["factors"])
    hw = [rec["tile_lr"] * 2 ** stages, rec["tile_lr"] * rec["up_res"]]
    if (any(tuple(f) != (2, 1) for f in g["factors"])
            or 2 ** stages != rec["up_res"]
            or any(cfg[d]["in_hw"] != hw or any(
                tuple(f) != (2, 1) for f in cfg[d]["factors"])
                for d in ("spatial_disc", "temporal_disc"))
            or not pcfg.train.use_temporal_disc or pcfg.train.use_growing):
        raise ValueError("the program's pass-2 recipe is not the "
                         "configuration's")
    return pcfg


def inputs(ctx: dict) -> dict:
    """The trained nets' parameters and the training set, made on the card
    from the seed as :func:`train.inputs` makes them, and the frozen G1's
    parameters from a stream of their own."""
    dev = ctx["devices"][0]
    cfg, desc = ctx["config"], descriptions(ctx["config"])
    if ctx["traffic"].get("pass2_source", "g1") != "g1":
        raise ValueError("the train2 traffic trains G2 on frozen-G1 "
                         "outputs alone (pass2_source g1)")
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"])
    params = {
        "gen": nets.make_weights(nets.generator_layout(desc["generator"]),
                                 gen, dev),
        "ds": nets.make_weights(
            nets.discriminator_layout(desc["spatial_disc"]), gen, dev),
        "dt": nets.make_weights(
            nets.discriminator_layout(desc["temporal_disc"]), gen, dev)}
    lr, hr = train1.make_data(ctx, gen)
    d1 = common.generator_desc(cfg["generator_pass1"])
    g1 = torch.Generator(device=dev).manual_seed(ctx["seed"] ^ PASS1_STREAM)
    p1 = nets.make_weights(nets.generator_layout(d1), g1, dev)
    return {"params": params, "desc": desc, "lr": lr, "hr": hr,
            "pass1": (p1, d1)}


def intermediates(ctx: dict, state: dict) -> torch.Tensor:
    """The frozen G1 over every LR volume, through the program's
    ``precompute_intermediates``: (N, Z, Y·s, X·s, 1) float32."""
    from mpgan_torch.infer import assemble
    p1, d1 = state["pass1"]
    dt = common.torch_dtype(ctx["config"]["dtype"])
    g1 = common.port_generator(d1, 1, p1, dt, dt, ctx["devices"][0])
    g1.eval().requires_grad_(False)
    return assemble.precompute_intermediates(g1, state["lr"])


def setup(ctx: dict) -> dict:
    """The inputs, the intermediate volumes, and the pass-2 trainer driven
    through its first steps and the replayed R1 step (as
    :func:`train.setup` drives the pass-1 trainer)."""
    from mpgan_torch.data.loader import FluidDataset
    from mpgan_torch.data.pipeline import TileCreator
    from mpgan_torch.train import loop
    cfg, tr, seed = ctx["config"], ctx["traffic"], ctx["seed"]
    rec = cfg["recipe"]
    at, k = tr["replay_step"], max(rec["r1_interval"], 1)
    if at % k or at < 2 * k:
        raise ValueError(f"replay_step {at} is not a replay of the lazy-R1 "
                         f"program (every {k} steps, captured at {k})")
    pcfg = program_config(cfg, seed)
    state = inputs(ctx)
    common.mark(ctx, "inputs")
    state["interm"] = intermediates(ctx, state)
    common.mark(ctx, "intermediates")
    ds = FluidDataset(lr=state["lr"].cpu().numpy(), hr=state["hr"],
                      n_sims=tr["n_sims"], n_frames=tr["n_frames"],
                      up_res=rec["up_res"])
    tc = TileCreator(ds, rec["tile_lr"],
                     density_threshold=rec["density_threshold"],
                     augment=True, rot_mode=rec["rot_mode"],
                     scale_min=rec["scale_min"], scale_max=rec["scale_max"],
                     device=ctx["devices"][0], interm=state["interm"])
    common.mark(ctx, "dataset")
    trainer = loop.Trainer(pcfg, tc, device=ctx["devices"][0], pass_no=2)
    rt = trainer.runtime()
    params = state["params"]
    with torch.no_grad():
        for net, name in ((rt.gen, "gen"), (rt.ds, "ds"), (rt.dt, "dt")):
            net.load_state_dict(params[name], strict=True)
        for key, v in rt.ema.items():
            v.copy_(params["gen"][key])
    common.mark(ctx, "trainer")
    state.update(drive(ctx, trainer, params))
    common.mark(ctx, "steps")
    state["tc"] = tc
    return state


def drive(ctx: dict, trainer, params: dict) -> dict:
    """Fit the trainer through its first ``check_steps`` steps and on to
    the replayed R1 step, keeping what the reference follows (the state
    before and after each stretch, the losses of each step and the first
    gradients), as :func:`train.setup` keeps them."""
    rec, tr = ctx["config"]["recipe"], ctx["traffic"]
    rt = trainer.runtime()
    at = tr["replay_step"]

    def logger(into):
        return lambda _, m: into.append(
            {key: m[key] for key in ("d_loss", "dt_loss", "g_loss")})
    b1 = rec["beta1"]
    nets_ = {"gen": (rt.gen, rt.opt_g), "ds": (rt.ds, rt.opt_ds),
             "dt": (rt.dt, rt.opt_dt)}
    first = {"it": 0, "losses": [],
             "before": {**params, "ema": params["gen"]},
             "triplet": program_triplet(trainer)}
    trainer.fit(1, log_every=1, on_log=logger(first["losses"]))
    # Adam's first moment after one step is (1 − β1)·g
    first["grads"] = {name: {key: m / (1 - b1) for key, m in st["m"].items()}
                      for name, st in train1._moments(nets_).items()}
    steps = tr["check_steps"]
    trainer.fit(steps, start_it=1, log_every=1,
                on_log=logger(first["losses"]))
    first["after"] = train1._params(nets_, rt)
    trainer.fit(at, start_it=steps, log_every=at)
    replay = {"it": at, "losses": [], "before": train1._params(nets_, rt),
              "opt": train1._moments(nets_)}
    trainer.fit(at + 1, start_it=at, log_every=1,
                on_log=logger(replay["losses"]))
    replay["after"] = train1._params(nets_, rt)
    # m_after = β1·m_before + (1 − β1)·g
    replay["grads"] = {
        name: {key: (m - b1 * replay["opt"][name]["m"][key]) / (1 - b1)
               for key, m in st["m"].items()}
        for name, st in train1._moments(nets_).items()}
    return {"trainer": trainer, "stretches": [first, replay],
            "next_it": at + 1}


def program_triplet(trainer) -> torch.Tensor:
    """The program's aligned real triplet of step 0's D-run batch, run
    eagerly: the trainer's sampler drawn with step 0's seed, then the
    velocity in the trainer's units and its warp
    (``loop.aligned_reals``)."""
    from mpgan_torch.train import losses, loop
    cfg, dev = trainer.cfg, trainer.device
    sample = loop.make_sampler(trainer.tc, 2, cfg.train.batch_size, True)
    rng = torch.Generator(device=dev).manual_seed(
        loop._step_seed(cfg.train.rand_seed, 0))
    return loop.aligned_reals(
        sample(rng), 2, trainer.n_stages, trainer.tc.up_res,
        losses.use_warp_kernel(cfg.loss.warp_backend, dev),
        cfg.loss.warp_max_disp)


def reference(ctx: dict, state: dict, quant=None, fault=None,
              kink_delta=None) -> list:
    """The pass-2 reference over each stretch the program kept, as
    :func:`train.reference` follows the pass-1 ones (``kink_delta``:
    :func:`ref_train2.run`'s)."""
    rec = {**ctx["config"]["recipe"], "n_frames": ctx["traffic"]["n_frames"]}
    desc = {**state["desc"], "recipe": rec}
    out = []
    with common.strict_float32():
        data = ref_train2.pass2_data(state["lr"], state["interm"],
                                     state["hr"], rec)
        for s in state["stretches"]:
            before = s["before"]
            start = {"it": s["it"], "opt": s.get("opt", {}),
                     "ema": before["ema"]}
            out.append(ref_train2.run(
                desc, {k: before[k] for k in ("gen", "ds", "dt")}, data,
                ctx["seed"], len(s["losses"]), quant, fault, start,
                kink_delta))
    return out


def widened(unit: dict, ref: dict, moves: list) -> dict:
    """``unit``'s gradient moved from ``ref``'s, leaf by leaf along their
    difference, by the sum of the norms of that leaf in ``moves`` (each a
    gradient by leaf)."""
    out = {}
    for k, u in unit.items():
        d = u - ref[k]
        n = float(d.double().norm())
        w = sum(float(mv[k].double().norm()) for mv in moves)
        out[k] = ref[k] + d * (1.0 + w / n) if n > 0 else u
    return out


def references(ctx: dict, state: dict) -> tuple[list, list]:
    """The float32 reference, and the same rounded to bf16 with its own
    hinge terms (the unit of ``train_grad_err_ratio``), whose first
    gradients are widened (:func:`widened`) by what the float32
    reference's hinge terms within ``KINK_DELTA`` of their kink at the
    first step move, each counted the other way: the discriminator's
    gradient by the term's, G's by the discriminator's other update. A
    program in bf16 may count such a term either way. Neither looks at
    the program."""
    ref = reference(ctx, state, kink_delta=KINK_DELTA)
    unit = reference(ctx, state, quant=nets.bf16_round)
    for r, u in zip(ref, unit, strict=True):
        moves = dict(r["kinks"], gen=r["kinks_gen"])
        for name, mv in moves.items():
            if name != "gen":
                mv = [t for _, _, t in mv]
            u["grads0"][name] = widened(u["grads0"][name],
                                        r["grads0"][name], mv)
    return ref, unit


def net_ratios(prog: dict, ref: dict, unit: dict) -> dict:
    """Per net the norm over its leaves of the first gradient's gap from
    the reference's over the same of the unit's, the leaves those
    :func:`train.compare_stretch` keeps."""
    out = {}
    for name in ("gen", "ds", "dt"):
        rg = ref["grads0"][name]
        gn = {k: float(v.double().norm()) for k, v in rg.items()}
        med = sorted(gn.values())[len(gn) // 2]
        keys = [k for k, v in gn.items() if v >= 1e-3 * med]

        def gap(g):
            return math.sqrt(sum(float((g[k].double() - rg[k].double())
                                       .norm()) ** 2 for k in keys))
        out[name] = gap(prog["grads"][name]) / max(
            gap(unit["grads0"][name]), 1e-30)
    return out


def compare(stretches: list, ref: list, unit: list,
            where: dict | None = None) -> dict:
    """:func:`train.compare`'s numbers, and of the first stretch (the
    steps from the benchmark's weights, no margin near a kink):
    ``train_net_err_ratio_first``, :func:`net_ratios`' most over the
    nets, and ``train_warp_gap``, ‖t − t_ref‖ / ‖t_ref‖ of the aligned
    real triplets: the sample, the velocity's units and the warp, which
    no rounding of the networks moves."""
    where = {} if where is None else where
    out = train1.compare(stretches, ref, unit, where)
    first = stretches[0]
    r = net_ratios(first, ref[0], unit[0])
    net = max(r, key=r.get)
    out["train_net_err_ratio_first"] = r[net]
    where["train_net_err_ratio_first"] = f"step {first['it']}: {net}"
    t, tr = first["triplet"].double(), ref[0]["triplet"].double()
    out["train_warp_gap"] = float((t.to(tr.device) - tr).norm() / tr.norm())
    return out


def step_flops(cfg: dict) -> dict:
    """Convolution operations of one pass-2 temporal GAN step, by part
    (``d_run``, ``g_run``, ``r1``) and in all (``step``): the terms of
    :func:`counts.train_step_flops` with G2's slices, t × t·s input
    pixels each (t the LR tile, s ``up_res``), in place of pass 1's t × t.
    ``cfg`` as :func:`descriptions` gives it."""
    rec = cfg["recipe"]
    b, t = rec["batch"], rec["tile_lr"]
    gf = counts.generator_flops(cfg["generator"], t, t * rec["up_res"])
    dsf = counts.discriminator_flops(cfg["spatial_disc"])
    dtf = counts.discriminator_flops(cfg["temporal_disc"])
    parts = {"d_run": 3 * b * gf + 3 * (2 * b) * dsf + 3 * (2 * b) * dtf,
             "g_run": 3 * (3 * b) * gf + 3 * b * dsf + b * dsf + 3 * b * dtf,
             "r1": 9 * b * (dsf + dtf) / max(rec["r1_interval"], 1)}
    return {**parts, "step": sum(parts.values())}


def run(ctx: dict) -> dict:
    cfg, tr, devs = ctx["config"], ctx["traffic"], ctx["devices"]
    state = setup(ctx)
    if devs[0].type == "cuda":
        torch.cuda.synchronize(devs[0])
    setup_s = time.perf_counter() - ctx["t0"]
    seconds = (min(ctx["seconds"], tr["trace_seconds"]) if ctx["trace"]
               else ctx["seconds"])
    steps, w = train1.window(ctx, state, seconds)
    peak = common.memory_peak(devs)
    state["trainer"] = state["tc"] = None
    if devs[0].type == "cuda":
        torch.cuda.empty_cache()
    ref, unit = references(ctx, state)
    where: dict = {}
    numbers = compare(state["stretches"], ref, unit, where)
    rates = state["chunk_rates"]
    common.note(ctx, f"window: {len(rates)} fit calls, steps/s per call "
                + " ".join(f"{r:.1f}" for r in rates))
    desc = descriptions(cfg)
    return {
        "setup_s": setup_s,
        "e2e": {"train_samples_per_s":
                cfg["recipe"]["batch"] * steps / w.wall_s},
        "attempted": steps, "failed": 0, "numbers": numbers, "where": where,
        "checked": sum(len(s["losses"]) for s in state["stretches"]),
        "memory_peak_bytes": peak,
        "record": {"units": steps, "window_s": w.wall_s,
                   "summary": w.summary,
                   "flops_per_unit": step_flops(desc)["step"],
                   "warp_bytes_per_unit": counts.train_warp_bytes(desc),
                   "n_devices": len(devs)}}
