"""Train traffic: the flagship pass-1 recipe through the program's
``Trainer.fit`` (graphed on a card), the training set resident on the card.

Traffic keys: ``n_sims``, ``n_frames``, ``lr_size`` (LR edge; HR is
``lr_size·up_res``), ``velocity`` (velocity range, LR cells per frame),
``check_steps`` (the first steps the reference follows), ``replay_step``
(a lazy-R1 step after that program's capture, which the reference follows
from the program's own state; the window starts after it),
``trace_seconds``. The window calls ``fit`` from one multiple of the
recipe's ``output_interval`` to the next, so that it reads the step's
metrics where a user's ``fit`` logs them.

Set-up builds one trainer from the seed and drives it through its first
``check_steps`` steps with ``fit``, keeping the losses of each step, the
optimizers' first moments after the first step (the first gradients) and
the parameters and EMA after the last; then on to ``replay_step``, whose
state before and after (parameters, EMA, Adam's moments) it keeps too;
then the same trainer is measured. After the window the reference follows
the first steps from the same weights and data, and the replayed step from
the program's state before it.
"""

from __future__ import annotations

import time

import torch

from port_bench import counts, trace
from port_bench.drivers import common
from port_bench.reference import nets
from port_bench.reference import train as ref_train

# recipe key → (section of the program's configuration, attribute)
PROGRAM_KEYS = {
    "batch": ("train", "batch_size"), "lr_gen": ("train", "learning_rate"),
    "lr_disc": ("train", "lr_disc"), "beta1": ("train", "beta1"),
    "adam_eps": ("train", "adam_eps"), "ema_decay": ("train", "ema_decay"),
    "tile_lr": ("data", "tile_size_low"), "up_res": ("data", "up_res"),
    "density_threshold": ("data", "density_threshold"),
    "rot_mode": ("data", "rot_mode"), "scale_min": ("data", "scale_min"),
    "scale_max": ("data", "scale_max"), "r1_gamma": ("loss", "r1_gamma"),
    "r1_interval": ("loss", "r1_interval"),
    "lambda_adv": ("loss", "lambda_adv"), "lambda_l1": ("loss", "lambda_l1"),
    "lambda_f": ("loss", "lambda_f"), "lambda_t": ("loss", "lambda_t"),
    "warp_max_disp": ("loss", "warp_max_disp"),
    "gan_loss": ("loss", "gan_loss"),
    "output_interval": ("train", "output_interval"),
}


def descriptions(cfg: dict) -> dict:
    """The reference's view of the configuration's training networks."""
    return {"generator": common.generator_desc(cfg["generator_pass1"]),
            "spatial_disc": {**cfg["spatial_disc"], "factors": [
                tuple(f) for f in cfg["spatial_disc"]["factors"]]},
            "temporal_disc": {**cfg["temporal_disc"], "factors": [
                tuple(f) for f in cfg["temporal_disc"]["factors"]]},
            "recipe": cfg["recipe"]}


def program_config(cfg: dict, seed: int):
    """The program's flagship configuration at the recipe's batch and tile,
    sampling from ``seed``; refused unless every number of the recipe is
    what the program will run."""
    from mpgan_torch.train import recipe
    rec = cfg["recipe"]
    pcfg = recipe.flagship_config(cfg["dtype"], batch=rec["batch"],
                                  tile=rec["tile_lr"])
    pcfg.train.rand_seed = seed
    g = cfg["generator_pass1"]
    pcfg.model.n_base_filters = g["base_filters"]
    pcfg.model.n_res_blocks = g["n_res_blocks"]
    pcfg.model.disc_base_filters = cfg["spatial_disc"]["base_filters"]
    for key, (sec, attr) in PROGRAM_KEYS.items():
        got = getattr(getattr(pcfg, sec), attr)
        if got != rec[key]:
            raise ValueError(f"the program's recipe has {sec}.{attr} = "
                             f"{got!r}, the configuration {key} = "
                             f"{rec[key]!r}")
    if (pcfg.model.stages != len(cfg["generator_pass1"]["factors"])
            or not pcfg.train.use_temporal_disc or pcfg.train.use_growing):
        raise ValueError("the program's recipe is not the configuration's")
    return pcfg


def make_data(ctx: dict, gen: torch.Generator):
    tr, dev, up = ctx["traffic"], ctx["devices"][0], \
        ctx["config"]["recipe"]["up_res"]
    n, s = tr["n_sims"] * tr["n_frames"], tr["lr_size"]
    lr = common.lr_frames(n, s, tr["velocity"], gen, dev)
    hr = torch.rand((n, s * up, s * up, s * up, 1), generator=gen,
                    device=dev)
    return lr, hr


def inputs(ctx: dict) -> dict:
    """The three nets' parameters and the training set, made on the card
    from the seed."""
    dev = ctx["devices"][0]
    desc = descriptions(ctx["config"])
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"])
    params = {
        "gen": nets.make_weights(nets.generator_layout(desc["generator"]),
                                 gen, dev),
        "ds": nets.make_weights(
            nets.discriminator_layout(desc["spatial_disc"]), gen, dev),
        "dt": nets.make_weights(
            nets.discriminator_layout(desc["temporal_disc"]), gen, dev)}
    lr, hr = make_data(ctx, gen)
    return {"params": params, "desc": desc, "lr": lr, "hr": hr}


def _params(nets_: dict, rt) -> dict:
    out = {name: {k: p.detach().clone() for k, p in net.named_parameters()}
           for name, (net, _) in nets_.items()}
    out["ema"] = {k: v.detach().clone() for k, v in rt.ema.items()}
    return out


def _moments(nets_: dict) -> dict:
    """Adam's state per net as the reference holds it: ``m``, ``v`` and
    the step count ``t`` (zero where the optimizer holds none yet)."""
    out = {}
    for name, (net, opt) in nets_.items():
        m, v, t = {}, {}, 0
        for k, p in net.named_parameters():
            st = opt.state.get(p, {})
            m[k] = st["exp_avg"].detach().clone() if st else \
                torch.zeros_like(p)
            v[k] = st["exp_avg_sq"].detach().clone() if st else \
                torch.zeros_like(p)
            t = max(t, int(st["step"])) if st else t
        out[name] = {"m": m, "v": v, "t": t}
    return out


def setup(ctx: dict) -> dict:
    """The inputs, and the trainer driven through its first steps and the
    replayed R1 step."""
    from mpgan_torch.data.loader import FluidDataset
    from mpgan_torch.data.pipeline import TileCreator
    from mpgan_torch.train import loop
    cfg, tr, seed = ctx["config"], ctx["traffic"], ctx["seed"]
    dev = ctx["devices"][0]
    rec = cfg["recipe"]
    at, k = tr["replay_step"], max(rec["r1_interval"], 1)
    if at % k or at < 2 * k:
        raise ValueError(f"replay_step {at} is not a replay of the lazy-R1 "
                         f"program (every {k} steps, captured at {k})")
    state = inputs(ctx)
    common.mark(ctx, "inputs")
    params, lr, hr = state["params"], state["lr"], state["hr"]
    ds = FluidDataset(lr=lr.cpu().numpy(), hr=hr, n_sims=tr["n_sims"],
                      n_frames=tr["n_frames"], up_res=rec["up_res"])
    tc = TileCreator(ds, rec["tile_lr"],
                     density_threshold=rec["density_threshold"],
                     augment=True, rot_mode=rec["rot_mode"],
                     scale_min=rec["scale_min"], scale_max=rec["scale_max"],
                     device=dev)
    common.mark(ctx, "dataset")
    trainer = loop.Trainer(program_config(cfg, seed), tc, device=dev)
    rt = trainer.runtime()
    with torch.no_grad():
        for net, name in ((rt.gen, "gen"), (rt.ds, "ds"), (rt.dt, "dt")):
            net.load_state_dict(params[name], strict=True)
        for key, v in rt.ema.items():
            v.copy_(params["gen"][key])
    common.mark(ctx, "trainer")

    def logger(into):
        return lambda _, m: into.append(
            {key: m[key] for key in ("d_loss", "dt_loss", "g_loss")})
    b1 = rec["beta1"]
    nets_ = {"gen": (rt.gen, rt.opt_g), "ds": (rt.ds, rt.opt_ds),
             "dt": (rt.dt, rt.opt_dt)}
    first = {"it": 0, "losses": [],
             "before": {**params, "ema": params["gen"]}}
    trainer.fit(1, log_every=1, on_log=logger(first["losses"]))
    # Adam's first moment after one step is (1 − β1)·g; a parameter the
    # optimizer holds no state for has not moved
    first["grads"] = {name: {key: m / (1 - b1) for key, m in st["m"].items()}
                      for name, st in _moments(nets_).items()}
    steps = tr["check_steps"]
    trainer.fit(steps, start_it=1, log_every=1,
                on_log=logger(first["losses"]))
    first["after"] = _params(nets_, rt)
    trainer.fit(at, start_it=steps, log_every=at)
    replay = {"it": at, "losses": [], "before": _params(nets_, rt),
              "opt": _moments(nets_)}
    trainer.fit(at + 1, start_it=at, log_every=1,
                on_log=logger(replay["losses"]))
    replay["after"] = _params(nets_, rt)
    # m_after = β1·m_before + (1 − β1)·g
    replay["grads"] = {
        name: {key: (m - b1 * replay["opt"][name]["m"][key]) / (1 - b1)
               for key, m in st["m"].items()}
        for name, st in _moments(nets_).items()}
    common.mark(ctx, "steps")
    state.update(trainer=trainer, tc=tc, stretches=[first, replay],
                 next_it=at + 1)
    return state


def window(ctx: dict, state: dict, seconds: float):
    """``fit`` from one multiple of the recipe's output interval to the
    next until ``seconds`` have passed; the steps done and the window."""
    trainer, it = state["trainer"], state["next_it"]
    every = ctx["config"]["recipe"]["output_interval"]
    chunks = []
    with trace.Window(ctx["devices"], ctx["trace"]) as w:
        end = w.t0 + seconds
        last = w.t0
        while time.perf_counter() < end:
            stop = (it // every + 1) * every
            trainer.fit(stop, start_it=it, log_every=every)
            now = time.perf_counter()
            chunks.append((stop - it) / (now - last))
            it, last = stop, now
    state["chunk_rates"] = chunks
    return it - state["next_it"], w


def compare_stretch(prog: dict, ref: dict, unit: dict, where: dict) -> dict:
    """The numbers of one stretch of steps that the reference followed:
    the widest relative gap of a step's loss (of every step, and of the
    first step's alone); the gap of norms of the first gradient per leaf,
    the worst leaf's and the median leaf's, the median leaf's norm of the
    difference of the first gradients, and that over the same of the
    reference rounded to bf16 (``unit``); the gap of norms of the change
    over the stretch (of each net and of the EMA), the worst leaf's and
    the median leaf's. A median is taken per net and the largest of them
    is the number, so that a fault of one net shows. A leaf whose
    reference gradient is under a thousandth of its net's median leaf's
    (an input head that only a fade uses) is left out. ``where`` gets the
    worst step, leaf or net."""
    loss = {}
    for i, got in enumerate(prog["losses"]):
        for key in ("d_loss", "dt_loss", "g_loss"):
            r = float(ref[key][i])
            loss[f"{key}@{prog['it'] + i}"] = abs(got[key] - r) / max(
                abs(r), 1e-6)
    grads, diffs, units, changes = {}, {}, {}, {}
    for name in ("gen", "ds", "dt"):
        rg = ref["grads0"][name]
        gn = {k: float(v.double().norm()) for k, v in rg.items()}
        med = sorted(gn.values())[len(gn) // 2]
        moving = {k for k, v in gn.items() if v >= 1e-3 * med}
        pg = prog["grads"][name]
        grads[name] = common.leaf_gaps(pg, rg, moving)
        diffs[name] = common.leaf_diffs(pg, rg, moving)
        units[name] = common.leaf_diffs(unit["grads0"][name], rg, moving)
        for which in [name] + (["ema"] if name == "gen" else []):
            p0 = prog["before"][which]
            dp = {k: prog["after"][which][k] - p0[k] for k in moving}
            src = ref["params"][name] if which != "ema" else ref["ema"]
            dr = {k: src[k] - p0[k] for k in moving}
            changes[which] = common.leaf_gaps(dp, dr)

    def worst(by_net, key):
        flat = {f"{n}.{k}": v for n, d in by_net.items() for k, v in d.items()}
        leaf = max(flat, key=flat.get)
        where[key] = leaf
        return flat[leaf]

    def median(by_net, key):
        meds = {n: sorted(d.values())[len(d) // 2] for n, d in by_net.items()}
        net = max(meds, key=meds.get)
        where[key] = net
        return meds[net]

    def ratio(key):
        r = {n: sorted(diffs[n].values())[len(diffs[n]) // 2]
             / max(sorted(units[n].values())[len(units[n]) // 2], 1e-30)
             for n in diffs}
        net = max(r, key=r.get)
        where[key] = net
        return r[net]
    worst_loss = max(loss, key=loss.get)
    where["train_loss_gap"] = worst_loss
    return {"train_loss_gap": loss[worst_loss],
            "train_loss_gap_first": max(
                v for k, v in loss.items() if k.endswith(f"@{prog['it']}")),
            "train_grad_gap": worst(grads, "train_grad_gap"),
            "train_grad_gap_median": median(grads, "train_grad_gap_median"),
            "train_grad_diff_median": median(diffs,
                                             "train_grad_diff_median"),
            "train_grad_err_ratio": ratio("train_grad_err_ratio"),
            "train_change_gap": worst(changes, "train_change_gap"),
            "train_change_gap_median": median(changes,
                                              "train_change_gap_median")}


def compare(progs: list, refs: list, units: list,
            where: dict | None = None) -> dict:
    """Each number the most over the stretches (:func:`compare_stretch`);
    ``where`` names the stretch's first step and the worst in it."""
    where = {} if where is None else where
    out: dict = {}
    for prog, ref, unit in zip(progs, refs, units, strict=True):
        here: dict = {}
        for key, v in compare_stretch(prog, ref, unit, here).items():
            if key not in out or v > out[key]:
                out[key] = v
                where[key] = f"step {prog['it']}: {here.get(key, '')}"
    return out


def reference(ctx: dict, state: dict, quant=None, fault=None) -> list:
    """The reference over each stretch the program kept: the first steps
    from the benchmark's weights, the replayed step from the program's
    state before it (``state["stretches"]``; the reference's own runs
    stand in for it in :mod:`port_bench.control`)."""
    tr, rec = ctx["traffic"], ctx["config"]["recipe"]
    rec = {**rec, "n_frames": tr["n_frames"]}
    desc = {**state["desc"], "recipe": rec}
    stretches = state["stretches"]
    iters = [s["it"] + i for s in stretches
             for i in range(len(s["losses"]))]
    out = []
    with common.strict_float32():
        vols = ref_train.drawn_volumes(state["lr"], rec, ctx["seed"], iters)
        data = ref_train.pass1_data(state["lr"], state["hr"], rec, vols)
        for s in stretches:
            before = s["before"]
            start = {"it": s["it"], "opt": s.get("opt", {}),
                     "ema": before["ema"]}
            out.append(ref_train.run(
                desc, {k: before[k] for k in ("gen", "ds", "dt")}, data,
                ctx["seed"], len(s["losses"]), quant, fault, start))
    return out


def run(ctx: dict) -> dict:
    cfg, tr, devs = ctx["config"], ctx["traffic"], ctx["devices"]
    state = setup(ctx)
    if devs[0].type == "cuda":
        torch.cuda.synchronize(devs[0])
    setup_s = time.perf_counter() - ctx["t0"]
    seconds = (min(ctx["seconds"], tr["trace_seconds"]) if ctx["trace"]
               else ctx["seconds"])
    steps, w = window(ctx, state, seconds)
    peak = common.memory_peak(devs)
    state["trainer"] = state["tc"] = None
    if devs[0].type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(ctx, state)
    unit = reference(ctx, state, quant=nets.bf16_round)
    where: dict = {}
    numbers = compare(state["stretches"], ref, unit, where)
    batch = cfg["recipe"]["batch"]
    rates = state["chunk_rates"]
    common.note(ctx, f"window: {len(rates)} fit calls, steps/s per call "
                + " ".join(f"{r:.1f}" for r in rates))
    return {
        "setup_s": setup_s,
        "e2e": {"train_samples_per_s": batch * steps / w.wall_s},
        "attempted": steps, "failed": 0, "numbers": numbers, "where": where,
        "checked": sum(len(s["losses"]) for s in state["stretches"]),
        "memory_peak_bytes": peak,
        "record": {"units": steps, "window_s": w.wall_s,
                   "summary": w.summary,
                   "flops_per_unit": counts.train_step_flops(
                       descriptions(cfg)),
                   "warp_bytes_per_unit": counts.train_warp_bytes(
                       descriptions(cfg)),
                   "n_devices": len(devs)}}
