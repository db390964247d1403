"""Three-pass frames traffic: the frames traffic of :mod:`frames` through the
program's graphed upscaler with the yz refiner G3 as its third pass, one
captured program a frame.

Traffic keys: those of :mod:`frames` (``kind`` ``frames3``). Each pass
takes all its slices in one call inside the program (the pool's peak,
27.65 GB on an H100 at 64³ → 512³, leaves room beside the resident
frames). G1 and G2 are the configuration's two-pass
generators, drawn from the seed as in the frames traffic (the same seed
gives the same weights); G3 (``generator_pass3``) is drawn after them from
a stream of its own of the seed.
"""

from __future__ import annotations

import time

import torch

from port_bench import counts
from port_bench.drivers import common, frames
from port_bench.reference import frames3 as ref_frames3
from port_bench.reference import nets

# G3's weights: a stream of the seed of its own, apart from G1's and G2's
# and from the frames'
PASS3_STREAM = 0x3A55


def pass3_weights(config: dict, seed: int, device):
    """(p3, desc3): G3's parameters, drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed ^ PASS3_STREAM)
    d3 = common.generator_desc(config["generator_pass3"])
    return nets.make_weights(nets.generator_layout(d3), gen, device), d3


def inputs(ctx: dict) -> dict:
    """The frames traffic's weights and frames, and G3's weights."""
    state = frames.inputs(ctx)
    state["pass3"] = pass3_weights(ctx["config"], ctx["seed"],
                                   ctx["devices"][0])
    return state


def port_pass3(desc: dict, params: dict, dtype, out_dtype, device):
    """The program's pass-3 refiner with the widths of ``desc``, holding
    ``params`` (the benchmark's own tensors, copied)."""
    from mpgan_torch.models import generator as G
    if [tuple(f) for f in desc["factors"]] != [(1, 1)] \
            or desc["min_filters"] != 8 or desc["out_channels"] != 1:
        raise ValueError(f"the program's pass-3 refiner has one stage of "
                         f"factors (1, 1), min_filters 8 and one output "
                         f"channel; the configuration asks for {desc}")
    gen = G.make_pass3(base_filters=desc["base_filters"],
                       n_res_blocks=desc["n_res_blocks"], dtype=dtype,
                       out_dtype=out_dtype, in_channels=desc["in_channels"])
    gen = gen.to(device)
    gen.load_state_dict(params, strict=True)
    return gen


def setup(ctx: dict) -> dict:
    """The inputs and the warmed three-pass upscaler."""
    from mpgan_torch.infer import assemble
    cfg, tr, dev = ctx["config"], ctx["traffic"], ctx["devices"][0]
    state = inputs(ctx)
    p1, d1, p2, d2 = state["weights"]
    p3, d3 = state["pass3"]
    dt = common.torch_dtype(cfg["dtype"])
    g1 = common.port_generator(d1, 1, p1, dt, dt, dev)
    g2 = common.port_generator(d2, 2, p2, dt, dt, dev)
    g3 = port_pass3(d3, p3, dt, dt, dev)
    for g in (g1, g2, g3):
        g.eval().requires_grad_(False)
    up = assemble.make_graphed_upscaler(g1, g2, cfg["up_res"], gen3=g3)
    for i in range(tr["warm_calls"]):
        up(state["lr"][i % state["lr"].shape[0]])
    state["up"] = up
    return state


def check(ctx: dict, state: dict, kept: dict) -> dict:
    """:func:`frames.check`'s two numbers against the three-pass plain
    float32 reference on the same frame and weights: ``frame_rel_rms``
    and ``frame_err_ratio``, each the widest over the kept frames."""
    p1, d1, p2, d2 = state["weights"]
    p3, d3 = state["pass3"]
    lr, tr = state["lr"], ctx["traffic"]
    worst = {"frame_rel_rms": 0.0, "frame_err_ratio": 0.0}
    with common.strict_float32(), torch.no_grad():
        for k in sorted(kept):
            args = (p1, d1, p2, d2, p3, d3, lr[k % lr.shape[0]],
                    ctx["config"]["up_res"], tr["ref_block"])
            ref = ref_frames3.upscale(*args)
            err = common.rel_rms(kept[k], ref)
            unit = common.rel_rms(ref_frames3.upscale(*args,
                                                      nets.bf16_round), ref)
            worst["frame_rel_rms"] = max(worst["frame_rel_rms"], err)
            worst["frame_err_ratio"] = max(worst["frame_err_ratio"],
                                           err / max(unit, 1e-12))
            del ref
    return worst


def pass3_counts(config: dict, lr_size: int) -> tuple[int, int]:
    """(operations, bytes) of pass 3 a frame: G3's convolutions over the
    Xs yz slices of Ys × Zs, and its input (4 channels) read once and its
    output (1 channel) written once in the configuration's dtype."""
    s = lr_size * config["up_res"]
    d3 = common.generator_desc(config["generator_pass3"])
    size = torch.empty((), dtype=common.torch_dtype(
        config["dtype"])).element_size()
    return (s * counts.generator_flops(d3, s, s),
            s ** 3 * (d3["in_channels"] + d3["out_channels"]) * size)


def run(ctx: dict) -> dict:
    cfg, tr, devs = ctx["config"], ctx["traffic"], ctx["devices"]
    state = setup(ctx)
    if devs[0].type == "cuda":
        torch.cuda.synchronize(devs[0])
    setup_s = time.perf_counter() - ctx["t0"]
    seconds = (min(ctx["seconds"], tr["trace_seconds"]) if ctx["trace"]
               else ctx["seconds"])
    n, kept, w = frames.window(ctx, state, seconds, frames.picks(ctx))
    peak = common.memory_peak(devs)
    state["up"] = None
    if devs[0].type == "cuda":
        torch.cuda.empty_cache()
    s = tr["lr_size"] * cfg["up_res"]
    d1, d2 = state["weights"][1], state["weights"][3]
    ops3, bytes3 = pass3_counts(cfg, tr["lr_size"])
    numbers = check(ctx, state, kept)
    return {
        "setup_s": setup_s,
        "e2e": {"frame_vox_per_s": n * s ** 3 / w.wall_s},
        "attempted": n, "failed": 0,
        "numbers": numbers,
        "checked": len(kept),
        "memory_peak_bytes": peak,
        "record": {"units": n, "window_s": w.wall_s, "summary": w.summary,
                   "flops_per_unit": counts.frame_flops(
                       d1, d2, (tr["lr_size"],) * 3, cfg["up_res"]) + ops3,
                   "pass3_flops_per_unit": ops3,
                   "pass3_bytes_per_unit": bytes3,
                   "n_devices": len(devs)}}
