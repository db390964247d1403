"""Frames traffic: a simulation's LR frames, resident on the card, through
the program's graphed upscaler frame after frame in a closed loop.

Traffic keys: ``lr_size`` (LR edge), ``n_frames`` (distinct frames, made
from the seed), ``velocity`` (velocity range, LR cells per frame),
``devices`` (cards the upscaler splits each pass over), ``warm_calls``
(calls before the window: eager, capture, replay), ``max_in_flight``
(frames enqueued ahead of the last finished one), ``check_frames`` and
``check_span`` (frames compared, drawn from the seed among the window's
first ``check_span``; the window's last frame is compared too),
``ref_block`` (slices per block of the reference), ``trace_seconds``
(the traced window's length).
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from port_bench import counts, trace
from port_bench.drivers import common
from port_bench.reference import frames as ref_frames
from port_bench.reference import nets


def inputs(ctx: dict) -> dict:
    """The weights and the frames, made on the card from the seed."""
    cfg, tr, dev = ctx["config"], ctx["traffic"], ctx["devices"][0]
    p1, d1, p2, d2 = common.frame_weights(cfg, ctx["seed"], dev)
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"] ^ 0x5EED)
    lr = common.lr_frames(tr["n_frames"], tr["lr_size"], tr["velocity"],
                          gen, dev)
    return {"lr": lr, "weights": (p1, d1, p2, d2)}


def setup(ctx: dict) -> dict:
    """The inputs and the warmed upscaler."""
    from mpgan_torch.infer import assemble
    cfg, tr, devs = ctx["config"], ctx["traffic"], ctx["devices"]
    state = inputs(ctx)
    p1, d1, p2, d2 = state["weights"]
    dt = common.torch_dtype(cfg["dtype"])
    g1 = common.port_generator(d1, 1, p1, dt, dt, devs[0])
    g2 = common.port_generator(d2, 2, p2, dt, dt, devs[0])
    for g in (g1, g2):
        g.eval().requires_grad_(False)
    split = devs if len(devs) > 1 else None
    up = assemble.make_graphed_upscaler(g1, g2, cfg["up_res"], devices=split)
    for i in range(tr["warm_calls"]):
        up(state["lr"][i % state["lr"].shape[0]])
    state["up"] = up
    return state


def picks(ctx: dict) -> set[int]:
    """The window positions compared (besides the last), from the seed."""
    tr = ctx["traffic"]
    rng = np.random.default_rng(ctx["seed"])
    return set(rng.choice(tr["check_span"], size=tr["check_frames"],
                          replace=False).tolist())


def window(ctx: dict, state: dict, seconds: float, picks: set[int]):
    """Frames through the upscaler for ``seconds`` → (frames done, the
    kept outputs by window position, the window)."""
    up, lr, devs = state["up"], state["lr"], ctx["devices"]
    cuda = devs[0].type == "cuda"
    inflight: deque = deque()
    kept: dict[int, torch.Tensor] = {}
    n, out = 0, None
    with trace.Window(devs, ctx["trace"]) as w:
        end = w.t0 + seconds
        while time.perf_counter() < end:
            out = up(lr[n % lr.shape[0]])
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                inflight.append(ev)
            if n in picks:
                kept[n] = out
            n += 1
            while len(inflight) > ctx["traffic"]["max_in_flight"]:
                inflight.popleft().synchronize()
    if n:
        kept[n - 1] = out
    return n, kept, w


def check(ctx: dict, state: dict, kept: dict) -> dict:
    """Against the plain float32 reference on the same frame and weights:
    ``frame_rel_rms``, the widest relative RMS error of a kept frame; and
    ``frame_err_ratio``, the widest ratio of that error to the error of the
    reference computed with every convolution's operands and results and
    the output rounded to bfloat16 (the configuration's precision): the
    error in units of what that precision's rounding makes with these
    weights, which differ in how much they amplify it from seed to
    seed."""
    p1, d1, p2, d2 = state["weights"]
    lr, tr = state["lr"], ctx["traffic"]
    worst = {"frame_rel_rms": 0.0, "frame_err_ratio": 0.0}
    with common.strict_float32(), torch.no_grad():
        for k in sorted(kept):
            args = (p1, d1, p2, d2, lr[k % lr.shape[0]],
                    ctx["config"]["up_res"], tr["ref_block"])
            ref = ref_frames.upscale(*args)
            err = common.rel_rms(kept[k], ref)
            unit = common.rel_rms(ref_frames.upscale(*args, nets.bf16_round),
                                  ref)
            worst["frame_rel_rms"] = max(worst["frame_rel_rms"], err)
            worst["frame_err_ratio"] = max(worst["frame_err_ratio"],
                                           err / max(unit, 1e-12))
            del ref
    return worst


def run(ctx: dict) -> dict:
    cfg, tr, devs = ctx["config"], ctx["traffic"], ctx["devices"]
    state = setup(ctx)
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    setup_s = time.perf_counter() - ctx["t0"]
    seconds = (min(ctx["seconds"], tr["trace_seconds"]) if ctx["trace"]
               else ctx["seconds"])
    n, kept, w = window(ctx, state, seconds, picks(ctx))
    peak = common.memory_peak(devs)
    state["up"] = None
    if devs[0].type == "cuda":
        torch.cuda.empty_cache()
    s = tr["lr_size"] * cfg["up_res"]
    d1, d2 = state["weights"][1], state["weights"][3]
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
                       d1, d2, (tr["lr_size"],) * 3, cfg["up_res"]),
                   "n_devices": len(devs)}}
