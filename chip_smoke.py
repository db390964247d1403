#!/usr/bin/env python3
"""Drive the PyTorch port (mpgan_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a traceback and a non-zero
exit, and no result line:

1. build    nvcc builds every kernel of the port from csrc/ (in parallel)
2. warp     the warp kernel vs its plain version on the card: B=16 at 64²
            (the trainer's shape) and B=256 at 256², dt ±1, displacements
            beyond the ±8 clamp, zero velocity (max |Δ| ≤ 1e-5); gradients
            through advect_2d_fast vs autograd of the plain version (1e-4);
            kernel, plain, library (grid_sample) and bound times
3. bundled  the exported 4x L1 pair on sim_1010c frame 12 (32³→128³): f32
            with TF32 off equals the port's CPU output (atol 1e-4); bf16
            keeps PSNR ≥ 34.5 dB against the ground truth
4. bench    the main path at the bench shape: 4x, 64³→256³, bf16, base 32,
            2 res blocks, 2 stages, bundled weights; voxels/s
5. serve    InferenceServer on a temporary socket with the CUDA upscaler;
            3 requests (the bundled frame, a 64³ random frame twice) equal
            the direct call
6. align    the trainer's fake- and real-triplet alignment (G1 in f32 on
            sim_3020 frames 29/30/31, B=16 tiles of 16²) through the warp
            kernel, equal to the plain clamped warp (1e-5); the launch
            counts are reset just before this path and read just after
7. train    the flagship training recipe (pass 1, 4x, G base 32 with 2 res
            blocks, D base 32, B=16, LR tile 16, temporal D, hinge, lazy
            R1 γ=10 every 16 steps, TTUR, EMA 0.999) on a synthetic
            2 sims × 4 frames 32³→128³ dataset, through Trainer.fit:
            (a) one batch of draws assembled by the card's and the CPU's
            tile creator (max |Δ| ≤ 1e-6); float32 steps (TF32 off,
            lrgan = adamEps = 1) from the same seeded weights on that
            batch, on the card and on the CPU: losses within rtol 1e-3;
            the updated G, Ds, Dt and EMA parameters within atol 1e-4 at
            step 1 (R1 skipped, lrdisc 1) and step 0 (R1 applied, lrdisc
            1e-2), Ds and Dt at step 0 with lrdisc 1; the CPU step without
            oneDNN is reported beside each as the spread of float32
            summation order; (b) bf16: 3 warm-up steps, then 3 windows of
            32 timed steps (each with two R1 steps) between CUDA events,
            with the launch counts reset just before and read just after:
            6 warp launches per step, finite metrics, EMA ≠ G; (c) pass 2
            (D factors (2, 1)), bf16: 4 steps, 6 warp launches per step,
            finite metrics

Then one JSON line listing every kernel, the card's name and power limit
(nvidia-smi), and last the line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Runs on one card; exits non-zero without CUDA.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "examples", "data")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
WARP_FLOPS_PER_PX = 27         # clamps, floors, weights and 4-tap blend


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0, **info):
    print(f"   ok in {time.perf_counter() - t0:.2f} s "
          + " ".join(f"{k}={v}" for k, v in info.items()), flush=True)


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls,
    between CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def warp_inputs(b, h, w, vscale, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    f = torch.rand((b, h, w, 1), generator=g, device=dev)
    v = torch.randn((b, h, w, 2), generator=g, device=dev) * vscale
    return f, v


def grid_for(vel, dt, r):
    """grid_sample's normalised (x, y) grid of the clamped backtrace."""
    b, h, w, _ = vel.shape
    ys = torch.arange(h, device=vel.device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=vel.device, dtype=torch.float32)[None, :]
    px = (xs + (-dt * vel[..., 0]).clamp(-r, r)).clamp(0, w - 1)
    py = (ys + (-dt * vel[..., 1]).clamp(-r, r)).clamp(0, h - 1)
    return torch.stack([px * (2.0 / (w - 1)) - 1, py * (2.0 / (h - 1)) - 1],
                       dim=-1)


def phase_warp(dev, wk):
    t0 = phase("2 warp kernel vs plain")
    max_err = 0.0
    for b, h, w in ((16, 64, 64), (256, 256, 256)):
        for dt in (1.0, -1.0):
            for vscale in (1.5, 12.0, 0.0):
                f, v = warp_inputs(b, h, w, vscale, 1, dev)
                got = wk.advect_2d_kernel(f, v, dt)
                torch.cuda.synchronize()
                want = wk.advect_2d_clamped_ref(f, v, dt)
                err = float((got - want).abs().max())
                assert err <= 1e-5, (b, h, w, dt, vscale, err)
                if vscale == 0.0:
                    assert float((got - f).abs().max()) <= 1e-6
                max_err = max(max_err, err)
    f, v = warp_inputs(16, 64, 64, 6.0, 2, dev)
    tf, tv = f.clone().requires_grad_(), v.clone().requires_grad_()
    g = torch.randn_like(f)
    wk.advect_2d_fast(tf, tv, 1.0).backward(g)
    rf, rv = f.clone().requires_grad_(), v.clone().requires_grad_()
    wk.advect_2d_clamped_ref(rf, rv, 1.0).backward(g)
    gerr = max(float((tf.grad - rf.grad).abs().max()),
               float((tv.grad - rv.grad).abs().max()))
    assert gerr <= 1e-4, gerr

    times = {}
    for b, h, w, iters in ((16, 64, 64, 200), (256, 256, 256, 20)):
        f, v = warp_inputs(b, h, w, 1.5, 3, dev)
        grid = grid_for(v, 1.0, wk.DEFAULT_MAX_DISP)
        f_nchw = f.permute(0, 3, 1, 2)
        lib = F.grid_sample(f_nchw, grid, mode="bilinear",
                            padding_mode="border", align_corners=True)
        lib_err = float((lib.permute(0, 2, 3, 1)
                         - wk.advect_2d_clamped_ref(f, v, 1.0)).abs().max())
        px = b * h * w
        t = {
            "shape": [b, h, w],
            "ms": cuda_ms(lambda: wk.advect_2d_kernel(f, v, 1.0), iters),
            "plain_ms": cuda_ms(lambda: wk.advect_2d_clamped_ref(f, v, 1.0),
                                iters),
            "library_ms": cuda_ms(lambda: F.grid_sample(
                f_nchw, grid, mode="bilinear", padding_mode="border",
                align_corners=True), iters),
            "bound_ms": max(px * 16 / HBM_BYTES_PER_S,
                            px * WARP_FLOPS_PER_PX / F32_FLOPS) * 1e3,
            "library_max_abs_err": lib_err,
        }
        times[(b, h, w)] = t
        print("   warp timing " + json.dumps(t), flush=True)
    done(t0, max_abs_err=max_err, grad_max_abs_err=gerr)
    return max_err, gerr, times


def load_chain(dtype, device):
    from mpgan_torch import config
    from mpgan_torch.infer import load

    cfg = config.Config()
    cfg.model.dtype = dtype
    g1 = load.load_generator_npz(load.bundled_weights("g1_l1_4x"), 1, cfg,
                                 device)
    g2 = load.load_generator_npz(load.bundled_weights("g2_l1_4x"), 2, cfg,
                                 device)
    return cfg, g1, g2


def phase_bundled(dev):
    from mpgan_torch.infer import assemble, load
    from mpgan_torch.io import uni

    t0 = phase("3 bundled 4x chain (sim_1010c frame 12, 32^3 -> 128^3)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, c1, c2 = load_chain("float32", "cpu")
    lr = load.read_lr_frame(cfg, os.path.join(DATA, "sim_1010c"), 12)
    with torch.inference_mode():
        ref = assemble.upscale_volume(c1, c2, torch.from_numpy(lr), 4)
    _, g1, g2 = load_chain("float32", dev)
    lr_dev = torch.from_numpy(lr).to(dev)
    with torch.inference_mode():
        out32 = assemble.upscale_volume(g1, g2, lr_dev, 4).cpu()
    err32 = float((out32 - ref).abs().max())
    assert err32 <= 1e-4, err32
    torch.backends.cudnn.allow_tf32 = True
    _, b1, b2 = load_chain("bfloat16", dev)
    with torch.inference_mode():
        out16 = assemble.upscale_volume(b1, b2, lr_dev, 4)
    assert out16.dtype == torch.bfloat16 and out16.shape == (128, 128, 128, 1)
    assert bool(torch.isfinite(out16).all())
    gt = uni.readUni(os.path.join(DATA, "sim_1010c",
                                  "density_high_0012.uni"))[1]
    p16 = assemble.psnr_volume(out16, gt)
    p32 = assemble.psnr_volume(out32, gt)
    assert p16 >= 34.5, p16
    done(t0, f32_vs_cpu_max_abs_err=err32, psnr_f32=p32, psnr_bf16=p16)
    return lr, {"f32_vs_cpu_max_abs_err": err32, "psnr_f32_db": p32,
                "psnr_bf16_db": p16}


def phase_bench(dev):
    from mpgan_torch.infer import assemble

    t0 = phase("4 main path: 4x 64^3 -> 256^3 bf16, base 32, 2 res blocks")
    _, g1, g2 = load_chain("bfloat16", dev)
    lr = torch.from_numpy(np.random.default_rng(0).random(
        (64, 64, 64, 4), dtype=np.float32)).to(dev)
    with torch.inference_mode():
        out = assemble.upscale_volume(g1, g2, lr, 4)
        assert out.shape == (256, 256, 256, 1) and out.dtype == torch.bfloat16
        assert bool(torch.isfinite(out).all())
        frame_ms = cuda_ms(lambda: assemble.upscale_volume(g1, g2, lr, 4), 10,
                           warmup=2)
        interm = assemble.pass1_volume(g1, lr)
        pass1_ms = cuda_ms(lambda: assemble.pass1_volume(g1, lr), 10)
        pass2_ms = cuda_ms(lambda: assemble.pass2_volume(
            g2, interm, lr[..., 1:4]), 10)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        assemble.upscale_volume(g1, g2, lr, 4)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    res = {"frame_ms": frame_ms, "voxels_per_s": 256 ** 3 / (frame_ms / 1e3),
           "pass1_ms": pass1_ms, "pass2_ms": pass2_ms,
           "peak_mem_bytes": peak}
    print("   main path " + json.dumps(res), flush=True)
    done(t0)
    return res


def phase_serve(dev, bundled_lr):
    from mpgan_torch import serve

    t0 = phase("5 serving: InferenceServer + Client, 3 requests")
    _, g1, g2 = load_chain("bfloat16", dev)
    upscale = serve.make_upscaler((g1, g2, None), dev, up_res=4)
    rnd = np.random.default_rng(1).random((64, 64, 64, 4), dtype=np.float32)
    with tempfile.TemporaryDirectory() as d:
        sock = os.path.join(d, "mpgan.sock")
        server = serve.InferenceServer(upscale, sock, expect_channels=4)
        server.warm((64, 64, 64, 4))
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        try:
            with serve.Client(sock, timeout=300) as c:
                for lr in (bundled_lr, rnd, rnd):
                    t = time.perf_counter()
                    hr = c.upscale(lr)
                    req_s = time.perf_counter() - t
                    direct = serve._to_host(upscale(lr))
                    assert hr.shape == direct.shape, (hr.shape, direct.shape)
                    assert np.array_equal(hr, direct)
                    print(f"   request {lr.shape} -> {hr.shape} in "
                          f"{req_s:.3f} s, equal to the direct call",
                          flush=True)
                c.shutdown_server()
        finally:
            th.join(timeout=60)
        assert not th.is_alive(), "server thread did not stop"
    done(t0)


def phase_align(dev, wk):
    from mpgan_torch import config
    from mpgan_torch.data import loader
    from mpgan_torch.infer import load
    from mpgan_torch.io import uni
    from mpgan_torch.train import loop, losses

    t0 = phase("6 fake/real triplet alignment through the warp kernel")
    torch.backends.cudnn.allow_tf32 = False
    cfg, g1, _ = load_chain("float32", dev)
    sim = os.path.join(DATA, "sim_3020")
    batch = {}
    for key, f in (("prev", 29), ("", 30), ("next", 31)):
        sfx = f"_{key}" if key else ""
        lr = load.read_lr_frame(cfg, sim, f)          # (16, 16, 16, 4)
        hr = uni.readUni(os.path.join(sim, loader.HIGH_DENSITY % f))[1]
        batch["lr" + sfx] = torch.from_numpy(lr).to(dev)   # B=16 xy tiles
        batch["hr" + sfx] = torch.from_numpy(
            np.ascontiguousarray(hr[2::4])).to(dev)   # centre HR planes
    use_kernel = losses.use_warp_kernel(cfg.loss.warp_backend, dev)
    assert use_kernel
    md = cfg.loss.warp_max_disp
    wk.launches = 0                                    # path starts
    with torch.no_grad():
        fakes = loop.aligned_fakes(g1, batch, 1, 2, 4, use_kernel, md)
        reals = loop.aligned_reals(batch, 1, 2, 4, use_kernel, md)
    torch.cuda.synchronize()
    launches = wk.launches                             # path ends
    assert launches == 4, launches
    vel = loop.vel_hr(batch, 1, 2, 4)
    with torch.no_grad():
        f_prev, _, f_next = loop.fake_triplet(g1, batch, 1, 2)
        plain = [wk.advect_2d_clamped_ref(f_prev, vel, 1.0, md),
                 wk.advect_2d_clamped_ref(f_next, vel, -1.0, md),
                 wk.advect_2d_clamped_ref(batch["hr_prev"], vel, 1.0, md),
                 wk.advect_2d_clamped_ref(batch["hr_next"], vel, -1.0, md)]
    got = [fakes[..., 0:1], fakes[..., 2:3], reals[..., 0:1], reals[..., 2:3]]
    err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
    assert err <= 1e-5, err
    assert fakes.shape == reals.shape == (16, 64, 64, 3)
    clamped = float((vel.abs() > md).float().mean())
    done(t0, launches=launches, max_abs_err=err,
         vel_hr_max=float(vel.abs().max()), share_beyond_clamp=clamped)
    return launches, err


TRAIN_METRICS = ("d_loss", "dt_loss", "g_loss", "g_adv", "l1", "feat", "g_t",
                 "psnr")


def _train_state(rt):
    """Every parameter of the step's nets and the EMA, on the host."""
    out = {f"{net}.{k}": v.detach().cpu()
           for net in ("gen", "ds", "dt")
           for k, v in getattr(rt, net).state_dict().items()}
    out.update({f"ema.{k}": v.cpu() for k, v in rt.ema.items()})
    return out


def _f32_step(cfg, tc, batch, step):
    """One step at ``step`` from the seeded initial weights on the injected
    ``batch``, on the tile creator's device → (metrics, every parameter on
    the host)."""
    from mpgan_torch.train import loop

    d = tc.device
    rt = loop.Trainer(cfg, tc, device=d).runtime()
    rt.step = step
    b = {k: v.to(d) for k, v in batch.items()}
    rt.step_stable.sample = lambda rng: b
    m = loop.read_metrics(rt.step_stable(1.0, torch.Generator(device=d)))
    return m, _train_state(rt)


def _step_gap(run, ref):
    """(max relative gap of the losses, max abs gap of the parameters per
    net) between two ``_f32_step`` results."""
    (m, p), (mr, pr) = run, ref
    loss_rel = max(abs(m[k] - mr[k]) / max(abs(mr[k]), 1e-12)
                   for k in TRAIN_METRICS)
    err = {}
    for k in pr:
        net = k.split(".")[0]
        err[net] = max(err.get(net, 0.0), float((p[k] - pr[k]).abs().max()))
    return loss_rel, err


def phase_train(dev, wk):
    from mpgan_torch.data import pipeline
    from mpgan_torch.train import loop, recipe

    t0 = phase("7 train: flagship pass-1 4x temporal GAN, B=16 tile 16")
    ds = recipe.synthetic_dataset()          # 2 sims x 4 frames, 32^3->128^3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_tc = pipeline.TileCreator(ds, 16, density_threshold=0.0, device="cpu")
    tc = pipeline.TileCreator(ds, 16, density_threshold=0.0, device=dev)

    # (a) one batch of draws, assembled by the card's and the CPU's tile
    # creator (each from its own hrz)
    idx, st = cpu_tc.dense_idx_t, cpu_tc.st
    draws = pipeline.draw(torch.Generator().manual_seed(0), 16, idx, st)
    batch = pipeline.assemble_pass1(cpu_tc.lr, cpu_tc.hrz, idx, draws, "xy",
                                    True, st)
    on_card = pipeline.assemble_pass1(
        tc.lr, tc.hrz, tc.dense_idx_t,
        pipeline.Draws(*(t.to(dev) for t in draws)), "xy", True, tc.st)
    assembly_err = max(float((on_card[k].cpu() - v).abs().max())
                       for k, v in batch.items())
    assert assembly_err <= 1e-6, assembly_err

    # float32 steps from the same seeded weights on that batch, on the card
    # and on the CPU (lrgan = adamEps = 1): step 1 (R1 skipped) and step 0
    # (R1 applied) with lrdisc 1e-2 hold every parameter; step 0 with
    # lrdisc 1 holds the losses, Ds and Dt, and reports G. The CPU again
    # without oneDNN (another convolution summation order) is the witness
    # of how far the float32 step itself is from one summation order to
    # another.
    cfg = recipe.flagship_config("float32")
    cfg.train.learning_rate = cfg.train.adam_eps = 1.0
    parity = {}
    for step, lr_disc in ((1, 1.0), (0, 1e-2), (0, 1.0)):
        cfg.train.lr_disc = lr_disc
        card = _f32_step(cfg, tc, batch, step)
        cpu = _f32_step(cfg, cpu_tc, batch, step)
        torch.backends.mkldnn.enabled = False
        try:
            cpu_other = _f32_step(cfg, cpu_tc, batch, step)
        finally:
            torch.backends.mkldnn.enabled = True
        loss_rel, err = _step_gap(card, cpu)
        saturated = step == 0 and lr_disc == 1.0
        held = {k: err[k] for k in ("ds", "dt")} if saturated else err
        assert loss_rel <= 1e-3, (step, lr_disc, loss_rel)
        assert max(held.values()) <= 1e-4, (step, lr_disc, err)
        w_rel, w_err = _step_gap(cpu_other, cpu)
        parity[f"step{step}_lrdisc{lr_disc:g}"] = {
            "loss_max_rel_err": loss_rel, "param_max_abs_err": err,
            "cpu_no_onednn_loss_max_rel_err": w_rel,
            "cpu_no_onednn_param_max_abs_err": w_err}
    torch.backends.cudnn.allow_tf32 = True
    print("   f32 step card vs CPU " + json.dumps(
        {"assembly_max_abs_err": assembly_err, **parity}), flush=True)

    # (b) bf16 steps through Trainer.fit: 3 windows of 32 steps, each with
    # two R1 steps
    cfg = recipe.flagship_config("bfloat16")
    tr = loop.Trainer(cfg, tc, device=dev)
    tr.fit(3, log_every=3)                   # warm-up (R1 at step 0)
    n, windows = 32, 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(windows + 1)]
    wk.launches = 0                                    # path starts
    events[0].record()
    for w in range(windows):
        out = tr.fit(3 + (w + 1) * n, start_it=3 + w * n, log_every=n)
        events[w + 1].record()
    torch.cuda.synchronize()
    launches = wk.launches                             # path ends
    ms = [events[w].elapsed_time(events[w + 1]) / n for w in range(windows)]
    steps = n * windows
    assert launches == 6 * steps, launches
    assert all(np.isfinite(out[k]) for k in TRAIN_METRICS), out
    rt = tr.rt
    ema_gap = max(float((rt.ema[k] - p.detach()).abs().max())
                  for k, p in rt.gen.named_parameters())
    assert ema_gap > 0, ema_gap
    assert rt.step == 3 + steps
    med = sorted(ms)[windows // 2]
    res = {"ms_per_step": med, "ms_per_step_windows": ms,
           "steps_per_s": 1e3 / med, "samples_per_s": 16e3 / med,
           "steps": steps, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "warp_launches": launches,
           "warp_launches_per_step": launches / steps,
           "ema_max_abs_gap": ema_gap, "f32_parity": parity,
           "assembly_max_abs_err": assembly_err,
           "metrics": {k: out[k] for k in TRAIN_METRICS}}

    # (c) pass 2 (4x along x, D factors (2, 1)), bf16: 4 steps through
    # Trainer.fit, the first with R1
    tr2 = loop.Trainer(cfg, tc, device=dev, pass_no=2)
    wk.launches = 0                                    # path starts
    out2 = tr2.fit(4, log_every=4)
    torch.cuda.synchronize()
    launches2 = wk.launches                            # path ends
    assert launches2 == 6 * 4, launches2
    assert all(np.isfinite(out2[k]) for k in TRAIN_METRICS), out2
    res["pass2"] = {"steps": 4, "warp_launches": launches2,
                    "metrics": {k: out2[k] for k in TRAIN_METRICS}}
    print("   train " + json.dumps(res), flush=True)
    done(t0)
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; the port's smoke run needs "
              "one", file=sys.stderr)
        return 2
    from mpgan_torch import _build
    from mpgan_torch.ops import warp_kernel as wk

    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = phase("1 build kernels (nvcc, sm_90a)")
    paths = _build.build()
    _build.load("warp")
    build_s = time.perf_counter() - t0
    done(t0, libs=",".join(sorted(paths)))

    max_err, grad_err, times = phase_warp(dev, wk)
    bundled_lr, quality = phase_bundled(dev)
    bench = phase_bench(dev)
    phase_serve(dev, bundled_lr)
    align_launches, align_err = phase_align(dev, wk)
    train = phase_train(dev, wk)

    small, large = times[(16, 64, 64)], times[(256, 256, 256)]
    kernels = [{
        "name": "warp2d", "route": "cuda",
        "source": "mpgan_torch/csrc/warp.cu",
        "replaces": "mpgan_tpu/ops/warp_pallas.py:89",
        "launches": train["warp_launches"],
        "launches_per_train_step": train["warp_launches_per_step"],
        "launches_align": align_launches,
        "launches_pass2": train["pass2"]["warp_launches"],
        "max_abs_err": max(max_err, align_err),
        "ms": small["ms"], "plain_ms": small["plain_ms"],
        "bound_ms": small["bound_ms"], "bound_by": "bytes",
        "library_ms": small["library_ms"],
        "shape": small["shape"], "grad_max_abs_err": grad_err,
        "large": large, "build_s": build_s,
    }]
    print(json.dumps({"kernels": kernels, "main_path": bench,
                      "bundled": quality, "train": train}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
