#!/usr/bin/env python3
"""Drive the PyTorch port (mpgan_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a traceback and a non-zero
exit, and no result line:

1. build    nvcc builds every kernel of the port from csrc/ (in parallel)
2. warp     every warp kernel vs its plain version on the card, at B=16
            64² (the trainer's shape, one block per image in the
            backward) and B=256 256² (tiled backward), velocity scales
            1.5, 12 (beyond the ±8 clamp) and 0: the single-field and the
            triplet forward (max |Δ| ≤ 1e-5); the gradients of every input
            through advect_2d_fast and align_triplet_fast and the field
            gradients as the train step asks for them (1e-4); each
            kernel's time against its plain version, a library call
            (grid_sample, grid_sampler_2d_backward) and its bound
2b single  advect_2d_fast forward and backward at B=16 64², the launch
            counts reset just before and read just after: 1 and 1
3. bundled  the exported 4x L1 pair on sim_1010c frame 12 (32³→128³): f32
            with TF32 off equals the port's CPU output (atol 1e-4); bf16
            keeps PSNR ≥ 34.5 dB against the ground truth
4. bench    the main path at the bench shape: 4x, 64³→256³, bf16, base 32,
            2 res blocks, 2 stages, bundled weights; voxels/s
5. serve    InferenceServer on a temporary socket with the CUDA upscaler;
            3 requests (the bundled frame, a 64³ random frame twice) equal
            the direct call
6. align    the trainer's fake- and real-triplet alignment (G1 in f32 on
            sim_3020 frames 29/30/31, B=16 tiles of 16²) through the
            triplet kernel, equal to the plain version (1e-5); the launch
            counts are reset just before this path and read just after:
            2 forward, no backward
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
            3 forward and 1 backward warp launches per step, finite
            metrics, EMA ≠ G; (c) pass 2 (D factors (2, 1)), bf16: 4
            steps, 3 forward and 1 backward warp launches per step, finite
            metrics

Then one JSON line listing every kernel (its launches on the path that
runs it, its times at B=16 64², and under "large" at B=256 256²), the
card's name and power limit (nvidia-smi), and last the line
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

# The warp kernels: where each replaces the TPU kernel (or, for the
# backward, the custom_vjp backward of the TPU kernel's wrapper), and what
# the work the train step asks of it moves and computes per pixel: bytes
# (each input read once, each output written once; the backward as the
# train step runs it, without the velocity gradient) and f32 operations
# (clamps, floors, weights and the 4-tap blend or scatter, per field).
WARP_KERNELS = {
    "warp2d": ("mpgan_tpu/ops/warp_pallas.py:89", 16, 27),
    "warp2d_bwd": ("mpgan_tpu/ops/warp_pallas.py:126", 16, 30),
    "warp2d_triplet": ("mpgan_tpu/ops/warp_pallas.py:89", 32, 54),
    "warp2d_triplet_bwd": ("mpgan_tpu/ops/warp_pallas.py:126", 24, 60),
}
WARP_SHAPES = ((16, 64, 64, 200), (256, 256, 256, 20))  # B, H, W, timed calls


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
    """prev, cur, nxt (B, H, W, 1), vel (B, H, W, 2) and a gradient of the
    (B, H, W, 3) triplet with NCHW strides, as Dt's backward hands it
    over."""
    g = torch.Generator(device=dev).manual_seed(seed)
    p, c, n = (torch.rand((b, h, w, 1), generator=g, device=dev)
               for _ in range(3))
    v = torch.randn((b, h, w, 2), generator=g, device=dev) * vscale
    gy = torch.randn((b, 3, h, w), generator=g, device=dev).permute(0, 2, 3, 1)
    return p, c, n, v, gy


def grid_for(vel, dt, r):
    """grid_sample's normalised (x, y) grid of the clamped backtrace."""
    b, h, w, _ = vel.shape
    ys = torch.arange(h, device=vel.device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=vel.device, dtype=torch.float32)[None, :]
    px = (xs + (-dt * vel[..., 0]).clamp(-r, r)).clamp(0, w - 1)
    py = (ys + (-dt * vel[..., 1]).clamp(-r, r)).clamp(0, h - 1)
    return torch.stack([px * (2.0 / (w - 1)) - 1, py * (2.0 / (h - 1)) - 1],
                       dim=-1)


def gap(got, want):
    """Max abs difference over pairs of tensors."""
    return max(float((a - b).detach().abs().max())
               for a, b in zip(got, want))


def warp_checks(wk, b, h, w, vscale, dev):
    """Every warp kernel against its plain version on one input: the
    forwards (1e-5), and the gradients of every input through the
    autograd Functions and the field gradients as the train step asks for
    them (1e-4). → max abs error per kernel."""
    p, c, n, v, gy = warp_inputs(b, h, w, vscale, 1, dev)
    g1 = gy[..., :1]
    err = {}
    for dt in (1.0, -1.0):
        got = wk.advect_2d_kernel(p, v, dt)
        torch.cuda.synchronize()
        e = gap([got], [wk.advect_2d_clamped_ref(p, v, dt)])
        assert e <= 1e-5, ("warp2d", b, h, w, dt, vscale, e)
        if vscale == 0.0:
            assert gap([got], [p]) <= 1e-6
        err["warp2d"] = max(err.get("warp2d", 0.0), e)
        ref_in = [t.clone().requires_grad_() for t in (p, v)]
        ref = torch.autograd.grad(wk.advect_2d_clamped_ref(*ref_in, dt),
                                  ref_in, g1)
        k_in = [t.clone().requires_grad_() for t in (p, v)]
        got = torch.autograd.grad(wk.advect_2d_fast(*k_in, dt), k_in, g1)
        only_f, _ = wk.advect_2d_kernel_bwd(g1, p, v, dt)
        torch.cuda.synchronize()
        e = max(gap(got, ref), gap([only_f], ref[:1]))
        assert e <= 1e-4, ("warp2d_bwd", b, h, w, dt, vscale, e)
        err["warp2d_bwd"] = max(err.get("warp2d_bwd", 0.0), e)
    got = wk.align_triplet_kernel(p, c, n, v)
    torch.cuda.synchronize()
    e = gap([got], [wk.align_triplet_ref(p, c, n, v)])
    assert e <= 1e-5, ("warp2d_triplet", b, h, w, vscale, e)
    err["warp2d_triplet"] = e
    ref_in = [t.clone().requires_grad_() for t in (p, c, n, v)]
    ref = torch.autograd.grad(wk.align_triplet_ref(*ref_in), ref_in, gy)
    k_in = [t.clone().requires_grad_() for t in (p, c, n, v)]
    got = torch.autograd.grad(wk.align_triplet_fast(*k_in), k_in, gy)
    d_prev, d_nxt, _ = wk.align_triplet_kernel_bwd(gy, p, n, v)
    torch.cuda.synchronize()
    e = max(gap(got, ref), gap([d_prev, d_nxt], [ref[0], ref[2]]))
    assert e <= 1e-4, ("warp2d_triplet_bwd", b, h, w, vscale, e)
    err["warp2d_triplet_bwd"] = e
    return err


def warp_times(wk, b, h, w, iters, dev):
    """Each warp kernel at one shape: its wrapper's time per call (CUDA
    events over back-to-back calls), its plain version's (for a backward,
    the autograd backward of the plain forward through a kept graph), one
    PyTorch call computing the same function (grid_sample, and for a
    backward grid_sampler_2d_backward of the input alone; also grid_sample
    forward plus backward through autograd), and its bound."""
    p, c, n, v, gy = warp_inputs(b, h, w, 1.5, 3, dev)
    r = wk.DEFAULT_MAX_DISP
    g1 = gy[..., :1]
    grid_p, grid_n = grid_for(v, 1.0, r), grid_for(v, -1.0, r)
    one = p.permute(0, 3, 1, 2)
    two = torch.cat([p, n]).permute(0, 3, 1, 2)
    grid2 = torch.cat([grid_p, grid_n])
    g_one = g1.permute(0, 3, 1, 2).contiguous()
    g_two = torch.cat([gy[..., 0:1], gy[..., 2:3]]).permute(0, 3, 1, 2)

    def gs(x, grid):
        return F.grid_sample(x, grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    def gs_bwd(go, x, grid):  # d input only: bilinear, border, corners
        return torch.ops.aten.grid_sampler_2d_backward(
            go, x, grid, 0, 1, True, [True, False])[0]

    def gs_fwd_bwd(x, grid, go):
        x = x.detach().requires_grad_()
        return torch.autograd.grad(gs(x, grid), x, go)[0]

    def plain_bwd(fn, inputs, go):
        inputs = [t.clone().requires_grad_() for t in inputs]
        out = fn(*inputs)
        return lambda: torch.autograd.grad(out, inputs, go, retain_graph=True)

    ref1 = wk.advect_2d_clamped_ref(p, v, 1.0)
    ref3 = wk.align_triplet_ref(p, c, n, v)
    ref1_bwd = plain_bwd(lambda f: wk.advect_2d_clamped_ref(f, v, 1.0),
                         [p], g1)()[0]
    ref3_bwd = plain_bwd(lambda a, z: wk.align_triplet_ref(a, c, z, v),
                         [p, n], gy)()
    lib_err = {
        "warp2d": gap([gs(one, grid_p).permute(0, 2, 3, 1)], [ref1]),
        "warp2d_bwd": gap([gs_bwd(g_one, one, grid_p).permute(0, 2, 3, 1)],
                          [ref1_bwd]),
        "warp2d_triplet": gap(
            gs(two, grid2).permute(0, 2, 3, 1).chunk(2),
            [ref3[..., 0:1], ref3[..., 2:3]]),
        "warp2d_triplet_bwd": gap(
            gs_bwd(g_two, two, grid2).permute(0, 2, 3, 1).chunk(2),
            ref3_bwd),
    }
    calls = {
        "warp2d": (lambda: wk.advect_2d_kernel(p, v, 1.0),
                   lambda: wk.advect_2d_clamped_ref(p, v, 1.0),
                   lambda: gs(one, grid_p), None),
        "warp2d_bwd": (lambda: wk.advect_2d_kernel_bwd(g1, p, v, 1.0),
                       plain_bwd(lambda f: wk.advect_2d_clamped_ref(f, v, 1.0),
                                 [p], g1),
                       lambda: gs_bwd(g_one, one, grid_p),
                       lambda: gs_fwd_bwd(one, grid_p, g_one)),
        "warp2d_triplet": (lambda: wk.align_triplet_kernel(p, c, n, v),
                           lambda: wk.align_triplet_ref(p, c, n, v),
                           lambda: gs(two, grid2), None),
        "warp2d_triplet_bwd": (
            lambda: wk.align_triplet_kernel_bwd(gy, p, n, v),
            plain_bwd(lambda a, m, z: wk.align_triplet_ref(a, m, z, v),
                      [p, c, n], gy),
            lambda: gs_bwd(g_two, two, grid2),
            lambda: gs_fwd_bwd(two, grid2, g_two)),
    }
    px = b * h * w
    out = {}
    for name, (kern, plain, lib, lib_fb) in calls.items():
        _, nbytes, flops = WARP_KERNELS[name]
        out[name] = {
            "shape": [b, h, w],
            "ms": cuda_ms(kern, iters),
            "plain_ms": cuda_ms(plain, iters),
            "library_ms": cuda_ms(lib, iters),
            "bound_ms": max(px * nbytes / HBM_BYTES_PER_S,
                            px * flops / F32_FLOPS) * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / F32_FLOPS else "operations"),
            "library_max_abs_err": lib_err[name],
        }
        if lib_fb is not None:
            out[name]["library_fwd_bwd_ms"] = cuda_ms(lib_fb, iters)
    return out


def phase_warp(dev, wk):
    t0 = phase("2 warp kernels vs plain")
    err = {k: 0.0 for k in WARP_KERNELS}
    for b, h, w, _ in WARP_SHAPES:
        for vscale in (1.5, 12.0, 0.0):
            for k, e in warp_checks(wk, b, h, w, vscale, dev).items():
                err[k] = max(err[k], e)
    times = {}
    for b, h, w, iters in WARP_SHAPES:
        for name, t in warp_times(wk, b, h, w, iters, dev).items():
            times.setdefault(name, []).append(t)
            print(f"   {name} timing " + json.dumps(t), flush=True)
    done(t0, **{f"{k}_max_abs_err": e for k, e in err.items()})
    return err, times


def phase_single_path(dev, wk):
    """The single-field entry point a user calls, advect_2d_fast (the JAX
    package's advect_2d_fast), forward and backward at the trainer's
    shape: one launch of each kernel."""
    t0 = phase("2b advect_2d_fast: single-field warp, forward and backward")
    p, _, _, v, gy = warp_inputs(16, 64, 64, 1.5, 4, dev)
    f = p.clone().requires_grad_()
    wk.launches = wk.bwd_launches = 0                  # path starts
    out = wk.advect_2d_fast(f, v, 1.0)
    out.backward(gy[..., :1])
    torch.cuda.synchronize()
    counts = (wk.launches, wk.bwd_launches)            # path ends
    assert counts == (1, 1), counts
    r = f.detach().requires_grad_()
    want = wk.advect_2d_clamped_ref(r, v, 1.0)
    want.backward(gy[..., :1])
    err = gap([out, f.grad], [want, r.grad])
    assert err <= 1e-4, err
    assert out.shape == (16, 64, 64, 1) and bool(torch.isfinite(out).all())
    done(t0, launches=counts[0], bwd_launches=counts[1], max_abs_err=err)
    return counts, err


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

    t0 = phase("6 fake/real triplet alignment through the warp kernels")
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
    wk.launches = wk.bwd_launches = 0                  # path starts
    with torch.no_grad():
        fakes = loop.aligned_fakes(g1, batch, 1, 2, 4, use_kernel, md)
        reals = loop.aligned_reals(batch, 1, 2, 4, use_kernel, md)
    torch.cuda.synchronize()
    launches = (wk.launches, wk.bwd_launches)          # path ends
    assert launches == (2, 0), launches
    vel = loop.vel_hr(batch, 1, 2, 4)
    with torch.no_grad():
        fake_in = loop.fake_triplet(g1, batch, 1, 2)
        plain = [wk.align_triplet_ref(*fake_in, vel, md),
                 wk.align_triplet_ref(batch["hr_prev"], batch["hr"],
                                      batch["hr_next"], vel, md)]
    err = gap([fakes, reals], plain)
    assert err <= 1e-5, err
    assert fakes.shape == reals.shape == (16, 64, 64, 3)
    clamped = float((vel.abs() > md).float().mean())
    done(t0, launches=launches[0], max_abs_err=err,
         vel_hr_max=float(vel.abs().max()), share_beyond_clamp=clamped)
    return launches[0], err


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
    wk.launches = wk.bwd_launches = 0                  # path starts
    events[0].record()
    for w in range(windows):
        out = tr.fit(3 + (w + 1) * n, start_it=3 + w * n, log_every=n)
        events[w + 1].record()
    torch.cuda.synchronize()
    launches, bwd_launches = wk.launches, wk.bwd_launches  # path ends
    ms = [events[w].elapsed_time(events[w + 1]) / n for w in range(windows)]
    steps = n * windows
    assert (launches, bwd_launches) == (3 * steps, steps), (launches,
                                                            bwd_launches)
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
           "warp_launches": launches, "warp_bwd_launches": bwd_launches,
           "warp_launches_per_step": launches / steps,
           "warp_bwd_launches_per_step": bwd_launches / steps,
           "ema_max_abs_gap": ema_gap, "f32_parity": parity,
           "assembly_max_abs_err": assembly_err,
           "metrics": {k: out[k] for k in TRAIN_METRICS}}

    # (c) pass 2 (4x along x, D factors (2, 1)), bf16: 4 steps through
    # Trainer.fit, the first with R1
    tr2 = loop.Trainer(cfg, tc, device=dev, pass_no=2)
    wk.launches = wk.bwd_launches = 0                  # path starts
    out2 = tr2.fit(4, log_every=4)
    torch.cuda.synchronize()
    launches2 = (wk.launches, wk.bwd_launches)         # path ends
    assert launches2 == (3 * 4, 4), launches2
    assert all(np.isfinite(out2[k]) for k in TRAIN_METRICS), out2
    res["pass2"] = {"steps": 4, "warp_launches": launches2[0],
                    "warp_bwd_launches": launches2[1],
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

    warp_err, times = phase_warp(dev, wk)
    single_launches, single_err = phase_single_path(dev, wk)
    bundled_lr, quality = phase_bundled(dev)
    bench = phase_bench(dev)
    phase_serve(dev, bundled_lr)
    align_launches, align_err = phase_align(dev, wk)
    train = phase_train(dev, wk)

    # launches: each kernel's count on the path that runs it, the train
    # step (7b) for the triplet kernels, advect_2d_fast (2b) for the
    # single-field ones
    paths = {
        "warp2d": ("2b advect_2d_fast", single_launches[0], single_err),
        "warp2d_bwd": ("2b advect_2d_fast", single_launches[1], single_err),
        "warp2d_triplet": ("7b train step", train["warp_launches"],
                           align_err),
        "warp2d_triplet_bwd": ("7b train step", train["warp_bwd_launches"],
                               0.0),
    }
    kernels = []
    for name, (replaces, _, _) in WARP_KERNELS.items():
        path, launches, path_err = paths[name]
        small, large = times[name]
        entry = {"name": name, "route": "cuda",
                 "source": "mpgan_torch/csrc/warp.cu", "replaces": replaces,
                 "launches": launches, "path": path,
                 "max_abs_err": max(warp_err[name], path_err)}
        entry.update(small)
        entry["large"] = large
        kernels.append(entry)
    kernels[0]["build_s"] = build_s
    kernels[2].update(launches_per_train_step=train["warp_launches_per_step"],
                      launches_align=align_launches,
                      launches_pass2=train["pass2"]["warp_launches"])
    kernels[3].update(
        launches_per_train_step=train["warp_bwd_launches_per_step"],
        launches_pass2=train["pass2"]["warp_bwd_launches"])
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
