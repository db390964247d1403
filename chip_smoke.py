#!/usr/bin/env python3
"""Drive the PyTorch port (mpgan_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a traceback and a non-zero
exit, and no result line:

1. build    nvcc builds every kernel of the port from csrc/ (in parallel)
2. warp     every warp kernel vs its plain version on the card, at B=16
            64² (the trainer's shape: 16x32 backward tiles, 128 blocks)
            and B=256 256² (64x64 tiles for one field, 32x64 for a
            triplet), velocity scales 1.5, 12 (beyond the ±8 clamp) and
            0: the single-field and the triplet forward (max |Δ| ≤ 1e-5);
            the gradients of every input through advect_2d_fast and
            align_triplet_fast, the field gradients as the train step asks
            for them and the velocity gradient alone (1e-4); each backward
            called 5 times with both gradients asked for, bit for bit
            equal; a clamp of 40 cells at B=4 256² (windows staged in
            chunks), 1e-4 and bit for bit; g scaled by 1e-20 and 1e+20 and
            g all zero (the fixed-point exponent's ends) through both
            backwards, 5 calls bit for bit equal and within 1e-4 times the
            scale of the plain version; each kernel's time against its
            plain version, a library call (grid_sample,
            grid_sampler_2d_backward) and its bound; each kernel's ms per
            call is the median of 5 windows, with their min and max,
            beside the host µs per call of its wrapper (perf_counter over
            1000 back-to-back calls, one synchronise)
2b single  advect_2d_fast forward and backward at B=16 64², the launch
            counts reset just before and read just after: 1 and 1
3. bundled  the exported 4x L1 pair on sim_1010c frame 12 (32³→128³): f32
            with TF32 off equals the port's CPU output (atol 1e-4); bf16
            keeps PSNR ≥ 34.5 dB against the ground truth
3b demo     python -m mpgan_torch.demo in all four modes (l1, gan, 8x,
            8x3) in process through main([mode]) in a temporary
            directory, the shipped bf16 run: PSNR/SSIM and trilinear
            printed, the written strip PNG decoded and equal to the
            strip; each mode again in float32 (TF32 off) through
            demo.upscale_frame, held to its gate's floors in
            mpgan_torch.quality.GATES (8x3 to psnr3/ssim3 over 8x's
            two-pass values); the bf16 − float32 gap, and after phase 9
            each way's gap to phase 9's values for the same chain
4. bench    the main path at the bench shape: 4x, 64³→256³, bf16, base 32,
            2 res blocks, 2 stages, bundled weights; voxels/s; then at
            64³ and at 32³→128³ eager upscale_volume against the graphed
            upscaler (make_graphed_upscaler, its program captured) in
            turns (eager, graphed, graphed, eager) of 5 windows of 4
            frames between CUDA events: median ms per frame, voxels/s,
            peak allocated bytes, the graph pool's bytes, and each way's
            profile (mpgan_torch.profiling.infer_profile: busy share, host
            launches per frame); 64³ and 32³ frames interleaved through
            one graphed upscaler, bf16 and float32 (TF32 off) under cuDNN's
            deterministic mode, each returned frame equal to an eager
            upscale_volume bit for bit, read after all calls; with several
            cards visible the same frames through one graphed upscaler
            over every card (each card's share of each pass a program
            captured on it), equal to an eager upscale_volume over the
            same cards bit for bit (on one card a line says it needs
            several)
5. serve    InferenceServer on a temporary socket under cuDNN's
            deterministic mode, both shapes warmed, 10 requests of 32³ (the
            bundled frame and four random ones) and 64³ (five random)
            interleaved, in turns (eager, graphed, graphed, eager) with an
            eager upscaler and with serve.make_upscaler (graphed on one
            card): every response equals a direct eager upscale_volume bit
            for bit; median request ms per shape and way; a request's copy
            into a static device input from its pageable array and through
            a pinned staging buffer (host ms, synchronised)
6. align    the trainer's fake- and real-triplet alignment (G1 in f32 on
            sim_3020 frames 29/30/31, B=16 tiles of 16²) through the
            triplet kernel, equal to the plain version (1e-5); the launch
            counts are reset just before this path and read just after:
            2 forward, no backward
7. train    the flagship training recipe (pass 1, 4x, G base 32 with 2 res
            blocks, D base 32, B=16, LR tile 16, temporal D, hinge, lazy
            R1 γ=10 every 16 steps, TTUR, EMA 0.999; Trainer.fit holds
            cuDNN's deterministic mode) on a synthetic
            2 sims × 4 frames 32³→128³ dataset, through Trainer.fit:
            (a) one batch of draws assembled by the card's and the CPU's
            tile creator (max |Δ| ≤ 1e-6); float32 steps (TF32 off,
            lrgan = adamEps = 1) from the same seeded weights on that
            batch, on the card and on the CPU: losses within rtol 1e-3;
            the updated G, Ds, Dt and EMA parameters within atol 1e-4 at
            step 1 (R1 skipped, lrdisc 1) and step 0 (R1 applied, lrdisc
            1e-2), Ds and Dt at step 0 with lrdisc 1; the CPU step without
            oneDNN is reported beside each as the spread of float32
            summation order; (b) bf16, stepping eagerly and replaying
            CUDA graphs (mpgan_torch.train.graphed), each also with fit's
            cuDNN deterministic mode patched out: each trainer warmed
            up for 33 steps (every program run twice: two R1 steps), then
            timed in turns (eager, graphed, eager and graphed without the
            mode, then in reverse) of 3 windows of 32 steps (each with
            two R1 steps) between CUDA events (the mode's cost: the
            ratio of the medians), then
            8 steps of each under the profiler
            (mpgan_torch.profiling.train_profile: device busy share, host
            launches per step, warp kernels per step by name), which must
            show 3 triplet forward and 1 triplet backward warp kernels per
            step in both ways; each way's median ms per step, peak
            allocated bytes and the graphs' pool bytes; the launch counts
            reset just before and read just after (a replay adds the
            launches its graph captured): 3 forward and 1 backward per
            step; finite metrics, EMA ≠ G; (c) pass 2 (D factors (2, 1)),
            bf16: 4 steps, 3 forward and 1 backward warp launches per
            step, finite metrics
8. cli      the reference-style CLI, mpgan_torch.cli.main, in process on a
            temporary directory: (a) a smooth synthetic .uni dataset of 2
            sims × 4 frames, 32³ LR (density + velocity) → 128³ HR, and the
            bundled 4x L1 pair copied in as the gen-only runs test_0000
            (G1) and test_0001 (G2); (b) pass 1 through `out 0` at the
            flagship recipe (bf16), 8 iterations with saveInterval 4
            (model_0001, final model_0002), then `resumeIndex` on it takes
            the budget-complete fast path; the checkpoint restores on the
            CPU bit for bit and a CPU save restores on the card (host
            time of one save and one restore reported); the recipe in
            float32 (TF32 off, lrgan = adamEps = 1, lrdisc 1e-2), 4
            iterations with saveInterval 2, and two resumes of its
            model_0001 to iteration 4 agree to atol 1e-4; (c) pass 3
            through `out 0` (trainPass 3 pass3Source model: precompute_finals
            over the 8 volumes with the bundled chain), 4 iterations with
            3 forward and 1 backward warp launch each (counts reset just
            before, read just after), finite metrics; then its checkpoint
            restored into an eager and a graphed Trainer, timed and
            profiled as 7b does (the times reported, not held to
            anything; the warp kernels per step held); (d)
            `out 1` with 3 passes on two frames: 128³ volumes equal to a
            direct upscale_volume of the same chain; that chain's frame
            timed with and without pass 3 (10 frames, CUDA events)
9. quality  every gate of tests/test_quality.py with the port on the card
            (mpgan_torch.quality: the same bundled frames, all 22 exported
            bundles, float32 with TF32 off): each PSNR/SSIM/tdiff value
            printed beside its floor and held to it; then `python -m
            mpgan_torch.eval` in process (main([...])) over the canonical
            4x pair's bundled frame from a temporary run dir laid out from
            the exported .npz: its PSNR/SSIM equal the gate's
10. stream  upscale_volume_streamed against upscale_volume on the bundled
            4x L1 pair at full width, 128³ → 512³, sliceChunk 32, in bf16
            (max |Δ| ≤ 2^-7, one bf16 unit in the last place of a density
            in [1, 2): the two paths hand G2 slices of different memory
            layouts, and cuDNN rounds them differently) and in float32
            with TF32 off (1e-4); each path's ms per frame and peak device
            memory (reset between them); then a 1024³ bf16 streamed frame
11. recover fault recovery of the flagship recipe with the warp kernels:
            (a) in process, float32 (TF32 off, ganLoss sce, adamEps 1,
            where the card reproduces an uninterrupted run within
            atol 1e-4): `out 0` with
            MPGAN_FAIL_ONCE raises after its first checkpoint, a
            `resumeLatest 1` rerun finishes it, 3 forward and 1 backward
            warp launch per step across both (counts reset just before,
            read just after), and the final state equals an uninterrupted
            run's (atol 1e-4; the gap between two uninterrupted runs is
            reported beside it); (b) as a user runs it: `python -m
            mpgan_torch.cli out 0 ... retryOnError 1` with MPGAN_FAIL_ONCE,
            then with `hangTimeout 5` and MPGAN_HANG_ONCE; each exits 0 with
            its final checkpoint in the run dir it owned
11c repro   8b's float32 setting (hinge, lrgan 1, lrdisc 1e-2, TF32 off),
            4 steps, 3 pairs of runs in each of eight ways. Four with the
            generator's upsample backward as F.interpolate's own
            (atomics; the port's earlier backward): as it was; with the
            triplet backward kernel swapped for its plain version (the
            autograd of align_triplet_ref under deterministic
            algorithms); with cudnn.deterministic on and
            cudnn.benchmark off; with both.
            Four with the port's fixed-order upsample backward: alone,
            with the other two swaps (all_three), with cuDNN's
            deterministic mode and the triplet backward kernel
            (kernel_bwd_deterministic: its fixed-point sums), and as a
            user runs the trainer, no flag set (trainer_default: the mode
            Trainer.fit holds); the ways without the mode patch fit's
            mode out; all step eagerly. Prints each way's largest and
            median parameter gap between the runs of a pair; asserts
            kernel_bwd_deterministic's and trainer_default's are 0 in
            every pair, reports the others and one bf16 pair of
            trainer_default. Then, the gated way
            replaying CUDA graphs against stepping eagerly through
            Trainer.fit: 32 steps (R1 at steps 0 and 16) and a useGrowing
            stretch of 24 (stage 2 fading over 8 steps, R1 at 16), every
            tensor of the state and the last metrics equal bit for bit,
            the programs captured and replayed as the rule says
12 datagen  the data path on the card: (a) one solver step at 64³ with a
            sphere obstacle and MacCormack, Jacobi and CG, on the card and
            on the CPU from the same inputs (Jacobi 1e-5: no reduction, only
            single-op rounding differs; CG 1e-4: its dot products sum in
            another order), with the mean |divergence| over fluid cells
            after the projection; (b) `python -m mpgan_torch.datagen` at
            its defaults (resHigh 128, upRes 4, warmup 8), 6 frames per sim:
            two plume sims (the second with an obstacle) in a child
            process, then in process a varied sim with CG, a moving sim and
            a dataDim 2 sim at 256²; per sim its seconds, steps/s and the
            split of a frame between device time (CUDA events) and host
            fetch + gzip write; one 256³ Jacobi and one CG step with peak
            device memory; (c) the native .uni codec built; the loader on
            the four 3D sims with it and with the pure-Python codec, equal
            arrays, both timed; `out 0` for 4 pass-1 steps of the flagship
            recipe on them: 3 forward and 1 backward warp launch per step
            (counts reset just before, read just after); every sim of (b)
            ran its frames as CUDA graphs (the card's default)
12d graphs  the solver's step and the datagen frame graphed (GraphedStep,
            datagen.scene_frames) against eager: a step of the plume scene
            at 64³ and 128³ with its obstacle and at 256³ without, each
            with Jacobi and with CG; the moving scene's frame at 128³
            (noise, the obstacle's mask built in the program from its
            centre, the step); a 2D Jacobi step at 256²; per case 3 steps
            from one state equal bit for bit (eager, captured, replayed),
            then turns (eager, graphed, graphed, eager; 2 rounds) of one
            window each between CUDA events: median ms per step, host
            launches per step and busy share over 2 steps
            (profiling.solver_profile), the graph's pool bytes, beside the
            card's name and power limit; then one 6-frame sim per scene
            family at datagen's defaults (128³, upRes 4, warmup 8; plume
            with its obstacle, varied, varied-dual with CG, moving, and
            2D at 256²; the HR velocity not written) graphed and eager
            with the clock stopped: every file byte for byte equal, and
            each way's frame split printed
13 parallel data-parallel training and parallel inference, float32 at
            11a's setting for training (ganLoss sce, adamEps 1, TF32 off):
            (a) `out 0` with `coordinator 127.0.0.1:<free port>
            numProcesses 1 processId 0`, 4 steps through NCCL at world
            size 1, replaying CUDA graphs (one capture, in the NCCL
            group), equal to the same run without the flags (1e-4), 3
            forward and 1 backward warp launch per step; (b) two ranks
            sharing the card over gloo (spawned processes), the flagship
            recipe at global B=16, 4 steps: with replicated residency
            each rank's state equals a one-process B=16 run's (1e-4, and
            within 1e-2 of how far that run moved from the initial
            state; the gap between two one-process runs printed beside
            it), and a planted fault (the gradients summed over the
            ranks, not averaged) exceeds that relative limit; with
            sharded residency (one sim per rank) the ranks' states are
            bitwise equal and each rank holds half of the volume stacks;
            each rank launches 3 forward and 1 backward warp kernels per
            step (counts reset just before, read just after); with more
            than one card visible the same over NCCL on two cards; (c)
            dryrun_multichip(2, share_cards) with both ranks on the
            card over gloo; (d) at the
            bench shape (4x, 64³→256³, bundled g1_l1_4x/g2_l1_4x and
            g3_l1p3_4x): upscale_volume with its slices split over
            [card] * 2 equals the one-device call, and InferencePipeline
            with 2 and 3 stages over [card] * k streams 6 frames, each
            stage replaying its CUDA graph (one capture per stage), under
            cuDNN's deterministic mode, bf16 and f32: every frame, read
            after all are out, equal to an eager pipeline's (built with
            assemble.graphable answering False) bit for bit and to
            upscale_volume's (bf16
            within one unit, 2^-7; f32 within 1e-4); the graphs' pool
            bytes; bf16 ms per frame graphed, eager and sequential, in
            turns (CUDA events), reported; with several cards visible a
            2-stage pipeline over every card at default_split (its pass-2
            stage over distinct cards, each card's share graphed on it),
            bf16 and f32, equal to an eager pipeline over the same cards
            bit for bit (on one card a line says it needs several)
13e nccl    this process as the only rank of an NCCL group: the NCCL
            version; an all-reduce (a sum pre-multiplied by 2, which NCCL
            runs on one rank) captured as the train step's graphs capture
            is not run by the capture, its graph holds NCCL's kernel
            (CUDAGraph.debug_dump) and each of 10 replays runs it, the
            profiler's record of the replays reported (kernels per
            replay);
            7b's recipe (bf16) through an eager and a graphed rank in
            turns as 7b times them (median ms per step, busy share, host
            launches per step, NCCL kernels per step and their device µs
            by name, equal in both ways; the graph pools' bytes), 3
            forward and 1 backward warp launches per step (counts reset
            just before, read just after); in 11c's float32 setting (TF32
            off, cuDNN deterministic; lrgan = adamEps = 1, lrdisc 1e-2) 32
            steps with R1 at 0 and 16: the graphed rank equals the eager
            rank bit for bit, and the single-process graphed trainer
            within 1e-4 (the gap printed)

Then one JSON line listing every kernel (its launches on the path that
runs it, its times at B=16 64², and under "large" at B=256 256²), the
card's name and power limit (nvidia-smi), and last the line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Runs on one card; exits non-zero without CUDA.
"""

import contextlib
import json
import os
import shutil
import socket
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
SPREAD_WINDOWS = 5     # a kernel's ms per call: median, min, max of windows
BF16_UNIT = 2.0 ** -7  # one bf16 unit in the last place of a value in [1, 2)


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


def host_us(fn, iters=1000, warmup=10):
    """Host µs per call of ``fn()``: perf_counter over ``iters``
    back-to-back calls after ``warmup``, with one synchronise at the end."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e6


def repeat_equal(fn, n=5):
    """``fn()`` (a tuple of tensors or None) called ``n`` times gives the
    same bits every time; → the first call's outputs."""
    runs = [fn() for _ in range(n)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        for a, z in zip(run, runs[0]):
            assert (a is None and z is None) or torch.equal(a, z)
    return runs[0]


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
    # the velocity gradient alone (its own instantiation of the kernel)
    _, _, d_vel = wk.align_triplet_kernel_bwd(gy, p, n, v, field_grads=False,
                                              vel_grad=True)
    torch.cuda.synchronize()
    e = gap([d_vel], ref[3:])
    assert e <= 1e-4, ("warp2d_triplet_bwd vel", b, h, w, vscale, e)
    err["warp2d_triplet_bwd"] = max(e, err["warp2d_triplet_bwd"])
    # each backward, both gradients asked for, bit for bit over 5 calls
    for dt in (1.0, -1.0):
        repeat_equal(lambda: wk.advect_2d_kernel_bwd(g1, p, v, dt,
                                                     vel_grad=True))
    repeat_equal(lambda: wk.align_triplet_kernel_bwd(gy, p, n, v,
                                                     vel_grad=True))
    return err


def warp_chunk_check(wk, dev):
    """Both backwards with a clamp of 40 cells at B=4 256²: windows too
    large for one staged chunk, their max read from device memory; within
    1e-4 of the plain version, bit for bit over 5 calls. → max abs error."""
    p, c, n, v, gy = warp_inputs(4, 256, 256, 4.0, 6, dev)
    g1 = gy[..., :1]
    got = repeat_equal(lambda: wk.advect_2d_kernel_bwd(g1, p, v, 1.0, 40))
    ref_in = [p.clone().requires_grad_()]
    ref = torch.autograd.grad(wk.advect_2d_clamped_ref(ref_in[0], v, 1.0, 40),
                              ref_in, g1)
    e1 = gap(got[:1], ref)
    got = repeat_equal(lambda: wk.align_triplet_kernel_bwd(gy, p, n, v, 40))
    ref_in = [t.clone().requires_grad_() for t in (p, n)]
    ref = torch.autograd.grad(
        wk.align_triplet_ref(ref_in[0], c, ref_in[1], v, 40), ref_in, gy)
    e3 = gap(got[:2], ref)
    assert max(e1, e3) <= 1e-4, ("chunked windows", e1, e3)
    return max(e1, e3)


def warp_exponent_checks(wk, b, h, w, dev):
    """Both backwards on g scaled by 1e-20 and 1e+20 and on g all zero, the
    ends of the fixed-point exponent: 5 calls bit for bit equal, and every
    gradient within 1e-4 times the scale of the plain version's (zero: 0).
    → max abs error over the scale, per kernel."""
    p, c, n, v, gy = warp_inputs(b, h, w, 1.5, 5, dev)
    err = {"warp2d_bwd": 0.0, "warp2d_triplet_bwd": 0.0}
    for scale in (1e-20, 1e20, 0.0):
        g3 = gy * scale
        g1 = g3[..., :1]
        got = repeat_equal(lambda: wk.advect_2d_kernel_bwd(
            g1, p, v, -1.0, vel_grad=True))
        ref_in = [t.clone().requires_grad_() for t in (p, v)]
        ref = torch.autograd.grad(
            wk.advect_2d_clamped_ref(*ref_in, -1.0), ref_in, g1)
        e = gap(got, ref)
        assert e <= 1e-4 * scale, ("warp2d_bwd", b, h, w, scale, e)
        err["warp2d_bwd"] = max(err["warp2d_bwd"], e / (scale or 1.0))
        got = repeat_equal(lambda: wk.align_triplet_kernel_bwd(
            g3, p, n, v, vel_grad=True))
        ref_in = [t.clone().requires_grad_() for t in (p, n, v)]
        ref = torch.autograd.grad(
            wk.align_triplet_ref(ref_in[0], c, ref_in[1], ref_in[2]),
            ref_in, g3)
        e = gap(got, ref)
        assert e <= 1e-4 * scale, ("warp2d_triplet_bwd", b, h, w, scale, e)
        err["warp2d_triplet_bwd"] = max(err["warp2d_triplet_bwd"],
                                        e / (scale or 1.0))
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
        windows = sorted(cuda_ms(kern, iters) for _ in range(SPREAD_WINDOWS))
        out[name] = {
            "shape": [b, h, w],
            "ms": windows[SPREAD_WINDOWS // 2],
            "ms_min": windows[0], "ms_max": windows[-1],
            "plain_ms": cuda_ms(plain, iters),
            "library_ms": cuda_ms(lib, iters),
            "bound_ms": max(px * nbytes / HBM_BYTES_PER_S,
                            px * flops / F32_FLOPS) * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / F32_FLOPS else "operations"),
            "library_max_abs_err": lib_err[name],
            "host_us_per_call": host_us(kern),
            "library_host_us_per_call": host_us(lib),
        }
        if lib_fb is not None:  # a backward: its repeat check held
            out[name]["library_fwd_bwd_ms"] = cuda_ms(lib_fb, iters)
            out[name]["deterministic"] = True
    return out


def phase_warp(dev, wk):
    t0 = phase("2 warp kernels vs plain")
    err = {k: 0.0 for k in WARP_KERNELS}
    exp_err = {}
    for b, h, w, _ in WARP_SHAPES:
        for vscale in (1.5, 12.0, 0.0):
            for k, e in warp_checks(wk, b, h, w, vscale, dev).items():
                err[k] = max(err[k], e)
        for k, e in warp_exponent_checks(wk, b, h, w, dev).items():
            exp_err[k] = max(exp_err.get(k, 0.0), e)
    print("   exponent ends, max |Δ| / scale " + json.dumps(exp_err),
          flush=True)
    print(f"   chunked windows (clamp 40) max |Δ| {warp_chunk_check(wk, dev)}",
          flush=True)
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


def phase_demo(dev):
    """3b: ``python -m mpgan_torch.demo`` in all four modes → per mode the
    shipped bf16 run's and the float32 run's PSNR/SSIM and their gap, the
    float32 floors."""
    from mpgan_torch import demo, quality
    from mpgan_torch.utils import preview

    t0 = phase("3b demo: python -m mpgan_torch.demo, four modes, bf16 "
               "through main; float32 (TF32 off) held to the gates' floors")
    keys = ("psnr", "ssim", "psnr_tri", "ssim_tri")
    res = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            for mode in demo.MODES:
                t = time.perf_counter()
                r = demo.main([mode])
                secs = time.perf_counter() - t
                with open(os.path.join(d, demo.PNG), "rb") as fh:
                    png = preview.decode_png(fh.read())
                assert png.shape == r["strip"].shape and np.array_equal(
                    png, r["strip"]), (mode, png.shape)
                assert r["out"].shape == (128, 128, 128, 1) and bool(
                    np.isfinite(r["out"]).all()), mode
                res[mode] = {"bfloat16": {k: r[k] for k in keys},
                             "main_s": secs, "png_shape": list(png.shape)}
        finally:
            os.chdir(cwd)
    with quality.full_f32():
        for mode, m in demo.MODES.items():
            lr, gt = quality.read_frame(m.sim, m.frame)
            r = demo.upscale_frame(mode, lr, gt, dev, "float32")
            res[mode]["float32"] = {k: r[k] for k in keys}
            res[mode]["bfloat16_minus_float32"] = {
                k: res[mode]["bfloat16"][k] - r[k] for k in ("psnr", "ssim")}
    # each mode's float32 values against its gate's floors: the two-pass
    # floors for l1, gan and 8x; psnr3/ssim3 (over 8x's two-pass values)
    # for 8x3
    for mode, m in demo.MODES.items():
        f32 = res[mode]["float32"]
        vals = {"psnr": f32["psnr"], "ssim": f32["ssim"],
                "tri": f32["psnr_tri"], "ssim_tri": f32["ssim_tri"]}
        three = len(m.chain) == 3
        if three:
            two = res["8x"]["float32"]
            vals.update(psnr3=f32["psnr"], ssim3=f32["ssim"],
                        psnr=two["psnr"], ssim=two["ssim"])
        floors = [f for f in quality.GATES[m.gate].floors
                  if (f[0] in ("psnr3", "ssim3")) == three]
        checks = quality.check_floors(floors, vals)
        for c in checks:
            print(f"   demo {mode} float32: {c['check']}: {c['value']:.4f} "
                  f"{'ok' if c['ok'] else 'FAILED'}", flush=True)
        assert checks and all(c["ok"] for c in checks), (mode, checks)
        res[mode]["floors"] = checks
    print("   demo " + json.dumps(res), flush=True)
    done(t0, **{m: "{:.2f}/{:.2f} dB".format(res[m]["bfloat16"]["psnr"],
                                             res[m]["float32"]["psnr"])
                for m in res})
    return res


def demo_gaps(demo_res, quality_res):
    """Each demo mode's bf16 and float32 PSNR/SSIM minus phase 9's float32
    values for the same chain and frame."""
    from mpgan_torch import demo

    out = {}
    for mode, m in demo.MODES.items():
        (rec,) = [r for r in quality_res["gates"][m.gate]
                  if tuple(r["chain"][:len(m.chain)]) == m.chain]
        suffix = "3" if len(m.chain) == 3 else ""
        ref = {"psnr": rec["psnr" + suffix], "ssim": rec["ssim" + suffix]}
        out[mode] = {f"{dt}_minus_phase9_{k}": demo_res[mode][dt][k] - ref[k]
                     for dt in ("bfloat16", "float32") for k in ref}
    return out


def phase_bench(dev):
    from mpgan_torch.infer import assemble

    t0 = phase("4 main path: 4x 64^3 -> 256^3 bf16, base 32, 2 res blocks; "
               "eager against graphed at 64^3 and 32^3")
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
    small = torch.from_numpy(np.random.default_rng(1).random(
        (32, 32, 32, 4), dtype=np.float32)).to(dev)
    for x in (lr, small):
        res[f"{x.shape[0]}^3"] = upscale_turns(g1, g2, x, frames=4,
                                               windows=5)
    res["graphed_bits"] = graphed_frame_bits(dev)
    res["graphed_bits_cards"] = multi_card_frame_bits()
    print("   main path " + json.dumps(res), flush=True)
    done(t0, **{f"{k}_eager_graphed_ms": "{:.3f}/{:.3f}".format(
        res[k]["eager"]["frame_ms"], res[k]["graphed"]["frame_ms"])
        for k in ("64^3", "32^3")})
    return res


def upscale_turns(g1, g2, lr, frames, windows):
    """The two-pass chain on ``lr`` eagerly (``upscale_volume``) and
    through the graphed upscaler (``make_graphed_upscaler``), each warmed
    up (the graphed one's program captured), timed in turns (eager,
    graphed, graphed, eager) of ``windows`` windows of ``frames`` frames
    between CUDA events, then profiled for 5 frames each
    (mpgan_torch.profiling.infer_profile) → per way the median ms per
    frame and the windows, voxels/s, peak allocated bytes over its turns
    (the graph's pool held throughout) and its profile; the graph pool's
    bytes."""
    from mpgan_torch import profiling
    from mpgan_torch.infer import assemble

    torch.cuda.synchronize()
    torch.cuda.empty_cache()        # the pools of released graphs go
    pools = _graph_pool_bytes()
    graphed = assemble.make_graphed_upscaler(g1, g2, 4)

    def eager():
        with torch.inference_mode():
            return assemble.upscale_volume(g1, g2, lr, 4)
    ways = {"eager": eager, "graphed": lambda: graphed(lr)}
    for fn in ways.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    pool_bytes = _graph_pool_bytes() - pools
    ms = {k: [] for k in ways}
    peak = dict.fromkeys(ways, 0)
    for name in ("eager", "graphed", "graphed", "eager"):
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(windows + 1)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events[0].record()
        for w in range(windows):
            for _ in range(frames):
                ways[name]()
            events[w + 1].record()
        torch.cuda.synchronize()
        peak[name] = max(peak[name], torch.cuda.max_memory_allocated())
        ms[name] += [events[w].elapsed_time(events[w + 1]) / frames
                     for w in range(windows)]
    voxels = (4 * lr.shape[0]) ** 3
    res = {"graph_pool_bytes": pool_bytes}
    for name, fn in ways.items():
        med = sorted(ms[name])[len(ms[name]) // 2]
        res[name] = {"frame_ms": med, "frame_ms_windows": ms[name],
                     "voxels_per_s": voxels / (med / 1e3),
                     "peak_mem_bytes": peak[name],
                     "profile": profiling.infer_profile(fn, 5)}
    graphed.programs.popitem()[1].release()
    return res


def graphed_frame_bits(dev):
    """Frames of 64³ and 32³ interleaved (3 each) through one graphed
    upscaler, bf16 and float32 (TF32 off), under cuDNN's deterministic
    mode: each returned frame, read after all calls, equals an eager
    ``upscale_volume`` of its input bit for bit → frames compared per
    dtype."""
    from mpgan_torch.infer import assemble

    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32)
    res = {}
    try:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = (True,
                                                                  False,
                                                                  False)
        for dtype in ("bfloat16", "float32"):
            _, g1, g2 = load_chain(dtype, dev)
            graphed = assemble.make_graphed_upscaler(g1, g2, 4)
            frames = [torch.from_numpy(np.random.default_rng(10 + i).random(
                (n, n, n, 4), dtype=np.float32)).to(dev)
                for i in range(3) for n in (64, 32)]
            got = [graphed(f) for f in frames]
            assert all(p.captured for p in graphed.programs.values())
            with torch.inference_mode():
                for f, g in zip(frames, got):
                    assert torch.equal(g, assemble.upscale_volume(
                        g1, g2, f, 4)), (dtype, f.shape)
            res[dtype] = {"frames_equal": len(frames)}
            for p in graphed.programs.values():
                p.release()
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = flags
    return res


MULTI_CARD_SIZES = (64, 32)     # phase 4's multi-card frames, interleaved


def _cards_turns(g1, g2, graphed, cards, frames):
    """64³ frames through ``graphed`` (over ``cards``), an eager
    upscale_volume over the same cards and the one-card graphed upscaler,
    in turns (in order, then in reverse; 2 rounds; CUDA events on the
    first card, whose gather waits for every card) → per way the median
    ms per frame and every turn's."""
    from mpgan_torch.infer import assemble

    one = assemble.make_graphed_upscaler(g1, g2, 4)

    def eager():
        with torch.inference_mode():
            return [assemble.upscale_volume(g1, g2, f, 4, devices=cards)
                    for f in frames]
    ways = {"cards_graphed": lambda: [graphed(f) for f in frames],
            "cards_eager": eager,
            "one_card_graphed": lambda: [one(f) for f in frames]}
    for fn in ways.values():
        fn()
        fn()
    res = {name: {"median": med, "turns": all_ms} for name, (med, all_ms)
           in _pipeline_turns(ways, frames, turns=2).items()}
    one.programs.popitem()[1].release()
    return res


def multi_card_frame_bits():
    """Phase 4 over every visible card where there are several: frames of
    64³ and 32³ interleaved (3 each) through make_graphed_upscaler over
    the cards (each card's share of each pass its own program, captured
    on it), bf16 and float32 (TF32 off), under cuDNN's deterministic mode:
    each returned frame, read after all calls, equals an eager
    ``upscale_volume`` over the same cards bit for bit → frames compared
    per dtype and the cards, and bf16 64³ ms per frame graphed over the
    cards, eager over them and graphed on one card, in turns; None on
    one card."""
    from mpgan_torch.infer import assemble
    from mpgan_torch.parallel import mesh as pmesh

    if torch.cuda.device_count() < 2:
        print("   4 multi-card: graphed shares over distinct cards need "
              "several cards; 1 visible, not run", flush=True)
        return None
    cards = pmesh.make_mesh()
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32)
    res = {"cards": len(cards)}
    try:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = (True,
                                                                  False,
                                                                  False)
        for dtype in ("bfloat16", "float32"):
            _, g1, g2 = load_chain(dtype, cards[0])
            graphed = assemble.make_graphed_upscaler(g1, g2, 4,
                                                     devices=cards)
            frames = [torch.from_numpy(np.random.default_rng(20 + i).random(
                (n, n, n, 4), dtype=np.float32)).to(cards[0])
                for i in range(3) for n in MULTI_CARD_SIZES]
            got = [graphed(f) for f in frames]
            programs = [q for p in graphed.programs.values()
                        for q in p.programs.values()]
            assert programs and all(q.captured for q in programs)
            assert {q.device for q in programs} == set(cards)
            with torch.inference_mode():
                for f, g in zip(frames, got):
                    assert torch.equal(g, assemble.upscale_volume(
                        g1, g2, f, 4, devices=cards)), (dtype, f.shape)
            res[dtype] = {"frames_equal": len(frames),
                          "programs": len(programs)}
            if dtype == "bfloat16":
                res[dtype]["ms_per_frame"] = _cards_turns(
                    g1, g2, graphed, cards, frames[::2])
            for p in graphed.programs.values():
                p.release()
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = flags
    print("   4 multi-card " + json.dumps(res), flush=True)
    return res


def _serve_turn(upscale, requests, warm_shapes):
    """An InferenceServer over ``upscale`` on a temporary socket, each of
    ``warm_shapes`` warmed, then ``requests`` sent in order by one client
    → (the responses, each request's seconds on the client's clock)."""
    from mpgan_torch import serve

    with tempfile.TemporaryDirectory() as d:
        sock = os.path.join(d, "mpgan.sock")
        server = serve.InferenceServer(upscale, sock, expect_channels=4)
        for shape in warm_shapes:
            server.warm(shape)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        out, secs = [], []
        try:
            with serve.Client(sock, timeout=300) as c:
                for lr in requests:
                    t = time.perf_counter()
                    out.append(c.upscale(lr))
                    secs.append(time.perf_counter() - t)
                c.shutdown_server()
        finally:
            th.join(timeout=60)
        assert not th.is_alive(), "server thread did not stop"
    return out, secs


def phase_serve(dev, bundled_lr):
    from mpgan_torch import serve
    from mpgan_torch.infer import assemble

    t0 = phase("5 serving: InferenceServer + Client, 32^3 and 64^3 requests "
               "interleaved, the graphed upscaler against the eager one")
    from mpgan_torch.train import graphed as graphed_mod

    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    captures = []
    graph_init = graphed_mod.Graph.__init__

    def counted(self, fn, device, generator=None):
        graph_init(self, fn, device, generator)
        captures.append(fn)
    try:
        graphed_mod.Graph.__init__ = counted
        _, g1, g2 = load_chain("bfloat16", dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()    # the pools of released graphs go
        pools = _graph_pool_bytes()
        graphed = serve.make_upscaler((g1, g2, None), dev, up_res=4)

        def eager(lr):
            with torch.inference_mode():
                return assemble.upscale_volume(
                    g1, g2, torch.tensor(lr, device=dev), 4)
        rng = np.random.default_rng(1)
        small = [bundled_lr] + [rng.random(bundled_lr.shape,
                                           dtype=np.float32)
                                for _ in range(4)]
        large = [rng.random((64, 64, 64, 4), dtype=np.float32)
                 for _ in range(5)]
        requests = [v for pair in zip(small, large) for v in pair]
        direct = [serve._to_host(eager(lr)) for lr in requests]
        warm = [(32, 32, 32, 4), (64, 64, 64, 4)]
        secs = {"eager": [], "graphed": []}
        for name in ("eager", "graphed", "graphed", "eager"):
            out, s = _serve_turn(graphed if name == "graphed" else eager,
                                 requests, warm)
            for hr, want in zip(out, direct):
                assert hr.shape == want.shape and np.array_equal(hr, want)
            secs[name] += s
        torch.cuda.synchronize()
        pool_bytes = _graph_pool_bytes() - pools
        # the graphed upscaler captured both shapes while warming up, and
        # only then
        assert len(captures) == 2, len(captures)
        res = {"requests_per_turn": len(requests), "graph_pool_bytes":
               pool_bytes, "staging": _staging_ms(large[0], dev)}
        for name, s in secs.items():
            for shape, lat in (("32^3", s[0::2]), ("64^3", s[1::2])):
                res[f"{name}_{shape}_request_ms"] = sorted(lat)[
                    len(lat) // 2] * 1e3
                res[f"{name}_{shape}_request_ms_all"] = [v * 1e3 for v in lat]
    finally:
        graphed_mod.Graph.__init__ = graph_init
        cudnn.deterministic, cudnn.benchmark = flags
    print("   serve " + json.dumps(res), flush=True)
    done(t0, **{k: f"{v:.2f}" for k, v in res.items()
                if k.endswith("request_ms")})
    return res


def _staging_ms(lr, dev):
    """A request's copy into a static device input, host ms per copy
    (synchronised): straight from its pageable array, and through a
    pinned staging buffer (a host copy, then an asynchronous one)."""
    static = torch.empty(lr.shape, device=dev)
    pinned = torch.empty(lr.shape, pin_memory=True)
    src = torch.from_numpy(lr)

    def pageable():
        static.copy_(src)
        torch.cuda.synchronize()

    def staged():
        pinned.copy_(src)
        static.copy_(pinned, non_blocking=True)
        torch.cuda.synchronize()
    res = {"bytes": lr.nbytes}
    for name, fn in (("pageable", pageable), ("pinned_staging", staged),
                     ("pinned_staging", staged), ("pageable", pageable)):
        res.setdefault(f"{name}_ms", []).append(host_us(fn, iters=50) / 1e3)
    assert torch.equal(static.cpu(), src)
    return res


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

    # (b) bf16 steps through Trainer.fit, stepping eagerly and replaying
    # CUDA graphs in turns, 3 windows of 32 steps a turn (each window with
    # two R1 steps)
    cfg = recipe.flagship_config("bfloat16")
    wk.launches = wk.bwd_launches = 0                  # path starts
    turns = train_turns(cfg, lambda graphs: loop.Trainer(
        cfg, tc, device=dev, graphs=graphs), n=32, windows=3,
        cudnn_off=True)
    launches, bwd_launches = wk.launches, wk.bwd_launches  # path ends
    steps = turns.pop("steps")
    assert (launches, bwd_launches) == (3 * steps, steps), (launches,
                                                            bwd_launches)
    rt = turns.pop("trainers")["graphed"].rt
    ema_gap = max(float((rt.ema[k] - p.detach()).abs().max())
                  for k, p in rt.gen.named_parameters())
    assert ema_gap > 0, ema_gap
    med = turns["graphed"]["ms_per_step"]
    res = {"ms_per_step": med, "steps_per_s": 1e3 / med,
           "samples_per_s": 16e3 / med, **turns, "steps": steps,
           "warp_launches": launches, "warp_bwd_launches": bwd_launches,
           "warp_launches_per_step": launches / steps,
           "warp_bwd_launches_per_step": bwd_launches / steps,
           "ema_max_abs_gap": ema_gap, "f32_parity": parity,
           "assembly_max_abs_err": assembly_err}

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


def _graph_pool_bytes():
    """Bytes of the device memory segments that CUDA graphs' private
    pools hold."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


@contextlib.contextmanager
def cudnn_mode_off():
    """Trainer.fit without its cuDNN deterministic mode: the caller's
    flags stay as they are for the block."""
    from mpgan_torch.train import loop

    held = loop.deterministic_cudnn
    loop.deterministic_cudnn = contextlib.nullcontext
    try:
        yield
    finally:
        loop.deterministic_cudnn = held


def train_turns(cfg, make, n, windows, cudnn_off=False):
    """An eager and a graphed trainer (``make(graphs)``), with
    ``cudnn_off`` also an eager and a graphed one whose ``fit`` runs
    without cuDNN's deterministic mode (:func:`cudnn_mode_off`), each
    warmed up until every program has run twice (two lazy R1 steps and one
    more), timed in turns (the ways in order, then in reverse) of
    ``windows`` windows of ``n`` steps between CUDA events, then the
    default two profiled for 8 steps each
    (mpgan_torch.profiling.train_profile), which must show 3 triplet
    forward and 1 triplet backward warp kernels per step. → per way the
    median ms per step and the windows, the last metrics, peak allocated
    bytes over its turns (and the profile split), and the graphs' pool
    bytes; with the trainers by way and the steps all took in all."""
    from mpgan_torch import profiling

    ways = {"eager": (False, True), "graphed": (True, True)}
    if cudnn_off:
        ways.update(eager_cudnn_off=(False, False),
                    graphed_cudnn_off=(True, False))
    trainers, its, start, out = {}, {}, {}, {}
    ms = {w: [] for w in ways}
    peak = dict.fromkeys(ways, 0)
    warm = 2 * max(cfg.loss.r1_interval, 1) + 1

    def fit(way, steps):
        mode = (contextlib.nullcontext() if ways[way][1]
                else cudnn_mode_off())
        with mode:
            out[way] = trainers[way].fit(its[way] + steps,
                                         start_it=its[way], log_every=steps)
        its[way] += steps

    for way, (graphs, _) in ways.items():
        tr = trainers[way] = make(graphs)
        assert tr.graphs == graphs
        its[way] = start[way] = tr.runtime().step
        fit(way, warm)
    torch.cuda.synchronize()
    pool_bytes = _graph_pool_bytes()
    for way in list(ways) + list(reversed(ways)):
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(windows + 1)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events[0].record()
        for w in range(windows):
            fit(way, n)
            events[w + 1].record()
        torch.cuda.synchronize()
        peak[way] = max(peak[way], torch.cuda.max_memory_allocated())
        ms[way] += [events[w].elapsed_time(events[w + 1]) / n
                    for w in range(windows)]
    res = {"trainers": trainers, "graph_pool_bytes": pool_bytes}
    for way in ways:
        assert all(np.isfinite(out[way][k]) for k in TRAIN_METRICS), out
        res[way] = {"ms_per_step": sorted(ms[way])[len(ms[way]) // 2],
                    "ms_per_step_windows": ms[way],
                    "peak_mem_bytes": peak[way],
                    "metrics": {k: out[way][k] for k in TRAIN_METRICS}}
    for way in ("eager", "graphed"):
        prof, _ = profiling.train_profile(trainers[way], its[way], 8)
        its[way] += 8
        assert trainers[way].rt.step == its[way]
        warp = prof["warp_kernels_per_step"]
        assert warp == {"warp2d_triplet": 3.0, "warp2d_triplet_bwd": 1.0}, (
            way, warp)
        res[way]["profile"] = {k: prof[k] for k in (
            "wall_ms_per_step", "kernel_ms_per_step",
            "device_busy_share", "host_launches_per_step",
            "host_launches_by_call", "device_activities_per_step",
            "warp_kernels_per_step", "warp_kernel_device_ms_by_name",
            "nccl_kernels_per_step",
            "nccl_kernel_device_us_per_step_by_name")}
    if cudnn_off:
        res["cudnn_mode_cost"] = {
            w: res[w]["ms_per_step"] / res[f"{w}_cudnn_off"]["ms_per_step"]
            for w in ("eager", "graphed")}
    res["steps"] = sum(its[w] - start[w] for w in its)
    return res


CLI_RECIPE = ("upRes 4 tileSizeLow 16 batchSize 16 densityThreshold 0 "
              "useTempoD 1 ganLoss hinge r1Gamma 10 r1Interval 16 "
              "lrdisc 0.0004 emaDecay 0.999 randSeed 0")


def smooth_dataset(base, n_sims=2, n_frames=4, size=32, up=4, seed=0):
    """Smooth density and velocity fields (sums of drifting sinusoids made
    with numpy from ``seed``) written as .uni: HR density at size·up, LR
    density as its 4³ block mean, LR velocity in LR cells per frame."""
    from mpgan_torch.data import loader
    from mpgan_torch.io import uni

    rng = np.random.default_rng(seed)
    n = size * up
    r = np.stack(np.meshgrid(*(np.arange(n, dtype=np.float32) * (2 * np.pi
                                                                 / n),) * 3,
                             indexing="ij"))                  # (3, n, n, n)
    r_lr = r[:, up // 2::up, up // 2::up, up // 2::up]
    for sim in range(n_sims):
        d = os.path.join(base, f"sim_{1000 + sim:04d}")
        os.makedirs(d)
        k = rng.integers(1, 4, (4, 3)).astype(np.float32)
        phi, drift = rng.random(4) * 6.28, rng.random(4) * 0.3
        kv = rng.integers(1, 3, (3, 3)).astype(np.float32)
        for f in range(n_frames):
            arg = np.tensordot(k, r, 1) + (phi + drift * f)[:, None, None,
                                                            None]
            hr = np.clip(0.5 + 0.15 * np.sin(arg).sum(0), 0, 1)
            lr = hr.reshape(size, up, size, up, size, up).mean((1, 3, 5))
            vel = 0.5 * np.sin(np.tensordot(kv, r_lr, 1) + 0.1 * f)
            uni.write_density(os.path.join(d, loader.HIGH_DENSITY % f),
                              hr.astype(np.float32))
            uni.write_density(os.path.join(d, loader.LOW_DENSITY % f),
                              lr.astype(np.float32))
            uni.write_velocity(os.path.join(d, loader.LOW_VELOCITY % f),
                               np.moveaxis(vel, 0, -1).astype(np.float32))


def _state_tensors(state):
    """Every tensor of a train state (``Trainer.state()`` or a restored
    checkpoint) on the host, by path."""
    out = {}

    def walk(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{prefix}/{i}", v)
        elif torch.is_tensor(x):
            out[prefix] = x.detach().to("cpu")
    walk("", state)
    return out


def _last_metrics(run):
    """The last row of a run dir's metrics.jsonl."""
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return json.loads(f.read().splitlines()[-1])


def _state_gap(a, b):
    assert set(a) == set(b), set(a) ^ set(b)
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def phase_cli(dev, wk):
    from mpgan_torch import cli
    from mpgan_torch import config as cfgmod
    from mpgan_torch.data.loader import FluidDataLoader
    from mpgan_torch.data.pipeline import TileCreator
    from mpgan_torch.infer import assemble, load
    from mpgan_torch.io import uni
    from mpgan_torch.train import checkpoint as ckpt
    from mpgan_torch.train import loop

    t0 = phase("8 CLI: out 0 pass 1 (save, resume), out 0 pass 3, out 1 "
               "with 3 passes")
    res = {}
    with tempfile.TemporaryDirectory() as d:
        # (a) data and the bundled pair as gen-only runs
        t = time.perf_counter()
        smooth_dataset(os.path.join(d, "data"))
        runs = os.path.join(d, "runs")
        _gen_only_runs(runs, ("g1_l1_4x", "g2_l1_4x"))
        res["data_s"] = time.perf_counter() - t
        data = (f"basePath {d}/data/ fromSim 1000 toSim 1001 frameMax 4 "
                f"testPath {runs}/ ")

        def run_cli(args, sims=data):
            t = time.perf_counter()
            cli.main((sims + args).split())
            torch.cuda.synchronize()
            return time.perf_counter() - t

        # (b) pass 1, bf16, flagship: test_0002
        res["pass1_bf16_s"] = run_cli(
            f"out 0 {CLI_RECIPE} trainingIters 8 saveInterval 4 "
            "outputInterval 8")
        run1 = ckpt.run_dir(runs, 2)
        assert {ckpt.latest_model_no(run1), ckpt.latest_gen_no(run1)} == {2}
        meta = ckpt.read_json(ckpt.model_dir(run1, 2) + ".json")
        assert meta == {"it": 8, "stage": 2, "pass_no": 1, "up_res": 4,
                        "total_iters": 8}, meta
        assert os.path.isdir(ckpt.gen_dir(run1, 1, "gen_ema"))
        last = _last_metrics(run1)
        assert all(np.isfinite(last[k]) for k in TRAIN_METRICS), last
        before = sorted(os.listdir(run1))
        res["resume_index_fast_path_s"] = run_cli(
            f"out 0 {CLI_RECIPE} trainingIters 8 resumeIndex 2")
        assert sorted(os.listdir(run1)) == before
        assert ckpt.latest_run_idx(runs) == 2

        # the card's checkpoint on the CPU and a CPU save on the card
        cfg = cfgmod.from_cli((data + CLI_RECIPE).split())
        ds = FluidDataLoader(f"{d}/data/", 1000, 1001, 0, 4).get()
        tr = loop.Trainer(cfg, TileCreator(ds, 16, 0.0, device=dev), dev)
        t = time.perf_counter()
        it = tr.restore(run1, 1)
        torch.cuda.synchronize()
        res["restore_s"] = time.perf_counter() - t
        assert it == 4 and tr.rt.step == 4
        t = time.perf_counter()
        tr.save(os.path.join(d, "card_save"), 0, it)
        torch.cuda.synchronize()
        res["save_s"] = time.perf_counter() - t
        res["state_bytes"] = os.path.getsize(os.path.join(
            ckpt.model_dir(os.path.join(d, "card_save"), 0), ckpt.STATE_FILE))
        cpu_tr = loop.Trainer(cfg, TileCreator(ds, 16, 0.0, device="cpu"),
                              "cpu")
        cpu_tr.restore(run1, 1)
        gap_to_cpu = _state_gap(_state_tensors(tr.state()),
                                _state_tensors(cpu_tr.state()))
        cpu_tr.save(os.path.join(d, "cpu_save"), 0, it)
        back = loop.Trainer(cfg, TileCreator(ds, 16, 0.0, device=dev), dev)
        back.restore(os.path.join(d, "cpu_save"), 0)
        gap_from_cpu = _state_gap(_state_tensors(back.state()),
                                  _state_tensors(cpu_tr.state()))
        assert gap_to_cpu == 0.0 and gap_from_cpu == 0.0, (gap_to_cpu,
                                                            gap_from_cpu)
        del tr, cpu_tr, back

        # the recipe in float32: test_0003, resumed twice from model_0001
        # into test_0004 and test_0005
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        f32 = ("out 0 " + CLI_RECIPE.replace("lrdisc 0.0004", "lrdisc 0.01")
               + " dtype float32 lrgan 1 adamEps 1 outputInterval 4 ")
        res["pass1_f32_s"] = run_cli(f32 + "trainingIters 4 saveInterval 2")
        for _ in range(2):
            run_cli(f32 + "trainingIters 2 saveInterval 0 resumeTest 3 "
                    "resumeNo 1")
        conts = [ckpt.restore(ckpt.run_dir(runs, i), 0, "cpu")
                 for i in (4, 5)]
        assert all(m["it"] == 4 for _, m in conts), [m for _, m in conts]
        resume_gap = _state_gap(_state_tensors(conts[0][0]),
                                _state_tensors(conts[1][0]))
        assert resume_gap <= 1e-4, resume_gap
        res["f32_resume_max_abs_gap"] = resume_gap
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True

        # (c) pass 3 on the bundled chain's outputs: test_0006
        n3 = 4
        wk.launches = wk.bwd_launches = 0                  # path starts
        res["pass3_s"] = run_cli(
            f"out 0 {CLI_RECIPE} trainPass 3 pass3Source model "
            f"load_model_test 0 load_model_test2 1 trainingIters {n3} "
            f"saveInterval 2 outputInterval {n3}")
        launches3 = (wk.launches, wk.bwd_launches)         # path ends
        assert launches3 == (3 * n3, n3), launches3
        run3 = ckpt.run_dir(runs, 6)
        assert ckpt.run_pass_no(run3) == 3
        last = _last_metrics(run3)
        assert all(np.isfinite(last[k]) for k in TRAIN_METRICS), last
        # its checkpoint in a Trainer: 2 windows of 16 steps
        g1 = load.load_generator(cfg, 1, 0, -1, dev)
        g2 = load.load_generator(cfg, 2, 1, -1, dev)
        finals = assemble.precompute_finals(g1, g2, torch.from_numpy(
            ds.lr).to(dev), 4)
        assert finals.shape == (8, 128, 128, 128, 1)
        tc3 = TileCreator(ds, 16, 0.0, device=dev, final=finals)

        def restored(graphs):
            tr3 = loop.Trainer(cfg, tc3, dev, pass_no=3, graphs=graphs)
            assert tr3.restore(run3, ckpt.latest_model_no(run3)) == n3
            return tr3
        wk.launches = wk.bwd_launches = 0
        turns = train_turns(cfg, restored, n=32, windows=3)
        del turns["trainers"]
        steps = turns["steps"]
        assert (wk.launches, wk.bwd_launches) == (3 * steps, steps)
        res["pass3"] = {"cli_steps": n3, "warp_launches": launches3[0],
                        "warp_bwd_launches": launches3[1], **turns,
                        "cli_metrics": {k: last[k] for k in TRAIN_METRICS}}
        del tc3, finals

        # (d) out 1, three passes, two frames: test_0007
        res["out1_3pass_s"] = run_cli(
            "out 1 load_model_test 0 load_model_test2 1 load_model_test3 6 "
            "outFrameMin 1 outFrameMax 3",
            sims=data.replace("toSim 1001", "toSim 1000"))
        assert len(os.listdir(ckpt.run_dir(runs, 7))) == 2
        cfg.train.load_model_test = 0
        chain = load.load_pass_chain(cfg, 1, -1, 6, -1, device=dev)
        out_gap = 0.0
        for f in (1, 2):
            got = uni.readUni(os.path.join(ckpt.run_dir(runs, 7),
                                           f"source_1000_{f:04d}.uni"))[1]
            lr = load.read_lr_frame(cfg, os.path.join(d, "data",
                                                      "sim_1000"), f)
            with torch.inference_mode():
                want = assemble.upscale_volume(
                    chain[0], chain[1], torch.from_numpy(lr).to(dev), 4,
                    gen3=chain[2]).float().cpu().numpy()
            assert got.shape == want.shape == (128, 128, 128, 1)
            assert np.isfinite(got).all()
            out_gap = max(out_gap, float(np.abs(got - want).max()))
        assert out_gap == 0.0, out_gap
        res["out1_max_abs_gap"] = out_gap
        lr_dev = torch.from_numpy(lr).to(dev)
        with torch.inference_mode():
            res["frame_3pass_ms"] = cuda_ms(lambda: assemble.upscale_volume(
                chain[0], chain[1], lr_dev, 4, gen3=chain[2]), 10)
            res["frame_2pass_ms"] = cuda_ms(lambda: assemble.upscale_volume(
                chain[0], chain[1], lr_dev, 4), 10)
    print("   cli " + json.dumps(res), flush=True)
    done(t0)
    return res


def phase_quality(dev):
    from mpgan_torch import eval as mp_eval
    from mpgan_torch import quality

    t0 = phase("9 quality gates of every bundle on the card; mpgan_torch.eval")
    res = {}
    for name in quality.GATES:
        for rec in quality.run_gate(name, dev):
            for f in rec["floors"]:
                print(f"   {name} {'+'.join(rec['chain'])}: {f['check']}: "
                      f"{f['value']:.4f} {'ok' if f['ok'] else 'FAILED'}",
                      flush=True)
            assert all(f["ok"] for f in rec["floors"]), rec
            res.setdefault(name, []).append(
                {"chain": rec["chain"], **rec["values"]})
    gate = res["test_4x_canonical_twopass_l1_bundled_floor"][0]
    with tempfile.TemporaryDirectory() as d:
        # eval reads sim_%04d dirs: the canonical frame (sim_1010c) as
        # sim_1010, the exported pair as gen-only runs test_0000/test_0001
        os.makedirs(os.path.join(d, "data"))
        os.symlink(os.path.join(DATA, "sim_1010c"),
                   os.path.join(d, "data", "sim_1010"))
        runs = os.path.join(d, "runs")
        _gen_only_runs(runs, ("g1_l1_4x", "g2_l1_4x"))
        t = time.perf_counter()
        with quality.full_f32():
            ev = mp_eval.main(
                f"basePath {d}/data/ fromSim 1010 toSim 1010 frameMin 12 "
                f"frameMax 13 upRes 4 dtype float32 load_model_test 0 "
                f"load_model_test2 1 testPath {runs}/".split())
        eval_s = time.perf_counter() - t
    want = {"psnr_mean": round(gate["psnr"], 3),
            "ssim_mean": round(gate["ssim"], 4),
            "trilinear_psnr_mean": round(gate["tri"], 3),
            "trilinear_ssim_mean": round(gate["ssim_tri"], 4)}
    assert ev["frames"] == 1 and ev["two_pass"], ev
    assert {k: ev[k] for k in want} == want, (ev, want)
    done(t0, gates=len(res), eval_s=f"{eval_s:.2f}")
    return {"gates": res, "eval": ev, "eval_s": eval_s}


def _gen_only_runs(runs, names):
    """The shipped generators ``names`` as gen-only runs test_0000, ...
    (``gen_0000/params.npz`` + sidecar) under ``runs``."""
    from mpgan_torch.infer import load

    for idx, name in enumerate(names):
        dst = os.path.join(runs, f"test_{idx:04d}", "gen_0000")
        os.makedirs(dst)
        src = load.bundled_weights(name)
        shutil.copy(src, os.path.join(dst, "params.npz"))
        shutil.copy(os.path.splitext(src)[0] + ".json",
                    os.path.join(dst, "params.json"))


def _peak_after(fn):
    """(result, seconds, peak device bytes) of ``fn()``, synchronised, with
    the peak counter reset just before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, torch.cuda.max_memory_allocated()


@contextlib.contextmanager
def counted_captures():
    """A list that gets one entry per CUDA graph captured in the block
    (mpgan_torch.train.graphed.Graph)."""
    from mpgan_torch.train import graphed as graphed_mod

    captures = []
    graph_init = graphed_mod.Graph.__init__

    def counted(self, fn, device, generator=None):
        graph_init(self, fn, device, generator)
        captures.append(fn)
    graphed_mod.Graph.__init__ = counted
    try:
        yield captures
    finally:
        graphed_mod.Graph.__init__ = graph_init


@contextlib.contextmanager
def eager_only():
    """Within the block nothing is graphable (mpgan_torch.infer.assemble
    .graphable answers False): what is built there runs eagerly."""
    from mpgan_torch.infer import assemble

    graphable = assemble.graphable
    assemble.graphable = lambda device, devices=None: False
    try:
        yield
    finally:
        assemble.graphable = graphable


def phase_streamed(dev):
    from mpgan_torch import quality
    from mpgan_torch.infer import assemble
    from mpgan_torch.serve import _to_host

    t0 = phase("10 streamed assembly: 128^3 -> 512^3 and 1024^3, bf16")
    chunk = 32
    lr = torch.from_numpy(np.random.default_rng(2).random(
        (128, 128, 128, 4), dtype=np.float32)).to(dev)
    res = {"chunk": chunk}
    # (dtype, max |streamed - in memory|): the two feed G2 slices of
    # different memory layouts, so cuDNN may pick other kernels and round
    # differently: in bf16 by one unit in the last place of the densities
    # (2^-7 in [1, 2)); in float32 with TF32 off within phase 3's 1e-4
    for dtype, tol in (("bfloat16", 2.0 ** -7), ("float32", 1e-4)):
        _, g1, g2 = load_chain(dtype, dev)

        def in_memory():
            return assemble.upscale_volume(g1, g2, lr, 4, chunk=chunk)

        def streamed():
            return assemble.upscale_volume_streamed(g1, g2, lr, 4,
                                                    chunk=chunk, chunk1=chunk)
        with torch.inference_mode(), quality.full_f32():
            in_memory()                        # warm-up
            ref, s_mem, peak_mem = _peak_after(in_memory)
            t = time.perf_counter()
            ref = _to_host(ref)
            fetch_s = time.perf_counter() - t
            streamed()                         # warm-up
            got, s_str, peak_str = _peak_after(streamed)
        assert got.shape == ref.shape == (512, 512, 512, 1)
        assert got.dtype == np.float32 and bool(np.isfinite(got).all())
        diff = np.abs(got - ref)
        err = float(diff.max())
        assert err <= tol, (dtype, err)
        res[f"512_{dtype}"] = {
            "in_memory_ms": s_mem * 1e3, "in_memory_fetch_ms": fetch_s * 1e3,
            "in_memory_peak_bytes": peak_mem, "streamed_ms": s_str * 1e3,
            "streamed_peak_bytes": peak_str, "max_abs_err": err,
            "tolerance": tol, "share_differing": float((diff > 0).mean())}
        del ref, got, diff
    lr = torch.from_numpy(np.random.default_rng(3).random(
        (256, 256, 256, 4), dtype=np.float32)).to(dev)
    _, g1, g2 = load_chain("bfloat16", dev)
    with torch.inference_mode():
        big, s_big, peak_big = _peak_after(
            lambda: assemble.upscale_volume_streamed(g1, g2, lr, 4,
                                                     chunk=chunk,
                                                     chunk1=chunk))
    assert big.shape == (1024, 1024, 1024, 1)
    assert bool(np.isfinite(big[::7, ::7, ::7]).all())
    del big
    res["1024_bfloat16"] = {"streamed_ms": s_big * 1e3,
                            "streamed_peak_bytes": peak_big}
    print("   streamed " + json.dumps(res), flush=True)
    done(t0)
    return res


def phase_recover(dev, wk):
    from mpgan_torch import cli
    from mpgan_torch.train import checkpoint as ckpt

    t0 = phase("11 fault recovery: out 0 with MPGAN_FAIL_ONCE/HANG_ONCE")
    res = {}
    with tempfile.TemporaryDirectory() as d:
        smooth_dataset(os.path.join(d, "data"), n_sims=1)
        data = f"basePath {d}/data/ fromSim 1000 toSim 1000 frameMax 4 "
        # float32 at the recipe's learning rates, with ganLoss sce and
        # adamEps 1, where two uninterrupted runs of these 4 steps agree on
        # the card (the gap is reported). With 8b's hinge and lrgan 1 they
        # do not agree within 1e-4: the card's atomics reorder float sums,
        # and the hinge's kink and G's unit step turn that noise into
        # discrete changes; Adam's default eps makes a first step of ±lr
        # that flips on noise
        f32 = (data + "out 0 " + CLI_RECIPE.replace("ganLoss hinge",
                                                    "ganLoss sce")
               + " dtype float32 adamEps 1 trainingIters 4 "
               "saveInterval 2 outputInterval 4 ")
        sentinel = os.path.join(d, "fail_once")

        # (a) in process: crash after the first checkpoint, resumeLatest
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        t = time.perf_counter()
        wk.launches = wk.bwd_launches = 0                  # path starts
        os.environ["MPGAN_FAIL_ONCE"] = sentinel
        try:
            cli.main((f32 + f"testPath {d}/a/").split())
            raise AssertionError("MPGAN_FAIL_ONCE did not fire")
        except RuntimeError as e:
            assert "MPGAN_FAIL_ONCE" in str(e), e
        finally:
            del os.environ["MPGAN_FAIL_ONCE"]
        crashed = (wk.launches, wk.bwd_launches)
        cli.main((f32 + f"testPath {d}/a/ resumeLatest 1").split())
        torch.cuda.synchronize()
        launches = (wk.launches, wk.bwd_launches)          # path ends
        res["a_s"] = time.perf_counter() - t
        assert crashed == (3 * 2, 2) and launches == (3 * 4, 4), (crashed,
                                                                 launches)
        # two uninterrupted runs: the reference and the card's own spread
        for name in ("plain", "plain2"):
            cli.main((f32 + f"testPath {d}/{name}/").split())
        got, want, again = (ckpt.restore(ckpt.run_dir(f"{d}/{name}", 0), 2,
                                         "cpu")
                            for name in ("a", "plain", "plain2"))
        assert got[1] == want[1] and got[1]["it"] == 4, (got[1], want[1])
        gap = _state_gap(_state_tensors(got[0]), _state_tensors(want[0]))
        spread = _state_gap(_state_tensors(again[0]),
                            _state_tensors(want[0]))
        assert gap <= 1e-4, (gap, spread)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        res.update(warp_launches=launches[0], warp_bwd_launches=launches[1],
                   steps=4, resumed_vs_uninterrupted_max_abs_gap=gap,
                   uninterrupted_repeat_max_abs_gap=spread)

        # (b) as a user runs it: a supervised child crashes, then hangs
        env = dict(os.environ, MPGAN_RETRY_DELAY_S="0",
                   MPGAN_STARTUP_GRACE_S="60",
                   PYTHONPATH=os.pathsep.join(
                       [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        bf16 = data + "out 0 " + CLI_RECIPE + " trainingIters 4 saveInterval 2"
        for kind, var, extra in (("crash", "MPGAN_FAIL_ONCE", ""),
                                 ("hang", "MPGAN_HANG_ONCE", " hangTimeout 5")):
            runs = os.path.join(d, kind)
            flag = os.path.join(d, f"{kind}_once")
            t = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "mpgan_torch.cli"]
                + (bf16 + f" testPath {runs}/ retryOnError 1" + extra).split(),
                capture_output=True, text=True, env=dict(env, **{var: flag}),
                timeout=300)
            res[f"b_{kind}_s"] = time.perf_counter() - t
            assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
            assert os.path.exists(flag), kind
            assert "retryOnError: training child died" in r.stdout, kind
            assert "resumeIndex 0: resuming model_0001" in r.stdout, kind
            if kind == "hang":
                assert "; killing it" in r.stdout
            meta = ckpt.read_json(ckpt.model_dir(ckpt.run_dir(runs, 0), 2)
                                  + ".json")
            assert meta["it"] == 4 and meta["total_iters"] == 4, meta
    print("   recover " + json.dumps(res), flush=True)
    done(t0)
    return res


def _plain_triplet_bwd(wk):
    """align_triplet_kernel_bwd's plain version: the autograd of
    align_triplet_ref under deterministic algorithms, so that gather's
    backward sums each gradient in a fixed order instead of with atomics."""
    def bwd(g, prev, nxt, vel, max_disp=wk.DEFAULT_MAX_DISP,
            field_grads=True, vel_grad=False):
        p, n, v = (t.detach().requires_grad_() for t in (prev, nxt, vel))
        torch.use_deterministic_algorithms(True)
        try:
            with torch.enable_grad():
                out = wk.align_triplet_ref(p, torch.zeros_like(p), n, v,
                                           max_disp)
                d_p, d_n, d_v = torch.autograd.grad(out, (p, n, v), g)
        finally:
            torch.use_deterministic_algorithms(False)
        return ((d_p, d_n) if field_grads else (None, None)) + (
            d_v if vel_grad else None,)
    return bwd


def _interpolate_upsample(x, fh, fw):
    """The generator's upsample as the port first ran it:
    ``F.interpolate`` with its own backward (atomics on CUDA)."""
    if fh == 1 and fw == 1:
        return x
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(h * fh, w * fw), mode="bilinear",
                         align_corners=False)


# phase 11c: way → (F.interpolate's upsample backward, plain triplet
# backward, cuDNN's deterministic mode: "off" with Trainer.fit's own mode
# patched out, "set" by the phase, "fit" left to Trainer.fit)
REPRO_WAYS = {
    "interpolate_bwd": (True, False, "off"),
    "plain_triplet_bwd": (True, True, "off"),
    "cudnn_deterministic": (True, False, "set"),
    "both": (True, True, "set"),
    "fixed_upsample_bwd": (False, False, "off"),
    "all_three": (False, True, "set"),
    "kernel_bwd_deterministic": (False, False, "set"),
    "trainer_default": (False, False, "fit"),
}
# the ways whose every pair must reproduce bit for bit: the fixed-order
# upsample backward, the triplet backward kernel, cuDNN deterministic (set
# by the phase; set by Trainer.fit alone, the trainer as a user runs it)
REPRO_GATED = ("kernel_bwd_deterministic", "trainer_default")
REPRO_PAIRS = 3


def _graphed_equals_eager(cfg, tc, dev, iters):
    """``iters`` steps of ``cfg`` stepping eagerly and replaying CUDA
    graphs from the same seed → (every tensor of each run's state, the
    last metrics of each, the graphed run's programs: uses and whether
    captured, by (fade, R1))."""
    from mpgan_torch.train import loop

    states, metrics = [], []
    for graphs in (False, True):
        tr = loop.Trainer(cfg, tc, device=dev, graphs=graphs)
        metrics.append(tr.fit(iters, log_every=iters))
        torch.cuda.synchronize()
        states.append(_state_tensors(tr.state()))
    programs = {f"fade={k[0]},r1={k[1]}": [p.uses, p.graph is not None]
                for k, p in tr.programs.programs.items()}
    return states, metrics, programs


def phase_repro(dev, wk):
    from mpgan_torch import cli
    from mpgan_torch import config as cfgmod
    from mpgan_torch.data.loader import FluidDataLoader
    from mpgan_torch.data.pipeline import TileCreator
    from mpgan_torch.models import generator
    from mpgan_torch.ops import upsample
    from mpgan_torch.train import checkpoint as ckpt
    from mpgan_torch.train import loop

    t0 = phase(f"11c float32 reproducibility: 8b's setting, "
               f"{len(REPRO_WAYS)} ways x {REPRO_PAIRS} pairs of runs")
    res = {}
    kernel_bwd = wk.align_triplet_kernel_bwd
    step_init = loop.TrainStep.__init__
    fixed_up = (generator.upsample_nchw, upsample.upsample_nchw)

    def plain_bwd_step_init(self, *args, **kwargs):
        step_init(self, *args, **kwargs)
        self.warp_bwds_per_step = 0     # the step's own launch check
    # the seven ways step eagerly, as the runs they are compared with did;
    # the gated way then also replays graphs, against its eager run
    trainer_init = loop.Trainer.__init__

    def eager_trainer_init(self, *args, **kwargs):
        trainer_init(self, *args, graphs=False, **kwargs)
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    with tempfile.TemporaryDirectory() as d:
        smooth_dataset(os.path.join(d, "data"), n_sims=1)
        f32 = (f"basePath {d}/data/ fromSim 1000 toSim 1000 frameMax 4 out 0 "
               + CLI_RECIPE.replace("lrdisc 0.0004", "lrdisc 0.01")
               + " dtype float32 lrgan 1 adamEps 1 trainingIters 4 "
               "saveInterval 2 outputInterval 4 ")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            loop.Trainer.__init__ = eager_trainer_init
            def pair_gap(way, k, flags_line):
                for i in (0, 1):
                    cli.main((flags_line + f"testPath {d}/{way}{k}{i}/")
                             .split())
                torch.cuda.synchronize()
                a, b = (_state_tensors(ckpt.restore(ckpt.run_dir(
                    f"{d}/{way}{k}{i}", 0), 2, "cpu")[0]) for i in (0, 1))
                assert all(bool(torch.isfinite(t.float()).all())
                           for t in a.values())
                return _state_gap(a, b)

            for way, (interp, plain, determ) in REPRO_WAYS.items():
                up = _interpolate_upsample if interp else fixed_up[0]
                generator.upsample_nchw = upsample.upsample_nchw = up
                wk.align_triplet_kernel_bwd = (_plain_triplet_bwd(wk) if plain
                                               else kernel_bwd)
                loop.TrainStep.__init__ = (plain_bwd_step_init if plain
                                           else step_init)
                cudnn.deterministic, cudnn.benchmark = flags
                if determ == "set":
                    cudnn.deterministic, cudnn.benchmark = True, False
                wk.launches = wk.bwd_launches = 0
                with (cudnn_mode_off() if determ == "off"
                      else contextlib.nullcontext()):
                    gaps = [pair_gap(way, k, f32)
                            for k in range(REPRO_PAIRS)]
                res[way] = {"repeat_max_abs_gaps": gaps,
                            "largest": max(gaps),
                            "median": sorted(gaps)[REPRO_PAIRS // 2],
                            "cudnn_mode": determ,
                            "warp_launches": wk.launches,
                            "warp_bwd_kernel_launches": wk.bwd_launches}
            # the trainer as a user runs it, in bf16: one pair, reported
            cudnn.deterministic, cudnn.benchmark = flags
            res["trainer_default_bfloat16"] = {"repeat_max_abs_gap": pair_gap(
                "bf16", 0, f32.replace("dtype float32", "dtype bfloat16"))}

            # the gated way replaying graphs against stepping eagerly: 32
            # steps of the recipe (R1 at steps 0 and 16), then a useGrowing
            # stretch (stage 1 for 12 steps, stage 2 fading over 8 with R1
            # at step 16, stable for 4)
            loop.Trainer.__init__ = trainer_init
            generator.upsample_nchw, upsample.upsample_nchw = fixed_up
            wk.align_triplet_kernel_bwd = kernel_bwd
            loop.TrainStep.__init__ = step_init
            # no flag set here: Trainer.fit holds cuDNN's deterministic mode
            cfg = cfgmod.from_cli(f32.split())
            tc = TileCreator(FluidDataLoader(f"{d}/data/", 1000, 1000, 0,
                                             4).get(), 16, 0.0, device=dev)
            grow = cfgmod.from_cli((f32 + "useGrowing 1 alphaIters 8 "
                                    "stableIters 4").split())
            for name, c, iters in (("graphed_recipe", cfg, 32),
                                   ("graphed_growing", grow, 24)):
                wk.launches = wk.bwd_launches = 0
                (a, b), (ma, mb), programs = _graphed_equals_eager(
                    c, tc, dev, iters)
                assert all(bool(torch.isfinite(t.float()).all())
                           for t in a.values())
                res[name] = {
                    "steps": iters, "max_abs_gap": _state_gap(a, b),
                    "metrics_equal": all(ma[k] == mb[k]
                                         for k in TRAIN_METRICS),
                    "programs_uses_captured": programs,
                    "warp_launches": wk.launches,
                    "warp_bwd_kernel_launches": wk.bwd_launches}
                assert (wk.launches, wk.bwd_launches) == (6 * iters,
                                                          2 * iters)
            del tc
        finally:
            loop.Trainer.__init__ = trainer_init
            generator.upsample_nchw, upsample.upsample_nchw = fixed_up
            wk.align_triplet_kernel_bwd = kernel_bwd
            loop.TrainStep.__init__ = step_init
            cudnn.deterministic, cudnn.benchmark = flags
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
    print("   repro " + json.dumps(res), flush=True)
    for way in REPRO_GATED:
        gated = res[way]
        assert gated["largest"] == 0.0, (way, gated)
        # the kernel ran in every run (the step checks its own 3 + 1
        # launches)
        assert gated["warp_bwd_kernel_launches"] >= 2 * REPRO_PAIRS, gated
    for name in ("graphed_recipe", "graphed_growing"):
        r = res[name]
        assert r["max_abs_gap"] == 0.0 and r["metrics_equal"], (name, r)
    # replays ran: the recipe's two programs and the growing stretch's
    # stable and fading programs were captured
    assert res["graphed_recipe"]["programs_uses_captured"] == {
        "fade=False,r1=True": [2, True],
        "fade=False,r1=False": [30, True]}, res["graphed_recipe"]
    assert res["graphed_growing"]["programs_uses_captured"] == {
        "fade=True,r1=False": [7, True], "fade=True,r1=True": [1, False],
        "fade=False,r1=False": [4, True]}, res["graphed_growing"]
    done(t0, **{k: f"{v['largest']:.3g}/{v['median']:.3g}"
                for k, v in res.items() if k in REPRO_WAYS},
         graphed_gaps=[res[k]["max_abs_gap"] for k in ("graphed_recipe",
                                                       "graphed_growing")])
    return res


def _smoke_inputs(n, seed, dev):
    """A state at n³ with a sphere obstacle, an inflow sphere and a source,
    made with numpy from ``seed`` and moved to ``dev``."""
    from mpgan_torch.solver import smoke

    rng = np.random.default_rng(seed)
    solid = smoke.sphere_mask(n, n, n, (0.5, 0.55, 0.5), 0.12)
    dens = torch.from_numpy(rng.random((n, n, n, 1), dtype=np.float32))
    vel = torch.from_numpy((rng.standard_normal((n, n, n, 3)) * 0.5).astype(
        np.float32))
    inflow = smoke.sphere_mask(n, n, n, (0.5, 0.12, 0.5), 0.14) * (1 - solid)
    src = torch.from_numpy(rng.random((n, n, n, 1), dtype=np.float32))
    state = smoke.SmokeState(dens * (1 - solid), vel * (1 - solid), solid)
    return (smoke.SmokeState(*(t.to(dev) for t in state)), src.to(dev),
            inflow.to(dev))


def _fluid_div(state):
    from mpgan_torch.solver import smoke

    fluid = 1.0 - state.solid
    return float((smoke.divergence(state.velocity) * fluid).abs().sum()
                 / fluid.sum())


def phase_datagen(dev, wk, card):
    from mpgan_torch import cli
    from mpgan_torch import datagen as datagen_cli
    from mpgan_torch.data import loader
    from mpgan_torch.io import native
    from mpgan_torch.solver import datagen, smoke

    t0 = phase("12 datagen on the card -> native .uni codec -> loader -> "
               "out 0")
    res = {"card": card}
    # (a) one step at 64^3 with an obstacle and MacCormack, card vs CPU.
    # Jacobi has no reduction, so only the rounding of single ops differs;
    # CG's dot products sum in another order on the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for solver, tol in (("jacobi", 1e-5), ("cg", 1e-4)):
        params = smoke.SmokeParams(dt=0.5, buoyancy=2e-2, vorticity_eps=0.1,
                                   jacobi_iters=50, cg_iters=60,
                                   maccormack=True, pressure_solver=solver)
        outs = []
        for where in ("cpu", dev):
            state, src, inflow = _smoke_inputs(64, 0, where)
            outs.append(smoke.step(state, params, src, inflow))
        err = gap([t.cpu() for t in outs[1]], outs[0])
        res[f"a_{solver}"] = {"card_vs_cpu_max_abs_err": err,
                              "tolerance": tol,
                              "fluid_mean_abs_div_card": _fluid_div(outs[1]),
                              "fluid_mean_abs_div_cpu": _fluid_div(outs[0])}
        assert err <= tol, (solver, err)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    print("   12a " + json.dumps({k: v for k, v in res.items()
                                  if k.startswith("a_")}), flush=True)

    with tempfile.TemporaryDirectory() as d:
        base = os.path.join(d, "data")
        frames = 6
        common = f"basePath {base}/ frames {frames} randSeed 0"
        # (b) datagen at its defaults (resHigh 128, upRes 4, warmup 8): two
        # plume sims as a user runs it, the second with an obstacle
        t = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "mpgan_torch.datagen", *(
                common + " fromSim 1000 toSim 1001 obstacles 2").split()],
            capture_output=True, text=True, timeout=600, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])))
        assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
        sims = [json.loads(line[len("datagen "):])
                for line in r.stdout.splitlines()
                if line.startswith("datagen ")]
        res["b_subprocess_s"] = time.perf_counter() - t
        sims += datagen_cli.main(
            (common + " fromSim 1002 toSim 1002 scene varied "
             "pressureSolver cg").split())
        sims += datagen_cli.main(
            (common + " fromSim 1003 toSim 1003 scene moving").split())
        sims += datagen_cli.main(
            (common + " fromSim 1004 toSim 1004 dataDim 2 resHigh 256")
            .split())
        assert [s["sim"] for s in sims] == [1000, 1001, 1002, 1003, 1004]
        assert [s["obstacle"] for s in sims[:2]] == [False, True]
        assert all(s["frames"] == frames for s in sims), sims
        assert all(s["graphed"] for s in sims), sims    # the card's default
        for s in sims:
            print(f"   12b sim {s['sim']} " + json.dumps(s), flush=True)
        res["b_sims"] = sims
        # one 256^3 step of each solver on the plume scene, peak memory
        for solver in ("jacobi", "cg"):
            sc = datagen.make_scene(0, 256, "plume", True, solver, dev)
            src = sc.inflow * 0.75
            state = smoke.step(sc.state, sc.params, src, sc.inflow)  # warm-up
            state, s, peak = _peak_after(
                lambda: smoke.step(state, sc.params, src, sc.inflow))
            assert bool(torch.isfinite(state.velocity).all())
            res[f"b_256_{solver}"] = {"step_ms": s * 1e3, "peak_bytes": peak,
                                      "fluid_mean_abs_div": _fluid_div(state)}
            del sc, state, src
        print("   12b 256^3 " + json.dumps({k: res[f"b_256_{k}"] for k in
                                            ("jacobi", "cg")}), flush=True)

        # (c) read back through the native codec and the pure-Python one,
        # then train on the generated sims
        assert native.available(), "the native .uni codec did not build"
        lib = native.get_lib()

        def load():
            t = time.perf_counter()
            ds = loader.FluidDataLoader(base, 1000, 1003, 0, frames).get()
            return ds, time.perf_counter() - t
        ds, native_s = load()
        native._lib = False                  # as on a host without g++
        try:
            ds_py, python_s = load()
        finally:
            native._lib = lib
        for k in ("lr", "hr"):
            assert np.array_equal(getattr(ds, k), getattr(ds_py, k)), k
        assert ds.lr.shape == (4 * frames, 32, 32, 32, 4)
        assert ds.hr.shape == (4 * frames, 128, 128, 128, 1)
        assert np.isfinite(ds.lr).all() and ds.hr.max() > 0.1
        res["c_loader"] = {"native_s": native_s, "python_s": python_s,
                           "speedup": python_s / native_s,
                           "frames": 4 * frames,
                           "bytes": int(ds.lr.nbytes + ds.hr.nbytes)}
        steps = 4
        wk.launches = wk.bwd_launches = 0                  # path starts
        t = time.perf_counter()
        cli.main((f"basePath {base}/ fromSim 1000 toSim 1003 frameMax "
                  f"{frames} testPath {d}/runs/ out 0 {CLI_RECIPE} "
                  f"trainingIters {steps} saveInterval {steps} "
                  f"outputInterval {steps}").split())
        torch.cuda.synchronize()
        launches = (wk.launches, wk.bwd_launches)          # path ends
        res["c_train_s"] = time.perf_counter() - t
        assert launches == (3 * steps, steps), launches
        last = _last_metrics(os.path.join(d, "runs", "test_0000"))
        assert all(np.isfinite(last[k]) for k in TRAIN_METRICS), last
        res["c_train"] = {"steps": steps, "warp_launches": launches[0],
                          "warp_bwd_launches": launches[1],
                          "metrics": {k: last[k] for k in TRAIN_METRICS}}
    print("   12c " + json.dumps({k: v for k, v in res.items()
                                  if k.startswith("c_")}), flush=True)
    done(t0)
    return res

# phase 12d: (name, resolution, pressure solver, obstacle, steps per window)
SOLVER_CASES = (("64^3_jacobi", 64, "jacobi", True, 10),
                ("64^3_cg", 64, "cg", True, 10),
                ("128^3_jacobi", 128, "jacobi", True, 6),
                ("128^3_cg", 128, "cg", True, 6),
                ("256^3_jacobi", 256, "jacobi", False, 1),
                ("256^3_cg", 256, "cg", False, 1))
SOLVER_ROUNDS = 2      # rounds of turns (eager, graphed, graphed, eager)


@contextlib.contextmanager
def fixed_clock():
    """The wall clock stopped within the block: a .uni header's timestamp
    and gzip's mtime are equal in two runs, whose files can then be held
    byte for byte."""
    wall = time.time
    time.time = lambda: 1.7e9
    try:
        yield
    finally:
        time.time = wall


def solver_turns(name, ways, state, n, bit_steps=3):
    """Phase 12d's comparison of one case. ``ways``: "eager" and
    "graphed" → ``step(state, t)`` → the next state. From ``state`` both
    take ``bit_steps`` steps (the graphed program eager, captured, then
    replayed), every field equal bit for bit at every step; then each
    runs on from its own state, timed in turns (eager, graphed, graphed,
    eager; ``SOLVER_ROUNDS`` rounds) of one window of ``n`` steps between
    CUDA events, then profiled for 2 steps each
    (mpgan_torch.profiling.solver_profile) → per way the median ms per
    step, the windows and the profile; the graphed program's pool bytes,
    the ratio of the medians and the seconds of each part."""
    from mpgan_torch import profiling

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()        # the pools of released graphs go
    pools = _graph_pool_bytes()
    states = dict.fromkeys(ways, state)
    for t in range(bit_steps):
        for way, step in ways.items():
            states[way] = step(states[way], t)
        assert all(torch.equal(g, e) for g, e in zip(
            states["graphed"], states["eager"])), (name, t)
    torch.cuda.synchronize()
    pool_bytes = _graph_pool_bytes() - pools
    t1 = time.perf_counter()
    clock = dict.fromkeys(ways, bit_steps)

    def one(way):
        states[way] = ways[way](states[way], clock[way])
        clock[way] += 1
    ms = {way: [] for way in ways}
    for _ in range(SOLVER_ROUNDS):
        for way in ("eager", "graphed", "graphed", "eager"):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            for _ in range(n):
                one(way)
            ev[1].record()
            torch.cuda.synchronize()
            ms[way].append(ev[0].elapsed_time(ev[1]) / n)
    t2 = time.perf_counter()
    res = {"bit_steps_equal": bit_steps, "graph_pool_bytes": pool_bytes}
    for way in ways:
        res[way] = {"ms_per_step": sorted(ms[way])[len(ms[way]) // 2],
                    "ms_per_step_windows": ms[way],
                    "profile": profiling.solver_profile(
                        lambda w=way: one(w), 2)}
    res["graphed_over_eager"] = (res["graphed"]["ms_per_step"]
                                 / res["eager"]["ms_per_step"])
    res["s"] = {"bits": t1 - t0, "turns": t2 - t1,
                "profiles": time.perf_counter() - t2}
    return res


def phase_solver_graphs(dev, card):
    """12d: the solver's step and the datagen frame graphed against eager
    on the card (module docstring)."""
    from mpgan_torch.solver import datagen, smoke, smoke2d
    from mpgan_torch.solver.graphed import GraphedStep

    t0 = phase("12d solver step and datagen frame: graphed against eager")
    res = {"card": card, "steps": {}}
    for name, n, solver, obstacle, per_window in SOLVER_CASES:
        sc = datagen.make_scene(0, n, "plume", obstacle, solver, dev)
        src = sc.inflow * 0.75
        graphed_step = GraphedStep()
        res["steps"][name] = solver_turns(name, {
            "eager": lambda s, t: smoke.step(s, sc.params, src, sc.inflow),
            "graphed": lambda s, t: graphed_step(s, sc.params, src,
                                                 sc.inflow)},
            sc.state, per_window)
        graphed_step.release()
        del sc, src, graphed_step
    # the moving scene's frame at 128^3: noise, the obstacle's mask built
    # in the program from its centre, the step
    sc = datagen.make_scene(3, 128, "moving", device=dev)
    with eager_only():
        eager = datagen.scene_frames(sc, 3, 4, dev)
    frames = datagen.scene_frames(sc, 3, 4, dev)
    assert frames.graphed and not eager.graphed
    res["steps"]["128^3_moving_frame"] = solver_turns(
        "128^3_moving_frame", {"eager": eager.advance,
                               "graphed": frames.advance}, sc.state, 6)
    frames.release()
    # 2D at 256^2 with a disc obstacle
    solid = smoke2d.disc_mask(256, 256, (0.55, 0.5), 0.1, dev)
    inflow = smoke2d.disc_mask(256, 256, (0.12, 0.5), 0.12, dev) * (
        1 - solid)
    params = smoke.SmokeParams(dt=0.5, buoyancy=2e-2, vorticity_eps=0.1,
                               jacobi_iters=50, maccormack=True)
    graphed_step = GraphedStep(smoke2d.step)
    res["steps"]["256^2_2d_jacobi"] = solver_turns("256^2_2d_jacobi", {
        "eager": lambda s, t: smoke2d.step(s, params, inflow * 0.75,
                                           inflow),
        "graphed": lambda s, t: graphed_step(s, params, inflow * 0.75,
                                             inflow)},
        smoke2d.init_state(256, 256, solid, dev), 10)
    graphed_step.release()
    for name, r in res["steps"].items():
        print(f"   12d {name} " + json.dumps({
            "eager_ms": r["eager"]["ms_per_step"],
            "graphed_ms": r["graphed"]["ms_per_step"],
            "ratio": r["graphed_over_eager"],
            "launches_per_step": [r[w]["profile"]["host_launches_per_step"]
                                  for w in ("eager", "graphed")],
            "busy": [r[w]["profile"]["device_busy_share"]
                     for w in ("eager", "graphed")],
            "pool_bytes": r["graph_pool_bytes"], "s": r["s"]}), flush=True)

    # one 6-frame sim per scene family at datagen's defaults (128^3, upRes
    # 4, warmup 8; the HR velocity not written, to keep the phase short),
    # graphed and eager in turns, the files held byte for byte
    sims = (("plume", dict(with_obstacle=True)),
            ("varied", {}),
            ("varied-dual", dict(pressure_solver="cg")),
            ("moving", {}),
            ("2d", {}))
    res["datagen"] = {}
    with tempfile.TemporaryDirectory() as d, fixed_clock():
        for i, (scene, kw) in enumerate(sims):
            runs = {}
            # the first sim's first way pays for the kernels' first use:
            # the order alternates
            order = ("graphed", "eager") if i % 2 == 0 else ("eager",
                                                             "graphed")
            for way in order:
                out = os.path.join(d, way, scene)
                ctx = eager_only() if way == "eager" else \
                    contextlib.nullcontext()
                with ctx:
                    if scene == "2d":
                        runs[way] = datagen.generate_sim_2d(
                            out, 1010 + i, 256, 4, 6, with_obstacle=True)
                    else:
                        runs[way] = datagen.generate_sim(
                            out, 1010 + i, 128, 4, 6, scene=scene,
                            save_flags=True, write_high_vel=False, **kw)
                assert runs[way]["graphed"] == (way == "graphed"), runs[way]
            names = sorted(os.listdir(os.path.join(d, "eager", scene)))
            assert names == sorted(os.listdir(os.path.join(d, "graphed",
                                                           scene)))
            for fname in names:
                with open(os.path.join(d, "eager", scene, fname),
                          "rb") as a, open(os.path.join(
                              d, "graphed", scene, fname), "rb") as b:
                    assert a.read() == b.read(), (scene, fname)
            runs["files_equal"] = len(names)
            res["datagen"][scene] = runs
            print(f"   12d datagen {scene} " + json.dumps({
                way: {k: runs[way][k] for k in (
                    "seconds", "frame_device_ms", "frame_compute_ms",
                    "frame_fetch_write_ms")}
                for way in ("graphed", "eager")} | {"files_equal":
                                                   len(names)}),
                flush=True)
    done(t0, **{name: "{:.3f}/{:.3f}".format(
        r["eager"]["ms_per_step"], r["graphed"]["ms_per_step"])
        for name, r in res["steps"].items()})
    return res


# phase 13b: two ranks' gap to one process, as a share of how far the
# one-process run moved from the initial state
DP_REL_LIMIT = 1e-2


def _dp_config():
    """The flagship recipe in phase 11a's float32 setting (ganLoss sce,
    adamEps 1; the caller turns TF32 off), where the card reproduces an
    uninterrupted run within 1e-4."""
    from mpgan_torch.train import recipe

    cfg = recipe.flagship_config("float32")
    cfg.loss.gan_loss = "sce"
    cfg.train.adam_eps = 1.0
    return cfg


DP_MODES = ("replicated", "sharded", "summed")


def _dp_rank(rank, world, url, out_dir, own_cards):
    """One rank of phase 13b (a spawned process): the flagship recipe at
    global B=16 on the synthetic dataset, 4 steps with replicated, then
    sharded residency, then replicated again with a planted fault (each
    gradient summed over the ranks instead of averaged: the check that
    two ranks equal one process must catch it), on card ``rank`` over
    NCCL (``own_cards``) or on card 0 over gloo. Saves each final state
    and writes ``rank<r>.json``: residency, volumes held, warp
    launches."""
    from mpgan_torch import _build
    from mpgan_torch.data.pipeline import TileCreator
    from mpgan_torch.ops import warp_kernel as wk
    from mpgan_torch.parallel import mesh as pmesh
    from mpgan_torch.train import loop, recipe

    dev = torch.device("cuda", rank if own_cards else 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load("warp")
    pmesh.init_distributed(url, world, rank, "nccl" if own_cards else "gloo")
    res = {"rank": rank, "world": pmesh.world(), "device": str(dev)}
    mean = pmesh.all_reduce_mean
    try:
        ds = recipe.synthetic_dataset()
        for mode in DP_MODES:
            if mode == "summed":
                pmesh.all_reduce_mean = lambda ts, share=None: mean(ts, 1.0)
            tc = TileCreator(ds, 16, density_threshold=0.0, device=dev)
            tr = loop.Trainer(_dp_config(), tc, device=dev,
                              shard_data=mode == "sharded")
            torch.cuda.synchronize()
            wk.launches = wk.bwd_launches = 0                  # path starts
            out = tr.fit(4)
            torch.cuda.synchronize()
            launches = (wk.launches, wk.bwd_launches)          # path ends
            pmesh.all_reduce_mean = mean
            state = _train_state(tr.rt)
            pmesh.check_replicated([t.to(dev) for t in state.values()])
            torch.save(state, os.path.join(out_dir, f"{mode}{rank}.pt"))
            res[mode] = {"data_sharded": tr.data_sharded,
                         "lr_vols": int(tc.lr.shape[0]),
                         "hrz_vols": int(tc.hrz.shape[0]),
                         "stack_bytes": tc.lr.nbytes + tc.hrz.nbytes,
                         "warp_launches": launches[0],
                         "warp_bwd_launches": launches[1],
                         "g_loss": out["g_loss"]}
    finally:
        pmesh.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _dp_two_ranks(d, own_cards):
    """Phase 13b over two spawned ranks → their results and states."""
    out = os.path.join(d, "nccl" if own_cards else "gloo")
    os.makedirs(out)
    torch.multiprocessing.start_processes(
        _dp_rank, args=(2, f"file://{out}/store", out, own_cards), nprocs=2,
        start_method="spawn")
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            info = json.load(f)
        info["states"] = {m: torch.load(os.path.join(out, f"{m}{r}.pt"))
                          for m in DP_MODES}
        ranks.append(info)
    return ranks


def phase_parallel(dev, wk):
    """13: data-parallel training, the dry run and parallel inference."""
    from mpgan_torch import cli
    from mpgan_torch.data.pipeline import TileCreator
    from mpgan_torch.dryrun import dryrun_multichip
    from mpgan_torch.parallel import mesh as pmesh
    from mpgan_torch.train import checkpoint as ckpt
    from mpgan_torch.train import graphed, loop, recipe

    t0 = phase("13 parallel: NCCL world 1, two ranks on the card, "
               "dryrun_multichip(2), sliced and pipelined inference")
    res = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as d:
        # (a) out 0 through NCCL at world size 1 against the same run
        # without the flags
        smooth_dataset(os.path.join(d, "data"), n_sims=1)
        f32 = (f"basePath {d}/data/ fromSim 1000 toSim 1000 frameMax 4 out 0 "
               + CLI_RECIPE.replace("ganLoss hinge", "ganLoss sce")
               + " dtype float32 adamEps 1 trainingIters 4 saveInterval 0 "
               "outputInterval 4 ")
        t = time.perf_counter()
        captures = []
        graph_init = graphed.Graph.__init__

        def counted(self, fn, device, generator=None):
            graph_init(self, fn, device, generator)
            captures.append(pmesh.backend())
        graphed.Graph.__init__ = counted
        try:
            wk.launches = wk.bwd_launches = 0                  # path starts
            cli.main((f32 + f"testPath {d}/nccl/ coordinator "
                      f"127.0.0.1:{free_port()} numProcesses 1 "
                      "processId 0").split())
            torch.cuda.synchronize()
            launches = (wk.launches, wk.bwd_launches)          # path ends
        finally:
            graphed.Graph.__init__ = graph_init
        res["a_s"] = time.perf_counter() - t
        assert launches == (3 * 4, 4), launches
        # the rank replayed graphs (R1 at step 0, eager; the program
        # without R1 eager at step 1, captured at step 2)
        assert captures == ["nccl"], captures
        cli.main((f32 + f"testPath {d}/plain/").split())
        got, want = (ckpt.restore(ckpt.run_dir(f"{d}/{n}", 0), 0, "cpu")
                     for n in ("nccl", "plain"))
        assert got[1] == want[1] and got[1]["it"] == 4, (got[1], want[1])
        gap = _state_gap(_state_tensors(got[0]), _state_tensors(want[0]))
        assert gap <= 1e-4, gap
        res["a"] = {"nccl_world1_vs_no_flags_max_abs_gap": gap,
                    "graphs_captured": len(captures),
                    "warp_launches": launches[0],
                    "warp_bwd_launches": launches[1]}

        # (b) two ranks on the card over gloo at global B=16 against one
        # process at B=16 (twice: the card's own spread)
        t = time.perf_counter()
        ranks = _dp_two_ranks(d, own_cards=False)
        res["b_s"] = time.perf_counter() - t
        ds = recipe.synthetic_dataset()
        one = []
        for _ in range(2):
            tr = loop.Trainer(_dp_config(), TileCreator(
                ds, 16, density_threshold=0.0, device=dev), device=dev)
            init = _train_state(tr.runtime())
            tr.fit(4)
            one.append(_train_state(tr.rt))
        spread = _state_gap(one[1], one[0])
        # the gap is held absolutely and against how far the 4 steps moved
        # the state: a fault that every rank makes alike (a sum in place of
        # the mean) moves the state by a share of that distance, which at
        # adamEps 1 can stay below 1e-4
        moved = _state_gap(one[0], init)
        rep_gap, sum_gap = (max(_state_gap(r["states"][m], one[0])
                                for r in ranks)
                            for m in ("replicated", "summed"))
        assert rep_gap <= 1e-4 and rep_gap <= DP_REL_LIMIT * moved, (
            rep_gap, moved, spread)
        assert sum_gap > DP_REL_LIMIT * moved, (sum_gap, moved)
        sh = [r["states"]["sharded"] for r in ranks]
        assert all(torch.equal(sh[0][k], sh[1][k]) for k in sh[0])
        full = ds.lr.shape[0]
        for r in ranks:
            assert not r["replicated"]["data_sharded"]
            assert r["replicated"]["lr_vols"] == full
            assert r["sharded"]["data_sharded"]
            assert (r["sharded"]["lr_vols"], r["sharded"]["hrz_vols"]) == (
                full // 2, full // 2), r["sharded"]
            for m in DP_MODES:
                assert (r[m]["warp_launches"], r[m]["warp_bwd_launches"]) \
                    == (3 * 4, 4), r[m]
        res["b"] = {
            "ranks_vs_one_process_max_abs_gap": rep_gap,
            "one_process_repeat_max_abs_gap": spread,
            "one_process_moved_from_init_max_abs": moved,
            "summed_fault_vs_one_process_max_abs_gap": sum_gap,
            "relative_limit": DP_REL_LIMIT,
            "sharded_ranks_bitwise_equal": True,
            "stack_bytes_per_rank": {m: ranks[0][m]["stack_bytes"]
                                     for m in ("replicated", "sharded")},
            # rank 0's launches in its replicated and sharded runs (the
            # planted fault's run is a control, not the path)
            "warp_launches_per_rank": sum(
                ranks[0][m]["warp_launches"]
                for m in ("replicated", "sharded")),
            "warp_bwd_launches_per_rank": sum(
                ranks[0][m]["warp_bwd_launches"]
                for m in ("replicated", "sharded")),
            "g_loss": {m: [r[m]["g_loss"] for r in ranks]
                       for m in DP_MODES}}
        if torch.cuda.device_count() > 1:
            ranks = _dp_two_ranks(d, own_cards=True)
            nccl_gap = max(_state_gap(r["states"]["replicated"], one[0])
                           for r in ranks)
            assert nccl_gap <= 1e-4, nccl_gap
            sh = [r["states"]["sharded"] for r in ranks]
            assert all(torch.equal(sh[0][k], sh[1][k]) for k in sh[0])
            res["b"]["nccl_two_cards_vs_one_process_max_abs_gap"] = nccl_gap
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True

    # (c) the dry run: two gloo ranks sharing the card
    t = time.perf_counter()
    dry = dryrun_multichip(2, "cuda", share_cards=True)
    res["c"] = {"s": time.perf_counter() - t, "backend": dry["backend"],
                "data_sharded": dry["data_sharded"], "stages": dry["stages"]}

    # (d) inference at the bench shape: the slices split over [card] * 2,
    # then the passes as a pipeline of 2 and 3 stages over [card] * k
    res["d"] = _parallel_inference(dev)
    print("   parallel " + json.dumps(res), flush=True)
    done(t0)
    return res


def free_port():
    """A free TCP port on the loopback interface."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _captured_collective_probe(dev, replays=10):
    """An all-reduce captured as the train step's graphs capture
    (``thread_local``) on the group's communicator, with an op that NCCL
    runs even on one rank (a sum pre-multiplied by 2; a one-rank in-place
    sum is no work for it): eagerly it doubles the tensor; after the
    capture the tensor is unchanged (recorded, not run) and the graph's
    nodes (``CUDAGraph.debug_dump``) hold NCCL's kernel; each of
    ``replays`` profiled replays doubles the tensor again → the graph's
    NCCL kernel node, and the kernels the profiler recorded in the window
    (between two 10 ms device spins) by name, count and device µs per
    replay, and whether that trace is whole (both spins and one NCCL
    kernel per replay): short windows late in a long process have come
    back cut, so the trace is reported, not held."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from mpgan_torch.profiling import NCCL_KERNELS

    x = torch.ones(1 << 20, device=dev)
    op = dist._make_nccl_premul_sum(2.0)
    dist.all_reduce(x, op=op)
    torch.cuda.synchronize()
    assert bool(x.eq(2).all()), x[:4]
    x.fill_(1.0)
    # the captured graph kept (keep_graph) for its dump, then instantiated
    g = torch.cuda.CUDAGraph(keep_graph=True)
    g.enable_debug_mode()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        dist.all_reduce(x, op=op)
    torch.cuda.synchronize()
    assert bool(x.eq(1).all()), x[:4]
    with tempfile.TemporaryDirectory() as d:
        g.debug_dump(os.path.join(d, "probe.dot"))
        with open(os.path.join(d, "probe.dot")) as f:
            nodes = NCCL_KERNELS.findall(f.read())
    assert nodes, "no NCCL kernel node in the captured graph"
    g.instantiate()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        for _ in range(replays):
            g.replay()
        torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()
    assert bool(x.eq(2.0 ** replays).all()), x[:4]
    g.reset()
    kernels = {e.key: [e.count / replays, e.self_device_time_total / replays]
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    nccl = sum(c for k, (c, _) in kernels.items() if NCCL_KERNELS.search(k))
    spins = sum(c for k, (c, _) in kernels.items() if "spin_kernel" in k)
    return {"replays": replays, "graph_nccl_nodes": sorted(set(nodes)),
            "replay_kernels_count_us": kernels,
            "trace_whole": (nccl, spins * replays) == (1.0, 2.0)}


def phase_nccl_rank(dev, wk):
    """13e: the flagship pass-1 step as the only rank of an NCCL group,
    graphed against eager; float32 bit for bit."""
    from mpgan_torch import config as cfgmod
    from mpgan_torch.data.loader import FluidDataLoader
    from mpgan_torch.data.pipeline import TileCreator
    from mpgan_torch.parallel import mesh as pmesh
    from mpgan_torch.train import loop, recipe

    t0 = phase("13e NCCL group of one: the flagship pass-1 step graphed "
               "against eager, float32 bit for bit")
    res = {"nccl_version": ".".join(map(str, torch.cuda.nccl.version())),
           "NCCL_GRAPH_MIXING_SUPPORT": os.environ.get(
               "NCCL_GRAPH_MIXING_SUPPORT", "unset")}
    tc = TileCreator(recipe.synthetic_dataset(), 16, density_threshold=0.0,
                     device=dev)
    cfg = recipe.flagship_config("bfloat16")
    # 11c's float32 setting, on its smooth one-sim dataset
    tmp = tempfile.TemporaryDirectory()
    smooth_dataset(os.path.join(tmp.name, "data"), n_sims=1)
    f32 = cfgmod.from_cli((
        f"basePath {tmp.name}/data/ fromSim 1000 toSim 1000 frameMax 4 "
        "out 0 " + CLI_RECIPE.replace("lrdisc 0.0004", "lrdisc 0.01")
        + " dtype float32 lrgan 1 adamEps 1").split())
    tc32 = TileCreator(FluidDataLoader(f"{tmp.name}/data/", 1000, 1000, 0,
                                       4).get(), 16, 0.0, device=dev)
    tmp.cleanup()
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    pmesh.init_distributed(f"127.0.0.1:{free_port()}", 1, 0, "nccl")
    try:
        assert loop.Trainer(cfg, tc, device=dev).graphs is True
        res["probe"] = _captured_collective_probe(dev)
        wk.launches = wk.bwd_launches = 0                  # path starts
        turns = train_turns(cfg, lambda graphs: loop.Trainer(
            cfg, tc, device=dev, graphs=graphs), n=32, windows=3)
        launches = (wk.launches, wk.bwd_launches)          # path ends
        steps = turns.pop("steps")
        turns.pop("trainers")
        assert launches == (3 * steps, steps), launches
        nccl = {w: turns[w]["profile"]["nccl_kernels_per_step"]
                for w in ("eager", "graphed")}
        assert nccl["graphed"] == nccl["eager"], nccl
        res.update(turns, steps=steps, warp_launches=launches[0],
                   warp_bwd_launches=launches[1])

        # 11c's float32 setting: 32 steps, R1 at steps 0 and 16
        cudnn.deterministic, cudnn.benchmark = True, False
        cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        runs = {}
        for graphs in (False, True):
            tr = loop.Trainer(f32, tc32, device=dev,
                              graphs=None if graphs else False)
            assert tr.graphs is graphs
            runs[graphs] = (tr.fit(32, log_every=32), tr)
        torch.cuda.synchronize()
    finally:
        pmesh.shutdown()
    try:
        tr = loop.Trainer(f32, tc32, device=dev)
        assert tr.graphs is True
        runs["single"] = (tr.fit(32, log_every=32), tr)
        torch.cuda.synchronize()
    finally:
        (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    states = {k: _state_tensors(tr.state()) for k, (_, tr) in runs.items()}
    assert all(bool(torch.isfinite(t.float()).all())
               for st in states.values() for t in st.values())
    rank_gap = _state_gap(states[True], states[False])
    single_gap = _state_gap(states[True], states["single"])
    metrics_equal = all(runs[True][0][k] == runs[False][0][k]
                        for k in TRAIN_METRICS)
    assert rank_gap == 0.0 and metrics_equal, (rank_gap, metrics_equal)
    assert single_gap <= 1e-4, single_gap
    res["f32"] = {
        "steps": 32, "graphed_vs_eager_rank_max_abs_gap": rank_gap,
        "metrics_equal": metrics_equal,
        "graphed_rank_vs_single_process_graphed_max_abs_gap": single_gap,
        "programs_uses_captured": {
            f"fade={k[0]},r1={k[1]}": [p.uses, p.graph is not None]
            for k, p in runs[True][1].programs.programs.items()}}
    print("   nccl_rank " + json.dumps(res), flush=True)
    done(t0, graphed_ms=res["graphed"]["ms_per_step"],
         eager_ms=res["eager"]["ms_per_step"], f32_rank_gap=rank_gap,
         f32_single_gap=single_gap)
    return res


def _pipeline_turns(ways, frames, turns):
    """Each of ``ways`` (name → a function that streams ``frames``) in
    turns (in order, then in reverse), ``turns`` times, one stream between
    CUDA events → name → (median ms per frame, every turn's)."""
    ms = {name: [] for name in ways}
    order = list(ways) + list(reversed(ways))
    for _ in range(turns):
        for name in order:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            ways[name]()
            ev[1].record()
            torch.cuda.synchronize()
            ms[name].append(ev[0].elapsed_time(ev[1]) / len(frames))
    return {name: (sorted(v)[len(v) // 2], v) for name, v in ms.items()}


def _parallel_inference(dev):
    """13d → per dtype: the sliced call's error; per pipeline its split,
    the graphed stream equal to the eager one bit for bit (6 frames, read
    after all are out, cuDNN's deterministic mode), its error to
    upscale_volume, the graphs' pool bytes and (bf16) ms per frame
    graphed, eager and sequential, in turns."""
    from mpgan_torch.infer import assemble, load
    from mpgan_torch.infer.pipeline import InferencePipeline

    frames = [np.random.default_rng(s).random((64, 64, 64, 4),
                                              dtype=np.float32)
              for s in range(6)]
    out = {}
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        for dtype, tol in (("bfloat16", BF16_UNIT), ("float32", 1e-4)):
            torch.backends.cudnn.allow_tf32 = dtype != "float32"
            torch.backends.cuda.matmul.allow_tf32 = dtype != "float32"
            cfg, g1, g2 = load_chain(dtype, dev)
            g3 = load.load_bundled("g3_l1p3_4x", dtype, dev)
            with torch.inference_mode():
                lr = torch.from_numpy(frames[0]).to(dev)
                one = assemble.upscale_volume(g1, g2, lr, 4)
                two = assemble.upscale_volume(g1, g2, lr, 4,
                                              devices=[dev] * 2)
                sliced_err = float((two.float() - one.float()).abs().max())
            assert sliced_err <= tol, (dtype, sliced_err)
            res = {"apply_sliced_2_devices_max_abs_err": sliced_err}
            for k, gen3 in ((2, None), (3, g3)):
                def sequential():
                    with torch.inference_mode():
                        return [assemble.upscale_volume(
                            g1, g2, torch.from_numpy(f).to(dev), 4,
                            gen3=gen3) for f in frames]
                torch.cuda.synchronize()
                torch.cuda.empty_cache()    # released graphs' pools go
                pools = _graph_pool_bytes()
                pp = InferencePipeline(g1, g2, 4, devices=[dev] * k,
                                       gen3=gen3)
                with eager_only():
                    eager = InferencePipeline(g1, g2, 4, devices=[dev] * k,
                                              gen3=gen3)
                assert not any(st.graphed for st in eager.stages)
                assert all(st.graphed for st in pp.stages)
                want = sequential()
                with counted_captures() as captures:
                    got = list(pp.stream(frames))
                ref = list(eager.stream(frames))
                torch.cuda.synchronize()
                pool_bytes = _graph_pool_bytes() - pools
                # one capture per stage (frame 1), read after all frames
                assert len(captures) == k, (k, len(captures))
                assert all(torch.equal(a, b) for a, b in zip(got, ref)), (
                    dtype, k)
                err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got, want))
                assert len(got) == len(frames) and err <= tol, (dtype, k,
                                                                err)
                entry = {"split": list(pp.split), "max_abs_err": err,
                         "frames": len(frames),
                         "graphed_equals_eager": True,
                         "graph_pool_bytes": pool_bytes}
                del got, ref, want
                if dtype == "bfloat16":
                    turns = _pipeline_turns(
                        {"graphed": lambda: list(pp.stream(frames)),
                         "eager": lambda: list(eager.stream(frames)),
                         "sequential": sequential}, frames, turns=2)
                    for name, (med, all_ms) in turns.items():
                        entry[f"{name}_ms_per_frame"] = med
                        entry[f"{name}_ms_per_frame_turns"] = all_ms
                pp.release()
                res[f"pipeline_{k}_stages"] = entry
            out[dtype] = res
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    out["multi_card"] = multi_card_pipeline(frames)
    return out


def multi_card_pipeline(frames):
    """13d over every visible card where there are several: the 2-stage
    pipeline at ``default_split`` (its pass-2 stage over distinct cards,
    each card's share captured on it), bf16 and float32 (TF32 off), under
    cuDNN's deterministic mode: every frame equal to an eager pipeline's
    over the same cards bit for bit → per dtype the split and frames
    compared; None on one card."""
    from mpgan_torch.infer import assemble
    from mpgan_torch.infer.pipeline import InferencePipeline
    from mpgan_torch.parallel import mesh as pmesh

    if torch.cuda.device_count() < 2:
        print("   13d multi-card: a stage over distinct cards needs several "
              "cards; 1 visible, not run", flush=True)
        return None
    cards = pmesh.make_mesh()
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32)
    res = {"cards": len(cards)}
    try:
        cudnn.deterministic, cudnn.benchmark = True, False
        for dtype in ("bfloat16", "float32"):
            cudnn.allow_tf32 = dtype != "float32"
            _, g1, g2 = load_chain(dtype, cards[0])
            pp = InferencePipeline(g1, g2, 4, devices=cards)
            with eager_only():
                eager = InferencePipeline(g1, g2, 4, devices=cards)
            spans = [st.split for st in pp.stages]
            assert any(spans) and all(st.graphed for st in pp.stages)
            got = list(pp.stream(frames))
            want = list(eager.stream(frames))
            for d in cards:
                torch.cuda.synchronize(d)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), dtype
            assert all(isinstance(p, assemble.CardPrograms)
                       for st in pp.stages if st.split
                       for p in st.programs.values())
            res[dtype] = {"split": list(pp.split),
                          "stages_over_cards": spans,
                          "frames_equal": len(frames)}
            pp.release()
            del got, want
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = flags
    print("   13d multi-card " + json.dumps(res), flush=True)
    return res


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


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
    bundled_lr, bundled_quality = phase_bundled(dev)
    demo_res = phase_demo(dev)
    bench = phase_bench(dev)
    served = phase_serve(dev, bundled_lr)
    align_launches, align_err = phase_align(dev, wk)
    train = phase_train(dev, wk)
    cli_res = phase_cli(dev, wk)
    quality = phase_quality(dev)
    demo_res["gaps_to_phase9"] = demo_gaps(demo_res, quality)
    print("   demo gaps to phase 9 " + json.dumps(demo_res["gaps_to_phase9"]),
          flush=True)
    streamed = phase_streamed(dev)
    recover = phase_recover(dev, wk)
    repro = phase_repro(dev, wk)
    datagen = phase_datagen(dev, wk, nvidia_smi())
    solver_graphs = phase_solver_graphs(dev, nvidia_smi())
    parallel = phase_parallel(dev, wk)
    parallel["e"] = phase_nccl_rank(dev, wk)

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
    kernels[0].update(build_s=build_s, stream_source=wk.STREAM_SOURCE)
    kernels[2].update(launches_per_train_step=train["warp_launches_per_step"],
                      launches_align=align_launches,
                      launches_pass2=train["pass2"]["warp_launches"],
                      launches_pass3_cli=cli_res["pass3"]["warp_launches"],
                      launches_recovery=recover["warp_launches"],
                      launches_datagen=datagen["c_train"]["warp_launches"],
                      launches_nccl_world1=parallel["a"]["warp_launches"],
                      launches_nccl_rank_turns=parallel["e"][
                          "warp_launches"],
                      launches_two_ranks_per_rank=parallel["b"][
                          "warp_launches_per_rank"])
    kernels[3].update(
        launches_per_train_step=train["warp_bwd_launches_per_step"],
        launches_pass2=train["pass2"]["warp_bwd_launches"],
        launches_pass3_cli=cli_res["pass3"]["warp_bwd_launches"],
        launches_recovery=recover["warp_bwd_launches"],
        launches_datagen=datagen["c_train"]["warp_bwd_launches"],
        launches_nccl_world1=parallel["a"]["warp_bwd_launches"],
        launches_nccl_rank_turns=parallel["e"]["warp_bwd_launches"],
        launches_two_ranks_per_rank=parallel["b"][
            "warp_bwd_launches_per_rank"])
    print(json.dumps({"kernels": kernels, "main_path": bench,
                      "serve": served,
                      "bundled": bundled_quality, "demo": demo_res,
                      "train": train,
                      "cli": cli_res, "quality": quality,
                      "streamed": streamed, "recover": recover,
                      "repro": repro, "datagen": datagen,
                      "solver_graphs": solver_graphs,
                      "parallel": parallel}),
          flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
