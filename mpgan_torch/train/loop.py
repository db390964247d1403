"""Training loop — counterpart of ``mpgan_tpu/train/loop.py``
(single device).

One train step (:class:`TrainStep`, one per growth stage and fade flag)
samples and augments batches on the device (the tile creator), updates Ds
(and Dt) ``discRuns`` times and G ``genRuns`` times, each on a fresh batch,
then the EMA copy of G, then counts the step. :class:`Trainer` drives the
growth schedule, rebuilds the models at a stage boundary (carrying the
learned weights forward) and logs metrics.

Where eager PyTorch differs from the JAX package's one jitted program:
- work both discriminator losses share is computed once per D-run: the
  fake under ``no_grad``, the conditioned inputs and the fake and real
  triplets; then the Ds and Dt losses take two backward passes. The
  generator's prev/cur/next inputs go through G as one batch. With
  ``discRuns = genRuns = 1`` and temporal D on, the warp kernels launch
  3 times forward per step (the fake and real triplets of the D-run, the
  fake triplet of the G-run, one fused launch each) and once backward (the
  G-run), and the step checks this through the kernels' launch counters;
- lazy R1 is a Python branch on the host-side step counter;
- metrics stay device tensors; the trainer reads them only at log points;
- a parameter that no loss reaches gets a zero gradient, so that Adam
  moves it as optax does (optax updates every leaf every step);
- ``stepsPerDispatch`` is accepted and means one step per Python
  iteration.

A batch is a dict of NHWC tensors with the JAX pipeline's keys: ``lr``,
``lr_prev``, ``lr_next`` for pass 1; ``interm`` (+ ``_prev``, ``_next``)
and ``lr_vel`` (+ ``_prev``, ``_next``) for pass 2; ``hr``, ``hr_prev``,
``hr_next`` for the targets.

Not ported yet: checkpoints and resume, pass 3, sharded residency and data
parallelism, heartbeats and fault injection, ``profileDir``, ``debugNans``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from mpgan_torch.config import Config
from mpgan_torch.data.pipeline import TileCreator
from mpgan_torch.device import resolve_device
from mpgan_torch.infer.load import torch_dtype
from mpgan_torch.models import discriminator as D
from mpgan_torch.models import generator as G
from mpgan_torch.models import growing
from mpgan_torch.ops import warp_kernel
from mpgan_torch.train import losses

_PASS_INPUT_KEY = {1: "lr", 2: "interm", 3: "final"}


def g_input(batch: dict, pass_no: int) -> torch.Tensor:
    if pass_no == 1:
        return batch["lr"]
    parts = [batch[_PASS_INPUT_KEY[pass_no]]]
    if "lr_vel" in batch:
        parts.append(batch["lr_vel"])
    return torch.cat(parts, dim=-1)


def g_input_shifted(batch: dict, pass_no: int, which: str) -> torch.Tensor:
    if pass_no == 1:
        return batch[f"lr_{which}"]
    parts = [batch[f"{_PASS_INPUT_KEY[pass_no]}_{which}"]]
    if f"lr_vel_{which}" in batch:
        parts.append(batch[f"lr_vel_{which}"])
    return torch.cat(parts, dim=-1)


def vel_hr(batch: dict, pass_no: int, stage: int, up_res: int) -> torch.Tensor:
    """The centre frame's (v_w, v_h) velocity on the output grid of this
    stage, in output-grid pixels (linear resize, then unit scale)."""
    s_in = 2 ** stage
    fh, fw = {1: (s_in, s_in), 2: (s_in, 1), 3: (1, 1)}[pass_no]
    unit_h = s_in if pass_no != 3 else up_res
    unit_w = s_in if pass_no == 1 else up_res
    v = batch["lr"][..., 1:3] if pass_no == 1 else batch["lr_vel"][..., 0:2]
    if (fh, fw) != (1, 1):
        _, h, w, _ = v.shape
        v = F.interpolate(v.permute(0, 3, 1, 2), size=(h * fh, w * fw),
                          mode="bilinear", align_corners=False)
        v = v.permute(0, 2, 3, 1)
    # scalar products: a per-call unit tensor would be a host→device copy
    return torch.cat([v[..., 0:1] * unit_w, v[..., 1:2] * unit_h], dim=-1)


def fake_triplet(gen, batch: dict, pass_no: int, stage: int,
                 alpha: float = 1.0, fade: bool = False):
    """G on the (prev, cur, next) inputs as one batch → three (B, H, W, 1)."""
    x = torch.cat([g_input_shifted(batch, pass_no, "prev"),
                   g_input(batch, pass_no),
                   g_input_shifted(batch, pass_no, "next")])
    return gen(x, stage=stage, alpha=alpha, fade=fade).chunk(3)


def aligned_fakes(gen, batch: dict, pass_no: int, stage: int, up_res: int,
                  use_kernel: bool, max_disp: int = 8, alpha: float = 1.0,
                  fade: bool = False) -> torch.Tensor:
    """G on the (prev, cur, next) inputs, advected to the centre time →
    (B, H, W, 3)."""
    return losses.align_triplet(*fake_triplet(gen, batch, pass_no, stage,
                                              alpha, fade),
                                vel_hr(batch, pass_no, stage, up_res),
                                use_kernel, max_disp)


def aligned_reals(batch: dict, pass_no: int, stage: int, up_res: int,
                  use_kernel: bool, max_disp: int = 8) -> torch.Tensor:
    """The HR target triplet advected to the centre time → (B, H, W, 3)."""
    return losses.align_triplet(batch["hr_prev"], batch["hr"],
                                batch["hr_next"],
                                vel_hr(batch, pass_no, stage, up_res),
                                use_kernel, max_disp)


def make_sampler(tc: TileCreator, pass_no: int, batch_size: int,
                 temporal: bool) -> Callable[[torch.Generator], dict]:
    """Batch-sampling closure: ``sample(generator) → batch dict``."""
    if pass_no == 1:
        return lambda rng: tc.sample_pass1(rng, batch_size, temporal)
    if pass_no == 2:
        return lambda rng: tc.sample_pass2(rng, batch_size, temporal)
    raise ValueError(f"pass {pass_no} training is not ported yet")


def _make_opt(cfg: Config, params, disc: bool,
              device: torch.device) -> torch.optim.Adam:
    """Adam as ``optax.adam`` (ε outside the square root). ``disc`` takes
    ``lrdisc`` when it is set (TTUR)."""
    lr = cfg.train.learning_rate
    if disc and cfg.train.lr_disc > 0:
        lr = cfg.train.lr_disc
    return torch.optim.Adam(params, lr=lr, betas=(cfg.train.beta1, 0.999),
                            eps=cfg.train.adam_eps,
                            fused=device.type == "cuda")


def _update(opt: torch.optim.Optimizer, params: list[torch.Tensor],
            loss: torch.Tensor) -> None:
    """Backward into ``params`` only, then one optimizer step. A parameter
    the loss does not reach gets a zero gradient (optax updates it too)."""
    for p in params:
        p.grad = None
    loss.backward(inputs=params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.step()


@dataclass
class StageRuntime:
    """Models, optimizers, EMA and the two steps of one growth stage."""
    stage: int
    gen: G.Generator
    ds: D.Discriminator
    dt: D.Discriminator | None
    opt_g: torch.optim.Adam
    opt_ds: torch.optim.Adam
    opt_dt: torch.optim.Adam | None
    ema: dict[str, torch.Tensor] = field(default_factory=dict)
    step: int = 0            # train steps taken, carried across stages
    step_fade: "TrainStep | None" = None
    step_stable: "TrainStep | None" = None


class TrainStep:
    """One train step at ``(stage, fade)``: ``step(alpha, rng) → metrics``
    (device tensors, or 0.0 for losses the configuration skips).

    ``sample`` is the batch source (:func:`make_sampler`); tests replace it
    to inject a batch.
    """

    def __init__(self, cfg: Config, tc: TileCreator, rt: StageRuntime,
                 fade: bool, pass_no: int, n_stages: int):
        lcfg = cfg.loss
        self.cfg, self.rt, self.fade, self.pass_no = cfg, rt, fade, pass_no
        self.temporal = rt.dt is not None
        if self.temporal and tc.st.n_vel == 0:
            raise ValueError(
                "useTempoD requires velocity channels (useVelocities 1): the "
                "temporal discriminator aligns frames by advection")
        if pass_no not in (1, 2):
            raise ValueError(f"pass {pass_no} training is not ported yet")
        self.stage = rt.stage
        self.n_stages = n_stages
        self.up_res = tc.up_res
        s_in = 2 ** self.stage
        self.s_in = s_in
        # Ds conditioning upsample factors (per axis) for this pass
        self.cond_f = {1: (s_in, s_in), 2: (s_in, 1)}[pass_no]
        self.sample = make_sampler(tc, pass_no, cfg.train.batch_size,
                                   self.temporal)
        self.device = tc.device
        self.use_kernel = losses.use_warp_kernel(lcfg.warp_backend,
                                                 self.device)
        # pure-L1 training (kAdv 0 kt 0 kf 0): no loss term touches a
        # discriminator, so the D-runs and the D forwards are skipped
        self.pure_l1 = (lcfg.lambda_adv == 0 and lcfg.lambda_t == 0
                        and lcfg.lambda_f == 0)
        self.g_params = list(rt.gen.parameters())
        self.ds_params = list(rt.ds.parameters())
        self.dt_params = list(rt.dt.parameters()) if self.temporal else []
        self.ema = ([rt.ema[n] for n, _ in rt.gen.named_parameters()]
                    if rt.ema else [])
        d_runs = 0 if self.pure_l1 else max(cfg.train.disc_runs, 1)
        self.d_runs = d_runs
        self.g_runs = max(cfg.train.gen_runs, 1)
        # warp kernel launches per step (counted only where the CUDA kernels
        # run): forward, one per triplet, real + fake per D-run and fake per
        # G-run; backward, one per G-run
        warped = self.temporal and not self.pure_l1
        self.warps_per_step = 2 * d_runs + self.g_runs if warped else 0
        self.warp_bwds_per_step = self.g_runs if warped else 0
        self.count_launches = (self.use_kernel
                               and self.device.type == "cuda")

    # ------------------------------------------------------------- helpers

    def _batch(self, rng: torch.Generator) -> dict:
        """A fresh batch, with the HR targets downsampled when training an
        intermediate growth stage."""
        b = self.sample(rng)
        if self.stage == self.n_stages:
            return b
        out = dict(b)
        f = self.up_res // self.s_in
        fh, fw = (f, f) if self.pass_no == 1 else (f, 1)
        for k in ("hr", "hr_prev", "hr_next"):
            if k in b:
                out[k] = D.downsample_nhwc(b[k], fh, fw)
        return out

    def _gen(self, x, alpha):
        return self.rt.gen(x, stage=self.stage, alpha=alpha, fade=self.fade)

    def _align(self, prev, cur, nxt, vel):
        return losses.align_triplet(prev, cur, nxt, vel, self.use_kernel,
                                    self.cfg.loss.warp_max_disp)

    def _d_update(self, net, opt, params, real, fake, alpha,
                  rng) -> torch.Tensor:
        """One update of a discriminator on real and fake inputs (scored as
        one batch): adversarial loss, lazy R1 and WGAN-GP."""
        lcfg = self.cfg.loss

        def disc(x):
            return net(x, alpha=alpha, fade=self.fade)

        real_logits, fake_logits = disc(torch.cat([real, fake])).chunk(2)
        loss = losses.d_loss(real_logits, fake_logits, lcfg.label_smooth,
                             lcfg.gan_loss)
        # lazy R1 (StyleGAN2): every r1Interval-th step, γ scaled ×interval
        k = max(lcfg.r1_interval, 1)
        if lcfg.r1_gamma > 0 and self.rt.step % k == 0:
            loss = loss + 0.5 * lcfg.r1_gamma * k * losses.r1_penalty(
                disc, real)
        if lcfg.gp_weight > 0:
            eps = torch.rand((real.shape[0], 1, 1, 1), generator=rng,
                             device=real.device)
            loss = loss + lcfg.gp_weight * losses.gradient_penalty(
                disc, real, fake, eps)
        _update(opt, params, loss)
        return loss.detach()

    def _d_run(self, rng, alpha):
        rt, pass_no = self.rt, self.pass_no
        b = self._batch(rng)
        x_in = g_input(b, pass_no)
        with torch.no_grad():
            if self.temporal:
                f_prev, fake, f_next = fake_triplet(
                    rt.gen, b, pass_no, self.stage, alpha, self.fade)
                vel = vel_hr(b, pass_no, self.stage, self.up_res)
                trip_fake = self._align(f_prev, fake, f_next, vel)
                trip_real = self._align(b["hr_prev"], b["hr"], b["hr_next"],
                                        vel)
            else:
                fake = self._gen(x_in, alpha)
            real_in = D.condition_ds_input(x_in, b["hr"], *self.cond_f)
            fake_in = D.condition_ds_input(x_in, fake, *self.cond_f)
        loss_ds = self._d_update(rt.ds, rt.opt_ds, self.ds_params, real_in,
                                 fake_in, alpha, rng)
        loss_dt = 0.0
        if self.temporal:
            loss_dt = self._d_update(rt.dt, rt.opt_dt, self.dt_params,
                                     trip_real, trip_fake, alpha, rng)
        return loss_ds, loss_dt

    def _g_run(self, rng, alpha):
        rt, lcfg, pass_no = self.rt, self.cfg.loss, self.pass_no
        b = self._batch(rng)
        x_in = g_input(b, pass_no)
        hr = b["hr"]
        if self.temporal and not self.pure_l1:
            f_prev, fake, f_next = fake_triplet(rt.gen, b, pass_no,
                                                self.stage, alpha, self.fade)
        else:
            fake = self._gen(x_in, alpha)
        l_l1 = losses.l1_loss(fake, hr)
        aux = dict(g_adv=0.0, l1=l_l1.detach(), feat=0.0, g_t=0.0,
                   psnr=losses.psnr(fake.detach(), hr))
        if self.pure_l1:
            total = lcfg.lambda_l1 * l_l1
        else:
            fake_in = D.condition_ds_input(x_in, fake, *self.cond_f)
            real_in = D.condition_ds_input(x_in, hr, *self.cond_f)
            fake_logits, feats_fake = rt.ds(fake_in, alpha=alpha,
                                            fade=self.fade,
                                            return_features=True)
            with torch.no_grad():
                _, feats_real = rt.ds(real_in, alpha=alpha, fade=self.fade,
                                      return_features=True)
            l_adv = losses.g_adv_loss(fake_logits, lcfg.gan_loss)
            l_f = losses.feature_loss(feats_real, feats_fake)
            l_t = 0.0
            if self.temporal:
                vel = vel_hr(b, pass_no, self.stage, self.up_res)
                trip_fake = self._align(f_prev, fake, f_next, vel)
                l_t = losses.g_adv_loss(
                    rt.dt(trip_fake, alpha=alpha, fade=self.fade),
                    lcfg.gan_loss)
            total = (lcfg.lambda_adv * l_adv + lcfg.lambda_l1 * l_l1
                     + lcfg.lambda_f * l_f + lcfg.lambda_t * l_t)
            aux.update(g_adv=l_adv.detach(), feat=l_f.detach(),
                       g_t=l_t.detach() if self.temporal else 0.0)
        _update(rt.opt_g, self.g_params, total)
        return total.detach(), aux

    # ---------------------------------------------------------------- step

    def __call__(self, alpha: float, rng: torch.Generator) -> dict:
        rt = self.rt
        n0, nb0 = warp_kernel.launches, warp_kernel.bwd_launches
        loss_ds, loss_dt = 0.0, 0.0
        for _ in range(self.d_runs):
            loss_ds, loss_dt = self._d_run(rng, alpha)
        loss_g, aux = 0.0, {}
        for _ in range(self.g_runs):
            loss_g, aux = self._g_run(rng, alpha)
        decay = self.cfg.train.ema_decay
        if decay > 0:
            with torch.no_grad():
                torch._foreach_mul_(self.ema, decay)
                torch._foreach_add_(self.ema, self.g_params,
                                    alpha=1.0 - decay)
        rt.step += 1
        if self.count_launches:
            got = (warp_kernel.launches - n0, warp_kernel.bwd_launches - nb0)
            want = (self.warps_per_step, self.warp_bwds_per_step)
            if got != want:
                raise RuntimeError(
                    f"warp kernels launched (forward, backward) {got} times "
                    f"in a step, expected {want}")
        return dict(d_loss=loss_ds, dt_loss=loss_dt, g_loss=loss_g, **aux)


def read_metrics(metrics: dict) -> dict[str, float]:
    """Device metrics → floats, in one device→host copy."""
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    vals = (torch.stack([metrics[k].to(torch.float32) for k in keys])
            .tolist() if keys else [])
    out = {k: float(v) for k, v in metrics.items() if not torch.is_tensor(v)}
    out.update(zip(keys, vals))
    return {k: out[k] for k in metrics}


def _step_seed(seed: int, start_it: int) -> int:
    """The sampling stream's seed: a function of the run seed and the first
    iteration, so that a run started at ``start_it`` is reproducible."""
    return int(np.random.SeedSequence([seed, start_it]).generate_state(
        1, np.uint64)[0])


class Trainer:
    """Host-side training loop: growth schedule, stage rebuilds, metrics.

    ``Trainer(cfg, tile_creator, device=...).fit(iters)``; ``device`` is
    CUDA unless the caller asks for the CPU, and must be the tile
    creator's. Initial weights are drawn as flax draws them (lecun-normal
    kernels, zero biases) from a CPU generator seeded with ``randSeed``.
    """

    def __init__(self, cfg: Config, tc: TileCreator, device=None,
                 pass_no: int | None = None):
        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device)
        if tc.device != self.device:
            raise ValueError(f"the tile creator's volumes are on {tc.device}, "
                             f"the trainer runs on {self.device}")
        self.pass_no = pass_no if pass_no is not None else (
            1 if cfg.train.first_gen_run else 2)
        if self.pass_no not in (1, 2):
            raise ValueError(f"pass {self.pass_no} training is not ported yet")
        self.n_stages = cfg.model.stages
        self.schedule = (growing.GrowthSchedule(
            self.n_stages, cfg.train.alpha_iters, cfg.train.stable_iters)
            if cfg.train.use_growing else None)
        self.rt: StageRuntime | None = None
        self.metrics_log: list[dict] = []
        self.init_rng = torch.Generator().manual_seed(cfg.train.rand_seed)

    # ---------------------------------------------------------------- build

    def _make_models(self, stage: int):
        mcfg, st = self.cfg.model, self.tc.st
        dtype = torch_dtype(mcfg.dtype)
        t = self.cfg.data.tile_size_low
        s = 2 ** stage
        kw = dict(base_filters=mcfg.n_base_filters,
                  n_res_blocks=mcfg.n_res_blocks, dtype=dtype,
                  remat=mcfg.remat, generator=self.init_rng)
        if self.pass_no == 1:
            c_in = 1 + st.n_vel + st.n_vort
            gen = G.make_pass1(stage, in_channels=c_in, **kw)
            dfac, hw = (2, 2), (t * s, t * s)
        else:
            # pass-2 input: intermediate density + velocity (no vorticity)
            c_in = 1 + st.n_vel
            gen = G.make_pass2(stage, in_channels=c_in, **kw)
            dfac, hw = (2, 1), (t * s, t * self.tc.up_res)
        factors = (dfac,) * stage
        dkw = dict(base_filters=mcfg.disc_base_filters, factors=factors,
                   dtype=dtype, generator=self.init_rng)
        ds = D.make_spatial(stage, c_in + 1, hw, **dkw)
        dt = (D.make_temporal(stage, hw, **dkw)
              if self.cfg.train.use_temporal_disc else None)
        return gen, ds, dt

    def _init_stage(self, stage: int, prev: StageRuntime | None
                    ) -> StageRuntime:
        gen, ds, dt = self._make_models(stage)
        if prev is not None:  # grow: carry learned weights forward
            gen.load_state_dict(growing.migrate_params(
                prev.gen.state_dict(), gen.state_dict()))

            def carry(old, new):
                # the Dense head is re-initialised: its input width and
                # meaning change with the stage
                kept = {k: v for k, v in old.state_dict().items()
                        if not k.startswith("out.")}
                new.load_state_dict(growing.migrate_params(
                    kept, new.state_dict()))
            carry(prev.ds, ds)
            if dt is not None and prev.dt is not None:
                carry(prev.dt, dt)
        dev, cfg = self.device, self.cfg
        gen, ds = gen.to(dev), ds.to(dev)
        dt = dt.to(dev) if dt is not None else None
        ema: dict[str, torch.Tensor] = {}
        if cfg.train.ema_decay > 0:
            # EMA starts at the (migrated) generator; at a growth boundary
            # the old stage's average carries forward and the new blocks
            # start at their initial values
            ema = {k: v.detach() for k, v in gen.named_parameters()}
            if prev is not None and prev.ema:
                ema = growing.migrate_params(prev.ema, ema)
            ema = {k: v.detach().clone() for k, v in ema.items()}
        rt = StageRuntime(
            stage=stage, gen=gen, ds=ds, dt=dt,
            opt_g=_make_opt(cfg, gen.parameters(), False, dev),
            opt_ds=_make_opt(cfg, ds.parameters(), True, dev),
            opt_dt=(_make_opt(cfg, dt.parameters(), True, dev)
                    if dt is not None else None),
            ema=ema, step=prev.step if prev is not None else 0)
        rt.step_fade = TrainStep(cfg, self.tc, rt, True, self.pass_no,
                                 self.n_stages)
        rt.step_stable = TrainStep(cfg, self.tc, rt, False, self.pass_no,
                                   self.n_stages)
        return rt

    def runtime(self, start_it: int = 0) -> StageRuntime:
        """The current stage's runtime, built for the stage of iteration
        ``start_it`` if there is none yet (``fit`` calls this)."""
        if self.rt is None:
            stage = (self.schedule.stage_at(start_it)[0] if self.schedule
                     else self.n_stages)
            self.rt = self._init_stage(stage, None)
        return self.rt

    # ------------------------------------------------------------------ fit

    def fit(self, iters: int | None = None, log_every: int | None = None,
            on_log: Callable | None = None, start_it: int = 0) -> dict:
        """Train iterations ``start_it`` … ``iters − 1``. Every
        ``log_every`` iterations and at the end, the step's metrics are
        read, appended to ``metrics_log`` and passed to ``on_log(self,
        metrics)``. Returns the last metrics with ``steps_per_sec``."""
        cfg = self.cfg
        iters = iters if iters is not None else cfg.train.training_iters
        log_every = log_every or cfg.train.output_interval
        if log_every <= 0:  # outputInterval 0 = log only at the end
            log_every = max(iters, 1)
        rng = torch.Generator(device=self.device).manual_seed(
            _step_seed(cfg.train.rand_seed, start_it))
        cur_stage = self.runtime(start_it).stage
        t_start = time.time()
        last: dict = {}
        it = start_it
        while it < iters:
            if self.schedule:
                stage, alpha = self.schedule.stage_at(it)
                if stage != cur_stage:
                    self.rt = self._init_stage(stage, self.rt)
                    cur_stage = stage
            else:
                stage, alpha = self.n_stages, 1.0
            fade = alpha < 1.0 and stage > 1
            fn = self.rt.step_fade if fade else self.rt.step_stable
            metrics = fn(alpha, rng)
            it += 1
            if (it - 1) // log_every != it // log_every or it >= iters:
                last = read_metrics(metrics)
                last.update(it=it - 1, stage=stage, alpha=float(alpha),
                            wall=time.time() - t_start)
                self.metrics_log.append(last)
                if on_log:
                    on_log(self, last)
        if last:
            last["steps_per_sec"] = (it - start_it) / max(last["wall"], 1e-9)
            last["steps_per_dispatch"] = 1
        return last
