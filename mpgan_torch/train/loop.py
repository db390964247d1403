"""Training loop — counterpart of ``mpgan_tpu/train/loop.py``
(single device): passes 1 and 2 with progressive growing, and the pass-3
refiner (one stage, constant resolution, D factors (1, 1); JAX
``:472-473``, ``:519-522``, ``:543-548``).

One train step (:class:`TrainStep`, one per growth stage and fade flag)
samples and augments batches on the device (the tile creator), updates Ds
(and Dt) ``discRuns`` times and G ``genRuns`` times, each on a fresh batch,
then the EMA copy of G, then counts the step. :class:`Trainer` drives the
growth schedule, rebuilds the models at a stage boundary (carrying the
learned weights forward) and logs metrics.

On a CUDA card a run without ``debugNans`` replays each step as a CUDA
graph (:mod:`mpgan_torch.train.graphed`), the counterpart of the JAX
package's jitted step: one graph per device program (stage, fade, lazy R1
on or off), captured at the program's second use. A rank of an NCCL
process group replays too, its all-reduces inside the graph (JAX's step
jitted over the mesh). On the CPU, inside a gloo process group and with
``debugNans`` it steps eagerly.

``fit`` holds cuDNN's deterministic mode for its whole run
(:func:`deterministic_cudnn`), so that a float32 run repeats bit for bit,
as the JAX step does: with the fixed-order backwards of the upsample, the
fade downsample and the warp, cuDNN's algorithm choice is the last source
of run-to-run parting.

Where the port differs from the JAX package's one jitted program:
- work both discriminator losses share is computed once per D-run: the
  fake under ``no_grad``, the conditioned inputs and the fake and real
  triplets; then the Ds and Dt losses take two backward passes. The
  generator's prev/cur/next inputs go through G as one batch. With
  ``discRuns = genRuns = 1`` and temporal D on, the warp kernels launch
  3 times forward per step (the fake and real triplets of the D-run, the
  fake triplet of the G-run, one fused launch each) and once backward (the
  G-run), and the step checks this through the kernels' launch counters;
- lazy R1 is chosen on the host from the step counter: the step with R1
  and the step without it are two programs (JAX's ``lax.cond`` runs one
  branch of one program);
- metrics stay device tensors; the trainer reads them only at log points;
- a parameter that no loss reaches gets a zero gradient, so that Adam
  moves it as optax does (optax updates every leaf every step);
- ``stepsPerDispatch`` is accepted and means one step per dispatch: a
  graph replay (or an eager step) waits on nothing on the host, so
  there is no dispatch latency for K steps to amortise.

A batch is a dict of NHWC tensors with the JAX pipeline's keys: ``lr``,
``lr_prev``, ``lr_next`` for pass 1; ``interm`` (pass 2) or ``final``
(pass 3) (+ ``_prev``, ``_next``) and ``lr_vel`` (+ ``_prev``, ``_next``);
``hr``, ``hr_prev``, ``hr_next`` for the targets.

:meth:`Trainer.save` and :meth:`Trainer.restore` write and read the full
train state (:mod:`mpgan_torch.train.checkpoint`); ``fit`` calls
``on_checkpoint`` every ``saveInterval`` iterations. The sampling stream
of iteration ``it`` is seeded from ``(randSeed, it)``, so a run resumed
from a checkpoint draws the batches an uninterrupted run draws and ends in
its state.

For unattended runs ``fit`` touches the supervisor's heartbeat
(:mod:`mpgan_torch.utils.liveness`) after every step, after every
checkpoint and at the end, and after its first checkpoint crashes
(``MPGAN_FAIL_ONCE``) or hangs (``MPGAN_HANG_ONCE``) once when asked to,
each leaving a sentinel file so that the restarted run goes through.
``profileDir`` traces ``fit`` with ``torch.profiler`` into that directory.
Spans (:mod:`mpgan_torch.tracing`; in the profiler's trace as ranges of
their names): ``train.step``, one iteration of ``fit``, the parent of
``train.replay`` (:mod:`mpgan_torch.train.graphed`) or ``train.eager`` (a
step run eagerly, timed on the card) and of ``train.read_metrics``, the
device-to-host read of the metrics at a log point. Inside a step, each
timed on the card, in a captured program too (by the events its capture
records into the graph, read for its last traced replay):
``train.d_run`` and ``train.g_run``, one D-run and one G-run, each the
parent of ``train.sample``, the assembly of its batch.
``debugNans`` checks every loss and gradient before its optimizer step and
raises ``FloatingPointError`` naming the update and the step at the first
non-finite value. That is coarser than JAX's ``jax_debug_nans``, which
re-runs the failing computation op by op and names the primitive that
made the NaN: here the first update whose loss or gradient is not finite
is named, and NaNs that stay inside a forward pass without reaching a
loss or gradient go unseen.

Data parallelism (JAX ``:108-147``, ``:451-469``, ``:591-600``): inside a
process group (:mod:`mpgan_torch.parallel.mesh`) every rank trains its
rows of the global batch on its own card with replicated state. Each
update all-reduces the gradients (each rank's weighted by its share of the
rows) before the optimizer step, and each step's metrics, so that every
rank holds the global-batch values. The nets and the EMA are replicated
(broadcast from rank 0 and checked) at start, after a growth-stage rebuild
and after a restore. Residency is sharded (:meth:`TileCreator.shard_over`:
each rank holds its block of whole sims and draws ``batch/world`` rows
with a generator seeded from the run seed, the iteration and its rank)
when the sim count and the batch divide over the ranks; otherwise
(``shard_data=False`` forces it) every rank draws the global batch with
the iteration's generator and keeps its rows, so that a run over several
ranks equals a one-process run at the same global batch up to the order
of float sums.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from mpgan_torch import tracing
from mpgan_torch.config import Config
from mpgan_torch.data.pipeline import TileCreator
from mpgan_torch.device import resolve_device
from mpgan_torch.infer.load import torch_dtype
from mpgan_torch.models import discriminator as D
from mpgan_torch.models import generator as G
from mpgan_torch.models import growing
from mpgan_torch.ops import warp_kernel
from mpgan_torch.parallel import mesh as pmesh
from mpgan_torch.train import checkpoint as ckpt
from mpgan_torch.train import graphed, losses
from mpgan_torch.utils.liveness import touch_heartbeat

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
                 temporal: bool, data_sharded: bool = False,
                 n_ranks: int = 1, rank: int = 0
                 ) -> Callable[[torch.Generator], dict]:
    """Batch-sampling closure: ``sample(generator) → batch dict``, this
    rank's rows of the ``batch_size`` global batch.

    With ``data_sharded`` (sharded residency) the rank draws its
    ``batch_size/n_shards`` rows from its own volume block, with a
    generator its caller seeds per rank (JAX: the key folded with the mesh
    axis index); otherwise it draws the global batch and keeps its rows
    (:func:`mpgan_torch.parallel.mesh.shard_rows`)."""
    draws = {1: tc.sample_pass1, 2: tc.sample_pass2, 3: tc.sample_pass3}
    if pass_no not in draws:
        raise ValueError(f"there is no pass {pass_no}")
    draw = draws[pass_no]
    if data_sharded:
        if batch_size % tc.n_shards:
            raise ValueError(f"batchSize {batch_size} must divide over the "
                             f"{tc.n_shards}-device mesh for sharded "
                             "residency")
        local = batch_size // tc.n_shards
        return lambda rng: draw(rng, local, temporal)
    return lambda rng: pmesh.shard_rows(draw(rng, batch_size, temporal),
                                        n_ranks, rank)


def _make_opt(cfg: Config, params, disc: bool,
              device: torch.device) -> torch.optim.Adam:
    """Adam as ``optax.adam`` (ε outside the square root). ``disc`` takes
    ``lrdisc`` when it is set (TTUR)."""
    lr = cfg.train.learning_rate
    if disc and cfg.train.lr_disc > 0:
        lr = cfg.train.lr_disc
    # on a card the step counts live on the device (fused), and capturable
    # lets a CUDA graph capture the update; the arithmetic is the same
    cuda = device.type == "cuda"
    return torch.optim.Adam(params, lr=lr, betas=(cfg.train.beta1, 0.999),
                            eps=cfg.train.adam_eps, fused=cuda,
                            capturable=cuda)


def _load_opt(opt: torch.optim.Optimizer, sd: dict) -> None:
    """Load an optimizer's moments and step counts. The hyperparameters
    (learning rate, betas, ε, ``fused``) stay this run's, as in optax,
    where they live in the transformation and not in its state."""
    groups = [{k: v for k, v in g.items() if k != "params"}
              for g in opt.param_groups]
    opt.load_state_dict(sd)
    for g, fresh in zip(opt.param_groups, groups):
        g.update(fresh)


def _update(opt: torch.optim.Optimizer, params: list[torch.Tensor],
            loss: torch.Tensor, nan_check: str | None = None,
            share: float | None = None) -> None:
    """Backward into ``params`` only, then one optimizer step. A parameter
    the loss does not reach gets a zero gradient (optax updates it too).
    Inside a process group the gradients are first all-reduced, each
    rank's weighted by ``share``, its fraction of the global batch. With
    ``nan_check`` (a name for the update), a non-finite loss or gradient
    raises ``FloatingPointError`` before the step."""
    for p in params:
        p.grad = None
    loss.backward(inputs=params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if share is not None:
        pmesh.all_reduce_mean([p.grad for p in params], share)
    if nan_check is not None:
        finite = torch.stack([torch.isfinite(loss).all()] + [
            torch.isfinite(p.grad).all() for p in params]).all()
        if not bool(finite):
            raise FloatingPointError(
                f"debugNans: non-finite loss or gradient in {nan_check} "
                f"(loss {float(loss.detach())})")
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

    :meth:`run` is the step's device work alone, with lazy R1 chosen by
    the caller: it reads no host state that a step changes, so that a
    CUDA graph can capture it. ``__call__`` is the eager step around it.
    ``sample`` is the batch source (:func:`make_sampler`); tests replace it
    to inject a batch.
    """

    def __init__(self, cfg: Config, tc: TileCreator, rt: StageRuntime,
                 fade: bool, pass_no: int, n_stages: int,
                 data_sharded: bool = False):
        lcfg = cfg.loss
        self.cfg, self.rt, self.fade, self.pass_no = cfg, rt, fade, pass_no
        self.temporal = rt.dt is not None
        if self.temporal and tc.st.n_vel == 0:
            raise ValueError(
                "useTempoD requires velocity channels (useVelocities 1): the "
                "temporal discriminator aligns frames by advection")
        self.stage = rt.stage
        self.n_stages = n_stages
        self.up_res = tc.up_res
        s_in = 2 ** self.stage
        self.s_in = s_in
        # Ds conditioning upsample factors (per axis) for this pass; pass 3
        # is a constant-resolution refiner
        self.cond_f = {1: (s_in, s_in), 2: (s_in, 1), 3: (1, 1)}[pass_no]
        # data parallelism: this rank's rows of the global batch, and its
        # share of the gradient and metric means (None outside a group)
        b, n_ranks, rank = cfg.train.batch_size, pmesh.world(), pmesh.rank()
        self.sample = make_sampler(tc, pass_no, b, self.temporal,
                                   data_sharded, n_ranks, rank)
        lo, hi = ((0, b // n_ranks) if data_sharded
                  else pmesh.row_range(b, n_ranks, rank))
        # WGAN-GP draws ε for the rows the rank's generator draws, keeps its
        self.eps_rows = (b // n_ranks if data_sharded else b, lo, hi)
        self.share = (hi - lo) / b if pmesh.distributed() else None
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
        with tracing.span("train.sample", self.device):
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

    def _nan_check(self, what: str) -> str | None:
        return (f"the {what} update at step {self.rt.step}"
                if self.cfg.train.debug_nans else None)

    def _gen(self, x, alpha):
        return self.rt.gen(x, stage=self.stage, alpha=alpha, fade=self.fade)

    def _align(self, prev, cur, nxt, vel):
        return losses.align_triplet(prev, cur, nxt, vel, self.use_kernel,
                                    self.cfg.loss.warp_max_disp)

    def _d_update(self, net, opt, params, real, fake, alpha, rng, r1: bool,
                  what: str) -> torch.Tensor:
        """One update of a discriminator on real and fake inputs (scored as
        one batch): adversarial loss, lazy R1 (with ``r1``) and WGAN-GP."""
        lcfg = self.cfg.loss

        def disc(x):
            return net(x, alpha=alpha, fade=self.fade)

        real_logits, fake_logits = disc(torch.cat([real, fake])).chunk(2)
        loss = losses.d_loss(real_logits, fake_logits, lcfg.label_smooth,
                             lcfg.gan_loss)
        # lazy R1 (StyleGAN2): every r1Interval-th step, γ scaled ×interval
        if r1:
            k = max(lcfg.r1_interval, 1)
            loss = loss + 0.5 * lcfg.r1_gamma * k * losses.r1_penalty(
                disc, real)
        if lcfg.gp_weight > 0:
            n, lo, hi = self.eps_rows
            eps = torch.rand((n, 1, 1, 1), generator=rng,
                             device=real.device)[lo:hi]
            loss = loss + lcfg.gp_weight * losses.gradient_penalty(
                disc, real, fake, eps)
        _update(opt, params, loss, self._nan_check(what), self.share)
        return loss.detach()

    def _d_run(self, rng, alpha, r1):
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
                                 fake_in, alpha, rng, r1, "Ds")
        loss_dt = 0.0
        if self.temporal:
            loss_dt = self._d_update(rt.dt, rt.opt_dt, self.dt_params,
                                     trip_real, trip_fake, alpha, rng, r1,
                                     "Dt")
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
                   psnr=losses.mse(fake.detach(), hr))   # → PSNR in __call__
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
        _update(rt.opt_g, self.g_params, total, self._nan_check("G"),
                self.share)
        return total.detach(), aux

    # ---------------------------------------------------------------- step

    def r1_due(self) -> bool:
        """Whether the step at the runtime's step counter applies lazy R1
        (StyleGAN2: every r1Interval-th step, JAX ``:249-270``)."""
        k = max(self.cfg.loss.r1_interval, 1)
        return self.cfg.loss.r1_gamma > 0 and self.rt.step % k == 0

    def check_launches(self, got: tuple[int, int]) -> None:
        """Raise unless one step launched (or a graph captured) the warp
        kernels (forward, backward) ``got`` times as the step expects,
        where the CUDA kernels run."""
        want = (self.warps_per_step, self.warp_bwds_per_step)
        if self.count_launches and got != want:
            raise RuntimeError(
                f"warp kernels launched (forward, backward) {got} times in "
                f"a step, expected {want}")

    def __call__(self, alpha: float, rng: torch.Generator) -> dict:
        """One eager step: :meth:`run_checked` with lazy R1 as the step
        counter says, then the counter."""
        metrics = self.run_checked(alpha, rng, self.r1_due())
        self.rt.step += 1
        return metrics

    def run_checked(self, alpha: float | torch.Tensor, rng: torch.Generator,
                    r1: bool) -> dict:
        """:meth:`run` run eagerly, then the launch check."""
        n0, nb0 = warp_kernel.launches, warp_kernel.bwd_launches
        with tracing.span("train.eager", self.device):
            metrics = self.run(alpha, rng, r1)
        self.check_launches((warp_kernel.launches - n0,
                             warp_kernel.bwd_launches - nb0))
        return metrics

    def run(self, alpha: float | torch.Tensor, rng: torch.Generator,
            r1: bool) -> dict:
        """The step's device work: ``discRuns`` D-runs (lazy R1 with
        ``r1``), ``genRuns`` G-runs and the EMA → metrics. ``alpha`` is a
        float or a 0-d float64 device tensor; the step counter is not
        read or advanced."""
        loss_ds, loss_dt = 0.0, 0.0
        for _ in range(self.d_runs):
            with tracing.span("train.d_run", self.device):
                loss_ds, loss_dt = self._d_run(rng, alpha, r1)
        loss_g, aux = 0.0, {}
        for _ in range(self.g_runs):
            with tracing.span("train.g_run", self.device):
                loss_g, aux = self._g_run(rng, alpha)
        decay = self.cfg.train.ema_decay
        if decay > 0:
            with torch.no_grad():
                torch._foreach_mul_(self.ema, decay)
                torch._foreach_add_(self.ema, self.g_params,
                                    alpha=1.0 - decay)
        metrics = dict(d_loss=loss_ds, dt_loss=loss_dt, g_loss=loss_g,
                       **aux)
        if self.share is not None:
            # every rank holds the global batch's values, as JAX's
            # replicated metrics; the PSNR is that of the global MSE
            keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
            vals = torch.stack([metrics[k].float() for k in keys])
            pmesh.all_reduce_mean([vals], self.share)
            metrics.update(zip(keys, vals.unbind()))
        if torch.is_tensor(metrics.get("psnr")):
            metrics["psnr"] = losses.psnr_from_mse(metrics["psnr"])
        return metrics


def read_metrics(metrics: dict) -> dict[str, float]:
    """Device metrics → floats, in one device→host copy."""
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    vals = (torch.stack([metrics[k].to(torch.float32) for k in keys])
            .tolist() if keys else [])
    out = {k: float(v) for k, v in metrics.items() if not torch.is_tensor(v)}
    out.update(zip(keys, vals))
    return {k: out[k] for k in metrics}


def _step_seed(seed: int, it: int, rank: int | None = None) -> int:
    """The seed of iteration ``it``'s sampling stream: a function of the
    run seed and the iteration alone, so that a resume draws what an
    uninterrupted run draws; with ``rank`` (sharded residency) of the rank
    too, so that each rank draws its own rows."""
    key = [seed, it] if rank is None else [seed, it, rank]
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic mode (``deterministic=True``,
    ``benchmark=False``) while the block runs, the caller's two flags
    restored after, on return and on an exception. Only these two flags
    are touched: ``torch.backends.cudnn.flags`` would also reset
    ``allow_tf32`` and the others to its own defaults. cuDNN alone reads
    them, so on the CPU they change nothing."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


class Trainer:
    """Host-side training loop: growth schedule, stage rebuilds, metrics.

    ``Trainer(cfg, tile_creator, device=...).fit(iters)``; ``device`` is
    CUDA unless the caller asks for the CPU, and must be the tile
    creator's. Initial weights are drawn as flax draws them (lecun-normal
    kernels, zero biases) from a CPU generator seeded with ``randSeed``.
    Inside a process group the trainer is one rank of a data-parallel run
    (module docstring); ``shard_data=False`` keeps residency whole.

    ``graphs``: whether ``fit`` replays CUDA graphs
    (:mod:`mpgan_torch.train.graphed`). None (the default) replays them on
    a CUDA card, alone or as a rank of an NCCL process group (the graphs
    hold the rank's all-reduces), when ``debugNans`` is off, and steps
    eagerly otherwise: on the CPU, inside a gloo process group (ranks
    that share a card: gloo's collectives run on the host, and a graph
    cannot hold them) and with ``debugNans`` (which reads every loss on
    the host). True where graphs cannot run raises ``ValueError``; False
    steps eagerly everywhere.
    """

    def __init__(self, cfg: Config, tc: TileCreator, device=None,
                 pass_no: int | None = None, shard_data: bool = True,
                 graphs: bool | None = None):
        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device)
        if tc.device != self.device:
            raise ValueError(f"the tile creator's volumes are on {tc.device}, "
                             f"the trainer runs on {self.device}")
        self.graphs = self._graphs_rule(graphs)
        # the sampling stream, reseeded every iteration; one generator for
        # the trainer's life, as the graphs that draw from it hold its state
        self.rng = torch.Generator(device=self.device)
        self.programs: graphed.Programs | None = None
        n_ranks = pmesh.world()
        if shard_data and n_ranks > 1 and cfg.train.batch_size % n_ranks:
            print(f"  batchSize {cfg.train.batch_size} does not divide over "
                  f"{n_ranks} ranks; dataset residency stays replicated")
            shard_data = False
        self.data_sharded = bool(shard_data and n_ranks > 1
                                 and tc.shard_over(n_ranks, pmesh.rank()))
        self.pass_no = pass_no if pass_no is not None else (
            1 if cfg.train.first_gen_run else 2)
        if self.pass_no not in (1, 2, 3):
            raise ValueError(f"there is no pass {self.pass_no}")
        # pass 3 is a single-stage refiner; growing does not apply
        self.n_stages = 1 if self.pass_no == 3 else cfg.model.stages
        self.schedule = (growing.GrowthSchedule(
            self.n_stages, cfg.train.alpha_iters, cfg.train.stable_iters)
            if cfg.train.use_growing else None)
        self.rt: StageRuntime | None = None
        self.metrics_log: list[dict] = []
        self.init_rng = torch.Generator().manual_seed(cfg.train.rand_seed)

    def _graphs_rule(self, graphs: bool | None) -> bool:
        """The ``graphs`` argument → whether ``fit`` replays CUDA graphs
        (class docstring)."""
        why_not = None
        if not graphed.Graph.available(self.device):
            why_not = f"there are no CUDA graphs on {self.device}"
        elif pmesh.distributed() and pmesh.backend() != "nccl":
            why_not = (f"the trainer is inside a {pmesh.backend()} process "
                       "group, whose collectives run on the host, and a "
                       "CUDA graph cannot hold them")
        elif self.cfg.train.debug_nans:
            why_not = "debugNans reads every loss and gradient on the host"
            if graphs is None:
                print("  debugNans: the trainer steps eagerly, without CUDA "
                      "graphs")
        if graphs and why_not:
            raise ValueError(f"graphs=True: {why_not}")
        return why_not is None if graphs is None else bool(graphs)

    def _set_runtime(self, rt: StageRuntime) -> None:
        """Make ``rt`` the current runtime. Its programs are new, as JAX
        compiles anew for a new stage; the old runtime's graphs and their
        memory pools are released."""
        if self.programs is not None:
            self.programs.release()
        self.rt = rt
        self.programs = (graphed.Programs(rt, self.rng) if self.graphs
                         else None)

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
        elif self.pass_no == 2:
            # pass-2 input: intermediate density + velocity (no vorticity)
            c_in = 1 + st.n_vel
            gen = G.make_pass2(stage, in_channels=c_in, **kw)
            dfac, hw = (2, 1), (t * s, t * self.tc.up_res)
        else:
            # pass-3 input: full-res density + velocity, constant resolution
            c_in = 1 + st.n_vel
            gen = G.make_pass3(in_channels=c_in, **kw)
            ts = t * self.tc.up_res
            dfac, hw = (1, 1), (ts, ts)
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
                                 self.n_stages, self.data_sharded)
        rt.step_stable = TrainStep(cfg, self.tc, rt, False, self.pass_no,
                                   self.n_stages, self.data_sharded)
        replicate_state(rt)
        return rt

    def runtime(self, start_it: int = 0) -> StageRuntime:
        """The current stage's runtime, built for the stage of iteration
        ``start_it`` if there is none yet (``fit`` calls this)."""
        if self.rt is None:
            stage = (self.schedule.stage_at(start_it)[0] if self.schedule
                     else self.n_stages)
            self._set_runtime(self._init_stage(stage, None))
        return self.rt

    # ----------------------------------------------------------- checkpoint

    def state(self) -> dict:
        """The full train state as tensors and plain containers: the three
        nets' and optimizers' ``state_dict``s, the EMA and the step."""
        rt = self.runtime()
        return {
            "gen": rt.gen.state_dict(), "ds": rt.ds.state_dict(),
            "dt": rt.dt.state_dict() if rt.dt is not None else {},
            "opt_g": rt.opt_g.state_dict(), "opt_ds": rt.opt_ds.state_dict(),
            "opt_dt": rt.opt_dt.state_dict() if rt.opt_dt is not None else {},
            "ema": dict(rt.ema), "step": rt.step}

    def save(self, run: str, no: int, it: int,
             total_iters: int | None = None) -> None:
        """Checkpoint ``no`` of run dir ``run`` at iteration ``it``: the
        train state as ``model_%04d`` with its sidecar, the generator as
        ``gen_%04d`` and, with an EMA, ``gen_ema_%04d``. In a process
        group the lead writes (the state is replicated) and every rank
        returns once the files are in place."""
        rt = self.runtime()
        gen_meta = dict(stage=rt.stage, pass_no=self.pass_no,
                        up_res=self.tc.up_res)
        meta = dict(it=it, **gen_meta)
        if total_iters is not None:
            meta["total_iters"] = total_iters
        if pmesh.is_lead():
            ckpt.save(run, no, self.state(), meta)
            ckpt.save_gen(run, no, rt.gen.state_dict(), gen_meta)
            if rt.ema:
                ckpt.save_gen(run, no, rt.ema, gen_meta, prefix="gen_ema")
        pmesh.barrier()

    def restore(self, run_dir: str, model_no: int) -> int:
        """Resume from checkpoint ``model_no`` of ``run_dir`` (JAX
        ``:606-643``): rebuild the stage its sidecar records, then load the
        nets, the optimizers' moments, the EMA and the step. Returns the
        iteration to resume from. A corrupt sidecar, or one of another
        pass, raises ``ValueError``; a checkpoint without an EMA (saved
        without ``gen_ema_%04d``) restarts the average from the params."""
        meta_path = os.path.abspath(
            ckpt.model_dir(run_dir, model_no)) + ".json"
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"checkpoint sidecar {meta_path} is corrupt ({e}); pick "
                "another model_no or delete the damaged checkpoint") from e
        meta_pass = meta.get("pass_no")
        if meta_pass is not None and int(meta_pass) != self.pass_no:
            raise ValueError(
                f"{meta_path} records training pass {meta_pass}, but this "
                f"run trains pass {self.pass_no}: resuming across passes "
                "would restore mismatched parameters")
        state, _ = ckpt.restore(run_dir, model_no, self.device)
        rt = self._init_stage(int(meta.get("stage", self.n_stages)), None)
        self._set_runtime(rt)
        rt.gen.load_state_dict(state["gen"])
        rt.ds.load_state_dict(state["ds"])
        _load_opt(rt.opt_g, state["opt_g"])
        _load_opt(rt.opt_ds, state["opt_ds"])
        if rt.dt is not None:
            rt.dt.load_state_dict(state["dt"])
            _load_opt(rt.opt_dt, state["opt_dt"])
        if rt.ema:
            saved = state.get("ema") or {
                k: p.detach() for k, p in rt.gen.named_parameters()}
            for k, v in rt.ema.items():
                v.copy_(saved[k])
        rt.step = int(state["step"])
        replicate_state(rt, optimizers=True)
        return int(meta.get("it", 0))

    # ------------------------------------------------------------------ fit

    def fit(self, iters: int | None = None, log_every: int | None = None,
            on_log: Callable | None = None, start_it: int = 0,
            on_checkpoint: Callable | None = None) -> dict:
        """Train iterations ``start_it`` … ``iters − 1``. Every
        ``log_every`` iterations and at the end, the step's metrics are
        read, appended to ``metrics_log`` and passed to ``on_log(self,
        metrics)``; every ``saveInterval`` iterations before the end,
        ``on_checkpoint(self, it)`` is called with the iterations done.
        Returns the last metrics with ``steps_per_sec``.

        With ``graphs`` each step is one program's graph replay (its first
        use steps eagerly, its second captures the graph); a replay's
        metrics are the graph's output tensors, which its next replay
        overwrites. The whole run, warm-up and captures included, holds
        cuDNN's deterministic mode (:func:`deterministic_cudnn`)."""
        with deterministic_cudnn():
            return self._fit(iters, log_every, on_log, start_it,
                             on_checkpoint)

    def _fit(self, iters, log_every, on_log, start_it, on_checkpoint):
        cfg = self.cfg
        iters = iters if iters is not None else cfg.train.training_iters
        log_every = log_every or cfg.train.output_interval
        if log_every <= 0:  # outputInterval 0 = log only at the end
            log_every = max(iters, 1)
        rng = self.rng
        cur_stage = self.runtime(start_it).stage
        prof = None
        if cfg.train.profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    cfg.train.profile_dir))
            prof.start()
        t_start = time.time()
        last: dict = {}
        it = start_it
        while it < iters:
            if self.schedule:
                stage, alpha = self.schedule.stage_at(it)
                if stage != cur_stage:
                    self._set_runtime(self._init_stage(stage, self.rt))
                    cur_stage = stage
            else:
                stage, alpha = self.n_stages, 1.0
            fade = alpha < 1.0 and stage > 1
            with tracing.span("train.step", it=it):
                rng.manual_seed(_step_seed(cfg.train.rand_seed, it,
                                           pmesh.rank() if self.data_sharded
                                           else None))
                if self.programs is not None:
                    metrics = self.programs(fade, alpha)
                else:
                    fn = self.rt.step_fade if fade else self.rt.step_stable
                    metrics = fn(alpha, rng)
                it += 1
                touch_heartbeat()
                if (it - 1) // log_every != it // log_every or it >= iters:
                    with tracing.span("train.read_metrics"):
                        last = read_metrics(metrics)
                    last.update(it=it - 1, stage=stage, alpha=float(alpha),
                                wall=time.time() - t_start)
                    self.metrics_log.append(last)
                    if on_log:
                        on_log(self, last)
            save_every = cfg.train.save_interval
            if (on_checkpoint and save_every and it % save_every == 0
                    and it < iters):
                on_checkpoint(self, it)
                touch_heartbeat()  # a save is slow, and it is progress
                _inject_fault_once(it)
        if prof is not None:
            prof.stop()
        if last:
            last["steps_per_sec"] = (it - start_it) / max(last["wall"], 1e-9)
            # one step per graph replay or eager step, whatever
            # stepsPerDispatch says (module docstring)
            last["steps_per_dispatch"] = 1
        touch_heartbeat()  # the watchdog's clock restarts for the final save
        return last


def replicate_state(rt: StageRuntime, optimizers: bool = False) -> None:
    """Inside a process group, give every rank rank 0's nets, EMA (and
    with ``optimizers`` the optimizer moments and steps), checked bit for
    bit (:func:`mpgan_torch.parallel.mesh.replicate`)."""
    if not pmesh.distributed():
        return
    nets = [n for n in (rt.gen, rt.ds, rt.dt) if n is not None]
    tensors = [t for n in nets for t in n.state_dict().values()]
    tensors += list(rt.ema.values())
    if optimizers:
        for opt in (rt.opt_g, rt.opt_ds, rt.opt_dt):
            if opt is not None:
                tensors += [v for st in opt.state.values()
                            for v in st.values() if torch.is_tensor(v)]
    pmesh.replicate(tensors)


def _inject_fault_once(it: int) -> None:
    """Fault injection for recovery tests, after a checkpoint: with
    ``MPGAN_FAIL_ONCE=<path>`` raise, with ``MPGAN_HANG_ONCE=<path>`` hang
    (the silent-hang failure the watchdog exists for), each only while its
    sentinel file is absent; the sentinel is written first, so that the
    restarted run goes through. No effect unless a variable is set."""
    fail_once = os.environ.get("MPGAN_FAIL_ONCE")
    if fail_once and not os.path.exists(fail_once):
        with open(fail_once, "w") as fh:
            fh.write(f"injected at it={it}\n")
        raise RuntimeError(f"MPGAN_FAIL_ONCE: injected fault after the "
                           f"checkpoint at it={it}")
    hang_once = os.environ.get("MPGAN_HANG_ONCE")
    if hang_once and not os.path.exists(hang_once):
        with open(hang_once, "w") as fh:
            fh.write(f"hang injected at it={it}\n")
        print(f"MPGAN_HANG_ONCE: hanging at it={it}", flush=True)
        time.sleep(10 ** 9)
