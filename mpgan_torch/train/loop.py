"""The part of the train step that reaches the warp kernel: the temporal
alignment of generated and real frame triplets.

Counterpart of ``mpgan_tpu/train/loop.py`` :89-104 (``_g_input``,
``_g_input_shifted``) and of the ``aligned_fakes`` / ``aligned_reals`` /
``_vel_hr`` closures of ``make_train_step`` (:218-247). The rest of the
step (sampling, Ds/Dt, optimizers, EMA, growth) waits for the trainer.

A batch is a dict of NHWC tensors with the JAX pipeline's keys: ``lr``,
``lr_prev``, ``lr_next`` for pass 1; ``interm``/``final`` (+ ``_prev``,
``_next``) and ``lr_vel`` (+ ``_prev``, ``_next``) for passes 2 and 3;
``hr``, ``hr_prev``, ``hr_next`` for the targets.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
    return (v * torch.tensor([unit_w, unit_h], dtype=v.dtype,
                             device=v.device)).contiguous()


def aligned_fakes(gen, batch: dict, pass_no: int, stage: int, up_res: int,
                  use_kernel: bool, max_disp: int = 8, alpha: float = 1.0,
                  fade: bool = False) -> torch.Tensor:
    """G on the (prev, cur, next) inputs, advected to the centre time →
    (B, H, W, 3)."""
    def g(x):
        return gen(x, stage=stage, alpha=alpha, fade=fade)
    f_prev = g(g_input_shifted(batch, pass_no, "prev"))
    f_cur = g(g_input(batch, pass_no))
    f_next = g(g_input_shifted(batch, pass_no, "next"))
    return losses.align_triplet(f_prev, f_cur, f_next,
                                vel_hr(batch, pass_no, stage, up_res),
                                use_kernel, max_disp)


def aligned_reals(batch: dict, pass_no: int, stage: int, up_res: int,
                  use_kernel: bool, max_disp: int = 8) -> torch.Tensor:
    """The HR target triplet advected to the centre time → (B, H, W, 3)."""
    return losses.align_triplet(batch["hr_prev"], batch["hr"],
                                batch["hr_next"],
                                vel_hr(batch, pass_no, stage, up_res),
                                use_kernel, max_disp)
