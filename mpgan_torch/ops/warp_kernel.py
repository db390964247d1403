"""The semi-Lagrangian warp as a CUDA kernel, with its plain version and a
differentiable wrapper.

Counterpart of ``mpgan_tpu/ops/warp_pallas.py``: the TPU kernel
``advect_2d_pallas`` is replaced by ``csrc/warp.cu`` (see the note at its
top for the bound and the design), launched by :func:`advect_2d_kernel`.
:func:`advect_2d_clamped_ref` is the plain PyTorch version of the same
function (the JAX package's ``_clamped_xla_reference``), and
:class:`AdvectFast` / :func:`advect_2d_fast` is the differentiable warp the
temporal loss uses: kernel forward for CUDA tensors, plain forward for CPU
tensors, and in both cases a backward through autograd of the plain clamped
version — as the JAX ``custom_vjp`` does; the TPU kernel had no backward
kernel either.
"""

from __future__ import annotations

import torch

from mpgan_torch.ops.warp import advect_2d

# Cells; per-frame backtrace bound, shared with LossConfig.warp_max_disp.
DEFAULT_MAX_DISP = 8

# kernel launches since the last reset (incremented only where the kernel
# is launched; chip_smoke.py resets it before driving the main path)
launches = 0


def advect_2d_clamped_ref(field: torch.Tensor, vel: torch.Tensor,
                          dt: float = 1.0,
                          max_disp: int = DEFAULT_MAX_DISP) -> torch.Tensor:
    """Plain warp with the kernel's displacement clamp: velocity clipped to
    ±max_disp/|dt|, then :func:`mpgan_torch.ops.warp.advect_2d`."""
    lim = max_disp / max(abs(dt), 1e-9)
    return advect_2d(field, vel.clamp(-lim, lim), dt)


def advect_2d_kernel(field: torch.Tensor, vel: torch.Tensor, dt: float = 1.0,
                     max_disp: int = DEFAULT_MAX_DISP) -> torch.Tensor:
    """Launch the CUDA warp: field (B, H, W, 1), vel (B, H, W, 2) float32 as
    (v_w, v_h) → (B, H, W, 1) float32. The field is cast to float32 first.
    Raises on anything the kernel does not take."""
    global launches
    if field.device.type != "cuda" or vel.device != field.device:
        raise ValueError(f"advect_2d_kernel needs both tensors on one CUDA "
                         f"device, got {field.device} and {vel.device}")
    if field.dim() != 4 or field.shape[-1] != 1:
        raise ValueError(f"field must be (B, H, W, 1), got {tuple(field.shape)}")
    b, h, w, _ = field.shape
    if tuple(vel.shape) != (b, h, w, 2):
        raise ValueError(f"vel must be {(b, h, w, 2)}, got {tuple(vel.shape)}")
    if vel.dtype != torch.float32 or not field.is_floating_point():
        raise ValueError(f"need a float field and a float32 velocity, got "
                         f"{field.dtype} and {vel.dtype}")
    if not (field.is_contiguous() and vel.is_contiguous()):
        raise ValueError("field and vel must be contiguous")
    if b * h * w >= 2 ** 31:
        raise ValueError(f"{b}x{h}x{w} pixels exceed the kernel's int index")
    if vel.data_ptr() % 8:
        raise ValueError("vel must be 8-byte aligned (read as float2)")
    f = field.to(torch.float32)
    out = torch.empty((b, h, w, 1), dtype=torch.float32, device=field.device)
    from mpgan_torch import _build
    lib = _build.load("warp")
    with torch.cuda.device(field.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mpgan_warp2d(f.data_ptr(), vel.data_ptr(), out.data_ptr(),
                               b, h, w, float(dt), int(max_disp), stream)
    if err != 0:
        raise RuntimeError(f"warp kernel launch failed: CUDA error {err}")
    launches += 1
    return out


class AdvectFast(torch.autograd.Function):
    """Kernel forward (CUDA tensors) or plain forward (CPU tensors);
    backward through autograd of :func:`advect_2d_clamped_ref`."""

    @staticmethod
    def forward(ctx, field, vel, dt, max_disp):
        ctx.save_for_backward(field, vel)
        ctx.dt, ctx.max_disp = dt, max_disp
        if field.device.type == "cpu":
            return advect_2d_clamped_ref(field.to(torch.float32), vel,
                                         dt, max_disp)
        return advect_2d_kernel(field.contiguous(), vel.contiguous(),
                                dt, max_disp)

    @staticmethod
    def backward(ctx, g):
        field, vel = ctx.saved_tensors
        with torch.enable_grad():
            f = field.detach().requires_grad_(ctx.needs_input_grad[0])
            v = vel.detach().requires_grad_(ctx.needs_input_grad[1])
            out = advect_2d_clamped_ref(f.to(torch.float32), v, ctx.dt,
                                        ctx.max_disp)
            inputs = [t for t in (f, v) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, inputs, g) if inputs else ())
        gf = next(grads) if ctx.needs_input_grad[0] else None
        gv = next(grads) if ctx.needs_input_grad[1] else None
        return gf, gv, None, None


def advect_2d_fast(field: torch.Tensor, vel: torch.Tensor, dt: float = 1.0,
                   max_disp: int = DEFAULT_MAX_DISP) -> torch.Tensor:
    """Differentiable clamped warp (B, H, W, 1) × (B, H, W, 2) → (B, H, W, 1)
    float32: the kernel for CUDA tensors, the plain version for CPU ones."""
    return AdvectFast.apply(field, vel, float(dt), int(max_disp))
